"""Whole runs of each cell at a tiny size on the CPU: the one-line result,
the modules a run loads, and the comparison that decides `correct`, which
the control and every fault a cell can have must fail."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests import faults, tiny

ROOT = Path(__file__).resolve().parents[2]
CELLS = ["zcash.sync", "cometbft.sync"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _line(result) -> dict:
    line = json.dumps(result, allow_nan=False)
    assert "\n" not in line
    return json.loads(line)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_prints_the_contract(cell, trace):
    res = _line(tiny.run(cell, trace=trace))
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    spec = harness.load_spec(cell)
    want = {m["name"] for m in spec["per_layer" if trace else "end_to_end"]}
    got = set(res["metrics"])
    assert got <= want
    if not trace:
        assert got == want  # every end-to-end metric, on any device
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0 or \
            m["value"] == 0
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_run_loads_neither_jax_nor_the_jax_package(cell):
    """In a fresh process: no module whose whole top-level name is `jax`,
    `jaxlib`, `flax` or `ed25519_consensus_tpu` after a run."""
    out = subprocess.run(
        [sys.executable, "-m", "portbench.tests.tiny", cell], cwd=ROOT,
        capture_output=True, text=True, timeout=600, check=True)
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-3])["correct"] is True
    assert lines[-2] == "none"
    # the run went through the port (so the check above is not vacuous)
    tops = lines[-1].split()
    assert "ed25519_consensus_tpu_torch" in tops and "torch" in tops
    assert not set(tops) & set(harness.FORBIDDEN)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ed25519_consensus_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ed25519_consensus_tpu.batch", sys)
    assert harness.forbidden_modules() == ["ed25519_consensus_tpu"]


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.reference.ed25519_ref, portbench.compare;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ed25519_consensus_tpu_torch', 'ed25519_consensus_tpu', "
            "'jax', 'torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The control (the reference with one guarantee broken) in the
    program's place."""
    res = tiny.run(cell, control=True)
    assert res["correct"] is False
    assert res["checks"]["verdict_mismatches"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_in_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    faults.plant(fault, monkeypatch)
    res = tiny.run(cell, seed=2**31 + 77, seconds=1.5)
    assert res["correct"] is False
    assert res["checks"]["verdict_mismatches"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_every_window_judges_its_tampered_units(cell):
    """The window holds the traffic's tampered units, the comparison
    judges each, and a window too short to hold them is not correct."""
    res = tiny.run(cell, seed=2**31 + 79, seconds=1.5)
    assert res["compared"]["tampered"] == 2
    assert res["window"]["calls_rejecting"] == 2
    empty = tiny.run(cell, seed=2**31 + 79, seconds=0.0)
    assert empty["window"]["calls"] == 0
    assert empty["checks"]["tampered_units_unjudged"]["value"] == 2
    assert empty["correct"] is False


def test_without_the_port_a_run_prints_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and portbench/ fails."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.tests.tiny", "zcash.sync"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
