"""The port's consensuslint (ed25519_consensus_tpu_torch/analysis/linter.py)
against the JAX package's, on the CPU.

* Linter parity: every fixture snippet of the reference's own tests
  (tests/test_consensuslint.py) is linted by both linters at the matching
  package-relative path; the findings must be equal as (rule, path, line,
  col, symbol), exactly.  The fixtures are collected by running each
  reference test with its `lint_fixture` / `lint_tool_fixture` helpers
  swapped for ones that lint with both and hand the reference's findings
  back, so the reference test's own assertions still run.
* The real tree: the port lints clean under its committed waivers, every
  scope list resolves (a stale one is an error, like a stale waiver), and
  the waiver count is pinned; it is load_soak's ratchet.
* The CLI's exit codes, the stats gauges, load_soak's waiver gate on a
  scratch copy of the package, and the config registry's new surface
  (validate_all, knob_table, get_raw, README's knob table) against the
  reference's.
"""

import ast
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from ed25519_consensus_tpu import config as jconfig
from ed25519_consensus_tpu.analysis import linter as jlinter
from ed25519_consensus_tpu_torch import config
from ed25519_consensus_tpu_torch.analysis import linter
from ed25519_consensus_tpu_torch.tools import consensuslint, load_soak

from torch_threads import _one_torch_thread  # noqa: F401


ROOT = Path(__file__).resolve().parent.parent
REF_TESTS = ROOT / "tests" / "test_consensuslint.py"
JPKG, PPKG = "ed25519_consensus_tpu/", "ed25519_consensus_tpu_torch/"
HELPERS = ("lint_fixture", "lint_tool_fixture", "_one_finding")

# The committed waiver count of the port: every waiver is a CL006
# supervision site the reference waives too (analysis/waivers.toml).
PINNED_WAIVERS = 6


def _load_reference(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", ROOT / "tests" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fixture_tests(path: Path, helpers) -> "list[str]":
    """The reference tests that lint a fixture through `helpers`."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    out = []
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith(
                "test_") and not node.args.args:
            names = {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}
            if names & set(helpers):
                out.append(node.name)
    return out


def key(findings, prefix: str):
    """(rule, package-relative path, line, col, symbol), sorted."""
    return sorted((f.rule, f.path[len(prefix):] if f.path.startswith(prefix)
                   else f.path, f.line, f.col, f.symbol) for f in findings)


def lint_both(pairs, relpath: str, source: str, tool: bool = False):
    """Lint `source` at `relpath` with both linters; record the pair and
    return the reference's findings.  A tool fixture sits at a
    repo-relative path in the reference (tools/ is outside its package)
    and inside the package in the port."""
    jrel = relpath if tool else JPKG + relpath
    j = jlinter.lint_module(jlinter.ParsedModule(
        path=f"<fixture:{relpath}>", source=source, relpath=jrel))
    p = linter.lint_module(linter.ParsedModule(
        path=f"<fixture:{relpath}>", source=source, relpath=PPKG + relpath))
    pairs.append((relpath, source, key(j, "" if tool else JPKG),
                  key(p, PPKG)))
    return j


@pytest.fixture(scope="module")
def reference():
    return _load_reference("test_consensuslint")


# The one fixture whose scope symbol the port does not have: the port
# stages a batch in `Verifier._stage` (no queue-order/grouped split), so
# its CL001 batch scope names that symbol instead.
PORT_RENAMED = {"test_cl001_negative_verdict_symbol_in_batch":
                ("_stage_queue_order", "_stage")}


@pytest.mark.parametrize("name", _fixture_tests(REF_TESTS, HELPERS))
def test_linter_parity_on_reference_fixtures(name, reference, monkeypatch):
    pairs = []
    monkeypatch.setattr(reference, "lint_fixture",
                        lambda r, s: lint_both(pairs, r, s))
    monkeypatch.setattr(reference, "lint_tool_fixture",
                        lambda r, s: lint_both(pairs, r, s, tool=True))
    getattr(reference, name)()   # the reference's own assertions hold
    assert pairs, "the reference test linted no fixture"
    for relpath, source, jkey, pkey in pairs:
        if name not in PORT_RENAMED:
            assert pkey == jkey, (relpath, source)
            continue
        # the port has no such symbol, so no finding; renamed to the
        # port's symbol, the same finding at the same place
        old, new = PORT_RENAMED[name]
        assert jkey and pkey == []
        renamed = []
        lint_both(renamed, relpath, source.replace(old, new))
        assert renamed[0][3] == [(r, p, ln, c, s.replace(old, new))
                                 for r, p, ln, c, s in jkey]


def test_parity_collects_every_rule():
    """The collected fixtures reach every rule of CL001-CL007 (the
    concurrency pair's are test_torch_guards.py's)."""
    names = _fixture_tests(REF_TESTS, HELPERS)
    assert len(names) >= 60
    for rule in ("cl001", "cl002", "cl003", "cl004", "cl005", "cl006",
                 "cl007"):
        assert any(rule in n for n in names), rule


# -- waivers -----------------------------------------------------------------

def _one(mod, pkg):
    return mod.lint_module(mod.ParsedModule(
        path="<f>", source="_wave_cache = {}\n", relpath=pkg + "service.py"))


@pytest.mark.parametrize("mod,pkg", [(jlinter, JPKG), (linter, PPKG)],
                         ids=["reference", "port"])
def test_waiver_round_trip(mod, pkg):
    findings = _one(mod, pkg)
    waivers = [{"rule": "CL004", "path": pkg + "service.py",
                "symbol": "<module>", "reason": "test"}]
    active, waived = mod.apply_waivers(findings, waivers)
    assert active == [] and len(waived) == 1
    assert key(waived, pkg) == key(_one(jlinter, JPKG), JPKG)


@pytest.mark.parametrize("mod,pkg", [(jlinter, JPKG), (linter, PPKG)],
                         ids=["reference", "port"])
def test_stale_waiver_fails(mod, pkg):
    waivers = [{"rule": "CL004", "path": pkg + "service.py",
                "symbol": "nope", "reason": "stale"}]
    with pytest.raises(mod.WaiverError, match="stale"):
        mod.apply_waivers(_one(mod, pkg), waivers)


def test_waiver_requires_justification(tmp_path):
    p = tmp_path / "waivers.toml"
    p.write_text('[[waiver]]\nrule = "CL001"\npath = "x.py"\n'
                 'symbol = "f"\n')
    with pytest.raises(linter.WaiverError, match="reason"):
        linter.load_waivers(str(p))


# -- the real tree -----------------------------------------------------------

def test_port_lints_clean_under_committed_waivers():
    findings = linter.lint_package()
    active, waived = linter.apply_waivers(findings, linter.load_waivers())
    assert active == [], "\n".join(str(f) for f in active)
    assert {f.rule for f in waived} == {"CL006"}


def test_waiver_count_is_pinned_and_is_the_soak_ratchet():
    waivers = linter.load_waivers()
    assert len(waivers) == PINNED_WAIVERS == load_soak.MAX_WAIVERS
    assert all(w["reason"] and w["path"].startswith(PPKG) for w in waivers)
    assert load_soak.parse_args([]).max_waivers == PINNED_WAIVERS


def test_walk_covers_tools_and_csrc():
    files = {linter._relpath(p) for p in linter.iter_package_files()}
    assert PPKG + "tools/load_soak.py" in files
    assert PPKG + "analysis/harness.py" in files
    from ed25519_consensus_tpu_torch.analysis import sass_audit

    scanned = sass_audit.scan_tree()
    assert "csrc/window_sums_u32.cuh" in scanned["kernel"]
    assert "csrc/host/fe25519.cpp" in scanned["host"]


def test_scope_lists_resolve():
    linter.verify_scopes()
    lists = linter.scope_lists()
    assert "ops/msm.py" in lists["CL004"][0]
    assert "_shapes_completed" in linter._CL004_ALLOWED["ops/msm.py"]


@pytest.mark.parametrize("patch,match", [
    (("_CL001_BATCH_SYMBOLS", ("Verifier._stage_queue_order",)),
     "Verifier._stage_queue_order"),
    (("_CL007_VERDICT_SYMBOLS", ("VerifyService._execute_wave",)),
     "VerifyService._execute_wave"),
    (("_CL006_MODULES", ("tools/gone_lab.py",)), "tools/gone_lab.py"),
], ids=["symbol", "cl007-symbol", "module"])
def test_unresolvable_scope_entry_is_an_error(patch, match, monkeypatch):
    attr, extra = patch
    monkeypatch.setattr(linter, attr, getattr(linter, attr) + extra)
    with pytest.raises(linter.ScopeError, match=match):
        linter.verify_scopes()
    with pytest.raises(linter.ScopeError):
        linter.lint_package()


def test_allowlisted_global_must_exist(monkeypatch):
    allowed = dict(linter._CL004_ALLOWED)
    allowed["ops/msm.py"] = allowed["ops/msm.py"] | {"_gone_cache"}
    monkeypatch.setattr(linter, "_CL004_ALLOWED", allowed)
    with pytest.raises(linter.ScopeError, match="_gone_cache"):
        linter.verify_scopes()


def test_msm_module_globals_are_reviewed():
    """ops/msm.py is in CL004's scope: a new mutable global there (the
    completed-shape set's kind) fails the lint."""
    findings = linter.lint_module(linter.ParsedModule(
        path="<f>", source="_shapes_completed = set()\n_warm = {}\n",
        relpath=PPKG + "ops/msm.py"))
    assert [(f.rule, f.line) for f in findings] == [("CL004", 2)]


@pytest.mark.parametrize("src,n", [
    ("import torch\nx = torch.zeros(3, dtype=torch.float)\n", 1),
    ("import torch\ny = x.to(torch.double)\n", 1),
    ("y = p.double()\n", 0),                # Edwards doubling, not a dtype
    ("y = x.to(float)\n", 1),
    ("import numpy as np\ny = np.half(1)\n", 1),
], ids=["torch.float", "torch.double", "point-double", "to-float",
        "np.half"])
def test_cl001_torch_spellings(src, n):
    findings = linter.lint_module(linter.ParsedModule(
        path="<f>", source=src, relpath=PPKG + "ops/fixture.py"))
    assert [f.rule for f in findings] == ["CL001"] * n


# -- the CLI and the gauges --------------------------------------------------

def test_cli_exit_codes(tmp_path, capsys):
    assert consensuslint.main([]) == 0
    assert consensuslint.main([linter.PACKAGE_ROOT]) == 0
    assert consensuslint.main(["--no-waivers"]) == 1
    assert consensuslint.main(["--guards"]) == 0
    stale = tmp_path / "waivers.toml"
    shutil.copy(linter.WAIVERS_PATH, stale)
    with open(stale, "a", encoding="utf-8") as f:
        f.write('\n[[waiver]]\nrule = "CL002"\n'
                f'path = "{PPKG}batch.py"\nsymbol = "verify_many"\n'
                'reason = "stale on purpose"\n')
    assert consensuslint.main(["--waivers", str(stale)]) == 2
    assert "stale" in capsys.readouterr().err


def test_stats_and_gauges():
    from ed25519_consensus_tpu_torch.utils import metrics

    st = linter.publish_gauges()
    assert set(st["rule_counts"]) == set(linter.RULE_IDS)
    assert st["findings_active"] == 0
    assert st["waiver_count"] == PINNED_WAIVERS
    assert st["manifest_hash"] and len(st["manifest_hash"]) == 64
    g = metrics.gauges()
    assert g["consensuslint_waivers"] == PINNED_WAIVERS
    assert g["consensuslint_findings_active"] == 0
    assert g["twin_manifest_hash"] == st["manifest_hash"]


# -- load_soak's waiver gate on a scratch copy -------------------------------

def _scratch_copy(tmp_path) -> Path:
    dst = tmp_path / "repo"
    shutil.copytree(ROOT / "ed25519_consensus_tpu_torch",
                    dst / "ed25519_consensus_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    return dst


def _soak_gate(repo: Path, *argv) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(repo))
    return subprocess.run(
        [sys.executable, "-m", "ed25519_consensus_tpu_torch.tools.load_soak",
         "--device", "cpu", "--rounds", "1", *argv],
        cwd=str(repo), env=env, capture_output=True, text=True, timeout=120)


def test_load_soak_gate_refuses_an_unwaived_finding(tmp_path):
    repo = _scratch_copy(tmp_path)
    soak = repo / "ed25519_consensus_tpu_torch" / "tools" / "soak.py"
    soak.write_text(soak.read_text(encoding="utf-8")
                    + "\n\ndef _stamp():\n    import time\n"
                      "    return time.time()\n", encoding="utf-8")
    r = _soak_gate(repo)
    assert r.returncode == 2, r.stdout + r.stderr
    assert "consensuslint gate" in r.stderr and "1 active" in r.stderr


def test_load_soak_gate_refuses_more_waivers_than_the_ratchet(tmp_path):
    r = _soak_gate(_scratch_copy(tmp_path), "--max-waivers",
                   str(PINNED_WAIVERS - 1))
    assert r.returncode == 2, r.stdout + r.stderr
    assert f"{PINNED_WAIVERS} waiver(s) (max {PINNED_WAIVERS - 1})" \
        in r.stderr


def test_load_soak_gate_passes_the_real_tree():
    assert load_soak.lint_gate(PINNED_WAIVERS) is None
    assert "consensuslint" in load_soak.lint_gate(PINNED_WAIVERS - 1)


# -- the config registry's new surface ---------------------------------------

SHARED = sorted(set(config.KNOBS) & set(jconfig.KNOBS))


def test_registry_holds_36_of_the_references_knobs():
    assert len(config.KNOBS) == 36 and len(SHARED) == 36
    for name in ("ED25519_TPU_MSM_KERNEL", "ED25519_TPU_PALLAS_BODY",
                 "ED25519_TPU_WIN_CHUNK"):
        assert name in jconfig.KNOBS
        assert name not in config.KNOBS
        assert name in config.__doc__


@pytest.mark.parametrize("env", [
    {},
    {"ED25519_TPU_EMA_PRIOR": "x", "ED25519_TPU_MIN_LANES": "many"},
    {"ED25519_TPU_DEVCACHE_BYTES": "1e6", "ED25519_TPU_HEDGE_MIN_MS": "",
     "ED25519_TPU_STRAGGLER_RATIO": "three"},
], ids=["clean", "two", "three"])
def test_validate_all_matches_the_reference(env, monkeypatch):
    for name in SHARED:
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    mine = config.validate_all()
    ref = {k: v for k, v in jconfig.validate_all().items() if k in SHARED}
    assert set(mine) == set(ref)
    for name, err in mine.items():
        assert isinstance(err, config.ConfigError) and err.raw == env[name]


def test_knob_table_rows_match_the_reference():
    """Name, type and default agree for every shared knob; the doc column
    is each package's own (the port documents its own meaning)."""
    mine = {r[0]: r for r in config.knob_table()}
    ref = {r[0]: r for r in jconfig.knob_table()}
    assert list(mine) == list(config.KNOBS)
    for name in SHARED:
        assert mine[name][:3] == ref[name][:3], name
        assert mine[name][3]


def test_get_raw(monkeypatch):
    with pytest.raises(KeyError):
        config.get_raw("ED25519_TPU_NOT_A_KNOB")
    monkeypatch.setenv("ED25519_TPU_PERSIST_DIR", "")
    assert config.get_raw("ED25519_TPU_PERSIST_DIR") == "" == \
        jconfig.get_raw("ED25519_TPU_PERSIST_DIR")
    monkeypatch.delenv("ED25519_TPU_PERSIST_DIR")
    assert config.get_raw("ED25519_TPU_PERSIST_DIR") is None


def test_override_none_unsets_for_the_scope(monkeypatch):
    monkeypatch.setenv("ED25519_TPU_RACE_AUDIT", "1")
    with config.override(ED25519_TPU_RACE_AUDIT=None):
        assert config.get_raw("ED25519_TPU_RACE_AUDIT") is None
    assert config.get_raw("ED25519_TPU_RACE_AUDIT") == "1"


def test_readme_knob_table_in_sync():
    """README's port section renders config.knob_table() verbatim."""
    readme = (ROOT / "README.md").read_text(encoding="utf-8")
    port = readme[readme.index("## The PyTorch/CUDA port"):]
    for name, ty, default, doc in config.knob_table():
        row = f"| `{name}` | {ty} | {default} | {doc} |"
        assert row in port, f"missing or stale row:\n{row}"
