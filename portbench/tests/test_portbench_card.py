"""Each cell's command on the card, briefly: it prints a correct result
line; the control and each planted fault, at the cell's own size, are not
correct.  Marked `cuda`; skips without a card (decided in the fixture)."""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests import faults

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")


CELLS = ["zcash.sync", "cometbft.sync"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell,
         "--seed", str(2**31 + 101), "--seconds", "10", "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["compared"]["tampered"] == 2
    assert res["device"]["platform"] == "gpu"
    if trace:
        assert res["device"]["busy_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_the_cells_size_is_not_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell,
         "--seed", str(2**31 + 103), "--seconds", "4", "--control"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_at_the_cells_size_is_not_correct(card, cell, fault,
                                                monkeypatch):
    """Each fault planted in the timed path, at the cell's own traffic
    parameters on the card (a 10 s window holds its tampered units)."""
    faults.plant(fault, monkeypatch)
    args = argparse.Namespace(workload=cell, seed=2**31 + 107, seconds=10.0,
                              trace=0, control=False)
    res = harness.run(args, time.perf_counter())
    print(cell, fault, json.dumps(res["checks"]), json.dumps(res["window"]))
    assert res["compared"]["tampered"] == 2
    assert res["correct"] is False
    assert res["checks"]["verdict_mismatches"]["value"] > 0
