"""The `pod.sync4` cell (portbench/workloads/pod.sync4.json): one batch of
signatures by a recurring validator set a call through `verify_many(mesh=4,
hybrid=False, merge="never", chunk=1)`, and the mesh layer's counters and
spans (`last_run_stats["mesh_launch_seconds"]`, `["mesh_gather_seconds"]`,
`["mesh_lanes"]`; spans `mesh.launch`, `mesh.gather`) that its per-layer
metrics read.

On the CPU the cell runs at a tiny size through `harness.run` with the
CPU as its device, so its mesh is a virtual one of four shards there,
every kernel by its plain version; the verdicts are held to the plain
reference (portbench/reference/ed25519_ref.py).  The `cuda` test runs the
cell's own command on four cards and skips with fewer."""

import argparse
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import ed25519_consensus_tpu_torch as T
from ed25519_consensus_tpu_torch import batch, devcache, health
from ed25519_consensus_tpu_torch.parallel import sharded_msm
from ed25519_consensus_tpu_torch.utils import metrics
from portbench import harness
from portbench.reference import ed25519_ref as ref

from torch_threads import _one_torch_thread  # noqa: F401


ROOT = Path(__file__).resolve().parents[1]
CELL = "pod.sync4"
TINY = {"batch_size": 64, "signers": 16, "pool_batches": 2,
        "tamper_within_calls": 2}
SEED = 2**31 + 19
MESH_METRICS = ("mesh_launch_us_per_sig", "mesh_fold_us_per_sig",
                "mesh_offlead_lane_share")
NAME, START, END, SPAN_ID, PARENT_ID, CALL_ID, THREAD = range(7)

rng = random.Random(0x90D)


# A plain-kernel mesh call on the CPU takes seconds (more on a loaded
# machine): the turnaround prior the tiny run's scheduler starts from, well
# clear of its deadline floor.
EMA_PRIOR = "30"


def _mesh_call(vs, **kw):
    """verify_many on a four-shard CPU mesh, on a health clock of its own
    that only the test advances, so no deadline or cooldown of another
    test's lane reaches it."""
    return batch.verify_many(
        vs, hybrid=False, merge="never", mesh=4, device="cpu",
        health=health.DeviceHealth(mesh=4, clock=health.FakeClock()), **kw)


def _ref_entries(entries):
    return [(A, sig[:32], sig[32:], m) for A, sig, m in entries]


def _run(control: bool = False, trace: int = 1, keep=None) -> dict:
    overrides = {"traffic": TINY, "device": "cpu", "require_chip": False,
                 "compare": {"sample": 2, "workers": 1}}
    if keep is not None:
        overrides["keep"] = keep
    args = argparse.Namespace(workload=CELL, seed=SEED, seconds=4.0,
                              trace=trace, control=control)
    return harness.run(args, time.perf_counter(), overrides)


def _child() -> None:
    """The tiny traced run, in a process of its own (this session has
    imported JAX, which a run refuses to share a process with): one JSON
    line of the result, each window call's stats and the outcomes."""
    torch.set_num_threads(2)
    keep = {}
    res = _run(keep=keep)
    ctx = keep["ctx"]
    calls = [{k: c["stats"][k] for k in (
        "mesh", "device_ids", "mesh_reformations", "devcache",
        "mesh_lanes", "mesh_launch_seconds", "mesh_gather_seconds",
        "device_seconds")} for c in ctx.record["calls"]]
    print(json.dumps({"result": res, "calls": calls,
                      "outcomes": ctx.driver.outcomes(ctx.record)}))


@pytest.fixture(scope="module")
def tiny_run():
    """(the result line, each window call's stats, the outcomes, the
    cell's traffic at the tiny size) of one traced tiny run."""
    code = ("import runpy, sys; sys.path[:0] = ['.', 'tests']; "
            "runpy.run_path('tests/test_torch_pod_cell.py', "
            "run_name='__main__')")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ED25519_TPU_EMA_PRIOR", EMA_PRIOR)
        out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    traffic, _ = harness.make_traffic(harness.load_spec(CELL), SEED,
                                      {"traffic": TINY})
    return (got["result"], got["calls"],
            [tuple(o) for o in got["outcomes"]], traffic)


def test_tiny_run_is_correct_and_judges_both_tampered_units(tiny_run):
    res = tiny_run[0]
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0
    assert res["compared"]["tampered"] == 2
    assert res["checks"]["tampered_units_unjudged"]["value"] == 0
    assert res["window"]["calls_rejecting"] == 2


def test_every_verdict_equals_the_references(tiny_run):
    _, _, outcomes, traffic = tiny_run
    assert len(outcomes) >= 2
    for u, verdict in outcomes:
        entries, _ = traffic.batch(u)
        want = ref.verify_batch(_ref_entries(entries), random.Random(u))
        assert verdict is want, u


def test_window_runs_the_resident_mesh_on_four_shards(tiny_run):
    """Every window call dispatched the head-resident mesh form once, on
    the four shard positions of the CPU mesh, one batch of lanes each."""
    for st in tiny_run[1]:
        assert st["mesh"] == 4 and st["device_ids"] == [0, 1, 2, 3]
        assert st["mesh_reformations"] == []
        assert st["devcache"]["dispatch_hits"] == 1
        lanes = st["mesh_lanes"]
        assert sorted(lanes) == ["0", "1", "2", "3"]  # keys via JSON
        assert len(set(lanes.values())) == 1
        assert 0 < st["mesh_launch_seconds"] <= st["device_seconds"]
        assert 0 < st["mesh_gather_seconds"] <= st["device_seconds"]


def test_traced_line_reports_the_mesh_counters(tiny_run):
    got = tiny_run[0]["metrics"]
    assert got["mesh_offlead_lane_share"]["value"] == 0.75
    assert got["mesh_launch_us_per_sig"]["value"] > 0
    # no device trace on the CPU: the fold's device time is left out
    assert "mesh_fold_us_per_sig" not in got
    want = {m["name"] for m in harness.load_spec(CELL)["per_layer"]}
    assert set(got) <= want and set(MESH_METRICS) <= want


def test_pool_batches_are_valid_and_tampered_ones_are_not(tiny_run):
    traffic = tiny_run[3]
    assert len(traffic.pool) == TINY["pool_batches"]
    for entries in traffic.pool:
        assert len(entries) == TINY["batch_size"]
        assert ref.verify_batch(_ref_entries(entries), random.Random(1))
    assert len(traffic.tampered) == 2
    for q, (entries, bad) in traffic.tampered.items():
        assert 0 <= q < TINY["tamper_within_calls"]
        assert not ref.verify_batch(_ref_entries(entries),
                                    random.Random(2))
        assert not ref.verify_single(*_ref_entries(entries)[bad])
        good, _ = traffic.batch(q + traffic.pool_batches)
        assert [e for i, e in enumerate(entries) if i != bad] == \
            [e for i, e in enumerate(good) if i != bad]


def test_signers_recur_and_messages_are_distinct(tiny_run):
    traffic = tiny_run[3]
    msgs = [m for entries in traffic.pool for _, _, m in entries]
    assert len(set(msgs)) == len(msgs)
    assert all(len(m) == 32 for m in msgs)
    for entries in traffic.pool:
        keys = [A for A, _, _ in entries]
        assert len(set(keys)) == TINY["signers"]
        assert keys[:TINY["signers"]] == keys[TINY["signers"]:
                                              2 * TINY["signers"]]


def test_control_is_not_correct():
    """The union control (a failed union fails every member, without
    bisection) in the program's place fails a tampered batch's
    neighbours."""
    res = _run(control=True)
    assert res["correct"] is False
    assert res["checks"]["verdict_mismatches"]["value"] > 0


# -- the mesh counters and spans on a CPU virtual mesh ----------------------

def _verifiers(n_batches: int, sigs: int = 4, keys=None):
    out = []
    for b in range(n_batches):
        v = batch.Verifier()
        for i in range(sigs):
            sk = keys[i % len(keys)] if keys else T.SigningKey.new(rng)
            msg = b"pod-%d-%d-%d" % (b, i, rng.randrange(1 << 30))
            v.queue((sk.verification_key_bytes(), sk.sign(msg), msg))
        out.append(v)
    return out


def _spy(monkeypatch, name: str, lanes_of):
    """Record the (batches × lanes) each call of sharded_msm.<name>
    dispatches."""
    real = getattr(sharded_msm, name)
    seen = []

    def spy(*args, **kwargs):
        seen.append(lanes_of(*args))
        return real(*args, **kwargs)

    monkeypatch.setattr(sharded_msm, name, spy)
    return seen


def _cold_lanes(digits, pts, *_):
    return digits.shape[0] * digits.shape[-1]


def _cached_lanes(head_digits, r_digits, *_):
    return r_digits.shape[0] * (head_digits.shape[-1] + r_digits.shape[-1])


def test_mesh_lanes_sum_to_each_cold_dispatch(monkeypatch):
    seen = _spy(monkeypatch, "sharded_window_sums_many", _cold_lanes)
    vs = _verifiers(3)
    got = _mesh_call(vs, chunk=2,
                     cache=devcache.DeviceOperandCache(enabled=False))
    st = batch.last_run_stats
    assert got == [True] * 3
    assert len(seen) == 2  # two chunks: 2 batches, then 1
    lanes = st["mesh_lanes"]
    assert sorted(lanes) == [0, 1, 2, 3]
    assert sum(lanes.values()) == sum(seen)
    assert len(set(lanes.values())) == 1  # equal shards
    assert st["device_ids"] == [0, 1, 2, 3]
    # (device_seconds is on the lane's health clock, held still here; the
    # tiny run holds the mesh seconds under it on the system clock)
    assert st["mesh_launch_seconds"] > 0 and st["mesh_gather_seconds"] > 0


def test_mesh_lanes_sum_to_each_resident_dispatch(monkeypatch):
    """The head-resident form: each shard's dispatch carries the head's
    lanes beside its slice of the R lanes, all of them counted."""
    seen = _spy(monkeypatch, "sharded_window_sums_many_cached",
                _cached_lanes)
    cache = devcache.DeviceOperandCache(enabled=True)
    keys = [T.SigningKey.new(rng) for _ in range(3)]
    for _ in range(3):  # cold, then the head built, then resident
        vs = _verifiers(1, sigs=6, keys=keys)
        assert _mesh_call(vs, chunk=1, cache=cache) == [True]
    st = batch.last_run_stats
    assert st["devcache"]["dispatch_hits"] == 1 and len(seen) >= 1
    assert sum(st["mesh_lanes"].values()) == seen[-1]


def test_single_lane_call_counts_no_mesh_lanes():
    vs = _verifiers(1)
    assert batch.verify_many(
        vs, hybrid=False, mesh=0, device="cpu",
        health=health.DeviceHealth(clock=health.FakeClock())) == [True]
    st = batch.last_run_stats
    assert st["mesh_lanes"] == {} and st["device_ids"] is None
    assert st["mesh_launch_seconds"] == 0 == st["mesh_gather_seconds"]


def test_mesh_spans_nest_under_the_device_call():
    metrics.disable_spans()
    metrics.drain_spans()
    metrics.enable_spans()
    try:
        vs = _verifiers(2)
        assert _mesh_call(
            vs, chunk=2,
            cache=devcache.DeviceOperandCache(enabled=False)) == [True] * 2
    finally:
        metrics.disable_spans()
    spans = metrics.drain_spans()
    (root,) = [s for s in spans
               if s[NAME] == "verify_many" and s[PARENT_ID] is None]
    spans = [s for s in spans if s[CALL_ID] == root[CALL_ID]]
    by_id = {s[SPAN_ID]: s for s in spans}
    calls = [s for s in spans if s[NAME] == "device_call"]
    assert len(calls) == 1
    for name in ("mesh.launch", "mesh.gather"):
        (s,) = [s for s in spans if s[NAME] == name]
        parent = by_id[s[PARENT_ID]]
        assert parent[NAME] == "device_call"
        assert parent[START] <= s[START] <= s[END] <= parent[END]
        assert s[THREAD] == parent[THREAD]
    launch, gather = (next(s for s in spans if s[NAME] == n)
                      for n in ("mesh.launch", "mesh.gather"))
    assert launch[END] <= gather[START]


# -- the cell's readers ------------------------------------------------------

def _ctx(stats_list, trace=None, sigs=1000):
    calls = [{"sigs": sigs, "stats": st} for st in stats_list]
    return harness.Context(record={"calls": calls}, trace=trace)


@pytest.mark.parametrize("name", MESH_METRICS)
def test_reader_reads_nothing_without_its_counter_or_trace(name):
    reader = harness.module_from("metrics", name)
    parent_stats = {"device_seconds": 0.5, "device_ids": None}
    assert reader.read(_ctx([parent_stats, parent_stats])) is None
    assert reader.read(_ctx([])) is None
    single = dict(parent_stats, mesh_launch_seconds=0.0,
                  mesh_gather_seconds=0.0, mesh_lanes={})
    assert reader.read(_ctx([single], trace={
        "kernel_seconds": {"window_sums_kernel": 0.25}})) is None


def test_offlead_share_is_three_quarters_over_four_positions():
    reader = harness.module_from("metrics", "mesh_offlead_lane_share")
    four = {"mesh_lanes": {0: 640, 1: 640, 2: 640, 3: 640},
            "device_ids": [0, 1, 2, 3]}
    virtual = {"mesh_lanes": {0: 2560}, "device_ids": [0, 0, 0, 0]}
    assert reader.read(_ctx([four, four])) == 0.75
    assert reader.read(_ctx([virtual])) == 0.0
    assert reader.read(_ctx([four, virtual])) == 0.375


def test_launch_and_fold_readers_per_signature():
    launch = harness.module_from("metrics", "mesh_launch_us_per_sig")
    fold = harness.module_from("metrics", "mesh_fold_us_per_sig")
    st = {"mesh_lanes": {0: 64}, "mesh_launch_seconds": 0.002,
          "device_ids": [0]}
    assert launch.read(_ctx([st, st], sigs=1000)) == pytest.approx(2.0)
    trace = {"kernel_seconds": {
        "fold_shards_kernel": 0.001,
        "Memcpy PtoP (Device -> Device)": 0.003,
        "Memcpy HtoD (Pageable -> Device)": 0.5,
        "window_sums_kernel": 0.7}}
    assert fold.read(_ctx([st, st], trace=trace, sigs=1000)) == \
        pytest.approx(2.0)


# -- on four cards -----------------------------------------------------------

@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs (the cell's mesh over cards)")


@pytest.mark.cuda
def test_cell_on_four_cards(four_cards):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL,
         "--seed", str(2**31 + 109), "--seconds", "8", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 4
    assert res["metrics"]["mesh_offlead_lane_share"]["value"] >= 0.74


if __name__ == "__main__":
    _child()
