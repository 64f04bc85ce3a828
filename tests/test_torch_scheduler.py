"""The port's verify_many scheduler (`ed25519_consensus_tpu_torch.batch`) on
the CPU (`device="cpu"`: the lane's dispatches run the kernels' plain
versions), mirroring the JAX package's scheduler suite, where the port
differs on one rule: the host never decides what the device failed to.  A
device error, a deadline miss and a call during a cooldown raise
DeviceError where the JAX package decides on the host; only device
rejects are re-decided there.  Also covered: the typed error classes (a
sticky CUDA error is fatal and never retried), the first-call grace,
union-merge and bisection, discarded chunks, lane teardown, shape
warming, per-signature verdicts, and the entry points' refusal to fall
back to the CPU unasked.  Every verdict is held to the host oracle and,
where the JAX package has the same entry point, to its verdicts.
Timing-sensitive cases run on health.FakeClock, never on wall-time
bounds."""

import random
import threading
import time

import numpy as np
import pytest
import torch

import ed25519_consensus_tpu as J
from ed25519_consensus_tpu import batch as jbatch
import ed25519_consensus_tpu_torch as T
from ed25519_consensus_tpu_torch import (
    batch,
    devcache,
    faults,
    health,
    routing,
)
from ed25519_consensus_tpu_torch.ops import _cuda, msm
from ed25519_consensus_tpu_torch.ops.scalar import L

from torch_threads import _one_torch_thread  # noqa: F401


rng = random.Random(0x5C4ED)


@pytest.fixture(autouse=True)
def reset_device_state(monkeypatch):
    """One padded shape for the file, a fresh cache, and health state
    that never leaks; a test that abandoned a worker pays the join."""
    monkeypatch.setenv("ED25519_TPU_MIN_LANES", "128")
    devcache.set_default_cache(devcache.DeviceOperandCache(enabled=True))
    yield
    faults.uninstall()
    if health.any_lane_stuck():
        batch._DeviceLane.reset_all()
    devcache.set_default_cache(None)
    batch.reset_device_health()
    batch.last_run_stats.clear()


def fake_health() -> health.DeviceHealth:
    return health.DeviceHealth(clock=health.FakeClock())


def make_entries(n_batches, sigs_per_batch=3, bad=()):
    out = []
    for b in range(n_batches):
        ents = []
        for i in range(sigs_per_batch):
            sk = T.SigningKey.new(rng)
            msg = b"scheduler-%d-%d" % (b, i)
            sig = sk.sign(msg if (b not in bad or i != 0) else b"tampered")
            ents.append((sk.verification_key_bytes(), sig, msg))
        out.append(ents)
    return out


def port_verifiers(batches):
    out = []
    for ents in batches:
        v = batch.Verifier()
        v.queue_bulk(ents)
        out.append(v)
    return out


def jax_verifiers(batches):
    out = []
    for ents in batches:
        v = jbatch.Verifier()
        v.queue_bulk([(bytes(vk), J.Signature(s.R_bytes, s.s_bytes), m)
                      for vk, s, m in ents])
        out.append(v)
    return out


def make_verifiers(n_batches, sigs_per_batch=3, bad=()):
    return port_verifiers(make_entries(n_batches, sigs_per_batch, bad))


def expected(n_batches, bad=()):
    return [i not in bad for i in range(n_batches)]


def jax_verify_many(batches, monkeypatch, **kw):
    """The JAX package's verify_many on its host lane."""
    with monkeypatch.context() as m:
        m.setenv("ED25519_TPU_DISABLE_DEVICE", "1")
        return jbatch.verify_many(jax_verifiers(batches), rng=rng, mesh=0,
                                  **kw)


def warm_shapes():
    """The chunk shapes these tests dispatch count as completed, so the
    normal deadline (not the first-build grace) applies."""
    for nb in (1, 2):
        msm.mark_shape_completed(nb, 128)


def many(vs, **kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("rng", rng)
    return batch.verify_many(vs, **kw)


# -- device errors and their classes ---------------------------------------

def test_device_error_raises_never_decided_on_host(monkeypatch):
    """A kernel that raises (here as an nvcc build failure would) fails
    the call with DeviceError chained to it: the host decides no batch
    the device was asked to."""
    def boom(digits, pts, device=None):
        raise RuntimeError("nvcc failed: injected build error")

    monkeypatch.setattr(msm, "dispatch_window_sums_many", boom)
    batches = make_entries(6, bad={2})
    with pytest.raises(T.DeviceError, match="ambiguous") as ei:
        many(port_verifiers(batches), chunk=2, hybrid=False, merge="never")
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert "nvcc failed" in str(ei.value.__cause__)
    st = batch.last_run_stats
    assert st["device_batches"] == 0 and st["host_batches"] == 0
    assert st["error_classes"]["ambiguous"] == 1
    assert not st["device_sick"] and not batch.device_lane_stuck()
    # the JAX package decides the same batches on its host lane
    assert jax_verify_many(batches, monkeypatch, chunk=2,
                           merge="never") == expected(6, bad={2})


def test_kernel_build_failure_raises_before_the_lane(monkeypatch):
    """On a CUDA device the lane builds and loads every kernel before it
    starts: a build failure raises from verify_many in the caller's
    thread, before any batch is staged or verified."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(routing, "_device_count", [1])

    def broken_build():
        raise RuntimeError("nvcc failed:\nwindow_sums.cu: injected")

    monkeypatch.setattr(_cuda, "load_all", broken_build)
    staged = []
    monkeypatch.setattr(batch.Verifier, "_stage",
                        lambda self, rng: staged.append(1))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        batch.verify_many(make_verifiers(3), chunk=2, merge="never",
                          device="cuda:0", health=fake_health())
    assert not staged
    assert batch._DeviceLane._instances.get("cuda:0") is None


def test_error_chunk_ends_the_call(monkeypatch):
    """An error chunk ends the call, hybrid or not: exactly one device
    call, no retry of an unclassified error, and no cooldown — the next
    call goes to the device again and decides there."""
    warm_shapes()
    calls = []
    real = msm.dispatch_window_sums_many

    def boom_once(digits, pts, device=None):
        calls.append(digits.shape[0])
        if len(calls) == 1:
            raise RuntimeError("fast-failing device")
        return real(digits, pts, device)

    monkeypatch.setattr(msm, "dispatch_window_sums_many", boom_once)
    h = fake_health()
    with pytest.raises(T.DeviceError):
        many(make_verifiers(10, bad={3}), chunk=2, merge="never", health=h)
    assert len(calls) == 1
    assert not batch.last_run_stats["device_measured"]
    assert h.device_allowed()
    assert many(make_verifiers(4, bad={3}), chunk=2, hybrid=False,
                merge="never", health=h) == expected(4, bad={3})
    assert batch.last_run_stats["device_batches"] == 3


def test_transient_error_is_retried_and_decided_on_device():
    """A typed transient error retries the chunk (fresh blinders) after a
    bounded backoff on the virtual clock; the retry decides on the
    device."""
    warm_shapes()
    h = fake_health()
    vs = make_verifiers(4, bad={1})
    t0 = h.now()
    with faults.injected(faults.typed_error_plan(seed=1, kind="transient")):
        assert many(vs, chunk=2, hybrid=False, merge="never",
                    health=h) == expected(4, bad={1})
    st = batch.last_run_stats
    assert st["transient_retries"] == 1
    assert st["error_classes"]["transient"] == 1
    assert st["device_batches"] == 3
    assert st["device_rejects_confirmed"] == 1
    assert h.now() > t0  # the backoff advanced the virtual clock
    assert h.device_allowed()
    # past its two retries a transient error fails the call
    with faults.injected(faults.typed_error_plan(seed=1, kind="transient",
                                                 length=3)):
        with pytest.raises(T.DeviceError, match="transient"):
            many(make_verifiers(2), chunk=2, hybrid=False, merge="never",
                 health=h)
    assert batch.last_run_stats["transient_retries"] == 2


class _FakeAcceleratorError(RuntimeError):
    """Stands in for torch.AcceleratorError, matched by class name."""


_FakeAcceleratorError.__name__ = "AcceleratorError"


@pytest.mark.parametrize("err,cls", [
    (_cuda.CudaError("window_sums", 700), "fatal"),  # illegal address
    (_cuda.CudaError("window_sums", 719), "fatal"),  # launch failure
    (_cuda.CudaError("window_sums", 1), "ambiguous"),  # invalid value
    (RuntimeError("CUDA error: an illegal memory access was "
                  "encountered"), "fatal"),
    (_FakeAcceleratorError("device-side assert triggered"), "fatal"),
    (TimeoutError("slow"), "transient"),
    (ConnectionResetError("link"), "transient"),
    (faults.TransientDispatchError("x"), "transient"),
    (faults.FatalChipError("x", chips=(3,)), "fatal"),
    (faults.InjectedFault("x"), "ambiguous"),
    (RuntimeError("something else"), "ambiguous"),
    (None, "ambiguous"),
])
def test_error_classification(err, cls):
    ev = health.classify_device_error(err)
    assert ev.cls == cls
    liar = RuntimeError("lying marker")
    liar.device_error_class = "catastrophic"
    assert health.classify_device_error(liar).cls == "ambiguous"


def test_sticky_cuda_error_is_fatal_never_retried(monkeypatch):
    """A sticky CUDA error poisons the device's context: the call raises,
    the device cools down, and no retry goes back into the dead context —
    not within the call, and not on the next call, which raises too."""
    warm_shapes()
    calls = []

    def sticky(digits, pts, device=None):
        calls.append(digits.shape[0])
        raise _cuda.CudaError("window_sums", 700)

    monkeypatch.setattr(msm, "dispatch_window_sums_many", sticky)
    h = fake_health()
    vs = make_verifiers(4, bad={1})
    with pytest.raises(T.DeviceError, match="fatal") as ei:
        many(vs, chunk=2, hybrid=False, merge="never", health=h)
    assert isinstance(ei.value.__cause__, _cuda.CudaError)
    st = batch.last_run_stats
    assert len(calls) == 1
    assert st["error_classes"]["fatal"] == 1
    assert st["transient_retries"] == 0 and st["host_batches"] == 0
    assert not h.device_allowed() and h.in_cooldown()
    with pytest.raises(T.DeviceError, match="cooling down"):
        many(make_verifiers(3), chunk=2, hybrid=False, merge="never",
             health=h)
    assert len(calls) == 1  # the cooldown keeps the lane off the device


def test_lane_holds_the_next_chunk_until_the_error_is_read(monkeypatch):
    """The race behind a sticky error's second launch, made
    deterministic: the first chunk's dispatch raises while the second
    chunk waits in the lane's queue, and the caller's read of that error
    is held until the worker could have started the second chunk (it
    dispatches again) or 2 s have passed.  The worker must start nothing
    until the caller has read the error: the raising dispatch runs once,
    and the call raises DeviceError as before."""
    warm_shapes()
    calls = []
    second = threading.Event()

    def sticky(digits, pts, device=None):
        calls.append(digits.shape[0])
        if len(calls) > 1:
            second.set()
        raise _cuda.CudaError("window_sums", 700)

    real_wait = batch._DeviceLane.wait
    held = []

    def held_wait(self, cid, timeout):
        if not held:
            end = time.monotonic() + 10.0
            while time.monotonic() < end:
                with self._cv:
                    if cid in self._results:
                        break
                time.sleep(0.005)
            held.append(cid)
            second.wait(2.0)
        return real_wait(self, cid, timeout)

    monkeypatch.setattr(msm, "dispatch_window_sums_many", sticky)
    monkeypatch.setattr(batch._DeviceLane, "wait", held_wait)
    with pytest.raises(T.DeviceError, match="fatal"):
        many(make_verifiers(4), chunk=2, hybrid=False, merge="never",
             health=fake_health())
    assert held and len(calls) == 1
    assert not second.is_set()


class _HostFault(Exception):
    """A host-side failure inside verify_many (not a device error)."""


def test_host_exception_after_a_chunk_error_frees_the_lane(monkeypatch):
    """A chunk's dispatch raises, and before the caller reads that error
    the host lane raises on its own: verify_many leaves with the host's
    exception, and the errored chunk is dropped on the way out.  The
    next call on the same lane dispatches at once and decides on the
    device, with no deadline miss and no cooldown."""
    warm_shapes()
    calls = []
    real = msm.dispatch_window_sums_many

    def boom_once(digits, pts, device=None):
        calls.append(digits.shape[0])
        if len(calls) == 1:
            raise _cuda.CudaError("window_sums", 700)
        return real(digits, pts, device)

    lanes = []
    real_submit = batch._DeviceLane.submit

    def submit(self, *a, **kw):
        lanes.append(self)
        return real_submit(self, *a, **kw)

    def host_fault(verifier, rng):
        end = time.monotonic() + 10.0
        lane = lanes[0]
        while time.monotonic() < end and lane._held_error is None:
            time.sleep(0.005)
        assert lane._held_error is not None
        raise _HostFault("host lane failed")

    monkeypatch.setattr(msm, "dispatch_window_sums_many", boom_once)
    monkeypatch.setattr(batch._DeviceLane, "submit", submit)
    h = fake_health()
    with monkeypatch.context() as m:
        m.setattr(batch, "_host_verdict", host_fault)
        with pytest.raises(_HostFault):
            many(make_verifiers(6), chunk=2, merge="never", health=h)
    assert len(calls) == 1
    with lanes[0]._cv:
        assert lanes[0]._held_error is None  # the worker is free again
    assert h.device_allowed()
    assert many(make_verifiers(4, bad={3}), chunk=2, hybrid=False,
                merge="never", health=h) == expected(4, bad={3})
    st = batch.last_run_stats
    assert len(calls) == 3 and st["device_batches"] == 3
    assert not health.any_lane_stuck()


def test_placement_avoids_dead_cuda_devices(monkeypatch):
    """The single lane's placement check: with device 0 marked dead, the
    lane moves to the first surviving CUDA device, and with none left
    placement, and so verify_many, raises DeviceError."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(routing, "_device_count", [2])
    reg = health.chip_registry()
    assert batch._lane_device("cuda:0") == torch.device("cuda", 0)
    reg.mark_chip_dead(0)
    assert batch._lane_device("cuda:0") == torch.device("cuda", 1)
    reg.mark_chip_dead(1, heal_after=5.0)
    with pytest.raises(T.DeviceError, match="marked dead"):
        batch._lane_device("cuda:0")
    with pytest.raises(T.DeviceError, match="marked dead"):
        batch.verify_many(make_verifiers(1), device="cuda:0")
    reg.heal_chip(0)
    assert batch._lane_device("cuda:1") == torch.device("cuda", 0)
    assert routing.reform_for(1) == (1, None)
    assert routing.healthy_device_count() == 1


def test_corrupt_device_sum_is_overturned_on_the_host():
    """A corrupted device sum turns valid batches into device rejects;
    the host re-decides every one, so no valid batch fails."""
    warm_shapes()
    vs = make_verifiers(4, bad={2})
    plan = faults.FaultPlan([faults.CorruptSum(on=lambda i: True)], seed=3)
    with faults.injected(plan):
        assert many(vs, chunk=2, hybrid=False, merge="never",
                    health=fake_health()) == expected(4, bad={2})
    st = batch.last_run_stats
    assert st["device_rejects_overturned"] == 3
    assert st["device_rejects_confirmed"] == 1
    assert st["device_batches"] == 0


# -- deadlines, grace, cooldowns --------------------------------------------

def test_deadline_miss_abandons_lane_and_sets_cooldown(monkeypatch):
    warm_shapes()
    h = fake_health()
    release = threading.Event()

    def stall(digits, pts, device=None):
        h.clock.advance(1000.0)  # past the deadline and the build grace
        release.wait(timeout=30.0)
        raise RuntimeError("stalled call never completes")

    monkeypatch.setattr(msm, "dispatch_window_sums_many", stall)
    vs = make_verifiers(5, bad={0})
    t0 = h.now()
    try:
        with pytest.raises(T.DeviceError, match="deadline"):
            many(vs, chunk=2, hybrid=False, merge="never", health=h)
    finally:
        release.set()
    st = batch.last_run_stats
    assert st["device_sick"] and st["device_batches"] == 0
    assert st["host_batches"] == 0
    assert batch.device_lane_stuck() and h.lane_stuck
    assert h.cooldown_until > t0 and not h.device_allowed()
    assert batch._DeviceLane._instances.get("cpu") is None


def test_unwarmed_first_call_gets_compile_grace(monkeypatch):
    """An unwarmed shape's first call pays the device's lazy set-up: a
    call past the normal 2 s deadline but inside the grace is not sick,
    and the device decides every batch (the host only confirms its
    reject) — the grace never hands batches to the host."""
    monkeypatch.setattr(msm, "_shapes_completed", set())
    h = fake_health()
    real = msm.dispatch_window_sums_many
    calls = []

    def slow_first_call(digits, pts, device=None):
        calls.append(digits.shape[0])
        h.clock.advance(3.0)
        return real(digits, pts, device)

    monkeypatch.setattr(msm, "dispatch_window_sums_many", slow_first_call)
    vs = make_verifiers(3, bad={1})
    t0 = h.now()
    assert many(vs, chunk=2, hybrid=False, merge="never",
                health=h) == expected(3, bad={1})
    st = batch.last_run_stats
    assert calls and not st["device_sick"]
    assert not batch.device_lane_stuck() and h.cooldown_until <= t0
    assert h.now() - t0 <= 3.0 * len(calls)
    assert st["device_batches"] == 2 and st["device_rejects_confirmed"] == 1
    assert st["host_batches"] == 1


def test_cooldown_raises_without_touching_the_device(monkeypatch):
    """During a cooldown a call raises before it reaches the lane; an
    uncompetitive pause (not a cooldown) sends a hybrid call to the host
    lane and leaves a forced-device call on the device."""
    h = fake_health()
    h.note_deadline_miss()
    assert not h.device_allowed() and h.in_cooldown()
    real_get = batch._DeviceLane.get.__func__

    def fail_get(cls, device, health=None):
        raise AssertionError("device lane used during cooldown")

    with monkeypatch.context() as m:
        m.setattr(batch._DeviceLane, "get", classmethod(fail_get))
        for hybrid in (True, False):
            with pytest.raises(T.DeviceError, match="cooling down"):
                many(make_verifiers(4, bad={3}), merge="never", health=h,
                     hybrid=hybrid)
    h.clock.advance(h.DEADLINE_COOLDOWN + 1.0)
    assert h.device_allowed() and not h.in_cooldown()
    h.note_uncompetitive()
    assert not h.device_allowed() and not h.in_cooldown()
    assert many(make_verifiers(4, bad={3}), merge="never",
                health=h) == expected(4, bad={3})
    assert batch.last_run_stats["host_batches"] == 4
    warm_shapes()
    monkeypatch.setattr(batch._DeviceLane, "get", classmethod(real_get))
    assert many(make_verifiers(4, bad={3}), chunk=2, merge="never",
                health=h, hybrid=False) == expected(4, bad={3})
    assert batch.last_run_stats["device_batches"] == 3


def test_unresolved_probe_streak_arms_backoff(monkeypatch):
    """A hybrid probe the host overtakes before it reports (its call
    outlasts the young-probe grace, inside its deadline) measures
    nothing; a streak of them pauses hybrid probing."""
    warm_shapes()
    monkeypatch.setenv("ED25519_TPU_EMA_PRIOR", "10")  # deadline 60 s
    h = fake_health()
    calls, gates = [], []
    real = msm.dispatch_window_sums_many

    def slow_probe(digits, pts, device=None):
        calls.append(digits.shape[0])
        h.clock.advance(h.young_probe_grace + 2.0)
        gates[len(calls) - 1].wait(timeout=30.0)
        return real(digits, pts, device)

    monkeypatch.setattr(msm, "dispatch_window_sums_many", slow_probe)
    for i in range(h.UNRESOLVED_PROBE_LIMIT):
        gates.append(threading.Event())
        try:
            assert many(make_verifiers(8, bad={1}), chunk=2, merge="never",
                        health=h) == expected(8, bad={1})
        finally:
            gates[-1].set()
        st = batch.last_run_stats
        assert st["probed"] and not st["device_measured"]
        assert st["host_batches"] == 8
        assert h.unresolved_probe_streak == i + 1
    assert not h.device_allowed() and not h.in_cooldown()
    n = len(calls)
    assert many(make_verifiers(8), chunk=2, merge="never",
                health=h) == expected(8)
    assert len(calls) == n and not batch.last_run_stats["probed"]


# -- union merge and bisection ----------------------------------------------

def test_merge_union_all_valid_stream(monkeypatch):
    batches = make_entries(24, sigs_per_batch=4)
    assert many(port_verifiers(batches), merge="always") == expected(24) \
        == jax_verify_many(batches, monkeypatch, merge="always")
    assert batch.last_run_stats["merged_unions"] >= 1
    assert batch.last_run_stats["batches"] == 24


@pytest.mark.parametrize("bad", [{3, 17}, {0}, {19}])
def test_merge_union_bisects_bad_batches(bad, monkeypatch):
    batches = make_entries(20, sigs_per_batch=4, bad=bad)
    assert many(port_verifiers(batches), merge="always") == \
        expected(20, bad=bad) == jax_verify_many(batches, monkeypatch,
                                                 merge="always")


def test_merge_union_handles_malformed_staging(monkeypatch):
    batches = make_entries(8, sigs_per_batch=3)
    sk = T.SigningKey.new(rng)
    sig = sk.sign(b"malformed-s")
    batches[5].append((sk.verification_key_bytes(),
                       T.Signature(sig.R_bytes,
                                   int(L).to_bytes(32, "little")),
                       b"malformed-s"))
    assert many(port_verifiers(batches), merge="always") == \
        expected(8, bad={5}) == jax_verify_many(batches, monkeypatch,
                                                merge="always")


def test_merge_groups_and_members(monkeypatch):
    vs = make_verifiers(10, sigs_per_batch=2)
    monkeypatch.setattr(batch, "_MERGE_TARGET_SIGS", 6)
    groups = batch._merge_groups(vs)
    assert [i for g in groups for i in g] == list(range(10))
    assert all(sum(vs[i].batch_size for i in g) >= 6 for g in groups[:-1])
    u = batch.merge_verifiers(vs)
    assert u.batch_size == 20 and u._buffers_live()
    assert u.distinct_key_count == 20
    # exposed members still merge, and the union never aliases them
    before = [len(lst) for v in vs for lst in v.signatures.values()]
    u = batch.merge_verifiers(vs)
    for lst in u.signatures.values():
        lst.clear()
    assert [len(lst) for v in vs for lst in v.signatures.values()] == \
        before


def test_clone_content_digest_and_invalidate(monkeypatch):
    batches = make_entries(2, sigs_per_batch=5)
    v = port_verifiers(batches)[0]
    jv = jax_verifiers(batches)[0]
    c = v.clone()
    assert c._buffers_live() and c.content_digest() == v.content_digest()
    assert v.content_digest() == jv.content_digest()
    assert v.distinct_key_count == 5 and not v._map_exposed
    cache = devcache.default_cache()
    e0 = cache.epoch
    c.invalidate("operator said so")
    assert cache.epoch == e0 + 1 and c.content_digest() is None
    assert many([v, c], merge="never", health=fake_health()) == \
        [True, False]
    u = batch.merge_verifiers([v, c])
    assert u.invalid_reason == "operator said so"


# -- the lane ------------------------------------------------------------------

def test_discarded_queued_chunk_is_never_dispatched(monkeypatch):
    gate = threading.Event()
    calls = []

    def gated(digits, pts, device=None):
        calls.append(digits.shape[0])
        gate.wait(timeout=10.0)
        return torch.zeros((digits.shape[0], 4, 20, 33), dtype=torch.int32)

    monkeypatch.setattr(msm, "dispatch_window_sums_many", gated)
    lane = batch._DeviceLane.get("cpu", health=fake_health())
    d = np.zeros((1, 33, 8), dtype=np.int8)
    p = np.zeros((1, 33, 8), dtype=np.uint8)
    first = lane.submit(d, p)
    deadline = time.monotonic() + 5.0
    while lane.started_at(first) is None and time.monotonic() < deadline:
        time.sleep(0.01)
    queued = lane.submit(d, p)
    lane.discard(queued)
    gate.set()
    assert lane.wait(first, 10.0) is not batch._PENDING
    time.sleep(0.3)
    assert calls == [1]
    assert queued not in lane._results


def test_reset_all_abandons_worker_that_outlives_deadline(monkeypatch):
    release = threading.Event()

    def blocked(digits, pts, device=None):
        release.wait(timeout=30.0)
        return torch.zeros((digits.shape[0], 4, 20, 33), dtype=torch.int32)

    monkeypatch.setattr(msm, "dispatch_window_sums_many", blocked)
    lane = batch._DeviceLane.get("cpu")
    d = np.zeros((1, 33, 8), dtype=np.int8)
    p = np.zeros((1, 33, 8), dtype=np.uint8)
    cid = lane.submit(d, p)
    deadline = time.monotonic() + 5.0
    while lane.started_at(cid) is None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert lane.started_at(cid) is not None
    lane.discard(cid)
    try:
        assert not batch._DeviceLane.reset_all(timeout=0.3)
        assert batch._DeviceLane._instances.get("cpu") is not lane
        assert lane._abandoned and not lane.healthy()
        assert lane in batch._DeviceLane._abandoned_instances
        assert batch.device_lane_stuck()
        fresh = batch._DeviceLane.get("cpu")
        assert fresh is not lane and fresh.healthy()
    finally:
        release.set()
    assert batch._DeviceLane.reset_all(timeout=10.0)
    assert lane not in batch._DeviceLane._abandoned_instances
    assert not lane._thread.is_alive()


@pytest.mark.parametrize("cache_on,tables_on,forms", [
    (False, True, ["cold"]), (True, False, ["cold", "head"]),
    (True, True, ["cold", "head", "tables"])])
def test_warm_device_shapes_runs_each_dispatch_form(cache_on, tables_on,
                                                    forms, monkeypatch):
    seen = []
    main = threading.get_ident()
    for name, form in (("dispatch_window_sums_many", "cold"),
                       ("dispatch_window_sums_many_cached", "head"),
                       ("dispatch_window_sums_many_tables", "tables")):
        real = getattr(msm, name)

        def spy(*a, real=real, form=form, **k):
            # main-thread calls only: a lane worker of an earlier test may
            # still be draining a discarded chunk
            if threading.get_ident() == main:
                seen.append((form, a[0].shape[0]))
            return real(*a, **k)

        monkeypatch.setattr(msm, name, spy)
    monkeypatch.setattr(msm, "_shapes_completed", set())
    monkeypatch.setenv("ED25519_TPU_DEVCACHE_TABLES",
                       "1" if tables_on else "0")
    devcache.set_default_cache(devcache.DeviceOperandCache(enabled=cache_on))
    v = make_verifiers(1)[0]
    batch.warm_device_shapes(v, rng=rng, chunk=2, device="cpu")
    assert seen == [(f, 2) for f in forms]
    for variant in range(len(forms)):
        assert msm.shape_completed(2, 128, cached=variant)


# -- routing, entry points, per-signature verdicts -------------------------

def test_mesh_routing_is_the_single_lane(monkeypatch):
    """Auto routing with no card (or a device named) and mesh=1 are the
    single lane; mesh=4 runs four shards on the device named, and raises
    without one when fewer cards are visible."""
    vs = make_verifiers(3)
    assert many(vs, merge="never", mesh=None,
                health=fake_health()) == expected(3)
    assert batch.last_run_stats["mesh"] == 0
    assert many(vs, merge="never", mesh=1,
                health=fake_health()) == expected(3)
    assert many(vs, merge="never", mesh=4,
                health=fake_health()) == expected(3)
    assert batch.last_run_stats["mesh"] == 4
    with pytest.raises(ValueError, match="requested 4 CUDA devices"):
        batch.verify_many(vs, mesh=4)


def test_disable_device_runs_the_host_lane(monkeypatch):
    monkeypatch.setenv("ED25519_TPU_DISABLE_DEVICE", "1")

    def fail_get(cls, device, health=None):
        raise AssertionError("device lane used with the device disabled")

    monkeypatch.setattr(batch._DeviceLane, "get", classmethod(fail_get))
    # no device argument: the host lane needs no card
    assert batch.verify_many(make_verifiers(4, bad={0}), rng=rng,
                             merge="never") == expected(4, bad={0})
    assert routing.available_devices() == 0


def test_entry_points_raise_without_cuda(monkeypatch):
    """verify_many, warm_device_shapes, build_multiples_tables and
    verify_single_many take device=None as CUDA and raise without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    v = make_verifiers(1)[0]
    pts = np.zeros((1, 4, 20, 64), dtype=np.int16)
    for call in (lambda: batch.verify_many([v]),
                 lambda: batch.warm_device_shapes(v),
                 lambda: msm.build_multiples_tables(pts),
                 lambda: batch.verify_single_many([])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert batch.verify_many([v], device="cpu") == [True]
    assert msm.build_multiples_tables(pts, device="cpu").shape == \
        (1, 9, 4, 20, 64)


def test_verify_single_many_matches_reference(monkeypatch):
    good = [e for ents in make_entries(6, sigs_per_batch=2) for e in ents]
    entries = [(vk, s, m) for vk, s, m in good]
    vk, sig, _ = entries[3]
    entries[3] = (vk, sig, b"tampered")
    entries.append((b"\x01" * 31, sig, b"short key"))
    entries.append((vk, bytes(sig)[:40], b"short sig"))
    want = [i != 3 for i in range(len(good))] + [False, False]
    got = batch.verify_single_many(entries, rng=rng, device="cpu")
    jentries = [(vk, J.Signature(s.R_bytes, s.s_bytes)
                 if isinstance(s, T.Signature) else s, m)
                for vk, s, m in entries]
    with monkeypatch.context() as m:
        m.setenv("ED25519_TPU_DISABLE_DEVICE", "1")
        ref = jbatch.verify_single_many(jentries, rng=rng)
    assert got == want == ref


def test_hybrid_defaults_decide_every_batch_once(monkeypatch):
    """verify_many's defaults (merge auto, hybrid): every batch decided,
    host and device lanes together, verdicts the host oracle's."""
    batches = make_entries(9, bad={4, 7})
    assert many(port_verifiers(batches), chunk=3, merge="never",
                health=fake_health()) == expected(9, bad={4, 7}) == \
        jax_verify_many(batches, monkeypatch, chunk=3, merge="never")
    st = batch.last_run_stats
    assert st["host_batches"] + st["device_batches"] + \
        st["device_rejects_confirmed"] >= 9
    assert st["batches"] == 9 and st["sigs"] == 27


def test_forced_device_never_decides_on_the_host_when_chunks_finish_early(
        monkeypatch):
    """hybrid=False: when both in-flight chunks finish before the scheduler
    polls them, the rest is submitted to the device — no batch is decided
    on the host (the host took one batch per such turn before)."""
    real = batch._DeviceLane.submit

    def submit_and_finish(self, *a, **k):
        cid = real(self, *a, **k)
        with self._cv:
            while cid not in self._results:
                self._cv.wait(0.01)
        return cid

    monkeypatch.setattr(batch._DeviceLane, "submit", submit_and_finish)
    warm_shapes()
    assert many(make_verifiers(7, bad={5}), chunk=1, hybrid=False,
                merge="never", health=fake_health()) == expected(7, bad={5})
    st = batch.last_run_stats
    assert st["device_batches"] == 6 and st["device_rejects_confirmed"] == 1
    assert st["host_batches"] == 1  # the reject's host confirmation only


def test_config_knobs_parse(monkeypatch):
    from ed25519_consensus_tpu_torch import config

    monkeypatch.setenv("ED25519_TPU_EMA_PRIOR", "fast")
    with pytest.raises(config.ConfigError, match="ED25519_TPU_EMA_PRIOR"):
        many(make_verifiers(1), merge="never")
    monkeypatch.delenv("ED25519_TPU_EMA_PRIOR")
    monkeypatch.setenv("ED25519_TPU_DISABLE_NATIVE", "false")
    assert config.get("ED25519_TPU_DISABLE_NATIVE") is False
    monkeypatch.setenv("ED25519_TPU_DEVCACHE", "no")
    assert config.get("ED25519_TPU_DEVCACHE") is False
    assert config.get("ED25519_TPU_WIRE") == "compressed"
    monkeypatch.setenv("ED25519_TPU_WIRE", "Affine")
    assert config.get("ED25519_TPU_WIRE") == "affine"
    monkeypatch.setenv("ED25519_TPU_WIRE", "extended")  # not a wire choice
    assert config.get("ED25519_TPU_WIRE") == "compressed"
    monkeypatch.delenv("ED25519_TPU_WIRE")
    monkeypatch.setenv("ED25519_TPU_SENTINEL_RATE", "often")
    with pytest.raises(config.ConfigError,
                       match="ED25519_TPU_SENTINEL_RATE"):
        many(make_verifiers(1), merge="never")
    monkeypatch.delenv("ED25519_TPU_SENTINEL_RATE")
    with config.override(ED25519_TPU_DIGIT_WIRE="plain"):
        staged = make_verifiers(1)[0]._stage(rng)
        digits, _ = staged.device_operands(msm.pad_lanes)
        assert digits.dtype == np.int8 and digits.shape[0] == 33
