"""The port's degraded mesh on the CPU: the ChipRegistry's liveness, the
reformation ladder, a chip lost mid-wave (the wave re-issued on the widest
surviving rung, on the device), and the port's rule where no rung is left:
DeviceError, no verdict decided on the host.  The cases of
tests/test_mesh_degrade.py that the port's mesh modules cover, on a virtual
mesh (`device="cpu"`, chips = shard positions) in a world of 8 chips — the
JAX package's 8 virtual host devices, here `routing.available_devices()`
set to 8.  Verdicts are held to the JAX package's (its host lane) and the
host oracle's; timing runs on health.FakeClock."""

import random

import numpy as np
import pytest
import torch

import ed25519_consensus_tpu as J
import ed25519_consensus_tpu_torch as T
from ed25519_consensus_tpu import batch as jbatch
from ed25519_consensus_tpu_torch import (batch, devcache, faults, health,
                                         routing)
from ed25519_consensus_tpu_torch.ops import msm
from ed25519_consensus_tpu_torch.parallel import sharded_msm

rng = random.Random(0xDE64)
_KEYS = [T.SigningKey.new(rng) for _ in range(4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker (the port tests' idiom)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def reset_state(monkeypatch):
    """Chip liveness is process-global: every test starts and ends with a
    healed registry, in a world of 8 chips."""
    monkeypatch.setenv("ED25519_TPU_MIN_LANES", "128")
    monkeypatch.setattr(routing, "_device_count", [8])
    batch.reset_device_health()
    yield
    faults.uninstall()
    devcache.set_default_cache(None)
    batch._DeviceLane.reset_all()
    batch.reset_device_health()
    batch.last_run_stats.clear()


def make_entries(n_batches, tag=b"md", bad=()):
    out = []
    for b in range(n_batches):
        ents = []
        for j, sk in enumerate(_KEYS):
            msg = b"%s-%d-%d" % (tag, b, j)
            sig = sk.sign(msg if not (b in bad and j == 0) else b"tampered")
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


def jax_verdicts(batches, monkeypatch):
    """The JAX package's verify_many verdicts on its host lane."""
    with monkeypatch.context() as m:
        m.setenv("ED25519_TPU_DISABLE_DEVICE", "1")
        vs = []
        for ents in batches:
            v = jbatch.Verifier()
            v.queue_bulk([(bytes(vk), J.Signature(s.R_bytes, s.s_bytes), mg)
                          for vk, s, mg in ents])
            vs.append(v)
        return jbatch.verify_many(vs, rng=rng, mesh=0, merge="never")


def fake_world():
    clock = health.FakeClock()
    health.chip_registry().set_clock(clock)
    return clock


def mesh_call(batches, mesh, clock, **kw):
    return batch.verify_many(
        port_verifiers(batches), rng=rng, chunk=2, hybrid=False,
        merge="never", mesh=mesh, device="cpu",
        health=kw.pop("health", None)
        or health.DeviceHealth(mesh=mesh, clock=clock), **kw)


# -- ChipRegistry and the ladder -------------------------------------------

def test_chip_registry_mark_heal_window_and_quarantine():
    clock = health.FakeClock()
    reg = health.ChipRegistry(clock=clock)
    reg.mark_chip_dead(3)                      # permanent
    reg.mark_chip_dead(5, heal_after=10.0)     # transient
    reg.mark_chip_dead(5, heal_after=1.0)      # never shortens a window
    assert reg.excluded_chips() == {3, 5}
    assert reg.healthy_count(8) == 6
    assert reg.surviving(4, 8) == (0, 1, 2, 4)
    assert reg.surviving(7, 8) is None
    clock.advance(10.5)
    assert reg.excluded_chips() == {3}          # 5 rejoined on read
    reg.quarantine_chip(6)
    assert reg.excluded_chips() == {3, 6} and reg.healthy_count(8) == 6
    assert reg.quarantined_chips() == {6}
    reg.heal_chip(3)
    reg.heal_chip(6)
    assert reg.excluded_chips() == frozenset()


def test_reform_for_walks_the_ladder():
    reg = health.chip_registry()
    for d in (1, 2, 4, 8):
        assert routing.reform_for(d) == (d, None)
    reg.mark_chip_dead(7)
    assert routing.reform_for(8) == (4, None)      # 7 healthy: rung 4
    for c in (4, 3, 6, 5):
        reg.mark_chip_dead(c)
    assert routing.reform_for(8) == (2, None)      # 3 healthy: rung 2
    for c in (2, 1):
        reg.mark_chip_dead(c)
    assert routing.reform_for(8) == (1, None)      # one card
    reg.mark_chip_dead(0)
    assert routing.reform_for(8) == (0, None)      # no rung


def test_reform_for_places_on_survivors():
    reg = health.chip_registry()
    reg.mark_chip_dead(1)
    assert routing.reform_for(2) == (2, (0, 2))
    reg.mark_chip_dead(0)
    assert routing.reform_for(2) == (2, (2, 3))
    assert routing.reform_for(1) == (1, (2,))


def test_chip_loss_marks_and_errors():
    plan = faults.FaultPlan([faults.ChipLoss((5, 6), on=1,
                                             heal_after=30.0)], seed=7)
    assert plan.run(faults.SITE_SHARDED, lambda: "ok") == "ok"
    with pytest.raises(faults.FatalChipError, match=r"chips \[5, 6\]"):
        plan.run(faults.SITE_SHARDED, lambda: "ok")
    assert health.chip_registry().excluded_chips() == {5, 6}
    ev = health.classify_device_error(faults.FatalChipError(
        "x", chips=(5,), chips_marked=True))
    assert ev.cls == health.ERROR_FATAL and ev.marked


# -- the scheduler: mid-wave reformation, and no rung left ------------------

@pytest.mark.parametrize("lost, rung, ids", [((1,), 2, [0, 2]),
                                             (range(1, 8), 0, None)])
def test_chip_loss_midwave_reforms_and_reissues(monkeypatch, lost, rung,
                                                ids):
    """A chip lost under a 2-shard wave: the mesh reforms (onto chips 0
    and 2, or down to the single lane on chip 0) and the wave's batches
    re-issue there — decided on the device, the JAX package's verdicts."""
    clock = fake_world()
    batches = make_entries(2, tag=b"reform", bad={1})
    plan = faults.FaultPlan([faults.ChipLoss(lost, on=0,
                                             heal_after=600.0)], seed=3)
    with faults.injected(plan):
        got = mesh_call(batches, 2, clock)
    st = dict(batch.last_run_stats)
    assert got == jax_verdicts(batches, monkeypatch) == [True, False]
    last = st["mesh_reformations"][-1]
    assert (last["from"], last["to"], last["device_ids"]) == (2, rung, ids)
    assert last["reissued"] == 2
    assert st["mesh"] == rung and st["device_ids"] == ids
    assert st["error_classes"]["fatal"] == 1
    assert st["device_batches"] + st["device_rejects_confirmed"] == 2
    assert st["host_batches"] == st["device_rejects_confirmed"] == 1
    assert not st["device_sick"]
    clock.advance(601.0)  # the heal window: the full width is back
    assert routing.reform_for(2) == (2, None)


def test_fatal_error_on_a_shard_marks_named_chip_and_reforms(monkeypatch):
    clock = fake_world()
    batches = make_entries(4, tag=b"fatal", bad={2})
    plan = faults.typed_error_plan(3, "fatal", at=0, chips=(1,),
                                   site=faults.SITE_SHARDED)
    with faults.injected(plan):
        got = mesh_call(batches, 2, clock)
    st = batch.last_run_stats
    assert got == jax_verdicts(batches, monkeypatch)
    assert health.chip_registry().excluded_chips() == {1}
    assert st["mesh_reformations"][-1]["device_ids"] == [0, 2]
    assert health.chip_registry().suspicion(0) == 0.0


def _sticky_on(monkeypatch, bad_call):
    """Make the per-shard dispatch raise a sticky CUDA error (700, an
    illegal address) on its `bad_call`-th call, once."""
    from ed25519_consensus_tpu_torch.ops import _cuda

    real = msm.dispatch_window_sums_many
    calls = []

    def dispatch(digits, pts, device=None):
        calls.append(str(device))
        if len(calls) == bad_call:
            raise _cuda.CudaError("window_sums", 700)
        return real(digits, pts, device)

    monkeypatch.setattr(msm, "dispatch_window_sums_many", dispatch)
    return calls


def test_sticky_error_names_the_chips_of_its_device(monkeypatch):
    """A sticky CUDA error raised while driving one device names the chips
    whose shards run there — the one card of a real mesh (here the second
    device of a cpu/meta placement), every shard of a virtual mesh — and
    the classifier carries them as the fatal error's chips."""
    digits = np.zeros((1, 17, 256), dtype=np.uint8)
    wire = np.zeros((1, 33, 256), dtype=np.uint8)
    wire[:, 0] = 1
    for devices, ids, named in ((["cpu", "meta"], None, (1,)),
                                (["cpu", "cpu"], None, (0, 1)),
                                (["cpu", "cpu"], (4, 6), (4, 6))):
        _sticky_on(monkeypatch, 2)
        with pytest.raises(RuntimeError) as e:
            sharded_msm.sharded_window_sums_many(
                digits, wire, 2, devices=devices, device_ids=ids)
        ev = health.classify_device_error(e.value)
        assert ev.cls == health.ERROR_FATAL and ev.chips == named


def test_virtual_mesh_on_a_card_names_that_card_only(monkeypatch):
    """On a card, every shard of a virtual mesh is that card's chip: a
    sticky error under a virtual 4-mesh on cuda:0 of a two-card host
    excludes chip 0 alone — cuda:1 stays placeable for the single lane —
    and a later virtual mesh on cuda:0 raises DeviceError instead of
    reforming.  On the CPU the chips stay shard positions."""
    from ed25519_consensus_tpu_torch.ops import _cuda
    from ed25519_consensus_tpu_torch.parallel import mesh as mesh_lib

    monkeypatch.setattr(routing, "_device_count", [2])
    assert mesh_lib.shard_chips(("cuda:0",) * 4) == (0, 0, 0, 0)
    assert mesh_lib.shard_chips(("cuda:1", "cuda:0")) == (1, 0)
    assert mesh_lib.shard_chips(("cpu",) * 3) == (0, 1, 2)
    assert mesh_lib.shard_chips(("cpu",) * 2, (4, 6)) == (4, 6)

    def dispatch(digits, pts, device=None):
        raise _cuda.CudaError("window_sums", 700)

    monkeypatch.setattr(msm, "dispatch_window_sums_many", dispatch)
    digits = np.zeros((1, 17, 256), dtype=np.uint8)
    wire = np.zeros((1, 33, 256), dtype=np.uint8)
    with pytest.raises(RuntimeError) as e:
        sharded_msm.sharded_window_sums_many(digits, wire, 4,
                                             devices=["cuda:0"] * 4)
    ev = health.classify_device_error(e.value)
    assert ev.cls == health.ERROR_FATAL and ev.chips == (0,)
    reg = health.chip_registry()
    for c in ev.chips:  # what verify_many does with a fatal error's chips
        reg.mark_chip_dead(c, reason="sticky")
    assert reg.excluded_chips() == {0}
    assert routing.healthy_device_count() == 1
    assert routing.reform_for(1) == (1, (1,))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(T.DeviceError, match="cuda:0 is excluded"):
        batch.verify_many(port_verifiers(make_entries(1, tag=b"vc")),
                          mesh=4, device="cuda:0", hybrid=False,
                          merge="never")


def test_sticky_error_on_a_shard_reforms_onto_other_chips(monkeypatch):
    """The scheduler marks the named chips dead (both shards of the
    virtual 2-mesh share the device) and never launches into them again:
    the wave re-issues on chips 2 and 3 and is decided on the device."""
    clock = fake_world()
    calls = _sticky_on(monkeypatch, 2)
    batches = make_entries(2, tag=b"sticky", bad={0})
    got = mesh_call(batches, 2, clock)
    st = batch.last_run_stats
    assert got == jax_verdicts(batches, monkeypatch) == [False, True]
    assert health.chip_registry().excluded_chips() == {0, 1}
    assert st["error_classes"]["fatal"] == 1
    assert st["mesh_reformations"][-1]["device_ids"] == [2, 3]
    assert st["host_batches"] == st["device_rejects_confirmed"] == 1
    assert len(calls) == 4  # the failed wave's two shards, then the new one


def test_no_rung_left_raises_and_decides_nothing_on_the_host():
    """Every chip lost under the wave: no rung to reform to, so the call
    raises DeviceError — no batch is decided on the host — and the failed
    rung cools down, so the next call raises too."""
    clock = fake_world()
    hp = health.DeviceHealth(mesh=2, clock=clock)
    plan = faults.FaultPlan([faults.ChipLoss(range(8), on=0)], seed=4)
    with faults.injected(plan):
        with pytest.raises(T.DeviceError, match="no reformation rung") as e:
            mesh_call(make_entries(2, tag=b"floor"), 2, clock, health=hp)
    assert isinstance(e.value.__cause__, faults.FatalChipError)
    st = batch.last_run_stats
    assert st["host_batches"] == 0 and st["device_batches"] == 0
    assert hp.in_cooldown()
    health.chip_registry().reset()
    with pytest.raises(T.DeviceError, match="cooling down"):
        mesh_call(make_entries(1, tag=b"cool"), 2, clock, health=hp)


def test_entry_reformation_places_on_survivors(monkeypatch):
    clock = fake_world()
    health.chip_registry().mark_chip_dead(1)
    batches = make_entries(3, tag=b"entry", bad={0})
    got = mesh_call(batches, 4, clock)
    st = batch.last_run_stats
    assert got == jax_verdicts(batches, monkeypatch)
    assert st["mesh"] == 4 and st["device_ids"] == [0, 2, 3, 4]
    assert st["mesh_reformations"] == [
        {"from": 4, "to": 4, "device_ids": [0, 2, 3, 4], "reissued": 0}]


def test_every_chip_excluded_raises_at_entry():
    clock = fake_world()
    for c in range(8):
        health.chip_registry().mark_chip_dead(c)
    with pytest.raises(T.DeviceError, match="every chip is excluded"):
        mesh_call(make_entries(1, tag=b"dead"), 2, clock)


def test_warm_device_shapes_premarks_the_reformation_rung(monkeypatch):
    """warm_device_shapes(mesh=4) warms the 4-shard dispatch and its
    2-shard reformation rung (a virtual mesh on the CPU)."""
    monkeypatch.setattr(msm, "_shapes_completed", set())
    v = port_verifiers(make_entries(1, tag=b"warm"))[0]
    batch.warm_device_shapes(v, rng=rng, chunk=2, device="cpu", mesh=4)
    n = v._stage(rng).n_device_terms
    for rung in (4, 2):
        assert msm.shape_completed(2, sharded_msm.shard_pad(n, rung), rung)
    assert not msm.shape_completed(2, sharded_msm.shard_pad(n, 8), 8)


def test_chip_drop_keeps_the_entry_and_drops_the_copies_it_read():
    cache = devcache.DeviceOperandCache(budget_bytes=1 << 26, enabled=True)
    devcache.set_default_cache(cache)
    d = devcache.keyset_digest(b"k" * 32)
    cache.build(d, 1, np.zeros((4, 20, 4), dtype=np.int16))
    e = cache.lookup(d)
    e.device_ref("cpu", chips=(0, 2))
    health.chip_registry().mark_chip_dead(1)   # reads no copy
    assert set(e._device_refs) == {"cpu"}
    health.chip_registry().mark_chip_dead(2)
    assert not e._device_refs
    assert cache.lookup(d) is not None and cache.counters["chip_drops"] == 1
