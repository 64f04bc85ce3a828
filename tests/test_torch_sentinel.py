"""The port's sentinel audit and suspicion ledger on the CPU (virtual
meshes on `device="cpu"`, chips = shard positions, in a world of 8 chips
as the JAX package's tests have): the cases of tests/test_sentinel.py that
the port's mesh modules cover, under the port's rule — a divergence records
the attributed suspicion, as the JAX package does, and then raises
DeviceError naming the chips instead of re-deciding the chunk on the host.
Timing runs on health.FakeClock."""

import random

import pytest

import ed25519_consensus_tpu as J
import ed25519_consensus_tpu_torch as T
from ed25519_consensus_tpu import batch as jbatch
from ed25519_consensus_tpu import health as jhealth
from ed25519_consensus_tpu_torch import (batch, carry, devcache, faults,
                                         health, routing)

from torch_threads import _one_torch_thread  # noqa: F401


rng = random.Random(0x5E471E1)
_KEYS = [T.SigningKey.new(rng) for _ in range(3)]


@pytest.fixture(autouse=True)
def reset_state(monkeypatch):
    """Cold chunks only (the audit samples cold mesh chunks, and these
    tests' keyset recurs), a world of 8 chips, a fresh chip ledger."""
    monkeypatch.setattr(routing, "_device_count", [8])
    devcache.set_default_cache(devcache.DeviceOperandCache(enabled=False))
    batch.reset_device_health()
    health.chip_registry().set_clock(health.FakeClock())
    yield
    devcache.set_default_cache(None)
    faults.uninstall()
    batch._DeviceLane.reset_all()
    batch.reset_device_health()
    batch.last_run_stats.clear()


def make_verifiers(n_batches, sigs_per_batch=70, bad=()):
    """Batches of 70 signatures over 3 keys: 78 terms, so a 2-shard mesh
    (two 64-lane shards) holds real terms on both shards."""
    out = []
    for b in range(n_batches):
        v = batch.Verifier()
        for i in range(sigs_per_batch):
            sk = _KEYS[i % 3]
            msg = b"sentinel-%d-%d" % (b, i)
            sig = sk.sign(msg if (b not in bad or i != 0) else b"tampered")
            v.queue((sk.verification_key_bytes(), sig, msg))
        out.append(v)
    return out


def host_verdicts(vs):
    return [batch._host_verdict(v.clone(), rng) for v in vs]


def mesh_call(vs, mesh=2, **kw):
    return batch.verify_many(
        vs, rng=rng, chunk=2, hybrid=False, merge="never", mesh=mesh,
        device="cpu", health=health.DeviceHealth(
            mesh=mesh, clock=health.chip_registry().clock), **kw)


def test_clean_mesh_audits_pass_and_the_device_decides():
    vs = make_verifiers(4, bad={2})
    hv = host_verdicts(vs)
    assert mesh_call(vs, sentinel_rate=1.0) == hv
    st = batch.last_run_stats
    assert st["sentinel"]["audits"] == 2 and st["sentinel"]["divergence"] == 0
    assert st["device_batches"] == 3 and st["device_rejects_confirmed"] == 1
    assert health.chip_registry().excluded_chips() == frozenset()


@pytest.mark.parametrize("flip_accept", [False, True])
def test_corrupt_chip_is_attributed_and_the_call_raises(flip_accept):
    """Chip 1 corrupts its partial sums (randomly, or into a forged
    accept): the audit recomputes its shard on the host, names chip 1,
    records its suspicion — and the call raises DeviceError: no verdict
    of the distrusted chunk, or of any other, is published."""
    vs = make_verifiers(4, bad={0})
    plan = faults.FaultPlan([faults.CorruptChipSum(
        chip=1, on=lambda i: True, flip_accept=flip_accept)], seed=7)
    with faults.injected(plan):
        with pytest.raises(T.DeviceError, match=r"chips \[1\]"):
            mesh_call(vs, sentinel_rate=1.0)
    st = batch.last_run_stats
    assert st["sentinel"]["divergence"] == 1
    assert st["sentinel"]["attributed"] == [1]
    assert st["device_batches"] == st["host_batches"] == 0
    reg = health.chip_registry()
    assert reg.suspicion(1) == pytest.approx(health.SENTINEL_SUSPICION)
    assert reg.suspicion(0) == 0.0
    assert reg.chip_state(1) == health.STATE_SUSPECTED


def test_forged_accept_passes_without_the_audit():
    """The control: with the audit off, a chip forging identity window
    sums makes the device ACCEPT a tampered batch — the corruption only
    the audit can see (host confirmation covers rejects only)."""
    vs = make_verifiers(2, bad={1})
    assert host_verdicts(vs) == [True, False]
    plan = faults.FaultPlan([faults.CorruptChipSum(
        chip=0, on=lambda i: True, flip_accept=True)], seed=8)
    with faults.injected(plan):
        assert mesh_call(vs, sentinel_rate=0.0) == [True, True]
    assert batch.last_run_stats["sentinel"]["audits"] == 0


def test_repeated_divergence_quarantines_and_the_mesh_reforms():
    """A persistent corruptor crosses the threshold (2 × 1.5 = 3.0) and is
    quarantined; the next call reforms placement around it and audits
    clean."""
    plan = faults.FaultPlan([faults.CorruptChipSum(
        chip=1, on=lambda i: True)], seed=9)
    reg = health.chip_registry()
    with faults.injected(plan):
        for _ in range(2):
            with pytest.raises(T.DeviceError):
                mesh_call(make_verifiers(2), sentinel_rate=1.0)
    assert reg.chip_state(1) == health.STATE_QUARANTINED
    assert reg.excluded_chips() == {1}
    vs = make_verifiers(2, bad={0})
    assert mesh_call(vs, sentinel_rate=1.0) == host_verdicts(vs)
    st = batch.last_run_stats
    assert st["device_ids"] == [0, 2]
    assert st["sentinel"]["audits"] == 1 and st["sentinel"]["divergence"] == 0


def test_ambiguous_mesh_error_smears_suspicion_and_raises():
    vs = make_verifiers(2)
    plan = faults.typed_error_plan(4, "ambiguous", at=0, length=64,
                                   site=faults.SITE_SHARDED)
    with faults.injected(plan):
        with pytest.raises(T.DeviceError, match="ambiguous"):
            mesh_call(vs)
    reg = health.chip_registry()
    assert [reg.suspicion(c) for c in (0, 1, 2)] == [
        health.AMBIGUOUS_SUSPICION, health.AMBIGUOUS_SUSPICION, 0.0]
    assert reg.chip_state(0) == health.STATE_SUSPECTED
    assert reg.excluded_chips() == frozenset()
    assert batch.last_run_stats["host_batches"] == 0


def test_suspicion_accumulates_decays_and_quarantines():
    clk = health.FakeClock()
    reg = health.chip_registry()
    reg.set_clock(clk)
    drops = []
    health.register_chip_drop_listener(
        lambda chip, reason, _d=drops: _d.append((chip, reason)))
    assert reg.record_suspicion(5, 1.5, "audit-1") == health.STATE_SUSPECTED
    clk.advance(300.0)  # one half-life
    assert reg.suspicion(5) == pytest.approx(0.75)
    reg.record_suspicion(5, 1.5, "audit-2")
    assert reg.record_suspicion(5, 1.5, "audit-3") == \
        health.STATE_QUARANTINED
    assert 5 in reg.excluded_chips() and 5 in reg.quarantined_chips()
    assert any(c == 5 and "quarantine" in r for c, r in drops)
    clk.advance(3000.0)  # decay relaxes to probation, which stays out
    assert reg.chip_state(5) == health.STATE_PROBATION
    assert 5 in reg.excluded_chips() and 5 in reg.probation_chips()
    reg.heal_chip(5)
    assert reg.chip_state(5) == health.STATE_HEALTHY


def test_rate_zero_never_audits_and_sampling_is_deterministic():
    vs = make_verifiers(2)
    assert mesh_call(vs, sentinel_rate=0.0) == [True, True]
    assert batch.last_run_stats["sentinel"]["audits"] == 0
    fires = [batch._sentinel_fires(0.5, i) for i in range(64)]
    assert fires == [jbatch._sentinel_fires(0.5, i) for i in range(64)]
    assert any(fires) and not all(fires)
    assert [batch._sentinel_draw(i, "shard", 4) for i in range(16)] == \
        [jbatch._sentinel_draw(i, "shard", 4) for i in range(16)]


def test_shard_recomputation_matches_reference_planes():
    """The audit's lane values equal the JAX package's digit-plane decode
    (both digit wires), and its shard sum the host MSM of the lanes."""
    import numpy as np

    from ed25519_consensus_tpu_torch.ops import limbs

    staged = make_verifiers(1, sigs_per_batch=5)[0]._stage(rng)
    d, w = staged.device_operands(lambda n: 128)
    plain = np.zeros((limbs.NWINDOWS, 128), np.int8)
    for wi in range(limbs.NWINDOWS):
        lo = ((d[wi // 2] >> (4 * (wi % 2))) & 0xF).astype(np.int16)
        plain[wi] = np.where(lo >= 8, lo - 16, lo)
    for digits in (d, plain):
        vals = batch._sentinel_lane_values(digits)
        planes = jbatch._sentinel_digit_planes(digits)
        want = [sum(int(planes[k, lane]) * 16 ** (32 - k)
                    for k in range(limbs.NWINDOWS)) for lane in range(128)]
        assert vals == want
    jsum = jbatch._sentinel_shard_sum(jbatch._sentinel_digit_planes(d), w,
                                      0, 64)
    mine = batch._sentinel_shard_sum(vals, w, 0, 64)
    assert (mine.X * jsum.Z - jsum.X * mine.Z) % (2 ** 255 - 19) == 0
    assert (mine.Y * jsum.Z - jsum.Y * mine.Z) % (2 ** 255 - 19) == 0


def test_reference_registry_snapshot_carries_across():
    ref = jhealth.ChipRegistry(clock=jhealth.FakeClock())
    ref.mark_chip_dead(3)
    ref.record_suspicion(1, 1.5, "audit")
    ref.record_suspicion(6, 3.0, "storm")
    reg = carry.chip_registry_from_reference(
        ref.chip_states(), health.ChipRegistry(clock=health.FakeClock()))
    assert reg.excluded_chips() == ref.excluded_chips() == {3, 6}
    assert reg.suspicion(1) == pytest.approx(ref.suspicion(1))
    assert reg.chip_state(1) == health.STATE_SUSPECTED
    assert reg.chip_state(6) == health.STATE_QUARANTINED
    assert J.__name__ == "ed25519_consensus_tpu"


def test_reference_snapshot_with_probation_carries_state_for_state():
    """A reference snapshot holding dead, quarantined, probation (one clean
    probe in) and suspected chips carries as it stands: the port's
    chip_states() equals it state for state, its excluded chips equal the
    reference's, and both ladders go on identically — the probation chip
    rejoins on the same probe in both."""
    clock = jhealth.FakeClock()
    ref = jhealth.ChipRegistry(clock=clock)
    ref.mark_chip_dead(3)
    ref.record_suspicion(1, 1.5, "audit")
    ref.record_suspicion(6, 3.0, "storm")
    ref.record_suspicion(2, 3.0, "storm")
    clock.advance(900.0)
    ref.record_suspicion(6, 3.0, "storm again")
    assert ref.record_probation_pass(2) is False
    snap = ref.chip_states()
    assert {c: st["state"] for c, st in snap.items()} == {
        1: "suspected", 2: "probation", 3: "dead", 6: "quarantined"}
    reg = carry.chip_registry_from_reference(
        snap, health.ChipRegistry(clock=health.FakeClock()))
    assert reg.chip_states() == snap
    assert reg.excluded_chips() == ref.excluded_chips() == {2, 3, 6}
    assert reg.probation_chips() == ref.probation_chips() == {2}
    assert reg.quarantined_chips() == ref.quarantined_chips() == {6}
    for _ in range(2):
        assert reg.record_probation_pass(2) == ref.record_probation_pass(2)
    assert reg.chip_state(2) == ref.chip_state(2) == health.STATE_HEALTHY
    assert reg.excluded_chips() == ref.excluded_chips() == {3, 6}


def test_quarantine_relaxes_to_probation_then_rejoins():
    clk = health.FakeClock()
    reg = health.chip_registry()
    reg.set_clock(clk)
    reg.record_suspicion(2, 3.0, "storm")
    assert reg.chip_state(2) == health.STATE_QUARANTINED
    clk.advance(900.0)  # 3 half-lives: 3.0 → 0.375, under half the threshold
    assert reg.chip_state(2) == health.STATE_PROBATION
    assert 2 in reg.excluded_chips()
    assert not reg.record_probation_pass(2)
    assert not reg.record_probation_pass(2)
    assert reg.record_probation_pass(2)
    assert reg.chip_state(2) == health.STATE_HEALTHY
    assert reg.excluded_chips() == frozenset() and reg.suspicion(2) == 0.0


def test_probation_fail_requarantines_with_fresh_suspicion():
    clk = health.FakeClock()
    reg = health.chip_registry()
    reg.set_clock(clk)
    reg.record_suspicion(4, 3.0, "storm")
    clk.advance(900.0)
    assert reg.chip_state(4) == health.STATE_PROBATION
    assert not reg.record_probation_pass(4)
    reg.record_probation_fail(4)
    assert reg.chip_state(4) == health.STATE_QUARANTINED
    assert reg.suspicion(4) >= 3.0
    clk.advance(1200.0)  # the full streak again after the next window
    assert reg.chip_state(4) == health.STATE_PROBATION
    assert not reg.record_probation_pass(4)


def test_probation_chip_rejoins_the_mesh_at_full_width():
    """A corruptor quarantined by the audit decays to probation, passes its
    probes on the CPU and rejoins: the next call runs the full 2-mesh with
    no reformation and audits clean."""
    plan = faults.sentinel_plan(9, "corrupt-chip", chip=1, on=lambda i: True)
    reg = health.chip_registry()
    with faults.injected(plan):
        for _ in range(2):
            with pytest.raises(T.DeviceError):
                mesh_call(make_verifiers(2), sentinel_rate=1.0)
    assert reg.chip_state(1) == health.STATE_QUARANTINED
    reg.clock.advance(1800.0)
    assert reg.probation_chips() == {1}
    for _ in range(3):
        assert batch.run_probation_probe(
            make_verifiers(1, sigs_per_batch=6)[0], 1, rng=rng,
            device="cpu")
    assert reg.excluded_chips() == frozenset()
    vs = make_verifiers(2, bad={1})
    assert mesh_call(vs, sentinel_rate=1.0) == host_verdicts(vs)
    st = batch.last_run_stats
    assert st["mesh"] == 2 and st["mesh_reformations"] == []
    assert st["sentinel"]["divergence"] == 0


def test_forged_accept_is_caught_whatever_the_shard_draw():
    """A small batch puts every real term on shard 0 of a 4-mesh; chip 0
    forges its partial and the fold alike (identity sums: a device
    ACCEPT of a tampered batch).  Drawing one of the three all-padding
    shards proved nothing before; now the draw is among the shards with
    terms and the padding shards are checked for the identity, so every
    call raises naming chip 0 and no forged accept is published."""
    plan = faults.sentinel_plan(10, "flip-accept", chip=0, on=lambda i: True)
    reg = health.chip_registry()
    for call in range(4):
        vs = make_verifiers(2, sigs_per_batch=3, bad={0, 1})
        with faults.injected(plan):
            with pytest.raises(T.DeviceError, match=r"chips \[0\]"):
                mesh_call(vs, mesh=4, sentinel_rate=1.0,
                          device_ids=(0, 1, 2, 3))
        st = batch.last_run_stats
        assert st["sentinel"]["attributed"] == [0]
        assert st["device_batches"] == 0
        reg.heal_chip(0)
