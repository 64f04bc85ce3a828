"""The port's gray-failure defence on the CPU, held to the JAX package: the
latency ledger, the probation rung and the straggler ladder of the
ChipRegistry, the slow plans, hedged re-dispatch, the probation probe, the
service's hedge and straggler roll-up and the six knobs.

* The ledger, the registry and the plans are pure functions of their
  inputs: the same seeded sequence goes through both packages, and every
  output must be equal, integer for integer (tests/test_straggler.py's and
  tests/test_sentinel.py's cases, and seeded sequences beside them).
* Hedging runs under the port's rule: hybrid calls only.  The hedge cases
  of tests/test_straggler.py run with `hybrid=True` in BOTH packages, on the
  same verifiers, and the port's verdicts must equal the JAX package's and
  the host oracle's.  A forced-device call fires no twin.  The port's hedge
  is its race gated on the ledger, so ED25519_TPU_HEDGE_BUDGET has no
  counterpart: the cases that set it run at the reference's default.
* run_probation_probe runs on `device="cpu"`: the kernels' plain versions.

Timing runs on health.FakeClock."""

import random
import threading
import time

import numpy as np
import pytest
import torch

import ed25519_consensus_tpu as J
from ed25519_consensus_tpu import batch as jbatch
from ed25519_consensus_tpu import config as jconfig
from ed25519_consensus_tpu import faults as jfaults
from ed25519_consensus_tpu import health as jhealth
from ed25519_consensus_tpu import service as jservice
from ed25519_consensus_tpu_torch import (SigningKey, batch, config, devcache,
                                         faults, health, routing, service)
from ed25519_consensus_tpu_torch.ops import msm
from ed25519_consensus_tpu_torch.utils import metrics

rng = random.Random(0x57A6)
_KEYS = [SigningKey.new(rng) for _ in range(3)]

BASE = 0.010   # a modelled healthy dispatch (bucket rep 10000 µs)
SLOW = 0.100   # a modelled gray dispatch (10x: bucket rep 100000 µs)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker (the port tests' idiom)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def reset_state():
    for pkg_faults, pkg_batch in ((faults, batch), (jfaults, jbatch)):
        pkg_faults.uninstall()
        pkg_batch.reset_device_health()
        pkg_batch.last_run_stats.clear()
    devcache.set_default_cache(devcache.DeviceOperandCache(enabled=False))
    yield
    devcache.set_default_cache(None)
    for pkg_faults, pkg_batch in ((faults, batch), (jfaults, jbatch)):
        pkg_faults.uninstall()
        pkg_batch.reset_device_health()
        pkg_batch.last_run_stats.clear()
    batch._DeviceLane.reset_all()


def make_entries(n_batches, sigs=3, bad=(), tag=b"gray"):
    out = []
    for b in range(n_batches):
        ents = []
        for i in range(sigs):
            sk = _KEYS[i % len(_KEYS)]
            msg = b"%s-%d-%d" % (tag, b, i)
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


def host_truth(batches):
    return [batch._host_verdict(v, random.Random(1))
            for v in port_verifiers(batches)]


# -- the latency ledger, JAX against port ----------------------------------

def feed_healthy(led, chips=range(8), rounds=4, seconds=BASE):
    for _ in range(rounds):
        for c in chips:
            led.record((c,), seconds)


def ledger_outputs(pkg_health, script):
    """Run `script` (a list of (chips, seconds)) through a fresh ledger of
    one package → every output of every read, in order."""
    led = pkg_health.LatencyLedger()
    out = []
    for chips, seconds in script:
        out.append(("record", led.record(chips, seconds)))
        out.append(("reads", led.mesh_median_us(), led.gate_us(),
                    led.wave_quantile_us(950), led.wave_quantile_us(500),
                    led.wave_samples(), led.within_gate(0.030),
                    tuple(led.chip_p90_us(c) for c in range(9))))
    out.append(("stats", led.chip_stats()))
    return out


def _script_quantiles():
    return [((0,), s) for s in (BASE,) * 8 + (SLOW,) * 2]


def _script_persistent():
    s = [((c,), BASE) for _ in range(4) for c in range(8)]
    for _ in range(10):
        s.append(((7,), SLOW))
        s += [((c,), BASE) for c in range(7)]
    return s


def _script_smear():
    return [(tuple(range(8)), SLOW)] * 32


def _script_flap():
    s = [((c,), BASE) for _ in range(4) for c in range(8)]
    for w in range(12):
        s += [((7,), SLOW if w % 2 == 0 else BASE)] * 2
        s += [((c,), BASE) for c in range(8)]
    return s


def _script_seeded(seed):
    """Placement-diverse dispatches over log-uniform durations from 50 µs
    to past the overflow bucket, one slow chip among them."""
    r = random.Random(seed)
    s = []
    for _ in range(300):
        k = r.choice((1, 1, 1, 2, 4, 8))
        chips = tuple(sorted(r.sample(range(8), k)))
        sec = 10 ** r.uniform(-4.3, 3.2)
        if 3 in chips and k == 1:
            sec *= 12
        s.append((chips, sec))
    return s


@pytest.mark.parametrize("script", [
    _script_quantiles(), _script_persistent(), _script_smear(),
    _script_flap(), _script_seeded(1), _script_seeded(2)],
    ids=["quantiles", "persistent", "smear", "flap", "seeded1", "seeded2"])
@pytest.mark.parametrize("min_samples", ["2", "4", "8"])
def test_ledger_outputs_equal_the_reference(script, min_samples,
                                            monkeypatch):
    monkeypatch.setenv("ED25519_TPU_STRAGGLER_MIN_SAMPLES", min_samples)
    assert ledger_outputs(health, script) == ledger_outputs(jhealth, script)


def test_bucket_edges_and_representatives_equal_the_reference():
    assert health._LATENCY_EDGES_US == jhealth._LATENCY_EDGES_US
    assert health._LATENCY_OVERFLOW_US == jhealth._LATENCY_OVERFLOW_US
    assert all(isinstance(e, int) for e in health._LATENCY_EDGES_US)
    led = health.LatencyLedger()
    assert led._rep_us(0) == 100
    assert led._rep_us(len(health._LATENCY_EDGES_US)) == \
        health._LATENCY_OVERFLOW_US
    assert health.STRAGGLER_SUSPICION == jhealth.STRAGGLER_SUSPICION
    assert health.LatencyLedger.WAVE_WINDOW == \
        jhealth.LatencyLedger.WAVE_WINDOW
    assert batch._HEDGE_ARM_WAVES == jbatch._HEDGE_ARM_WAVES


def test_quantiles_are_integer_bucket_reps():
    led = health.LatencyLedger()
    for chips, s in _script_quantiles():
        led.record(chips, s)
    st = led.chip_stats()[0]
    assert (st["p50_us"], st["p90_us"]) == (10000, 100000)
    assert led.mesh_median_us() == 10000
    assert led.wave_quantile_us(950) == 100000


def test_persistent_straggler_flags_exactly_the_slow_chip(monkeypatch):
    monkeypatch.setenv("ED25519_TPU_STRAGGLER_MIN_SAMPLES", "4")
    led = health.LatencyLedger()
    flagged = [c for chips, s in _script_persistent()
               for c in led.record(chips, s)]
    assert flagged == [7, 7]
    assert all(st["straggler_events"] == 0
               for c, st in led.chip_stats().items() if c != 7)


def test_smearing_and_flap_never_flag(monkeypatch):
    monkeypatch.setenv("ED25519_TPU_STRAGGLER_MIN_SAMPLES", "4")
    for script in (_script_smear(), _script_flap()):
        led = health.LatencyLedger()
        assert not [c for chips, s in script for c in led.record(chips, s)]
    # the flapping chip's ring p90 IS over the gate: the per-dispatch
    # condition is what holds it back
    assert led.chip_p90_us(7) * 1000 > 3000 * led.mesh_median_us()


def test_gate_abstains_then_scales_the_median_and_namespaces_isolate():
    led = health.LatencyLedger("r0")
    assert led.gate_us() == 0 and led.within_gate(3600.0)
    feed_healthy(led)
    assert led.gate_us() == 30000
    assert led.within_gate(0.030) and not led.within_gate(0.031)
    other = health.LatencyLedger("r1")
    assert other.chip_stats() == {} and "r0" in repr(led)
    led.reset()
    assert led.chip_stats() == {} and led.wave_quantile_us(950) == 0


# -- the registry's ladder, JAX against port -------------------------------

def registry_walk(pkg_health, steps):
    """Drive a fresh registry of one package on a FakeClock through
    `steps` → every read after every step."""
    clock = pkg_health.FakeClock()
    reg = pkg_health.ChipRegistry(clock=clock)
    out = []
    for op, *args in steps:
        if op == "lat":
            res = reg.record_latency(*args)
        elif op == "sus":
            res = reg.record_suspicion(*args)
        elif op == "pass":
            res = reg.record_probation_pass(*args)
        elif op == "fail":
            res = reg.record_probation_fail(*args)
        elif op == "dead":
            res = reg.mark_chip_dead(*args)
        else:
            res = clock.advance(*args)
        out.append((op, res, reg.chip_states(),
                    sorted(reg.excluded_chips()),
                    sorted(reg.quarantined_chips()),
                    sorted(reg.probation_chips()),
                    [reg.chip_state(c) for c in range(8)]))
    out.append(reg.latency.chip_stats())
    return out


def _walk_straggler_to_rejoin():
    s = [("lat", (c,), BASE) for _ in range(2) for c in range(8)]
    for _ in range(6):
        s.append(("lat", (3,), SLOW))
        s += [("lat", (c,), BASE) for c in range(8) if c != 3]
    s += [("adv", 300.0), ("adv", 900.0), ("pass", 3), ("pass", 3),
          ("fail", 3), ("adv", 1200.0), ("pass", 3), ("pass", 3),
          ("pass", 3), ("pass", 3)]
    return s


def _walk_sentinel_ladder():
    return [("sus", 5, 1.5, "audit-1"), ("adv", 300.0),
            ("sus", 5, 1.5, "audit-2"), ("sus", 5, 1.5, "audit-3"),
            ("sus", 2, 3.0, "storm"), ("adv", 900.0), ("pass", 2),
            ("pass", 2), ("pass", 2), ("sus", 4, 3.0, "storm"),
            ("adv", 900.0), ("pass", 4), ("fail", 4), ("adv", 1200.0),
            ("pass", 4), ("dead", 6), ("sus", 6, 0.25, "amb"),
            ("adv", 5000.0), ("pass", 5), ("pass", 5), ("pass", 5)]


def _walk_seeded(seed):
    r = random.Random(seed)
    s = []
    for _ in range(160):
        op = r.random()
        if op < 0.6:
            k = r.choice((1, 1, 2, 8))
            chips = tuple(sorted(r.sample(range(8), k)))
            s.append(("lat", chips, SLOW if 6 in chips and k == 1
                      else BASE * r.choice((1, 1, 2))))
        elif op < 0.7:
            s.append(("sus", r.randrange(8), r.choice((0.25, 1.5)), "ev"))
        elif op < 0.8:
            s.append(("adv", r.choice((1.0, 60.0, 400.0))))
        elif op < 0.95:
            s.append(("pass", r.randrange(8)))
        else:
            s.append(("fail", r.randrange(8)))
    return s


@pytest.mark.parametrize("steps", [
    _walk_straggler_to_rejoin(), _walk_sentinel_ladder(), _walk_seeded(3),
    _walk_seeded(4)], ids=["straggler", "sentinel", "seeded3", "seeded4"])
def test_registry_walk_equals_the_reference(steps, monkeypatch):
    monkeypatch.setenv("ED25519_TPU_STRAGGLER_MIN_SAMPLES", "2")
    assert registry_walk(health, steps) == registry_walk(jhealth, steps)


def test_record_latency_walks_the_quarantine_ladder(monkeypatch):
    """Two completed streaks cross the default threshold on a frozen
    clock; attribution is exact."""
    monkeypatch.setenv("ED25519_TPU_STRAGGLER_MIN_SAMPLES", "2")
    clock = health.FakeClock()
    reg = health.chip_registry()
    reg.set_clock(clock)
    feed_healthy(reg.latency, rounds=2)
    flags = 0
    for _ in range(6):
        flags += len(reg.record_latency((3,), SLOW))
        feed_healthy(reg.latency,
                     chips=[c for c in range(8) if c != 3], rounds=1)
        if reg.chip_state(3) == health.STATE_QUARANTINED:
            break
    assert flags >= 2 and reg.excluded_chips() == {3}
    assert all(reg.chip_state(c) == health.STATE_HEALTHY
               for c in range(8) if c != 3)


def test_quarantine_optout_is_report_only_in_both(monkeypatch):
    monkeypatch.setenv("ED25519_TPU_QUARANTINE", "0")
    steps = [("sus", 1, 99.0, "huge"), ("adv", 10.0), ("sus", 2, 3.0, "x"),
             ("sus", 2, 1.5, "y"), ("dead", 6), ("pass", 1)]
    steps += [("lat", (3,), SLOW if k % 3 else BASE) for k in range(30)]
    out = registry_walk(health, steps)
    assert out == registry_walk(jhealth, steps)
    assert all(not excluded or excluded == [6]
               for _op, _r, _s, excluded, *_ in out[:-1])


# -- the plans, JAX against port --------------------------------------------

def plan_trace(pkg_health, plan, n=48, payloads=((0,), (5,), None, (1, 5))):
    """Run `plan` over n calls per payload at SITE_LANE and SITE_SHARDED on
    a FakeClock → per call: the clock's advance, the raised error's type
    or the result's bytes, and the injection log."""
    clock = pkg_health.FakeClock()
    out = []
    for payload in payloads:
        for i in range(n):
            for site in ("lane", "sharded"):
                t0 = clock.monotonic()
                # the audit form's (1 + D, B, 4, 20, 33) at the sharded
                # seam, a chunk's (B, 4, 20, 33) on the lane
                shape = ((1 + 4, 2, 4, 20, 33) if site == "sharded"
                         else (2, 4, 20, 33))
                try:
                    res = plan.run(site, lambda s=shape: np.zeros(
                        s, np.int32), clock=clock, payload=payload, mesh=4)
                    res = np.asarray(res).tobytes()
                except Exception as e:  # noqa: BLE001 - compared by type
                    res = type(e).__name__
                out.append((site, i, clock.monotonic() - t0, res))
    out.append(plan.injection_log())
    return out


PLANS = {
    "slow persistent": lambda f: f.slow_plan(7, chip=5, seconds=0.09,
                                             base_seconds=0.01),
    "slow flap": lambda f: f.slow_plan(7, chip=5, seconds=0.09,
                                       base_seconds=0.01, kind="flap",
                                       period=3),
    "slow sharded": lambda f: f.slow_plan(
        9, chip=1, seconds=0.25, sites=(f.SITE_SHARDED,)),
    "sentinel corrupt": lambda f: f.sentinel_plan(
        11, "corrupt-chip", chip=1, on=lambda i: True),
    "sentinel window": lambda f: f.sentinel_plan(
        12, "corrupt-chip", chip=5, at=3, length=4),
    "sentinel flip": lambda f: f.sentinel_plan(13, "flip-accept", chip=0,
                                               at=1, length=9),
    "storm slow": lambda f: f.storm_plan(14, "slow", at=1, length=4,
                                         seconds=0.25, chip=5),
    "randomized slow": lambda f: f.randomized_plan(
        16, error_rate=0.2, stall_rate=0.1, stall_seconds=0.3,
        corrupt_rate=0.1, slow_rate=0.3, slow_chip=5),
    "randomized slow lane": lambda f: f.randomized_plan(
        17, slow_rate=0.5, slow_seconds=0.125, slow_chip=0),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_draws_equal_the_reference(name):
    assert plan_trace(health, PLANS[name](faults)) == \
        plan_trace(jhealth, PLANS[name](jfaults))


def test_slow_faults_apply_only_in_placement_and_sleep_on_real_clocks():
    slow = faults.SlowChip(5, 0.02)
    plan = faults.FaultPlan([slow])
    t = time.monotonic()
    plan.run(faults.SITE_LANE, lambda: 0, payload=(5,))
    assert time.monotonic() - t >= 0.02
    clock = health.FakeClock()
    plan.run(faults.SITE_LANE, lambda: 0, clock=clock, payload=(4,))
    plan.run(faults.SITE_LANE, lambda: 0, clock=clock, payload=None, mesh=4)
    assert clock.monotonic() == 1000.0
    with pytest.raises(ValueError):
        faults.GrayFlap(1, 0.1, period=0)
    for bad in (lambda: faults.slow_plan(1, 0, 0.1, kind="x"),
                lambda: faults.sentinel_plan(1, "x"),
                lambda: faults.storm_plan(1, "x")):
        with pytest.raises(ValueError):
            bad()


# -- hedged re-dispatch (hybrid only) ----------------------------------------

def _lane_of(pkg):
    if pkg is batch:
        return next(iter(batch._DeviceLane._instances.values()), None)
    return jbatch._DeviceLane._instances.get(0)


def run_hedged_wedged(pkg, vs, monkeypatch, deadline_in=None, chunk=2,
                      hybrid=True):
    """Force-hedge a call whose device leg is wedged behind the
    device-call lock: the twin overtakes every chunk.  The installed
    ErrorOn keeps the late, already discarded device call cheap; the plan
    stays installed until that call reached the seam (or the worker
    skipped it)."""
    monkeypatch.setenv("ED25519_TPU_HEDGE_MIN_MS", "0")
    pkg_health = health if pkg is batch else jhealth
    pkg_faults = faults if pkg is batch else jfaults
    pkg_msm = msm
    if pkg is jbatch:
        from ed25519_consensus_tpu.ops import msm as pkg_msm
    clock = pkg_health.FakeClock()
    hp = pkg_health.DeviceHealth(mesh=0, clock=clock)
    pkg_health.chip_registry().set_clock(clock)
    plan = pkg_faults.FaultPlan(
        [pkg_faults.ErrorOn(on=lambda i: True, site=pkg_faults.SITE_LANE)],
        seed=2)
    deadline = (clock.monotonic() + deadline_in
                if deadline_in is not None else None)
    kw = dict(device="cpu") if pkg is batch else {}
    with pkg_faults.injected(plan):
        with pkg_msm.DEVICE_CALL_LOCK:
            got = pkg.verify_many(vs, rng=random.Random(5), chunk=chunk,
                                  hybrid=hybrid, merge="never", mesh=0,
                                  health=hp, deadline=deadline, **kw)
        lane = _lane_of(pkg)
        t_end = time.monotonic() + 5.0
        while (plan.calls_seen(pkg_faults.SITE_LANE) == 0
               and lane is not None and lane._discarded
               and time.monotonic() < t_end):
            time.sleep(0.002)
    return got, dict(pkg.last_run_stats), clock, deadline


def test_hedge_twin_first_valid_wins_loser_unread(monkeypatch):
    batches = make_entries(2, bad={1})
    got, st, _c, _d = run_hedged_wedged(batch, port_verifiers(batches),
                                        monkeypatch)
    jgot, jst, _c, _d = run_hedged_wedged(jbatch, jax_verifiers(batches),
                                          monkeypatch)
    assert got == jgot == host_truth(batches) == [True, False]
    for s in (st, jst):
        assert (s["hedges_fired"], s["hedges_won"], s["hedges_lost"]) == \
            (1, 1, 0)
        assert (s["device_batches"] + s["device_rejects_confirmed"]
                + s["device_rejects_overturned"]) == 0


def test_hedge_decides_tight_deadline_inside_deadline(monkeypatch):
    batches = make_entries(2)
    got, st, clock, deadline = run_hedged_wedged(
        batch, port_verifiers(batches), monkeypatch, deadline_in=0.5)
    jgot, _jst, _c, _d = run_hedged_wedged(
        jbatch, jax_verifiers(batches), monkeypatch, deadline_in=0.5)
    assert got == jgot == [True, True]
    assert st["hedges_won"] == 1 and clock.monotonic() <= deadline


def test_hedge_twin_restages_with_fresh_blinders(monkeypatch):
    calls = []
    real = batch._host_verdict

    def spy(v, r):
        calls.append(v)
        return real(v, r)

    monkeypatch.setattr(batch, "_host_verdict", spy)
    vs = port_verifiers(make_entries(2))
    got, st, _c, _d = run_hedged_wedged(batch, vs, monkeypatch)
    assert got == [True, True] and st["hedges_won"] == 1
    assert set(map(id, calls)) == set(map(id, vs))


def test_hedge_with_one_chunk_in_flight_matches_the_reference(monkeypatch):
    """Four batches: a hybrid call's probe chunk is the one chunk in
    flight (the host lane takes the rest of the pool), and its twin wins —
    in both packages."""
    batches = make_entries(4, bad={2})
    got, st, _c, _d = run_hedged_wedged(batch, port_verifiers(batches),
                                        monkeypatch)
    jgot, jst, _c, _d = run_hedged_wedged(jbatch, jax_verifiers(batches),
                                          monkeypatch)
    assert got == jgot == host_truth(batches)
    assert (st["hedges_fired"], st["hedges_won"]) == (1, 1)
    assert (jst["hedges_fired"], jst["hedges_won"]) == (1, 1)
    assert st["host_batches"] == jst["host_batches"] == 4


def arm_ledger(seconds=BASE):
    """A warm ledger on the real clock: hedging armed at the knobs'
    defaults (threshold max(p95 = 10 ms, the 50 ms floor))."""
    reg = health.chip_registry()
    reg.set_clock(None)
    feed_healthy(reg.latency, chips=(0,),
                 rounds=batch._HEDGE_ARM_WAVES + 8, seconds=seconds)
    assert reg.latency.wave_samples() >= batch._HEDGE_ARM_WAVES


def run_wedged_hybrid(batches, deadline=None):
    """One hybrid call whose device leg is wedged behind the device-call
    lock for the whole call; the late leg errors cheaply once released."""
    plan = faults.FaultPlan(
        [faults.ErrorOn(on=lambda i: True, site=faults.SITE_LANE)], seed=4)
    with faults.injected(plan):
        t0 = time.monotonic()
        with msm.DEVICE_CALL_LOCK:
            got = batch.verify_many(port_verifiers(batches), chunk=2,
                                    hybrid=True, merge="never", mesh=0,
                                    device="cpu", deadline=deadline)
        took = time.monotonic() - t0
        st = dict(batch.last_run_stats)
        lane = _lane_of(batch)
        t_end = time.monotonic() + 5.0
        while (plan.calls_seen(faults.SITE_LANE) == 0 and lane is not None
               and lane._discarded and time.monotonic() < t_end):
            time.sleep(0.002)
    return got, st, took


def test_armed_ledger_with_a_past_deadline_races_on_the_host():
    """A warm ledger and a deadline already past: no wait can afford a
    hedge, so the hybrid call races its wedged chunk on the host at once,
    as a cold one does — host-identical verdicts, no DeviceError, nothing
    decided by the device."""
    arm_ledger()
    batches = make_entries(2, bad={0})
    got, st, _took = run_wedged_hybrid(batches,
                                       deadline=time.monotonic() - 1.0)
    assert got == host_truth(batches) == [False, True]
    assert (st["hedges_fired"], st["hedges_won"], st["hedges_lost"]) == \
        (1, 1, 0)
    assert st["host_batches"] == 2
    assert (st["device_batches"] + st["device_rejects_confirmed"]
            + st["device_rejects_overturned"]) == 0


def test_armed_ledger_waits_for_the_threshold_then_hedges():
    """A warm ledger and no deadline: the call waits for the wedged device
    up to the 50 ms floor, then races the chunk as a hedge twin that wins."""
    arm_ledger()
    batches = make_entries(2, bad={1})
    got, st, took = run_wedged_hybrid(batches)
    assert got == host_truth(batches) == [True, False]
    assert took >= 0.05
    assert (st["hedges_fired"], st["hedges_won"], st["hedges_lost"]) == \
        (1, 1, 0)
    assert st["host_batches"] == 2 and st["device_batches"] == 0


def test_cold_ledger_races_at_once_and_counts_no_hedge():
    """A cold ledger at the default floor: the hybrid call races its
    wedged chunk at once, as the scheduler always did, and counts no
    hedge."""
    health.chip_registry().set_clock(None)
    batches = make_entries(2, bad={0})
    got, st, _took = run_wedged_hybrid(batches)
    assert got == host_truth(batches) == [False, True]
    assert (st["hedges_fired"], st["hedges_won"], st["hedges_lost"]) == \
        (0, 0, 0)
    assert st["host_batches"] == 2


def test_straggler_counters_ride_stats_zero_on_a_clean_run(monkeypatch):
    got, st, _c, _d = run_hedged_wedged(batch, port_verifiers(
        make_entries(2)), monkeypatch)
    for k in ("hedges_fired", "hedges_won", "hedges_lost",
              "straggler_suspicion_events"):
        assert k in st
    assert st["straggler_suspicion_events"] == 0
    clean = batch.verify_many(port_verifiers(make_entries(2)), chunk=2,
                              hybrid=False, merge="never", device="cpu",
                              health=health.DeviceHealth(
                                  clock=health.FakeClock()))
    assert clean == [True, True]
    assert all(batch.last_run_stats[k] == 0
               for k in ("hedges_fired", "hedges_won", "hedges_lost",
                         "straggler_suspicion_events"))
    assert health.chip_registry().latency.wave_samples() == 1


def test_forced_device_call_fires_no_twin_and_raises(monkeypatch):
    """The port's rule: under HEDGE_MIN_MS=0 a hybrid=False call never
    fires a twin (it never decides on the host); its wedged leg, once
    released, errors, and the call raises DeviceError."""
    monkeypatch.setenv("ED25519_TPU_HEDGE_MIN_MS", "0")
    plan = faults.FaultPlan([faults.ErrorOn(on=lambda i: True)], seed=3)

    def wedge():
        with msm.DEVICE_CALL_LOCK:
            time.sleep(0.3)

    holder = threading.Thread(target=wedge, daemon=True)
    holder.start()
    time.sleep(0.05)
    with faults.injected(plan):
        with pytest.raises(batch.DeviceError):
            batch.verify_many(port_verifiers(make_entries(2)), chunk=2,
                              hybrid=False, merge="never", mesh=0,
                              device="cpu", deadline=time.monotonic() + 5)
    holder.join(10.0)
    st = batch.last_run_stats
    assert (st["hedges_fired"], st["host_batches"], st["device_errors"]) \
        == (0, 0, 1)


def test_latency_lands_per_chip_and_flags_a_slow_named_chip(monkeypatch):
    """Forced-device calls named by device_ids feed the ledger per chip on
    the health clock; a slow chip's streaks accrue suspicion and show in
    the call's stats."""
    monkeypatch.setenv("ED25519_TPU_STRAGGLER_MIN_SAMPLES", "2")
    monkeypatch.setattr(routing, "_device_count", [8])
    clock = health.FakeClock()
    hp = health.DeviceHealth(clock=clock)
    reg = health.chip_registry()
    reg.set_clock(clock)
    vs = make_entries(2, bad={1})
    truth = host_truth(vs)
    plan = faults.slow_plan(1, chip=2, seconds=0.09, base_seconds=0.01)
    events = 0
    with faults.injected(plan):
        for rnd in range(7):
            for c in range(4):
                assert batch.verify_many(
                    port_verifiers(vs), chunk=2, hybrid=False,
                    merge="never", device="cpu", health=hp,
                    device_ids=(c,)) == truth
                events += batch.last_run_stats["straggler_suspicion_events"]
                assert batch.last_run_stats["device_ids"] == [c]
    stats = reg.latency.chip_stats()
    assert sorted(stats) == [0, 1, 2, 3]
    assert stats[0]["p50_us"] == 10000 and stats[2]["p90_us"] == 100000
    # three streaks: the first two decay a hair below the threshold
    assert events == 3 and reg.excluded_chips() == {2}
    # the quarantined chip reforms a named call onto a survivor
    assert batch.verify_many(port_verifiers(vs), chunk=2, hybrid=False,
                             merge="never", device="cpu", health=hp,
                             device_ids=(2,)) == truth
    st = batch.last_run_stats
    assert st["device_ids"] == [0]
    assert st["mesh_reformations"][0]["from"] == 0


# -- the probation probe -----------------------------------------------------

def _probation_chip(chip):
    clock = health.FakeClock()
    reg = health.chip_registry()
    reg.set_clock(clock)
    reg.record_suspicion(chip, 3.0, "test quarantine")
    clock.advance(6 * config.get("ED25519_TPU_SUSPICION_HALF_LIFE"))
    assert reg.chip_state(chip) == health.STATE_PROBATION
    return clock, reg


def test_probation_probe_clean_chip_rejoins():
    _clock, reg = _probation_chip(2)
    before = metrics.fault_counters()
    for i in range(config.get("ED25519_TPU_PROBATION_PROBES")):
        v = port_verifiers(make_entries(1, tag=b"probe%d" % i))[0]
        assert batch.run_probation_probe(v, 2, rng=rng, device="cpu")
    assert reg.chip_state(2) == health.STATE_HEALTHY
    assert not reg.excluded_chips()
    after = metrics.fault_counters()
    assert after.get("chip_rejoined", 0) == before.get("chip_rejoined", 0) + 1


def test_probation_probe_corrupting_chip_is_requarantined():
    _clock, reg = _probation_chip(4)
    plan = faults.FaultPlan([faults.CorruptChipSum(
        4, on=lambda i: True, site=faults.SITE_LANE)], seed=6)
    with faults.injected(plan):
        v = port_verifiers(make_entries(1))[0]
        assert batch.run_probation_probe(v, 4, rng=rng,
                                         device="cpu") is False
    assert reg.chip_state(4) == health.STATE_QUARANTINED
    assert reg.suspicion(4) >= 3.0
    # a fault on ANOTHER chip is not this chip's evidence
    _clock, reg = _probation_chip(5)
    plan = faults.FaultPlan([faults.CorruptChipSum(
        4, on=lambda i: True, site=faults.SITE_LANE)], seed=6)
    with faults.injected(plan):
        assert batch.run_probation_probe(
            port_verifiers(make_entries(1))[0], 5, rng=rng, device="cpu")


def test_probation_probe_slow_but_correct_fails_the_latency_gate():
    clock, reg = _probation_chip(2)
    feed_healthy(reg.latency)  # gate = 3x the 10 ms median
    assert reg.latency.gate_us() == 30000
    plan = faults.FaultPlan([faults.SlowChip(2, SLOW)], seed=1)
    with faults.injected(plan):
        assert batch.run_probation_probe(
            port_verifiers(make_entries(1))[0], 2, rng=rng,
            device="cpu") is False
    assert reg.chip_state(2) == health.STATE_QUARANTINED
    clock.advance(6 * config.get("ED25519_TPU_SUSPICION_HALF_LIFE"))
    assert reg.chip_state(2) == health.STATE_PROBATION
    for i in range(config.get("ED25519_TPU_PROBATION_PROBES")):
        assert batch.run_probation_probe(
            port_verifiers(make_entries(1, tag=b"p%d" % i))[0], 2,
            rng=rng, device="cpu") is True
    assert reg.chip_state(2) == health.STATE_HEALTHY


def test_probation_probe_dispatch_error_fails_and_bad_staging_abstains():
    _clock, reg = _probation_chip(1)
    with faults.injected(faults.FaultPlan([faults.ErrorOn(
            on=lambda i: True)], seed=2)):
        assert batch.run_probation_probe(
            port_verifiers(make_entries(1))[0], 1, rng=rng,
            device="cpu") is False
    assert reg.chip_state(1) == health.STATE_QUARANTINED
    v = batch.Verifier()
    v.invalidate("malformed")
    assert batch.run_probation_probe(v, 1, rng=rng, device="cpu") is None


# -- the service roll-up, routing's gauge, the knobs -------------------------

HEDGE_TOTALS = ("hedges_fired", "hedges_won", "hedges_lost",
                "straggler_suspicion_events")


def _service(**kw):
    clock = health.FakeClock()
    return service.VerifyService(
        auto_start=False, clock=clock, device="cpu", chunk=2,
        health=health.DeviceHealth(clock=clock), merge="never", **kw)


def test_service_rollup_zero_on_a_clean_wave():
    svc = _service(hybrid=False)
    tickets = [svc.submit(ents, cls="consensus")
               for ents in make_entries(2)]
    svc.process_once()
    assert [t.result(0) for t in tickets] == [True, True]
    st = svc.stats()
    assert st["device_waves"] == 1
    assert all(st[k] == 0 for k in HEDGE_TOTALS)
    assert st["probation_chips"] == []
    g = metrics.gauges()
    assert all(g[k] == 0 for k in HEDGE_TOTALS)
    assert g["latency_mesh_median_us"] > 0
    assert g["latency_wave_p95_us"] >= g["latency_mesh_median_us"]
    svc.close()
    ref = jservice.VerifyService(auto_start=False)
    assert set(HEDGE_TOTALS) <= set(ref.totals) and \
        set(HEDGE_TOTALS) <= set(svc.totals)
    ref.close()


def test_service_rolls_up_the_waves_hedges(monkeypatch):
    """Force-hedged hybrid waves with the device wedged: every wave's
    twins win, the totals and gauges add them up, verdicts stay the
    host's."""
    monkeypatch.setenv("ED25519_TPU_HEDGE_MIN_MS", "0")
    svc = _service(hybrid=True)
    batches = make_entries(3, bad={1})
    with msm.DEVICE_CALL_LOCK:
        tickets = [svc.submit(ents, cls="consensus",
                              deadline=svc.now() + 30.0)
                   for ents in batches]
        while svc.process_once():
            pass
    assert [t.result(0) for t in tickets] == host_truth(batches)
    st = svc.stats()
    assert st["hedges_fired"] >= 1 and st["hedges_lost"] == 0
    assert st["hedges_won"] == st["hedges_fired"]
    assert metrics.gauges()["hedges_won"] == st["hedges_won"]
    svc.close()


def test_routing_read_publishes_the_measured_wave_overhead(monkeypatch):
    monkeypatch.setattr(routing, "_device_count", [8])
    feed_healthy(health.chip_registry().latency)
    assert routing.RoutingPolicy().choose_mesh(10 ** 9) == 8
    assert metrics.gauges()["routing_measured_wave_overhead_us"] == 10000


KNOBS = ("ED25519_TPU_PROBATION_PROBES", "ED25519_TPU_QUARANTINE",
         "ED25519_TPU_STRAGGLER_RATIO", "ED25519_TPU_STRAGGLER_MIN_SAMPLES",
         "ED25519_TPU_HEDGE_QUANTILE", "ED25519_TPU_HEDGE_MIN_MS")


@pytest.mark.parametrize("name", KNOBS)
def test_knob_matches_the_reference(name, monkeypatch):
    mine, ref = config.KNOBS[name], jconfig.KNOBS[name]
    assert (mine.type, mine.default) == (ref.type, ref.default)
    assert config.get(name) == jconfig.get(name)
    monkeypatch.setenv(name, "0")
    assert config.get(name) == jconfig.get(name)


def test_registry_holds_31_knobs_and_no_lab_seeds():
    assert len(config.KNOBS) == 31
    for name in ("ED25519_TPU_STRAGGLER_LAB_SEED",
                 "ED25519_TPU_SENTINEL_SOAK_SEED",
                 "ED25519_TPU_HEDGE_BUDGET"):
        assert name not in config.KNOBS and name in jconfig.KNOBS
