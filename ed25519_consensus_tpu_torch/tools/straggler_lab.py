"""Straggler lab: the gray-failure gate — the port of the JAX package's
tools/straggler_lab.py.

The mesh survives chips that fail loudly (typed errors, chip loss, corrupt
partials), but a chip that merely runs 10x slow trips nothing: the breaker
sees successes, the classifier no exception, and every wave placed on it
inherits its latency.  This lab proves the latency half of chip health end
to end on a FakeClock, with real forced-device dispatches (the fault seam
advances the virtual clock, so a modelled 10x is exactly 10x and the run
is a pure function of the seed).  Three phases:

**Phase A — persistent straggler.**  Every dispatch pays a modelled base
cost (`StallFor` on the lane seam); one chip pays 10x (`faults.SlowChip`).
A forced-device sweep — one single-chip call per chip per round
(`verify_many(device_ids=(chip,))`; placement diversity is where exact
attribution comes from) — feeds the latency ledger.  Gates: the straggler
streaks complete on the slow chip and no other, the ladder quarantines
that chip and no other within `quarantine_round_bound()` rounds, the
consensus p99 over the surviving chips afterwards is <= 1.3x the healthy
baseline, and every verdict equals the host oracle's, none lost.

**Phase B — gray flap.**  The same chip alternates slow and normal windows
(`faults.GrayFlap`, one window a sweep round).  Windows shorter than
ED25519_TPU_STRAGGLER_MIN_SAMPLES must never complete a streak: zero
accruals, no chip ever excluded.

**Phase C — hedged re-dispatch, under the port's rule.**  The port hedges
hybrid calls only (a forced-device call never decides on the host), so
both variants run `hybrid=True` where the JAX lab runs `hybrid=False`.
Force-hedged (HEDGE_MIN_MS=0), a tight-deadline call whose device leg is
wedged behind the device-call lock returns inside its deadline on the
virtual clock, its one twin won, zero batches decided by the device (the
leg is discarded unread).  A racing variant corrupts every device result
(`faults.CorruptSum`) behind a short real-time wedge: every verdict equals
the host oracle's, every fired hedge resolves, and no corrupted sum is
published as a device accept.

Usage:
  python -m ed25519_consensus_tpu_torch.tools.straggler_lab [--seed N]
      [--devices 8] [--chip 5] [--min-samples 4] [--device cpu] [--json]

The chips are logical: on one card (or the CPU) every chip's calls run on
`--device`.  Runs on the card by default; `--device cpu` runs the kernels'
plain versions.  Exit status is nonzero unless every gate holds."""

import argparse
import json
import os
import random
import sys
import threading
import time

from .. import SigningKey, batch, config, devcache, faults, health
from ..ops import msm

# The JAX knob ED25519_TPU_STRAGGLER_LAB_SEED's default (the port keeps
# lab seeds out of its knob registry).
DEFAULT_SEED = 0x57A661

# The virtual cost model: every lane call pays BASE_S (the StallFor floor
# on the seam); the gray chip pays BASE_S + SLOW_S = 10x.  On a FakeClock
# the real compute is invisible, so the ratio is exact.
BASE_S = 0.010
SLOW_S = 0.090

_stable_seed = faults._stable_seed


def make_wave(seed, keys, tag, n_batches=2, bad_rate=0.25):
    """A keyset-uniform wave of verifiers and its host-oracle truth:
    seeded tampering keeps real False verdicts in the machinery."""
    vs, want = [], []
    for b in range(n_batches):
        rnd = random.Random(_stable_seed(seed, "wave", tag, b))
        bad = rnd.random() < bad_rate
        v = batch.Verifier()
        for j, sk in enumerate(keys):
            msg = b"straggler-lab %s %d %d" % (tag.encode(), b, j)
            sig = sk.sign(msg if not (bad and j == 0) else b"tampered")
            v.queue((sk.verification_key_bytes(), sig, msg))
        vs.append(v)
        want.append(not bad)
    return vs, want


def premark_shapes(seed, keys):
    """Mark the single-lane chunk shape completed, so the lab exercises
    the latency machinery, not the first-call grace."""
    probe, _ = make_wave(seed, keys, "shape-probe", n_batches=1,
                         bad_rate=0.0)
    n_terms = probe[0]._stage(None).n_device_terms
    msm.mark_shape_completed(2, msm.pad_lanes(n_terms), 0)


def quantile_us(durations_us, q_milli):
    """Nearest-rank quantile over integer-µs durations (the ledger's
    convention)."""
    if not durations_us:
        return 0
    s = sorted(durations_us)
    return s[(q_milli * (len(s) - 1)) // 1000]


def quarantine_round_bound() -> int:
    """The bounded-detection claim from the knobs: a persistent straggler
    completes one streak every MIN_SAMPLES of its dispatches (one a sweep
    round), needs ceil(threshold / STRAGGLER_SUSPICION) streaks to cross
    the threshold, plus one streak of slack for decay between accruals."""
    thr = config.get("ED25519_TPU_SUSPICION_THRESHOLD")
    need = max(1, int(config.get("ED25519_TPU_STRAGGLER_MIN_SAMPLES")))
    events = max(1, -(-int(thr * 1000)
                      // int(health.STRAGGLER_SUSPICION * 1000)))
    return need * (events + 2)


def _setup(seed, rng_tag):
    batch.reset_device_health()  # a fresh chip ledger and latency ledger
    clock = health.FakeClock()
    hp = health.DeviceHealth(mesh=0, clock=clock)
    health.chip_registry().set_clock(clock)
    devcache.set_default_cache(devcache.DeviceOperandCache(enabled=False))
    rnd = random.Random(_stable_seed(seed, "keys"))
    keys = [SigningKey.new(rnd) for _ in range(4)]
    premark_shapes(seed, keys)
    return clock, hp, keys, random.Random(_stable_seed(seed, rng_tag))


def run_wave(seed, keys, tag, hp, rng, chip, device, bad_rate=0.25,
             deadline=None):
    """One forced-device wave on chip `chip` → (host identical, none
    lost, µs on the virtual clock, stats)."""
    vs, want = make_wave(seed, keys, tag, bad_rate=bad_rate)
    t0 = hp.clock.monotonic()
    got = batch.verify_many(vs, rng=rng, chunk=2, hybrid=False,
                            merge="never", mesh=0, health=hp,
                            device=device, device_ids=(chip,),
                            deadline=deadline)
    dt_us = int(round((hp.clock.monotonic() - t0) * 1000000))
    return (got == want, len(got) == len(want), dt_us,
            dict(batch.last_run_stats))


def sweep(seed, keys, tag, hp, rng, chips, results, device,
          bad_rate=0.25):
    """One round: a forced wave on every chip of `chips`; appends the
    integer-µs durations to `results` → (all host-identical, none
    lost)."""
    identical = lost_none = True
    for c in chips:
        ok, nolost, dt_us, _st = run_wave(
            seed, keys, "%s-c%d" % (tag, c), hp, rng, c, device,
            bad_rate=bad_rate)
        results.append(dt_us)
        identical = identical and ok
        lost_none = lost_none and nolost
    return identical, lost_none


def run_persistent_straggler(seed, devices=8, chip=5,
                             device="cuda") -> dict:
    """Phase A (see the module docstring)."""
    _clock, hp, keys, rng = _setup(seed, "rng")
    reg = health.chip_registry()
    bound = quarantine_round_bound()
    results = {"ok": True, "chip": chip, "round_bound": bound}
    all_chips = tuple(range(devices))
    try:
        base_plan = faults.FaultPlan(
            [faults.StallFor(BASE_S, on=lambda i: True,
                             site=faults.SITE_LANE)], seed=seed)
        healthy_us, identical, lost_none = [], True, True
        with faults.injected(base_plan):
            for r in range(2):
                ok_r, nl_r = sweep(seed, keys, "base-%d" % r, hp, rng,
                                   all_chips, healthy_us, device)
                identical, lost_none = identical and ok_r, lost_none and nl_r
        healthy_p99 = quantile_us(healthy_us, 990)
        results["healthy_p99_us"] = healthy_p99

        plan = faults.slow_plan(seed, chip, SLOW_S, base_seconds=BASE_S)
        detected_at = None
        storm_us = []
        with faults.injected(plan):
            for r in range(bound):
                ok_r, nl_r = sweep(seed, keys, "storm-%d" % r, hp, rng,
                                   all_chips, storm_us, device)
                identical, lost_none = identical and ok_r, lost_none and nl_r
                if reg.chip_state(chip) == health.STATE_QUARANTINED:
                    detected_at = r
                    break
            # The straggler is out of placement: the survivors carry
            # consensus at the healthy cost.
            survivors = tuple(c for c in all_chips
                              if c not in reg.excluded_chips())
            post_us = []
            for r in range(3):
                ok_r, nl_r = sweep(seed, keys, "post-%d" % r, hp, rng,
                                   survivors, post_us, device)
                identical, lost_none = identical and ok_r, lost_none and nl_r
        post_p99 = quantile_us(post_us, 990)
        events = {c: st["straggler_events"]
                  for c, st in reg.latency.chip_stats().items()
                  if st["straggler_events"]}
        results.update({
            "detected_at_round": detected_at,
            "quarantined_within_bound": detected_at is not None,
            "straggler_events": events,
            "attribution_exact": set(events) == {chip},
            "quarantine_exact": reg.excluded_chips() == {chip},
            "survivors": len(survivors),
            "consensus_p99_us": post_p99,
            # The 1.3x compare in scaled integers, the ledger's way.
            "p99_recovered": post_p99 * 10 <= healthy_p99 * 13,
            "host_identical": identical,
            "zero_lost": lost_none,
        })
        results["ok"] = all((
            results["quarantined_within_bound"],
            results["attribution_exact"], results["quarantine_exact"],
            results["p99_recovered"], identical, lost_none))
    finally:
        devcache.set_default_cache(None)
        batch.reset_device_health()
    return results


def run_gray_flap(seed, devices=8, chip=5, device="cuda") -> dict:
    """Phase B (see the module docstring).  `period=devices` aligns one
    flap window with one sweep round (`devices` lane calls), so the chip
    alternates a slow round and a normal one."""
    _clock, hp, keys, rng = _setup(seed, "rng-flap")
    reg = health.chip_registry()
    results = {"ok": True, "chip": chip}
    all_chips = tuple(range(devices))
    rounds = 3 * max(
        1, int(config.get("ED25519_TPU_STRAGGLER_MIN_SAMPLES")))
    try:
        plan = faults.slow_plan(seed, chip, SLOW_S, base_seconds=BASE_S,
                                kind="flap", period=devices)
        identical = lost_none = never_excluded = True
        flap_us = []
        with faults.injected(plan):
            for r in range(rounds):
                ok_r, nl_r = sweep(seed, keys, "flap-%d" % r, hp, rng,
                                   all_chips, flap_us, device)
                identical, lost_none = identical and ok_r, lost_none and nl_r
                never_excluded = never_excluded and not reg.excluded_chips()
        events = sum(st["straggler_events"]
                     for st in reg.latency.chip_stats().values())
        results.update({
            "rounds": rounds,
            "straggler_events": events,
            "no_accrual": events == 0,
            "never_excluded": never_excluded,
            "state": reg.chip_state(chip),
            "host_identical": identical,
            "zero_lost": lost_none,
        })
        results["ok"] = all((
            events == 0, never_excluded,
            reg.chip_state(chip) == health.STATE_HEALTHY,
            identical, lost_none))
    finally:
        devcache.set_default_cache(None)
        batch.reset_device_health()
    return results


def run_hedge_phase(seed, chip=1, device="cuda") -> dict:
    """Phase C (see the module docstring), force-hedged: with a hedge
    threshold above zero the frozen virtual clock would never reach it,
    and the wedged leg would hold the call."""
    clock, hp, keys, rng = _setup(seed, "rng-hedge")
    results = {"ok": True, "chip": chip}
    try:
        with config.override(ED25519_TPU_HEDGE_MIN_MS=0):
            # C1: the device leg is wedged behind the device-call lock (a
            # seized card); the twin overtakes the chunk inside the deadline
            # and the leg is discarded unread.
            vs, want = make_wave(seed, keys, "hedge-deadline")
            deadline = clock.monotonic() + 0.5
            with msm.DEVICE_CALL_LOCK:
                got = batch.verify_many(vs, rng=rng, chunk=2, hybrid=True,
                                        merge="never", mesh=0, health=hp,
                                        device=device, device_ids=(chip,),
                                        deadline=deadline)
            st = dict(batch.last_run_stats)
            inside = clock.monotonic() <= deadline
            device_touched = (st["device_batches"]
                              + st["device_rejects_confirmed"]
                              + st["device_rejects_overturned"])
            results["deadline"] = {
                "want": want, "got": got,
                "hedges_fired": st["hedges_fired"],
                "hedges_won": st["hedges_won"],
                "hedges_lost": st["hedges_lost"],
                "inside_deadline": inside,
                "device_decided_batches": device_touched,
                "ok": (got == want and inside and st["hedges_fired"] == 1
                       and st["hedges_won"] == 1 and st["hedges_lost"] == 0
                       and device_touched == 0),
            }
            results["ok"] = results["ok"] and results["deadline"]["ok"]

            # C2: both legs racing, every device result corrupted; a short
            # real-time wedge makes the twin fire before the leg can land.
            corrupt_plan = faults.FaultPlan(
                [faults.CorruptSum(on=lambda i: True, site=faults.SITE_LANE)],
                seed=seed)
            vs, want = make_wave(seed, keys, "hedge-race", bad_rate=0.5)

            def wedge():
                with msm.DEVICE_CALL_LOCK:
                    time.sleep(0.25)

            holder = threading.Thread(target=wedge, daemon=True)
            holder.start()
            time.sleep(0.05)  # the wedge holds the lock before the submit
            with faults.injected(corrupt_plan):
                got = batch.verify_many(vs, rng=rng, chunk=2, hybrid=True,
                                        merge="never", mesh=0, health=hp,
                                        device=device, device_ids=(chip,))
                holder.join(timeout=30.0)
            st = dict(batch.last_run_stats)
            results["race"] = {
                "want": want, "got": got,
                "hedges_fired": st["hedges_fired"],
                "hedges_resolved": st["hedges_won"] + st["hedges_lost"],
                "device_accepts": st["device_batches"],
                "rejects_overturned": st["device_rejects_overturned"],
                # A corrupted sum never clears the cofactored identity check:
                # zero device-decided accepts.
                "ok": (got == want and st["hedges_fired"] >= 1
                       and (st["hedges_won"] + st["hedges_lost"]
                            == st["hedges_fired"])
                       and st["device_batches"] == 0),
            }
            results["ok"] = results["ok"] and results["race"]["ok"]
    finally:
        devcache.set_default_cache(None)
        batch.reset_device_health()
    return results


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=lambda s: int(s, 0), default=DEFAULT_SEED)
    ap.add_argument("--devices", type=int, default=8,
                    help="logical chips of the sweep")
    ap.add_argument("--chip", type=int, default=5,
                    help="the gray-failing chip (phases A and B)")
    ap.add_argument("--min-samples", type=int, default=4,
                    help="ED25519_TPU_STRAGGLER_MIN_SAMPLES for the run "
                         "(the JAX lab's operating point, half the "
                         "default)")
    ap.add_argument("--device", default="cuda",
                    help="torch device every chip's calls run on "
                         "(default: the card; cpu runs the kernels' plain "
                         "versions)")
    ap.add_argument("--json", action="store_true")
    return ap.parse_args(argv)


def lab(args) -> dict:
    """All three phases → the summary ({"ok", "persistent", "flap",
    "hedge", ...}).  Phases A and B make forced-device calls, which never
    hedge, so the ladder is measured alone; phase C force-hedges
    (HEDGE_MIN_MS=0)."""
    summary = {"seed": args.seed, "devices": args.devices,
               "device": args.device, "min_samples": args.min_samples,
               "ok": True}
    with config.override(ED25519_TPU_STRAGGLER_MIN_SAMPLES=args.min_samples):
        summary["persistent"] = run_persistent_straggler(
            args.seed, devices=args.devices, chip=args.chip,
            device=args.device)
        summary["flap"] = run_gray_flap(
            args.seed, devices=args.devices, chip=args.chip,
            device=args.device)
        summary["hedge"] = run_hedge_phase(args.seed, device=args.device)
    summary["ok"] = all(summary[k]["ok"]
                        for k in ("persistent", "flap", "hedge"))
    return summary


def headline(summary) -> dict:
    """The one-line result: how fast a gray chip is diagnosed and how far
    the consensus tail recovers."""
    pers = summary["persistent"]
    return {
        "metric": "straggler_lab",
        "value": pers.get("detected_at_round"),
        "unit": "rounds_to_quarantine_persistent_straggler",
        "round_bound": pers.get("round_bound"),
        "attribution_exact": pers.get("attribution_exact"),
        "healthy_p99_us": pers.get("healthy_p99_us"),
        "consensus_p99_us": pers.get("consensus_p99_us"),
        "p99_recovered": pers.get("p99_recovered"),
        "flap_accruals": summary["flap"].get("straggler_events"),
        "hedge_inside_deadline": summary["hedge"].get(
            "deadline", {}).get("inside_deadline"),
        "ok": summary["ok"],
    }


def main(argv=None):
    args = parse_args(argv)
    summary = lab(args)
    if args.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    print(json.dumps(headline(summary)))
    print("STRAGGLER_LAB", json.dumps(summary))
    if not summary["ok"]:
        print(f"VIOLATION: straggler_lab gates failed (replay with --seed "
              f"{args.seed:#x})", file=sys.stderr)
    sys.stdout.flush()  # os._exit skips buffer flushing
    # Never let interpreter teardown run with a lane worker parked.
    batch._DeviceLane.reset_all(timeout=30.0)
    os._exit(0 if summary["ok"] else 1)


if __name__ == "__main__":
    main()
