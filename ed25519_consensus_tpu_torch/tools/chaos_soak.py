"""Chaos soak: randomized fault schedules against the forced-device
`verify_many` — the port of the JAX package's tools/chaos_soak.py.

Each round draws a fresh deterministic FaultPlan from the master seed
(faults.randomized_plan — error / stall / corrupted-sum faults plus an
optional flapping link), builds a mixed valid/tampered batch pool, clears
the device health (`batch.reset_device_health`: a round after a failed
one would otherwise raise from the cooldown without touching the device)
and runs `verify_many(hybrid=False, merge="never")` under the plan.

**The gate differs from the JAX tool's on purpose.**  Under an injected
error the port's `verify_many` raises `DeviceError` where the JAX package
re-decides on the host, so a round passes when its verdicts equal the
host's and the construction truth, OR when the call raised `DeviceError`.
A raising round is counted, never re-run on the host and never counted as
verdicts.  A round never passes with a wrong verdict.  The soak fails
unless at least one round with an injected fault finished with verdicts:
a soak in which every round raised would prove nothing.  The summary
counts rounds that raised and finished, injected faults, and the device
rejects the host confirmed or overturned (corrupted sums read as device
rejects, which the host re-decides).  A flapping link raises in every
round that reaches one of its down windows (the port does not retry an
untyped error).

Usage:
  python -m ed25519_consensus_tpu_torch.tools.chaos_soak [--seed 0xC4A05]
      [--rounds 50] [--batches 12] [--sigs 4] [--mesh 0] [--flap 0]
      [--device cpu] [--json]

Any wrong verdict prints the round's replay seed: `--seed N --rounds 1`
reproduces a round exactly (plans are pure functions of the seed and the
call stream).  Runs on the card by default; `--device cpu` runs the
kernels' plain versions (`--mesh D` is then a virtual mesh on the CPU)."""

import argparse
import json
import os
import random
import sys

from .. import SigningKey, batch, faults, health
from ..error import DeviceError
from ..utils import metrics

DEFAULT_SEED = 0xC4A05


def make_pool(rnd, keys, n_batches, sigs):
    """Mixed valid/tampered batches of ONE fixed size per soak, so one
    warmed chunk shape covers the whole run."""
    vs, want = [], []
    for b in range(n_batches):
        v = batch.Verifier()
        bad_at = rnd.randrange(sigs) if rnd.random() < 0.35 else -1
        for j in range(sigs):
            sk = rnd.choice(keys)
            m = b"chaos %d %d" % (b, j)
            sig = sk.sign(m)
            if j == bad_at:
                m += b"!"  # tamper
            v.queue((sk.verification_key_bytes(), sig, m))
        vs.append(v)
        want.append(bad_at < 0)
    return vs, want


def run_round(r, round_seed, args, keys, site, clock=None) -> dict:
    """One round → its record: "raised" (the call raised DeviceError),
    "ok" (verdicts equal the host and the truth, or raised), "wrong"
    (batches whose verdict differs)."""
    plan = faults.randomized_plan(
        round_seed, error_rate=0.15, stall_rate=0.05, stall_seconds=0.05,
        corrupt_rate=0.10, flap_period=args.flap, site=site)
    vs, want = make_pool(random.Random(round_seed ^ 0x5EED), keys,
                         args.batches, args.sigs)
    vrng = random.Random(round_seed ^ 0xB11D)
    batch.reset_device_health()  # every round gets a live device lane
    h = None if clock is None else health.DeviceHealth(
        mesh=args.mesh or 0, clock=clock)
    got, error = None, None
    with faults.injected(plan):
        try:
            got = batch.verify_many(
                [v.clone() for v in vs], rng=vrng, hybrid=False,
                merge="never", mesh=args.mesh or None, health=h,
                device=args.device)
        except DeviceError as e:
            error = e
    s = dict(batch.last_run_stats)
    host = [batch._host_verdict(v, vrng) for v in vs]
    wrong = [] if got is None else [
        i for i, (g, hv) in enumerate(zip(got, host)) if g != hv]
    wrong += [i for i, (hv, w) in enumerate(zip(host, want)) if hv != w]
    return {
        "round": r, "seed": round_seed, "raised": error is not None,
        "error": None if error is None else str(error)[:160],
        "ok": not wrong, "wrong": sorted(set(wrong)),
        "injected": len(plan.injection_log()),
        "fault_kinds": sorted({k for _s, _i, k in plan.injection_log()}),
        "device_calls": plan.calls_seen(site),
        "device_batches": s.get("device_batches", 0),
        "host_batches": s.get("host_batches", 0),
        "device_errors": s.get("device_errors", 0),
        "rejects_confirmed": s.get("device_rejects_confirmed", 0),
        "rejects_overturned": s.get("device_rejects_overturned", 0),
        "sick": s.get("device_sick", False),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=lambda s: int(s, 0), default=DEFAULT_SEED)
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--batches", type=int, default=12)
    ap.add_argument("--sigs", type=int, default=4,
                    help="signatures per batch (fixed — see make_pool)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard over an N-device mesh (0 = single device)")
    ap.add_argument("--flap", type=int, default=0,
                    help="flapping-link period (0 = no flap fault)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; cpu runs the "
                         "kernels' plain versions)")
    ap.add_argument("--json", action="store_true",
                    help="one JSON line per round instead of text")
    return ap.parse_args(argv)


def soak(args, clock=None, log=print) -> dict:
    """Every round → the summary ({"ok", "rounds_raised",
    "rounds_finished", "finished_with_faults", "fault_kinds" (rounds in
    which each fault class fired), ...}).  `clock` (a
    health.FakeClock) puts each round's device health on a virtual clock:
    stalls advance it instead of sleeping, and no chunk deadline depends
    on the host's speed."""
    rnd = random.Random(args.seed)
    keys = [SigningKey.new(rnd) for _ in range(16)]
    site = faults.SITE_SHARDED if args.mesh and args.mesh > 1 \
        else faults.SITE_LANE
    warm_vs, _ = make_pool(random.Random(args.seed ^ 0xA), keys,
                           args.batches, args.sigs)
    batch.warm_device_shapes(warm_vs[0], chunk=8, device=args.device,
                             mesh=args.mesh or 0)
    t_begin = health.SYSTEM_CLOCK.monotonic()
    totals = {"rounds": 0, "batches": 0, "device_calls": 0, "injected": 0,
              "rounds_raised": 0, "rounds_finished": 0,
              "finished_with_faults": 0, "wrong_rounds": 0,
              "device_batches": 0, "host_batches": 0,
              "device_rejects_confirmed": 0, "device_rejects_overturned": 0,
              "sick_rounds": 0, "fault_kinds": {}}
    for r in range(args.rounds):
        rec = run_round(r, rnd.getrandbits(32), args, keys, site, clock)
        totals["rounds"] += 1
        totals["batches"] += args.batches
        totals["device_calls"] += rec["device_calls"]
        totals["injected"] += rec["injected"]
        totals["rounds_raised"] += rec["raised"]
        totals["rounds_finished"] += not rec["raised"]
        totals["finished_with_faults"] += (not rec["raised"]
                                           and rec["injected"] > 0)
        totals["wrong_rounds"] += not rec["ok"]
        totals["device_batches"] += rec["device_batches"]
        totals["host_batches"] += rec["host_batches"]
        totals["device_rejects_confirmed"] += rec["rejects_confirmed"]
        totals["device_rejects_overturned"] += rec["rejects_overturned"]
        totals["sick_rounds"] += bool(rec["sick"])
        for kind in rec["fault_kinds"]:
            totals["fault_kinds"][kind] = \
                totals["fault_kinds"].get(kind, 0) + 1
        if args.json:
            log(json.dumps(rec))
        elif not rec["ok"] or rec["injected"]:
            log(f"round {r:3d} seed={rec['seed']:#010x} "
                f"inj={rec['injected']:2d} {rec['fault_kinds']} "
                f"dev={rec['device_batches']:2d} "
                f"host={rec['host_batches']:2d} "
                f"{'RAISED' if rec['raised'] else 'finished'} "
                f"{'OK' if rec['ok'] else 'WRONG VERDICT'}")
        if not rec["ok"]:
            print(f"WRONG VERDICT round={r} seed={rec['seed']:#x} "
                  f"batches={rec['wrong']}", file=sys.stderr)
    batch._DeviceLane.reset_all(timeout=30.0)
    proved = totals["finished_with_faults"] > 0
    return {"ok": totals["wrong_rounds"] == 0 and proved,
            "proved": proved, "seed": args.seed, "flap": args.flap,
            "mesh": args.mesh, "device": args.device,
            "seconds": round(health.SYSTEM_CLOCK.monotonic() - t_begin, 3),
            "fault_counters": metrics.fault_counters(), **totals}


def main(argv=None):
    summary = soak(parse_args(argv), log=lambda m: print(m, flush=True))
    print("CHAOS_SOAK", json.dumps(summary))
    if not summary["proved"]:
        print("VIOLATION: no round with an injected fault finished with "
              "verdicts; the soak proved nothing", file=sys.stderr)
    sys.stdout.flush()  # os._exit skips buffer flushing
    # soak() stopped the lane workers; exit without risking interpreter
    # teardown with a parked one.
    os._exit(0 if summary["ok"] else 1)


if __name__ == "__main__":
    main()
