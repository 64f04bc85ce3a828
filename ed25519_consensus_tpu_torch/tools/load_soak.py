"""Service-layer overload soak: concurrent submitters, seeded deadlines and
seeded fault and overload storms against a small-capacity `VerifyService`
on the card — the port of the JAX package's tools/load_soak.py.  Each
round must hold the service's acceptance bar:

* **Nothing lost**: every submitted batch resolves to exactly one of
  {verdict, Overloaded, DeadlineExceeded, the device wave's exception} —
  counted per round, no wall-time assertions.
* **Host-identical verdicts**: every verdict the service returned equals
  the host verdict of the same batch, whatever the (injected) device did
  and however the breaker and the queues behaved.

Submissions carry a seeded mix of traffic classes (consensus / mempool /
rpc), so the per-class queues and the priority drain are under the same
storms.  Storm profiles (--storm; faults.storm_plan and request-side
schedules):

* ``none``     — pure overload: capacity pressure only.
* ``stall``    — a stall storm at the lane dispatch (calls sleep past the
  scheduler's 2 s deadline floor: deadline misses, breaker food).
* ``slowchip`` — a GRAY window: a few mid-round device calls run 0.25 s
  slow — correct verdicts, late; the latency ledger records them on a
  live service and nothing sheds or wedges.
* ``death``    — device death mid-queue (KillLane: the lane worker dies
  with chunks in flight, replacement lanes die in the window).
* ``error``    — a crash storm (every call in the window raises).
* ``deadline`` — a deadline storm on the REQUEST side: a third of the
  submissions carry tight or already-expired deadlines.
* ``mixed``    — randomized_plan faults (errors, stalls, corrupted sums)
  and the deadline storm together.
* ``churn``    — a cache-churn storm: every round's batches recur over
  one of three keysets while the injected device operand cache holds
  two, so residency cycles build → hit → evict → rebuild, with a rotating
  devcache fault plan (corrupt / evict / stale) on the lookup seam.  It
  must exercise residency (devcache hits > 0) or the soak fails.

A device error out of `verify_many` reaches the service as a
`DeviceError` wave, whose tickets carry it (service.py: the host never
decides what the device failed to); the soak counts them as
`device_error` outcomes, and any other exception a device wave's tickets
carry as `crash`.

Before the first round, `main` runs the consensuslint gate
(`lint_gate`): it publishes the analysis gauges and exits 2 when the
port's tree has an active finding, a stale or malformed waiver file, or
more waivers than `--max-waivers` (default `MAX_WAIVERS`, the committed
count, which tests/test_torch_consensuslint.py pins).

    python -m ed25519_consensus_tpu_torch.tools.load_soak [--seed 0x10AD]
        [--rounds 4] [--submitters 3] [--requests 8] [--sigs 4]
        [--capacity-sigs 48] [--mesh 0] [--storm mixed] [--device cpu]
        [--json] [--max-waivers 6]

Runs on the card by default; `--device cpu` runs the kernels' plain
versions on the CPU.  Exits nonzero on any violation, printing the replay
seed: plans and deadline schedules are pure functions of (seed, round),
so a failure reproduces with --seed N --rounds 1."""

import argparse
import contextlib
import json
import os
import random
import sys
import threading

from .. import (SigningKey, batch, config, devcache, faults, health,
               service, tenancy)
from ..error import DeviceError
from ..utils import metrics

# The consensuslint waiver ratchet: the committed waiver count.
MAX_WAIVERS = 6

STORMS = ("none", "stall", "death", "error", "deadline", "mixed", "churn",
          "slowchip")


def make_pool(rnd, keys, n_batches, sigs, keyset=None):
    """Mixed valid/tampered batches of a fixed size (one warmed chunk
    shape).  With `keyset` (the churn storm), sig j of EVERY batch signs
    with keyset[j]: all batches share one keyset blob, so chunks are
    keyset-uniform and recur in the device operand cache."""
    vs, want = [], []
    for b in range(n_batches):
        v = batch.Verifier()
        bad_at = rnd.randrange(sigs) if rnd.random() < 0.35 else -1
        for j in range(sigs):
            sk = keyset[j % len(keyset)] if keyset else rnd.choice(keys)
            m = b"load %d %d" % (b, j)
            sig = sk.sign(m)
            if j == bad_at:
                m += b"!"  # tamper
            v.queue((sk.verification_key_bytes(), sig, m))
        vs.append(v)
        want.append(bad_at < 0)
    return vs, want


def storm_for(profile, seed, site):
    if profile in ("none", "deadline"):
        return None
    if profile == "churn":
        # A devcache fault window rides every churn round, its kind
        # rotating by seed so the soak sweeps all three seams.
        kind = ("corrupt", "evict", "stale")[seed % 3]
        return faults.devcache_plan(seed, kind, at=2, length=4)
    if profile == "stall":
        # the default storm seconds exceed the warmed 8-batch chunk's
        # budget, so the window deterministically blows deadlines
        return faults.storm_plan(seed, "stall", at=1, length=3, site=site)
    if profile == "slowchip":
        # A gray window: 0.25 s late is well inside every non-tight
        # deadline, so the gate stays zero lost and host-identical.
        return faults.storm_plan(seed, "slow", at=1, length=4,
                                 seconds=0.25, site=site)
    if profile == "death":
        return faults.storm_plan(seed, "crash", at=1, length=2)
    if profile == "error":
        return faults.storm_plan(seed, "error", at=0, length=6, site=site)
    if profile == "mixed":
        return faults.randomized_plan(seed, error_rate=0.2,
                                      stall_rate=0.1, stall_seconds=0.3,
                                      corrupt_rate=0.1, site=site)
    raise SystemExit(f"unknown storm profile {profile!r}")


def class_for(rnd):
    """Seeded traffic class per submission (a consensus-heavy mix)."""
    r = rnd.random()
    if r < 0.4:
        return tenancy.CLASS_CONSENSUS
    if r < 0.8:
        return tenancy.CLASS_MEMPOOL
    return tenancy.CLASS_RPC


def deadline_for(profile, rnd):
    """Seeded per-request RELATIVE deadline (seconds from submit): None,
    generous, tight, or already expired — the deadline storms skew
    tight."""
    if profile in ("deadline", "mixed"):
        r = rnd.random()
        if r < 0.2:
            return -1.0       # expired at submit: must shed
        if r < 0.5:
            return 0.05       # tight: host route or shed
        return 120.0
    return None if rnd.random() < 0.5 else 120.0


def churn_keysets(keys, sigs):
    """Three disjoint keysets of `sigs` keys for the churn storm (three
    over a two-entry budget always churns); the pool grows with fresh
    deterministic keys when 3·sigs exceeds it."""
    keys = list(keys)
    grow = random.Random(0xC0AB)
    while len(keys) < 3 * sigs:
        keys.append(SigningKey.new(grow))
    return [keys[i * sigs:(i + 1) * sigs] for i in range(3)]


def run_round(r, round_seed, args, keys, site):
    rnd = random.Random(round_seed ^ 0x5EED)
    keyset = (churn_keysets(keys, args.sigs)[r % 3]
              if args.storm == "churn" else None)
    vs, want = make_pool(rnd, keys,
                         args.submitters * args.requests, args.sigs,
                         keyset=keyset)
    host_truth = [batch._host_verdict(v.clone(), random.Random(
        round_seed ^ 0xB11D)) for v in vs]
    assert host_truth == want, "host ground truth must match construction"

    batch.reset_device_health()
    svc = service.VerifyService(
        capacity_sigs=args.capacity_sigs,
        high_watermark=0.8, low_watermark=0.4,
        wave_max_batches=6, chunk=8,
        hybrid=False,  # force device participation
        # mesh passes through verbatim: 0 pins the single-device lane, so
        # the storm's fault site is the dispatch boundary that runs
        merge="never", mesh=args.mesh,
        breaker_failure_threshold=2, breaker_seed=round_seed,
        rng=random.Random(round_seed ^ 0xB11D), device=args.device)
    outcomes = [None] * len(vs)
    drnd = random.Random(round_seed ^ 0xDEAD)
    deadlines = [deadline_for(args.storm, drnd) for _ in vs]
    crnd = random.Random(round_seed ^ 0xC1A5)
    classes = [class_for(crnd) for _ in vs]

    def submitter(k):
        # Submit the whole stream FIRST (queue pressure is the point),
        # then collect every outcome.
        base = k * args.requests
        tickets = []
        for i in range(args.requests):
            idx = base + i
            dl = deadlines[idx]
            try:
                t = svc.submit(
                    vs[idx],
                    deadline=None if dl is None else svc.now() + dl,
                    cls=classes[idx])
            except service.Overloaded:
                outcomes[idx] = "overloaded"
                continue
            except service.ServiceClosed:
                outcomes[idx] = "closed"
                continue
            tickets.append((idx, t))
        for idx, t in tickets:
            try:
                outcomes[idx] = t.result(timeout=120.0)
            except service.DeadlineExceeded:
                outcomes[idx] = "deadline"
            except service.ServiceClosed:
                outcomes[idx] = "closed"
            except DeviceError:
                outcomes[idx] = "device_error"
            except TimeoutError:
                pass  # never resolved: lost
            except Exception:  # noqa: BLE001 - a device wave's crash
                outcomes[idx] = "crash"

    plan = storm_for(args.storm, round_seed, site)
    threads = [threading.Thread(target=submitter, args=(k,))
               for k in range(args.submitters)]
    if plan is not None:
        faults.install(plan)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        if plan is not None:
            faults.uninstall()
    svc.close()

    lost = sum(1 for o in outcomes if o is None)
    mismatches = [i for i, o in enumerate(outcomes)
                  if isinstance(o, bool) and o != host_truth[i]]
    tally = {
        "verdicts": sum(isinstance(o, bool) for o in outcomes),
        "overloaded": outcomes.count("overloaded"),
        "deadline": outcomes.count("deadline"),
        "closed": outcomes.count("closed"),
        "device_error": outcomes.count("device_error"),
        "crash": outcomes.count("crash"),
    }
    st = svc.stats()
    rec = {
        "round": r, "seed": round_seed, "storm": args.storm,
        "lost": lost, "mismatches": len(mismatches),
        "injected": 0 if plan is None else len(plan.injection_log()),
        "breaker": st["breaker_state"],
        "crash_fallbacks": st["crash_fallbacks"],
        "device_error_waves": st["device_error_waves"],
        "host_waves": st["host_waves"], "device_waves": st["device_waves"],
        "by_class": st["by_class"],
        **tally,
    }
    ok = lost == 0 and not mismatches
    if not ok:
        print(f"VIOLATION round={r} seed={round_seed:#x} lost={lost} "
              f"mismatch_batches={mismatches} outcomes={outcomes} "
              f"want={host_truth}", file=sys.stderr)
    return ok, rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=lambda s: int(s, 0), default=0x10AD)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--submitters", type=int, default=3)
    ap.add_argument("--requests", type=int, default=8,
                    help="batches per submitter per round")
    ap.add_argument("--sigs", type=int, default=4,
                    help="signatures per batch (fixed — one warm shape)")
    ap.add_argument("--capacity-sigs", type=int, default=48,
                    help="small on purpose: overload must actually occur")
    ap.add_argument("--mesh", type=int, default=0)
    ap.add_argument("--storm", default="mixed", choices=STORMS)
    ap.add_argument("--device", default=None,
                    help="torch device of the service (default: CUDA; "
                         "cpu runs the kernels' plain versions)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--max-waivers", type=int, default=MAX_WAIVERS,
                    help="consensuslint waiver ratchet: refuse to soak a "
                         "tree whose committed waiver count exceeds this")
    return ap.parse_args(argv)


def soak(args) -> dict:
    """Every round of the soak → the summary ({"ok", "violations", ...});
    prints one line (or JSON record) per round.  Knob overrides the storm
    needs are scoped to the soak."""
    with contextlib.ExitStack() as stack:
        return _soak(args, stack)


def lint_gate(max_waivers: int) -> "str | None":
    """The consensus-safety ratchet run before a soak: publish the
    consensuslint gauges (waivers, active findings, per-rule counts, the
    manifests' hashes) and refuse a tree whose analysis is dirty, whose
    waiver file or scope lists are stale, or whose waiver count grew past
    `max_waivers`.  The reason as a line, or None when the tree is
    clean."""
    from ..analysis import linter

    fix = "run `python -m ed25519_consensus_tpu_torch.tools.consensuslint`"
    try:
        st = linter.publish_gauges()
    except (linter.WaiverError, linter.ScopeError) as e:
        return f"consensuslint error — {e}; {fix}"
    if st["findings_active"] or st["waiver_count"] > max_waivers:
        return (f"consensuslint gate — {st['findings_active']} active "
                f"finding(s), {st['waiver_count']} waiver(s) (max "
                f"{max_waivers}); {fix}")
    return None


def _soak(args, stack) -> dict:
    rnd = random.Random(args.seed)
    keys = [SigningKey.new(rnd) for _ in range(16)]
    site = faults.SITE_SHARDED if args.mesh and args.mesh > 1 \
        else faults.SITE_LANE
    cache = None
    if args.storm == "churn":
        # A cache whose budget holds exactly TWO resident head tensors:
        # the per-round keyset rotation then cycles residency.  The raised
        # EMA prior keeps a slow real-clock dispatch from arming a
        # cooldown that would starve the lookup stream the gate reads.
        prior = config.get_raw("ED25519_TPU_EMA_PRIOR")
        stack.enter_context(config.override(
            ED25519_TPU_EMA_PRIOR="10" if prior is None else prior))
        from ..ops import limbs
        entry_bytes = 4 * limbs.NLIMBS * 2 * (args.sigs + 1) * 2
        cache = devcache.DeviceOperandCache(
            budget_bytes=int(2.5 * entry_bytes), enabled=True)
        devcache.set_default_cache(cache)
    warm_vs, _ = make_pool(random.Random(args.seed ^ 0xA), keys,
                           1, args.sigs)
    if not args.mesh or args.mesh <= 1:
        batch.warm_device_shapes(warm_vs[0], chunk=8, device=args.device)

    violations = 0
    t_begin = health.SYSTEM_CLOCK.monotonic()
    totals = {"rounds": 0, "batches": 0, "verdicts": 0, "overloaded": 0,
              "deadline": 0, "closed": 0, "device_error": 0, "crash": 0,
              "injected": 0, "device_error_waves": 0,
              "crash_fallbacks": 0}
    for r in range(args.rounds):
        round_seed = rnd.getrandbits(32)
        ok, rec = run_round(r, round_seed, args, keys, site)
        violations += not ok
        totals["rounds"] += 1
        totals["batches"] += args.submitters * args.requests
        for k in ("verdicts", "overloaded", "deadline", "closed",
                  "device_error", "crash", "injected",
                  "device_error_waves", "crash_fallbacks"):
            totals[k] += rec[k]
        if args.json:
            print(json.dumps(rec), flush=True)
        else:
            print(f"round {r:2d} seed={round_seed:#010x} "
                  f"inj={rec['injected']:3d} verdicts={rec['verdicts']:2d} "
                  f"ovl={rec['overloaded']:2d} dl={rec['deadline']:2d} "
                  f"err_waves={rec['device_error_waves']:2d} "
                  f"err_tickets={rec['device_error']:2d} "
                  f"breaker={rec['breaker']:9s} "
                  f"{'OK' if ok else 'VIOLATION'}", flush=True)
    dt = health.SYSTEM_CLOCK.monotonic() - t_begin
    if args.storm == "churn":
        st = cache.stats()
        if st["hits"] == 0 or \
                metrics.gauges().get("devcache_hits", 0) == 0:
            print(f"VIOLATION: churn storm produced no devcache hits "
                  f"(stats={st}) — residency never exercised",
                  file=sys.stderr)
            violations += 1
        devcache.set_default_cache(None)
    if args.storm in ("stall", "death", "error", "mixed", "churn",
                      "slowchip") \
            and totals["injected"] == 0:
        # A device-fault storm that never injected tested nothing.
        print(f"VIOLATION: storm {args.storm!r} injected 0 faults over "
              f"{totals['rounds']} rounds (site mismatch or device "
              f"never dispatched?)", file=sys.stderr)
        violations += 1
    summary = {
        "ok": violations == 0, "violations": violations,
        "seconds": round(dt, 2), "storm": args.storm,
        "device": args.device, **totals,
        "fault_counters": metrics.fault_counters(),
    }
    if cache is not None:
        summary["devcache"] = cache.stats()
    return summary


def main(argv=None):
    args = parse_args(argv)
    refused = lint_gate(args.max_waivers)
    if refused is not None:
        print(f"VIOLATION: {refused}", file=sys.stderr)
        sys.exit(2)
    summary = soak(args)
    print("LOAD_SOAK", json.dumps(summary))
    sys.stdout.flush()  # os._exit skips buffer flushing
    # Never risk interpreter teardown with a parked lane worker (stall
    # storms abandon workers by design).
    batch._DeviceLane.reset_all(timeout=30.0)
    os._exit(0 if summary["ok"] else 1)


if __name__ == "__main__":
    main()
