"""Forced-device verdict soak — the port of the JAX package's
tools/device_soak.py: mixed valid / tampered / small-order batches
through `verify_many(hybrid=False, merge="never")`, every verdict held
against the per-batch host verdict and the construction truth.

The pool: 24 batches of 20–400 signatures over 48 keys (seeded), each
signature with a 5 % chance a torsion / non-canonical entry with s = 0
(ZIP215-valid), half the batches with one tampered message.  The truth is
by construction: a batch is invalid iff its tamper landed (the JAX tool
takes "half the batches tampered" as the truth, which a torsion entry
drawn at the tamper's index would contradict; the random draws are the
same).

`passes` > 1 re-verifies clones of the same pool.  A chunk dispatches from
residency only when its batches share one keyset, and every batch of the
pool has its own, so a multi-pass soak runs one batch a chunk: each
keyset is then cold at pass 1, built at pass 2 and dispatched from
resident tables (K1 on the R wire, K4, K2t, K3) from pass 3.  A single
pass keeps the JAX tool's chunk of 8.

    python -m ed25519_consensus_tpu_torch.tools.device_soak [--passes 1]
        [--seed 0xDEC5] [--device cpu]

Runs on the card by default; `--device cpu` runs the kernels' plain
versions.  Prints DEVICE_SOAK and the summary; exits nonzero on a verdict
that differs from the host or the construction truth."""

import argparse
import json
import random
import sys
import time

from .. import Signature, SigningKey, batch, health
from . import soak

DEFAULT_SEED = 0xDEC5
BATCHES = 24
KEYS = 48


def make_pool(rng, batches: int = BATCHES):
    """(verifiers, construction truth) of the seeded pool (module
    docstring), drawn from `rng` in the JAX tool's order."""
    keys = [SigningKey.new(rng) for _ in range(KEYS)]
    encs = soak.torsion_encodings()
    vs, want = [], []
    for i in range(batches):
        bv = batch.Verifier()
        n = rng.randrange(20, 400)
        bad = rng.random() < 0.5
        bad_at = rng.randrange(n) if bad else -1
        tampered = False
        for j in range(n):
            if rng.random() < 0.05:
                A = rng.choice(encs)
                R = rng.choice(encs)
                bv.queue((A, Signature(R, b"\x00" * 32), b"Zcash"))
                continue
            sk = rng.choice(keys)
            m = b"soak %d %d" % (i, j)
            sig = sk.sign(m)
            if j == bad_at:
                m = m + b"!"  # tamper
                tampered = True
            bv.queue((sk.verification_key_bytes(), sig, m))
        vs.append(bv)
        want.append(not tampered)
    return vs, want


def run(seed: int = DEFAULT_SEED, passes: int = 1, device=None,
        batches: int = BATCHES, clock=None, log=print) -> dict:
    """The soak → its summary: per pass the verdict counts, the device /
    host split, confirmed and overturned device rejects, the devcache
    dispatch counters and the batches whose verdict differs (`wrong`,
    with `ok` False).  The chunk is 8 for one pass, 1 for more (module
    docstring); `batches` < 24 takes a prefix of the pool (the tests'
    size).  `clock` (a health.FakeClock) puts each pass's device health on
    a virtual clock, so no chunk deadline depends on the host's speed."""
    chunk = 8 if passes == 1 else 1
    rng = random.Random(seed)
    vs, want = make_pool(rng, batches)
    host = [batch._host_verdict(v.clone(), rng) for v in vs]
    batch.warm_device_shapes(vs[0].clone(), chunk=chunk, device=device)
    out = {"seed": seed, "passes": [], "batches": len(vs),
           "sigs": sum(v.batch_size for v in vs), "chunk": chunk,
           "device": device, "host_equals_truth": host == want}
    wrong = [] if host == want else [
        ("host", i) for i, (h, w) in enumerate(zip(host, want)) if h != w]
    for p in range(passes):
        batch.reset_device_health()
        h = None if clock is None else health.DeviceHealth(clock=clock)
        t0 = time.perf_counter()
        got = batch.verify_many([v.clone() for v in vs], rng=rng,
                                chunk=chunk, hybrid=False, merge="never",
                                health=h, device=device)
        dt = time.perf_counter() - t0
        s = dict(batch.last_run_stats)
        bad = [i for i, (g, h) in enumerate(zip(got, host)) if g != h]
        wrong += [(p, i) for i in bad]
        dc = s.get("devcache", {})
        rec = {"pass": p, "seconds": dt, "valid": sum(got),
               "device_batches": s.get("device_batches", 0),
               "host_batches": s.get("host_batches", 0),
               "rejects_confirmed": s.get("device_rejects_confirmed", 0),
               "rejects_overturned": s.get("device_rejects_overturned", 0),
               "dispatch_hits": dc.get("dispatch_hits", 0),
               "table_dispatch_hits": dc.get("table_dispatch_hits", 0),
               "wrong": bad}
        out["passes"].append(rec)
        log(f"# pass {p}: {len(vs)} batches in {dt:.2f} s; device "
            f"{rec['device_batches']} / host {rec['host_batches']}; rejects "
            f"confirmed {rec['rejects_confirmed']} overturned "
            f"{rec['rejects_overturned']}; table dispatches "
            f"{rec['table_dispatch_hits']}; wrong {bad}")
    out["wrong"] = wrong
    out["rejects_overturned"] = sum(r["rejects_overturned"]
                                    for r in out["passes"])
    out["table_dispatch_hits"] = sum(r["table_dispatch_hits"]
                                     for r in out["passes"])
    out["ok"] = not wrong
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=lambda s: int(s, 0), default=DEFAULT_SEED)
    ap.add_argument("--passes", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    summary = run(args.seed, args.passes, args.device,
                  log=lambda m: print(m, flush=True))
    print("DEVICE_SOAK", json.dumps(summary))
    sys.stdout.flush()
    batch._DeviceLane.reset_all(timeout=30.0)
    sys.exit(0 if summary["ok"] else 1)


if __name__ == "__main__":
    main()
