"""Randomized soak: the streaming surfaces against the per-call oracle —
the port of the JAX package's tools/soak.py.

Generates rounds of randomized workloads — variable batch sizes (0..~300),
valid/tampered/malformed/non-canonical/torsion signatures, repeated keys,
duplicate entries — and checks that `batch.verify_many` (union-merge +
bisection + scheduler) and `batch.verify_single_many` agree exactly with
the per-call ZIP215 verdicts.  Consensus software lives or dies on this
agreement; the fixed seed makes any failure reproducible.

The soak runs the host lane: `run` holds `ED25519_TPU_DISABLE_DEVICE=1`
for its own duration (config.override, restored on return) — importing
the module changes nothing.  The entry stream and the oracle's verdicts
are pure functions of the seed and equal to the JAX tool's: `run` returns
the SHA-256 of each.

Usage: python -m ed25519_consensus_tpu_torch.tools.soak [--rounds 40]
           [--seed 0xD00D]
"""

import argparse
import hashlib
import json
import random
import sys

from .. import (
    InvalidSignature, MalformedPublicKey, Signature, SigningKey,
    VerificationKey, batch, config, health,
)
from ..ops import edwards
from ..ops.scalar import L
from ..utils import fixtures

DEFAULT_SEED = 0xD00D


def oracle(vkb, sig, msg) -> bool:
    """Per-call reference verdict (the reference's verify loop).  Catches
    ONLY the library's rejection exceptions — any other exception is a
    real bug and must crash the soak, not read as 'invalid'."""
    try:
        VerificationKey.from_bytes(vkb).verify(
            sig if isinstance(sig, Signature) else Signature.from_bytes(sig),
            msg)
        return True
    except (InvalidSignature, MalformedPublicKey):
        return False


def random_entry(rng, keys, torsion_encs):
    """One randomized (vkb, sig, msg) entry, adversarial with prob ~1/3."""
    roll = rng.random()
    sk = rng.choice(keys)
    msg = b"soak-%d" % rng.getrandbits(48)
    if roll < 0.55:
        return (sk.verification_key_bytes(), sk.sign(msg), msg)
    if roll < 0.70:  # tampered
        return (sk.verification_key_bytes(), sk.sign(b"evil"), msg)
    if roll < 0.80:  # torsion/non-canonical A and R, s = 0 (ZIP215-valid)
        enc = rng.choice(torsion_encs)
        return (enc, Signature(rng.choice(torsion_encs), b"\x00" * 32),
                b"Zcash")
    if roll < 0.88:  # s >= l (must reject)
        sig = sk.sign(msg)
        return (sk.verification_key_bytes(),
                Signature(sig.R_bytes, int(L).to_bytes(32, "little")), msg)
    if roll < 0.94:  # non-point key (must reject)
        return (b"\x02" + b"\x00" * 31, sk.sign(msg), msg)
    # duplicate-prone: fixed message, fixed key
    return (keys[0].verification_key_bytes(), keys[0].sign(b"dup"), b"dup")


def torsion_encodings() -> list:
    """The eight torsion points and six non-canonical encodings."""
    encs = [p.compress() for p in edwards.eight_torsion()]
    return encs + fixtures.non_canonical_point_encodings()[:6]


def entry_bytes(entry) -> bytes:
    """The wire bytes of one entry (key ‖ signature ‖ message), for the
    stream digest."""
    vkb, sig, msg = entry
    vk = vkb if isinstance(vkb, (bytes, bytearray)) else vkb.to_bytes()
    return bytes(vk) + sig.to_bytes() + bytes(msg)


def run(rounds: int = 40, seed: int = DEFAULT_SEED, log=print) -> dict:
    """The soak → its summary.  Raises SystemExit naming the round on the
    first verdict that differs from the oracle (explicit raises, not
    asserts: the checks must survive python -O)."""
    with config.override(ED25519_TPU_DISABLE_DEVICE="1"):
        return _run(rounds, seed, log)


def _run(rounds, seed, log):
    rng = random.Random(seed)
    keys = [SigningKey.new(rng) for _ in range(24)]
    torsion_encs = torsion_encodings()
    stream_digest = hashlib.sha256()
    verdict_digest = hashlib.sha256()
    t_start = health.SYSTEM_CLOCK.monotonic()
    total_batches = total_sigs = 0
    for rnd in range(rounds):
        n_batches = rng.randrange(1, 24)
        stream, expect = [], []
        flat, flat_expect = [], []
        for _ in range(n_batches):
            n = rng.choice([0, 1, 2, 3, 8, 32, 64, 150, 300])
            entries = [random_entry(rng, keys, torsion_encs)
                       for _ in range(n)]
            for e in entries:
                stream_digest.update(entry_bytes(e))
            v = batch.Verifier()
            if rng.random() < 0.5:
                v.queue_bulk(entries)
            else:
                for e in entries:
                    v.queue(e)  # parsing never validates (deferred)
            # exact expectation: every queued entry must verify
            batch_ok = True
            for e in entries:
                ok = oracle(*e)
                if rng.random() < 0.1:
                    flat.append(e)
                    flat_expect.append(ok)
                batch_ok = batch_ok and ok
            expect.append(batch_ok)
            stream.append(v)
            total_sigs += v.batch_size
        total_batches += n_batches
        verdict_digest.update(repr((expect, flat_expect)).encode())
        merge = rng.choice(["auto", "always", "never"])
        got = batch.verify_many(stream, rng=rng, merge=merge,
                                chunk=rng.choice([2, 4, 8]))
        if got != expect:
            raise SystemExit(
                f"round {rnd}: verify_many(merge={merge}) mismatch\n"
                f"got    {got}\nexpect {expect}")
        if flat:
            got_flat = batch.verify_single_many(flat, rng=rng)
            if got_flat != flat_expect:
                raise SystemExit(
                    f"round {rnd}: verify_single_many mismatch")
        if rnd % 10 == 0:
            log(f"# round {rnd}: {n_batches} batches ok "
                f"(cumulative {total_sigs} sigs)")
    return {"ok": True, "rounds": rounds, "seed": seed,
            "batches": total_batches, "sigs": total_sigs,
            "seconds": round(health.SYSTEM_CLOCK.monotonic() - t_start, 3),
            "stream_sha256": stream_digest.hexdigest(),
            "verdicts_sha256": verdict_digest.hexdigest()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--seed", type=lambda s: int(s, 0), default=DEFAULT_SEED)
    args = ap.parse_args(argv)
    summary = run(args.rounds, args.seed,
                  log=lambda m: print(m, flush=True))
    print(f"SOAK OK: {summary['rounds']} rounds, {summary['batches']} "
          f"batches, {summary['sigs']} sigs in {summary['seconds']:.0f}s "
          f"(seed {args.seed:#x})")
    print("SOAK", json.dumps(summary))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
