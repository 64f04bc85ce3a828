"""The H100's published peaks and what K1 (`csrc/expand_compressed.cu`)
must do on a compressed wire, copied from `chip_smoke.py` (`k1_work` and
the prices above it) so that the yardstick sits with the benchmark.

Peaks (H100 SXM data sheet, at the 700 W limit): HBM3 at 3.35 TB/s; int32
operations at the SM's issue limit, 128 lanes a clock over 132 SMs at the
1.98 GHz boost clock (33.5e12/s); integer multiply-adds at half that.
Field operations are priced at the 8 x 32-bit arithmetic of
`csrc/fe25519_u32.cuh`, counted by hand from the source (see
`chip_smoke.py` for the counts' derivation)."""

import numpy as np

from portbench.reference.ed25519_ref import (BASEPOINT, D, P, SQRT_M1,
                                             compress, scalar_mul)

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 128 * 132 * 1.98e9
IMAD_PER_S = 64 * 132 * 1.98e9

OPS8_FE_ADD = 20
OPS8_FE_MUL = 16 + 7 * 25 + 36
MADS8_FE_MUL = 64 + 8 + 2
OPS8_TO_CANONICAL = 145
MADS8_TO_CANONICAL = 1 + 19
OPS8_FE_SQ = 14 + 69 + 8 + 15 + 15 + 36
MADS8_FE_SQ = 36 + 8 + 2

# K1 per lane: the squarings y^2, v^2, (v^3)^2 and the 251 of the pow22523
# ladder; the multiplies d*y^2, v^2*v, v^6*v, u*v^7, the ladder's 11,
# u*v^3, *t1 and x*y; u and v; X, Y and T to canonical limbs.  The flip
# multiply and the neg subtraction are counted from the hints.
K1_SQS_PER_LANE = 3 + 251
K1_MULS_PER_LANE = 4 + 11 + 3
K1_ADDS_PER_LANE = 2
K1_CANONICAL_PER_LANE = 3


def k1_counts(lanes: int, flips: int, negs: int) -> "tuple[int, int, int]":
    """(bytes, int32 operations, multiply-adds) K1 must move and do over
    `lanes` lanes of which `flips` carry the sqrt(-1) hint and `negs` the
    negation hint: 33 bytes in and 160 out a lane."""
    muls = lanes * K1_MULS_PER_LANE + flips
    sqs = lanes * K1_SQS_PER_LANE
    adds = lanes * K1_ADDS_PER_LANE + negs
    canon = lanes * K1_CANONICAL_PER_LANE
    return (lanes * (33 + 160),
            sqs * OPS8_FE_SQ + muls * OPS8_FE_MUL + adds * OPS8_FE_ADD
            + canon * OPS8_TO_CANONICAL,
            sqs * MADS8_FE_SQ + muls * MADS8_FE_MUL
            + canon * MADS8_TO_CANONICAL)


def k1_work(wire) -> "tuple[int, int, int]":
    """K1's work on the compressed wire (B, 33, N) uint8 (chip_smoke.py's
    `k1_work`)."""
    wire = np.asarray(wire)
    B, _, N = wire.shape
    hints = wire[:, 32].astype(np.int64)
    return k1_counts(B * N, int((hints & 1).sum()),
                     int(((hints >> 1) & 1).sum()))


def wire_hint(enc: bytes) -> int:
    """The compressed wire's hint for a 32-byte encoding, as the port's
    native host staging sets it: bit 0, the candidate root
    r = u v^3 (u v^7)^((p-5)/8) needed the sqrt(-1) fix-up; bit 1, the
    parity of the (fixed-up) r differs from the sign bit, so K1 negates it
    (also for x = 0 with the sign bit set, where the negation changes
    nothing but is still done).  0 for an encoding that does not
    decompress (no batch holding one reaches the device)."""
    y = (int.from_bytes(enc, "little") & ((1 << 255) - 1)) % P
    u = (y * y - 1) % P
    v = (D * y % P * y + 1) % P
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    flip = 0
    if check == (-u) % P and check != u:
        r = r * SQRT_M1 % P
        flip = 1
    elif check != u:
        return 0
    return flip | (((r & 1) ^ (enc[31] >> 7)) << 1)


B_ENC = compress(BASEPOINT)
SHIFT_B_ENC = compress(scalar_mul(1 << 128, BASEPOINT))
IDENTITY_ENC = (1).to_bytes(32, "little")
CHUNK = 64


def pad_lanes(n: int) -> int:
    """The port's lane padding (`ops/msm.pad_lanes`, without the
    ED25519_TPU_MIN_LANES floor, which the benchmark leaves unset)."""
    return max(CHUNK, -(-n // CHUNK) * CHUNK)


class K1Reckoner:
    """K1's lanes and hints for a device dispatch the harness can work out
    from its own inputs: the port stages a batch of n signatures over m
    distinct keys as the lanes [B, A_1..A_m, the split-high terms
    [2^128]B, [2^128]A_1.., R_1..R_n] (every coefficient of a batch of
    random blinders exceeds 2^128 but for a 2^-125 chance), pads them to
    `pad_lanes` over the chunk's widest batch, and pads the chunk to
    `chunk` batches with the identity (hint 0).  A resident keyset ships
    only the R lanes after the 2(1 + m) head lanes.  `traffic.shift128`
    gives a key's [2^128]A encoding.  Each hint costs a field
    exponentiation; `prime` computes the missing ones in `workers`
    spawned processes."""

    def __init__(self, traffic, workers: int = 1):
        self.traffic = traffic
        self.workers = workers
        self.memo = {IDENTITY_ENC: 0}

    def encodings(self, entries, resident: bool) -> list:
        keys = list(dict.fromkeys(A for A, _, _ in entries))
        encs = [sig[:32] for _, sig, _ in entries]
        if not resident:
            encs += [B_ENC, SHIFT_B_ENC] + keys + [
                self.traffic.shift128(A) for A in keys]
        return encs

    def prime(self, encs) -> None:
        todo = list(dict.fromkeys(e for e in encs if e not in self.memo))
        if self.workers > 1 and len(todo) > 1000:
            import concurrent.futures
            import multiprocessing

            with concurrent.futures.ProcessPoolExecutor(
                    max_workers=self.workers,
                    mp_context=multiprocessing.get_context("spawn")) as pool:
                hints = list(pool.map(wire_hint, todo, chunksize=2048))
        else:
            hints = [wire_hint(e) for e in todo]
        self.memo.update(zip(todo, hints))

    def dispatch(self, batches, chunk: int, resident: bool):
        """K1's (bytes, operations, multiply-adds) for one chunk of staged
        batches (each a list of entries)."""
        n_lanes, flips, negs = 0, 0, 0
        for b in batches:
            encs = self.encodings(b, resident)
            self.prime(encs)
            head = 2 * (1 + len({A for A, _, _ in b}))
            n_lanes = max(n_lanes, head + len(b))
            for e in encs:
                h = self.memo[e]
                flips += h & 1
                negs += (h >> 1) & 1
        n_lanes = pad_lanes(n_lanes)
        if resident:
            n_lanes -= head
        return k1_counts(chunk * n_lanes, flips, negs)


def bound_s(work) -> float:
    """The least time for `work`: the larger of its bytes over the HBM
    rate and its operations over their issue rates."""
    nbytes, ops, mads = work
    return max(nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S,
               mads / IMAD_PER_S)
