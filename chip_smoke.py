"""Smoke run of the PyTorch/CUDA port (`ed25519_consensus_tpu_torch`) on one
NVIDIA GPU: builds the CUDA kernels from `csrc/` and the native host runtime
from `csrc/host/`, holds each kernel against its plain PyTorch version on the
card, drives the port's two paths, and times the kernels.

* Single-batch verification: a 10,000-signature Zcash block-sync batch
  through `Verifier.verify_gpu()`, a tampered copy, the adversarial ZIP215
  batch, and one stacked B = 8 device call (kernels K1, K2, K3).
* `verify_many` on one card with resident keysets: the zcash10k batch at
  depth 16, device only, cold (cache off), warm-residency, hot with
  resident tables (K1, K4, K2t, K3) and hot with resident heads (K1, K2,
  K3); then a 256-height cometbft128 commit stream through verify_many's
  defaults and per commit.
* The front door, `VerifyService(device="cuda:0", hybrid=False)`: the cometbft128
  stream as mempool admission (with the zcash10k block and rpc traffic),
  block inclusion from the verdict memo, and vote replay after a
  validator-set rotation (K1, K2, K3, K4, K2t); then the overload soak
  (tools/load_soak.py --storm mixed).
* The sharded mesh at D = 2 and D = 4 — shard k on cuda:k when that many
  cards are visible, else every shard on cuda:0 (a virtual mesh; the log
  names the placement): the 1M-signature pod batch and a tampered copy
  through `sharded_msm.sharded_staged_msm`, then pod100k batches through
  `verify_many(mesh=D)` cold, from a resident head and with every chunk
  audited by the sentinel (K1, K2, K3 per shard, K5 across shards); then
  the affine wire through the single lane and the mesh (K6 in place of
  K1).  K5 and K6 are held against their plain versions on the operands
  those paths gave them, and the routing model's constants `a` and `b`
  are measured.
* The gray-failure half of the scheduler (`phase_gray`): the straggler
  lab, the sentinel soak and the slowchip overload soak at their defaults;
  the cometbft128 stream one commit a hybrid call with a deadline, clean
  and then with chip 0 flapping slow (hedged re-dispatch); pod100k on a
  4-chip mesh of logical chips with chip 3 corrupting until it is
  quarantined, then on probation, probed and rejoined (K1, K2, K3, K5,
  and K4, K2t on the stream's resident keyset).
* The federation (`phase_federation`): a `federation.ReplicaSet` of three
  `VerifyService(device="cuda:0", hybrid=False)` replicas over their
  namespaced device operand caches; eight CometBFT chains of 128
  validators each, 64 heights a pass, one tampered commit a chain, four
  passes — cold, resident (K2t from each chain's home), a crash of chain
  0's home with its queue re-verified on peers and the replica revived,
  probed and rejoined with its peers' warm hints, affinity restored (K1,
  K2, K4, K2t, K3); then tools/traffic_lab.py --fleet 3 --replica-crash
  and --device, and tools/mesh_chaos.py (8 logical chips: K1–K3 a shard,
  K5) at their defaults.
* The analysis layer (`phase_analysis`): the integer-only SASS audit of
  every built kernel library against `analysis/sass_manifest.json`, the
  device race audit (`consensuslint --race-audit --device cuda:0`: the
  cometbft128 stream through a `hybrid=False` service with four submitter
  threads, a three-replica fleet through a crash and rejoin, a hybrid
  `verify_many`, under the lock-order and write-race monitors; the same
  harness bare in a second process for the audit's overhead, and the
  workload once more in this process for the launch counts) and the
  `consensuslint --stats` line.
* The lab: the 20-limb K1, K2, K2t, K3 and K4 (`-l20`) timed in turns with
  the default ones (fe25519_u32.cuh) on the main path's operands; the
  self-test of their field arithmetic (probe_fe8) against the exact-
  integer model, with the SASS of each operation counted; the kernel
  lab's sweep, the two knobs, the stage profile and the probes.

    python3 chip_smoke.py
    python3 chip_smoke.py --stress-tables REPS SECONDS
    python3 chip_smoke.py --sanitize
    python3 chip_smoke.py --cold-start [CHECKOUT ...]
    python3 chip_smoke.py --shift128

The second form only runs the cometbft128 per-commit stream again and again
(`stress_tables_path`) and exits nonzero if the device ever rejected a batch
the host accepts.  The third runs every kernel once at small shapes against
its plain version, for compute-sanitizer (`sanitize_path`).  The fourth
times a verdict path's first call with an empty kernel cache in each
checkout named (default: this one), in the order given (`cold_start_path`).
The fifth runs only `phase_shift128`: K7 on a zcash.sync-shaped cold
dispatch against its plain version, timed, and the cold path through it.

Exits nonzero, and prints no result, without a CUDA device, outside a
checkout of the repository, when the native runtime does not build or fails
its self-check, or when any phase fails.  Its last line is
`{"ok": true, "device": {...}}`; the line before it is the card's name and
power limit, and the one before that the per-kernel JSON record (launch
counts on the two paths, errors against the plain versions, times and
bounds)."""

import json
import os
import random
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The card's peak rates, for each kernel's bound: HBM3 at 3.35 TB/s, and
# int32 operations at the SM's issue limit, 128 lanes per clock (four
# schedulers, one 32-lane instruction each: IMAD on the FMA pipe, adds,
# shifts and logic on the INT32 pipe), the rate behind the 67 TFLOP/s
# float32 peak with a multiply-add counted once: 128 x 132 SMs x the
# 1.98 GHz boost clock (H100 SXM data sheet) = 33.5e12 int32 ops/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 128 * 132 * 1.98e9
# Integer multiply-adds (IMAD) issue at half that rate, 64 a clock an SM:
# a second bound for work rich in multiplies (the 20-limb field products).
IMAD_PER_S = 64 * 132 * 1.98e9

# int32 instructions per field operation, from csrc/fe25519.cuh, a
# multiply-add counting as one.  A carry step is 4 per limb (add the
# rounding offset, shift, multiply-subtract, add the carry in) plus the
# 608 fold.  fe_mul: 400 products, 2 wide steps over 41 columns, 21 fold
# multiply-adds, 5 steps over 20 limbs; fe_sq: 210 products (20 squares,
# 190 doubled cross products) and 19 doublings, then the same carries;
# add / sub / mul_small: 20 ops and one step; a negation: 20.  A complete
# addition is 9 multiplies and 9 adds.
OPS_CARRY = 4 * 20 + 1
OPS_MUL_TAIL = 2 * 4 * 41 + 21 + 5 * OPS_CARRY
OPS_FE_MUL = 400 + OPS_MUL_TAIL
OPS_FE_SQ = 210 + 19 + OPS_MUL_TAIL
OPS_FE_ADD = 20 + OPS_CARRY
OPS_FE_NEG = 20
OPS_GE_ADD = 9 * OPS_FE_MUL + 9 * OPS_FE_ADD
# The same operations in csrc/fe25519_u32.cuh (8 x 32-bit words, carry
# chains), counted by hand from the source, a multiply-add or a 64-bit
# multiply counting as one; tools/ptxas_report.py and the fe8 phase count
# the SASS beside them.  fe8_add: a chain of 8 and its carry word,
# 38 * carry, a chain of 8 and its carry word, the last multiply-add (20,
# 2 on the multiply pipe); fe8_sub the same with two ands and a subtract
# (21); fe8_neg is fe8_sub.  fe8_mul: row 0, 8 mul.wide and a chain of 8;
# rows 1..7, 8 mul.wide, a chain of 8 and its carry word, a chain of 8
# (25 each); the reduction, 8 mul.wide, 17 chain additions, 38 * top, a
# chain of 8 and its carry word, the last multiply-add (36): 227
# operations, of which 74 on the multiply pipe.  A complete addition is 9
# products, 5 adds and 4 subtracts.  The conversions: fe8_from_limbs20
# ~5 a limb into the 64-bit accumulator, 7 word shifts and 23 for the
# fold (130); fe8_to_limbs20_canonical 11 + 18 for the residue, 40 for
# the fields and 76 for the balanced split (145).
OPS8_FE_ADD = 20
MADS8_FE_ADD = 2
OPS8_FE_SUB = 21
OPS8_FE_MUL = 16 + 7 * 25 + 36
MADS8_FE_MUL = 64 + 8 + 2
OPS8_GE_ADD = 9 * OPS8_FE_MUL + 5 * OPS8_FE_ADD + 4 * OPS8_FE_SUB
MADS8_GE_ADD = 9 * MADS8_FE_MUL + 5 * MADS8_FE_ADD
OPS8_FROM_LIMBS20 = 130
OPS8_TO_CANONICAL = 145
MADS8_TO_CANONICAL = 1 + 19
# fe8_sq: row 0, 7 mul.wide and a chain of 7; rows 1..6, 7 - i mul.wide, a
# chain of 7 - i and its carry word, a chain of 7 - i (69 together); the 8
# squares; the doubling chain and its carry word (15); the squares' chain
# (15); fe8_mul's reduction (36): 157 operations, 46 on the multiply pipe
# (36 products, 8 + 2 in the reduction).  phase_fe8 counts the SASS.
OPS8_FE_SQ = 14 + 69 + 8 + 15 + 15 + 36
MADS8_FE_SQ = 36 + 8 + 2
# K1 per lane (csrc/expand_compressed.cu): squarings y^2, v^2, (v^3)^2 and
# the 251 of the pow22523 ladder; multiplies d*y^2, v^2*v, v^6*v, u*v^7,
# the ladder's 11, u*v^3, *t1 and x*y; plus u and v; X, Y and T to
# canonical limbs.  The flip multiply and the neg subtraction are counted
# per lane from the hints (the kernel multiplies every lane, by 1 where
# the hint does not flip: the data needs only the flips).
K1_SQS_PER_LANE = 3 + 251
K1_MULS_PER_LANE = 4 + 11 + 3
K1_ADDS_PER_LANE = 2
K1_CANONICAL_PER_LANE = 3

ZCASH_SIGS, ZCASH_KEYS = 10_000, 64
STACK_B, STACK_N = 8, 12_288
DEPTH = 16  # zcash10k batches per verify_many pass (bench.py's default)
SLICE0_KERNELS = ("expand_compressed", "window_sums", "fold_partials")
COMET_KEYS, COMET_HEIGHTS = 128, 256
# bench.py's pod configs (BASELINE.json config 5): signatures tiled from
# POD_BASE distinct ones over POD_KEYS keys.
POD_SIGS, POD100K, POD_BASE, POD_KEYS = 1_000_000, 100_000, 10_000, 256
MESH_DEPTH = 4  # pod100k batches per verify_many pass on the mesh
DEV = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync() -> None:
    import torch

    if torch.device(DEV).type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of `fn` on the card over `reps` runs (CUDA
    events), after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class Work(tuple):
    """(bytes, int32 operations, integer multiply-adds, operations at the
    20-limb price) a kernel must move and do on its inputs: complete
    additions and field products priced at the 8 x 32-bit arithmetic
    (the least the card is known to need), the last for the 20-limb bound
    beside it."""

    def __new__(cls, nbytes, ops, mads=0, ops_l20=None):
        return super().__new__(cls, (nbytes, ops, mads,
                                     ops if ops_l20 is None else ops_l20))


def adds_work(nbytes, adds, extra_ops=0, extra_mads=0,
              extra_l20=None) -> Work:
    """Work of `adds` complete additions plus other operations."""
    return Work(nbytes, adds * OPS8_GE_ADD + extra_ops,
                adds * MADS8_GE_ADD + extra_mads,
                adds * OPS_GE_ADD + (extra_ops if extra_l20 is None
                                     else extra_l20))


def bound_ms(work) -> "tuple[float, str]":
    """The least time for `work`: the larger of its bytes over the HBM
    rate and its operations over the issue rate of their type (all int32
    operations over 33.5e12/s, the multiply-adds alone over 16.7e12/s)."""
    w = Work(*work)
    tb = w[0] / HBM_BYTES_PER_S
    to = max(w[1] / INT32_OPS_PER_S, w[2] / IMAD_PER_S)
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def bound_note(work) -> str:
    """The log's account of a bound: which pipe, and the 20-limb bound (every
    operation at the 20-limb price over the issue rate) beside it."""
    w = Work(*work)
    which = ("multiply-adds" if w[2] / IMAD_PER_S > w[1] / INT32_OPS_PER_S
             else "all int32 ops")
    old = max(w[0] / HBM_BYTES_PER_S, w[3] / INT32_OPS_PER_S) * 1e3
    return (f"{w[1]:.4e} int32 ops, {w[2]:.4e} multiply-adds ({which} "
            f"bound the ops), {w[0]:.4e} B; 20-limb bound {old:.4f} ms")


def random_wire(n: int, rng):
    """(33, n) uint8 compressed wire: the 14 ZIP215 matrix encodings
    (8 torsion points, 6 non-canonical low-order encodings), the other 20
    non-canonical encodings, then random curve points with random sign
    bits; plus the host points they decompress to."""
    import numpy as np

    from ed25519_consensus_tpu_torch.ops import edwards
    from ed25519_consensus_tpu_torch.utils import fixtures

    encs = [p.compress() for p in edwards.eight_torsion()]
    encs += fixtures.non_canonical_point_encodings()
    out, pts = [], []
    for e in encs:
        pt, h = edwards.decompress_with_hint(e)
        out.append((e, h))
        pts.append(pt)
    while len(out) < n:
        e = rng.getrandbits(256).to_bytes(32, "little")
        res = edwards.decompress_with_hint(e)
        if res is not None:
            out.append((e, res[1]))
            pts.append(res[0])
    w = np.zeros((33, n), dtype=np.uint8)
    for i, (e, h) in enumerate(out[:n]):
        w[:32, i] = np.frombuffer(e, dtype=np.uint8)
        w[32, i] = h
    return w, pts[:n]


def adversarial_digits(B: int, N: int, seed: int):
    """(B, 33, N) int8 digit planes: runs of all -8, all +7 and all 0,
    then uniform digits in [-8, 7]."""
    import numpy as np

    d = np.random.default_rng(seed).integers(
        -8, 8, size=(B, 33, N)).astype(np.int8)
    q = N // 8
    d[:, :, :q] = -8
    d[:, :, q:2 * q] = 7
    d[:, :, 2 * q:3 * q] = 0
    return d


def phase_kernels(report: dict) -> None:
    """Each kernel against its plain PyTorch version on the card."""
    import numpy as np
    import torch

    from ed25519_consensus_tpu_torch.ops import edwards, limbs, msm
    from ed25519_consensus_tpu_torch.ops import torch_decompress as TD

    rng = random.Random(0xC41)
    dev = torch.device(DEV)

    # K1 on 4,096 lanes (B = 2, N = 2,048): exact int16 equality.
    w, pts = random_wire(4096, rng)
    wire = torch.from_numpy(
        np.ascontiguousarray(w.reshape(33, 2, 2048).transpose(1, 0, 2))
    ).to(dev)
    k1 = TD.expand_compressed_points(wire)
    p1 = TD.expand_compressed_points_plain(wire)
    sync()
    err = int((k1.int() - p1.int()).abs().max())
    host = k1.permute(1, 2, 0, 3).reshape(4, limbs.NLIMBS, 4096).cpu()
    bad = [i for i in range(0, 4096, 7) if limbs.unpack_point(
        host[..., i].numpy()) != pts[i]]
    log(f"K1 expand_compressed vs plain: 4096 lanes, max |diff| = {err}; "
        f"vs host decompression on {len(range(0, 4096, 7))} lanes: "
        f"{len(bad)} differ")
    if err or bad:
        raise AssertionError("K1 disagrees with its plain version or host")
    report["expand_compressed"]["max_abs_err"] = err

    # K2 + K3 at B = 2, N = 8,192 with adversarial digits, packed and
    # plain: exact limb equality with the plain versions, every window
    # equal to the plain window sum as a point, and batch 0's MSM equal to
    # the exact host MSM.
    B, N = 2, 8192
    d = adversarial_digits(B, N, seed=7)
    packed = np.stack([limbs.pack_digit_planes(x) for x in d])
    base = k1.permute(1, 2, 0, 3).reshape(4, limbs.NLIMBS, 4096)
    points = base.repeat(1, 1, B * N // 4096).reshape(
        4, limbs.NLIMBS, B, N).permute(2, 0, 1, 3).contiguous()
    dig_p = torch.from_numpy(packed).to(dev)
    dig_i = torch.from_numpy(d).to(dev)
    k2 = msm.window_partials(dig_p, points)
    k2i = msm.window_partials(dig_i, points)
    p2 = msm.window_partials_plain(dig_p, points)
    k3 = msm.fold_partials(k2)
    p3 = msm.fold_partials_plain(p2)
    sync()
    err2 = max(int((k2 - p2).abs().max()), int((k2i - p2).abs().max()))
    err3 = int((k3 - p3).abs().max())
    ws_k, ws_p = k3.cpu().numpy(), p3.cpu().numpy()
    n_bad = sum(limbs.unpack_point(ws_k[b, ..., w]) !=
                limbs.unpack_point(ws_p[b, ..., w])
                for b in range(B) for w in range(33))
    # host MSM for batch 0: scalar_i = Σ_w d_{i,w} 16^(32-w), reduced mod
    # the full group order 8ℓ (torsion points are in the mix)
    from ed25519_consensus_tpu_torch.ops.scalar import L

    wts = [16 ** (32 - w) for w in range(33)]
    scal = [sum(int(d[0, w, i]) * wts[w] for w in range(33)) % (8 * L)
            for i in range(N)]
    host_pts = [pts[i % 4096] for i in range(N)]
    host_ok = msm.combine_window_sums(ws_k[:1]) == \
        edwards.multiscalar_mul(scal, host_pts)
    log(f"K2 window_sums vs plain (B={B}, N={N}, packed and plain "
        f"digits): max |diff| = {err2}; K3 fold_partials vs plain: "
        f"max |diff| = {err3}; windows unequal as points: {n_bad}/66; "
        f"batch-0 MSM equals host MSM: {host_ok}")
    if err2 or err3 or n_bad or not host_ok:
        raise AssertionError("K2/K3 disagree with their plain versions")
    report["window_sums"]["max_abs_err"] = err2
    report["fold_partials"]["max_abs_err"] = err3

    # K4 and K2t at B = 2 on the same points: K4 equal to its plain version;
    # K2t with head tables shared (TH = 1) and per batch (TH = B), the head
    # boundary at lane 130 inside a chunk, equal to its plain version and,
    # as points, to K2's window sums on the same points and digits.
    tbl = msm.multiples_tables(points)
    tbl_p = msm.build_tables_plain(points)
    n_head = 130
    head1 = tbl[:1, ..., :n_head].contiguous()
    r_tbl = tbl[..., n_head:].contiguous()
    k2t = msm.window_partials_tables(dig_p, head1, r_tbl)
    p2t = msm.window_partials_tables_plain(dig_p, head1, r_tbl)
    headB = tbl[..., :n_head].contiguous()
    k2tb = msm.window_partials_tables(dig_i, headB, r_tbl)
    sync()
    err4 = int((tbl.int() - tbl_p.int()).abs().max())
    err2t = max(int((k2t - p2t).abs().max()),
                int((k2tb - msm.window_partials_tables_plain(
                    dig_i, headB, r_tbl)).abs().max()))
    ws_t = msm.fold_partials(k2tb).cpu().numpy()
    n_bad_t = sum(limbs.unpack_point(ws_t[b, ..., w]) !=
                  limbs.unpack_point(ws_k[b, ..., w])
                  for b in range(B) for w in range(33))
    log(f"K4 build_tables vs plain (B={B}, N={N}): max |diff| = {err4}; "
        f"K2t window_sums_tables vs plain (TH = 1 and TH = B, {n_head} "
        f"head lanes): max |diff| = {err2t}; windows unequal to K2's as "
        f"points: {n_bad_t}/66")
    if err4 or err2t or n_bad_t:
        raise AssertionError("K4/K2t disagree with their plain versions "
                             "or with K2")
    report["build_tables"]["max_abs_err"] = err4
    report["window_sums_tables"]["max_abs_err"] = err2t

    # K4 at its limits against its plain version: one lane, an odd lane
    # count, and points whose limbs sit at |limb| = 8191.
    from ed25519_consensus_tpu_torch.ops import probes

    extreme = torch.from_numpy(np.stack([probes.extreme_points(96, s)
                                         for s in (1, 2)])).to(dev)
    limits = {"N = 1": points[..., :1], "N = 333": points[..., 1000:1333],
              "|limb| = 8191": extreme}
    for label, p in limits.items():
        p = p.contiguous()
        err = int((msm.multiples_tables(p).int()
                   - msm.build_tables_plain(p).int()).abs().max())
        sync()
        log(f"K4 build_tables vs plain at {label} (B={p.shape[0]}, "
            f"N={p.shape[-1]}): max |diff| = {err}")
        if err:
            raise AssertionError(f"K4 disagrees with its plain version at "
                                 f"{label}")


def zcash10k(rng):
    """The bench.py `zcash10k` deployment: 10,000 signatures over 64 keys
    (BASELINE.json config "Zcash block-sync replay"), as (vk, sig, msg)
    tuples."""
    from ed25519_consensus_tpu_torch import SigningKey

    keys = [SigningKey.new(rng) for _ in range(ZCASH_KEYS)]
    out = []
    for i in range(ZCASH_SIGS):
        sk = keys[i % ZCASH_KEYS]
        msg = b"zcash-tx-%d" % i
        out.append((sk.verification_key_bytes(), sk.sign(msg), msg))
    return out


def adversarial(rng):
    """The bench.py `adversarial` batch: the 196-case ZIP215 small-order
    x non-canonical matrix plus 196 random signatures."""
    from ed25519_consensus_tpu_torch import Signature, SigningKey, batch
    from ed25519_consensus_tpu_torch.ops import edwards
    from ed25519_consensus_tpu_torch.utils import fixtures

    bv = batch.Verifier()
    encs = [p.compress() for p in edwards.eight_torsion()]
    encs += fixtures.non_canonical_point_encodings()[:6]
    for A in encs:
        for R in encs:
            bv.queue((A, Signature(R, b"\x00" * 32), b"Zcash"))
    for i in range(196):
        sk = SigningKey.new(rng)
        msg = b"adv-%d" % i
        bv.queue((sk.verification_key_bytes(), sk.sign(msg), msg))
    return bv


def phase_main_path(report: dict, state: dict) -> None:
    """The main path, with the launch counts read around it."""
    import numpy as np

    from ed25519_consensus_tpu_torch import InvalidSignature, batch
    from ed25519_consensus_tpu_torch.ops import _cuda, msm

    rng = random.Random(0x5EED)
    t = time.perf_counter()
    entries = zcash10k(rng)
    bv = batch.Verifier()
    bv.queue_bulk(entries)
    bad = list(entries)
    vk, sig, _ = bad[len(bad) // 2]
    bad[len(bad) // 2] = (vk, sig, b"zcash-tx-tampered")
    tampered = batch.Verifier()
    tampered.queue_bulk(bad)
    adv = adversarial(rng)
    host_verdict = True
    try:
        adv.verify(rng=random.Random(3), backend="host")
    except InvalidSignature:
        host_verdict = False
    log(f"built zcash10k ({ZCASH_SIGS} sigs, {ZCASH_KEYS} keys), its "
        f"tampered copy and the adversarial batch (host verdict "
        f"{host_verdict}) in {time.perf_counter() - t:.1f} s")

    _cuda.reset_launch_counts()
    runs = []
    for i in range(2):
        timings = {}
        t = time.perf_counter()
        bv.verify_gpu(rng=random.Random(100 + i), timings=timings)
        runs.append((time.perf_counter() - t, timings))
    total, timings = runs[-1]
    log(f"zcash10k verify_gpu: accepted; end to end {total:.3f} s = "
        f"{ZCASH_SIGS / total:.0f} sigs/s (second run; first "
        f"{runs[0][0]:.3f} s); host staging {timings['stage_host']:.3f} s, "
        f"device {timings['device']:.3f} s, host combine "
        f"{timings['combine']:.3f} s")
    state["e2e"] = {"seconds": total, "sigs_per_s": ZCASH_SIGS / total,
                    **timings}
    try:
        tampered.verify_gpu(rng=random.Random(4))
    except InvalidSignature:
        log("tampered zcash10k verify_gpu: rejected (InvalidSignature)")
    else:
        raise AssertionError("tampered batch accepted")
    dev_verdict = True
    try:
        adv.verify_gpu(rng=random.Random(5))
    except InvalidSignature:
        dev_verdict = False
    log(f"adversarial batch ({adv.batch_size} sigs): device verdict "
        f"{dev_verdict}, host verdict {host_verdict}")
    if dev_verdict != host_verdict:
        raise AssertionError("adversarial device verdict != host verdict")

    t = time.perf_counter()
    ops = [bv._stage(random.Random(200 + b)).device_operands(
        lambda n: STACK_N) for b in range(STACK_B)]
    digits = np.stack([o[0] for o in ops])
    wire = np.stack([o[1] for o in ops])
    t_stage = time.perf_counter() - t
    t = time.perf_counter()
    ws = msm.dispatch_window_sums_many(digits, wire, DEV).cpu().numpy()
    t_dev = time.perf_counter() - t
    oks = [msm.combine_window_sums(ws[b:b + 1]).mul_by_cofactor()
           .is_identity() for b in range(STACK_B)]
    log(f"stacked dispatch_window_sums_many B={STACK_B}, N={STACK_N}: "
        f"accepts {oks}; staging {t_stage:.2f} s, device call "
        f"{t_dev:.3f} s")
    if not all(oks):
        raise AssertionError("a stacked zcash10k batch was rejected")
    counts = _cuda.launch_counts()
    log(f"single-batch path launches: "
        f"{ {k: v for k, v in counts.items() if v} }")
    add_launches(report, counts)
    need_launches("the single-batch path", counts, SLICE0_KERNELS)
    no_lab_forms("the single-batch path", counts)
    state["stack"] = (digits, wire)
    state["verifier"] = bv
    state["tampered"] = tampered
    state["adv"] = adv


# RFC 8032 section 7.1 TEST 1-3 (tests/test_torch_batch.py): (pk, sig, msg)
# hex.
RFC8032 = [
    ("d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8821"
     "590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b", ""),
    ("3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da085ac1e"
     "43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00", "72"),
    ("fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac18ff9b5"
     "38d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a", "af82"),
]


def host_single_verdict(entry) -> bool:
    """The host's ZIP215 verdict on one (vk, sig, msg) entry of bytes."""
    from ed25519_consensus_tpu_torch import Signature, VerificationKey

    vk, sig, msg = entry
    try:
        VerificationKey.from_bytes(vk).verify(Signature.from_bytes(sig), msg)
    except Exception:  # noqa: BLE001 - any refusal is a False verdict
        return False
    return True


def phase_vectors(report: dict) -> None:
    """The RFC 8032 vectors (and each with its message tampered) and the
    256 cases of the legacy corpus (tests/data/legacy_oracle_corpus.json:
    the ZIP215 matrix, non-canonical and small-order keys, random valid
    and invalid signatures), one signature a batch (as
    batch.verify_single_many builds them), through verify_many on the card,
    device only and per batch, with the launch counts set to 0 just before
    it and read just after: every verdict equals the host's ZIP215
    verdict (the CPU tests hold the host rules against the JAX
    package's).  A batch whose bytes do not stage is False on the host
    rules before any device call."""
    from ed25519_consensus_tpu_torch import Signature, batch
    from ed25519_consensus_tpu_torch.ops import _cuda
    from ed25519_consensus_tpu_torch.verification_key import \
        VerificationKeyBytes

    entries = []
    for pk, sig, msg in RFC8032:
        m = bytes.fromhex(msg)
        entries.append((bytes.fromhex(pk), bytes.fromhex(sig), m))
        entries.append((bytes.fromhex(pk), bytes.fromhex(sig),
                        m + b"tampered"))
    corpus = json.loads((ROOT / "tests" / "data" /
                         "legacy_oracle_corpus.json").read_text())
    entries += [(bytes.fromhex(c["vk"]), bytes.fromhex(c["sig"]),
                 bytes.fromhex(c["msg"])) for c in corpus["cases"]]
    host = [host_single_verdict(e) for e in entries]
    verifiers = []
    for vk, sig, msg in entries:
        v = batch.Verifier()
        try:
            v.queue((VerificationKeyBytes(vk), Signature.from_bytes(sig),
                     msg))
        except Exception:  # noqa: BLE001 - malformed bytes: verdict False
            v.batch_size = 1
            v.invalidate("malformed wire bytes")
        verifiers.append(v)
    batch.reset_device_health()
    _cuda.reset_launch_counts()
    got = batch.verify_many(verifiers, rng=random.Random(17),
                            merge="never", hybrid=False, mesh=0,
                            device=DEV)
    counts = _cuda.launch_counts()
    add_launches(report, counts)
    st = batch.last_run_stats
    log(f"RFC 8032 vectors (3 + 3 tampered) and the legacy corpus "
        f"({len(corpus['cases'])} cases), one signature a batch, through "
        f"verify_many (merge=never, hybrid=False): "
        f"{sum(got)} accepted, {len(got) - sum(got)} rejected, equal to "
        f"the host: {got == host}; device batches "
        f"{st.get('device_batches')}, rejects confirmed "
        f"{st.get('device_rejects_confirmed')}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    if got != host:
        bad = [i for i, (a, b) in enumerate(zip(got, host)) if a != b]
        raise AssertionError(f"per-signature device verdicts differ from "
                             f"the host at {bad}")
    need_launches("the vectors", counts, SLICE0_KERNELS)
    no_lab_forms("the vectors", counts)


SERVICE_KERNELS = ("expand_compressed", "window_sums", "fold_partials",
                   "build_tables", "window_sums_tables")
RPC_SUBMISSIONS = 256


def pct(xs, q: float) -> float:
    """The q-quantile of xs by the nearest rank (xs non-empty)."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, int(round(q * len(xs))) - 1))]


def rpc_batches(n: int):
    """`n` seeded rpc submissions of 1-4 fresh signatures (fresh keys and
    messages), a quarter with one tampered → [(entries, host truth)]."""
    from ed25519_consensus_tpu_torch import SigningKey

    rng = random.Random(0x59C)
    out = []
    for i in range(n):
        k = rng.randint(1, 4)
        bad_at = rng.randrange(k) if rng.random() < 0.25 else -1
        ents = []
        for j in range(k):
            sk = SigningKey.new(rng)
            msg = b"rpc/%d/%d" % (i, j)
            sig = sk.sign(msg)
            ents.append((sk.verification_key_bytes(), sig,
                         msg + b"!" if j == bad_at else msg))
        out.append((ents, bad_at < 0))
    return out


LEG_SUMS = ("device_batches", "device_unions", "host_batches",
            "host_unions", "device_rejects_confirmed",
            "device_rejects_overturned", "stage_seconds", "device_seconds",
            "combine_seconds", "host_seconds", "seconds")


def service_leg(label: str, subs, merge: str = "auto") -> dict:
    """One leg on a service of its own: a VerifyService(device="cuda:0",
    mesh=0, hybrid=False) — device only, so every verdict of a device
    wave is the kernels' or a device reject re-decided on the host — on
    the real clock with default capacity and watermarks, over the
    process-default device operand cache and verdict memo the legs share.
    `subs` — (verifier, class, tenant, host truth) — go in as fast as the
    front door admits them, with the launch counts set to 0 just before;
    after every ticket resolved, close(drain=True) joins the dispatcher
    (the last wave's memo stores included) and the counts are read.
    Every verdict must equal the host truth, consensus class shed nothing,
    the breaker stay closed and no wave crash or fail on the device.
    Logs the per-class submit→resolve p50/p99 (VerifyTicket.resolved_at),
    the rate and the service's totals → the leg's record."""
    from ed25519_consensus_tpu_torch import service, tenancy
    from ed25519_consensus_tpu_torch.ops import _cuda

    svc = service.VerifyService(
        device="cuda:0" if DEV == "cuda" else DEV, mesh=0, hybrid=False,
        merge=merge)
    log(f"  {label}: VerifyService(device={svc.device}, mesh=0, "
        f"hybrid=False, merge={merge}), capacity {svc.capacity_sigs} sigs, "
        f"watermarks "
        f"{ {c: p.shed_watermark for c, p in svc.class_policies.items()} }")
    tickets, overloaded = [], {}
    try:
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        for v, cls, tenant, want in subs:
            sigs = v.batch_size
            t = time.perf_counter()
            try:
                ticket = svc.submit(v, cls=cls, tenant=tenant)
            except service.Overloaded:
                overloaded[cls] = overloaded.get(cls, 0) + 1
                continue
            tickets.append((ticket, t, cls, sigs, want))
        bad = [i for i, (ticket, _t, _c, _s, want) in enumerate(tickets)
               if ticket.result(timeout=600) != want]
    finally:
        svc.close(drain=True)
    counts = _cuda.launch_counts()
    dt = max(ticket.resolved_at for ticket, *_r in tickets) - t0
    if bad:
        raise AssertionError(f"{label}: verdicts differ from the host at "
                             f"tickets {bad[:10]}")
    st = svc.stats()
    totals = {k: st[k] for k in (
        "submitted", "resolved", "rejected_overloaded", "shed_deadline",
        "waves", "host_waves", "device_waves", "probe_waves",
        "crash_fallbacks", "device_error_waves", "dedup_fanout",
        "verdict_cache_hits", "verdict_cache_stores",
        "devcache_hot_waves", "devcache_dispatch_hits")}
    cons = st["by_class"][tenancy.CLASS_CONSENSUS]
    if cons["rejected_overloaded"] or cons["shed_deadline"]:
        raise AssertionError(f"{label}: consensus class shed: {cons}")
    if svc.breaker.transitions:
        raise AssertionError(f"{label}: the breaker left closed: "
                             f"{svc.breaker.transitions}")
    if st["crash_fallbacks"] or st["device_error_waves"]:
        raise AssertionError(f"{label}: crash fallbacks "
                             f"{st['crash_fallbacks']}, device-error waves "
                             f"{st['device_error_waves']}")
    if st["submitted"] != (st["resolved"] + st["rejected_overloaded"]
                           + st["shed_deadline"]):
        raise AssertionError(f"{label}: tickets lost: {st}")
    waves = [w for route, w in svc.wave_stats if route == "device"]
    if len(svc.wave_stats) != st["host_waves"] + st["device_waves"]:
        raise AssertionError(f"{label}: {len(svc.wave_stats)} wave stats "
                             f"for {st['host_waves'] + st['device_waves']} "
                             f"routed groups")
    dev = {k: sum(w.get(k, 0) for w in waves) for k in LEG_SUMS}
    dev["table_dispatch_hits"] = sum(
        (w.get("devcache") or {}).get("table_dispatch_hits", 0)
        for w in waves)
    lat = {}
    for ticket, t, cls, _s, _w in tickets:
        lat.setdefault(cls, []).append((ticket.resolved_at - t) * 1e3)
    sigs = sum(s for _t, _t0, _c, s, _w in tickets)
    log(f"  {label}: {len(tickets)} tickets ({sigs} sigs) resolved in "
        f"{dt:.3f} s = {sigs / dt:.0f} sigs/s; overloaded {overloaded}; "
        f"{smi_line()}")
    for cls in sorted(lat, key=tenancy.class_rank):
        xs = lat[cls]
        log(f"    {cls}: {len(xs)} tickets, submit→resolve p50 "
            f"{pct(xs, 0.50):.3f} ms, p99 {pct(xs, 0.99):.3f} ms")
    log(f"    totals {totals}; device waves' verify_many {dev}; "
        f"launches { {k: v for k, v in counts.items() if v} }")
    return {"seconds": dt, "sigs": sigs, "totals": totals,
            "by_class": st["by_class"], "launches": counts,
            "verify_many": dev, "overloaded": overloaded,
            "latency_ms": {c: {"p50": pct(x, 0.5), "p99": pct(x, 0.99)}
                           for c, x in lat.items()}}


def device_decided(label: str, leg: dict) -> None:
    """Fails unless the leg's device waves decided verdicts on the card
    (device batches or unions > 0) and the host decided nothing in them
    but the device's rejects (which it re-decides by design)."""
    d = leg["verify_many"]
    host = d["host_batches"] + d["host_unions"]
    rejects = d["device_rejects_confirmed"] + d["device_rejects_overturned"]
    if not d["device_batches"] + d["device_unions"] or host != rejects:
        raise AssertionError(f"{label}: the device decided "
                             f"{d['device_batches']} batches and "
                             f"{d['device_unions']} unions; the host "
                             f"{host}, of which {rejects} device rejects")


def phase_service(report: dict, state: dict) -> None:
    """The front door at full width (service_leg: a VerifyService(device=
    "cuda:0", mesh=0, hybrid=False) for each leg, default capacity and
    watermarks, on the process default device operand cache and verdict
    memo) and the cometbft128 stream of phase_stream (256 heights x 128
    validators, height 77 tampered) in three legs:

    * A, mempool admission: each commit a mempool-class submission under
      tenant cometbft, the zcash10k block one consensus-class submission
      under tenant zcash, and 256 seeded rpc submissions of 1-4 fresh
      signatures (a quarter tampered) interleaved;
    * B, block inclusion: the same commits as consensus class — every one
      must resolve from the memo at submit, with no re-hash mismatch and
      no kernel launch;
    * C, vote replay after a validator-set rotation: rotate_tenant
      ("cometbft") on the device operand cache and the memo, then the
      commits a third time, verified on the device again (0 memo hits).

    Gates: service_leg's in every leg, the device deciding legs A and C
    (device_decided), device waves > 0, K1 K2 K3 K4 and K2t launched on
    the service path and no lab form.  If leg C's waves never reach the
    resident-tables dispatch it runs again, after another rotation, with
    merge="never" (the per-commit form of phase_stream)."""
    from ed25519_consensus_tpu_torch import (batch, devcache, service,
                                             tenancy, verdictcache)

    heights, bad_h = state["comet_heights"]
    comet_truth = [h != bad_h for h in range(COMET_HEIGHTS)]
    rpc = rpc_batches(RPC_SUBMISSIONS)
    for ents, want in rpc[:16]:
        if batch._host_verdict(verifiers([ents])[0],
                               random.Random(5)) != want:
            raise AssertionError("rpc host truth differs from its "
                                 "construction")

    def commits(cls):
        return [(v, cls, "cometbft", want) for v, want in
                zip(verifiers(heights), comet_truth)]

    def rotate():
        devcache.default_cache().rotate_tenant("cometbft", "smoke")
        verdictcache.default_cache().rotate_tenant("cometbft", "smoke")

    devcache.set_default_cache(devcache.DeviceOperandCache(enabled=True))
    verdictcache.set_default_cache(None)
    batch.reset_device_health()
    legs = {}
    totals = dict.fromkeys(state["stream_launches"], 0)
    leg_a = []
    for h, (v, cls, tenant, want) in enumerate(
            commits(tenancy.CLASS_MEMPOOL)):
        leg_a.append((v, cls, tenant, want))
        ents, rwant = rpc[h]
        leg_a.append((verifiers([ents])[0], tenancy.CLASS_RPC, None, rwant))
        if h == COMET_HEIGHTS // 2:
            leg_a.append((state["verifier"].clone(),
                          tenancy.CLASS_CONSENSUS, "zcash", True))
    legs["A"] = service_leg(
        f"leg A, mempool admission ({COMET_HEIGHTS} commits, zcash10k, "
        f"{RPC_SUBMISSIONS} rpc)", leg_a)
    legs["B"] = service_leg(
        f"leg B, block inclusion (the {COMET_HEIGHTS} commits, consensus)",
        commits(tenancy.CLASS_CONSENSUS))
    rotate()
    legs["C"] = service_leg(
        "leg C, vote replay after rotate_tenant(cometbft)",
        commits(tenancy.CLASS_CONSENSUS))
    if not (legs["C"]["launches"]["build_tables"]
            and legs["C"]["launches"]["window_sums_tables"]):
        log("  leg C never reached the resident-tables dispatch with the "
            "default wave shaping: again, after another rotation, with "
            "merge=never")
        rotate()
        legs["C-never"] = service_leg(
            "leg C, merge=never", commits(tenancy.CLASS_CONSENSUS),
            merge="never")
    vc = verdictcache.default_cache().stats()
    log(f"  verdict memo: {vc}")
    b = legs["B"]
    if b["totals"]["verdict_cache_hits"] != COMET_HEIGHTS \
            or vc["rehash_mismatch"] or any(b["launches"].values()):
        raise AssertionError(f"leg B: {b['totals']['verdict_cache_hits']} "
                             f"memo hits of {COMET_HEIGHTS}, "
                             f"{vc['rehash_mismatch']} re-hash mismatches, "
                             f"launches {b['launches']}")
    for name in [n for n in legs if n.startswith("C")]:
        if legs[name]["totals"]["verdict_cache_hits"]:
            raise AssertionError(f"leg {name} hit the memo after the "
                                 f"rotation")
    for name in legs:
        if name != "B":
            device_decided(f"leg {name}", legs[name])
    if not sum(leg["totals"]["device_waves"] for leg in legs.values()):
        raise AssertionError("no device wave")
    for leg in legs.values():
        for k, v in leg["launches"].items():
            totals[k] += v
    need_launches("the service path", totals, SERVICE_KERNELS)
    no_lab_forms("the service path", totals)
    state["service_launches"] = totals
    devcache.set_default_cache(None)
    verdictcache.set_default_cache(None)


def phase_soak(state: dict) -> None:
    """The port's overload soak (tools/load_soak.py) at its defaults on
    the card — four rounds of three submitters against a 48-signature
    VerifyService, seeded traffic classes and deadlines, and the "mixed"
    storm (errors, stalls, corrupted sums at the lane): nothing lost,
    every verdict host-identical."""
    from ed25519_consensus_tpu_torch.tools import load_soak

    summary = load_soak.soak(load_soak.parse_args(["--storm", "mixed"]))
    log(f"  load_soak --storm mixed: {json.dumps(summary)}")
    if not summary["ok"]:
        raise AssertionError("load_soak --storm mixed: a request was "
                             "lost or a verdict differs from the host")
    state["soak"] = summary


SOAK_KERNELS = ("expand_compressed", "window_sums", "fold_partials",
                "build_tables", "window_sums_tables")


def hold_recorded_cold(label: str, calls) -> None:
    """Every cold dispatch (K1, K2, K3) a path made held, on the card,
    against the plain chain on the same operands, exactly; a difference
    fails the run naming the chunk and its batches."""
    import torch

    from ed25519_consensus_tpu_torch.ops import msm
    from ed25519_consensus_tpu_torch.ops import torch_decompress as TD

    bad = []
    for c, ((digits, wire, *_), out) in enumerate(calls):
        d = msm.as_tensor(digits, DEV)
        w = msm.as_tensor(wire, DEV)
        want = msm.fold_partials_plain(msm.window_partials_plain(
            d, TD.expand_compressed_points_plain(w)))
        if not torch.equal(out, want):
            rows = [b for b in range(out.shape[0])
                    if not torch.equal(out[b], want[b])]
            log(f"  {label} cold chunk {c}: batches {rows} differ from the "
                f"plain versions")
            bad.append(c)
    log(f"  {label}: {len(calls) - len(bad)}/{len(calls)} cold dispatches "
        f"equal their plain versions (K1, K2, K3; exact)")
    if bad:
        raise AssertionError(f"{label}: device window sums differ from the "
                             f"plain versions in cold chunks {bad}")


def phase_verdict_soaks(state: dict) -> None:
    """The verdict soaks on the card, through verify_many(hybrid=False,
    merge="never") on cuda:0:

    * tools/device_soak.py at three passes over its pool (24 batches of
      20-400 signatures over 48 keys, torsion entries, half the batches
      tampered), one batch a chunk: cold, built, then from resident tables
      (ROADMAP §C's resident-keyset rounds).  Every verdict equals the
      host's; every tables dispatch is held against the plain versions
      (hold_recorded_tables) and at least one is required; a device reject
      the host overturned fails the phase, with the cold dispatches held
      too, so the chunk is named.
    * tools/chaos_soak.py at its defaults for 8 rounds (randomized_plan:
      errors, stalls, corrupted sums): no wrong verdict, rounds that raised
      DeviceError counted, and at least one faulted round that finished
      with verdicts (the port's gate).
    * one chaos round with a flapping link (--flap 2) over 24 batches, so
      the round reaches the flap's first down window (call 2): it must
      raise DeviceError, with no wrong verdict.

    Launches are counted from just before each soak to just after it (the
    holds come after)."""
    from ed25519_consensus_tpu_torch import devcache
    from ed25519_consensus_tpu_torch.ops import _cuda
    from ed25519_consensus_tpu_torch.tools import chaos_soak, device_soak

    dev = "cuda:0" if DEV == "cuda" else DEV
    totals = dict.fromkeys(_cuda.KERNELS, 0)

    def add(counts):
        for k, v in counts.items():
            totals[k] += v

    devcache.set_default_cache(devcache.DeviceOperandCache(enabled=True))
    _cuda.reset_launch_counts()
    with record_calls("dispatch_window_sums_many_tables") as tab, \
            record_calls("dispatch_window_sums_many") as cold:
        ds = device_soak.run(passes=3, device=dev,
                             log=lambda m: log("  device_soak " + m))
    counts = _cuda.launch_counts()
    add(counts)
    log(f"  device_soak: {ds['batches']} batches, {ds['sigs']} sigs a pass, "
        f"chunk {ds['chunk']}; "
        f"{[round(ds['sigs'] / p['seconds']) for p in ds['passes']]} sigs/s "
        f"a pass; table dispatches {ds['table_dispatch_hits']}; rejects "
        f"confirmed {[p['rejects_confirmed'] for p in ds['passes']]}, "
        f"overturned {[p['rejects_overturned'] for p in ds['passes']]}; "
        f"launches { {k: v for k, v in counts.items() if v} }; "
        f"{smi_line()}")
    if not ds["ok"]:
        raise AssertionError(f"device_soak: verdicts differ from the host "
                             f"at (pass, batch) {ds['wrong']}")
    if not tab.calls or ds["table_dispatch_hits"] <= 0:
        raise AssertionError("device_soak: no dispatch from resident tables")
    hold_recorded_tables("device_soak", tab.calls)
    if ds["rejects_overturned"]:
        hold_recorded_cold("device_soak", cold.calls)
        raise AssertionError(
            f"device_soak: the host overturned {ds['rejects_overturned']} "
            f"device rejects (per pass "
            f"{[p['rejects_overturned'] for p in ds['passes']]}; one batch "
            f"a chunk, so the chunk is the batch): ROADMAP §C's fault")
    devcache.set_default_cache(None)

    chaos = {}
    for label, argv in (("8 rounds", ["--rounds", "8"]),
                        ("flap 2", ["--rounds", "1", "--flap", "2",
                                    "--batches", "24"])):
        _cuda.reset_launch_counts()
        summary = chaos_soak.soak(
            chaos_soak.parse_args(argv + ["--device", dev]),
            log=lambda m: log("  chaos_soak " + m))
        counts = _cuda.launch_counts()
        add(counts)
        chaos[label] = summary
        log(f"  chaos_soak {label}: "
            f"{ {k: v for k, v in summary.items() if k != 'fault_counters'} }"
            f"; launches { {k: v for k, v in counts.items() if v} }")
        if summary["wrong_rounds"]:
            raise AssertionError(f"chaos_soak {label}: a round passed with "
                                 f"a wrong verdict")
    if not chaos["8 rounds"]["ok"]:
        raise AssertionError("chaos_soak: no round with an injected fault "
                             "finished with verdicts")
    flap = chaos["flap 2"]
    if flap["rounds_raised"] != 1 or not flap["fault_kinds"].get(
            "FlappingLink"):
        raise AssertionError(f"chaos_soak --flap 2: the flap did not fire "
                             f"and raise: {flap}")
    need_launches("the verdict soaks", totals, SOAK_KERNELS)
    no_lab_forms("the verdict soaks", totals)
    state["verdict_soaks_launches"] = totals
    state["verdict_soaks"] = {"device_soak": ds, "chaos": chaos}


def phase_restart(state: dict) -> None:
    """The durable verdict state on the card, at the front door's size: the
    cometbft128 stream (256 commits x 128 signatures, height 77 tampered)
    as consensus class through a VerifyService(device="cuda:0", mesh=0,
    hybrid=False, persist_dir=<tmp>) on a fresh verdict memo and device
    operand cache, driven by process_once.  Life 1 journals 256 records
    and is abandoned (no close, no flush: a hard kill).  Life 2 is a fresh
    service, memo and devcache on the same directory: it must absorb all
    256 records and serve every commit from the memo at submit — 256
    hits, 0 waves, 0 launches.  Then the two lives again under
    faults.persist_plan("bitrot") on life 1's appends: life 2's load
    report must drop a record, the dropped commits are verified on the
    card again (K1-K3), and every verdict of every life equals the
    host's."""
    import tempfile

    from ed25519_consensus_tpu_torch import (devcache, faults, service,
                                             tenancy, verdictcache)
    from ed25519_consensus_tpu_torch.ops import _cuda

    heights, bad_h = state["comet_heights"]
    truth = [h != bad_h for h in range(COMET_HEIGHTS)]
    dev = "cuda:0" if DEV == "cuda" else DEV
    totals = dict.fromkeys(_cuda.KERNELS, 0)

    def life(label, pdir, plan=None):
        devcache.set_default_cache(devcache.DeviceOperandCache(enabled=True))
        vc = verdictcache.VerdictCache()
        svc = service.VerifyService(device=dev, mesh=0, hybrid=False,
                                    persist_dir=pdir, verdict_cache=vc,
                                    auto_start=False)
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        if plan is not None:
            faults.install(plan)
        try:
            tickets = [svc.submit(v, cls=tenancy.CLASS_CONSENSUS,
                                  tenant="cometbft")
                       for v in verifiers(heights)]
            at_submit = sum(t.done() for t in tickets)
            while svc.process_once():
                pass
        finally:
            if plan is not None:
                faults.uninstall()
        got = [t.result(0) for t in tickets]
        dt = time.perf_counter() - t0
        counts = _cuda.launch_counts()
        for k, v in counts.items():
            totals[k] += v
        st = svc.stats()
        journal = vc.journal()
        rep = journal.last_load_report
        rec = {"seconds": dt, "sigs_per_s": COMET_HEIGHTS * COMET_KEYS / dt,
               "resolved_at_submit": at_submit,
               "hits": st["verdict_cache_hits"], "waves": st["waves"],
               "device_waves": st["device_waves"],
               "device_error_waves": st["device_error_waves"],
               "appends": journal.counters["appends"],
               "journal_bytes": os.path.getsize(journal.path),
               "absorbed": rep["absorbed"], "dropped": {
                   k: v for k, v in rep["dropped"].items() if v},
               "file_dropped": rep["file_dropped"],
               "launches": {k: v for k, v in counts.items() if v}}
        log(f"  {label}: {rec}")
        rec["counts"] = counts
        if got != truth:
            bad = [h for h, (g, w) in enumerate(zip(got, truth)) if g != w]
            raise AssertionError(f"{label}: verdicts differ from the host at "
                                 f"heights {bad}")
        return rec

    runs = {}
    for kind in ("clean", "bitrot"):
        with tempfile.TemporaryDirectory(prefix="chip-smoke-journal-") as d:
            plan = None if kind == "clean" else faults.persist_plan(
                0x5EED, "bitrot")
            one = life(f"{kind}, life 1", d, plan)
            # The hard kill: life 1's service was dropped unclosed.
            two = life(f"{kind}, life 2 (revived)", d)
        runs[kind] = (one, two)
        if one["appends"] != COMET_HEIGHTS or one["device_error_waves"]:
            raise AssertionError(f"{kind}: life 1 appended "
                                 f"{one['appends']} records of "
                                 f"{COMET_HEIGHTS}")
        need_launches(f"{kind} life 1", one["counts"], SOAK_KERNELS[:3])
    one, two = runs["clean"]
    if (two["absorbed"] != COMET_HEIGHTS or two["hits"] != COMET_HEIGHTS
            or two["resolved_at_submit"] != COMET_HEIGHTS or two["waves"]
            or two["launches"]):
        raise AssertionError(f"the revived service did not serve every "
                             f"commit from the journal: {two}")
    _one, rot = runs["bitrot"]
    dropped = COMET_HEIGHTS - rot["absorbed"]
    if not dropped or not rot["dropped"] or rot["hits"] != rot["absorbed"] \
            or not rot["device_waves"]:
        raise AssertionError(f"bitrot: the load report dropped nothing or "
                             f"the dropped commits were not re-verified on "
                             f"the device: {rot}")
    need_launches("bitrot life 2", rot["counts"], SOAK_KERNELS[:3])
    no_lab_forms("the restart path", totals)
    state["restart_launches"] = totals
    state["restart"] = runs
    devcache.set_default_cache(None)
    verdictcache.set_default_cache(None)


# The gray-failure phase: the labs' sizes (the JAX tools' defaults; a CPU
# rehearsal shrinks them), the hedge leg's per-commit deadline and gray
# flap, and the probation leg's corrupting chip and mesh width.
GRAY_LAB_DEVICES = 8
GRAY_LAB_MIN_SAMPLES = 4
GRAY_DEADLINE_S = 0.5
GRAY_SLOW_S, GRAY_FLAP_PERIOD = 0.25, 8
GRAY_MESH, GRAY_CHIP = 4, 3
GRAY_KERNELS = ("expand_compressed", "window_sums", "fold_partials",
                "fold_shards")


def gray_labs(dev: str, add) -> dict:
    """Part (a) of phase_gray: tools/straggler_lab.py, tools/sentinel_soak.py
    and tools/load_soak.py --storm slowchip on `dev`, each gate a failure
    of the run."""
    from ed25519_consensus_tpu_torch.ops import _cuda
    from ed25519_consensus_tpu_torch.tools import (load_soak, sentinel_soak,
                                                   straggler_lab)

    out = {}
    # The tools' chips 5 and 3, inside a narrower rehearsal mesh.
    chip = str(min(5, GRAY_LAB_DEVICES - 1))
    for label, run, argv in (
            ("straggler_lab", lambda a: straggler_lab.lab(
                straggler_lab.parse_args(a)),
             ["--devices", str(GRAY_LAB_DEVICES), "--chip", chip,
              "--min-samples", str(GRAY_LAB_MIN_SAMPLES)]),
            ("sentinel_soak", lambda a: sentinel_soak.soak(
                sentinel_soak.parse_args(a)),
             ["--devices", str(GRAY_LAB_DEVICES), "--chip", chip,
              "--transient-chip", str(min(3, GRAY_LAB_DEVICES - 1))]),
            ("load_soak slowchip", lambda a: load_soak.soak(
                load_soak.parse_args(a)), ["--storm", "slowchip"])):
        _cuda.reset_launch_counts()
        t = time.perf_counter()
        summary = run(argv + ["--device", dev])
        dt = time.perf_counter() - t
        counts = _cuda.launch_counts()
        add(counts)
        if label == "straggler_lab":
            brief = straggler_lab.headline(summary)
        elif label == "sentinel_soak":
            brief = sentinel_soak.headline(summary)
        else:
            brief = {k: summary[k] for k in (
                "ok", "verdicts", "overloaded", "deadline", "injected",
                "device_error", "crash")}
        log(f"  {label}: {dt:.1f} s; {json.dumps(brief)}; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        if not summary["ok"]:
            raise AssertionError(f"{label}: a gate failed: "
                                 f"{json.dumps(summary)[:2000]}")
        out[label] = summary
    return out


def gray_hedge_pass(label: str, vs, truth, dev: str, plan=None,
                    cold: bool = False) -> dict:
    """One pass of the cometbft128 stream, one verify_many call a commit
    (hybrid, merge="never", the single lane on `dev`, a deadline
    GRAY_DEADLINE_S ahead), under `plan` when given.  `cold` empties the
    latency ledger before every call, so each call races its chunk on
    the host at once: the scheduling the hedge gate replaced."""
    from ed25519_consensus_tpu_torch import batch, faults, health

    keys = ("hedges_fired", "hedges_won", "hedges_lost",
            "straggler_suspicion_events", "device_batches", "host_batches",
            "device_rejects_confirmed", "device_rejects_overturned")
    agg = dict.fromkeys(keys, 0)
    lat, got = [], []
    rng = random.Random(len(label))
    if plan is not None:
        faults.install(plan)
    t0 = time.perf_counter()
    try:
        for v in vs:
            if cold:
                health.chip_registry().latency.reset()
            t = time.perf_counter()
            got.extend(batch.verify_many(
                [v], rng=rng, hybrid=True, merge="never", mesh=0,
                device=dev, deadline=time.monotonic() + GRAY_DEADLINE_S))
            lat.append(time.perf_counter() - t)
            for k in keys:
                agg[k] += batch.last_run_stats.get(k, 0)
    finally:
        if plan is not None:
            faults.uninstall()
    dt = time.perf_counter() - t0
    rec = {"commits": len(vs), "verdicts": len(got),
           "p50_ms": 1e3 * pct(lat, 0.5), "p99_ms": 1e3 * pct(lat, 0.99),
           "max_ms": 1e3 * max(lat),
           "sigs_per_s": len(vs) * COMET_KEYS / dt, **agg}
    if plan is not None:
        rec["injected"] = len(plan.injection_log())
    log(f"  {label}: {json.dumps(rec)}")
    if len(got) != len(vs):
        raise AssertionError(f"{label}: {len(vs) - len(got)} commits lost")
    if got != truth:
        bad = [h for h, (g, w) in enumerate(zip(got, truth)) if g != w]
        raise AssertionError(f"{label}: verdicts differ from the host at "
                             f"heights {bad}")
    return rec


def gray_probation_leg(state: dict, dev: str) -> dict:
    """Part (c) of phase_gray: pod100k x MESH_DEPTH through verify_many on
    a GRAY_MESH-chip mesh of logical chips on `dev`, forced-device, every
    chunk audited, with chip GRAY_CHIP corrupting its partial sums on
    every call and a FakeClock on the chip registry and the lane."""
    from ed25519_consensus_tpu_torch import (batch, config, devcache, faults,
                                             health)
    from ed25519_consensus_tpu_torch.error import DeviceError
    from ed25519_consensus_tpu_torch.tools import sentinel_soak

    batch.reset_device_health()
    clock = health.FakeClock()
    reg = health.chip_registry()
    reg.set_clock(clock)
    hp = health.DeviceHealth(mesh=GRAY_MESH, clock=clock)
    devcache.set_default_cache(devcache.DeviceOperandCache(enabled=False))
    base, bad = state["pod100k"], state["pod100k_bad"]
    bad_at = min(2, MESH_DEPTH - 1)
    truth = [i != bad_at for i in range(MESH_DEPTH)]
    ids = tuple(range(GRAY_MESH))
    passes = []

    def one_pass(label):
        vs = [bad.clone() if i == bad_at else base.clone()
              for i in range(MESH_DEPTH)]
        t = time.perf_counter()
        try:
            got = batch.verify_many(
                vs, rng=random.Random(len(passes)), chunk=MESH_DEPTH,
                hybrid=False, merge="never", mesh=GRAY_MESH, device=dev,
                health=hp, sentinel_rate=1.0, device_ids=ids)
            err = None
        except DeviceError as e:
            got, err = None, e
        st = dict(batch.last_run_stats)
        rec = {"pass": label, "seconds": time.perf_counter() - t,
               "raised": err is not None, "mesh": st["mesh"],
               "device_ids": st["device_ids"],
               "reformations": st["mesh_reformations"],
               "sentinel": st["sentinel"],
               "device_batches": st["device_batches"],
               "rejects_confirmed": st["device_rejects_confirmed"],
               "state": reg.chip_state(GRAY_CHIP)}
        log(f"  probation leg, {label}: {json.dumps(rec)}")
        if got is not None and got != truth:
            raise AssertionError(f"probation leg {label}: verdicts {got} "
                                 f"differ from the host's {truth}")
        passes.append(rec)
        return rec

    bound = sentinel_soak.waves_to_quarantine()
    plan = faults.sentinel_plan(0x6A7, "corrupt-chip", chip=GRAY_CHIP,
                                on=lambda i: True)
    with faults.injected(plan):
        for w in range(bound):
            rec = one_pass(f"corrupting wave {w}")
            if not rec["raised"] or rec["sentinel"]["attributed"] != \
                    [GRAY_CHIP]:
                raise AssertionError(f"probation leg: an audited pass "
                                     f"did not raise naming chip "
                                     f"{GRAY_CHIP}: {rec}")
            if rec["state"] == health.STATE_QUARANTINED:
                break
        if reg.chip_state(GRAY_CHIP) != health.STATE_QUARANTINED:
            raise AssertionError(f"chip {GRAY_CHIP} not quarantined within "
                                 f"{bound} waves")
        waves = len(passes)
        rec = one_pass("reformed")
        if rec["raised"] or rec["mesh"] != GRAY_MESH // 2 or \
                rec["device_batches"] != MESH_DEPTH - 1 or \
                rec["sentinel"]["divergence"]:
            raise AssertionError(f"probation leg: the pass after the "
                                 f"quarantine did not run at D = "
                                 f"{GRAY_MESH // 2} on the device: {rec}")
    clock.advance(6 * config.get("ED25519_TPU_SUSPICION_HALF_LIFE"))
    if reg.chip_state(GRAY_CHIP) != health.STATE_PROBATION:
        raise AssertionError("the quarantine did not relax to probation")
    probes = []
    for p in range(config.get("ED25519_TPU_PROBATION_PROBES")):
        t = time.perf_counter()
        ok = batch.run_probation_probe(state["verifier"].clone(), GRAY_CHIP,
                                       rng=random.Random(900 + p),
                                       device=dev)
        probes.append({"passed": ok, "seconds": time.perf_counter() - t})
    log(f"  probation probes (zcash10k on chip {GRAY_CHIP}): {probes}; "
        f"state {reg.chip_state(GRAY_CHIP)}")
    if not all(p["passed"] for p in probes) or reg.excluded_chips():
        raise AssertionError(f"chip {GRAY_CHIP} did not rejoin: {probes}")
    rec = one_pass("rejoined")
    if rec["raised"] or rec["mesh"] != GRAY_MESH or rec["reformations"] \
            or rec["device_batches"] != MESH_DEPTH - 1:
        raise AssertionError(f"probation leg: the rejoined pass was not a "
                             f"full-width device pass: {rec}")
    devcache.set_default_cache(None)
    batch.reset_device_health()
    return {"quarantine_wave": waves - 1, "wave_bound": bound,
            "passes": passes, "probes": probes}


def phase_gray(state: dict) -> None:
    """The gray-failure half of the scheduler on the card:

    (a) tools/straggler_lab.py (8 logical chips, all three phases),
        tools/sentinel_soak.py (the 8-mesh, both phases) and
        tools/load_soak.py --storm slowchip, at the JAX tools' defaults,
        every chip on cuda:0; each gate fails the run.
    (b) The hedge leg: the cometbft128 stream one commit a call through
        verify_many(hybrid=True, merge="never", mesh=0, deadline=now +
        GRAY_DEADLINE_S) on cuda:0 on the real clock — a clean pass, whose
        calls arm the latency ledger, then the same stream with chip 0
        flapping GRAY_SLOW_S late every other GRAY_FLAP_PERIOD calls
        (faults.slow_plan kind "flap": SlowChip sleeps); then both again
        on a ledger emptied before every call, which races each commit on
        the host at once, for comparison.  Per pass: the
        per-commit p50/p99, sigs/s, hedges fired/won/lost, straggler
        accruals and device-decided batches.  Fails unless every verdict
        is the host's, no commit is lost, and the slow pass wins a hedge.
    (c) The probation leg (gray_probation_leg): pod100k on a 4-chip mesh
        of logical chips, chip 3 corrupting: the audited passes raise
        naming chip 3 until it is quarantined (within ceil(threshold /
        1.5) waves), the next pass runs at D = 2 on the device, then the
        corruption stops, the chip decays to probation, passes
        PROBATION_PROBES probes on a zcash10k batch and rejoins, and the
        last pass runs at D = 4 with no reformation.

    Launch counts are set to 0 before each part and read after."""
    from ed25519_consensus_tpu_torch import batch, devcache, faults
    from ed25519_consensus_tpu_torch.ops import _cuda

    dev = "cuda:0" if DEV == "cuda" else DEV
    totals = dict.fromkeys(_cuda.KERNELS, 0)

    def add(counts):
        for k, v in counts.items():
            totals[k] += v

    labs = gray_labs(dev, add)

    heights, bad_h = state["comet_heights"]
    truth = [h != bad_h for h in range(COMET_HEIGHTS)]
    batch.reset_device_health()
    devcache.set_default_cache(devcache.DeviceOperandCache(enabled=True))
    hedge = {}

    def flap():
        return faults.slow_plan(0x6A7, chip=0, seconds=GRAY_SLOW_S,
                                kind="flap", period=GRAY_FLAP_PERIOD)

    for label, plan, cold in (("clean", None, False),
                              ("gray flap", flap(), False),
                              ("clean, cold ledger", None, True),
                              ("gray flap, cold ledger", flap(), True)):
        _cuda.reset_launch_counts()
        hedge[label] = gray_hedge_pass(f"hedge leg, {label} pass",
                                       verifiers(heights), truth, dev, plan,
                                       cold)
        counts = _cuda.launch_counts()
        hedge[label]["launches"] = {k: v for k, v in counts.items() if v}
        add(counts)
    devcache.set_default_cache(None)
    batch.reset_device_health()
    if hedge["gray flap"]["hedges_won"] < 1:
        raise AssertionError(f"the gray-flap pass won no hedge: "
                             f"{hedge['gray flap']}")

    _cuda.reset_launch_counts()
    probation = gray_probation_leg(state, dev)
    counts = _cuda.launch_counts()
    add(counts)
    need_launches("the probation leg", counts, GRAY_KERNELS)
    need_launches("the gray phase", totals,
                  GRAY_KERNELS + ("build_tables", "window_sums_tables"))
    no_lab_forms("the gray phase", totals)
    state["gray_launches"] = totals
    state["gray"] = {"labs": labs, "hedge": hedge, "probation": probation}


# The federation phase: FED_CHAINS CometBFT chains, each signed by its own
# COMET_KEYS validators (bench.py's cometbft128 shape), FED_HEIGHTS heights
# a pass, through a ReplicaSet of FED_REPLICAS device services on one card.
# Commits go in runs of FED_RUN heights of one chain (one chunk each); a
# CPU rehearsal shrinks the depth.
FED_REPLICAS, FED_CHAINS, FED_HEIGHTS, FED_RUN = 3, 8, 64, 8
FED_SEED = 0xFED13
FED_KERNELS = ("expand_compressed", "window_sums", "fold_partials",
               "build_tables", "window_sums_tables")


def fed_chain_keys(c: int, n_keys: int):
    """Chain c's n_keys validator keys, from FED_SEED."""
    from ed25519_consensus_tpu_torch import SigningKey, faults

    rnd = random.Random(faults._stable_seed(FED_SEED, "chain", c))
    return [SigningKey.new(rnd) for _ in range(n_keys)]


def fed_bad_height(c: int, heights: int) -> int:
    return (11 * c + 7) % heights


def fed_sign_chain(job):
    """Chain c's commits, job = (c, heights, n_keys), in a worker process:
    per height, one (vk, R, s, msg) row a validator; validator 5 of the
    chain's tampered height carries a message it did not sign."""
    sys.path.insert(0, str(ROOT))
    c, heights, n_keys = job
    keys = fed_chain_keys(c, n_keys)
    bad_h = fed_bad_height(c, heights)
    rows = []
    for h in range(heights):
        row = []
        for i, sk in enumerate(keys):
            msg = b"chain=%d/vote/height=%d/round=0/val=%d" % (c, h, i)
            sig = sk.sign(msg)
            if h == bad_h and i == 5:
                msg = b"chain=%d/vote/tampered" % c
            row.append((sk.verification_key_bytes().to_bytes(),
                        sig.R_bytes, sig.s_bytes, msg))
        rows.append(row)
    return rows


def fed_chains():
    """The leg's chains: the first window of FED_CHAINS consecutive chain
    seeds whose affinity homes cover every replica → (chain ids, homes,
    commits {(chain, height): entries}).  The commits are signed in one
    worker process a chain (spawned, all stopped on return)."""
    import concurrent.futures
    import multiprocessing

    from ed25519_consensus_tpu_torch import (SigningKey, batch, devcache,
                                             routing)

    homes = {}

    def home(c):
        if c not in homes:
            sk = fed_chain_keys(c, COMET_KEYS)
            v = batch.Verifier()
            v.queue_bulk([(k.verification_key_bytes(), k.sign(b"h"), b"h")
                          for k in sk])
            homes[c] = routing.replica_affinity_order(
                devcache.keyset_digest(v._canonical_keyset_blob()),
                f"chain-{c}", range(FED_REPLICAS))[0]
        return homes[c]

    start = 0
    while {home(c) for c in range(start, start + FED_CHAINS)} != \
            set(range(FED_REPLICAS)):
        start += 1
    chains = list(range(start, start + FED_CHAINS))
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(len(chains), os.cpu_count() or 1),
            mp_context=ctx) as pool:
        signed = list(pool.map(fed_sign_chain, [
            (c, FED_HEIGHTS, COMET_KEYS) for c in chains]))
    from ed25519_consensus_tpu_torch.signature import Signature
    from ed25519_consensus_tpu_torch.verification_key import \
        VerificationKeyBytes

    commits = {}
    for c, rows in zip(chains, signed):
        for h, row in enumerate(rows):
            commits[(c, h)] = [(VerificationKeyBytes(vk), Signature(R, s),
                                msg) for vk, R, s, msg in row]
    return chains, {c: homes[c] for c in chains}, commits


def fed_order(chains):
    """One pass's submission order: runs of FED_RUN heights of one chain,
    the chains in turn."""
    return [(c, h) for b in range(0, FED_HEIGHTS, FED_RUN) for c in chains
            for h in range(b, min(b + FED_RUN, FED_HEIGHTS))]


def fed_namespace_bytes(fs) -> dict:
    """Per replica namespace: resident keysets, host-mirror bytes and
    device bytes of its devcache."""
    out = {}
    for rid, rep in sorted(fs.replicas.items()):
        st = rep.cache.stats()
        out[st["namespace"]] = {k: st[k] for k in (
            "resident_keysets", "resident_bytes", "device_bytes")}
    return out


def fed_pass(label, fs, order, commits, truth, crash=None):
    """One pass of the chains' commits through the ReplicaSet, pumped on
    the real clock: each run of FED_RUN heights of every chain is
    submitted (consensus class, tenant = the chain), then the fleet is
    pumped until it resolved them.  `crash`, a fault plan, is installed
    before the pass's second half.  → (the pass record, the
    pass's launch counts)."""
    from ed25519_consensus_tpu_torch import batch, faults
    from ed25519_consensus_tpu_torch.ops import _cuda

    keys = ("submitted", "affinity_hits", "spillovers", "reissued",
            "host_floor", "ejections", "rejoins", "prewarm_hits",
            "revivals", "probes", "device_error_waves")
    before = {k: fs.totals[k] for k in keys}
    lat, got = [], {}
    homes_hit = {}
    block = FED_RUN * len({c for c, _h in order})
    rec = {"pass": label}
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    for b in range(0, len(order), block):
        if crash is not None and b == (len(order) // block // 2) * block:
            rec["namespaces_before_eject"] = fed_namespace_bytes(fs)
            faults.install(crash)
        sent = {}
        for c, h in order[b:b + block]:
            v = batch.Verifier()
            v.queue_bulk(commits[(c, h)])
            sent[(c, h)] = (fs.submit(v, cls="consensus",
                                      tenant=f"chain-{c}"),
                            time.perf_counter())
        while not all(f.done() for f, _t in sent.values()):
            if fs.process_once() == 0:
                time.sleep(0.0005)
        if crash is not None and "namespaces_after_eject" not in rec \
                and fs.totals["ejections"] > before["ejections"]:
            rec["namespaces_after_eject"] = fed_namespace_bytes(fs)
        for k, (f, t) in sent.items():
            got[k] = f.result(0)
            lat.append(f._current().resolved_at - t)
            homes_hit.setdefault(k[0], []).append(f.replica_trail[0])
    dt = time.perf_counter() - t0
    if crash is not None:
        faults.uninstall()
    counts = _cuda.launch_counts()
    d = {k: fs.totals[k] - before[k] for k in keys}
    rec.update({
        "commits": len(order), "seconds": dt,
        "sigs_per_s": len(order) * COMET_KEYS / dt,
        "p50_ms": 1e3 * pct(lat, 0.5), "p99_ms": 1e3 * pct(lat, 0.99),
        "affinity_hit_rate": d["affinity_hits"] / max(1, d["submitted"]),
        **{k: d[k] for k in keys if k not in ("submitted",
                                              "affinity_hits")},
        "rejected": sorted(k for k, ok in got.items() if not ok),
        "launches": {k: counts[k] for k in FED_KERNELS},
        "placements": {c: sorted(set(r)) for c, r in homes_hit.items()},
    })
    if len(got) != len(order) or any(not isinstance(x, bool)
                                     for x in got.values()):
        raise AssertionError(f"fleet {label}: commits lost or failed")
    wrong = [k for k in order if got[k] != truth[k]]
    if wrong:
        raise AssertionError(f"fleet {label}: verdicts differ from the "
                             f"host's at {wrong[:8]}")
    brief = {k: v for k, v in rec.items()
             if k not in ("rejected", "placements")}
    log(f"  fleet {label}: {json.dumps(brief)}")
    return rec, counts


def fleet_leg(dev: str, add) -> dict:
    """Part (a) of phase_federation (its docstring)."""
    from ed25519_consensus_tpu_torch import (batch, config, faults,
                                             federation, health, service)
    from ed25519_consensus_tpu_torch.ops import _cuda

    t = time.perf_counter()
    chains, homes, commits = fed_chains()
    t_sign = time.perf_counter() - t
    truth, rng = {}, random.Random(0xFED)
    for (c, h), ents in commits.items():
        v = batch.Verifier()
        v.queue_bulk(ents)
        truth[(c, h)] = batch._host_verdict(v, rng)
    bad = sorted(k for k, ok in truth.items() if not ok)
    if bad != sorted((c, fed_bad_height(c, FED_HEIGHTS)) for c in chains):
        raise AssertionError(f"host verdicts reject {bad}, not the "
                             f"tampered commits")
    log(f"  fleet chains {chains} ({COMET_KEYS} validators each), homes "
        f"{homes}; {len(commits)} commits signed and host-verified in "
        f"{time.perf_counter() - t:.1f} s (signing {t_sign:.1f} s)")
    if set(homes.values()) != set(range(FED_REPLICAS)):
        raise AssertionError(f"a replica is no chain's home: {homes}")

    def factory(rid, clock, cache):
        return service.VerifyService(
            clock=clock, auto_start=False, replica_id=f"r{rid}",
            cache=cache, device=dev, hybrid=False, merge="never", mesh=0,
            chunk=FED_RUN, health=health.DeviceHealth(mesh=0),
            breaker_seed=rid)

    order = fed_order(chains)
    passes = []
    with config.override(ED25519_TPU_VERDICT_CACHE_ENABLED="0"):
        # The memo is off, so every pass re-verifies the stream on the
        # card (a memo hit would answer pass 2 with no launch).
        fs = federation.ReplicaSet(FED_REPLICAS, service_factory=factory,
                                   device=dev)
    try:
        home0 = homes[chains[0]]
        for label in ("pass 1 (cold)", "pass 2 (resident)",
                      "pass 3 (crash)", "pass 4 (rejoined)"):
            crash = None
            if label.startswith("pass 3"):
                crash = faults.replica_plan(FED_SEED, "crash",
                                            replica=home0, at=0)
            with record_calls("dispatch_window_sums_many_tables") as tab:
                rec, counts = fed_pass(label, fs, order, commits, truth,
                                       crash)
            add(counts)
            rec["tables_calls"] = tab.calls
            rec["namespaces"] = fed_namespace_bytes(fs)
            passes.append(rec)
            if label.startswith("pass 3"):
                # Revival: the ejected replica's suspicion decays on a
                # short half-life, it is rebuilt, probed on the card and
                # rejoins with its peers' warm hints.
                _cuda.reset_launch_counts()
                t = time.perf_counter()
                with config.override(
                        ED25519_TPU_REPLICA_SUSPICION_HALF_LIFE="0.001"):
                    while fs.totals["rejoins"] < 1 and \
                            time.perf_counter() - t < 30.0:
                        fs.process_once()
                        time.sleep(0.002)
                add(_cuda.launch_counts())
                rec["revival"] = {
                    "seconds": time.perf_counter() - t,
                    **{k: fs.totals[k] for k in (
                        "revivals", "probes", "probe_failures", "rejoins",
                        "prewarm_hits", "prewarm_refused")},
                    "state": fs.registry.state_of(home0)}
                log(f"  fleet revival of r{home0}: "
                    f"{json.dumps(rec['revival'])}")
        for rec in passes:
            for k in ("namespaces_before_eject", "namespaces_after_eject",
                      "namespaces"):
                if k in rec:
                    log(f"  fleet {rec['pass']} devcache {k}: "
                        f"{json.dumps(rec[k])}")
    finally:
        fs.close()
    want_bad = sorted((c, fed_bad_height(c, FED_HEIGHTS)) for c in chains)
    p1, p2, p3, p4 = passes
    checks = {
        "8 tampered rejected a pass": all(r["rejected"] == want_bad
                                          for r in passes),
        "pass 2 launched K2t": p2["launches"]["window_sums_tables"] > 0
        or DEV == "cpu",
        "pass 3 ejected": p3["ejections"] >= 1 and p3["reissued"] >= 1,
        "pass 3 rejoined": p3["revival"]["rejoins"] >= 1
        and p3["revival"]["state"] == health.REPLICA_HEALTHY,
        "the eject freed its namespace only": (
            p3["namespaces_after_eject"][f"r{home0}"]["device_bytes"] == 0
            and all(p3["namespaces_after_eject"][ns]["device_bytes"]
                    >= p3["namespaces_before_eject"][ns]["device_bytes"]
                    for ns in p3["namespaces_before_eject"]
                    if ns != f"r{home0}")),
        "pass 4 affinity restored": p4["affinity_hit_rate"] == 1.0
        and p4["placements"][chains[0]] == [home0],
        "no host floor, no device error": all(
            r["host_floor"] == 0 and r["device_error_waves"] == 0
            for r in passes),
    }
    log(f"  fleet gates: {json.dumps(checks)}")
    if not all(checks.values()):
        raise AssertionError(f"fleet leg: gates failed: "
                             f"{[k for k, ok in checks.items() if not ok]}")
    calls = [c for r in passes for c in r.pop("tables_calls")]
    hold_recorded_tables("fleet", calls)
    return {"chains": chains, "homes": homes, "passes": passes}


def phase_federation(state: dict) -> None:
    """The federation on the card:

    (a) fleet_leg: a ReplicaSet(FED_REPLICAS) whose replicas are
        VerifyService(device="cuda:0", hybrid=False, mesh=0) over their
        namespaced devcaches, pumped on the real clock.  FED_CHAINS
        CometBFT chains, each with its own COMET_KEYS-validator keyset
        (chosen from FED_SEED so every replica is some chain's affinity
        home), FED_HEIGHTS heights a pass, one commit a consensus-class
        submission, one commit of each chain tampered.  Pass 1 starts
        cold (a keyset builds at its second sighting); in pass 2 every
        chain dispatches from its home's resident tables (K2t); pass 3
        crashes chain 0's home halfway (faults.replica_plan "crash"): its
        queue is surrendered and re-verified on peers on the card; then
        the replica is revived, probed on the card and rejoins with its
        peers' warm hints; pass 4 shows affinity restored.  Gates: every
        verdict the host's, none lost, exactly the tampered commits
        rejected, the crash ejects and rejoins, K2t launched in pass 2,
        the ejected namespace's device bytes freed and no peer's, every
        tables dispatch equal to the plain chain.
    (b) tools/traffic_lab.py --fleet 3 --replica-crash at the tool's
        defaults (host-modelled replicas), and the single-service
        --device run (one batch a chunk, rotation faults) on the card.
    (c) tools/mesh_chaos.py at its defaults, the storm's 8 chips logical
        on cuda:0 (K1, K2, K3 a shard and K5).
    Each tool's gates fail the run.  Launch counts are set to 0 before
    each part and read after."""
    from ed25519_consensus_tpu_torch import batch, devcache
    from ed25519_consensus_tpu_torch.ops import _cuda
    from ed25519_consensus_tpu_torch.tools import mesh_chaos, traffic_lab

    dev = "cuda:0" if DEV == "cuda" else DEV
    totals = dict.fromkeys(_cuda.KERNELS, 0)

    def add(counts):
        for k, v in counts.items():
            totals[k] += v

    batch.reset_device_health()
    t = time.perf_counter()
    fleet = fleet_leg(dev, add)
    log(f"  (a) fleet leg: {time.perf_counter() - t:.1f} s")
    devcache.set_default_cache(None)
    batch.reset_device_health()

    labs = {}
    for label, argv in (
            ("traffic_lab --fleet 3 --replica-crash",
             ["--fleet", "3", "--replica-crash"]),
            ("traffic_lab --device", ["--device", "--rotation-faults",
                                      "--torch-device", dev])):
        _cuda.reset_launch_counts()
        t = time.perf_counter()
        cfg = traffic_lab.parse_args(argv)
        summary = traffic_lab.run(cfg)
        counts = _cuda.launch_counts()
        add(counts)
        log(f"  (b) {label}: {time.perf_counter() - t:.1f} s; "
            f"{json.dumps(traffic_lab.headline(cfg, summary))}; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        if not summary["ok"]:
            raise AssertionError(f"{label}: gates failed: "
                                 f"{traffic_lab.failed_gates(summary)}")
        labs[label] = traffic_lab.headline(cfg, summary)
    batch.reset_device_health()

    _cuda.reset_launch_counts()
    t = time.perf_counter()
    cfg = mesh_chaos.parse_args(["--device", dev])
    chaos = mesh_chaos.chaos(cfg)
    counts = _cuda.launch_counts()
    add(counts)
    log(f"  (c) mesh_chaos: {time.perf_counter() - t:.1f} s; "
        f"{json.dumps(mesh_chaos.headline(chaos))}; storm "
        f"{json.dumps([(s['stage'], s['mesh_after'], s['reissued']) for s in chaos.get('reformation_storm', {}).get('stages', [])])}; "
        f"launches { {k: v for k, v in counts.items() if v} }")
    if not chaos["ok"]:
        raise AssertionError(f"mesh_chaos: gates failed: "
                             f"{json.dumps(chaos)[:2000]}")
    need_launches("mesh_chaos", counts, ("expand_compressed", "window_sums",
                                         "fold_partials", "fold_shards"))
    need_launches("the federation phase", totals,
                  FED_KERNELS + ("fold_shards",))
    no_lab_forms("the federation phase", totals)
    batch.reset_device_health()
    state["federation_launches"] = totals
    state["federation"] = {"fleet": fleet, "labs": labs,
                           "mesh_chaos": mesh_chaos.headline(chaos)}


ANALYSIS_KERNELS = ("expand_compressed", "window_sums", "fold_partials",
                    "build_tables", "window_sums_tables")


def phase_analysis(state: dict) -> None:
    """The port's consensus-safety analysis on the card:

    (a) the SASS audit (analysis/sass_audit.py) of every library
        `_cuda.build_all()` built: no floating-point opcode outside the
        compiler's 32-bit integer-division sequence and its constant-move
        idiom, and each function's opcodes equal to
        analysis/sass_manifest.json when this toolkit's nvcc built it; one
        line per function;
    (b) `consensuslint --race-audit --device cuda:0` in a subprocess over
        the cometbft128 stream of phase_stream (the host's verdicts come
        with it): every verdict the host's, no flagged field, no lock
        cycle; then the same harness run bare in a second process
        (ED25519_TPU_RACE_AUDIT unset: no monitor), whose workload seconds
        are the baseline of the monitors' cost; then the same workload
        here, with the launch counts set to 0 before it and read after;
    (c) the `consensuslint --stats` line, its race_audit_fields read from
        (b)'s report."""
    import contextlib
    import io
    import tempfile

    from ed25519_consensus_tpu_torch import batch, config, devcache
    from ed25519_consensus_tpu_torch.analysis import harness, sass_audit
    from ed25519_consensus_tpu_torch.ops import _cuda
    from ed25519_consensus_tpu_torch.tools import consensuslint

    dev = "cuda:0" if DEV == "cuda" else DEV
    t = time.perf_counter()
    audit = sass_audit.audit_libraries()
    for fn, k in sorted(audit["kernels"].items()):
        log(f"  (a) sass {fn} ({k['source']}): {k['instructions']} "
            f"instructions, {len(k['opcodes'])} opcodes, {k['divisions']} "
            f"u32 division sequence(s), {k['constant_moves']} constant "
            f"move(s)")
    problems = [f"{fn}: {p}" for fn, k in audit["kernels"].items()
                for p in k["problems"]]
    if problems:
        raise AssertionError(f"SASS audit: {problems[:8]}")
    committed = sass_audit.load_manifest()
    if committed is None:
        raise AssertionError("no committed analysis/sass_manifest.json")
    drift = sass_audit.diff_manifests(committed,
                                      sass_audit.manifest_of(audit))
    if drift:
        raise AssertionError(f"SASS manifest drift: {drift[:8]}")
    same = committed["nvcc"] == audit["nvcc"]
    log(f"  (a) SASS audit: {len(audit['kernels'])} functions clean, nvcc "
        f"{audit['nvcc']}, manifest "
        f"{'matched' if same else 'built by ' + committed['nvcc'] + ': invariants only'}"
        f"; {time.perf_counter() - t:.1f} s")

    heights, bad_h = state["comet_heights"]
    host = [h != bad_h for h in range(len(heights))]
    with tempfile.TemporaryDirectory(prefix="chip-smoke-analysis-") as d:
        fixture = os.path.join(d, "stream.json")
        out = os.path.join(d, "race.json")
        harness.dump_stream(fixture, heights, bad_h, host)
        t = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m",
             "ed25519_consensus_tpu_torch.tools.consensuslint",
             "--race-audit", "--device", dev, "--fixture", fixture,
             "--out", out], cwd=str(ROOT), capture_output=True, text=True,
            timeout=600)
        wall = time.perf_counter() - t
        if r.returncode != 0:
            raise AssertionError(f"race audit exited {r.returncode}:\n"
                                 f"{r.stdout[-4000:]}{r.stderr[-4000:]}")
        summary = json.loads(r.stdout.strip().splitlines()[-1])
        if summary["failed"] or summary["flagged"] or summary["cycles"]:
            raise AssertionError(f"race audit: {summary['failed']}")
        log(f"  (b) race audit (monitored, {wall:.1f} s with the process): "
            f"{summary['fields_tracked']} fields tracked, 0 flagged, "
            f"{summary['lock_edges']} lock edges, 0 cycles; workload "
            f"{summary['workload']['seconds']:.2f} s; legs "
            f"{json.dumps(summary['workload']['legs'])}")
        for i, layer in enumerate(summary["lock_layers"]):
            log(f"  (b) lock layer {i}: {', '.join(layer)}")
        t = time.perf_counter()
        with config.override(ED25519_TPU_RACE_AUDIT=None):
            r = subprocess.run(
                [sys.executable, harness.__file__, "--device", dev,
                 "--fixture", fixture], cwd=str(ROOT), capture_output=True,
                text=True, timeout=600)
        wall = time.perf_counter() - t
        if r.returncode != 0:
            raise AssertionError(f"bare harness exited {r.returncode}:\n"
                                 f"{r.stdout[-4000:]}{r.stderr[-4000:]}")
        bare = json.loads(r.stdout.strip().splitlines()[-1])
        if bare["monitored"] or bare["failed"]:
            raise AssertionError(f"bare harness: {bare}")
        mon_s = summary["workload"]["seconds"]
        bare_s = bare["workload"]["seconds"]
        log(f"  (b) the same harness bare ({wall:.1f} s with the process): "
            f"workload {bare_s!r} s against {mon_s!r} s monitored, ratio "
            f"{mon_s / bare_s!r}; legs {json.dumps(bare['workload']['legs'])}")
        batch.reset_device_health()
        devcache.set_default_cache(None)  # cold, as in the subprocess
        _cuda.reset_launch_counts()
        plain = harness.device_workload(heights, dev, truth=host,
                                        log=lambda m: None)
        counts = _cuda.launch_counts()
        if plain["wrong"]:
            raise AssertionError(f"in-process workload: {plain['wrong']}")
        log(f"  (b) the same workload in this process: {plain['seconds']:.2f}"
            f" s; launches { {k: v for k, v in counts.items() if v} }")
        need_launches("the analysis workload", counts, ANALYSIS_KERNELS)
        no_lab_forms("the analysis workload", counts)
        buf = io.StringIO()
        with config.override(ED25519_TPU_RACE_AUDIT_OUT=out), \
                contextlib.redirect_stdout(buf):
            rc = consensuslint.main(["--stats"])
        st = json.loads(buf.getvalue())
        if rc != 0 or st["findings_active"] or \
                st["race_audit_fields"] != summary["fields_tracked"]:
            raise AssertionError(f"consensuslint --stats: rc {rc}, {st}")
        log(f"  (c) consensuslint --stats: {json.dumps(st, sort_keys=True)}")
    devcache.set_default_cache(None)
    batch.reset_device_health()
    state["analysis_launches"] = counts
    state["analysis"] = {
        "sass": {fn: {"instructions": k["instructions"],
                      "opcodes": len(k["opcodes"]),
                      "divisions": k["divisions"]}
                 for fn, k in audit["kernels"].items()},
        "nvcc": audit["nvcc"], "race": {
            k: summary[k] for k in ("fields_tracked", "lock_edges")},
        "monitored_s": mon_s, "bare_s": bare_s,
        "in_process_s": plain["seconds"]}


def no_lab_forms(label: str, counts: dict) -> None:
    """Fails if a verdict path launched a 20-limb (-l20) kernel — the
    lab's window_sums-l20, window_sums_tables-l20, expand_compressed-l20,
    fold_partials-l20, build_tables-l20, fold_shards-l20 or
    expand_affine-l20: every verdict path runs the default K1 to K6 and
    K2t."""
    lab = [k for k, v in counts.items() if v and "-l20" in k]
    if lab:
        raise AssertionError(f"{label} launched the lab's {lab}")


def k1_work(w) -> Work:
    """Work K1 must do on the wire w (B, 33, N) uint8: it expands every
    lane, with the flip multiply and the neg subtraction counted from the
    hints; its squarings priced as fe8_sq, its multiplies as fe8_mul, plus
    the three coordinates to canonical limbs (the 20-limb price beside it:
    fe_sq and fe_mul)."""
    B, _, N = w.shape
    hints = w[:, 32].int()
    flips = int((hints & 1).sum())
    negs = int(((hints >> 1) & 1).sum())
    lanes = B * N
    muls = lanes * K1_MULS_PER_LANE + flips
    sqs = lanes * K1_SQS_PER_LANE
    adds = lanes * K1_ADDS_PER_LANE + negs
    canon = lanes * K1_CANONICAL_PER_LANE
    return Work(lanes * (33 + 160),
                sqs * OPS8_FE_SQ + muls * OPS8_FE_MUL + adds * OPS8_FE_ADD
                + canon * OPS8_TO_CANONICAL,
                sqs * MADS8_FE_SQ + muls * MADS8_FE_MUL
                + canon * MADS8_TO_CANONICAL,
                sqs * OPS_FE_SQ + muls * OPS_FE_MUL + adds * OPS_FE_ADD)


def window_work(dig, nchunk: int, chunk: int):
    """(window additions, negated digits) of plain digits dig (B, nwin, N)
    at `chunk` lanes a block: a (chunk, window) adds only its nonzero
    digits."""
    import torch

    B, nwin, N = dig.shape
    pad = nchunk * chunk - N
    nnz = torch.nn.functional.pad((dig != 0).int(), (0, pad)).reshape(
        B, nwin, nchunk, chunk).sum(dim=-1)
    return int((nnz - 1).clamp(min=0).sum()), int((dig < 0).sum())


def plain_digits(d):
    import torch

    from ed25519_consensus_tpu_torch.ops import msm

    return msm.expand_digits(d).int() if d.dtype == torch.uint8 else d.int()


def conversions(points_in: int, points_out: int) -> "tuple[int, int]":
    """(ops, multiply-adds) of converting `points_in` limb points to the
    8 x 32-bit words and `points_out` back to limbs (4 coordinates each)."""
    return (4 * (points_in * OPS8_FROM_LIMBS20
                 + points_out * OPS8_TO_CANONICAL),
            4 * points_out * MADS8_TO_CANONICAL)


def k2_work(d, nchunk: int, chunk: int = 64, part_bytes: int = 4) -> Work:
    """Work a K2 form must do on digits d (B, 17, N) uint8 or (B, nwin, N)
    int8: it builds a lane's table only up to its largest |digit| and adds
    only the nonzero digits of a (chunk, window); it reads the digits and
    the points once (converting each point) and writes the partials
    (converting each).  A negation costs nothing in ge8_add (its sign
    swaps operands); at the 20-limb price it cost two."""
    dig = plain_digits(d)
    B, nwin, N = dig.shape
    table_adds = int((dig.abs().amax(dim=1) - 1).clamp(min=0).sum())
    window_adds, neg_digits = window_work(dig, nchunk, chunk)
    conv, conv_mads = conversions(B * N, B * nchunk * nwin)
    return adds_work(d.numel() + B * N * 160
                     + B * nchunk * nwin * 80 * part_bytes,
                     table_adds + window_adds, conv, conv_mads,
                     neg_digits * 2 * OPS_FE_NEG)


def fold_work(B: int, nchunk: int, nwin: int, part_bytes: int = 4) -> Work:
    """Work of K3: nchunk - 1 additions per (b, window), each partial
    converted in and each window sum out."""
    conv, conv_mads = conversions(B * nchunk * nwin, B * nwin)
    return adds_work(B * nchunk * nwin * 80 * part_bytes + B * nwin * 320,
                     B * nwin * max(nchunk - 1, 0), conv, conv_mads, 0)


def k4_work(pts, window_bits: int = 4, arith: str = "u32") -> Work:
    """Work K4 must do on points (B, 4, 20, N): read each point once and
    write its table.  The default form builds K2's tree: 7 complete
    additions a lane, the 4 coordinates in and the 8 entries past the
    identity out as canonical limbs (32 conversions).  The 20-limb chain
    (build_tables-l20, build_tables-r32): NTBL - 1 additions a lane, priced
    with every point converted in and every entry out."""
    from ed25519_consensus_tpu_torch.ops import msm

    B, _, _, N = pts.shape
    lanes = B * N
    ntbl = msm._table_entries(window_bits)
    nbytes = lanes * 160 * (1 + ntbl)
    if msm._u32_tables(window_bits, arith):
        return adds_work(nbytes, lanes * 7, *conversions(lanes, lanes * 8),
                         0)
    return adds_work(nbytes, lanes * (ntbl - 1),
                     *conversions(lanes, lanes * ntbl), 0)


def same_table_points(a, b) -> bool:
    """Whether tables a and b (B, NTBL, 4, 20, N) hold the same points,
    entry by entry and lane by lane: Z nonzero mod p in both (so an entry
    of zeros is no point) and X1 Z2 = X2 Z1, Y1 Z2 = Y2 Z1 and T1 Z2 = T2
    Z1 mod p, in the plain field arithmetic on a's device."""
    import torch

    from ed25519_consensus_tpu_torch.ops import torch_field as TF

    x, y = a.int().movedim(3, 0), b.int().movedim(3, 0)  # limbs first
    if not all(bool(TF.canonical_limbs20(t[:, :, :, 2]).any(dim=0).all())
               for t in (x, y)):
        return False
    return all(torch.equal(
        TF.canonical_limbs20(TF.mul(x[:, :, :, c], y[:, :, :, 2])),
        TF.canonical_limbs20(TF.mul(y[:, :, :, c], x[:, :, :, 2])))
        for c in (0, 1, 3))


def tree_levels(live: int) -> int:
    """The levels of a warp's halving tree (csrc/fold_partials.cu
    warp_fold) over `live` values at which lane 0 adds: ceil(log2 live)."""
    n, s = 0, 16
    while s:
        n += s < live
        live = min(live, s)
        s //= 2
    return n


def fold_serial_adds(nchunk: int) -> int:
    """The complete additions on K3's longest dependent path (thread 0's,
    csrc/fold_partials.cu): its own partials after the first, then every
    level of its warp's halving tree and of the warps' tree at which lane
    0 adds."""
    from ed25519_consensus_tpu_torch.ops.msm import FOLD_THREADS as threads

    held = min(nchunk, threads)
    return (max(-(-nchunk // threads) - 1, 0) + tree_levels(min(held, 32))
            + tree_levels(-(-held // 32)))


def k5_serial_adds(D: int) -> int:
    """The complete additions on K5's longest dependent path (lane 0 of a
    warp, csrc/fold_partials.cu fold_shards_kernel): the levels of one
    halving tree over the D shards, ceil(log2 D); the 20-limb body
    (fold_shards-l20) takes D - 1 in a row."""
    return tree_levels(D)


def k5_work(D: int, B: int) -> Work:
    """Work of K5 on D shards of B window sums: read each shard's sums once
    and write the fold; D - 1 additions a (b, w), each shard's point
    converted in and the fold out."""
    return adds_work(D * B * 33 * 320 + B * 33 * 320, B * 33 * max(D - 1, 0),
                     *conversions(D * B * 33, B * 33), 0)


def k6_work(a, arith: str = "u32") -> Work:
    """Work of K6 on the affine wire a (B, 2, 20, N): 80 bytes read and
    160 written a lane, one field product priced as fe8_mul; the default
    form also converts X and Y in and X, Y and T out as canonical limbs,
    which the 20-limb form (expand_affine-l20) does not."""
    B, _, _, N = a.shape
    lanes = B * N
    if arith == "l20":
        return Work(lanes * 240, lanes * OPS8_FE_MUL, lanes * MADS8_FE_MUL,
                    lanes * OPS_FE_MUL)
    return Work(lanes * 240,
                lanes * (OPS8_FE_MUL + 2 * OPS8_FROM_LIMBS20
                         + 3 * OPS8_TO_CANONICAL),
                lanes * (MADS8_FE_MUL + 3 * MADS8_TO_CANONICAL),
                lanes * OPS_FE_MUL)


def kernel_work(d, w, parts):
    """The Work each kernel must do on these inputs:
    digits d (B, 17, N) uint8, wire w (B, 33, N) uint8, K2's partials.
    Counted from the data: K1 as k1_work, K2 as k2_work, K3 as
    fold_work."""
    B, nchunk = parts.shape[:2]
    return {"expand_compressed": k1_work(w),
            "window_sums": k2_work(d, nchunk),
            "fold_partials": fold_work(B, nchunk, 33)}


def hold_and_time(report: dict, label: str, digits, wire,
                  timed: bool, ge8_us: "float | None" = None) -> None:
    """K1, K2 and K3 on the card against their plain versions on the same
    operands, which must agree exactly; then, if `timed`, both timed
    (median of 5, CUDA events) beside each kernel's bound, K3's with its
    latency floor beside it: the additions on its longest dependent path
    (`fold_serial_adds`) times `ge8_us`, one addition's measured latency
    in a chain (probe_ge8)."""
    import torch

    from ed25519_consensus_tpu_torch.ops import msm
    from ed25519_consensus_tpu_torch.ops import torch_decompress as TD

    d = torch.from_numpy(digits).to(DEV)
    w = torch.from_numpy(wire).to(DEV)
    B, _, N = d.shape
    pts = TD.expand_compressed_points(w)
    parts = msm.window_partials(d, pts)
    work = kernel_work(d, w, parts)
    cases = {
        "expand_compressed": (
            lambda: TD.expand_compressed_points(w),
            lambda: TD.expand_compressed_points_plain(w)),
        "window_sums": (
            lambda: msm.window_partials(d, pts),
            lambda: msm.window_partials_plain(d, pts)),
        "fold_partials": (
            lambda: msm.fold_partials(parts),
            lambda: msm.fold_partials_plain(parts)),
    }
    for name, (kern, plain) in cases.items():
        got, want = kern(), plain()
        sync()
        err = int((got.int() - want.int()).abs().max())
        if err:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {label} (B={B}, N={N}): {err}")
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
        if not timed:
            continue
        ms = cuda_ms(kern)
        pms = cuda_ms(plain)
        bms, by = bound_ms(work[name])
        log(f"  {label} B={B} N={N} {name:18s} kernel {ms:10.3f}  plain "
            f"{pms:10.3f}  bound {bms:8.4f} ({by}; "
            f"{bound_note(work[name])})")
        if name == "fold_partials" and ge8_us is not None:
            n_serial = fold_serial_adds(parts.shape[1])
            floor = n_serial * ge8_us / 1e3
            log(f"  {label} B={B} N={N} fold_partials latency floor "
                f"{floor:.4f} ms ({n_serial} serial additions x "
                f"{ge8_us:.4f} us)")
            print(json.dumps({"fold_latency_floor": {
                "label": label, "B": B, "N": N, "nchunk": parts.shape[1],
                "serial_additions": n_serial, "us_per_addition": ge8_us,
                "floor_ms": floor, "kernel_ms": ms, "bound_ms": bms}}),
                flush=True)
        if B == STACK_B:
            report[name].update(ms=ms, plain_ms=pms, bound_ms=bms,
                                bound_by=by)
    log(f"  {label} B={B} N={N}: K1, K2, K3 equal their plain versions "
        f"(max |diff| 0)")


def phase_times(report: dict, state: dict) -> None:
    """Each kernel against its plain version at every shape the main path
    gave it, on the operands it was given: zcash10k and the adversarial
    batch as `verify_gpu` stages them (B = 1, N = pad_lanes(terms)), and
    the stacked B = 8, N = 12,288 call.  Timed at the zcash10k
    `verify_gpu` shape and at B = 8; first one complete addition's latency
    in a chain (probe_ge8, one warp), for K3's latency floor."""
    import torch

    from ed25519_consensus_tpu_torch.ops import msm
    from ed25519_consensus_tpu_torch.tools import microbench

    ge8_us = microbench.probe_ge8(device=torch.device(DEV))["us_per_add"]
    state["ge8_us"] = ge8_us
    log("kernels vs plain versions at the main path's shapes (exact), "
        "then times (median of 5, CUDA events), ms:")
    # The operands of the second zcash10k verify_gpu and of the
    # adversarial verify_gpu: the same staging, the same seeds.
    for label, verifier, seed, timed in (
            ("zcash10k verify_gpu", state["verifier"], 101, True),
            ("adversarial verify_gpu", state["adv"], 5, False)):
        digits, wire = verifier._stage(random.Random(seed)).device_operands(
            msm.pad_lanes)
        hold_and_time(report, label, digits[None], wire[None], timed,
                      ge8_us)
    digits, wire = state["stack"]
    hold_and_time(report, "stacked zcash10k", digits[:1], wire[:1], True,
                  ge8_us)
    hold_and_time(report, "stacked zcash10k", digits, wire, True, ge8_us)


def phase_profile(state: dict) -> None:
    """One more zcash10k `verify_gpu` under torch.profiler: the device time
    of each kernel and copy inside the call, and the card's idle share of
    the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    bv = state["verifier"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        bv.verify_gpu(rng=random.Random(300))
        wall = time.perf_counter() - t
    rows = device_rows(prof)
    busy = sum(us for us, _, _ in rows) / 1e6
    if not rows:
        log("profiled verify_gpu: the profiler captured no device time "
            "(device busy share not measured)")
        return
    log(f"profiled verify_gpu: wall {wall:.3f} s, device busy "
        f"{busy * 1e3:.3f} ms, idle share {1 - busy / wall:.5f}")
    for us, key, count in rows[:8]:
        log(f"  {us / 1e3:9.3f} ms  x{count}  {key[:70]}")


def device_rows(prof) -> list:
    """[(device microseconds, name, count)] of every kernel and copy a
    torch.profiler run saw on the card, the longest first.  The host ops
    that launched them (aten::copy_ carries its copy's device time again)
    and the profiler's own buffer requests are left out."""
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0 and not ev.key.startswith("aten::") \
                and ev.key != "Activity Buffer Request":
            rows.append((us, ev.key, ev.count))
    return sorted(rows, reverse=True)


def dispatch_split(label: str, fn) -> None:
    """One call of the dispatch `fn` under torch.profiler, after a warm-up
    call: the device time of each kernel and copy in it, and their sum."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    rows = device_rows(prof)
    if not rows:
        log(f"  {label}: the profiler captured no device time (not "
            f"measured)")
        return
    log(f"  {label}: device busy {sum(r[0] for r in rows) / 1e3:.4f} ms; "
        + "; ".join(f"{key[:40]} {us / 1e3:.4f} ms x{count}"
                    for us, key, count in rows))


def device_ms(fn, reps: int = 5) -> float:
    """Mean device milliseconds of the kernels `fn` launches, over `reps`
    runs under torch.profiler after one warm-up run: the kernels' own time,
    without the host time between a CUDA event and the launch that a
    kernel shorter than its wrapper's host work would show (K3, K5, K6).
    NaN when the profiler captured no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        sync()
    us = sum(getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
             for ev in prof.key_averages() if ev.key.endswith("_kernel"))
    return us / 1e3 / reps if us else float("nan")


def k7_work(w, flagged: int) -> Work:
    """Work K7 (csrc/shift128_lanes.cu) must do on the wire w (B, 33, N)
    with `flagged` lanes carrying the shift flag: 128 doublings a flagged
    lane, priced at their 4 fe8_sq and 4 fe8_mul (a doubling's 3 adds, 3
    subtracts and negation and the lane's 3 + 4 conversions are left out,
    so the bound is a floor); the hint byte of every lane read, 60 limbs
    read and 80 written (2 B each) a flagged lane."""
    from ed25519_consensus_tpu_torch.ops.torch_decompress import (
        SHIFT128_DOUBLINGS as n)

    B, _, N = w.shape
    return Work(B * N + flagged * (60 + 80) * 2,
                flagged * n * 4 * (OPS8_FE_SQ + OPS8_FE_MUL),
                flagged * n * 4 * (MADS8_FE_SQ + MADS8_FE_MUL),
                flagged * n * 4 * (OPS_FE_SQ + OPS_FE_MUL))


def fresh_key_batch(n: int, rng, tamper: bool = False):
    """One zcash.sync-shaped batch: n signatures, each under a fresh key
    (every key's [2^128]A is the card's to compute), as a Verifier; with
    `tamper`, signature n // 2 signs another message."""
    from ed25519_consensus_tpu_torch import SigningKey, batch

    ents = []
    for i in range(n):
        sk = SigningKey.new(rng)
        msg = b"joinsplit-%d" % i
        sig = sk.sign(b"tampered" if tamper and i == n // 2 else msg)
        ents.append((sk.verification_key_bytes(), sig, msg))
    v = batch.Verifier()
    v.queue_bulk(ents)
    return v


def phase_shift128(report: dict, state: dict) -> None:
    """K7 (shift128_lanes) on a zcash.sync-shaped cold dispatch: one batch
    of 10,000 signatures under fresh keys, staged by
    `device_operands_deferred` (every split-high lane flagged) and padded
    to B = 8 with the identity wire, as verify_many(chunk=8) sends it.
    K7 on K1's output against its plain version (exact), timed in place
    beside its bound, K1 beside it; then that batch and a tampered copy
    through verify_many(hybrid=False) on the card, the launches and the
    shift128 counters read around the calls."""
    import numpy as np
    import torch

    from ed25519_consensus_tpu_torch import batch
    from ed25519_consensus_tpu_torch.ops import _cuda, limbs, msm
    from ed25519_consensus_tpu_torch.ops import torch_decompress as TD

    rng = random.Random(0x5128)
    v = fresh_key_batch(ZCASH_SIGS, rng)
    staged = v._stage(random.Random(7))
    pad = msm.pad_lanes(staged.n_device_terms)
    _, w0 = staged.device_operands_deferred(lambda n: pad)
    w = np.stack([w0] + [limbs.identity_wire_batch(pad)] * (STACK_B - 1))
    flagged = int(((w[:, 32] & TD.SHIFT128_FLAG) != 0).sum())
    if flagged != staged.shift128_device or flagged != ZCASH_SIGS:
        raise AssertionError(f"{flagged} flagged lanes for "
                             f"{staged.shift128_device} deferred keys")
    wire = torch.from_numpy(w).to(DEV)
    pts = TD.expand_compressed_points(wire)
    want = TD.shift128_lanes_plain(wire, pts.clone())
    got = TD.shift128_lanes(wire, pts.clone())
    sync()
    err = int((got.int() - want.int()).abs().max())
    if err:
        raise AssertionError(f"shift128_lanes disagrees with its plain "
                             f"version: max |diff| {err}")
    scratch = pts.clone()
    ms = cuda_ms(lambda: TD.shift128_lanes(wire, scratch))
    pms = cuda_ms(lambda: TD.shift128_lanes_plain(wire, pts), reps=1)
    k1_ms = cuda_ms(lambda: TD.expand_compressed_points(wire))
    work = k7_work(w, flagged)
    bms, by = bound_ms(work)
    row = report["shift128_lanes"]
    row.update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by)
    log(f"  zcash.sync dispatch B={STACK_B} N={pad}, {flagged} flagged "
        f"lanes: shift128_lanes kernel {ms:.4f} ms  plain {pms:.3f}  "
        f"bound {bms:.4f} ({by}; {bound_note(work)}); K1 {k1_ms:.4f} ms; "
        f"max |diff| 0")
    for tamper in (False, True):
        vv = fresh_key_batch(ZCASH_SIGS, rng, tamper=tamper) if tamper \
            else v
        _cuda.reset_launch_counts()
        t = time.perf_counter()
        out = batch.verify_many([vv], rng=random.Random(8), hybrid=False,
                                merge="never", chunk=STACK_B,
                                device="cuda:0")
        dt = time.perf_counter() - t
        counts = _cuda.launch_counts()
        add_launches(report, counts)
        st = dict(batch.last_run_stats)
        log(f"  verify_many zcash.sync batch{' tampered' if tamper else ''}"
            f": {out} in {dt:.3f} s (staging {st['stage_seconds']:.3f} s); "
            f"shift128 lookups {st['shift128_lookups']}, hits "
            f"{st['shift128_hits']}, device {st['shift128_device']}; "
            f"launches { {k: n for k, n in counts.items() if n} }")
        if out != [not tamper]:
            raise AssertionError(f"verify_many gave {out}")
        if not counts.get("shift128_lanes"):
            raise AssertionError("the cold path did not launch K7")
        if st["shift128_hits"] + st["shift128_device"] != \
                st["shift128_lookups"]:
            raise AssertionError("shift128 counters do not add up")
    print(json.dumps({"shift128_lanes": {
        "B": STACK_B, "N": pad, "flagged": flagged, "kernel_ms": ms,
        "plain_ms": pms, "bound_ms": bms, "bound_by": by, "k1_ms": k1_ms}}),
        flush=True)


def phase_native(state: dict) -> None:
    """The native host runtime: built from csrc/host/ and self-checked, or
    the run fails — a broken build must never pass as a slow run."""
    from ed25519_consensus_tpu_torch import native

    t = time.perf_counter()
    lib = native.load()
    if lib is None:
        raise AssertionError("the native host runtime did not build or "
                             "failed its self-check")
    log(f"native host runtime: {native.library_path().name}, built and "
        f"self-checked in {time.perf_counter() - t:.1f} s")


def stream_pass(label: str, make, host, tampered_at=None, **kw) -> dict:
    """One verify_many pass over `make()`'s verifiers with the launch
    counts set to 0 just before it and read just after; every verdict
    must equal the host verdict `host[i]`."""
    from ed25519_consensus_tpu_torch import batch
    from ed25519_consensus_tpu_torch.ops import _cuda

    vs = make()
    device = kw.pop("device", DEV)
    batch.reset_device_health()
    _cuda.reset_launch_counts()
    t = time.perf_counter()
    verdicts = batch.verify_many(vs, rng=random.Random(len(label)),
                                 device=device, **kw)
    dt = time.perf_counter() - t
    counts = _cuda.launch_counts()
    st = dict(batch.last_run_stats)
    if verdicts != host:
        bad = [i for i, (a, b) in enumerate(zip(verdicts, host)) if a != b]
        raise AssertionError(f"{label}: verdicts differ from the host at "
                             f"{bad}")
    sigs = st["sigs"]
    dc = st["devcache"]
    log(f"  {label}: {len(vs)} batches, {sigs} sigs in {dt:.3f} s = "
        f"{sigs / dt:.0f} sigs/s; staging {st.get('stage_seconds', 0):.3f}"
        f" s, device {st.get('device_seconds', 0):.3f} s, combine "
        f"{st.get('combine_seconds', 0):.3f} s, host lane "
        f"{st.get('host_seconds', 0):.3f} s; device batches "
        f"{st.get('device_batches', st.get('device_unions'))}, host "
        f"{st.get('host_batches', st.get('host_unions'))}, rejects "
        f"confirmed {st.get('device_rejects_confirmed', 0)} overturned "
        f"{st.get('device_rejects_overturned', 0)}; devcache "
        f"hit {dc['hit']} tables_hit {dc['tables_hit']} dispatch_hits "
        f"{dc['dispatch_hits']} table_dispatch_hits "
        f"{dc['table_dispatch_hits']}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return {"seconds": dt, "sigs_per_s": sigs / dt, "stats": st,
            "launches": counts, "verdicts": verdicts}


class record_calls:
    """Records every call the path makes to `msm.<name>` while it runs:
    its arguments (numpy operands as given, device tensors by reference)
    and a clone of its result on the device — no synchronisation, so the
    path keeps its timing."""

    def __init__(self, name):
        self.name = name
        self.calls = []

    def __enter__(self):
        from ed25519_consensus_tpu_torch.ops import msm

        self.saved = getattr(msm, self.name)

        def wrapper(*args, **kw):
            out = self.saved(*args, **kw)
            self.calls.append((args, out.clone()))
            return out

        setattr(msm, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        from ed25519_consensus_tpu_torch.ops import msm

        setattr(msm, self.name, self.saved)
        return False


def first_per_shape(calls) -> list:
    """The first input of each shape among recorded calls: a tensor, or a
    list of tensors (K5's shard sums), told apart by its length and its
    first tensor's shape."""
    first = {}
    for (x, *_), _out in calls:
        key = tuple(x.shape) if hasattr(x, "shape") else \
            (len(x),) + tuple(x[0].shape)
        first.setdefault(key, x)
    return list(first.values())


# Lanes a stacked plain check of hold_recorded_tables holds at once.
HOLD_LANES = 1 << 15


def hold_recorded_tables(label: str, calls) -> None:
    """Every tables-resident dispatch a path made held, on the card,
    against its plain versions run on the same operands: the calls that
    read one resident head at one shape are stacked (HOLD_LANES lanes at
    a time) and their results compared with the plain chain's (K1 on the
    R wire, K4, K2t, K3), exactly; a stack that differs is held call by
    call, kernel by kernel on the recomputed intermediates.  A difference
    fails the run, naming the chunk, its batches and the kernels that
    differ."""
    import torch

    from ed25519_consensus_tpu_torch.ops import msm
    from ed25519_consensus_tpu_torch.ops import torch_decompress as TD

    def plain(digits, head, rwire):
        ext = TD.expand_compressed_points_plain(rwire)
        tbl = msm.build_tables_plain(ext)
        part = msm.window_partials_tables_plain(digits, head, tbl)
        return ext, tbl, part, msm.fold_partials_plain(part)

    t = time.perf_counter()
    groups = {}
    for c, call in enumerate(calls):
        (digits, head, rwire, *_), _out = call
        key = (head.data_ptr() if hasattr(head, "data_ptr") else id(head),
               tuple(digits.shape[1:]), tuple(rwire.shape[1:]))
        groups.setdefault(key, []).append((c, call))
    stacks = []
    for grp in groups.values():
        digits = grp[0][1][0][0]
        per = max(1, HOLD_LANES // (digits.shape[0] * digits.shape[-1]))
        stacks += [grp[i:i + per] for i in range(0, len(grp), per)]
    bad = []
    for stack in stacks:
        d = torch.cat([msm.as_tensor(x[0], DEV) for _c, (x, _o) in stack])
        rw = torch.cat([msm.as_tensor(x[2], DEV) for _c, (x, _o) in stack])
        ht = msm.as_tensor(stack[0][1][0][1], DEV)[None]
        if torch.equal(torch.cat([o for _c, (_x, o) in stack]),
                       plain(d, ht, rw)[3]):
            continue
        for c, ((digits, head, rwire, *_), out) in stack:
            d = msm.as_tensor(digits, DEV)
            rw = msm.as_tensor(rwire, DEV)
            ht = msm.as_tensor(head, DEV)[None]
            ext, tbl, part, want = plain(d, ht, rw)
            if torch.equal(out, want):
                continue
            rows = [b for b in range(out.shape[0])
                    if not torch.equal(out[b], want[b])]
            kernels = {
                "K1": torch.equal(TD.expand_compressed_points(rw), ext),
                "K4": torch.equal(msm.multiples_tables(ext), tbl),
                "K2t": torch.equal(msm.window_partials_tables(d, ht, tbl),
                                   part),
                "K3": torch.equal(msm.fold_partials(part), want),
                "the dispatch again": torch.equal(
                    msm.dispatch_window_sums_many_tables(digits, head,
                                                         rwire, DEV),
                    want)}
            log(f"  {label} chunk {c}: batches {rows} differ from the "
                f"plain versions (max |diff| "
                f"{int((out - want).abs().max())}); on the same operands "
                f"again, equal to the plain version: {kernels}")
            bad.append(c)
    sync()
    log(f"  {label}: {len(calls) - len(bad)}/{len(calls)} tables "
        f"dispatches of the path equal their plain versions (K1, K4, K2t, "
        f"K3; exact; {len(stacks)} stacks), held in "
        f"{time.perf_counter() - t:.1f} s")
    if bad:
        raise AssertionError(f"{label}: device window sums differ from the "
                             f"plain versions in chunks {sorted(bad)}")


def phase_stream(report: dict, state: dict) -> None:
    """verify_many on one card with resident keysets, at its users' sizes:
    zcash10k at depth 16 device only (cold with the cache off,
    warm-residency, hot with resident tables, hot with resident heads),
    then the cometbft128 256-height commit stream."""
    from ed25519_consensus_tpu_torch import batch, devcache
    from ed25519_consensus_tpu_torch.config import override
    from ed25519_consensus_tpu_torch.ops import _cuda, msm

    bv = state["verifier"]
    t = time.perf_counter()
    for i in range(5):
        staged = bv.clone()._stage(random.Random(400 + i))
        staged.device_operands_cached(msm.pad_lanes)
    per10k = (time.perf_counter() - t) / 5
    log(f"native staging (stage + cached operands) of one 10k batch: "
        f"{per10k * 1e3:.1f} ms")
    state["stage_10k_s"] = per10k
    tampered = state["tampered"]
    host_ok = batch._host_verdict(bv.clone(), random.Random(6))
    host_bad = batch._host_verdict(tampered.clone(), random.Random(7))
    if not host_ok or host_bad:
        raise AssertionError("host verdicts of zcash10k / tampered wrong")
    bad_at = min(11, DEPTH - 1)

    def zcash(tamper=False):
        def make():
            return [tampered.clone() if tamper and i == bad_at
                    else bv.clone() for i in range(DEPTH)]
        return make

    ok16 = [True] * DEPTH
    bad16 = [i != bad_at for i in range(DEPTH)]
    log(f"zcash10k verify_many, depth {DEPTH}, device only "
        f"(hybrid=False, merge=never, chunk=8):")
    batch.warm_device_shapes(bv.clone(), rng=random.Random(8), device=DEV)
    totals = dict.fromkeys(_cuda.KERNELS, 0)
    passes = {}
    kw = dict(hybrid=False, merge="never", mesh=0)
    devcache.set_default_cache(devcache.DeviceOperandCache(enabled=False))
    passes["cold"] = stream_pass("cold (cache off)", zcash(), ok16, **kw)
    devcache.set_default_cache(devcache.DeviceOperandCache(enabled=True))
    passes["warm"] = stream_pass("warm-residency", zcash(), ok16, **kw)
    with record_calls("dispatch_window_sums_many_tables") as rec:
        passes["tables"] = stream_pass("hot, resident tables (one tampered "
                                       "batch)", zcash(True), bad16, **kw)
    hold_recorded_tables("hot, resident tables", rec.calls)
    with override(ED25519_TPU_DEVCACHE_TABLES="0"):
        passes["head"] = stream_pass("hot, resident heads "
                                     "(ED25519_TPU_DEVCACHE_TABLES=0)",
                                     zcash(), ok16, **kw)
    for name, p in passes.items():
        st = p["stats"]
        want = DEPTH - (1 if name == "tables" else 0)
        if st["device_batches"] != want or st["device_sick"]:
            raise AssertionError(f"{name}: device_batches "
                                 f"{st['device_batches']} != {want}")
        if name == "tables" and st["device_rejects_confirmed"] != 1:
            raise AssertionError("the tampered batch was not a confirmed "
                                 "device reject")
        for k, v in p["launches"].items():
            totals[k] += v
    if passes["tables"]["stats"]["devcache"]["table_dispatch_hits"] <= 0:
        raise AssertionError("the tables pass never dispatched from "
                             "resident tables")
    if passes["head"]["stats"]["devcache"]["dispatch_hits"] <= 0 or \
            passes["head"]["stats"]["devcache"]["table_dispatch_hits"]:
        raise AssertionError("the head pass did not run the head-resident "
                             "dispatch")
    for name, kernels in (("tables", ("window_sums_tables", "build_tables",
                                      "expand_compressed", "fold_partials")),
                          ("head", ("window_sums", "expand_compressed",
                                    "fold_partials"))):
        for k in kernels:
            if passes[name]["launches"][k] == 0:
                raise AssertionError(f"{name} pass never launched {k}")

    # cometbft128: 128 validators, the same set every height
    t = time.perf_counter()
    heights, bad_h = comet_heights()
    state["comet_heights"] = (heights, bad_h)
    state["comet_verifier"] = batch.Verifier()
    state["comet_verifier"].queue_bulk(heights[0])

    def comet():
        return verifiers(heights)

    host = [batch._host_verdict(v, random.Random(9)) for v in comet()]
    if host != [h != bad_h for h in range(COMET_HEIGHTS)]:
        raise AssertionError("cometbft128 host verdicts wrong")
    log(f"cometbft128 stream: {COMET_HEIGHTS} heights x {COMET_KEYS} "
        f"validators, height {bad_h} tampered (built in "
        f"{time.perf_counter() - t:.1f} s):")
    (passes["comet_defaults"], passes["comet_per_commit"],
     calls) = comet_passes(comet, host, state["comet_verifier"])
    hold_recorded_tables("per commit", calls)
    pc = passes["comet_per_commit"]["stats"]
    if pc["device_batches"] + pc["device_rejects_confirmed"] \
            != COMET_HEIGHTS or pc["devcache"]["table_dispatch_hits"] <= 0:
        raise AssertionError("the per-commit stream did not run on the "
                             "device from resident tables")
    for p in (passes["comet_defaults"], passes["comet_per_commit"]):
        for k, v in p["launches"].items():
            totals[k] += v
    state["stream_launches"] = totals
    state["passes"] = passes
    devcache.set_default_cache(None)


def verifiers(batches) -> list:
    """One fresh batch.Verifier per list of (vk, sig, msg) entries."""
    from ed25519_consensus_tpu_torch import batch

    out = []
    for ents in batches:
        v = batch.Verifier()
        v.queue_bulk(ents)
        out.append(v)
    return out


def comet_heights():
    """bench.py's cometbft128 stream: COMET_HEIGHTS heights signed by the
    same COMET_KEYS validators (keys from a seed), one height tampered →
    (per-height entries, the tampered height)."""
    from ed25519_consensus_tpu_torch import SigningKey

    rng = random.Random(0xC0E7)
    keys = [SigningKey.new(rng) for _ in range(COMET_KEYS)]
    heights = []
    for h in range(COMET_HEIGHTS):
        ents = []
        for i, sk in enumerate(keys):
            msg = b"vote/height=%d/round=0/val=%d" % (h, i)
            ents.append((sk.verification_key_bytes(), sk.sign(msg), msg))
        heights.append(ents)
    bad_h = min(77, COMET_HEIGHTS - 1)
    vk, sig, _ = heights[bad_h][5]
    heights[bad_h][5] = (vk, sig, b"vote/tampered")
    return heights, bad_h


def comet_passes(make, host, first):
    """The cometbft128 stream through verify_many's defaults, then per
    commit with every tables dispatch recorded, the cache fresh and the
    shapes of `first` warmed → (defaults pass, per-commit pass, the
    recorded calls)."""
    from ed25519_consensus_tpu_torch import batch, devcache

    devcache.set_default_cache(devcache.DeviceOperandCache(enabled=True))
    batch.warm_device_shapes(first.clone(), rng=random.Random(10),
                             device=DEV)
    defaults = stream_pass("verify_many defaults (merge=auto, hybrid=True)",
                           make, host, mesh=0)
    with record_calls("dispatch_window_sums_many_tables") as rec:
        per_commit = stream_pass("per commit (merge=never, hybrid=False)",
                                 make, host, hybrid=False, merge="never",
                                 mesh=0)
    return defaults, per_commit, rec.calls


def stress_tables_path(reps: int, seconds: float) -> int:
    """The cometbft128 stream of phase_stream, `reps` times or for
    `seconds`, whichever ends first — the search for the open fault of
    ROADMAP.md §C (valid batches the device rejected on the
    resident-tables path, once).  A pass whose device rejects the host
    overturned has its tables dispatches held against the plain versions
    (`hold_recorded_tables` names the chunk, batches and kernel).  Returns
    the number of overturned rejects."""
    from ed25519_consensus_tpu_torch import devcache

    heights, bad_h = comet_heights()
    host = [h != bad_h for h in range(COMET_HEIGHTS)]
    first = verifiers(heights[:1])[0]
    t0 = time.perf_counter()
    total = passes = 0
    while passes < reps and time.perf_counter() - t0 < seconds:
        _, per_commit, calls = comet_passes(
            lambda: verifiers(heights), host, first)
        over = per_commit["stats"]["device_rejects_overturned"]
        if over:
            try:
                hold_recorded_tables(f"pass {passes}", calls)
            except AssertionError as e:
                log(f"  {e}")
        total += over
        passes += 1
    devcache.set_default_cache(None)
    log(f"stress: {passes} per-commit passes ({passes * COMET_HEIGHTS} "
        f"batches) in {time.perf_counter() - t0:.1f} s; device rejects "
        f"the host overturned: {total}")
    return total


def need_launches(label: str, counts: dict, kernels) -> None:
    """Fails unless every kernel of `kernels` launched in the path `label`
    (a CPU rehearsal, DEV = "cpu", launches none and checks nothing)."""
    missing = [k for k in kernels if not counts[k]]
    if missing and DEV != "cpu":
        raise AssertionError(f"{label} never launched {missing}")


def mesh_placement(D: int):
    """(devices, label): shard k on cuda:k when D cards are visible, else
    all D shards on cuda:0 — a virtual mesh, which measures the mesh's
    overhead, not its scaling."""
    import torch

    if DEV != "cuda":
        return [DEV] * D, f"virtual ({D} shards on {DEV})"
    if torch.cuda.device_count() >= D:
        return ([f"cuda:{k}" for k in range(D)],
                f"cards (cuda:0..cuda:{D - 1})")
    return ["cuda:0"] * D, f"virtual ({D} shards on cuda:0)"


def pod_base(rng):
    """bench.py's pod configs: POD_BASE distinct signatures over POD_KEYS
    keys, tiled to the batch size (BASELINE.json config 5)."""
    from ed25519_consensus_tpu_torch import SigningKey

    keys = [SigningKey.new(rng) for _ in range(POD_KEYS)]
    out = []
    for i in range(POD_BASE):
        sk = keys[i % POD_KEYS]
        msg = b"pod-tx-%d" % i
        out.append((sk.verification_key_bytes(), sk.sign(msg), msg))
    return out


def pod_verifier(base, count: int, tamper: bool = False):
    from ed25519_consensus_tpu_torch import batch

    bv = batch.Verifier()
    for rep in range(count // POD_BASE):
        if tamper and rep == 0:
            bad = list(base)
            vk, sig, _ = bad[7]
            bad[7] = (vk, sig, b"pod-tx-tampered")
            bv.queue_bulk(bad)
        else:
            bv.queue_bulk(base)
    return bv


def phase_mesh(report: dict, state: dict) -> None:
    """The sharded mesh at D = 2 and D = 4:
    pod1m (and a tampered copy) once through sharded_staged_msm, then
    pod100k batches through verify_many(mesh=D) at depth MESH_DEPTH —
    cold, hot from a resident head, and with every chunk audited by the
    sentinel — with the launch counts set to 0 before and read after."""
    from ed25519_consensus_tpu_torch import batch, devcache
    from ed25519_consensus_tpu_torch.ops import _cuda, msm
    from ed25519_consensus_tpu_torch.parallel import sharded_msm

    t = time.perf_counter()
    base = pod_base(random.Random(0x90D))
    pod1m = pod_verifier(base, POD_SIGS)
    pod1m_bad = pod_verifier(base, POD_SIGS, tamper=True)
    log(f"built pod1m ({POD_SIGS} sigs tiled from {POD_BASE} distinct over "
        f"{POD_KEYS} keys) and its tampered copy in "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    staged = {"pod1m": pod1m._stage(random.Random(11)),
              "pod1m tampered": pod1m_bad._stage(random.Random(12))}
    host = {k: batch._host_verdict(v.clone(), random.Random(13))
            for k, v in (("pod1m", pod1m), ("pod1m tampered", pod1m_bad))}
    log(f"  staged both in {time.perf_counter() - t:.1f} s (with host "
        f"verdicts {host})")
    if host != {"pod1m": True, "pod1m tampered": False}:
        raise AssertionError("pod1m host verdicts wrong")
    # The single lane's window sums of the same staged batch, the points
    # the mesh's must equal.
    single = {}
    for k, s in staged.items():
        pad = msm.pad_lanes(s.n_device_terms)
        t = time.perf_counter()
        d, w = s.device_operands(lambda n: pad)
        t_pack = time.perf_counter() - t
        t = time.perf_counter()
        ws = msm.dispatch_window_sums_many(d[None], w[None], DEV)
        ws = ws.cpu().numpy()
        t_dev = time.perf_counter() - t
        t = time.perf_counter()
        single[k] = msm.combine_window_sums(ws)
        log(f"  {k} single lane: N = {pad}, operands packed in "
            f"{t_pack:.3f} s, device call (copies in and out included) "
            f"{t_dev:.3f} s, host combine {time.perf_counter() - t:.3f} s")

    base100k = pod_verifier(base, POD100K)
    bad100k = pod_verifier(base, POD100K, tamper=True)
    host100k = (batch._host_verdict(base100k.clone(), random.Random(14)),
                batch._host_verdict(bad100k.clone(), random.Random(15)))
    if host100k != (True, False):
        raise AssertionError("pod100k host verdicts wrong")
    bad_at = min(2, MESH_DEPTH - 1)

    def pod100k(tamper=False):
        def make():
            return [bad100k.clone() if tamper and i == bad_at
                    else base100k.clone() for i in range(MESH_DEPTH)]
        return make

    ok = [True] * MESH_DEPTH
    bad = [i != bad_at for i in range(MESH_DEPTH)]
    totals = dict.fromkeys(_cuda.KERNELS, 0)
    passes = {}
    state["mesh_passes"] = passes
    with record_calls("fold_shards") as cap:
        for D in (2, 4):
            devices, label = mesh_placement(D)
            log(f"mesh D = {D}: placement {label}")
            _cuda.reset_launch_counts()
            for k, s in staged.items():
                t = time.perf_counter()
                check = sharded_msm.sharded_staged_msm(s, D, devices=devices)
                dt = time.perf_counter() - t
                verdict = check.mul_by_cofactor().is_identity()
                log(f"  {k} sharded_staged_msm: N = "
                    f"{sharded_msm.shard_pad(s.n_device_terms, D)}, "
                    f"{dt:.3f} s = {POD_SIGS / dt:.0f} sigs/s (operand "
                    f"packing, device call, host combine); verdict "
                    f"{verdict} (host {host[k]}); window sums equal the "
                    f"single lane's as points: {check == single[k]}")
                if verdict != host[k] or check != single[k]:
                    raise AssertionError(f"{k} on the D = {D} mesh "
                                         f"disagrees with the host or the "
                                         f"single lane")
            counts = _cuda.launch_counts()
            for name, n in counts.items():
                totals[name] += n
            log(f"  pod1m launches: { {k: v for k, v in counts.items() if v} }")
            need_launches("pod1m", counts, ("expand_compressed",
                                            "window_sums", "fold_partials",
                                            "fold_shards"))
            kw = dict(hybrid=False, merge="never", mesh=D, chunk=MESH_DEPTH,
                      device=devices[0] if label.startswith("virtual")
                      else None)
            batch.warm_device_shapes(base100k.clone(), rng=random.Random(16),
                                     chunk=MESH_DEPTH, **{
                                         k: kw[k] for k in ("mesh",
                                                            "device")})
            devcache.set_default_cache(
                devcache.DeviceOperandCache(enabled=False))
            passes[f"cold D={D}"] = stream_pass(
                f"pod100k x{MESH_DEPTH} cold, D = {D} (one tampered batch)",
                pod100k(True), bad, **kw)
            devcache.set_default_cache(
                devcache.DeviceOperandCache(enabled=True))
            for sight in (1, 2):  # sighting 1 stages cold, 2 builds
                stream_pass(f"pod100k x{MESH_DEPTH} sighting {sight}, "
                            f"D = {D}", pod100k(), ok, **kw)
            passes[f"head D={D}"] = stream_pass(
                f"pod100k x{MESH_DEPTH} resident head, D = {D}",
                pod100k(), ok, **kw)
            devcache.set_default_cache(
                devcache.DeviceOperandCache(enabled=False))
            passes[f"sentinel D={D}"] = stream_pass(
                f"pod100k x{MESH_DEPTH} sentinel rate 1.0, D = {D}",
                pod100k(), ok, sentinel_rate=1.0, **kw)
            devcache.set_default_cache(None)
            for name in (f"cold D={D}", f"head D={D}", f"sentinel D={D}"):
                st = passes[name]["stats"]
                want = MESH_DEPTH - (1 if name.startswith("cold") else 0)
                if st["mesh"] != D or st["device_batches"] != want:
                    raise AssertionError(f"{name}: mesh {st['mesh']}, "
                                         f"device_batches "
                                         f"{st['device_batches']} != {want}")
                need_launches(name, passes[name]["launches"],
                              ("expand_compressed", "window_sums",
                               "fold_partials", "fold_shards"))
                for k, v in passes[name]["launches"].items():
                    totals[k] += v
            if passes[f"head D={D}"]["stats"]["devcache"]["dispatch_hits"] \
                    <= 0:
                raise AssertionError("the resident-head mesh form never ran")
            sen = passes[f"sentinel D={D}"]["stats"]["sentinel"]
            log(f"  sentinel: {sen}")
            if sen["audits"] < 1 or sen["divergence"]:
                raise AssertionError(f"sentinel audits {sen}")
            if passes[f"cold D={D}"]["stats"]["device_rejects_confirmed"] \
                    != 1:
                raise AssertionError("the tampered pod100k batch was not a "
                                     "confirmed device reject")
    state["mesh_launches"] = totals
    state["fold_shards_inputs"] = first_per_shape(cap.calls)
    state["pod100k"] = base100k
    state["pod100k_bad"] = bad100k
    sync()


def phase_affine(report: dict, state: dict) -> None:
    """ED25519_TPU_WIRE=affine through the single lane and the D = 2 mesh
    (zcash10k at depth 8, the cache off so every chunk is cold): K6 in
    place of K1, verdicts the host's."""
    from ed25519_consensus_tpu_torch import devcache
    from ed25519_consensus_tpu_torch.config import override
    from ed25519_consensus_tpu_torch.ops import _cuda

    bv, tampered = state["verifier"], state["tampered"]
    depth, bad_at = 8, 5

    def make():
        return [tampered.clone() if i == bad_at else bv.clone()
                for i in range(depth)]

    want = [i != bad_at for i in range(depth)]
    devices, label = mesh_placement(2)
    totals = dict.fromkeys(_cuda.KERNELS, 0)
    log(f"affine wire (ED25519_TPU_WIRE=affine), zcash10k x{depth}, one "
        f"tampered, cache off:")
    devcache.set_default_cache(devcache.DeviceOperandCache(enabled=False))
    with override(ED25519_TPU_WIRE="affine"), \
            record_calls("expand_affine_points") as cap:
        for mesh, dev in ((0, DEV), (2, devices[0] if label.startswith(
                "virtual") else None)):
            p = stream_pass("single lane" if not mesh else
                            f"mesh D = 2, {label}", make, want,
                            hybrid=False, merge="never", mesh=mesh,
                            device=dev)
            if p["launches"]["expand_compressed"]:
                raise AssertionError("the affine pass ran K1")
            need_launches("affine", p["launches"], ("expand_affine",)
                          + (("fold_shards",) if mesh else ()))
            for k, v in p["launches"].items():
                totals[k] += v
    devcache.set_default_cache(None)
    state["affine_launches"] = totals
    state["expand_affine_inputs"] = first_per_shape(cap.calls)


def phase_mesh_kernels(report: dict, state: dict) -> None:
    """K5 and K6 against their plain versions on the operands the mesh and
    affine paths gave them, at every shape (exact; K5 in both call forms,
    the shard list as the path passes it and the stacked tensor, which must
    agree), then timed at the largest beside their bounds, with their
    device time under the profiler and K5's latency floor (its serial
    additions, `k5_serial_adds`, times one addition's latency in a chain,
    probe_ge8); K5's device time and floor also at every other shape.
    Then one pod100k D = 4 cold mesh dispatch under the profiler with the
    stacked fold (the shard sums stacked, then the 20-limb K5 on the
    stack) and with K5 on the shard list, each split by kernel and copy,
    and timed in turns (`mesh_fold_split`); and K1, K2, K3 held on one
    pod100k mesh shard's operands."""
    import numpy as np
    import torch

    from ed25519_consensus_tpu_torch.ops import msm
    from ed25519_consensus_tpu_torch.parallel import sharded_msm

    ge8_us = state["ge8_us"]
    log("K5 / K6 vs plain versions on the path's operands (exact, every "
        "shape), then times at the largest (median of 5, CUDA events), ms:")
    for parts in state["fold_shards_inputs"]:
        stacked = torch.stack(parts)
        want = msm.fold_shards_plain(parts)
        for form, x in (("list", parts), ("stacked", stacked)):
            err = int((msm.fold_shards(x) - want).abs().max())
            if err:
                raise AssertionError(f"fold_shards ({form}) disagrees with "
                                     f"its plain version at D={len(parts)} "
                                     f"B={parts[0].shape[0]}: {err}")
        D, B = len(parts), parts[0].shape[0]
        n_serial = k5_serial_adds(D)
        dms = device_ms(lambda: msm.fold_shards(parts))
        log(f"  fold_shards D={D} B={B}: list and stacked forms equal the "
            f"plain version; device {dms:.5f} ms (profiler, mean of 5), "
            f"latency floor "
            f"{n_serial * ge8_us / 1e3:.5f} ms ({n_serial} serial additions "
            f"x {ge8_us:.4f} us, conversions not counted)")
    for x in state["expand_affine_inputs"]:
        err = int((msm.expand_affine_points(x).int()
                   - msm.expand_affine_points_plain(x).int()).abs().max())
        if err:
            raise AssertionError(f"expand_affine disagrees with its plain "
                                 f"version at {tuple(x.shape)}: {err}")
    log(f"  expand_affine: equal to its plain version at "
        f"{[tuple(x.shape) for x in state['expand_affine_inputs']]}")
    g = max(state["fold_shards_inputs"],
            key=lambda x: len(x) * x[0].numel())
    a = max(state["expand_affine_inputs"], key=lambda x: x.numel())
    D, B = len(g), g[0].shape[0]
    Ba, _, _, Na = a.shape
    cases = {
        "fold_shards": (lambda: msm.fold_shards(g),
                        lambda: msm.fold_shards_plain(g), k5_work(D, B),
                        f"D={D} B={B}"),
        "expand_affine": (lambda: msm.expand_affine_points(a),
                          lambda: msm.expand_affine_points_plain(a),
                          k6_work(a), f"B={Ba} N={Na}"),
    }
    for name, (kern, plain, work, shape) in cases.items():
        got, want = kern(), plain()
        sync()
        err = int((got.int() - want.int()).abs().max())
        if err:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"({shape}): {err}")
        ms = cuda_ms(kern)
        pms = cuda_ms(plain)
        dms = device_ms(kern)
        bms, by = bound_ms(work)
        log(f"  {shape} {name:14s} kernel {ms:10.4f}  device {dms:10.5f}  "
            f"plain {pms:10.3f}  bound {bms:8.5f} ({by}; "
            f"{bound_note(work)}); device share of the bound "
            f"{bms / dms:.3f}; max |diff| 0")
        row = {"kernel": name, "shape": shape, "ms": ms, "device_ms": dms,
               "plain_ms": pms, "bound_ms": bms, "bound_by": by}
        if name == "fold_shards":
            n_serial = k5_serial_adds(D)
            row.update(serial_additions=n_serial, us_per_addition=ge8_us,
                       floor_ms=n_serial * ge8_us / 1e3)
        print(json.dumps({"mesh_kernel": row}), flush=True)
        report[name].update(max_abs_err=err, ms=ms, plain_ms=pms,
                            bound_ms=bms, bound_by=by)
    # One pod100k shard's operands as the D = 4 mesh gives them.
    staged = [state["pod100k"].clone()._stage(random.Random(600 + b))
              for b in range(MESH_DEPTH)]
    pad = max(sharded_msm.shard_pad(s.n_device_terms, 4) for s in staged)
    ops = [s.device_operands(lambda n: pad) for s in staged]
    per = pad // 4
    digits = np.stack([o[0] for o in ops])
    wire = np.stack([o[1] for o in ops])
    mesh_fold_split(digits, wire)
    hold_and_time(report, "pod100k D=4 shard 0",
                  np.ascontiguousarray(digits[..., :per]),
                  np.ascontiguousarray(wire[..., :per]), False)


def mesh_fold_split(digits, wire) -> None:
    """One cold D = 4 mesh dispatch (sharded_window_sums_many) of the
    pod100k operands under the profiler, with the stacked fold — the shard
    sums stacked to (D, B, 4, 20, 33) and folded by the 20-limb K5, as the
    mesh folded before K5 read the shards in place — and with K5 on the
    shard list, each split by kernel and copy (`dispatch_split`); then both
    timed in turns (stacked, list, list, stacked, x3, each the median of 5
    CUDA-event runs).  The two folds must give the same window sums as
    points."""
    import torch

    from ed25519_consensus_tpu_torch.ops import msm
    from ed25519_consensus_tpu_torch.parallel import sharded_msm

    devices, label = mesh_placement(4)
    d = torch.from_numpy(digits).to(devices[0])
    w = torch.from_numpy(wire).to(devices[0])
    list_fold = sharded_msm._gather_fold

    def stacked_fold(parts, placement, chips, audit):
        lead = placement[0]
        return msm.fold_shards(torch.stack([p.to(lead) for p in parts]),
                               arith="l20")

    def run(fold):
        sharded_msm._gather_fold = fold
        try:
            return sharded_msm.sharded_window_sums_many(d, w, 4,
                                                        devices=devices)
        finally:
            sharded_msm._gather_fold = list_fold

    forms = {"stacked": lambda: run(stacked_fold),
             "list": lambda: run(list_fold)}
    if not same_window_sums(forms["stacked"](), forms["list"]()):
        raise AssertionError("the stacked and the list mesh folds differ "
                             "as points")
    log(f"one cold D = 4 mesh dispatch, pod100k B={d.shape[0]} "
        f"N={d.shape[-1]}, placement {label}:")
    for name, fn in forms.items():
        dispatch_split(f"{name} fold", fn)
    times = {"stacked": [], "list": []}
    for _ in range(3):
        for name in ("stacked", "list", "list", "stacked"):
            times[name].append(cuda_ms(forms[name]))
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"  in turns (CUDA events): stacked {med['stacked']:.4f} ms "
        f"{times['stacked']}, list {med['list']:.4f} ms {times['list']}")
    print(json.dumps({"mesh_fold_turns": times}), flush=True)


def same_window_sums(a, b) -> bool:
    """Window sums (B, 4, 20, 33) equal as points, window by window."""
    from ed25519_consensus_tpu_torch.ops import limbs

    a, b = a.cpu().numpy(), b.cpu().numpy()
    return all(limbs.unpack_point(a[i, ..., w]) ==
               limbs.unpack_point(b[i, ..., w])
               for i in range(a.shape[0]) for w in range(a.shape[-1]))


def phase_routing(state: dict) -> None:
    """The routing model's constants on this card: `b` = the single lane's
    device seconds per term (slope of K1 + K2 + K3 over two lane counts at
    B = 4), `a` = the D = 2 mesh call's fixed cost (its intercept over the
    same two lane counts), operands already on the card."""
    import torch

    import numpy as np

    from ed25519_consensus_tpu_torch.ops import msm
    from ed25519_consensus_tpu_torch.parallel import sharded_msm

    staged = [state["pod100k"].clone()._stage(random.Random(700 + b))
              for b in range(MESH_DEPTH)]
    pad = max(sharded_msm.shard_pad(s.n_device_terms, 2) for s in staged)
    ops = [s.device_operands(lambda n: pad) for s in staged]
    d_all = torch.from_numpy(np.stack([o[0] for o in ops])).to(DEV)
    w_all = torch.from_numpy(np.stack([o[1] for o in ops])).to(DEV)
    devices, label = mesh_placement(2)

    def wall(fn, reps=5):
        fn()
        sync()
        ts = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            sync()
            ts.append(time.perf_counter() - t)
        return statistics.median(ts)

    sizes = [n - n % 128 for n in (pad // 8, pad)]
    single, mesh = [], []
    for n in sizes:
        d, w = d_all[..., :n].contiguous(), w_all[..., :n].contiguous()
        single.append((n, wall(lambda: msm.dispatch_window_sums_many(
            d, w, DEV))))
        mesh.append((n, wall(lambda: sharded_msm.sharded_window_sums_many(
            d, w, 2, devices=devices))))
    terms = [(n * MESH_DEPTH) for n, _ in single]
    b = (single[1][1] - single[0][1]) / (terms[1] - terms[0])
    slope = (mesh[1][1] - mesh[0][1]) / (terms[1] - terms[0])
    a = mesh[0][1] - slope * terms[0]
    log(f"routing constants (B = {MESH_DEPTH}, lanes {sizes[0]} and "
        f"{sizes[1]} per batch; mesh D = 2 {label}): single lane "
        f"{single[0][1] * 1e3:.3f} / {single[1][1] * 1e3:.3f} ms, mesh "
        f"{mesh[0][1] * 1e3:.3f} / {mesh[1][1] * 1e3:.3f} ms; "
        f"b = {b:.4e} s/term, a = {a:.4e} s "
        f"(mesh slope {slope:.4e} s/term)")
    state["routing"] = {"a": a, "b": b, "placement": label}


def tables_work(d, head_tables, r_tables, parts) -> Work:
    """Work K2t must do on these inputs: the digits, the head tables once
    (shared across the batch when TH = 1), the R tables and the partials
    written; the window additions of the nonzero digits, each stored
    table entry converted once and each partial out.  Only the stored
    entries 1.. are read (the copy in window_sums_u32.cuh and
    window_sums.cuh): entry 0, the identity, is not."""
    dig = plain_digits(d)
    B, nwin, _ = dig.shape
    nchunk = parts.shape[1]
    window_adds, neg_digits = window_work(dig, nchunk, 64)
    entries = (head_tables[:, 1:].numel() + r_tables[:, 1:].numel()) // 80
    nbytes = (d.numel() + 2 * (head_tables[:, 1:].numel()
                               + r_tables[:, 1:].numel())
              + parts.numel() * parts.element_size())
    conv, conv_mads = conversions(entries, B * nchunk * nwin)
    return adds_work(nbytes, window_adds, conv, conv_mads,
                     neg_digits * 2 * OPS_FE_NEG)


def hold_tables(report: dict, label: str, digits, head, head_tables,
                rwire, record: bool) -> None:
    """K4 and K2t on the card against their plain versions on the same
    operands, exactly: K4 on the R points; K2t with the head tables shared
    (TH = 1, batch stride 0) and per batch (TH = B); K2t's full-tables
    form (one shared table over all N lanes, no R tables) where every
    batch has the same points.  K2t's window sums must equal the
    head-resident dispatch's as points.  Then K1 on the R wire, K4 and K2t
    are timed beside their bounds (K4 and K2t into the JSON record if
    `record`; K1's record is the stacked B = 8 cold call's)."""
    import torch

    from ed25519_consensus_tpu_torch.ops import limbs, msm
    from ed25519_consensus_tpu_torch.ops import torch_decompress as TD

    d = torch.from_numpy(digits).to(DEV)
    ht = torch.from_numpy(head_tables).to(DEV)[None]
    rw = torch.from_numpy(rwire).to(DEV)
    B, _, N = d.shape
    n_head = ht.shape[-1]
    r_pts = TD.expand_compressed_points(rw)
    r_tbl = msm.multiples_tables(r_pts)
    parts = msm.window_partials_tables(d, ht, r_tbl)
    htB = ht.expand(B, -1, -1, -1, -1).contiguous()
    checks = [
        ("expand_compressed", r_pts, TD.expand_compressed_points_plain(rw)),
        ("build_tables", r_tbl, msm.build_tables_plain(r_pts)),
        ("window_sums_tables", parts,
         msm.window_partials_tables_plain(d, ht, r_tbl)),
        ("window_sums_tables", msm.window_partials_tables(d, htB, r_tbl),
         msm.window_partials_tables_plain(d, htB, r_tbl)),
    ]
    same_points = bool((rw == rw[:1]).all())
    if same_points:
        full = torch.cat([ht, r_tbl[:1]], dim=-1)
        k_full = msm.window_partials_tables(d, full)
        checks += [("window_sums_tables", k_full,
                    msm.window_partials_tables_plain(d, full)),
                   ("window_sums_tables", k_full, parts)]
    for name, got, want in checks:
        sync()
        err = int((got.int() - want.int()).abs().max())
        if err:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {label} (B={B}, N={N}): {err}")
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
    ws_t = msm.fold_partials(parts).cpu().numpy()
    ws_h = msm.dispatch_window_sums_many_cached(d, head, rw,
                                                DEV).cpu().numpy()
    n_bad = sum(limbs.unpack_point(ws_t[b, ..., w]) !=
                limbs.unpack_point(ws_h[b, ..., w])
                for b in range(B) for w in range(33))
    if n_bad:
        raise AssertionError(f"K2t window sums differ from the head-resident "
                             f"dispatch on {label}: {n_bad} windows")
    log(f"  {label} B={B} N={N} ({n_head} head lanes): K1 on the R wire, "
        f"K4 and K2t (TH = 1, "
        f"TH = B{', full-tables form' if same_points else ''}) equal their "
        f"plain versions (max |diff| 0); K2t's window sums equal the "
        f"head-resident dispatch's as points")
    cases = {
        "expand_compressed R wire": (
            lambda: TD.expand_compressed_points(rw),
            lambda: TD.expand_compressed_points_plain(rw), k1_work(rw)),
        "build_tables": (lambda: msm.multiples_tables(r_pts),
                         lambda: msm.build_tables_plain(r_pts),
                         k4_work(r_pts)),
        "window_sums_tables": (
            lambda: msm.window_partials_tables(d, ht, r_tbl),
            lambda: msm.window_partials_tables_plain(d, ht, r_tbl),
            tables_work(d, ht, r_tbl, parts)),
    }
    if same_points:
        # the full-tables form (TB = 1 over all N lanes): timed for the
        # log, the JSON record keeps the resident-tables form above
        cases["window_sums_tables full-tables form"] = (
            lambda: msm.window_partials_tables(d, full),
            lambda: msm.window_partials_tables_plain(d, full),
            tables_work(d, full, r_tbl[..., :0], parts))
    for name, (kern, plain, work) in cases.items():
        ms = cuda_ms(kern)
        pms = cuda_ms(plain)
        bms, by = bound_ms(work)
        log(f"  {label} B={B} N={N} {name:18s} kernel {ms:10.3f}  plain "
            f"{pms:10.3f}  bound {bms:8.4f} ({by}; {bound_note(work)})")
        if record and name in report:
            report[name].update(ms=ms, plain_ms=pms, bound_ms=bms,
                                bound_by=by)


def phase_tables_times(report: dict, state: dict) -> None:
    """K4 and K2t against their plain versions on the operands the
    resident-tables dispatches of the main path were given — the zcash10k
    chunk (B = 8, N = 10,176, 130 head lanes; the JSON record's times) and
    a cometbft128 chunk (B = 8, 258 head + 190 R lanes, 128 of them
    signatures) — and K4 against the host-built head tables as points;
    then each chunk's whole dispatch once under the profiler, split by
    kernel and copy (`dispatch_split`)."""
    import numpy as np
    import torch

    from ed25519_consensus_tpu_torch.ops import limbs, msm

    log("K4 / K2t vs plain versions on the resident-tables operands "
        "(exact), then times (median of 5, CUDA events), ms:")
    for label, v, record in (("zcash10k tables chunk", state["verifier"],
                              True),
                            ("cometbft128 tables chunk",
                             state["comet_verifier"], False)):
        staged = [v.clone()._stage(random.Random(500 + b))
                  for b in range(8)]
        head = staged[0].head_tensor()
        n_head = head.shape[-1]
        nr = msm.pad_lanes(staged[0].n_cached_terms) - n_head
        ops = [s.device_operands_cached(lambda n: n_head + nr)
               for s in staged]
        digits = np.stack([o[0] for o in ops])
        rwire = np.stack([o[1] for o in ops])
        host_tbl = staged[0].head_tables_tensor()
        hold_tables(report, label, digits, head, host_tbl, rwire, record)
        dispatch_split(f"{label}: one resident-tables dispatch (profiler)",
                       lambda: msm.dispatch_window_sums_many_tables(
                           digits, host_tbl, rwire, DEV))
        if record:
            state["tables_operands"] = (digits, host_tbl, rwire)
        state.setdefault("tables_rwire", {})[label] = rwire
        # K4 on the head points against the host-built tables: exact
        # against its plain version, equal to the host tables as points
        hp = torch.from_numpy(head[None]).to(DEV)
        k4 = msm.multiples_tables(hp)
        err = int((k4.int() - msm.build_tables_plain(hp).int()).abs().max())
        k4h = k4[0].cpu().numpy()
        n_bad = sum(limbs.unpack_point(k4h[k][..., j]) !=
                    limbs.unpack_point(host_tbl[k][..., j])
                    for k in range(msm.NTABLE) for j in range(n_head))
        log(f"  {label}: K4 on the {n_head} head points vs plain max "
            f"|diff| = {err}; entries unequal to the host-built "
            f"head_tables_tensor as points: {n_bad}/{msm.NTABLE * n_head}")
        if err or n_bad:
            raise AssertionError("K4 disagrees with the host-built tables")


# -- the kernel-lab path: every form of the window-sum kernel, the stage
# -- profile and the micro-probes ------------------------------------------

REPLACES = {
    "expand_compressed": "ed25519_consensus_tpu/ops/jnp_decompress.py:151",
    "window_sums": "ed25519_consensus_tpu/ops/pallas_msm.py:320",
    "window_sums_tables": "ed25519_consensus_tpu/ops/pallas_msm.py:320",
    "window_select_only": "ed25519_consensus_tpu/ops/pallas_msm.py:320",
    "fold_partials": "ed25519_consensus_tpu/ops/pallas_msm.py:424",
    "build_tables": "ed25519_consensus_tpu/ops/msm.py:194",
    "fold_shards": "ed25519_consensus_tpu/parallel/sharded_msm.py:139",
    "expand_affine": "ed25519_consensus_tpu/ops/msm.py:396",
    # no TPU kernel: the host's per-key [2^128]A (batch.py's
    # _shift128_for_key), moved onto the card
    "shift128_lanes": "ed25519_consensus_tpu/batch.py:133",
    "probe_chain": "tools/microbench_pallas.py:64",
    "probe_fmul": "tools/microbench_pallas.py:101",
    # the self-test of K2's and K2t's field arithmetic, which replaces the
    # TPU's field arithmetic (jnp_field.mul)
    "probe_fe8": "ed25519_consensus_tpu/ops/jnp_field.py:91",
    # one complete addition's latency: the TPU's point_add
    "probe_ge8": "ed25519_consensus_tpu/ops/jnp_edwards.py:33",
}


class Report(dict):
    """The per-kernel JSON record: a row per kernel name, made at first
    use with its source, the TPU kernel it replaces and no launches."""

    def __missing__(self, name):
        from ed25519_consensus_tpu_torch.ops import _cuda

        base = _cuda.base_of(name)
        row = {"name": name, "route": "cuda",
               "source": "ed25519_consensus_tpu_torch/csrc/"
                         + _cuda.kernel(base, name[len(base):]).source,
               "replaces": REPLACES[base.split("-")[0]], "launches": 0,
               "library_ms": None, "max_abs_err": 0}
        self[name] = row
        return row


def add_launches(report: dict, counts: dict) -> None:
    for name, n in counts.items():
        if n:
            report[name]["launches"] += n


def timed_result(fn, reps: int = 5):
    """(fn()'s result, median ms of `reps` more runs): the first call is
    the warm-up and the result held against the other version."""
    out = fn()
    sync()
    return out, cuda_ms(lambda: fn(), reps)


def hold_row(report: dict, name: str, kern, plain, work, plain_cache=None,
             plain_key=None, plain_reps: int = 3) -> dict:
    """Kernel `name` (kern()) against its plain version (plain()) on the
    same inputs, exactly; then both timed (median of 5 and of
    `plain_reps`, CUDA events) beside the bound of `work` (a Work, or
    (bytes, int32 operations)).  The row takes the numbers unless an earlier phase timed
    it at the main path's shape.  Plain versions that compute the same
    thing share one run through `plain_cache[plain_key]`."""
    got, ms = timed_result(kern)
    if plain_cache is not None and plain_key in plain_cache:
        want, pms = plain_cache[plain_key]
    else:
        want, pms = timed_result(plain, plain_reps)
        if plain_cache is not None:
            plain_cache[plain_key] = (want, pms)
    err = int((got.int() - want.int()).abs().max()) if got.numel() else 0
    if err or got.shape != want.shape:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"max |diff| {err}, shapes {tuple(got.shape)} "
                             f"{tuple(want.shape)}")
    bms, by = bound_ms(work)
    row = report[name]
    row["max_abs_err"] = max(row["max_abs_err"], err)
    if "ms" not in row:
        row.update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by)
    log(f"  {name:30s} kernel {ms:10.4f}  plain {pms:10.3f}  bound "
        f"{bms:8.4f} ({by}; {bound_note(work)}); max |diff| 0")
    return {"kernel_ms": ms, "plain_ms": pms, "bound_ms": bms,
            "bound_by": by}


def phase_variants(report: dict, state: dict) -> None:
    """The kernel lab's variant sweep at B = 8, N = 12,288 with the launch
    counts set to 0 just before it and read just after: every form
    parity-gated against the exact host MSM and timed.  Then each form's
    kernels on the sweep's operands against their plain versions (exact),
    timed beside their bounds, with ptxas's registers and spills; the
    `kernel_sweep` JSON line carries those beside the lab's own numbers."""
    import torch

    from ed25519_consensus_tpu_torch.ops import _cuda, msm
    from ed25519_consensus_tpu_torch.tools import kernel_lab

    dev = torch.device(DEV)
    t = time.perf_counter()
    operands = kernel_lab.sweep_operands(STACK_B, STACK_N, dev)
    log(f"sweep operands (B={STACK_B}, N={STACK_N}, both radixes) and the "
        f"exact host MSM in {time.perf_counter() - t:.1f} s")
    _cuda.reset_launch_counts()
    sweep = kernel_lab.exp_sweep(STACK_B, STACK_N, device=dev,
                                 operands=operands, emit=False)
    counts = _cuda.launch_counts()
    add_launches(report, counts)
    log(f"sweep launches: { {k: v for k, v in counts.items() if v} }")
    res = sweep["kernel_sweep"]["results"]
    failed = {n: r for n, r in res.items() if r.get("parity") != "ok"}
    if failed:
        raise AssertionError(f"sweep forms failed: {failed}")
    state["sweep_operands"] = operands
    ops, _ = operands
    ptx = state.get("ptxas", {})
    cache = {}
    tables = {}
    log("sweep forms vs plain versions at the sweep's shape (exact), then "
        "times (kernel median of 5, plain of 3; CUDA events), ms:")
    for name, entry, wb, kw, _pin in kernel_lab.SWEEP:
        d, e = ops[wb]
        base, suffix, chunk, W = kernel_lab.sweep_form(entry, wb, kw)
        kname = base + suffix
        fold = kw.get("fold_dtype", "int32")
        psize = 2 if fold == "int16" else 4
        nchunk = -(-STACK_N // chunk)
        if entry == "tables_full":
            if wb not in tables:
                kt = "build_tables" + ("-r32" if wb == 5 else "")
                pts1 = e[:1]
                tables[wb] = msm.multiples_tables(pts1, window_bits=wb)
                hold_row(report, kt,
                         lambda p=pts1, wb=wb: msm.multiples_tables(
                             p, window_bits=wb),
                         lambda p=pts1, wb=wb: msm.build_tables_plain(p, wb),
                         k4_work(pts1, wb), cache, ("K4", wb))
            tb = tables[wb]

            arith = kw.get("arith", "u32")

            def kern(d=d, tb=tb, wb=wb, W=W, arith=arith):
                return msm.window_partials_tables(d, tb, window_bits=wb,
                                                  win_chunk=W, arith=arith)

            def plain(d=d, tb=tb, wb=wb, W=W, arith=arith):
                return msm.window_partials_tables_plain(
                    d, tb, window_bits=wb, win_chunk=W, arith=arith)

            parts = kern()
            work = tables_work(d, tb, tb[..., :0], parts)
            key = ("K2t", wb, msm.u32_form(wb, win_chunk=W, arith=arith))
        else:
            kk = dict(kw)
            kk["win_chunk"] = W

            def kern(d=d, e=e, wb=wb, kk=kk):
                return msm.window_partials(d, e, window_bits=wb, **kk)

            pk = {k: v for k, v in kk.items()
                  if k in ("tbl_dtype", "fold_dtype", "body", "arith",
                           "win_chunk")}

            def plain(d=d, e=e, wb=wb, pk=pk, chunk=chunk):
                return msm.window_partials_plain(d, e, window_bits=wb,
                                                 chunk=chunk, **pk)

            parts = kern()
            work = k2_work(d, nchunk, chunk, psize)
            key = ("K2", wb, kk.get("tbl_dtype", "int16"), fold, chunk,
                   msm.u32_form(wb, kk.get("tbl_dtype", "int16"), fold,
                                kk.get("body", "rolled"), chunk, W,
                                kk.get("arith", "u32")))
        row = res[name]
        row.update(kernel=kname, plain_max_abs_err=0,
                   **hold_row(report, kname, kern, plain, work, cache, key))
        kf = "fold_partials" + "".join(
            tag for cond, tag in ((wb == 5, "-r32"),
                                  (fold == "int16", "-i16fold")) if cond)
        if kf not in cache:
            p_plain = cache[key][0]
            hold_row(report, kf, lambda p=parts: msm.fold_partials(p),
                     lambda p=p_plain: msm.fold_partials_plain(p),
                     fold_work(STACK_B, nchunk, msm.nwindows(wb), psize),
                     cache, kf)
        u = ptx.get(_cuda.kernel_symbol(base, suffix), {})
        row.update(registers=u.get("registers"),
                   spill_bytes=u.get("spill_stores", 0)
                   + u.get("spill_loads", 0) if u else None)
    print(json.dumps(sweep), flush=True)


def phase_knobs(report: dict, state: dict) -> None:
    """The main path's two kernel knobs: the stacked B = 8 zcash10k call
    (`dispatch_window_sums_many`) under ED25519_TPU_WIN_CHUNK=11 and under
    ED25519_TPU_PALLAS_BODY=hybrid, and the zcash10k resident-tables
    dispatch under ED25519_TPU_WIN_CHUNK=11, each with the launch counts
    set to 0 just before it and read just after: each must run the
    matching instantiation (the 20-limb kernels, `-l20`: the default K2 and
    K2t hold no other form) and not the default, give window sums equal to
    the unset knobs' as points (another order of additions), and verdicts
    equal to the host's."""
    import torch

    from ed25519_consensus_tpu_torch.config import override
    from ed25519_consensus_tpu_torch.ops import _cuda, limbs, msm
    from ed25519_consensus_tpu_torch.ops import torch_decompress as TD

    digits, wire = state["stack"]
    t_digits, t_head, t_rwire = state["tables_operands"]
    want = msm.dispatch_window_sums_many(digits, wire, DEV)
    want_t = msm.dispatch_window_sums_many_tables(t_digits, t_head, t_rwire,
                                                  DEV)
    cases = (
        ({"ED25519_TPU_WIN_CHUNK": "11"}, "stacked", "window_sums-l20-w11",
         "window_sums"),
        ({"ED25519_TPU_PALLAS_BODY": "hybrid"}, "stacked",
         "window_sums-hybrid", "window_sums"),
        ({"ED25519_TPU_WIN_CHUNK": "11"}, "tables",
         "window_sums_tables-l20-w11", "window_sums_tables"),
    )
    for env, path, kname, default in cases:
        with override(**env):
            _cuda.reset_launch_counts()
            if path == "stacked":
                ws = msm.dispatch_window_sums_many(digits, wire, DEV)
            else:
                ws = msm.dispatch_window_sums_many_tables(
                    t_digits, t_head, t_rwire, DEV)
            sync()
            counts = _cuda.launch_counts()
        add_launches(report, counts)
        ref = (want if path == "stacked" else want_t).cpu().numpy()
        host = ws.cpu().numpy()
        same = all(limbs.unpack_point(host[b, ..., w]) ==
                   limbs.unpack_point(ref[b, ..., w])
                   for b in range(host.shape[0]) for w in range(33))
        oks = [msm.combine_window_sums(host[b:b + 1]).mul_by_cofactor()
               .is_identity() for b in range(host.shape[0])]
        log(f"knob {env} on the {path} B={host.shape[0]} call: launches "
            f"{ {k: v for k, v in counts.items() if v} }; window sums equal "
            f"the default's as points: {same}; accepts {oks}")
        if DEV != "cpu" and (counts.get(kname, 0) != 1
                             or counts.get(default, 0)):
            raise AssertionError(f"knob {env} did not run {kname} alone")
        if not same or not all(oks):
            raise AssertionError(f"knob {env}: window sums or verdicts "
                                 f"differ from the default's and the host's")
    # the hybrid body's kernel row: the stacked call's operands
    d = torch.from_numpy(digits).to(DEV)
    pts = TD.expand_compressed_points(torch.from_numpy(wire).to(DEV))
    nchunk = -(-pts.shape[-1] // 64)
    hold_row(report, "window_sums-hybrid",
             lambda: msm.window_partials(d, pts, body="hybrid"),
             lambda: msm.window_partials_plain(d, pts, body="hybrid"),
             k2_work(d, nchunk))


def phase_profile_ledger(report: dict, state: dict) -> None:
    """The stage profile (tools/microbench.py profile_ledger) at B = 8,
    N = 12,288, with the launch counts set to 0 just before it and read
    just after; its `device_program_profile` JSON line is printed on a
    line of its own.  Then K2s against its plain version on the same
    operands (exact), timed beside its bound."""
    import torch

    from ed25519_consensus_tpu_torch.ops import _cuda, msm
    from ed25519_consensus_tpu_torch.tools import microbench

    ops, _ = state["sweep_operands"]
    d, e = ops[4]
    _cuda.reset_launch_counts()
    microbench.profile_ledger(STACK_B, STACK_N, device=torch.device(DEV),
                              operands=(d, e))
    counts = _cuda.launch_counts()
    add_launches(report, counts)
    need_launches("the stage profile", counts,
                  ("window_sums", "window_sums_tables",
                   "window_sums_tables-l20", "window_select_only",
                   "fold_partials"))
    tables = msm.multiples_tables(e)
    dig = plain_digits(d)
    nchunk = -(-STACK_N // 64)
    out_bytes = STACK_B * nchunk * 33 * 2 * 80 * 4
    hold_row(report, "window_select_only",
             lambda: msm.select_only(d, tables),
             lambda: msm.select_only_plain(d, tables),
             (d.numel() + tables[:, 1:].numel() * 2 + out_bytes,
              STACK_B * 33 * nchunk * 64 * 80 + int((dig < 0).sum()) * 40))


def phase_probes(report: dict, state: dict) -> None:
    """The micro-probes (tools/microbench.py) with the launch counts set to
    0 just before them and read just after: ns per int32 operation and µs
    per field multiply from the slope between two chain lengths.  Then each
    probe's kernel at its longer chain against its plain version (exact),
    timed beside its bound."""
    import numpy as np
    import torch

    from ed25519_consensus_tpu_torch.ops import _cuda, probes
    from ed25519_consensus_tpu_torch.tools import microbench

    _cuda.reset_launch_counts()
    state["probes"] = microbench.run_probes(torch.device(DEV))
    counts = _cuda.launch_counts()
    add_launches(report, counts)
    need_launches("the micro-probes", counts,
                  [f"probe_chain-{op}" for op in probes.CHAIN_OPS]
                  + ["probe_fmul", "probe_ge8"])
    S, L = 32, 128
    x = torch.from_numpy(np.arange(S * L, dtype=np.int32).reshape(S, L)
                         % 97).to(DEV)
    for op in probes.CHAIN_OPS:
        hold_row(report, f"probe_chain-{op}",
                 lambda op=op: probes.chain(x, op, 512),
                 lambda op=op: probes.chain_plain(x, op, 512),
                 (8 * S * L, 512 * S * L))
    xf = torch.from_numpy(np.arange(20 * S * L, dtype=np.int32)
                          .reshape(20, S, L) % 1000).to(DEV)
    hold_row(report, "probe_fmul", lambda: probes.fmul_chain(xf, 8),
             lambda: probes.fmul_chain_plain(xf, 8),
             (2 * 80 * S * L, 8 * S * L * OPS_FE_MUL))
    xg = torch.from_numpy(microbench.ge8_tile(1, 32)).to(DEV)
    hold_row(report, "probe_ge8", lambda: probes.ge8_chain(xg, 64),
             lambda: probes.ge8_chain_plain(xg.cpu(), 64).to(DEV),
             adds_work(2 * 320 * 32, 64 * 32,
                       *conversions(32, 32)), plain_reps=1)


def phase_old_new(report: dict, state: dict) -> None:
    """The 20-limb kernels (the lab's `-l20` forms) and the default ones
    on the 8 x 32-bit arithmetic, timed in turns on the same operands —
    old, new, new, old, three rounds, each time the median of 5 CUDA-event
    runs — with the launch counts set to 0 just before and read just
    after (the rows count the launches of the -l20 forms that only this
    phase runs): K1 on the stacked zcash10k wire (B = 8, N = 12,288)
    and on verify_gpu's (B = 1, N = 10,176); K2 on the stacked call; K3 on
    the stacked call's partials; K2t on the zcash10k resident-tables chunk
    (B = 8, N = 10,176, 130 head lanes); K4 on the R points of that chunk
    (B = 8, 10,046 lanes) and of the cometbft128 chunk (B = 8, 190 lanes);
    K5 on the pod100k D = 4 shard sums the mesh path gathered (the old on
    their stack, the new on the shard list, as each path passes them); K6
    on the affine pass's largest input.  Each pair is equal as points:
    K1's and K6's coordinates as canonical limbs, limb for limb; K2's and
    K2t's window sums folded by K3 and K3's and K5's sums, window by
    window; K4's tables entry by entry and lane by lane
    (`same_table_points`: the chain and the tree give other projective
    representatives of one point), the new tables' limbs canonical.  Each
    kernel's device time under the profiler beside (`device_ms`).  Then
    the -l20 forms of K1, K3, K4, K5 and K6 against their plain versions,
    timed beside their bounds.  Prints one `old_new` JSON line."""
    import torch

    from ed25519_consensus_tpu_torch.ops import _cuda, msm
    from ed25519_consensus_tpu_torch.ops import torch_decompress as TD
    from ed25519_consensus_tpu_torch.ops import torch_field as TF

    digits, wire = state["stack"]
    d = torch.from_numpy(digits).to(DEV)
    w8 = torch.from_numpy(wire).to(DEV)
    _, g_wire = state["verifier"]._stage(
        random.Random(101)).device_operands(msm.pad_lanes)
    w1 = torch.from_numpy(g_wire[None]).to(DEV)
    _cuda.reset_launch_counts()
    pts = TD.expand_compressed_points(w8)
    parts = msm.window_partials(d, pts)
    t_digits, t_head, t_rwire = state["tables_operands"]
    dt = torch.from_numpy(t_digits).to(DEV)
    ht = torch.from_numpy(t_head).to(DEV)[None]
    rt = msm.multiples_tables(TD.expand_compressed_points(
        torch.from_numpy(t_rwire).to(DEV)))
    r_pts = {label.split()[0]: TD.expand_compressed_points(
        torch.from_numpy(w).to(DEV))
        for label, w in state["tables_rwire"].items()}

    def same_points(a, b):
        canon = TF.canonical_limbs20(a.int().movedim(2, 0)).movedim(0, 2)
        return torch.equal(canon, b.int())

    def same_tables(a, b):
        flat = b.int().movedim(3, 0)
        return same_table_points(a, b) and torch.equal(
            TF.canonical_limbs20(flat), flat)

    pairs = {
        f"expand_compressed (B={w8.shape[0]}, N={w8.shape[-1]})": (
            lambda: TD.expand_compressed_points(w8, arith="l20"),
            lambda: TD.expand_compressed_points(w8), same_points),
        f"expand_compressed (B=1, N={w1.shape[-1]})": (
            lambda: TD.expand_compressed_points(w1, arith="l20"),
            lambda: TD.expand_compressed_points(w1), same_points),
        "window_sums": (
            lambda: msm.window_partials(d, pts, arith="l20"),
            lambda: msm.window_partials(d, pts),
            lambda a, b: same_window_sums(msm.fold_partials(a),
                                   msm.fold_partials(b))),
        "fold_partials": (
            lambda: msm.fold_partials(parts, arith="l20"),
            lambda: msm.fold_partials(parts), same_window_sums),
        "window_sums_tables": (
            lambda: msm.window_partials_tables(dt, ht, rt, arith="l20"),
            lambda: msm.window_partials_tables(dt, ht, rt),
            lambda a, b: same_window_sums(msm.fold_partials(a),
                                   msm.fold_partials(b))),
    }
    for chunk, p in r_pts.items():
        pairs[f"build_tables ({chunk} chunk, B={p.shape[0]}, "
              f"N={p.shape[-1]})"] = (
            lambda p=p: msm.multiples_tables(p, arith="l20"),
            lambda p=p: msm.multiples_tables(p), same_tables)
    shards = max(state["fold_shards_inputs"],
                 key=lambda x: len(x) * x[0].numel())
    gathered = torch.stack(shards)
    aff = max(state["expand_affine_inputs"], key=lambda x: x.numel())
    pairs[f"fold_shards (pod100k sums, D={len(shards)}, "
          f"B={shards[0].shape[0]})"] = (
        lambda: msm.fold_shards(gathered, arith="l20"),
        lambda: msm.fold_shards(shards), same_window_sums)
    pairs[f"expand_affine (B={aff.shape[0]}, N={aff.shape[-1]})"] = (
        lambda: msm.expand_affine_points(aff, arith="l20"),
        lambda: msm.expand_affine_points(aff), same_points)
    out = {}
    log("old (-l20) and new K1 / K2 / K3 / K2t / K4 / K5 / K6 in turns "
        "(old, new, new, old) x 3, each the median of 5 (CUDA events), ms:")
    for name, (old, new, equal) in pairs.items():
        if not equal(old(), new()):
            raise AssertionError(f"{name}: the -l20 and the new kernel "
                                 f"differ as points")
        times = {"old": [], "new": []}
        for _ in range(3):
            for which, fn in (("old", old), ("new", new), ("new", new),
                              ("old", old)):
                times[which].append(cuda_ms(fn))
        med = {k: statistics.median(v) for k, v in times.items()}
        dev = {"old": device_ms(old), "new": device_ms(new)}
        log(f"  {name}: old {med['old']:.4f} ms {times['old']}, new "
            f"{med['new']:.4f} ms {times['new']}; old / new "
            f"{med['old'] / med['new']:.3f}; equal as points; device time "
            f"(profiler, mean of 5) old {dev['old']:.4f} ms, new "
            f"{dev['new']:.4f} ms")
        out[name] = {"old_ms": times["old"], "new_ms": times["new"],
                     "old_median_ms": med["old"],
                     "new_median_ms": med["new"],
                     "old_device_ms": dev["old"],
                     "new_device_ms": dev["new"]}
    hold_row(report, "expand_compressed-l20",
             lambda: TD.expand_compressed_points(w8, arith="l20"),
             lambda: TD.expand_compressed_points_plain(w8, arith="l20"),
             k1_work(w8), plain_reps=1)
    hold_row(report, "fold_partials-l20",
             lambda: msm.fold_partials(parts, arith="l20"),
             lambda: msm.fold_partials_plain(parts, arith="l20"),
             fold_work(parts.shape[0], parts.shape[1], 33), plain_reps=1)
    zr = r_pts["zcash10k"]
    hold_row(report, "build_tables-l20",
             lambda: msm.multiples_tables(zr, arith="l20"),
             lambda: msm.build_tables_plain(zr, arith="l20"),
             k4_work(zr, arith="l20"), plain_reps=1)
    hold_row(report, "fold_shards-l20",
             lambda: msm.fold_shards(gathered, arith="l20"),
             lambda: msm.fold_shards_plain(gathered, arith="l20"),
             k5_work(len(shards), shards[0].shape[0]), plain_reps=1)
    hold_row(report, "expand_affine-l20",
             lambda: msm.expand_affine_points(aff, arith="l20"),
             lambda: msm.expand_affine_points_plain(aff, arith="l20"),
             k6_work(aff, arith="l20"), plain_reps=1)
    lab = ("expand_compressed-l20", "fold_partials-l20", "build_tables-l20",
           "fold_shards-l20", "expand_affine-l20")
    counts = _cuda.launch_counts()
    add_launches(report, {k: counts[k] for k in lab})
    need_launches("the old/new turns", counts, lab)
    print(json.dumps({"old_new": out}), flush=True)
    state["old_new"] = out


def phase_fe8(report: dict, state: dict) -> None:
    """The self-test of the fe8 field arithmetic of K1, K2, K2t and K3
    (probe_fe8, csrc/probes.cu; fe8_sq included) on every pair of the edge
    operands (0, 1, p − 1, p, p + 1, 2^255 − 1, 2^256 − 1, 2^256 − 19k,
    ...), the limbs20 vectors at ±8191
    and 256 random rows, with the launch counts set to 0 just before it
    and read just after: every output word equal to ops/fe_u32.py's, the
    exact-integer model; timed beside its bound.  Then the instructions of
    each operation in the built kernel's SASS (`cuobjdump -sass`, where
    the toolkit has it) beside the hand counts the bounds use."""
    import torch

    from ed25519_consensus_tpu_torch.ops import _cuda, probes
    from ed25519_consensus_tpu_torch.tools import ptxas_report

    x = torch.from_numpy(probes.fe8_operands(n_random=256)).to(DEV)
    _cuda.reset_launch_counts()
    got = probes.fe8_selftest(x)
    sync()
    counts = _cuda.launch_counts()
    add_launches(report, counts)
    need_launches("the fe8 self-test", counts, ("probe_fe8",))
    want = probes.fe8_selftest_plain(x.cpu())
    blocks = {"add": (0, 8), "sub": (8, 16), "neg": (16, 24),
              "mul": (24, 32), "from_limbs20": (32, 40),
              "to_limbs20_canonical": (40, 60), "ge8_add": (60, 92),
              "ge8_add neg": (92, 124), "sq": (124, 132)}
    g = got.cpu()
    bad = {k: int((g[:, a:b] != want[:, a:b]).any(dim=1).sum())
           for k, (a, b) in blocks.items()}
    log(f"probe_fe8 on {x.shape[0]} rows ({len(probes.FE8_EDGES) ** 2} "
        f"edge pairs): rows differing from the model, by operation: {bad}")
    if any(bad.values()):
        raise AssertionError("the fe8 self-test differs from the model")
    rows = x.shape[0]
    ops = (OPS8_FE_ADD + 2 * OPS8_FE_SUB + OPS8_FE_MUL + OPS8_FROM_LIMBS20
           + OPS8_TO_CANONICAL + 2 * OPS8_GE_ADD + OPS8_FE_SQ)
    mads = (MADS8_FE_ADD + MADS8_FE_MUL + MADS8_TO_CANONICAL + 1
            + 2 * MADS8_GE_ADD + MADS8_FE_SQ)
    hold_row(report, "probe_fe8", lambda: probes.fe8_selftest(x),
             lambda: probes.fe8_selftest_plain(x.cpu()).to(DEV),
             Work(rows * (probes.FE8_IN + probes.FE8_OUT) * 4, rows * ops,
                  rows * mads), plain_reps=1)
    hand = {"st_fe8_add": (OPS8_FE_ADD, MADS8_FE_ADD),
            "st_fe8_sub": (OPS8_FE_SUB, 0),
            "st_fe8_neg": (OPS8_FE_SUB, 0),
            "st_fe8_mul": (OPS8_FE_MUL, MADS8_FE_MUL),
            "st_fe8_from_limbs20": (OPS8_FROM_LIMBS20, 1),
            "st_fe8_to_limbs20_canonical": (OPS8_TO_CANONICAL,
                                            MADS8_TO_CANONICAL),
            "st_ge8_add": (OPS8_GE_ADD, MADS8_GE_ADD),
            "st_fe8_sq": (OPS8_FE_SQ, MADS8_FE_SQ)}
    sass = ptxas_report.sass_counts(_cuda.library_path("probes.cu"))
    if sass is None:
        log("SASS counts: no cuobjdump found (not measured)")
        return
    for fn, (ops_h, mads_h) in hand.items():
        c = sass.get(fn, {})
        log(f"  SASS {fn}: {c.get('instructions')} instructions, "
            f"{c.get('imad')} IMAD (hand count {ops_h} operations, "
            f"{mads_h} multiply-adds; the SASS adds the out-of-line call's "
            f"moves, loads and stores)")
    state["sass"] = sass


def sanitize_path() -> int:
    """Every kernel once at small shapes, each against its plain version:
    the run `compute-sanitizer` watches (python3 chip_smoke.py --sanitize
    under --tool memcheck, racecheck, initcheck and synccheck; README).
    K1, K2, K3, K4, K2t (TH = 1 and TH = B, the head boundary inside a
    chunk), K5 (both call forms), K6 (N = 200: 16-byte rows; N = 197: one
    int16 a thread); the cometbft128 tables chunk (B = 8, N = 448, 258 head
    lanes: chunk 4 straddles the head/R boundary) through K1, K4, K2t and
    K3; every sweep form of the kernel lab (K2, K2t, K3, K4 instantiations
    and windows per block), K2s, the probes and the -l20 forms of K1, K3,
    K4, K5 and K6; then the mesh_chaos storm and the traffic lab's
    --device run at small shapes.  Returns the number of kernels that
    differ, or tools whose gates fail."""
    import numpy as np
    import torch

    from ed25519_consensus_tpu_torch.ops import limbs, msm, probes
    from ed25519_consensus_tpu_torch.ops import torch_decompress as TD
    from ed25519_consensus_tpu_torch.tools import kernel_lab, microbench

    rng = random.Random(0x5A7)
    bad = []

    def check(label, got, want):
        sync()
        if got.shape != want.shape or not torch.equal(got.int(),
                                                      want.int()):
            bad.append(label)
        log(f"  {label}: {'equal' if label not in bad else 'DIFFERS'}")

    def wire(B, N):
        w, _ = random_wire(B * N, rng)
        return torch.from_numpy(np.ascontiguousarray(
            w.reshape(33, B, N).transpose(1, 0, 2))).to(DEV)

    B, N = 2, 200
    w = wire(B, N)
    pts = TD.expand_compressed_points(w)
    check("K1 expand_compressed", pts, TD.expand_compressed_points_plain(w))
    check("K1 expand_compressed-l20", TD.expand_compressed_points(
        w, arith="l20"), TD.expand_compressed_points_plain(w, arith="l20"))
    d = adversarial_digits(B, N, seed=9)
    dp = torch.from_numpy(np.stack([limbs.pack_digit_planes(x)
                                    for x in d])).to(DEV)
    parts = msm.window_partials(dp, pts)
    check("K2 window_sums", parts, msm.window_partials_plain(dp, pts))
    check("K3 fold_partials", msm.fold_partials(parts),
          msm.fold_partials_plain(parts))
    check("K3 fold_partials-l20", msm.fold_partials(parts, arith="l20"),
          msm.fold_partials_plain(parts, arith="l20"))
    tbl = msm.multiples_tables(pts)
    check("K4 build_tables", tbl, msm.build_tables_plain(pts))
    check("K4 build_tables-l20", msm.multiples_tables(pts, arith="l20"),
          msm.build_tables_plain(pts, arith="l20"))
    for th in (1, B):
        head = tbl[:th, ..., :130].contiguous()
        r = tbl[..., 130:].contiguous()
        check(f"K2t window_sums_tables TH={th}",
              msm.window_partials_tables(dp, head, r),
              msm.window_partials_tables_plain(dp, head, r))
    ws = msm.fold_partials(parts)
    shards = [ws, msm.fold_partials(msm.window_partials(dp.flip(0), pts)),
              ws]
    g = torch.stack(shards)
    check("K5 fold_shards (list)", msm.fold_shards(shards),
          msm.fold_shards_plain(shards))
    check("K5 fold_shards (stacked)", msm.fold_shards(g),
          msm.fold_shards_plain(g))
    check("K5 fold_shards-l20", msm.fold_shards(g, arith="l20"),
          msm.fold_shards_plain(g, arith="l20"))
    for aff in (pts[:, :2].contiguous(), pts[:, :2, :, :197].contiguous()):
        for arith in ("u32", "l20"):
            check(f"K6 expand_affine {arith} N={aff.shape[-1]}",
                  msm.expand_affine_points(aff, arith=arith),
                  msm.expand_affine_points_plain(aff, arith=arith))

    # the cometbft128 tables chunk: 258 head lanes, 190 R lanes
    B, N, n_head = 8, 448, 258
    head_pts = TD.expand_compressed_points(wire(1, n_head))
    head_tables = msm.multiples_tables(head_pts)
    rw = wire(B, N - n_head)
    r_pts = TD.expand_compressed_points(rw)
    check("cometbft128 chunk K1 (R wire)", r_pts,
          TD.expand_compressed_points_plain(rw))
    r_tbl = msm.multiples_tables(r_pts)
    check("cometbft128 chunk K4", r_tbl, msm.build_tables_plain(r_pts))
    dc = torch.from_numpy(np.stack([
        limbs.pack_digit_planes(x)
        for x in adversarial_digits(B, N, 10)])).to(DEV)
    pc = msm.window_partials_tables(dc, head_tables, r_tbl)
    check("cometbft128 chunk K2t", pc,
          msm.window_partials_tables_plain(dc, head_tables, r_tbl))
    check("cometbft128 chunk K3", msm.fold_partials(pc),
          msm.fold_partials_plain(pc))

    # every sweep form at B = 2, N = 200, K2s and the probes
    ops = {}
    for wb in (4, 5):
        _, _, dg, ext = kernel_lab.build_operands(200, B=2, window_bits=wb)
        ops[wb] = (torch.from_numpy(dg).to(DEV),
                   torch.from_numpy(ext).to(DEV))
    for name, entry, wb, kw, _pin in kernel_lab.SWEEP:
        dg, ext = ops[wb]
        if entry == "tables_full":
            t1 = msm.multiples_tables(ext[:1], window_bits=wb)
            check(f"{name} K4", t1, msm.build_tables_plain(ext[:1], wb))
            arith = kw.get("arith", "u32")
            p = msm.window_partials_tables(dg, t1, window_bits=wb,
                                           win_chunk=kw["win_chunk"],
                                           arith=arith)
            want = msm.window_partials_tables_plain(
                dg, t1, window_bits=wb, win_chunk=kw["win_chunk"],
                arith=arith)
        else:
            kk = dict(kw)
            chunk = kernel_lab.sweep_form(entry, wb, kk)[2]
            p = msm.window_partials(dg, ext, window_bits=wb, **kk)
            want = msm.window_partials_plain(
                dg, ext, window_bits=wb, chunk=chunk,
                **{k: v for k, v in kk.items()
                   if k in ("tbl_dtype", "fold_dtype", "body", "arith",
                            "win_chunk")})
        check(f"{name} K2/K2t", p, want)
        check(f"{name} K3", msm.fold_partials(p), msm.fold_partials_plain(p))
    dg, ext = ops[4]
    t2 = msm.multiples_tables(ext)
    check("K2s window_select_only", msm.select_only(dg, t2),
          msm.select_only_plain(dg, t2))
    x = torch.from_numpy(np.arange(8 * 128, dtype=np.int32)
                         .reshape(8, 128) % 97).to(DEV)
    for op in probes.CHAIN_OPS:
        check(f"probe_chain-{op}", probes.chain(x, op, 64),
              probes.chain_plain(x, op, 64))
    xf = torch.from_numpy(np.arange(20 * 8 * 128, dtype=np.int32)
                          .reshape(20, 8, 128) % 1000).to(DEV)
    check("probe_fmul", probes.fmul_chain(xf, 2),
          probes.fmul_chain_plain(xf, 2))
    xs = torch.from_numpy(probes.fe8_operands(n_random=8)).to(DEV)
    check("probe_fe8", probes.fe8_selftest(xs),
          probes.fe8_selftest_plain(xs.cpu()).to(DEV))
    xg = torch.from_numpy(microbench.ge8_tile(1, 64)).to(DEV)
    check("probe_ge8", probes.ge8_chain(xg, 4),
          probes.ge8_chain_plain(xg.cpu(), 4).to(DEV))
    # The federation's tools at small shapes (4-key batches): the mesh
    # chaos storm (K1, K2, K3 on 8, 4 and 2 logical shards, K5, the single
    # lane) and the single-service --device lab (K1, K2, K4, K2t, K3).
    from ed25519_consensus_tpu_torch.tools import mesh_chaos, traffic_lab

    storm = mesh_chaos.run_reformation_storm(mesh_chaos.DEFAULT_SEED,
                                             devices=8, device=DEV)
    lab = traffic_lab.run(traffic_lab.parse_args(
        ["--device", "--torch-device", DEV, "--requests", "40",
         "--service-rate", "50000", "--no-require-rpc-shed"]))
    for label, ok in (("mesh_chaos storm", storm["ok"]),
                      ("traffic_lab --device", lab["ok"])):
        if not ok:
            bad.append(label)
        log(f"  {label}: {'gates hold' if ok else 'GATES FAIL'}")
    log(f"sanitize: {len(bad)} kernels differ from their plain versions"
        + (f": {bad}" if bad else ""))
    return len(bad)


COLD_START = r"""
import json, random, sys, time
import torch
from ed25519_consensus_tpu_torch import SigningKey, batch

rng = random.Random(7)
keys = [SigningKey.new(rng) for _ in range(8)]


def make():
    bv = batch.Verifier()
    for i in range(256):
        sk = keys[i % 8]
        msg = b"cold-start-%d" % i
        bv.queue((sk.verification_key_bytes(), sk.sign(msg), msg))
    return bv


make().verify(backend="host")  # the native host runtime, built here
torch.zeros(1, device="cuda")  # the CUDA context
calls = []
for _ in range(2):
    vs = [make() for _ in range(2)]
    t = time.perf_counter()
    oks = batch.verify_many(vs, hybrid=False, merge="never", mesh=0)
    calls.append(time.perf_counter() - t)
    assert oks == [True, True], oks
print(json.dumps({"first_call_s": calls[0], "second_call_s": calls[1]}))
"""


def cold_start_path(checkouts: list) -> int:
    """A verdict path's first call with an empty kernel cache, in each
    checkout of `checkouts` in turn: its `build/` (the kernel cache) is
    removed, then a fresh process builds the native host runtime, makes
    the CUDA context and times two `verify_many` calls on two 256-signature
    batches, device only — the first builds and loads the kernels the
    path needs, the second is warm.  Prints one `cold_start` line each."""
    import shutil

    for checkout in checkouts:
        root = Path(checkout).resolve()
        shutil.rmtree(root / "build", ignore_errors=True)
        t = time.perf_counter()
        p = subprocess.run([sys.executable, "-c", COLD_START], cwd=root,
                           capture_output=True, text=True, timeout=600,
                           env={**os.environ,
                                "PYTHONPATH": str(root)})
        wall = time.perf_counter() - t
        if p.returncode:
            log(f"cold start in {root} failed:\n{p.stdout}\n{p.stderr}")
            return 1
        row = json.loads(p.stdout.strip().splitlines()[-1])
        libs = sorted(f.name.split("-")[0]
                      for f in (root / "build").glob("*.so"))
        print(json.dumps({"cold_start": {"checkout": str(root),
                                         "process_s": wall, **row,
                                         "built": libs}}), flush=True)
    return 0


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "ed25519_consensus_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--cold-start"]:
        return cold_start_path(sys.argv[2:] or [str(ROOT)])
    sys.path.insert(0, str(ROOT))
    from ed25519_consensus_tpu_torch.ops import _cuda, msm

    t0 = time.perf_counter()
    smi = smi_line()
    log(f"device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")

    t = time.perf_counter()
    built = _cuda.build_all()
    times = ", ".join(f"{k} {r['seconds']:.1f} s" for k, r in built.items())
    log(f"build: {time.perf_counter() - t:.1f} s wall for {len(built)} "
        f"sources, one nvcc each, in parallel ({times})")
    state = {"ptxas": {}}
    for name, r in built.items():
        usage = _cuda.ptxas_usage(r["log"])
        state["ptxas"].update(usage)
        for sym, u in sorted(usage.items()):
            log(f"  ptxas {name} {sym}: {u.get('registers')} registers, "
                f"spill stores {u.get('spill_stores')} B, spill loads "
                f"{u.get('spill_loads')} B")
    from ed25519_consensus_tpu_torch.tools import ptxas_report

    for sym in ptxas_report.FE8_BLOCKS:
        u = state["ptxas"].get(sym)
        if u:
            log("  " + ptxas_report.usage_line("resident", sym, u))

    if sys.argv[1:2] == ["--sanitize"]:
        return 1 if sanitize_path() else 0
    phase_native(state)
    if sys.argv[1:2] == ["--stress-tables"]:
        reps, seconds = int(sys.argv[2]), float(sys.argv[3])
        return 1 if stress_tables_path(reps, seconds) else 0
    report = Report()
    if sys.argv[1:2] == ["--shift128"]:
        phase_shift128(report, state)
        print(smi_line())
        return 0

    def timed(phase, *args):
        t = time.perf_counter()
        phase(*args)
        log(f"[{phase.__name__}: {time.perf_counter() - t:.1f} s]")

    timed(phase_kernels, report)
    timed(phase_main_path, report, state)
    timed(phase_stream, report, state)
    timed(phase_mesh, report, state)
    timed(phase_affine, report, state)
    timed(phase_vectors, report)
    timed(phase_service, report, state)
    timed(phase_soak, state)
    timed(phase_verdict_soaks, state)
    timed(phase_restart, state)
    timed(phase_gray, state)
    timed(phase_federation, state)
    timed(phase_analysis, state)
    for path in ("stream", "mesh", "affine", "service", "verdict_soaks",
                 "restart", "gray", "federation", "analysis"):
        no_lab_forms(f"the {path} path", state[f"{path}_launches"])
        add_launches(report, state[f"{path}_launches"])
        log(f"{path} path launches (all passes): "
            f"{ {k: v for k, v in state[f'{path}_launches'].items() if v} }")
    timed(phase_times, report, state)
    timed(phase_shift128, report, state)
    timed(phase_tables_times, report, state)
    timed(phase_mesh_kernels, report, state)
    timed(phase_routing, state)
    timed(phase_profile, state)
    timed(phase_old_new, report, state)
    timed(phase_fe8, report, state)
    timed(phase_variants, report, state)
    timed(phase_knobs, report, state)
    timed(phase_profile_ledger, report, state)
    timed(phase_probes, report, state)
    from ed25519_consensus_tpu_torch import batch

    if not batch._DeviceLane.reset_all(timeout=60.0):
        raise AssertionError("a device-lane worker did not stop")

    keys = ["name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"]
    rows = [row for row in report.values() if row["launches"]]
    launched = {_cuda.base_of(row["name"]) for row in rows}
    never = sorted(set(_cuda.INSTANTIATIONS) - launched)
    untimed = [row["name"] for row in rows if any(k not in row for k in keys)]
    if never or untimed:
        raise AssertionError(f"instantiations never launched on a path: "
                             f"{never}; kernels launched but not held and "
                             f"timed: {untimed}")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{k: row[k] for k in keys}
                                  for row in rows]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
