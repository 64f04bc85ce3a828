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

    python3 chip_smoke.py
    python3 chip_smoke.py --stress-tables REPS SECONDS

The second form only runs the cometbft128 per-commit stream again and again
(`stress_tables_path`) and exits nonzero if the device ever rejected a batch
the host accepts.

Exits nonzero, and prints no result, without a CUDA device, outside a
checkout of the repository, when the native runtime does not build or fails
its self-check, or when any phase fails.  Its last line is
`{"ok": true, "device": {...}}`; the line before it is the card's name and
power limit, and the one before that the per-kernel JSON record (launch
counts on the two paths, errors against the plain versions, times and
bounds)."""

import json
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
# K1 per lane (csrc/expand_compressed.cu): squarings y^2, v^2, (v^3)^2 and
# the 251 of the pow22523 ladder; multiplies d*y^2, v^2*v, v^6*v, u*v^7,
# the ladder's 11, u*v^3, *t1 and x*y; plus u and v.  The flip multiply
# and the neg subtraction are counted per lane from the hints.
K1_SQS_PER_LANE = 3 + 251
K1_MULS_PER_LANE = 4 + 11 + 3
K1_ADDS_PER_LANE = 2

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


def bound_ms(nbytes: float, ops: float) -> "tuple[float, str]":
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


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
    log(f"single-batch path launches: {counts}")
    for name, n in counts.items():
        report[name]["launches"] = n
        if n == 0 and name in SLICE0_KERNELS:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"single-batch path")
    state["stack"] = (digits, wire)
    state["verifier"] = bv
    state["tampered"] = tampered
    state["adv"] = adv


def k1_work(w):
    """(bytes, int32 ops) K1 must move and do on the wire w (B, 33, N)
    uint8: it expands every lane, with the flip multiply and the neg
    subtraction counted from the hints."""
    B, _, N = w.shape
    hints = w[:, 32].int()
    flips = int((hints & 1).sum())
    negs = int(((hints >> 1) & 1).sum())
    return (B * N * (33 + 160),
            B * N * (K1_SQS_PER_LANE * OPS_FE_SQ
                     + K1_MULS_PER_LANE * OPS_FE_MUL
                     + K1_ADDS_PER_LANE * OPS_FE_ADD)
            + flips * OPS_FE_MUL + negs * OPS_FE_ADD)


def kernel_work(d, w, parts):
    """(bytes, int32 ops) each kernel must move and do on these inputs:
    digits d (B, 17, N) uint8, wire w (B, 33, N) uint8, K2's partials.
    Counted from the data: K1 as k1_work; K2 builds a lane's table only up
    to its largest |digit| and adds only the nonzero digits of a (chunk,
    window), negating the negative ones; K3 takes nchunk - 1 additions per
    (b, window)."""
    import torch

    from ed25519_consensus_tpu_torch.ops import msm

    B, _, N = d.shape
    nchunk = parts.shape[1]
    k1 = k1_work(w)
    dig = msm.expand_digits(d).int()  # (B, 33, N)
    table_adds = int((dig.abs().amax(dim=1) - 1).clamp(min=0).sum())
    pad = nchunk * msm.CHUNK - N
    nnz = torch.nn.functional.pad((dig != 0).int(), (0, pad)).reshape(
        B, msm.NWINDOWS, nchunk, msm.CHUNK).sum(dim=-1)
    window_adds = int((nnz - 1).clamp(min=0).sum())
    neg_digits = int((dig < 0).sum())
    k2 = (B * N * (17 + 160) + B * nchunk * 33 * 320,
          (table_adds + window_adds) * OPS_GE_ADD
          + neg_digits * 2 * OPS_FE_NEG)
    k3 = (B * nchunk * 33 * 320 + B * 33 * 320,
          B * 33 * max(nchunk - 1, 0) * OPS_GE_ADD)
    return {"expand_compressed": k1, "window_sums": k2,
            "fold_partials": k3}


def hold_and_time(report: dict, label: str, digits, wire,
                  timed: bool) -> None:
    """K1, K2 and K3 on the card against their plain versions on the same
    operands, which must agree exactly; then, if `timed`, both timed
    (median of 5, CUDA events) beside each kernel's bound."""
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
        nbytes, ops = work[name]
        ms = cuda_ms(kern)
        pms = cuda_ms(plain)
        bms, by = bound_ms(nbytes, ops)
        log(f"  {label} B={B} N={N} {name:18s} kernel {ms:10.3f}  plain "
            f"{pms:10.3f}  bound {bms:8.4f} ({by}, {ops:.4e} int32 ops, "
            f"{nbytes:.4e} B)")
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
    `verify_gpu` shape and at B = 8."""
    from ed25519_consensus_tpu_torch.ops import msm

    log("kernels vs plain versions at the main path's shapes (exact), "
        "then times (median of 5, CUDA events), ms:")
    # The operands of the second zcash10k verify_gpu and of the
    # adversarial verify_gpu: the same staging, the same seeds.
    for label, verifier, seed, timed in (
            ("zcash10k verify_gpu", state["verifier"], 101, True),
            ("adversarial verify_gpu", state["adv"], 5, False)):
        digits, wire = verifier._stage(random.Random(seed)).device_operands(
            msm.pad_lanes)
        hold_and_time(report, label, digits[None], wire[None], timed)
    digits, wire = state["stack"]
    hold_and_time(report, "stacked zcash10k", digits[:1], wire[:1], True)
    hold_and_time(report, "stacked zcash10k", digits, wire, True)


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
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us, ev.key, ev.count))
    busy = sum(us for us, _, _ in rows) / 1e6
    if not rows:
        log("profiled verify_gpu: the profiler captured no device time "
            "(device busy share not measured)")
        return
    log(f"profiled verify_gpu: wall {wall:.3f} s, device busy "
        f"{busy * 1e3:.3f} ms, idle share {1 - busy / wall:.5f}")
    for us, key, count in sorted(rows, reverse=True)[:8]:
        log(f"  {us / 1e3:9.3f} ms  x{count}  {key[:70]}")


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
    """The first input tensor of each shape among recorded calls."""
    first = {}
    for (x, *_), _out in calls:
        first.setdefault(tuple(x.shape), x)
    return list(first.values())


def hold_recorded_tables(label: str, calls) -> None:
    """Every tables-resident dispatch a path made held, on the card,
    against its plain versions run on the same operands, kernel by kernel
    on the recomputed intermediates: K1 on the R wire, K4, K2t, K3 — and
    the path's own result against the plain chain's, exactly.  A
    difference fails the run, naming the chunk, its batches and the
    kernels that differ."""
    import torch

    from ed25519_consensus_tpu_torch.ops import msm
    from ed25519_consensus_tpu_torch.ops import torch_decompress as TD

    t = time.perf_counter()
    bad = []
    for c, ((digits, head, rwire, *_), out) in enumerate(calls):
        d = msm.as_tensor(digits, DEV)
        rw = msm.as_tensor(rwire, DEV)
        ht = head[None]
        ext = TD.expand_compressed_points_plain(rw)
        tbl = msm.build_tables_plain(ext)
        part = msm.window_partials_tables_plain(d, ht, tbl)
        want = msm.fold_partials_plain(part)
        if torch.equal(out, want):
            continue
        rows = [b for b in range(out.shape[0])
                if not torch.equal(out[b], want[b])]
        kernels = {
            "K1": torch.equal(TD.expand_compressed_points(rw), ext),
            "K4": torch.equal(msm.multiples_tables(ext), tbl),
            "K2t": torch.equal(msm.window_partials_tables(d, ht, tbl), part),
            "K3": torch.equal(msm.fold_partials(part), want),
            "the dispatch again": torch.equal(
                msm.dispatch_window_sums_many_tables(digits, head, rwire,
                                                     DEV), want)}
        log(f"  {label} chunk {c}: batches {rows} differ from the plain "
            f"versions (max |diff| {int((out - want).abs().max())}); on the "
            f"same operands again, equal to the plain version: {kernels}")
        bad.append(c)
    sync()
    log(f"  {label}: {len(calls) - len(bad)}/{len(calls)} tables "
        f"dispatches of the path equal their plain versions (K1, K4, K2t, "
        f"K3; exact), held in {time.perf_counter() - t:.1f} s")
    if bad:
        raise AssertionError(f"{label}: device window sums differ from the "
                             f"plain versions in chunks {bad}")


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
    """K5 and K6 against their plain versions on the first operands the
    mesh and affine paths gave them (exact), then timed beside their
    bounds; and K1, K2, K3 held on one pod100k mesh shard's operands."""
    from ed25519_consensus_tpu_torch.ops import msm
    from ed25519_consensus_tpu_torch.parallel import sharded_msm

    log("K5 / K6 vs plain versions on the path's operands (exact, every "
        "shape), then times at the largest (median of 5, CUDA events), ms:")
    for name, xs, kern, plain in (
            ("fold_shards", state["fold_shards_inputs"], msm.fold_shards,
             msm.fold_shards_plain),
            ("expand_affine", state["expand_affine_inputs"],
             msm.expand_affine_points, msm.expand_affine_points_plain)):
        for x in xs:
            err = int((kern(x).int() - plain(x).int()).abs().max())
            if err:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version at {tuple(x.shape)}: {err}")
        log(f"  {name}: equal to its plain version at "
            f"{[tuple(x.shape) for x in xs]}")
    g = max(state["fold_shards_inputs"], key=lambda x: x.numel())
    a = max(state["expand_affine_inputs"], key=lambda x: x.numel())
    D, B = g.shape[:2]
    Ba, _, _, Na = a.shape
    cases = {
        "fold_shards": (lambda: msm.fold_shards(g),
                        lambda: msm.fold_shards_plain(g),
                        (D * B * 33 * 320 + B * 33 * 320,
                         B * 33 * max(D - 1, 0) * OPS_GE_ADD),
                        f"D={D} B={B}"),
        "expand_affine": (lambda: msm.expand_affine_points(a),
                          lambda: msm.expand_affine_points_plain(a),
                          (Ba * Na * (80 + 160), Ba * Na * OPS_FE_MUL),
                          f"B={Ba} N={Na}"),
    }
    for name, (kern, plain, (nbytes, ops), shape) in cases.items():
        got, want = kern(), plain()
        sync()
        err = int((got.int() - want.int()).abs().max())
        if err:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"({shape}): {err}")
        ms = cuda_ms(kern)
        pms = cuda_ms(plain)
        bms, by = bound_ms(nbytes, ops)
        log(f"  {shape} {name:14s} kernel {ms:10.4f}  plain {pms:10.3f}  "
            f"bound {bms:8.5f} ({by}, {ops:.4e} int32 ops, {nbytes:.4e} B)"
            f"; max |diff| 0")
        report[name].update(max_abs_err=err, ms=ms, plain_ms=pms,
                            bound_ms=bms, bound_by=by)
    # One pod100k shard's operands as the D = 4 mesh gives them.
    staged = [state["pod100k"].clone()._stage(random.Random(600 + b))
              for b in range(MESH_DEPTH)]
    pad = max(sharded_msm.shard_pad(s.n_device_terms, 4) for s in staged)
    ops = [s.device_operands(lambda n: pad) for s in staged]
    per = pad // 4
    import numpy as np

    digits = np.ascontiguousarray(np.stack([o[0] for o in ops])[..., :per])
    wire = np.ascontiguousarray(np.stack([o[1] for o in ops])[..., :per])
    hold_and_time(report, "pod100k D=4 shard 0", digits, wire, False)


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


def tables_work(d, head_tables, r_tables, parts):
    """(bytes, int32 ops) K2t must move and do on these inputs: the digits,
    the head tables once (shared across the batch when TH = 1), the R
    tables and the partials written; the window additions of the nonzero
    digits and their negations."""
    import torch

    from ed25519_consensus_tpu_torch.ops import msm

    B, _, N = d.shape
    nchunk = parts.shape[1]
    dig = msm.expand_digits(d).int() if d.dtype == torch.uint8 else d.int()
    pad = nchunk * msm.CHUNK - N
    nnz = torch.nn.functional.pad((dig != 0).int(), (0, pad)).reshape(
        B, msm.NWINDOWS, nchunk, msm.CHUNK).sum(dim=-1)
    window_adds = int((nnz - 1).clamp(min=0).sum())
    neg_digits = int((dig < 0).sum())
    nbytes = (d.numel() + 2 * (head_tables.numel() + r_tables.numel())
              + B * nchunk * 33 * 320)
    return nbytes, window_adds * OPS_GE_ADD + neg_digits * 2 * OPS_FE_NEG


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
    nb_k4 = r_pts.numel() * 2 + r_tbl.numel() * 2
    ops_k4 = B * r_pts.shape[-1] * (msm.NTABLE - 1) * OPS_GE_ADD
    cases = {
        "expand_compressed R wire": (
            lambda: TD.expand_compressed_points(rw),
            lambda: TD.expand_compressed_points_plain(rw), k1_work(rw)),
        "build_tables": (lambda: msm.multiples_tables(r_pts),
                         lambda: msm.build_tables_plain(r_pts),
                         (nb_k4, ops_k4)),
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
    for name, (kern, plain, (nbytes, ops)) in cases.items():
        ms = cuda_ms(kern)
        pms = cuda_ms(plain)
        bms, by = bound_ms(nbytes, ops)
        log(f"  {label} B={B} N={N} {name:18s} kernel {ms:10.3f}  plain "
            f"{pms:10.3f}  bound {bms:8.4f} ({by}, {ops:.4e} int32 ops, "
            f"{nbytes:.4e} B)")
        if record and name in report:
            report[name].update(ms=ms, plain_ms=pms, bound_ms=bms,
                                bound_by=by)


def phase_tables_times(report: dict, state: dict) -> None:
    """K4 and K2t against their plain versions on the operands the
    resident-tables dispatches of the main path were given — the zcash10k
    chunk (B = 8, N = 10,176, 130 head lanes; the JSON record's times) and
    a cometbft128 chunk (B = 8, 258 head + 190 R lanes, 128 of them
    signatures) — and K4 against the host-built head tables as points."""
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
    sys.path.insert(0, str(ROOT))
    from ed25519_consensus_tpu_torch.ops import _cuda

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
    for name, r in built.items():
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    state = {}
    phase_native(state)
    if sys.argv[1:2] == ["--stress-tables"]:
        reps, seconds = int(sys.argv[2]), float(sys.argv[3])
        return 1 if stress_tables_path(reps, seconds) else 0
    sources = {k.name: f"ed25519_consensus_tpu_torch/csrc/{k.source}"
               for k in _cuda.KERNELS.values()}
    replaces = {
        "expand_compressed":
            "ed25519_consensus_tpu/ops/jnp_decompress.py:151",
        "window_sums": "ed25519_consensus_tpu/ops/pallas_msm.py:320",
        "fold_partials": "ed25519_consensus_tpu/ops/pallas_msm.py:424",
        "window_sums_tables": "ed25519_consensus_tpu/ops/pallas_msm.py:320",
        "build_tables": "ed25519_consensus_tpu/ops/msm.py:194",
        "fold_shards":
            "ed25519_consensus_tpu/parallel/sharded_msm.py:139",
        "expand_affine": "ed25519_consensus_tpu/ops/msm.py:396",
    }
    report = {name: {"name": name, "route": "cuda", "source": sources[name],
                     "replaces": replaces[name], "library_ms": None,
                     "max_abs_err": 0}
              for name in sources}
    def timed(phase, *args):
        t = time.perf_counter()
        phase(*args)
        log(f"[{phase.__name__}: {time.perf_counter() - t:.1f} s]")

    timed(phase_kernels, report)
    timed(phase_main_path, report, state)
    timed(phase_stream, report, state)
    timed(phase_mesh, report, state)
    timed(phase_affine, report, state)
    for path in ("stream", "mesh", "affine"):
        for name, n in state[f"{path}_launches"].items():
            report[name]["launches"] += n
        log(f"{path} path launches (all passes): "
            f"{state[f'{path}_launches']}")
    timed(phase_times, report, state)
    timed(phase_tables_times, report, state)
    timed(phase_mesh_kernels, report, state)
    timed(phase_routing, state)
    timed(phase_profile, state)
    from ed25519_consensus_tpu_torch import batch

    if not batch._DeviceLane.reset_all(timeout=60.0):
        raise AssertionError("a device-lane worker did not stop")

    keys = ["name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"]
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{k: report[n][k] for k in keys}
                                  for n in sources]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
