"""Device multiscalar multiplication Σ[c_i]P_i — the batch-verification hot
path (reference src/batch.rs:207-210), on an H100.

Algorithm (the JAX package's ops/msm.py): **transposed windowed Straus over
uniform 128-bit scalars**.  Every term's scalar is brought under 2^128 on
the host (`split_terms`: c = c_lo + 2^128·c_hi becomes [c_lo]P +
[c_hi]([2^128]P)) and recoded to NWINDOWS = 33 MSB-first signed radix-16
digits d_{i,w} ∈ [-8, 7]:

    Σ_i [c_i]P_i  =  Σ_w 16^(32-w) · S_w,    S_w = Σ_i [d_{i,w}] T_i

with T_i the [0..8]P_i multiples table.  The device computes only the 33
window sums S_w; the Horner combine (`combine_window_sums`) and every
accept/reject decision stay in exact host integers.

A cold device call is three kernels (csrc/), each with its plain PyTorch
version beside its wrapper:

  K1 `expand_compressed` (ops/torch_decompress.py) — compressed wire →
     extended points, when the points come compressed;
  K2 `window_sums` (`window_partials`) — per 64-lane chunk, per window, the
     complete-addition sum of the selected table entries, with the packed
     digits decoded in the load;
  K3 `fold_partials` (`fold_partials`) — the group fold of the chunk
     partials to (B, 4, NLIMBS, 33) int32.

A keyset resident in the device operand cache (devcache.py) takes one of
two hot dispatches: the head-resident one (`dispatch_window_sums_many_
cached`: K1 on the R wire, the resident head broadcast beside it, K2, K3)
or the tables-resident one (`dispatch_window_sums_many_tables`):

  K4 `build_tables` (`multiples_tables`) — the [0..8]P tables of K1's R
     points;
  K2t `window_sums_tables` (`window_partials_tables`) — K2's window phase
     on prebuilt tables: the resident head tables, shared across the
     batch, and K4's R tables; then K3.

Two more kernels serve the affine wire and the sharded mesh
(parallel/sharded_msm.py):

  K6 `expand_affine` (`expand_affine_points`) — the affine wire, X‖Y limbs,
     → extended points with Z = 1 and T = X·Y, in place of K1;
  K5 `fold_shards` (`fold_shards`) — the cross-shard group fold of the
     per-shard window sums gathered onto the placement's first device.

The plain versions take the kernels' additions in the kernels' order, so
kernel and plain version agree limb for limb.  Against the JAX package's
window sums they agree as group elements (projectively), not limb for limb:
the fold order differs.

Public entry points take `device=None`, meaning "cuda", and raise when no
CUDA device exists and the caller did not ask for the CPU.
"""

import threading

import numpy as np
import torch

from .. import config as _config
from . import _cuda
from . import limbs
from . import torch_edwards as E
from . import torch_field as F
from .edwards import Point, shift128
from .limbs import NLIMBS, NWINDOWS, PACKED_WINDOWS
from .torch_decompress import expand_compressed_points

MASK128 = (1 << 128) - 1
# Lanes per K2 block (csrc/window_sums.cu CHUNK), and threads per K3 block
# (csrc/fold_partials.cu THREADS): the plain versions mirror both.
CHUNK = 64
HALF = CHUNK // 2
FOLD_THREADS = 32
# Entries of a multiples table, [0..8]P.
NTABLE = 9

# Every device call (launches and the blocking fetch) holds this lock, so
# two threads — the verify_many lane worker and a direct caller — never
# interleave their calls into one device.  Reentrant: the lane worker holds
# it across a dispatch and its fetch, and the dispatches take it again.
DEVICE_CALL_LOCK = threading.RLock()

# (n_batches, n_lanes, mesh, variant) shapes that have COMPLETED at least
# one device call this process.  The lane builds and loads every kernel
# before it starts (batch._DeviceLane.get), but a shape's first call still
# pays the device's lazy set-up, so the scheduler gives a shape the longer
# first-call deadline until its first call completes.  Variants: 0 cold,
# 1 resident-head, 2 resident-tables dispatch.
_shapes_completed = set()


def mark_shape_completed(n_batches: int, n_lanes: int, mesh: int = 0,
                         cached: "bool | int" = False) -> None:
    _shapes_completed.add((int(n_batches), int(n_lanes), int(mesh or 0),
                           int(cached)))


def shape_completed(n_batches: int, n_lanes: int, mesh: int = 0,
                    cached: "bool | int" = False) -> bool:
    return (int(n_batches), int(n_lanes), int(mesh or 0),
            int(cached)) in _shapes_completed


def resolve_device(device=None) -> torch.device:
    """`None` means "cuda"; a CUDA device that does not exist raises — the
    port never falls back to the CPU unless asked to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def pad_lanes(n: int) -> int:
    """Lane count for n terms: a multiple of the K2 chunk (the kernel masks
    a ragged edge too, but a whole chunk costs the same), at least
    ED25519_TPU_MIN_LANES when that knob is set."""
    n = max(n, _config.get("ED25519_TPU_MIN_LANES") or 0)
    return max(CHUNK, -(-n // CHUNK) * CHUNK)


def split_terms(scalars, points):
    """Reduce arbitrary-width (≤ 2^256) scalars to uniform 128-bit terms.

    Each term with c ≥ 2^128 becomes [c & MASK128]P + [c >> 128]([2^128]P)."""
    out_s, out_p = [], []
    for c, pt in zip(scalars, points):
        c = int(c)
        hi = c >> 128
        out_s.append(c & MASK128)
        out_p.append(pt)
        if hi:
            out_s.append(hi)
            out_p.append(shift128(pt))
    return out_s, out_p


def pack_msm_operands(scalars, points, n_lanes: int | None = None):
    """Pack 128-bit (scalars, host Points) into padded numpy operands:
    digits (NWINDOWS, N) int8 and extended points (4, NLIMBS, N) int16,
    N = pad_lanes(len).  Padding terms are scalar 0 on the identity."""
    scalars = [int(s) for s in scalars]
    if len(scalars) != len(points):
        raise ValueError("scalar/point length mismatch")
    n = len(scalars)
    N = n_lanes if n_lanes is not None else pad_lanes(n)
    if N < n:
        raise ValueError("n_lanes must be ≥ len(scalars)")
    digits = np.zeros((NWINDOWS, N), dtype=np.int8)
    pts = limbs.identity_point_batch(N)
    if n:
        digits[:, :n] = limbs.pack_scalar_windows(scalars)
        pts[..., :n] = limbs.pack_point_batch(points).astype(np.int16)
    return digits, pts


def combine_window_sums(window_sums) -> Point:
    """Exact host Horner combine of the per-window sums (MSB first):
    acc ← [16]acc + S_w.  Accepts a leading singleton batch axis."""
    ws = np.asarray(window_sums)
    if ws.ndim == 4:
        if ws.shape[0] != 1:
            raise ValueError("combine_window_sums takes one batch")
        ws = ws[0]
    acc = Point(0, 1, 1, 0)
    for w in range(ws.shape[-1]):
        for _ in range(limbs.WINDOW_BITS):
            acc = acc.double()
        acc = acc.add(limbs.unpack_point(ws[..., w]))
    return acc


# -- digit planes ----------------------------------------------------------

def expand_digits(digits):
    """Nibble-packed digit planes, uint8 (..., PACKED_WINDOWS, N) →
    (..., NWINDOWS, N) int8 signed digits in [-8, 7].  Packed row w holds
    plane 2w in its low nibble and plane 2w+1 in its high nibble; the final
    carry plane rides alone in the low nibble of row 16.  K2 decodes the
    same way in its digit load; this is the plain version's decode."""
    x = digits.to(torch.int32)
    lo = ((x & 0xF) ^ 8) - 8
    hi = (((x >> 4) & 0xF) ^ 8) - 8
    half = NWINDOWS // 2
    pair = torch.stack([lo[..., :half, :], hi[..., :half, :]], dim=-2)
    head = pair.reshape(x.shape[:-2] + (2 * half, x.shape[-1]))
    return torch.cat([head, lo[..., half:, :]], dim=-2).to(torch.int8)


def _check_digits(digits, B: int, N: int) -> bool:
    """Validates a digit wire; returns True for the packed form."""
    if digits.dtype == torch.uint8:
        rows, packed = PACKED_WINDOWS, True
    elif digits.dtype == torch.int8:
        rows, packed = NWINDOWS, False
    else:
        raise ValueError(f"digits must be uint8 (packed) or int8 (plain), "
                         f"got {digits.dtype}")
    if tuple(digits.shape) != (B, rows, N):
        raise ValueError(f"digits must be {(B, rows, N)}, got "
                         f"{tuple(digits.shape)}")
    return packed


def _check_points(points):
    if points.dtype != torch.int16 or points.ndim != 4 \
            or tuple(points.shape[1:3]) != (4, NLIMBS):
        raise ValueError(f"points must be (B, 4, {NLIMBS}, N) int16, got "
                         f"{tuple(points.shape)} {points.dtype}")


# -- K2: per-chunk window partials -----------------------------------------

def window_partials_plain(digits, points):
    """Plain PyTorch version of K2: digits (B, 17, N) uint8 or (B, 33, N)
    int8, points (B, 4, NLIMBS, N) int16 → partials (B, nchunk, 33, 4,
    NLIMBS) int32.  Same tables (T1 = P, Tk = T(k-1) + P, stored int16),
    same selection, same addition order as csrc/window_sums.cu."""
    B, _, _, N = points.shape
    if _check_digits(digits, B, N):
        digits = expand_digits(digits)
    Np = -(-N // CHUNK) * CHUNK
    pts = torch.zeros((4, NLIMBS, B, Np), dtype=torch.int32,
                      device=points.device)
    pts[1, 0] = 1
    pts[2, 0] = 1
    pts[..., :N] = points.permute(1, 2, 0, 3)
    # tables: (9, 4, NLIMBS, B, Np), entry 0 the identity
    ents = [E.identity_like(pts), pts]
    for _ in range(7):
        ents.append(E.point_add(ents[-1], pts).to(torch.int16)
                    .to(torch.int32))
    return _partials_from_tables(torch.stack(ents), digits, N)


def _partials_from_tables(tbl, digits, N: int):
    """The window phase shared by K2's and K2t's plain versions: tables
    (9, 4, NLIMBS, B, Np) int32 with entry 0 the identity and every lane
    past N the identity, plain digits (B, 33, N) → (B, nchunk, 33, 4,
    NLIMBS) int32, each half-chunk summed lane by lane, then the halves."""
    B, Np = tbl.shape[3], tbl.shape[4]
    nchunk = Np // CHUNK
    dig = torch.zeros((B, NWINDOWS, Np), dtype=torch.int32,
                      device=tbl.device)
    dig[..., :N] = digits
    sel = _select(tbl, dig)  # (4, NLIMBS, B, 33, Np)
    sel = sel.reshape(4, NLIMBS, B, NWINDOWS, nchunk, 2, HALF).permute(
        0, 1, 2, 4, 3, 5, 6)
    acc = sel[..., 0]
    for lane in range(1, HALF):
        acc = E.point_add(acc, sel[..., lane])
    acc = E.point_add(acc[..., 0], acc[..., 1])  # (4, NLIMBS, B, nchunk, 33)
    return acc.permute(2, 3, 4, 0, 1).contiguous()


def _select(tbl, dig):
    """sign(d)·T[|d|] for every (b, w, lane) of tables (9, 4, NLIMBS, B,
    Np) and digits (B, 33, Np): (4, NLIMBS, B, 33, Np) int32, X and T
    negated for negative digits."""
    idx = dig.abs().long().unsqueeze(0).unsqueeze(0).expand(
        (4, NLIMBS) + tuple(dig.shape))
    sel = torch.gather(tbl.permute(1, 2, 3, 0, 4), 3, idx)
    sgn = torch.where(dig < 0, -1, 1).to(torch.int32)
    sel[0] *= sgn
    sel[3] *= sgn
    return sel


def window_partials(digits, points):
    """K2 wrapper: launches csrc/window_sums.cu on CUDA tensors, runs
    `window_partials_plain` on CPU tensors."""
    _check_points(points)
    B, _, _, N = points.shape
    packed = _check_digits(digits, B, N)
    if points.device.type == "cpu" and digits.device.type == "cpu":
        return window_partials_plain(digits, points)
    if points.device.type != "cuda" or digits.device != points.device:
        raise ValueError(f"digits on {digits.device} and points on "
                         f"{points.device}: both must be on one CUDA "
                         f"device or both on the CPU")
    digits, points = digits.contiguous(), points.contiguous()
    nchunk = -(-N // CHUNK)
    out = torch.empty((B, nchunk, NWINDOWS, 4, NLIMBS), dtype=torch.int32,
                      device=points.device)
    if B * nchunk:
        _cuda.KERNELS["window_sums"].launch(
            points.device, digits.data_ptr(), int(packed),
            points.data_ptr(), out.data_ptr(), B, N)
    return out


# -- K2t: window partials from prebuilt tables ----------------------------

def _check_tables(tables, name: str):
    if tables.dtype != torch.int16 or tables.ndim != 5 or \
            tuple(tables.shape[1:4]) != (NTABLE, 4, NLIMBS):
        raise ValueError(f"{name} must be (*, {NTABLE}, 4, {NLIMBS}, n) "
                         f"int16, got {tuple(tables.shape)} {tables.dtype}")


def _tables_operands(digits, head_tables, r_tables):
    """Validates K2t's operands; returns (B, n_head, N, packed, r_tables)
    with an empty R table tensor standing in for None."""
    _check_tables(head_tables, "head_tables")
    B = digits.shape[0]
    n_head = head_tables.shape[4]
    if r_tables is None:
        r_tables = torch.empty((B, NTABLE, 4, NLIMBS, 0), dtype=torch.int16,
                               device=head_tables.device)
    _check_tables(r_tables, "r_tables")
    N = n_head + r_tables.shape[4]
    if head_tables.shape[0] not in (1, B) or r_tables.shape[0] != B:
        raise ValueError(f"head tables batch {head_tables.shape[0]} and R "
                         f"tables batch {r_tables.shape[0]} do not fit "
                         f"B = {B} (head: 1 or B; R: B)")
    packed = _check_digits(digits, B, N)
    return B, n_head, N, packed, r_tables


def window_partials_tables_plain(digits, head_tables, r_tables=None):
    """Plain PyTorch version of K2t: digits (B, 17 | 33, N), head tables
    (TH, 9, 4, NLIMBS, n_head) int16 with TH ∈ {1, B}, R tables (B, 9, 4,
    NLIMBS, N − n_head) int16 (None when n_head = N) → partials (B, nchunk,
    33, 4, NLIMBS) int32.  The same selection and additions as K2's plain
    version on the given tables; entry 0 is taken as the identity, never
    read from the tensors (the kernel never stores or reads it)."""
    B, n_head, N, packed, r_tables = _tables_operands(
        digits, head_tables, r_tables)
    if packed:
        digits = expand_digits(digits)
    Np = -(-N // CHUNK) * CHUNK
    tbl = torch.zeros((NTABLE, 4, NLIMBS, B, Np), dtype=torch.int32,
                      device=r_tables.device)
    tbl[:, 1:3, 0] = 1  # the identity, kept in entry 0 and past lane N
    tbl[1:, ..., :n_head] = head_tables[:, 1:].permute(1, 2, 3, 0, 4)
    tbl[1:, ..., n_head:N] = r_tables[:, 1:].permute(1, 2, 3, 0, 4)
    return _partials_from_tables(tbl, digits, N)


def window_partials_tables(digits, head_tables, r_tables=None):
    """K2t wrapper: launches window_sums_tables (csrc/window_sums.cu) on
    CUDA tensors, runs `window_partials_tables_plain` on CPU tensors.
    TH = 1 head tables are shared by every batch (batch stride 0)."""
    B, n_head, N, packed, r_tables = _tables_operands(
        digits, head_tables, r_tables)
    devs = {digits.device, head_tables.device, r_tables.device}
    if devs == {torch.device("cpu")}:
        return window_partials_tables_plain(digits, head_tables, r_tables)
    if len(devs) != 1 or digits.device.type != "cuda":
        raise ValueError(f"digits, head tables and R tables on {devs}: all "
                         f"must be on one CUDA device or all on the CPU")
    digits = digits.contiguous()
    head_tables = head_tables.contiguous()
    r_tables = r_tables.contiguous()
    nchunk = -(-N // CHUNK)
    out = torch.empty((B, nchunk, NWINDOWS, 4, NLIMBS), dtype=torch.int32,
                      device=digits.device)
    if B * nchunk:
        _cuda.KERNELS["window_sums_tables"].launch(
            digits.device, digits.data_ptr(), int(packed),
            head_tables.data_ptr(), int(head_tables.shape[0] != 1),
            n_head, r_tables.data_ptr(), out.data_ptr(), B, N)
    return out


# -- K4: multiples tables --------------------------------------------------

def build_tables_plain(points):
    """Plain PyTorch version of K4: extended points (B, 4, NLIMBS, N) int16
    → tables (B, 9, 4, NLIMBS, N) int16, entry 0 the identity, entry k =
    entry (k−1) + P — the reference's table_scan, step for step."""
    pts = points.permute(1, 2, 0, 3).to(torch.int32)  # (4, NLIMBS, B, N)
    ents = [E.identity_like(pts)]
    for _ in range(NTABLE - 1):
        ents.append(E.point_add(ents[-1], pts))
    return torch.stack(ents).to(torch.int16).permute(3, 0, 1, 2, 4) \
        .contiguous()


def multiples_tables(points):
    """K4 wrapper: launches build_tables (csrc/build_tables.cu) on a CUDA
    tensor, runs `build_tables_plain` on a CPU tensor."""
    _check_points(points)
    if points.device.type == "cpu":
        return build_tables_plain(points)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    points = points.contiguous()
    B, _, _, N = points.shape
    out = torch.empty((B, NTABLE, 4, NLIMBS, N), dtype=torch.int16,
                      device=points.device)
    if B * N:
        _cuda.KERNELS["build_tables"].launch(
            points.device, points.data_ptr(), out.data_ptr(), B, N)
    return out


def build_multiples_tables(points, device=None):
    """The multiples tables of a batch of extended points, (B, 4, NLIMBS,
    N) int16 (numpy or tensor) → (B, 9, 4, NLIMBS, N) int16 tensor on
    `device` (None means CUDA): row 0 the identity, row k the exact [k]P,
    equal byte for byte to the reference's build_multiples_tables."""
    return multiples_tables(as_tensor(points, resolve_device(device)))


# -- K3: fold of the chunk partials ----------------------------------------

def fold_partials_plain(partials):
    """Plain PyTorch version of K3: (B, nchunk, 33, 4, NLIMBS) int32 →
    (B, 4, NLIMBS, 33) int32.  Same order as csrc/fold_partials.cu:
    accumulator t < FOLD_THREADS starts from chunk t and adds chunks
    t + 32, t + 64, ...; the live accumulators then meet in a halving tree.
    nchunk - 1 additions per (b, window); no chunks give the identity."""
    B, nchunk = partials.shape[:2]
    p = partials.permute(3, 4, 0, 2, 1)  # (4, NLIMBS, B, 33, nchunk)
    T = FOLD_THREADS
    live = min(nchunk, T)
    if not live:
        out = torch.zeros((B, 4, NLIMBS, NWINDOWS), dtype=torch.int32,
                          device=p.device)
        out[:, 1, 0] = 1
        out[:, 2, 0] = 1
        return out
    acc = p[..., :live].clone()
    for lo in range(T, nchunk, T):
        n = min(T, nchunk - lo)
        acc[..., :n] = E.point_add(acc[..., :n], p[..., lo:lo + n])
    s = T // 2
    while s:
        if live > s:
            m = live - s
            acc = torch.cat([E.point_add(acc[..., :m], acc[..., s:live]),
                             acc[..., m:s]], dim=-1)
            live = s
        s //= 2
    return acc[..., 0].permute(2, 0, 1, 3).contiguous()


def fold_partials(partials):
    """K3 wrapper: launches csrc/fold_partials.cu on a CUDA tensor, runs
    `fold_partials_plain` on a CPU tensor."""
    if partials.dtype != torch.int32 or partials.ndim != 5 or \
            tuple(partials.shape[2:]) != (NWINDOWS, 4, NLIMBS):
        raise ValueError(f"partials must be (B, nchunk, {NWINDOWS}, 4, "
                         f"{NLIMBS}) int32, got {tuple(partials.shape)} "
                         f"{partials.dtype}")
    if partials.device.type == "cpu":
        return fold_partials_plain(partials)
    if partials.device.type != "cuda":
        raise ValueError(f"unsupported device {partials.device}")
    partials = partials.contiguous()
    B, nchunk = partials.shape[:2]
    out = torch.empty((B, 4, NLIMBS, NWINDOWS), dtype=torch.int32,
                      device=partials.device)
    if B:
        _cuda.KERNELS["fold_partials"].launch(
            partials.device, partials.data_ptr(), out.data_ptr(), B, nchunk)
    return out


# -- K5: the cross-shard fold ----------------------------------------------

def _check_window_sums(ws, name: str, ndim: int):
    if ws.dtype != torch.int32 or ws.ndim != ndim or \
            tuple(ws.shape[-3:]) != (4, NLIMBS, NWINDOWS):
        raise ValueError(f"{name} must be (..., 4, {NLIMBS}, {NWINDOWS}) "
                         f"int32 of rank {ndim}, got {tuple(ws.shape)} "
                         f"{ws.dtype}")


def fold_shards_plain(gathered):
    """Plain PyTorch version of K5: gathered per-shard window sums (D, B,
    4, NLIMBS, 33) int32 → (B, 4, NLIMBS, 33) int32, shard 0 plus shards 1,
    2, ... in order by complete addition (D − 1 additions; D = 0 gives the
    identity), as csrc/fold_partials.cu fold_shards_kernel takes them."""
    g = gathered.permute(0, 2, 3, 1, 4)  # (D, 4, NLIMBS, B, 33)
    if not g.shape[0]:
        out = torch.zeros(gathered.shape[1:], dtype=torch.int32,
                          device=gathered.device)
        out[:, 1, 0] = 1
        out[:, 2, 0] = 1
        return out
    acc = g[0]
    for d in range(1, g.shape[0]):
        acc = E.point_add(acc, g[d])
    return acc.permute(2, 0, 1, 3).contiguous()


def fold_shards(gathered):
    """K5 wrapper: launches fold_shards (csrc/fold_partials.cu) on a CUDA
    tensor, runs `fold_shards_plain` on a CPU tensor.  A group fold by
    complete additions — never an elementwise limb add."""
    _check_window_sums(gathered, "gathered shard sums", 5)
    if gathered.device.type == "cpu":
        return fold_shards_plain(gathered)
    if gathered.device.type != "cuda":
        raise ValueError(f"unsupported device {gathered.device}")
    gathered = gathered.contiguous()
    D, B = gathered.shape[:2]
    out = torch.empty((B, 4, NLIMBS, NWINDOWS), dtype=torch.int32,
                      device=gathered.device)
    if B:
        _cuda.KERNELS["fold_shards"].launch(
            gathered.device, gathered.data_ptr(), out.data_ptr(), D, B)
    return out


# -- K6: the affine point wire ---------------------------------------------

def expand_affine_points_plain(points):
    """Plain PyTorch version of K6: (B, 2, NLIMBS, N) int16 X‖Y limbs →
    (B, 4, NLIMBS, N) int16 with Z = 1 and T = X·Y (one torch_field.mul;
    the product's limbs stay inside |limb| ≤ 8191, so the int16 cast is
    exact)."""
    X = points[:, 0].to(torch.int32).transpose(0, 1)  # (NLIMBS, B, N)
    Y = points[:, 1].to(torch.int32).transpose(0, 1)
    T = F.mul(X, Y)
    Z = torch.zeros_like(X)
    Z[0] = 1
    return torch.stack([X, Y, Z, T]).permute(2, 0, 1, 3).to(
        torch.int16).contiguous()


def _check_affine(points):
    if points.dtype != torch.int16 or points.ndim != 4 \
            or tuple(points.shape[1:3]) != (2, NLIMBS):
        raise ValueError(f"affine points must be (B, 2, {NLIMBS}, N) int16, "
                         f"got {tuple(points.shape)} {points.dtype}")


def expand_affine_points(points):
    """K6 wrapper: (B, 2, NLIMBS, N) int16 affine wire → (B, 4, NLIMBS, N)
    int16 extended points.  Launches csrc/expand_affine.cu on a CUDA
    tensor, runs `expand_affine_points_plain` on a CPU tensor."""
    _check_affine(points)
    if points.device.type == "cpu":
        return expand_affine_points_plain(points)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    points = points.contiguous()
    B, _, _, N = points.shape
    out = torch.empty((B, 4, NLIMBS, N), dtype=torch.int16,
                      device=points.device)
    if B * N:
        _cuda.KERNELS["expand_affine"].launch(
            points.device, points.data_ptr(), out.data_ptr(), B, N)
    return out


def expand_affine_points_single(points):
    """Unbatched affine expansion: (2, NLIMBS, N) → (4, NLIMBS, N)."""
    return expand_affine_points(points[None])[0]


# Device point wires, told apart by the batched points' second axis:
#   "extended"   (B, 4, NLIMBS, N) int16 — X‖Y‖Z‖T limbs
#   "affine"     (B, 2, NLIMBS, N) int16 — X‖Y limbs; Z and T by K6
#   "compressed" (B, 33, N) uint8 — encodings + hint byte; x by K1
def wire_of(points) -> str:
    c = points.shape[1]
    if c == 33:
        return "compressed"
    if c == 2:
        return "affine"
    return "extended"


def expand_points(points, wire: "str | None" = None):
    """Any batched point wire → (B, 4, NLIMBS, N) int16 extended points:
    K1 for the compressed wire, K6 for the affine one."""
    wire = wire_of(points) if wire is None else wire
    if wire == "compressed":
        return expand_compressed_points(points)
    if wire == "affine":
        return expand_affine_points(points)
    return points


def expand_points_single(points, wire: "str | None" = None):
    """Unbatched wire expansion: (33, N) or (2 | 4, NLIMBS, N) →
    (4, NLIMBS, N)."""
    return expand_points(points[None], wire)[0]


# -- the dispatch ----------------------------------------------------------

def as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def dispatch_window_sums_many(digits, points, device=None):
    """One device call for B stacked batches: digits (B, 17, N) uint8
    packed or (B, 33, N) int8 plain; points in any wire — (B, 33, N) uint8
    compressed, (B, 2, NLIMBS, N) int16 affine or (B, 4, NLIMBS, N) int16
    extended (numpy arrays or tensors) → (B, 4, NLIMBS, 33) int32 tensor on
    `device`.  On CUDA: K1 (compressed) or K6 (affine), K2, K3."""
    dev = resolve_device(device)
    digits = as_tensor(digits, dev)
    points = as_tensor(points, dev)
    with DEVICE_CALL_LOCK:
        return fold_partials(window_partials(digits, expand_points(points)))


def dispatch_window_sums(digits, points, device=None):
    """Single-batch form: (17|33, N) digits and (33, N) | (4, NLIMBS, N)
    points → (1, 4, NLIMBS, 33) tensor (combine_window_sums accepts the
    leading singleton)."""
    dev = resolve_device(device)
    return dispatch_window_sums_many(as_tensor(digits, dev)[None],
                                     as_tensor(points, dev)[None], dev)


def dispatch_window_sums_many_cached(digits, head, rwire, device=None):
    """The dispatch for a keyset whose head operands are resident: digits
    (B, 17 | 33, N) for all N = n_head + n_r lanes, `head` the entry's
    (4, NLIMBS, n_head) int16 tensor, `rwire` (B, 33, n_r) the per-
    signature compressed R encodings → (B, 4, NLIMBS, 33) int32.  K1
    expands the R wire, the head is broadcast beside it over the batch
    (a tensor copy), then K2 and K3 run as on the cold path — the same
    window-sum math, only where the head bytes came from differs."""
    dev = resolve_device(device)
    digits = as_tensor(digits, dev)
    head = as_tensor(head, dev)
    rwire = as_tensor(rwire, dev)
    with DEVICE_CALL_LOCK:
        r_pts = expand_compressed_points(rwire)
        pts = torch.cat([head[None].expand(rwire.shape[0], -1, -1, -1),
                         r_pts], dim=-1)
        return fold_partials(window_partials(digits, pts))


def dispatch_window_sums_many_tables(digits, head_tables, rwire,
                                     device=None):
    """The dispatch for a keyset whose head multiples TABLES are resident:
    digits (B, 17 | 33, N) for all N = n_head + n_r lanes, `head_tables`
    the entry's (9, 4, NLIMBS, n_head) int16 tensor, `rwire` (B, 33, n_r)
    → (B, 4, NLIMBS, 33) int32.  K1 expands the R wire, K4 builds the R
    lanes' tables, K2t sums the windows with the head tables shared across
    the batch (TH = 1), K3 folds.  The head tables are never rebuilt."""
    dev = resolve_device(device)
    digits = as_tensor(digits, dev)
    head_tables = as_tensor(head_tables, dev)
    rwire = as_tensor(rwire, dev)
    with DEVICE_CALL_LOCK:
        r_tbl = multiples_tables(expand_compressed_points(rwire))
        return fold_partials(window_partials_tables(
            digits, head_tables[None], r_tbl))


class PendingMSM:
    """An in-flight device MSM: `result()` waits for the window sums, then
    Horner-combines them in exact host integers."""

    __slots__ = ("_dev_out",)

    def __init__(self, dev_out):
        self._dev_out = dev_out

    def window_sums(self) -> np.ndarray:
        """Blocks on the device; (B, 4, NLIMBS, 33) int32 on the host."""
        return self._dev_out.cpu().numpy()

    def result(self) -> Point:
        return combine_window_sums(self.window_sums())


def device_msm(scalars, points, device=None) -> Point:
    """Exact Σ[c_i]P_i with the window sums computed on `device`; returns
    a host Point (projective coordinates, unnormalized Z)."""
    if not len(scalars):
        return Point(0, 1, 1, 0)
    scalars, points = split_terms(scalars, points)
    digits, pts = pack_msm_operands(scalars, points)
    return PendingMSM(dispatch_window_sums(digits, pts, device)).result()
