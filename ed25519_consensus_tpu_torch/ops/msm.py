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

One device call is three kernels (csrc/), each with its plain PyTorch
version beside its wrapper:

  K1 `expand_compressed` (ops/torch_decompress.py) — compressed wire →
     extended points, when the points come compressed;
  K2 `window_sums` (`window_partials`) — per 64-lane chunk, per window, the
     complete-addition sum of the selected table entries, with the packed
     digits decoded in the load;
  K3 `fold_partials` (`fold_partials`) — the group fold of the chunk
     partials to (B, 4, NLIMBS, 33) int32.

The plain versions take the kernels' additions in the kernels' order, so
kernel and plain version agree limb for limb.  Against the JAX package's
window sums they agree as group elements (projectively), not limb for limb:
the fold order differs.

Public entry points take `device=None`, meaning "cuda", and raise when no
CUDA device exists and the caller did not ask for the CPU.
"""

import numpy as np
import torch

from . import _cuda
from . import limbs
from . import torch_edwards as E
from .edwards import Point, shift128
from .limbs import NLIMBS, NWINDOWS, PACKED_WINDOWS
from .torch_decompress import expand_compressed_points

MASK128 = (1 << 128) - 1
# Lanes per K2 block (csrc/window_sums.cu CHUNK), and threads per K3 block
# (csrc/fold_partials.cu THREADS): the plain versions mirror both.
CHUNK = 64
HALF = CHUNK // 2
FOLD_THREADS = 32


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
    a ragged edge too, but a whole chunk costs the same)."""
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
    nchunk = -(-N // CHUNK)
    Np = nchunk * CHUNK
    dev = points.device
    pts = torch.zeros((4, NLIMBS, B, Np), dtype=torch.int32, device=dev)
    pts[1, 0] = 1
    pts[2, 0] = 1
    pts[..., :N] = points.permute(1, 2, 0, 3)
    dig = torch.zeros((B, NWINDOWS, Np), dtype=torch.int32, device=dev)
    dig[..., :N] = digits
    # tables: (9, 4, NLIMBS, B, Np), entry 0 the identity
    ents = [E.identity_like(pts), pts]
    for _ in range(7):
        ents.append(E.point_add(ents[-1], pts).to(torch.int16)
                    .to(torch.int32))
    tbl = torch.stack(ents)
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


# -- the dispatch ----------------------------------------------------------

def as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def dispatch_window_sums_many(digits, points, device=None):
    """One device call for B stacked batches: digits (B, 17, N) uint8
    packed or (B, 33, N) int8 plain; points (B, 33, N) uint8 compressed or
    (B, 4, NLIMBS, N) int16 extended (numpy arrays or tensors) →
    (B, 4, NLIMBS, 33) int32 tensor on `device`.  On CUDA: K1 (compressed
    points only), K2, K3."""
    dev = resolve_device(device)
    digits = as_tensor(digits, dev)
    points = as_tensor(points, dev)
    if points.ndim == 3:
        points = expand_compressed_points(points)
    return fold_partials(window_partials(digits, points))


def dispatch_window_sums(digits, points, device=None):
    """Single-batch form: (17|33, N) digits and (33, N) | (4, NLIMBS, N)
    points → (1, 4, NLIMBS, 33) tensor (combine_window_sums accepts the
    leading singleton)."""
    dev = resolve_device(device)
    return dispatch_window_sums_many(as_tensor(digits, dev)[None],
                                     as_tensor(points, dev)[None], dev)


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
