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

A cold device call is three kernels, or four (csrc/), each with its plain
PyTorch version beside its wrapper:

  K1 `expand_compressed` (ops/torch_decompress.py) — compressed wire →
     extended points, when the points come compressed; then, when the
     host flagged lanes (hint bit 2: a fresh key's split-high lane), K7
     `shift128_lanes` replaces each by [2^128] of itself in place;
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
     points, built on K2's table tree;
  K2t `window_sums_tables` (`window_partials_tables`) — K2's window phase
     on prebuilt tables: the resident head tables, shared across the
     batch, and K4's R tables; then K3.

Two more kernels serve the affine wire and the sharded mesh
(parallel/sharded_msm.py):

  K6 `expand_affine` (`expand_affine_points`) — the affine wire, X‖Y limbs,
     → extended points with Z = 1 and T = X·Y, in place of K1;
  K5 `fold_shards` (`fold_shards`) — the cross-shard group fold of the
     per-shard window sums gathered onto the placement's first device.

K1, K2, K2t, K3 and K4 compute in 8 × 32-bit words with carry chains
(csrc/fe25519_u32.cuh) and write CANONICAL limbs.  K2 and K2t
(csrc/window_sums_u32.cuh) split each window's 64 lanes into four
sub-sums joined as (q0 + q1) + (q2 + q3); K3 folds with 128 threads a
(window, batch) and warp trees; K4 builds K2's table tree, T2 = P + P,
T3 | T4, T5 … T8 from T4, so K2t on its tables gives K2's limbs.  Their
plain versions take the same additions in the 20-limb arithmetic
(`split=4`, the K3 order, `_u32_table_tree`) and end with
torch_field.canonical_limbs20.  The earlier 20-limb K1, K3 and K4 are the
lab's `expand_compressed-l20`, `fold_partials-l20` and `build_tables-l20`
(`arith="l20"` on their wrappers); no verdict path launches them.
K5 and K6 run on the same arithmetic and write canonical limbs too: K5
folds the shards with K3's warp tree, reading each shard's sums in place;
K6 stages its rows through shared memory with 16-byte accesses.  Their
20-limb kernels are the lab's `fold_shards-l20` and `expand_affine-l20`.

The kernel lab's forms (tools/kernel_lab.py, tools/microbench.py), all in
the 20-limb design (csrc/window_sums.cuh: 20 × 13-bit limbs, two half-chunk
sums, unnormalised limbs): the 20-limb default itself (`arith="l20"`, kernels
`window_sums-l20` and `window_sums_tables-l20`), and K2 and K2t as
templates over the Pallas kernel's variant axes — radix 32
(`window_bits=5`: 27 plain digit planes, 17-entry tables from K4's r32
form, folded by K3's 27-window form), int16 partials (`fold_dtype`), an
int32 table (`tbl_dtype`), the unrolled `hybrid` body, 32 lanes a block
(`chunk`) and W windows a block (`win_chunk`) — and K2s
(`window_select_only`) is the select-only profile form.  `window_sums_many`
and `window_sums_many_tables_full` reach every form by argument; the
dispatches take no form argument and read no knob: they always run the
default K2 and K2t.

The plain versions take the kernels' additions in the kernels' order, so
kernel and plain version agree limb for limb.  Against the JAX package's
window sums they agree as group elements (projectively), not limb for limb:
the fold order differs.

Public entry points take `device=None`, meaning "cuda", and raise when no
CUDA device exists and the caller did not ask for the CPU.
"""

import ctypes
import threading
import types

import numpy as np
import torch

from .. import config as _config
from . import _cuda
from . import limbs
from . import torch_edwards as E
from . import torch_field as F
from .edwards import Point, shift128
from .limbs import NLIMBS, NWINDOWS, PACKED_WINDOWS
from .torch_decompress import (expand_compressed_points, shift128_flagged,
                               shift128_lanes)

MASK128 = (1 << 128) - 1
# Lanes per K2 block (csrc/window_sums.cu CHUNK), and threads per K3 block
# (csrc/fold_partials.cu FOLD_THREADS; THREADS_L20 for the 20-limb K3): the
# plain versions mirror both.
CHUNK = 64
HALF = CHUNK // 2
FOLD_THREADS = 128
FOLD_THREADS_L20 = 32
# The most shards K5 folds, one a lane of a warp (csrc/fold_partials.cu
# MAX_SHARDS).
MAX_SHARDS = 32
# Entries of a multiples table, [0..8]P.
NTABLE = 9
# Shared memory one block may take on an H100 (dynamic, after the opt-in).
MAX_SHARED_BYTES = 232_448
# The u32 table of 8 entries x 64 lanes x 128 B (csrc/window_sums_u32.cuh
# TABLE_BYTES): K4's block, and with the 33 windows' digits the default K2
# and K2t's (SMEM_BYTES).
U32_TABLE_BYTES = 8 * CHUNK * 128
U32_SHARED_BYTES = U32_TABLE_BYTES + CHUNK * NWINDOWS
# Sub-sums a window in the default K2 and K2t (window_sums_u32.cuh S); the
# -l20 forms and every other lab form sum two halves.
U32_SPLIT = 4
# Their block: 40 threads a sub-sum (window_sums_u32.cuh WSTRIDE, THREADS).
U32_THREADS = U32_SPLIT * 40
ARITHS = ("u32", "l20")

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


def _table_entries(window_bits: int) -> int:
    """Multiples-table length for a signed radix, [0..2^(wb-1)]P: 9 entries
    at radix 16, 17 at radix 32 (the JAX package's ops/msm.py:187-191)."""
    return (1 << (window_bits - 1)) + 1


def nwindows(window_bits: int) -> int:
    """Digit planes of the radix: 33 at window_bits=4, 27 at 5."""
    if window_bits not in (limbs.WINDOW_BITS, limbs.WINDOW_BITS_R32):
        raise ValueError(f"window_bits must be 4 or 5, got {window_bits!r}")
    return limbs.windows_for_bits(window_bits)


def pack_msm_operands(scalars, points, n_lanes: int | None = None,
                      window_bits: int = limbs.WINDOW_BITS):
    """Pack 128-bit (scalars, host Points) into padded numpy operands:
    digits (nwin, N) int8 and extended points (4, NLIMBS, N) int16,
    N = pad_lanes(len), nwin = nwindows(window_bits) (33 at the production
    radix 16, 27 at the radix-32 variant).  Padding terms are scalar 0 on
    the identity.  The JAX package's ops/msm.py:305-330."""
    scalars = [int(s) for s in scalars]
    if len(scalars) != len(points):
        raise ValueError("scalar/point length mismatch")
    n = len(scalars)
    N = n_lanes if n_lanes is not None else pad_lanes(n)
    if N < n:
        raise ValueError("n_lanes must be ≥ len(scalars)")
    nwin = nwindows(window_bits)
    digits = np.zeros((nwin, N), dtype=np.int8)
    pts = limbs.identity_point_batch(N)
    if n:
        digits[:, :n] = limbs.pack_scalar_windows(scalars, nwin, window_bits)
        pts[..., :n] = limbs.pack_point_batch(points).astype(np.int16)
    return digits, pts


def combine_window_sums(window_sums,
                        window_bits: int = limbs.WINDOW_BITS) -> Point:
    """Exact host Horner combine of the per-window sums (MSB first):
    acc ← [2^wb]acc + S_w, so radix-32 sums take 5 doublings a window.
    Accepts a leading singleton batch axis.  The JAX package's
    ops/msm.py:333-352."""
    ws = np.asarray(window_sums)
    if ws.ndim == 4:
        if ws.shape[0] != 1:
            raise ValueError("combine_window_sums takes one batch")
        ws = ws[0]
    acc = Point(0, 1, 1, 0)
    for w in range(ws.shape[-1]):
        for _ in range(window_bits):
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


def _check_digits(digits, B: int, N: int,
                  window_bits: int = limbs.WINDOW_BITS) -> bool:
    """Validates a digit wire; returns True for the packed form (radix 16
    only: radix-32 digits do not fit a nibble)."""
    if digits.dtype == torch.uint8 and window_bits == limbs.WINDOW_BITS:
        rows, packed = PACKED_WINDOWS, True
    elif digits.dtype == torch.int8:
        rows, packed = nwindows(window_bits), False
    else:
        raise ValueError(f"digits must be uint8 (packed, radix 16) or int8 "
                         f"(plain), got {digits.dtype} at window_bits="
                         f"{window_bits}")
    if tuple(digits.shape) != (B, rows, N):
        raise ValueError(f"digits must be {(B, rows, N)}, got "
                         f"{tuple(digits.shape)}")
    return packed


def _check_points(points):
    if points.dtype != torch.int16 or points.ndim != 4 \
            or tuple(points.shape[1:3]) != (4, NLIMBS):
        raise ValueError(f"points must be (B, 4, {NLIMBS}, N) int16, got "
                         f"{tuple(points.shape)} {points.dtype}")


# -- the window-sum kernel forms -------------------------------------------
#
# K2, K2t and K2s are templates (csrc/window_sums.cuh) over the variant axes
# of the Pallas kernel (ed25519_consensus_tpu/ops/pallas_msm.py:159-338):
# window_bits, tbl_dtype, fold_dtype, body (rolled | hybrid), chunk (lanes
# a block, the JAX `tile`) and win_chunk (windows a block, a launch
# argument).  A form's kernel name is its kind plus a tag for every axis off
# the default ("window_sums-r32-w9", "window_sums-i16fold-w11"); only the
# forms in _cuda.INSTANTIATIONS are built, at the windows per block that
# _cuda.BLOCK_FORMS allows, and any other raises ValueError on the card
# and on the CPU alike — nothing falls back to another form.

_PART_DTYPES = types.MappingProxyType(
    {"int32": torch.int32, "int16": torch.int16})


def k2_shared_bytes(window_bits: int, tbl_dtype: str, fold_dtype: str,
                    chunk: int, win_chunk: int) -> int:
    """Shared memory of one window-sum block: the stored entries (entry
    stride padded by one 32-bit word), the W windows' digits and the W
    points of the half-chunk exchange (csrc/window_sums.cuh
    Cfg::smem_bytes)."""
    tsz = 2 if tbl_dtype == "int16" else 4
    psz = 4 if fold_dtype == "int32" else 2
    stride = 4 * NLIMBS * chunk + 4 // tsz
    return ((_table_entries(window_bits) - 1) * stride * tsz
            + win_chunk * chunk + win_chunk * 4 * NLIMBS * psz)


def u32_form(window_bits: int = limbs.WINDOW_BITS, tbl_dtype: str = "int16",
             fold_dtype: str = "int32", body: str = "rolled",
             chunk: int = CHUNK, win_chunk: "int | None" = None,
             arith: str = "u32") -> bool:
    """Whether these axes name the default K2 / K2t of
    csrc/window_sums_u32.cuh (radix 16, every window in one block, 64
    lanes, `arith` "u32"): its order of additions (the 4-way split, the
    table tree) and canonical limbs.  Every other form, `arith="l20"`
    included, is the 20-limb design (csrc/window_sums.cuh)."""
    if arith not in ARITHS:
        raise ValueError(f"arith must be one of {ARITHS}: {arith!r}")
    return (arith == "u32" and window_bits == limbs.WINDOW_BITS
            and tbl_dtype == "int16" and fold_dtype == "int32"
            and body == "rolled" and chunk == CHUNK
            and win_chunk in (None, NWINDOWS))


def kernel_form(kind: str, window_bits: int = limbs.WINDOW_BITS,
                tbl_dtype: str = "int16", fold_dtype: str = "int32",
                body: str = "rolled", chunk: int = CHUNK,
                win_chunk: "int | None" = None, arith: str = "u32"):
    """(base, suffix, chunk, win_chunk) of a window-sum form of `kind`
    ("window_sums", "window_sums_tables", "window_select_only"): `base`
    the instantiation, `suffix` "-w<W>" when W < nwin.  The default axes
    with every window in one block name the Hopper K2 / K2t ("u32"); with
    `arith="l20"` or fewer windows a block, the 20-limb kernels
    ("window_sums-l20", "window_sums_tables-l20"); every other axis names
    a lab form of the 20-limb design.  Radix-32 with an int32 table takes 32
    lanes a block: at 64 its table alone is 328 KB.  Raises ValueError for
    a form that is not built or whose block does not fit the card's 227 KB
    of shared memory."""
    nwin = nwindows(window_bits)
    if tbl_dtype not in ("int16", "int32"):
        raise ValueError(f"tbl_dtype must be int16 or int32: {tbl_dtype!r}")
    if fold_dtype not in _PART_DTYPES:
        raise ValueError(f"fold_dtype must be int32 or int16: "
                         f"{fold_dtype!r}")
    if body not in ("rolled", "hybrid"):
        raise ValueError(f"body must be rolled or hybrid: {body!r}")
    if chunk not in (32, 64):
        raise ValueError(f"chunk must be 32 or 64 lanes: {chunk!r}")
    W = nwin if win_chunk is None else int(win_chunk)
    _check_win_chunk(nwin, W)
    if window_bits == limbs.WINDOW_BITS_R32 and tbl_dtype == "int32":
        chunk = 32
    u32 = kind != "window_select_only" and u32_form(
        window_bits, tbl_dtype, fold_dtype, body, chunk, W, arith)
    smem = U32_SHARED_BYTES if u32 else k2_shared_bytes(
        window_bits, tbl_dtype, fold_dtype, chunk, W)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"{kind} at window_bits={window_bits}, tbl_dtype="
                         f"{tbl_dtype}, {chunk} lanes needs {smem} B of "
                         f"shared memory a block; the card has "
                         f"{MAX_SHARED_BYTES}")
    tags = [tag for cond, tag in (
        (window_bits == limbs.WINDOW_BITS_R32, "r32"),
        (tbl_dtype == "int32", "i32tbl"),
        (fold_dtype == "int16", "i16fold"),
        (body == "hybrid", "hybrid"),
        (chunk != CHUNK, f"c{chunk}")) if cond]
    if not tags and not u32 and kind != "window_select_only":
        tags = ["l20"]
    base = "-".join([kind] + tags)
    if base not in _cuda.INSTANTIATIONS:
        raise ValueError(f"no kernel is built for {base} (window_bits="
                         f"{window_bits}, tbl_dtype={tbl_dtype}, fold_dtype="
                         f"{fold_dtype}, body={body}, chunk={chunk}); built: "
                         f"{sorted(b for b in _cuda.INSTANTIATIONS if b.startswith(kind))}")
    if not _cuda.block_form_built(base, W == nwin):
        raise ValueError(f"no kernel is built for {base} at {W} windows a "
                         f"block: it holds only the form with every window "
                         f"in one block")
    return base, "" if W == nwin else f"-w{W}", chunk, W


def _check_win_chunk(nwin: int, win_chunk) -> None:
    if win_chunk is not None and (win_chunk <= 0 or nwin % win_chunk):
        raise ValueError(f"win_chunk {win_chunk!r} must be a positive "
                         f"divisor of {nwin} windows")


# -- K2: per-chunk window partials -----------------------------------------

def window_partials_plain(digits, points, *,
                          window_bits: int = limbs.WINDOW_BITS,
                          tbl_dtype: str = "int16",
                          fold_dtype: str = "int32",
                          win_chunk: "int | None" = None,
                          chunk: int = CHUNK, body: str = "rolled",
                          arith: str = "u32"):
    """Plain PyTorch version of K2: digits (B, 17, N) uint8 or (B, nwin, N)
    int8, points (B, 4, NLIMBS, N) int16 → partials (B, nchunk, nwin, 4,
    NLIMBS), int32 or int16 (`fold_dtype`), the same additions in the same
    order as the form's kernel at `chunk` lanes a block.  The default form
    (`u32_form`, csrc/window_sums_u32.cuh): the table tree T2 = P + P,
    T3 = T2 + P, T4 = T2 + T2, T5 = T4 + P, T6 = T4 + T2, T7 = T4 + T3,
    T8 = T4 + T4, four sub-sums a window, canonical limbs.  Every other
    form (csrc/window_sums.cuh): T1 = P, Tk = T(k−1) + P stored as
    `tbl_dtype`, two halves, the limbs as the additions leave them.
    `win_chunk` (W windows a block) only decides which block computes a
    window, not its additions, so every W of one design gives the same
    limbs: the plain version checks W and computes all windows at once.
    The JAX counterpart: the in-kernel body of
    ops/pallas_msm.py:220-318."""
    B, _, _, N = points.shape
    if _check_digits(digits, B, N, window_bits):
        digits = expand_digits(digits)
    _check_win_chunk(digits.shape[1], win_chunk)
    u32 = u32_form(window_bits, tbl_dtype, fold_dtype, body, chunk,
                   win_chunk, arith)
    Np = -(-N // chunk) * chunk
    pts = torch.zeros((4, NLIMBS, B, Np), dtype=torch.int32,
                      device=points.device)
    pts[1, 0] = 1
    pts[2, 0] = 1
    pts[..., :N] = points.permute(1, 2, 0, 3)
    # tables: (NTBL, 4, NLIMBS, B, Np), entry 0 the identity
    if u32:
        ents = [E.identity_like(pts)] + _u32_table_tree(pts)
    else:
        ents = [E.identity_like(pts), pts]
        for _ in range(_table_entries(window_bits) - 2):
            e = E.point_add(ents[-1], pts)
            ents.append(e.to(torch.int16).to(torch.int32)
                        if tbl_dtype == "int16" else e)
    return _window_phase(torch.stack(ents), digits, N, chunk, fold_dtype,
                         u32)


def _u32_table_tree(P):
    """Entries 1..8 of the default K2's table, built as its kernel builds
    them (two threads a lane, a chain of 4 additions; the default K4 runs
    the same code, window_sums_u32.cuh build_table): T2 = P + P; T3 = T2 +
    P and T4 = T2 + T2; T5 = T4 + P, T6 = T4 + T2, T7 = T4 + T3 and T8 =
    T4 + T4."""
    T2 = E.point_add(P, P)
    T3 = E.point_add(T2, P)
    T4 = E.point_add(T2, T2)
    return [P, T2, T3, T4, E.point_add(T4, P), E.point_add(T4, T2),
            E.point_add(T4, T3), E.point_add(T4, T4)]


def _window_phase(tbl, digits, N: int, chunk: int, fold_dtype: str,
                  u32: bool):
    """The window phase of a K2 / K2t plain version: the default form's
    four sub-sums and canonical limbs, or the 20-limb design's two halves."""
    if not u32:
        return _partials_from_tables(tbl, digits, N, chunk, fold_dtype)
    parts = _partials_from_tables(tbl, digits, N, chunk, fold_dtype,
                                  split=U32_SPLIT)
    return F.canonical_limbs20(parts.movedim(-1, 0)).movedim(0, -1) \
        .contiguous()


def _partials_from_tables(tbl, digits, N: int, chunk: int = CHUNK,
                          fold_dtype: str = "int32", split: int = 2):
    """The window phase shared by K2's and K2t's plain versions: tables
    (NTBL, 4, NLIMBS, B, Np) int32 with entry 0 the identity and every lane
    past N the identity, plain digits (B, nwin, N) → (B, nchunk, nwin, 4,
    NLIMBS).  Each chunk's lanes are `split` sub-sums of chunk / split
    lanes, each summed lane by lane from its first lane's selected entry;
    two halves then meet through the exchange (int16 when `fold_dtype` is
    int16), four as (q0 + q1) + (q2 + q3)."""
    if split not in (2, 4):
        raise ValueError(f"split must be 2 or 4, got {split!r}")
    B, Np = tbl.shape[3], tbl.shape[4]
    nwin = digits.shape[1]
    sub = chunk // split
    nchunk = Np // chunk
    dig = torch.zeros((B, nwin, Np), dtype=torch.int32, device=tbl.device)
    dig[..., :N] = digits
    sel = _select(tbl, dig)  # (4, NLIMBS, B, nwin, Np)
    sel = sel.reshape(4, NLIMBS, B, nwin, nchunk, split, sub).permute(
        0, 1, 2, 4, 3, 5, 6)
    acc = sel[..., 0]
    for lane in range(1, sub):
        acc = E.point_add(acc, sel[..., lane])
    if split == 4:
        acc = E.point_add(E.point_add(acc[..., 0], acc[..., 1]),
                          E.point_add(acc[..., 2], acc[..., 3]))
    else:
        other = acc[..., 1]
        if fold_dtype == "int16":
            other = other.to(torch.int16).to(torch.int32)
        acc = E.point_add(acc[..., 0], other)
    # acc: (4, NLIMBS, B, nchunk, nwin)
    return acc.permute(2, 3, 4, 0, 1).to(_PART_DTYPES[fold_dtype]) \
        .contiguous()


def _select(tbl, dig):
    """sign(d)·T[|d|] for every (b, w, lane) of tables (NTBL, 4, NLIMBS, B,
    Np) and digits (B, nwin, Np): (4, NLIMBS, B, nwin, Np) int32, X and T
    negated for negative digits."""
    idx = dig.abs().long().unsqueeze(0).unsqueeze(0).expand(
        (4, NLIMBS) + tuple(dig.shape))
    sel = torch.gather(tbl.permute(1, 2, 3, 0, 4), 3, idx)
    sgn = torch.where(dig < 0, -1, 1).to(torch.int32)
    sel[0] *= sgn
    sel[3] *= sgn
    return sel


def window_partials(digits, points, *, window_bits: int = limbs.WINDOW_BITS,
                    tbl_dtype: str = "int16", fold_dtype: str = "int32",
                    win_chunk: "int | None" = None, body: str = "rolled",
                    chunk: int = CHUNK, arith: str = "u32"):
    """K2 wrapper: launches the instantiation that `kernel_form` names on
    CUDA tensors, runs `window_partials_plain` on CPU tensors.  The
    defaults are the main path's K2 (window_sums.cu, window_sums_u32.cuh);
    `win_chunk=None` means every window in one block, `arith="l20"` the
    20-limb kernel."""
    _check_points(points)
    B, _, _, N = points.shape
    packed = _check_digits(digits, B, N, window_bits)
    base, suffix, chunk, W = kernel_form(
        "window_sums", window_bits, tbl_dtype, fold_dtype, body, chunk,
        win_chunk, arith)
    if points.device.type == "cpu" and digits.device.type == "cpu":
        return window_partials_plain(
            digits, points, window_bits=window_bits, tbl_dtype=tbl_dtype,
            fold_dtype=fold_dtype, win_chunk=W, chunk=chunk, body=body,
            arith=arith)
    if points.device.type != "cuda" or digits.device != points.device:
        raise ValueError(f"digits on {digits.device} and points on "
                         f"{points.device}: both must be on one CUDA "
                         f"device or both on the CPU")
    digits, points = digits.contiguous(), points.contiguous()
    nchunk = -(-N // chunk)
    out = torch.empty((B, nchunk, nwindows(window_bits), 4, NLIMBS),
                      dtype=_PART_DTYPES[fold_dtype], device=points.device)
    if B * nchunk:
        _cuda.kernel(base, suffix).launch(
            points.device, digits.data_ptr(), int(packed),
            points.data_ptr(), out.data_ptr(), B, N, W)
    return out


# -- K2t and K2s: window partials from prebuilt tables ---------------------

def _check_tables(tables, name: str, window_bits: int = limbs.WINDOW_BITS):
    n_tbl = _table_entries(window_bits)
    if tables.dtype != torch.int16 or tables.ndim != 5 or \
            tuple(tables.shape[1:4]) != (n_tbl, 4, NLIMBS):
        raise ValueError(f"{name} must be (*, {n_tbl}, 4, {NLIMBS}, n) "
                         f"int16, got {tuple(tables.shape)} {tables.dtype}")


def _tables_operands(digits, head_tables, r_tables,
                     window_bits: int = limbs.WINDOW_BITS):
    """Validates K2t's operands; returns (B, n_head, N, packed, r_tables)
    with an empty R table tensor standing in for None."""
    _check_tables(head_tables, "head_tables", window_bits)
    B = digits.shape[0]
    n_head = head_tables.shape[4]
    if r_tables is None:
        r_tables = torch.empty(
            (B, _table_entries(window_bits), 4, NLIMBS, 0),
            dtype=torch.int16, device=head_tables.device)
    _check_tables(r_tables, "r_tables", window_bits)
    N = n_head + r_tables.shape[4]
    if head_tables.shape[0] not in (1, B) or r_tables.shape[0] != B:
        raise ValueError(f"head tables batch {head_tables.shape[0]} and R "
                         f"tables batch {r_tables.shape[0]} do not fit "
                         f"B = {B} (head: 1 or B; R: B)")
    packed = _check_digits(digits, B, N, window_bits)
    return B, n_head, N, packed, r_tables


def _tables_tensor(head_tables, r_tables, B: int, N: int, chunk: int):
    """The blocks' view of the tables: (NTBL, 4, NLIMBS, B, Np) int32,
    head lanes then R lanes, the identity in entry 0 and past lane N
    (entry 0 of the tensors is never read, as the kernels never read it)."""
    n_tbl, n_head = head_tables.shape[1], head_tables.shape[4]
    Np = -(-N // chunk) * chunk
    tbl = torch.zeros((n_tbl, 4, NLIMBS, B, Np), dtype=torch.int32,
                      device=r_tables.device)
    tbl[:, 1:3, 0] = 1  # the identity, kept in entry 0 and past lane N
    tbl[1:, ..., :n_head] = head_tables[:, 1:].permute(1, 2, 3, 0, 4)
    tbl[1:, ..., n_head:N] = r_tables[:, 1:].permute(1, 2, 3, 0, 4)
    return tbl


def _tables_devices(digits, head_tables, r_tables) -> bool:
    """True for operands all on the CPU; raises unless they are all on one
    CUDA device."""
    devs = {digits.device, head_tables.device, r_tables.device}
    if devs == {torch.device("cpu")}:
        return True
    if len(devs) != 1 or digits.device.type != "cuda":
        raise ValueError(f"digits, head tables and R tables on {devs}: all "
                         f"must be on one CUDA device or all on the CPU")
    return False


def window_partials_tables_plain(digits, head_tables, r_tables=None, *,
                                 window_bits: int = limbs.WINDOW_BITS,
                                 fold_dtype: str = "int32",
                                 win_chunk: "int | None" = None,
                                 arith: str = "u32"):
    """Plain PyTorch version of K2t: digits (B, 17 | nwin, N), head tables
    (TH, NTBL, 4, NLIMBS, n_head) int16 with TH ∈ {1, B}, R tables (B,
    NTBL, 4, NLIMBS, N − n_head) int16 (None when n_head = N) → partials
    (B, nchunk, nwin, 4, NLIMBS).  The same selection and window phase as
    K2's plain version of the same form on the given tables (the default:
    four sub-sums, canonical limbs); entry 0 is taken as the identity,
    never read from the tensors (the kernel never stores or reads it).
    The JAX counterpart: ops/pallas_msm.py:275-285 (tables_in)."""
    B, n_head, N, packed, r_tables = _tables_operands(
        digits, head_tables, r_tables, window_bits)
    if packed:
        digits = expand_digits(digits)
    _check_win_chunk(digits.shape[1], win_chunk)
    u32 = u32_form(window_bits, fold_dtype=fold_dtype, win_chunk=win_chunk,
                   arith=arith)
    tbl = _tables_tensor(head_tables, r_tables, B, N, CHUNK)
    return _window_phase(tbl, digits, N, CHUNK, fold_dtype, u32)


def window_partials_tables(digits, head_tables, r_tables=None, *,
                           window_bits: int = limbs.WINDOW_BITS,
                           fold_dtype: str = "int32",
                           win_chunk: "int | None" = None,
                           arith: str = "u32"):
    """K2t wrapper: launches the window_sums_tables instantiation that
    `kernel_form` names (csrc/window_sums.cu by default; window_sums_lab.cu
    for `arith="l20"`, window_sums_r32.cu) on CUDA tensors, runs
    `window_partials_tables_plain` on CPU tensors.  TH = 1 head tables are
    shared by every batch (batch stride 0)."""
    B, n_head, N, packed, r_tables = _tables_operands(
        digits, head_tables, r_tables, window_bits)
    base, suffix, _, W = kernel_form(
        "window_sums_tables", window_bits, fold_dtype=fold_dtype,
        win_chunk=win_chunk, arith=arith)
    if _tables_devices(digits, head_tables, r_tables):
        return window_partials_tables_plain(
            digits, head_tables, r_tables, window_bits=window_bits,
            fold_dtype=fold_dtype, win_chunk=W, arith=arith)
    digits = digits.contiguous()
    head_tables = head_tables.contiguous()
    r_tables = r_tables.contiguous()
    nchunk = -(-N // CHUNK)
    out = torch.empty((B, nchunk, nwindows(window_bits), 4, NLIMBS),
                      dtype=_PART_DTYPES[fold_dtype], device=digits.device)
    if B * nchunk:
        _cuda.kernel(base, suffix).launch(
            digits.device, digits.data_ptr(), int(packed),
            head_tables.data_ptr(), int(head_tables.shape[0] != 1),
            n_head, r_tables.data_ptr(), out.data_ptr(), B, N, W)
    return out


def select_only_plain(digits, head_tables, r_tables=None):
    """Plain PyTorch version of K2s: K2t's operands → (B, nchunk, 33, 2,
    80) int32, for window w and chunk half h the limb-wise XOR over the
    half's lanes of sign(d)·T[|d|] (the identity for d = 0).  A profile
    form only (the JAX package's select_only, ops/pallas_msm.py:200-204,
    :251-253): it never reaches a verdict."""
    B, n_head, N, packed, r_tables = _tables_operands(
        digits, head_tables, r_tables)
    if packed:
        digits = expand_digits(digits)
    tbl = _tables_tensor(head_tables, r_tables, B, N, CHUNK)
    Np = tbl.shape[4]
    dig = torch.zeros((B, NWINDOWS, Np), dtype=torch.int32,
                      device=tbl.device)
    dig[..., :N] = digits
    sel = _select(tbl, dig).reshape(4, NLIMBS, B, NWINDOWS, Np // CHUNK, 2,
                                    HALF)
    x = sel[..., 0]
    for lane in range(1, HALF):
        x = x ^ sel[..., lane]
    return x.permute(2, 4, 3, 5, 0, 1).reshape(
        B, Np // CHUNK, NWINDOWS, 2, 4 * NLIMBS).contiguous()


def select_only(digits, head_tables, r_tables=None, *,
                win_chunk: "int | None" = None):
    """K2s wrapper: launches window_select_only (csrc/window_sums_lab.cu)
    on CUDA tensors, runs `select_only_plain` on CPU tensors."""
    B, n_head, N, packed, r_tables = _tables_operands(
        digits, head_tables, r_tables)
    base, suffix, _, W = kernel_form("window_select_only",
                                     win_chunk=win_chunk)
    if _tables_devices(digits, head_tables, r_tables):
        return select_only_plain(digits, head_tables, r_tables)
    digits = digits.contiguous()
    head_tables = head_tables.contiguous()
    r_tables = r_tables.contiguous()
    nchunk = -(-N // CHUNK)
    out = torch.empty((B, nchunk, NWINDOWS, 2, 4 * NLIMBS),
                      dtype=torch.int32, device=digits.device)
    if B * nchunk:
        _cuda.kernel(base, suffix).launch(
            digits.device, digits.data_ptr(), int(packed),
            head_tables.data_ptr(), int(head_tables.shape[0] != 1),
            n_head, r_tables.data_ptr(), out.data_ptr(), B, N, W)
    return out


# -- K4: multiples tables --------------------------------------------------

def _u32_tables(window_bits: int, arith: str) -> bool:
    """Whether K4 at these arguments is the default kernel on the 8 x
    32-bit arithmetic (radix 16, `arith` "u32"): K2's table tree, canonical
    limbs.  Every other form is the 20-limb chain: `arith="l20"`, and the
    radix-32 17-entry form whatever `arith`."""
    if arith not in ARITHS:
        raise ValueError(f"arith must be one of {ARITHS}: {arith!r}")
    return arith == "u32" and window_bits == limbs.WINDOW_BITS


def build_tables_plain(points, window_bits: int = limbs.WINDOW_BITS,
                       arith: str = "u32"):
    """Plain PyTorch version of K4: extended points (B, 4, NLIMBS, N) int16
    → tables (B, NTBL, 4, NLIMBS, N) int16, entry 0 the identity, NTBL = 9
    or 17 by `window_bits`.  The default (radix 16, `arith="u32"`, the
    kernel `build_tables`): entry 1 P, entries 2..8 K2's table tree
    (`_u32_table_tree`) in the 20-limb arithmetic, every entry as canonical
    limbs (torch_field.canonical_limbs20) — the kernel's limbs, and the
    JAX package's build_multiples_tables as points, entry by entry.
    `arith="l20"` and the radix-32 form (`build_tables-l20`,
    `build_tables-r32`): entry k = entry (k−1) + P, the reference's
    table_scan (ops/msm.py:194-220) step for step, equal to its
    build_multiples_tables byte for byte."""
    pts = points.permute(1, 2, 0, 3).to(torch.int32)  # (4, NLIMBS, B, N)
    ents = [E.identity_like(pts)]
    if _u32_tables(window_bits, arith):
        tbl = torch.stack(ents + _u32_table_tree(pts))
        tbl = F.canonical_limbs20(tbl.movedim(2, 0)).movedim(0, 2)
    else:
        for _ in range(_table_entries(window_bits) - 1):
            ents.append(E.point_add(ents[-1], pts))
        tbl = torch.stack(ents)
    return tbl.to(torch.int16).permute(3, 0, 1, 2, 4).contiguous()


def multiples_tables(points, window_bits: int = limbs.WINDOW_BITS,
                     arith: str = "u32"):
    """K4 wrapper: launches build_tables (9 entries, the 8 x 32-bit
    kernel), build_tables-l20 (`arith="l20"`, 9 entries, 20 limbs) or
    build_tables-r32 (17, 20 limbs) of csrc/build_tables.cu on a CUDA
    tensor, runs `build_tables_plain` on a CPU tensor."""
    _check_points(points)
    n_tbl = _table_entries(window_bits)
    nwindows(window_bits)
    u32 = _u32_tables(window_bits, arith)
    if points.device.type == "cpu":
        return build_tables_plain(points, window_bits, arith)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    points = points.contiguous()
    B, _, _, N = points.shape
    out = torch.empty((B, n_tbl, 4, NLIMBS, N), dtype=torch.int16,
                      device=points.device)
    if B * N:
        name = "build_tables" if u32 else (
            "build_tables-l20" if window_bits == limbs.WINDOW_BITS
            else "build_tables-r32")
        _cuda.kernel(name).launch(points.device, points.data_ptr(),
                                  out.data_ptr(), B, N)
    return out


def build_multiples_tables(points, device=None,
                           window_bits: int = limbs.WINDOW_BITS):
    """The multiples tables of a batch of extended points, (B, 4, NLIMBS,
    N) int16 (numpy or tensor) → (B, NTBL, 4, NLIMBS, N) int16 tensor on
    `device` (None means CUDA): row 0 the identity, row k the exact [k]P,
    equal byte for byte to the reference's build_multiples_tables
    (ops/msm.py:626-635) — the 20-limb K4 (`arith="l20"`).  No verdict
    path calls it: the resident-tables dispatch builds its tables with
    `multiples_tables`'s default."""
    return multiples_tables(as_tensor(points, resolve_device(device)),
                            window_bits, arith="l20")


# -- K3: fold of the chunk partials ----------------------------------------

def _identity_sums(B: int, nwin: int, device):
    out = torch.zeros((B, 4, NLIMBS, nwin), dtype=torch.int32, device=device)
    out[:, 1, 0] = 1
    out[:, 2, 0] = 1
    return out


def _warp_tree(acc, lives, base):
    """The halving trees of csrc/fold_partials.cu warp_fold, one per group
    of 32 lanes at once: group g holds lives[g] values from accumulator
    base[g]; at s = 16, 8, 4, 2, 1 lane l < s adds lane l + s when
    l + s < live, then live = min(live, s).  Each sum lands in lane 0 of
    its group."""
    lives = list(lives)
    s = 16
    while s:
        dst = [b + lane for b, live in zip(base, lives)
               for lane in range(s) if lane + s < live]
        if dst:
            src = [d + s for d in dst]
            acc[..., dst] = E.point_add(acc[..., dst], acc[..., src])
        lives = [min(live, s) for live in lives]
        s //= 2
    return acc


def fold_partials_plain(partials, arith: str = "u32"):
    """Plain PyTorch version of K3: (B, nchunk, nwin, 4, NLIMBS) int32 or
    int16 → (B, 4, NLIMBS, nwin) int32, the same additions in the same
    order as csrc/fold_partials.cu, nchunk − 1 per (b, window); no chunks
    give the identity.  The default K3 (`arith="u32"`): accumulator t <
    FOLD_THREADS starts from chunk t and adds chunks t + 128, t + 256, ...;
    each warp's 32 accumulators meet in a halving tree (`_warp_tree`), the
    warps' sums in one more; canonical limbs out.  The lab's 20-limb K3
    (`"l20"`): 32 accumulators from chunks t, t + 32, ..., one halving
    tree, the limbs as the additions leave them."""
    if arith not in ("u32", "l20"):
        raise ValueError(f"arith must be u32 or l20: {arith!r}")
    B, nchunk, nwin = partials.shape[:3]
    p = partials.to(torch.int32).permute(3, 4, 0, 2, 1)  # (4, NLIMBS, B, nwin, nchunk)
    T = FOLD_THREADS if arith == "u32" else FOLD_THREADS_L20
    live = min(nchunk, T)
    if not live:
        return _identity_sums(B, nwin, p.device)
    acc = p[..., :live].clone()
    for lo in range(T, nchunk, T):
        n = min(T, nchunk - lo)
        acc[..., :n] = E.point_add(acc[..., :n], p[..., lo:lo + n])
    warps = range(0, live, 32)
    acc = _warp_tree(acc, [min(live - w, 32) for w in warps], list(warps))
    if len(warps) > 1:
        acc = _warp_tree(acc[..., list(warps)], [len(warps)], [0])
    out = acc[..., 0]  # (4, NLIMBS, B, nwin)
    if arith == "u32":
        out = F.canonical_limbs20(out.movedim(1, 0)).movedim(0, 1)
    return out.permute(2, 0, 1, 3).contiguous()


def fold_partials(partials, arith: str = "u32"):
    """K3 wrapper: launches csrc/fold_partials.cu on a CUDA tensor — the
    instantiation for 33 or 27 windows of int32 or int16 partials, or the
    lab's 20-limb `fold_partials-l20` (`arith="l20"`, 33 windows of int32)
    — and runs `fold_partials_plain` on a CPU tensor."""
    if partials.dtype not in (torch.int32, torch.int16) or \
            partials.ndim != 5 or partials.shape[2] not in (
                NWINDOWS, limbs.NWINDOWS_R32) or \
            tuple(partials.shape[3:]) != (4, NLIMBS):
        raise ValueError(f"partials must be (B, nchunk, 33 | 27, 4, "
                         f"{NLIMBS}) int32 or int16, got "
                         f"{tuple(partials.shape)} {partials.dtype}")
    if arith not in ARITHS:
        raise ValueError(f"arith must be one of {ARITHS}: {arith!r}")
    base = "-".join(["fold_partials"] + [tag for cond, tag in (
        (partials.shape[2] == limbs.NWINDOWS_R32, "r32"),
        (partials.dtype == torch.int16, "i16fold"),
        (arith == "l20", "l20")) if cond])
    if base not in _cuda.INSTANTIATIONS:
        raise ValueError(f"no kernel is built for {base}")
    if partials.device.type == "cpu":
        return fold_partials_plain(partials, arith)
    if partials.device.type != "cuda":
        raise ValueError(f"unsupported device {partials.device}")
    partials = partials.contiguous()
    if partials.data_ptr() % 16:  # the kernel reads rows in 16 bytes
        partials = partials.clone()
    B, nchunk, nwin = partials.shape[:3]
    out = torch.empty((B, 4, NLIMBS, nwin), dtype=torch.int32,
                      device=partials.device)
    if B:
        _cuda.kernel(base).launch(
            partials.device, partials.data_ptr(), out.data_ptr(), B, nchunk)
    return out


# -- K5: the cross-shard fold ----------------------------------------------

def _check_window_sums(ws, name: str, ndim: int):
    if ws.dtype != torch.int32 or ws.ndim != ndim or \
            tuple(ws.shape[-3:]) != (4, NLIMBS, NWINDOWS):
        raise ValueError(f"{name} must be (..., 4, {NLIMBS}, {NWINDOWS}) "
                         f"int32 of rank {ndim}, got {tuple(ws.shape)} "
                         f"{ws.dtype}")


def _shard_sums(shards):
    """(the D shard sums as a list, B, device) of `shards`: a sequence of
    D (B, 4, NLIMBS, 33) int32 tensors on one device, or one stacked (D,
    B, 4, NLIMBS, 33) tensor (its slices; D = 0 only this way).  Raises
    ValueError past MAX_SHARDS on every device."""
    if isinstance(shards, torch.Tensor):
        _check_window_sums(shards, "stacked shard sums", 5)
        parts, B, device = list(shards.unbind(0)), shards.shape[1], \
            shards.device
    else:
        parts = list(shards)
        if not parts:
            raise ValueError("no shard sums: pass D = 0 as a stacked (0, "
                             "B, 4, 20, 33) tensor")
        for p in parts:
            _check_window_sums(p, "a shard's window sums", 4)
        B, device = parts[0].shape[0], parts[0].device
        if any(p.shape != parts[0].shape or p.device != device
               for p in parts):
            raise ValueError("the shard sums must share one shape and one "
                             "device")
    if len(parts) > MAX_SHARDS:
        raise ValueError(f"K5 folds at most {MAX_SHARDS} shards, got "
                         f"{len(parts)}")
    return parts, B, device


def fold_shards_plain(shards, arith: str = "u32"):
    """Plain PyTorch version of K5: the D per-shard window sums (a
    sequence of (B, 4, NLIMBS, 33) int32 tensors or one stacked (D, B, 4,
    NLIMBS, 33) tensor) → (B, 4, NLIMBS, 33) int32, the same additions in
    the same order as csrc/fold_partials.cu, D − 1 per (b, window); D = 0
    gives the identity.  The default K5 (`arith="u32"`): one warp's halving
    tree over the shards (`_warp_tree`), canonical limbs out.  The lab's
    20-limb K5 (`"l20"`): shard 0 plus shards 1, 2, ... in order, the limbs
    as the additions leave them."""
    if arith not in ARITHS:
        raise ValueError(f"arith must be one of {ARITHS}: {arith!r}")
    parts, B, device = _shard_sums(shards)
    if not parts:
        return _identity_sums(B, NWINDOWS, device)
    pts = [p.permute(1, 2, 0, 3) for p in parts]  # (4, NLIMBS, B, 33)
    if arith == "l20":
        acc = pts[0]
        for p in pts[1:]:
            acc = E.point_add(acc, p)
    else:
        acc = _warp_tree(torch.stack(pts, dim=-1), [len(pts)], [0])[..., 0]
        acc = F.canonical_limbs20(acc.movedim(1, 0)).movedim(0, 1)
    return acc.permute(2, 0, 1, 3).contiguous()


def fold_shards(shards, arith: str = "u32"):
    """K5 wrapper: the D per-shard window sums, as a sequence of (B, 4,
    NLIMBS, 33) int32 tensors or one stacked (D, B, 4, NLIMBS, 33) tensor,
    → (B, 4, NLIMBS, 33) int32 on their device.  Launches fold_shards
    (csrc/fold_partials.cu) on CUDA tensors — every shard on one device,
    contiguous; the kernel reads each in place, so nothing is stacked or
    copied — or the lab's 20-limb `fold_shards-l20` (`arith="l20"`, on the
    stacked layout; a sequence is stacked for it); runs
    `fold_shards_plain` on CPU tensors.  A group fold by complete
    additions — never an elementwise limb add."""
    if arith not in ARITHS:
        raise ValueError(f"arith must be one of {ARITHS}: {arith!r}")
    parts, B, device = _shard_sums(shards)
    if device.type == "cpu":
        return fold_shards_plain(shards, arith)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty((B, 4, NLIMBS, NWINDOWS), dtype=torch.int32,
                      device=device)
    if not B:
        return out
    if arith == "l20":
        g = shards if isinstance(shards, torch.Tensor) else \
            torch.stack(parts)
        g = g.contiguous()
        _cuda.kernel("fold_shards-l20").launch(
            device, g.data_ptr(), out.data_ptr(), len(parts), B)
        return out
    if not all(p.is_contiguous() for p in parts):
        raise ValueError("K5 reads every shard's sums in place: each must "
                         "be contiguous")
    ptrs = (ctypes.c_void_p * MAX_SHARDS)(*[p.data_ptr() for p in parts])
    _cuda.KERNELS["fold_shards"].launch(device, ptrs, len(parts),
                                        out.data_ptr(), B)
    return out


# -- K6: the affine point wire ---------------------------------------------

def expand_affine_points_plain(points, arith: str = "u32"):
    """Plain PyTorch version of K6: (B, 2, NLIMBS, N) int16 X‖Y limbs →
    (B, 4, NLIMBS, N) int16 with Z = 1 and T = X·Y (one torch_field.mul):
    every coordinate as canonical limbs (`arith="u32"`, the default K6's),
    or X and Y as they came and T as the product leaves it (`"l20"`, the
    JAX function's limbs; they stay inside |limb| ≤ 8191, so the int16
    cast is exact)."""
    if arith not in ARITHS:
        raise ValueError(f"arith must be one of {ARITHS}: {arith!r}")
    X = points[:, 0].to(torch.int32).transpose(0, 1)  # (NLIMBS, B, N)
    Y = points[:, 1].to(torch.int32).transpose(0, 1)
    T = F.mul(X, Y)
    Z = torch.zeros_like(X)
    Z[0] = 1
    out = torch.stack([X, Y, Z, T])  # (4, NLIMBS, B, N)
    if arith == "u32":
        out = F.canonical_limbs20(out.movedim(1, 0)).movedim(0, 1)
    return out.permute(2, 0, 1, 3).to(torch.int16).contiguous()


def _check_affine(points):
    if points.dtype != torch.int16 or points.ndim != 4 \
            or tuple(points.shape[1:3]) != (2, NLIMBS):
        raise ValueError(f"affine points must be (B, 2, {NLIMBS}, N) int16, "
                         f"got {tuple(points.shape)} {points.dtype}")


def expand_affine_points(points, arith: str = "u32"):
    """K6 wrapper: (B, 2, NLIMBS, N) int16 affine wire → (B, 4, NLIMBS, N)
    int16 extended points.  Launches csrc/expand_affine.cu on a CUDA
    tensor (`arith="l20"`: the lab's 20-limb `expand_affine-l20`), runs
    `expand_affine_points_plain` on a CPU tensor."""
    _check_affine(points)
    if arith not in ARITHS:
        raise ValueError(f"arith must be one of {ARITHS}: {arith!r}")
    if points.device.type == "cpu":
        return expand_affine_points_plain(points, arith)
    if points.device.type != "cuda":
        raise ValueError(f"unsupported device {points.device}")
    points = points.contiguous()
    B, _, _, N = points.shape
    out = torch.empty((B, 4, NLIMBS, N), dtype=torch.int16,
                      device=points.device)
    if B * N:
        _cuda.kernel("expand_affine" if arith == "u32" else
                     "expand_affine-l20").launch(
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


def expand_points(points, wire: "str | None" = None,
                  shift: "bool | None" = None):
    """Any batched point wire → (B, 4, NLIMBS, N) int16 extended points:
    K1 for the compressed wire, then K7 on the same stream when the wire
    carries a lane with the shift flag (`shift`, None: read from
    `points` by `shift128_flagged`); K6 for the affine one."""
    wire = wire_of(points) if wire is None else wire
    if wire == "compressed":
        pts = expand_compressed_points(points)
        if shift is None:
            shift = shift128_flagged(points)
        return shift128_lanes(points, pts) if shift else pts
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


def window_sums_many(digits, points, *, window_bits: int = limbs.WINDOW_BITS,
                     fold_dtype: str = "int32", tbl_dtype: str = "int16",
                     win_chunk: "int | None" = None, body: str = "rolled",
                     chunk: int = CHUNK, arith: str = "u32", device=None):
    """B stacked batches in one device call with any window-sum form — the
    counterpart of the JAX package's pallas_window_sums_many
    (ops/pallas_msm.py:480-508; its `tile` is `chunk` here): digits (B, 17,
    N) uint8 packed or (B, nwin, N) int8 plain (radix 32: plain only),
    points in any wire (numpy arrays or tensors) → (B, 4, NLIMBS, nwin)
    int32 tensor on `device` (None means CUDA).  The defaults are the
    verdict path's K2: `win_chunk` None puts every window in one block,
    `body` is rolled; `arith="l20"` takes the 20-limb K2.  On CUDA: K1
    or K6 for a point wire, the K2 form, the matching K3; a form that is
    not built or does not fit raises ValueError before any launch."""
    dev = resolve_device(device)
    kernel_form("window_sums", window_bits, tbl_dtype, fold_dtype, body,
                chunk, win_chunk, arith)
    # Whether K7 runs is read from the operands where the host holds them.
    shift = wire_of(points) == "compressed" and shift128_flagged(points)
    digits = as_tensor(digits, dev)
    points = as_tensor(points, dev)
    with DEVICE_CALL_LOCK:
        return fold_partials(window_partials(
            digits, expand_points(points, shift=shift),
            window_bits=window_bits,
            tbl_dtype=tbl_dtype, fold_dtype=fold_dtype,
            win_chunk=win_chunk, body=body, chunk=chunk, arith=arith))


def window_sums_many_tables_full(digits, tables, *,
                                 window_bits: int = limbs.WINDOW_BITS,
                                 fold_dtype: str = "int32",
                                 win_chunk: "int | None" = None,
                                 arith: str = "u32", device=None):
    """B stacked batches from FULL prebuilt multiples tables — the
    counterpart of pallas_window_sums_many_tables_full
    (ops/pallas_msm.py:511-536): digits (B, 17 | nwin, N), tables (TB,
    NTBL, 4, NLIMBS, N) int16 with TB ∈ {1, B} (TB = 1 shares one table
    across the batch) → (B, 4, NLIMBS, nwin) int32 on `device`.  K2t (no R
    lanes) and K3; the body is always rolled, as in the JAX package,
    `win_chunk` None puts every window in one block, `arith="l20"` takes
    the 20-limb K2t."""
    dev = resolve_device(device)
    digits = as_tensor(digits, dev)
    tables = as_tensor(tables, dev)
    with DEVICE_CALL_LOCK:
        return fold_partials(window_partials_tables(
            digits, tables, window_bits=window_bits, fold_dtype=fold_dtype,
            win_chunk=win_chunk, arith=arith))


def window_select_only(digits, tables, *, win_chunk: "int | None" = None,
                       device=None):
    """The select-only profile form (K2s) on full tables, (B, 17 | 33, N)
    digits and (TB, 9, 4, NLIMBS, N) tables → (B, nchunk, 33, 2, 80)
    int32 on `device`: the select time of K2t without its additions, for
    tools/microbench.py's stage profile (the JAX package's select_only,
    ops/pallas_msm.py:200-204).  Never on a verdict path."""
    dev = resolve_device(device)
    digits = as_tensor(digits, dev)
    tables = as_tensor(tables, dev)
    with DEVICE_CALL_LOCK:
        return select_only(digits, tables, win_chunk=win_chunk)


def dispatch_window_sums_many(digits, points, device=None):
    """One device call for B stacked batches: digits (B, 17, N) uint8
    packed or (B, 33, N) int8 plain; points in any wire — (B, 33, N) uint8
    compressed, (B, 2, NLIMBS, N) int16 affine or (B, 4, NLIMBS, N) int16
    extended (numpy arrays or tensors) → (B, 4, NLIMBS, 33) int32 tensor on
    `device`.  On CUDA: K1 (compressed; then K7 when a lane carries the
    shift flag) or K6 (affine), the default K2, K3."""
    return window_sums_many(digits, points, device=device)


def dispatch_window_sums(digits, points, device=None):
    """Single-batch form: (17|33, N) digits and (33, N) | (4, NLIMBS, N)
    points → (1, 4, NLIMBS, 33) tensor (combine_window_sums accepts the
    leading singleton)."""
    return dispatch_window_sums_many(digits[None], points[None], device)


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
