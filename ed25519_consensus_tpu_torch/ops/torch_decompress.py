"""On-device ZIP215 point expansion from the 33-byte compressed wire.

The host has already made every accept/reject decision (decompression
success, `s < ℓ`, and the final cofactored identity check all stay on the
host), so the device receives just the 32-byte y encoding plus a 2-bit
host-computed hint and rebuilds x with exact field arithmetic:

    u = y² − 1,  v = d·y² + 1,
    r₀ = u·v³ · (u·v⁷)^((p−5)/8)        (the RFC 8032 candidate root)
    x  = r₀ · i^flip · (−1)^neg          (hint bits)

Wire: (B, 33, N) uint8 — rows 0..31 the little-endian encoding bytes (bit
255 ignored; the sign is folded into `neg`), row 32 the hint byte (bit0 =
flip, bit1 = neg).  y ≥ p non-canonical encodings (ZIP215-accepted) work
unchanged because the arithmetic is congruent mod p; the canonical limbs
out hold y mod p.

`expand_compressed_points` is the wrapper of kernel K1
(csrc/expand_compressed.cu) on a CUDA tensor and runs
`expand_compressed_points_plain` on a CPU tensor.  The plain version is the
JAX package's `ops/jnp_decompress.py` in PyTorch: the same 20-limb chain,
equal to the JAX function limb for limb, then `torch_field.canonical_limbs20`,
because K1 computes on 8 × 32-bit words (csrc/fe25519_u32.cuh) and writes
canonical limbs; the kernel equals it limb for limb.  `arith="l20"` takes
the earlier 20-limb kernel (the lab's `expand_compressed-l20`),
whose plain version is the chain without the canonical step.
"""

import torch

from . import _cuda
from . import torch_field as F
from .field import D, P, SQRT_M1
from .limbs import LIMB_BITS, NLIMBS, int_to_limbs

_D_LIMBS = [int(v) for v in int_to_limbs(D % P)]
_SQRTM1_LIMBS = [int(v) for v in int_to_limbs(SQRT_M1 % P)]

# Lanes per step of the plain version: bounds the (20, 40, lanes) int32
# product intermediates of torch_field.mul to ~26 MB.
CHUNK_LANES = 8192


def unpack_y_limbs(enc_bytes):
    """(32, ...) uint8 little-endian encoding bytes → (NLIMBS, ...) int32
    limbs of y with bit 255 masked out.  Limb i covers bits [13i, 13i+13);
    each limb touches ≤ 3 bytes."""
    b = enc_bytes.to(torch.int32)
    top_masked = b[31] & 0x7F  # bit 255 is the sign slot, not y
    out = []
    for i in range(NLIMBS):
        bit0 = LIMB_BITS * i
        k, r = bit0 >> 3, bit0 & 7
        limb = torch.zeros_like(b[0])
        for j, kk in enumerate((k, k + 1, k + 2)):
            if kk > 31 or 8 * j - r >= LIMB_BITS:
                continue
            byte = top_masked if kk == 31 else b[kk]
            sh = 8 * j - r
            limb = limb | (byte << sh if sh >= 0 else byte >> -sh)
        out.append(limb & ((1 << LIMB_BITS) - 1))
    return torch.stack(out)


def _sqn(x, n):
    for _ in range(n):
        x = F.mul(x, x)
    return x


def pow22523(z):
    """z^((p-5)/8) with (p-5)/8 = 2^252 − 3 over balanced limbs — the
    standard 2^k−1 ladder."""
    t0 = F.mul(z, z)                      # z^2
    t1 = _sqn(t0, 2)                      # z^8
    t1 = F.mul(t1, z)                     # z^9
    t0 = F.mul(t0, t1)                    # z^11
    t0 = F.mul(t0, t0)                    # z^22
    t0 = F.mul(t1, t0)                    # z^(2^5-1)
    t1 = _sqn(t0, 5)
    t0 = F.mul(t1, t0)                    # z^(2^10-1)
    t1 = _sqn(t0, 10)
    t1 = F.mul(t1, t0)                    # z^(2^20-1)
    t2 = _sqn(t1, 20)
    t1 = F.mul(t2, t1)                    # z^(2^40-1)
    t1 = _sqn(t1, 10)
    t0 = F.mul(t1, t0)                    # z^(2^50-1)
    t1 = _sqn(t0, 50)
    t1 = F.mul(t1, t0)                    # z^(2^100-1)
    t2 = _sqn(t1, 100)
    t1 = F.mul(t2, t1)                    # z^(2^200-1)
    t1 = _sqn(t1, 50)
    t0 = F.mul(t1, t0)                    # z^(2^250-1)
    t0 = _sqn(t0, 2)                      # z^(2^252-4)
    return F.mul(t0, z)                   # z^(2^252-3)


def decompress_block(enc_bytes, hints):
    """One lane block: (32, L) uint8 encoding bytes + (L,) uint8 hints →
    (4, NLIMBS, L) int32 extended coordinates (Z = 1, T = x·y)."""
    y = unpack_y_limbs(enc_bytes)
    shape, dev = y.shape[1:], y.device
    one = torch.zeros_like(y)
    one[0] = 1
    yy = F.mul(y, y)
    u = F.sub(yy, one)
    v = F.add(F.mul(yy, F.const(_D_LIMBS, shape, dev)), one)
    v3 = F.mul(F.mul(v, v), v)
    v7 = F.mul(F.mul(v3, v3), v)
    t1 = pow22523(F.mul(u, v7))
    r = F.mul(F.mul(u, v3), t1)           # candidate root
    h = hints.to(torch.int32)
    r = F.select((h & 1) == 1,
                 F.mul(r, F.const(_SQRTM1_LIMBS, shape, dev)), r)
    x = F.select((h & 2) == 2, F.sub(torch.zeros_like(r), r), r)
    t = F.mul(x, y)
    return torch.stack([x, y, one, t])


def expand_compressed_points_plain(wire, arith: str = "u32"):
    """Plain PyTorch version of K1: (B, 33, N) uint8 → (B, 4, NLIMBS, N)
    int16, in CHUNK_LANES-lane steps; canonical limbs (`arith="u32"`, the
    default K1's) or the 20-limb chain's (`"l20"`)."""
    _check_arith(arith)
    B, rows, N = wire.shape
    flat = wire.permute(1, 0, 2).reshape(33, B * N)
    out = torch.empty((4, NLIMBS, B * N), dtype=torch.int16,
                      device=wire.device)
    for lo in range(0, B * N, CHUNK_LANES):
        blk = flat[:, lo:lo + CHUNK_LANES]
        pts = decompress_block(blk[:32], blk[32])
        if arith == "u32":
            pts = F.canonical_limbs20(pts.movedim(1, 0)).movedim(0, 1)
        out[..., lo:lo + CHUNK_LANES] = pts.to(torch.int16)
    return out.reshape(4, NLIMBS, B, N).permute(2, 0, 1, 3).contiguous()


def _check_arith(arith: str) -> None:
    if arith not in ("u32", "l20"):
        raise ValueError(f"arith must be u32 or l20: {arith!r}")


def _check_wire(wire):
    if wire.dtype != torch.uint8 or wire.ndim != 3 or wire.shape[1] != 33:
        raise ValueError(
            f"compressed wire must be (B, 33, N) uint8, got "
            f"{tuple(wire.shape)} {wire.dtype}")


def expand_compressed_points(wire, arith: str = "u32"):
    """(B, 33, N) uint8 compressed wire → (B, 4, NLIMBS, N) int16 extended
    coordinates.  Launches K1 on a CUDA tensor (`arith="l20"`: the lab's
    20-limb `expand_compressed-l20`); runs the plain version on a CPU
    tensor."""
    _check_wire(wire)
    _check_arith(arith)
    if wire.device.type == "cpu":
        return expand_compressed_points_plain(wire, arith)
    if wire.device.type != "cuda":
        raise ValueError(f"unsupported device {wire.device}")
    wire = wire.contiguous()
    B, _, N = wire.shape
    out = torch.empty((B, 4, NLIMBS, N), dtype=torch.int16,
                      device=wire.device)
    if B * N:
        _cuda.kernel("expand_compressed" if arith == "u32" else
                     "expand_compressed-l20").launch(
            wire.device, wire.data_ptr(), out.data_ptr(), B, N)
    return out
