"""Host-side packing between exact Python ints and the device limb format.

Device representation (kept identical to the JAX package's, so both packages
stage byte-identical operands):

* A field element is **20 limbs of 13 bits** held in int32 while computing
  and stored as int16.  13-bit limbs keep every schoolbook partial product
  below 2^26 and a full 20-term column accumulation below 20·2^26 < 2^31, so
  int32 never overflows (proof in torch_field.py).
* Arrays are limb-major with the terms on the LAST axis: field element batch
  = (20, N), point batch = (4, 20, N) for extended coordinates (X, Y, Z, T).
* Scalars ship as MSB-first signed radix-16 digit planes (33, N) int8, or
  nibble-packed (17, N) uint8; the radix-32 kernel variant takes (27, N)
  int8 planes.
"""

import numpy as np

NLIMBS = 20
LIMB_BITS = 13
LIMB_MASK = (1 << LIMB_BITS) - 1
# 2^260 = 2^(13·20) ≡ 19·2^5 = 608 (mod p): the fold constant for carries
# escaping the top limb.
FOLD = 608


def int_to_limbs(x: int) -> np.ndarray:
    """Pack a field element (int in [0, 2^260)) into 20×13-bit limbs."""
    out = np.empty(NLIMBS, dtype=np.int32)
    for i in range(NLIMBS):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    if x:
        raise ValueError("value too large for 260-bit limb format")
    return out


def limbs_to_int(limbs) -> int:
    """Unpack (possibly unnormalized, possibly signed) limbs to an int."""
    acc = 0
    for i in reversed(range(len(limbs))):
        acc = (acc << LIMB_BITS) + int(limbs[i])
    return acc


def _ints_to_bits(values, nbytes: int) -> np.ndarray:
    """(N, 8*nbytes) little-endian bit matrix from a list of ints, built
    via bytes + np.unpackbits (the per-int Python cost is one to_bytes
    call)."""
    raw = b"".join(v.to_bytes(nbytes, "little") for v in values)
    arr = np.frombuffer(raw, dtype=np.uint8).reshape(len(values), nbytes)
    return np.unpackbits(arr, axis=1, bitorder="little")


# (13,) bit weights for assembling one limb from its bit window.
_LIMB_WEIGHTS = (1 << np.arange(LIMB_BITS, dtype=np.int64)).astype(np.int32)


def pack_field_batch(values) -> np.ndarray:
    """Pack a list of field ints (< 2^260) into a (NLIMBS, N) int32 array.
    Vectorized: bits → (N, NLIMBS, 13) → weighted sum."""
    bits = _ints_to_bits(values, 33)[:, : NLIMBS * LIMB_BITS]
    limbs13 = bits.reshape(len(values), NLIMBS, LIMB_BITS).astype(np.int32)
    return (limbs13 @ _LIMB_WEIGHTS).T.copy()


def pack_point_batch(points) -> np.ndarray:
    """Pack host extended-coordinate Points into (4, NLIMBS, N) int32."""
    from .field import P

    coords = [[pt.X % P for pt in points], [pt.Y % P for pt in points],
              [pt.Z % P for pt in points], [pt.T % P for pt in points]]
    return np.stack([pack_field_batch(c) for c in coords])


def pack_points_from_raw(raw: np.ndarray) -> np.ndarray:
    """Vectorized limb packing straight from canonical point bytes: (T,
    128) uint8 rows of X‖Y‖Z‖T 32-byte little-endian coordinates (the
    native decompression output) → (4, NLIMBS, T) int16."""
    n = raw.shape[0]
    coords = raw.reshape(n, 4, 32)
    bits = np.unpackbits(coords, axis=2, bitorder="little")  # (n, 4, 256)
    bits = np.concatenate(
        [bits, np.zeros((n, 4, NLIMBS * LIMB_BITS - 256), np.uint8)], axis=2
    )
    limbs13 = bits.reshape(n, 4, NLIMBS, LIMB_BITS).astype(np.int16)
    vals = limbs13 @ _LIMB_WEIGHTS.astype(np.int16)  # (n, 4, NLIMBS)
    return np.ascontiguousarray(np.moveaxis(vals, 0, 2))


def unpack_point(arr) -> "object":
    """Unpack a single device point (4, NLIMBS) back to an exact host Point.
    Limbs may be unnormalized; the host reduces mod p exactly."""
    from .edwards import Point
    from .field import P

    coords = [limbs_to_int(np.asarray(arr[c])) % P for c in range(4)]
    return Point(*coords)


WINDOW_BITS = 4
# Signed radix-16: 32 nibble windows for the uniform 128-bit scalars plus
# one carry window from the signed recoding.  Digits live in [-8, 7]
# (carry at v ≥ 8) so every digit fits a SIGNED NIBBLE — that is what
# lets the device wire pack two digits per byte (pack_digit_planes);
# the kernels' [0..8]P multiples tables are unaffected (|d| ≤ 8 still).
NWINDOWS = 33
PACKED_WINDOWS = (NWINDOWS + 1) // 2  # nibble-packed digit planes

# Signed radix-32, the kernel-variant axis `window_bits=5` (the JAX
# package's ops/limbs.py:109-120): 26 five-bit windows cover the 128-bit
# scalars, plus the carry window, so 27 planes; digits live in [-16, 15]
# against a 17-entry [0..16]P table.  They do not fit a signed nibble, so
# radix-32 has no packed digit wire: plain int8 planes only.
WINDOW_BITS_R32 = 5
NWINDOWS_R32 = 27


def windows_for_bits(window_bits: int, scalar_bits: int = 128) -> int:
    """Signed-digit plane count for `scalar_bits`-bit scalars at the given
    window width: ceil(scalar_bits / window_bits) unsigned windows plus the
    carry window of the signed recoding (33 at 4 bits, 27 at 5)."""
    return -(-scalar_bits // window_bits) + 1


def _recode_signed(d_le: np.ndarray, radix: int = 16) -> np.ndarray:
    """Unsigned little-endian radix digits (n, W) → signed digits
    (n, W+1) int8 with every digit in [-radix/2, radix/2 - 1]:
    d ≥ radix/2 becomes d - radix with a carry into the next window
    (vectorized over the batch)."""
    n, W = d_le.shape
    half = radix // 2
    out = np.zeros((n, W + 1), dtype=np.int8)
    carry = np.zeros(n, dtype=np.int32)
    for w in range(W):
        v = d_le[:, w].astype(np.int32) + carry
        carry = (v >= half).astype(np.int32)
        out[:, w] = (v - radix * carry).astype(np.int8)
    out[:, W] = carry.astype(np.int8)
    return out


def pack_digit_planes(digits: np.ndarray) -> np.ndarray:
    """Nibble-pack signed digit planes for the device wire: (NWINDOWS, N)
    int8 with digits in [-8, 7] → (PACKED_WINDOWS, N) uint8, halving the
    digit transfer.  Packed row w carries plane 2w in its LOW nibble and
    plane 2w+1 in its HIGH nibble; the odd final plane (the carry
    window) rides alone in the last packed row's low nibble.  The uint8
    dtype IS the format tag (plain planes are int8).  Inverse:
    ops.msm.expand_digits, and the window-sum kernel's digit load."""
    W, n = digits.shape
    if W != NWINDOWS:
        raise ValueError(f"pack_digit_planes needs {NWINDOWS} planes, "
                         f"got {W}")
    d = digits.astype(np.int32) & 0xF
    packed = np.zeros((PACKED_WINDOWS, n), dtype=np.uint8)
    packed[: W // 2] = (d[1::2] << 4) | d[0:-1:2]
    packed[-1] = d[-1]
    return packed


def pack_scalar_windows(scalars, nwindows: int = NWINDOWS,
                        window_bits: int = WINDOW_BITS) -> np.ndarray:
    """Pack scalars (< 2^((nwindows-1)·window_bits)) into MSB-first SIGNED
    radix-2^window_bits digit planes (nwindows, N) int8, digits in
    [-2^(window_bits-1), 2^(window_bits-1) - 1] (vectorized via
    np.unpackbits + carry recoding).  The default is the production
    radix-16 wire; window_bits=5 with NWINDOWS_R32 planes is the radix-32
    variant (the JAX package's ops/limbs.py:171-191)."""
    nub = nwindows - 1  # unsigned windows before recoding
    nbytes = (nub * window_bits + 7) // 8
    for s in scalars:
        if s >> (nub * window_bits):
            raise ValueError(
                f"scalar exceeds {nub} radix-{1 << window_bits} windows")
    bits = _ints_to_bits(scalars, nbytes)[:, : nub * window_bits]
    w = (1 << np.arange(window_bits, dtype=np.int32)).astype(np.int32)
    digits = bits.reshape(len(scalars), nub, window_bits).astype(
        np.int32
    ) @ w  # (N, nub) little-endian window order
    return np.ascontiguousarray(
        _recode_signed(digits, radix=1 << window_bits)[:, ::-1].T)


def pack_u128_windows(zb: np.ndarray) -> np.ndarray:
    """Vectorized digit packing for 128-bit blinders: (n, 16) uint8
    little-endian rows → (NWINDOWS, n) int8 MSB-first signed radix-16
    digit planes."""
    n = zb.shape[0]
    bits = np.unpackbits(zb, axis=1, bitorder="little")  # (n, 128)
    w = (1 << np.arange(WINDOW_BITS, dtype=np.int32)).astype(np.int32)
    digits = bits.reshape(n, 32, WINDOW_BITS).astype(np.int32) @ w
    return np.ascontiguousarray(_recode_signed(digits)[:, ::-1].T)


def identity_point_batch(n: int) -> np.ndarray:
    """(4, NLIMBS, n) int16 batch of the identity (0 : 1 : 1 : 0)."""
    out = np.zeros((4, NLIMBS, n), dtype=np.int16)
    out[1, 0, :] = 1
    out[2, 0, :] = 1
    return out


def pack_points_affine_from_raw(raw: np.ndarray) -> np.ndarray:
    """Affine wire: (T, 128) uint8 raw rows with Z = 1 (what decompression
    outputs) → (2, NLIMBS, T) int16 X‖Y limbs; T = X·Y and Z = 1 are
    rebuilt on the device (ops/msm.py expand_affine_points)."""
    return np.ascontiguousarray(pack_points_from_raw(raw)[:2])


def pack_point_affine_batch(points) -> np.ndarray:
    """Affine wire from host Points, which must have Z = 1
    (edwards.Point.to_affine) → (2, NLIMBS, N) int32."""
    from .field import P

    for pt in points:
        if pt.Z % P != 1:
            raise ValueError("affine packing requires Z = 1 points")
    return np.stack([pack_field_batch([pt.X % P for pt in points]),
                     pack_field_batch([pt.Y % P for pt in points])])


def identity_affine_batch(n: int) -> np.ndarray:
    """(2, NLIMBS, n) int16 affine-wire identity batch (x = 0, y = 1)."""
    out = np.zeros((2, NLIMBS, n), dtype=np.int16)
    out[1, 0, :] = 1
    return out


def identity_wire_batch(n: int) -> np.ndarray:
    """(33, n) uint8 compressed-wire identity batch: the y = 1 encoding
    (byte 0 = 1) with hint 0 — decompresses on-device to (0, 1)."""
    out = np.zeros((33, n), dtype=np.uint8)
    out[0, :] = 1
    return out
