"""Exact host arithmetic modulo the Ed25519 group order ℓ.

Re-implements the `curve25519-dalek` `Scalar` surface the reference consumes
(SURVEY.md §2.2 N5): canonical parsing with the ZIP215 `s < ℓ` rejection rule
(reference src/verification_key.rs:239-240, src/batch.rs:193), the unreduced
255-bit `from_bits` form used for clamped signing scalars (reference
src/signing_key.rs:128), and the 64-byte wide reduction `from_hash`
(reference src/verification_key.rs:226, src/batch.rs:86, src/signing_key.rs:189).

Scalars are plain Python ints.  Like dalek's `Scalar::from_bits`, values may
be held *unreduced* (up to 255 bits) — arithmetic helpers reduce mod ℓ, while
`to_bytes` preserves the held value so clamped signing keys round-trip
byte-exactly (reference src/signing_key.rs:31-78 serde tuple format).
"""

import hashlib

# ℓ = 2^252 + 27742317777372353535851937790883648493, the prime order of the
# basepoint subgroup.
L = 2**252 + 27742317777372353535851937790883648493


def from_canonical_bytes(b: bytes):
    """Parse 32 bytes as a scalar, returning None unless the value is
    canonical (< ℓ).  This is ZIP215 rule 2: `s_bytes` MUST represent an
    integer less than ℓ (reference src/verification_key.rs:239-240)."""
    if len(b) != 32:
        return None
    v = int.from_bytes(b, "little")
    if v >= L:
        return None
    return v


def from_bits(b: bytes) -> int:
    """Parse 32 bytes as an unreduced 255-bit integer (bit 255 masked),
    matching dalek `Scalar::from_bits` (reference src/signing_key.rs:128).
    The value is NOT reduced mod ℓ; `to_bytes` round-trips it exactly."""
    if len(b) != 32:
        raise ValueError("scalar encoding must be 32 bytes")
    return int.from_bytes(b, "little") & ((1 << 255) - 1)


def from_wide_bytes(b: bytes) -> int:
    """Reduce a 64-byte little-endian integer mod ℓ (dalek
    `Scalar::from_bytes_mod_order_wide`, the tail of `Scalar::from_hash`)."""
    if len(b) != 64:
        raise ValueError("wide scalar encoding must be 64 bytes")
    return int.from_bytes(b, "little") % L


def from_hash(h: "hashlib._Hash") -> int:
    """dalek `Scalar::from_hash`: finalize a SHA-512 state and wide-reduce
    (reference src/verification_key.rs:226-231)."""
    return from_wide_bytes(h.digest())


def reduce(a: int) -> int:
    return a % L


def add(a: int, b: int) -> int:
    return (a + b) % L


def sub(a: int, b: int) -> int:
    return (a - b) % L


def mul(a: int, b: int) -> int:
    return (a * b) % L


def neg(a: int) -> int:
    return (-a) % L


def to_bytes(a: int) -> bytes:
    """32-byte little-endian encoding of the held value (which may be an
    unreduced `from_bits` value — dalek preserves those bytes too)."""
    if not 0 <= a < (1 << 256):
        raise ValueError("scalar out of encodable range")
    return a.to_bytes(32, "little")
