"""Exact host arithmetic over GF(2^255 - 19).

This is the consensus-critical field core: every accept/reject decision that
depends on field arithmetic (point decompression, canonicality, the final
identity check) runs through these exact Python-int routines, never through
device floating/limb math.  Mirrors the behavior the reference consumes from
`curve25519-dalek-ng` (reference Cargo.toml:18, u64_backend) — see SURVEY.md
§2.2 N1/N2.

Field elements are plain Python ints in [0, P).  Functions do not validate
range on entry; callers reduce with `% P` when ingesting untrusted data.
"""

# The field prime p = 2^255 - 19.
P = 2**255 - 19

# Edwards curve constant d = -121665/121666 mod p for -x^2 + y^2 = 1 + d x^2 y^2.
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P

# sqrt(-1) mod p, the canonical value used by RFC 8032 / dalek:
# 2^((p-1)/4) is a square root of -1 since p ≡ 5 (mod 8).
SQRT_M1 = pow(2, (P - 1) // 4, P)
assert (SQRT_M1 * SQRT_M1) % P == P - 1


def add(a: int, b: int) -> int:
    return (a + b) % P


def sub(a: int, b: int) -> int:
    return (a - b) % P


def mul(a: int, b: int) -> int:
    return (a * b) % P


def neg(a: int) -> int:
    return (-a) % P


def inv(a: int) -> int:
    """Multiplicative inverse via Fermat (a^(p-2)). inv(0) == 0 by convention."""
    return pow(a, P - 2, P)


def sqrt_ratio(u: int, v: int):
    """Return x with v*x^2 == u (mod p), choosing the nonnegative root, or
    None if u/v is a non-residue.  Matches dalek `FieldElement::sqrt_ratio_i`
    as exercised by `CompressedEdwardsY::decompress`
    (reference src/verification_key.rs:166).

    The candidate root is r = u * v^3 * (u * v^7)^((p-5)/8); then
    v*r^2 ∈ {u, -u, u*i, -u*i} and only the first two cases are squares.
    """
    res = sqrt_ratio_hint(u, v)
    return None if res is None else res[0]


def sqrt_ratio_hint(u: int, v: int):
    """Like `sqrt_ratio` but also expose the device-wire hint inputs
    from the SAME exponentiation chain: returns (x, r, flip) where x is
    the chosen even root, r the post-fixup candidate
    u·v³·(u·v⁷)^((p−5)/8)·i^flip, and flip whether the sqrt(−1) fixup
    fired; or None for a non-residue.  One pow chain serves both the
    decompression and the hint (ops/jnp_decompress wire)."""
    u %= P
    v %= P
    v3 = (v * v % P) * v % P
    v7 = (v3 * v3 % P) * v % P
    r = (u * v3 % P) * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    flip = 0
    if check == u:
        pass
    elif check == P - u:
        r = r * SQRT_M1 % P
        flip = 1
    elif u != 0:
        # check == ±u*i: not a square (u == 0 handled by check==u above).
        return None
    x = P - r if r & 1 else r  # the nonnegative (even-encoding) root
    return x, r, flip


def to_bytes(a: int) -> bytes:
    """Canonical 32-byte little-endian encoding of a (reduced first)."""
    return (a % P).to_bytes(32, "little")


def from_bytes(b: bytes) -> int:
    """Decode 32 bytes to a field element, masking bit 255 and reducing mod p.

    Non-canonical encodings (value in [p, 2^255)) are ACCEPTED and reduced —
    this is ZIP215 rule 1 as implemented by dalek `FieldElement::from_bytes`
    (exercised via reference src/verification_key.rs:166, tests/util/mod.rs:66-79).
    """
    if len(b) != 32:
        raise ValueError("field element encoding must be 32 bytes")
    return (int.from_bytes(b, "little") & ((1 << 255) - 1)) % P
