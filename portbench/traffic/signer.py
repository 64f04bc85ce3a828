"""The benchmark's own Ed25519 signer, in plain Python integers.

Verification reads only A, R, s and M, so a signature made here costs the
verifier exactly what any other valid signature costs.  To make a pool of
many keys quickly, keys and nonces are stepped: key i is a_0 + i with
A_i = A_{i-1} + B, nonce j is r_0 + j with R_j = R_{j-1} + B, one point
addition each, and the points are compressed with one batched inversion.
a_0 and r_0 come from the caller's seeded generator, so the same seed gives
the same bytes."""

from portbench.reference.ed25519_ref import (BASEPOINT, IDENTITY, L, P, add,
                                             challenge, decompress,
                                             scalar_mul)


def compress_many(points) -> list:
    """32-byte encodings of extended points, with one field inversion for
    all of them (Montgomery's trick)."""
    zs = [p[2] % P for p in points]
    prefix = []
    acc = 1
    for z in zs:
        prefix.append(acc)
        acc = acc * z % P
    inv = pow(acc, P - 2, P)
    out = [b""] * len(points)
    for i in range(len(points) - 1, -1, -1):
        zi = inv * prefix[i] % P
        inv = inv * zs[i] % P
        x = points[i][0] * zi % P
        y = points[i][1] * zi % P
        out[i] = (y | ((x & 1) << 255)).to_bytes(32, "little")
    return out


def stepped_points(start: int, n: int, step: int = 1) -> list:
    """Encodings of [start + i * step]B for i in range(n), one addition
    each."""
    p = scalar_mul(start % L, BASEPOINT)
    q = scalar_mul(step % L, BASEPOINT)
    pts = []
    for _ in range(n):
        pts.append(p)
        p = add(p, q)
    return compress_many(pts)


class KeyRange:
    """n signing keys a_0 + i, their public encodings in `public`."""

    def __init__(self, rng, n: int):
        self.a0 = rng.randrange(1, L)
        self.public = stepped_points(self.a0, n)

    def scalar(self, i: int) -> int:
        return (self.a0 + i) % L

    def shift128_public(self) -> list:
        """Encodings of [2^128]A_i, the split-high points the port stages
        for each key."""
        return stepped_points(self.a0 << 128, len(self.public), 1 << 128)


class NonceRange:
    """n nonces r_0 + j and their R encodings."""

    def __init__(self, rng, n: int):
        self.r0 = rng.randrange(1, L)
        self.public = stepped_points(self.r0, n)

    def scalar(self, j: int) -> int:
        return (self.r0 + j) % L


def sign_with(a: int, A_bytes: bytes, r: int, R_bytes: bytes,
              msg: bytes) -> bytes:
    """The 64-byte signature R || s of msg under key a, nonce r."""
    s = (r + challenge(R_bytes, A_bytes, msg) * a) % L
    return R_bytes + s.to_bytes(32, "little")


def tamper(sig: bytes, rng) -> bytes:
    """sig with s moved to another value below l (a well-formed signature
    that fails its equation)."""
    s = int.from_bytes(sig[32:], "little")
    s2 = (s + rng.randrange(1, L)) % L
    return sig[:32] + s2.to_bytes(32, "little")


def window_tampering(rng, count: int, within_calls: int,
                     units_per_call: int) -> dict:
    """{unit: half} for the `count` tampered units of a measured window,
    whose call 0 holds units 0 .. units_per_call - 1.  Each lies in a call
    of its own, drawn from rng among the window's first `within_calls`;
    the k-th lies in half k % 2 of its call's units (a call of one unit
    is its own half), and `half` is the half of its entries that holds
    its altered signature.  So every window holds the same number of
    tampered units, and leaving out either half of a call, or of a
    batch, always drops one of them."""
    if not 0 < count <= within_calls:
        raise ValueError("need 0 < count <= within_calls")
    out = {}
    for k, call in enumerate(sorted(rng.sample(range(within_calls),
                                               count))):
        n, half = units_per_call, k % 2
        lo, hi = ((0, n // 2), (n // 2, n))[half] if n > 1 else (0, 1)
        out[call * n + rng.randrange(lo, hi)] = half
    return out


def tampered_at(entries: list, half: int, tamperable: int, rng) -> int:
    """Alter one signature among entries[:tamperable], drawn from rng in
    half `half` of the whole batch; returns its index."""
    mid = len(entries) // 2
    bad = rng.randrange(*((0, mid), (mid, tamperable))[half])
    A, sig, msg = entries[bad]
    entries[bad] = (A, tamper(sig, rng), msg)
    return bad


def _eight_torsion_encodings() -> list:
    """The 8 canonical encodings of the 8-torsion subgroup, from a point
    of order 8."""
    t8 = decompress(bytes.fromhex(
        "c7176a703d4dd84fba3c0b760d10670f"
        "2a2053fa2c39ccc64ec7fd7792ac037a"))
    pts, p = [], IDENTITY
    for _ in range(8):
        pts.append(p)
        p = add(p, t8)
    return compress_many(pts)


def _low_order_non_canonical() -> list:
    """The 6 low-order non-canonical encodings: y = +-1 with the sign bit
    set, then y + p for y = 0 and 1 with either sign bit."""
    encs = []
    for y in (1, P - 1):
        e = bytearray(y.to_bytes(32, "little"))
        e[31] |= 0x80
        encs.append(bytes(e))
    for y in (0, 1):
        e = (P + y).to_bytes(32, "little")
        encs.append(e)
        hi = bytearray(e)
        hi[31] |= 0x80
        encs.append(bytes(hi))
    return encs


def zip215_matrix() -> list:
    """The 196-case small-order matrix: every (A, R) pair of the 14
    encodings with s = 0 and M = b"Zcash", all valid under ZIP 215, as
    (A_bytes, sig_bytes, msg)."""
    encs = _eight_torsion_encodings() + _low_order_non_canonical()
    zero = bytes(32)
    return [(a, r + zero, b"Zcash") for a in encs for r in encs]
