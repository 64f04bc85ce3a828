"""Exact host Edwards25519 group arithmetic in extended coordinates.

Re-implements the `curve25519-dalek` point surface consumed by the reference
(SURVEY.md §2.2 N2-N4, N6-N7): complete addition on -x^2 + y^2 = 1 + d x^2 y^2
(a = -1 twisted Edwards; the addition law is complete because a is square and
d is non-square mod p), ZIP215 decompression (non-canonical encodings
accepted: reference src/verification_key.rs:160-175, tests/util/mod.rs:82-155),
compression, cofactor ops (reference src/batch.rs:212), fixed-base and
double-base scalar multiplication (reference src/signing_key.rs:139,
src/verification_key.rs:251).

All coordinates are exact Python ints mod p — this path decides every
consensus accept/reject verdict, so it never touches device arithmetic.
"""

from . import field
from .field import P, D, D2, SQRT_M1


class Point:
    """An Edwards25519 point in extended homogeneous coordinates (X:Y:Z:T)
    with x = X/Z, y = Y/Z, x*y = T/Z."""

    __slots__ = ("X", "Y", "Z", "T")

    def __init__(self, X: int, Y: int, Z: int, T: int):
        self.X = X
        self.Y = Y
        self.Z = Z
        self.T = T

    # -- group law ---------------------------------------------------------

    def add(self, other: "Point") -> "Point":
        """Complete unified addition (add-2008-hwcd-3 with a=-1, k=2d).
        Valid for ALL inputs, including doubling and torsion points."""
        X1, Y1, Z1, T1 = self.X, self.Y, self.Z, self.T
        X2, Y2, Z2, T2 = other.X, other.Y, other.Z, other.T
        A = (Y1 - X1) * (Y2 - X2) % P
        B = (Y1 + X1) * (Y2 + X2) % P
        C = T1 * D2 % P * T2 % P
        Dv = 2 * Z1 * Z2 % P
        E = (B - A) % P
        F = (Dv - C) % P
        G = (Dv + C) % P
        H = (B + A) % P
        return Point(E * F % P, G * H % P, F * G % P, E * H % P)

    __add__ = add

    def double(self) -> "Point":
        """Dedicated doubling (dbl-2008-hwcd with a=-1); agrees with
        `self.add(self)` — property-tested in tests/test_edwards.py."""
        X1, Y1, Z1 = self.X, self.Y, self.Z
        A = X1 * X1 % P
        B = Y1 * Y1 % P
        C = 2 * Z1 * Z1 % P
        E = ((X1 + Y1) * (X1 + Y1) - A - B) % P
        G = (B - A) % P  # a=-1: G = D' + B with D' = -A
        F = (G - C) % P
        H = (-A - B) % P
        return Point(E * F % P, G * H % P, F * G % P, E * H % P)

    def to_affine(self) -> "Point":
        """The same projective class with Z = 1 (one field inversion).
        Cached coefficient points are normalized once so their compressed
        encoding and device-wire hint can be computed (batch.py)."""
        from .field import P, inv

        zi = inv(self.Z % P)
        x = self.X * zi % P
        y = self.Y * zi % P
        return Point(x, y, 1, x * y % P)

    def neg(self) -> "Point":
        return Point((-self.X) % P, self.Y, self.Z, (-self.T) % P)

    __neg__ = neg

    def __sub__(self, other: "Point") -> "Point":
        return self.add(other.neg())

    def mul_by_cofactor(self) -> "Point":
        """[8]P — three doublings (reference src/batch.rs:212)."""
        return self.double().double().double()

    # -- predicates --------------------------------------------------------

    def is_identity(self) -> bool:
        """Projective identity test: (0 : 1 : 1 : 0) ⇔ X ≡ 0 and Y ≡ Z."""
        return self.X % P == 0 and (self.Y - self.Z) % P == 0

    def is_small_order(self) -> bool:
        """True iff the point is in the 8-torsion subgroup."""
        return self.mul_by_cofactor().is_identity()

    def __eq__(self, other) -> bool:
        if not isinstance(other, Point):
            return NotImplemented
        # cross-multiplied projective equality
        return (
            (self.X * other.Z - other.X * self.Z) % P == 0
            and (self.Y * other.Z - other.Y * self.Z) % P == 0
        )

    def __hash__(self):
        zi = field.inv(self.Z)
        return hash((self.X * zi % P, self.Y * zi % P))

    def __repr__(self):
        return f"Point({self.compress().hex()})"

    # -- scalar multiplication --------------------------------------------

    def scalar_mul(self, n: int) -> "Point":
        """[n]P by 4-bit fixed windows.  `n` is used as-is (callers decide
        reduction; verification scalars are already < ℓ, and unreduced
        clamped signing scalars only ever multiply the order-ℓ basepoint,
        matching dalek `Scalar::from_bits` semantics)."""
        if n < 0:
            raise ValueError("scalar must be non-negative")
        if n == 0:
            return identity()
        # table[j] = [j]P for j in 0..15
        table = [identity(), self]
        for _ in range(14):
            table.append(table[-1].add(self))
        digits = []
        while n:
            digits.append(n & 15)
            n >>= 4
        acc = table[digits[-1]]
        for dgt in reversed(digits[:-1]):
            acc = acc.double().double().double().double()
            acc = acc.add(table[dgt])
        return acc

    __mul__ = None  # use explicit methods

    # -- codec -------------------------------------------------------------

    def compress(self) -> bytes:
        """Canonical 32-byte encoding: reduced y with sign(x) in bit 255."""
        zi = field.inv(self.Z)
        x = self.X * zi % P
        y = self.Y * zi % P
        b = bytearray(y.to_bytes(32, "little"))
        b[31] |= (x & 1) << 7
        return bytes(b)


def identity() -> Point:
    return Point(0, 1, 1, 0)


def decompress(b: bytes):
    """ZIP215 decompression.  Returns a Point, or None if the 255-bit y gives
    a non-residue x^2.  Per ZIP215 rule 1 (reference
    src/verification_key.rs:160-175 and the taxonomy in
    tests/util/mod.rs:82-155):

    * non-canonical y encodings (y + p in 255 bits) are ACCEPTED and reduced;
    * x = 0 with sign bit 1 is ACCEPTED (yields the same point as sign 0),
      matching deployed implementations rather than RFC8032 §5.1.3.4.
    """
    if len(b) != 32:
        return None
    sign = b[31] >> 7
    y = field.from_bytes(b)
    u = (y * y - 1) % P
    v = (D * y % P * y + 1) % P
    x = field.sqrt_ratio(u, v)
    if x is None:
        return None
    if sign:
        x = (-x) % P
    return Point(x, y, 1, x * y % P)


def decompress_with_hint(b: bytes):
    """ZIP215 decompression + device-wire hint in ONE exponentiation
    chain: returns (Point, hint) or None.  Host staging uses it for every
    key and R encoding (running `decompress` and then
    `decompression_hint` would pay the dominant pow twice)."""
    if len(b) != 32:
        return None
    sign = b[31] >> 7
    y = field.from_bytes(b)
    u = (y * y - 1) % P
    v = (D * y % P * y + 1) % P
    res = field.sqrt_ratio_hint(u, v)
    if res is None:
        return None
    x, r, flip = res
    if sign:
        x = (-x) % P
    hint = (1 if flip else 0) | (0 if x == r else 2)
    return Point(x, y, 1, x * y % P), hint


def decompression_hint(y: int, x: int) -> int:
    """Device-wire hint bits for on-device x-recomputation
    (ops/torch_decompress.py): given a point's y and its ZIP215-decompressed
    x (both mod p, any representatives), compute bit0 = the RFC 8032
    candidate root r₀ = u·v³·(u·v⁷)^((p−5)/8) needs the sqrt(−1) fixup,
    and bit1 = the final x is the (post-fixup) candidate's negation.
    Pure data derived from the host's own decompression — the device
    applies them as arithmetic selects, never as accept/reject logic.
    Agrees with `decompress_with_hint` on every decompressable
    encoding."""
    y %= P
    x %= P
    u = (y * y - 1) % P
    v = (D * y % P * y + 1) % P
    r0 = u * pow(v, 3, P) % P * pow(u * pow(v, 7, P) % P,
                                    (P - 5) // 8, P) % P
    chk = v * r0 % P * r0 % P
    flip = chk != u and chk == (P - u) % P
    r = r0 * SQRT_M1 % P if flip else r0
    return (1 if flip else 0) | (0 if x == r else 2)


def compress_with_hint(pt: "Point"):
    """(32-byte encoding, hint byte) for an AFFINE host point — the
    compressed-wire form of cached coefficient points (basepoint and
    [2^128]·key shift points, batch.py)."""
    if pt.Z % P != 1:
        raise ValueError("compress_with_hint requires Z = 1 points")
    return pt.compress(), decompression_hint(pt.Y, pt.X)


# -- basepoint and fixed-base table ---------------------------------------

# B = (x, 4/5) with the even root for x (RFC 8032 §5.1).
_By = 4 * pow(5, P - 2, P) % P
BASEPOINT = decompress(_By.to_bytes(32, "little"))
assert BASEPOINT is not None

_BASE_TABLE = None  # 64 rows × 16 entries: row i entry j = [j * 16^i]B


def _base_table():
    global _BASE_TABLE
    if _BASE_TABLE is None:
        rows = []
        base = BASEPOINT
        for _ in range(64):
            row = [identity(), base]
            for _j in range(14):
                row.append(row[-1].add(base))
            rows.append(row)
            base = row[8].double()  # [16^(i+1)]B = 2*[8*16^i]B
        _BASE_TABLE = rows
    return _BASE_TABLE


def basepoint_mul(s: int) -> Point:
    """[s]B via the precomputed radix-16 table (dalek
    `ED25519_BASEPOINT_TABLE`, reference src/signing_key.rs:139,191).
    Accepts unreduced 255/256-bit scalars."""
    if s < 0:
        raise ValueError("scalar must be non-negative")
    table = _base_table()
    acc = identity()
    i = 0
    while s and i < 64:
        acc = acc.add(table[i][s & 15])
        s >>= 4
        i += 1
    if s:  # scalars ≥ 2^256 are a caller bug
        raise ValueError("scalar too large for fixed-base table")
    return acc


def double_scalar_mul_basepoint(a: int, A: Point, b: int) -> Point:
    """[a]A + [b]B, the single-verification hot path (dalek
    `vartime_double_scalar_mul_basepoint`, reference
    src/verification_key.rs:251).  The [b]B half rides the fixed-base table
    so only the [a]A half pays doublings."""
    return A.scalar_mul(a).add(basepoint_mul(b))


def shift128(p: Point) -> Point:
    """[2^128]P by 128 exact doublings — the host-side half of the device
    MSM's uniform-128-bit-scalar split (ops/msm.py): a ≥2^128 coefficient c
    on P becomes c_lo on P plus c_hi on shift128(P).  batch.py caches the
    result per verification key."""
    for _ in range(128):
        p = p.double()
    return p


_BASEPOINT_SHIFT128 = None


def basepoint_shift128() -> Point:
    """[2^128]B, precomputed once for the basepoint coefficient split.
    Affine (Z = 1) so it has a compressed device-wire encoding."""
    global _BASEPOINT_SHIFT128
    if _BASEPOINT_SHIFT128 is None:
        _BASEPOINT_SHIFT128 = shift128(BASEPOINT).to_affine()
    return _BASEPOINT_SHIFT128


def multiscalar_mul(scalars, points, chunk: int = 1024) -> Point:
    """Σ [c_i]P_i — host MSM (dalek `VartimeMultiscalarMul`, reference
    src/batch.rs:207-210).  Straus with shared doublings and per-point 4-bit
    tables; exact, variable-time (verification uses no secrets).

    Memory is bounded by `chunk`: terms are processed in chunks of at most
    that many points, so at most 16·chunk table entries are ever live —
    this is the port's host-backend MSM and must survive 100k+-term
    batches.  The only cost of chunking is repeating the shared window
    doublings per chunk (~128 doubles each — noise next to the per-term
    table builds), and the chunk partials add up exactly (the group is
    commutative/associative)."""
    scalars = list(scalars)
    points = list(points)
    if len(scalars) != len(points):
        raise ValueError("scalar/point length mismatch")
    if not scalars:
        return identity()
    if chunk < 1:
        raise ValueError("chunk must be positive")
    if len(scalars) > chunk:
        acc = identity()
        for lo in range(0, len(scalars), chunk):
            acc = acc.add(
                multiscalar_mul(
                    scalars[lo:lo + chunk], points[lo:lo + chunk], chunk
                )
            )
        return acc
    tables = []
    for Pt in points:
        row = [identity(), Pt]
        for _ in range(14):
            row.append(row[-1].add(Pt))
        tables.append(row)
    nwin = (max(max(scalars).bit_length(), 1) + 3) // 4
    acc = identity()
    for w in range(nwin - 1, -1, -1):
        if w != nwin - 1:
            acc = acc.double().double().double().double()
        shift = 4 * w
        for s, row in zip(scalars, tables):
            dgt = (s >> shift) & 15
            if dgt:
                acc = acc.add(row[dgt])
    return acc


# -- torsion utilities (test support; SURVEY.md §2.2 N11) ------------------


def _find_order8_point() -> Point:
    """Deterministically locate an 8-torsion generator: [ℓ]Q kills the
    prime-order component of any point Q, leaving its torsion part; scan
    small-y points until that part has exact order 8."""
    from .scalar import L

    for y in range(2, 256):
        for sign in (0, 1):
            enc = bytearray(y.to_bytes(32, "little"))
            enc[31] |= sign << 7
            pt = decompress(bytes(enc))
            if pt is None:
                continue
            t = pt.scalar_mul(L)
            if t.is_small_order() and not t.double().double().is_identity():
                return t
    raise AssertionError("unreachable: 8-torsion generator exists")


_EIGHT_TORSION = None


def eight_torsion():
    """The 8 torsion points [k]T8, k=0..7, for an order-8 generator T8
    (dalek `EIGHT_TORSION`, reference tests/small_order.rs:3,18)."""
    global _EIGHT_TORSION
    if _EIGHT_TORSION is None:
        t8 = _find_order8_point()
        pts = [identity()]
        for _ in range(7):
            pts.append(pts[-1].add(t8))
        _EIGHT_TORSION = pts
    return _EIGHT_TORSION
