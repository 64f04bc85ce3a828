"""A plain ZIP215 Ed25519 verifier in exact Python integers: the reference
that decides whether the benchmark's runs are `correct`.

It is written from RFC 8032 and ZIP 215 alone and imports nothing but the
standard library.  It decides a batch the way ZIP 215 states it: every
`s` below l, every A and R decompressing (non-canonical encodings accepted,
x = 0 with the sign bit set accepted), and the cofactored equation

    [8]([-sum z_i s_i]B + sum [z_i]R_i + sum [z_i k_i]A_i) = 0,
    k_i = SHA-512(R_i || A_i || M_i) mod l,

with 128-bit blinders z_i drawn from the caller's seeded generator.  The
multiscalar multiplication is a bucket (Pippenger) sum over extended
coordinates.  `cofactored=False` drops the [8]: the RFC 8032 "strict"
equation that a port might be tempted to use, which ZIP 215's small-order
entries fail; the benchmark's control runs it."""

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P
D2 = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)

IDENTITY = (0, 1, 1, 0)


def _sqrt_ratio(u, v):
    """The even x with v*x^2 = u, or None (u/v not a square)."""
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    if check == u % P:
        pass
    elif check == (-u) % P:
        r = r * SQRT_M1 % P
    else:
        return None
    return P - r if r & 1 else r


def decompress(enc: bytes):
    """ZIP 215 decompression of a 32-byte encoding to an extended point,
    or None.  y is the low 255 bits reduced mod p (non-canonical y
    accepted); the sign bit negates x even when x = 0."""
    if len(enc) != 32:
        return None
    y = (int.from_bytes(enc, "little") & ((1 << 255) - 1)) % P
    u = (y * y - 1) % P
    v = (D * y % P * y + 1) % P
    x = _sqrt_ratio(u, v)
    if x is None:
        return None
    if enc[31] >> 7:
        x = (-x) % P
    return (x, y, 1, x * y % P)


def add(p, q):
    """Complete addition on -x^2 + y^2 = 1 + d x^2 y^2 (extended
    coordinates, Hisil-Wong-Carter-Dawson 2008)."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    a = (Y1 - X1) * (Y2 - X2) % P
    b = (Y1 + X1) * (Y2 + X2) % P
    c = T1 * D2 % P * T2 % P
    d = 2 * Z1 * Z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def double(p):
    X, Y, Z, _ = p
    a = X * X % P
    b = Y * Y % P
    c = 2 * Z * Z % P
    h = a + b
    e = h - (X + Y) * (X + Y) % P
    g = a - b
    f = c + g
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def neg(p):
    X, Y, Z, T = p
    return ((-X) % P, Y, Z, (-T) % P)


def is_identity(p) -> bool:
    X, Y, Z, _ = p
    return X % P == 0 and (Y - Z) % P == 0


def equal(p, q) -> bool:
    return ((p[0] * q[2] - q[0] * p[2]) % P == 0
            and (p[1] * q[2] - q[1] * p[2]) % P == 0)


def scalar_mul(k: int, p):
    acc = IDENTITY
    for bit in bin(k)[2:] if k > 0 else "":
        acc = double(acc)
        if bit == "1":
            acc = add(acc, p)
    return acc


def to_affine(p):
    zi = pow(p[2], P - 2, P)
    x, y = p[0] * zi % P, p[1] * zi % P
    return (x, y, 1, x * y % P)


def compress(p) -> bytes:
    x, y, _, _ = to_affine(p)
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


BASEPOINT = decompress((4 * pow(5, P - 2, P) % P).to_bytes(32, "little"))


def challenge(R_bytes: bytes, A_bytes: bytes, msg: bytes) -> int:
    return int.from_bytes(
        hashlib.sha512(R_bytes + A_bytes + msg).digest(), "little") % L


def _window_bits(n: int) -> int:
    """Bucket width for n terms: about log2(n) - 3, which balances the
    per-term additions against the per-window bucket walk."""
    return max(4, min(16, n.bit_length() - 3))


def _niels(p):
    """(y + x, y - x, 2d x y, the point) of an extended point, made affine:
    the form a bucket adds with seven products instead of nine."""
    x, y, _, t = to_affine(p) if p[2] % P != 1 else p
    return ((y + x) % P, (y - x) % P, D2 * t % P, (x, y, 1, t))


def msm(scalars, points):
    """sum [s_i]P_i over non-negative scalars by buckets."""
    terms = [(s, _niels(p)) for s, p in zip(scalars, points) if s]
    if not terms:
        return IDENTITY
    c = _window_bits(len(terms))
    mask = (1 << c) - 1
    top = max(s.bit_length() for s, _ in terms)
    n_win = -(-top // c)
    acc = IDENTITY
    for w in reversed(range(n_win)):
        if acc is not IDENTITY:
            for _ in range(c):
                acc = double(acc)
        shift = w * c
        buckets = {}
        get = buckets.get
        for s, nl in terms:
            digit = (s >> shift) & mask
            if digit:
                b = get(digit)
                if b is None:
                    buckets[digit] = nl[3]
                    continue
                X1, Y1, Z1, T1 = b
                ypx, ymx, xy2d, _ = nl
                a = (Y1 - X1) * ymx % P
                bb = (Y1 + X1) * ypx % P
                cc = T1 * xy2d % P
                d = 2 * Z1
                e, f, g, h = bb - a, d - cc, d + cc, bb + a
                buckets[digit] = (e * f % P, g * h % P, f * g % P,
                                  e * h % P)
        if not buckets:
            continue
        running = None
        total = None
        prev = max(buckets)
        for digit in range(prev, 0, -1):
            b = buckets.get(digit)
            if b is not None:
                running = b if running is None else add(running, b)
            if running is not None:
                total = running if total is None else add(total, running)
        acc = add(acc, total)
    return acc


def _cofactor_check(p, cofactored: bool) -> bool:
    if cofactored:
        p = double(double(double(p)))
    return is_identity(p)


def verify_single(A_bytes, R_bytes, s_bytes, msg,
                  cofactored: bool = True) -> bool:
    """One signature under ZIP 215: [8]([s]B - R - [k]A) = 0."""
    s = int.from_bytes(s_bytes, "little")
    if len(s_bytes) != 32 or s >= L:
        return False
    A = decompress(A_bytes)
    R = decompress(R_bytes)
    if A is None or R is None:
        return False
    k = challenge(R_bytes, A_bytes, msg)
    lhs = add(scalar_mul(s, BASEPOINT),
              neg(add(R, scalar_mul(k, A))))
    return _cofactor_check(lhs, cofactored)


def verify_batch(entries, rng, cofactored: bool = True,
                 first=()) -> bool:
    """The ZIP 215 batch verdict over entries (A_bytes, R_bytes, s_bytes,
    msg).  `first` names entries checked one by one before the batch
    equation: a failing one decides False at once (an order of work, not
    a rule: a batch holding a signature that fails its own equation fails
    the batch equation too, but for a 2^-128 chance of the blinders)."""
    for i in first:
        if not verify_single(*entries[i], cofactored=cofactored):
            return False
    b_coeff = 0
    key_coeff = {}
    key_point = {}
    r_scalars, r_points = [], []
    for A_bytes, R_bytes, s_bytes, msg in entries:
        s = int.from_bytes(s_bytes, "little")
        if len(s_bytes) != 32 or s >= L:
            return False
        if A_bytes not in key_point:
            A = decompress(A_bytes)
            if A is None:
                return False
            key_point[A_bytes] = A
            key_coeff[A_bytes] = 0
        R = decompress(R_bytes)
        if R is None:
            return False
        z = rng.getrandbits(128)
        k = challenge(R_bytes, A_bytes, msg)
        b_coeff += z * s
        key_coeff[A_bytes] += z * k
        r_scalars.append(z)
        r_points.append(R)
    scalars = [(-b_coeff) % L] + [key_coeff[a] % L for a in key_point] \
        + r_scalars
    points = [BASEPOINT] + list(key_point.values()) + r_points
    return _cofactor_check(msm(scalars, points), cofactored)
