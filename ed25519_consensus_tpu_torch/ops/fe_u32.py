"""An exact-integer model of csrc/fe25519_u32.cuh, step for step.

The kernels K1, K2, K2t, K3 and K4 compute in GF(2^255 - 19) on 8 x 32-bit
words with 64-bit products (`mul.wide.u32`) and PTX carry chains (`add.cc`,
`addc.cc`, `sub.cc`, ...).  No compiler for them runs on the CPU, so this
module runs the same instructions, in the same order, on Python ints: every
word is checked to lie in [0, 2^32) where an instruction reads or writes
it, every carry or borrow flag is 0 or 1, and where the CUDA source drops a
carry-out (the last instruction of a chain without `.cc`) the model asserts
that it is 0.  The tests (tests/test_torch_fe_u32.py) hold the model against
Python ints mod p, and the card's self-test kernel (csrc/probes.cu
`probe_fe8`) against the model, word for word.  `expand_lane`,
`tables_lane` and `fold_lane` are K1's and K4's bodies for one lane and
K3's for one (batch, window).

An element is a list of 8 words, least significant first, a value below
2^256 (the weak form; p = 2^255 - 19 < 2^256, so a residue may have two
representatives).  The closure note in fe25519_u32.cuh gives the bound each
step keeps; `check_weak` is the bound every operation's output must meet.

This module imports nothing outside the port.
"""

from .field import D, D2, P, SQRT_M1

M32 = 0xFFFFFFFF
WORDS = 8


class CarryLost(ArithmeticError):
    """A carry or borrow the CUDA source drops was not 0."""


def _w(*xs):
    for x in xs:
        if not 0 <= x <= M32:
            raise OverflowError(f"word {x:#x} outside 32 bits")


# -- one PTX instruction each ----------------------------------------------

def add_cc(a, b, cin=0):
    """add.cc.u32 (cin = 0) or addc.cc.u32: (sum word, carry out)."""
    _w(a, b)
    s = a + b + cin
    return s & M32, s >> 32


def sub_cc(a, b, bin_=0):
    """sub.cc.u32 (bin_ = 0) or subc.cc.u32: (difference word, borrow)."""
    _w(a, b)
    d = a - b - bin_
    return d & M32, 1 if d < 0 else 0


def mad_lo_cc(a, b, c, cin=0):
    """mad.lo.u32 / mad.lo.cc.u32 (cin = 0): lo(a*b) + c + cin."""
    _w(a, b, c)
    s = ((a * b) & M32) + c + cin
    return s & M32, s >> 32


def _no_carry(word, carry):
    """The last instruction of a chain without `.cc`: the carry it would
    produce is dropped, so it must be 0."""
    if carry:
        raise CarryLost("a carry out of a chain's last word was dropped")
    return word


# -- the field -------------------------------------------------------------

def to_words(x: int) -> list:
    if not 0 <= x < 1 << 256:
        raise ValueError("value outside [0, 2^256)")
    return [(x >> (32 * i)) & M32 for i in range(WORDS)]


def value(w) -> int:
    _w(*w)
    return sum(int(x) << (32 * i) for i, x in enumerate(w))


def check_weak(w) -> list:
    """The weak bound every operation keeps: 8 words of 32 bits, so the
    value is below 2^256."""
    if len(w) != WORDS:
        raise ValueError("an element has 8 words")
    _w(*w)
    return w


def fe8_add(a, b):
    """a + b: one chain over the 8 words; its carry c stands for 2^256 =
    38 (mod p), added back by a second chain; if that carries too, the
    value is below 38, so 38 more fit word 0 (the last multiply-add)."""
    r, c = [], 0
    for i in range(WORDS):
        x, c = add_cc(a[i], b[i], c)
        r.append(x)
    t = c * 38
    c = 0
    for i in range(WORDS):
        r[i], c = add_cc(r[i], t if i == 0 else 0, c)
    r[0] = _no_carry(*add_cc(r[0], c * 38))
    return check_weak(r)


def fe8_sub(a, b):
    """a - b: one borrow chain; a borrow means 2^256 was added, so 38 is
    subtracted (the sum gains 2p); a second borrow adds 2p once more, and
    then the value is at least 2^256 - 38, so word 0 absorbs the last 38.
    The result is a - b + k·2p, k ∈ {0, 1, 2}."""
    r, bw = [], 0
    for i in range(WORDS):
        x, bw = sub_cc(a[i], b[i], bw)
        r.append(x)
    t = (M32 if bw else 0) & 38  # subc.u32 bw, 0, 0 then and 38
    bw = 0
    for i in range(WORDS):
        r[i], bw = sub_cc(r[i], t if i == 0 else 0, bw)
    r[0] = _no_carry(*sub_cc(r[0], (M32 if bw else 0) & 38))
    return check_weak(r)


def fe8_neg(a):
    """-a as 0 - a (fe8_sub): never underflows."""
    return fe8_sub([0] * WORDS, a)


def mul_wide(a, b):
    """mul.wide.u32: the 64-bit product of two words as (low, high)."""
    _w(a, b)
    p = a * b
    return p & M32, p >> 32


def _reduce_wide(r):
    """The 16-word product r reduced to the weak form, L + 38·H: the
    38·H_j by mul.wide; low halves into L with the carry into a top word
    t, then high halves one word up, the last into t ≤ 38; then 38·t added
    by a chain, then its carry's 38 into word 0 (fe25519_u32.cuh
    fe8_reduce_wide, fe8_mul's and fe8_sq's tail)."""
    low, high = r[:WORDS], r[WORDS:]
    lo, hi = zip(*(mul_wide(high[j], 38) for j in range(WORDS)))
    c = 0
    for j in range(WORDS):
        low[j], c = add_cc(low[j], lo[j], c)
    top = c
    c = 0
    for j in range(WORDS - 1):
        low[j + 1], c = add_cc(low[j + 1], hi[j], c)
    top = _no_carry(*add_cc(top, hi[7], c))
    t = top * 38  # mul.lo.u32; top ≤ 38
    _w(t)
    c = 0
    for j in range(WORDS):
        low[j], c = add_cc(low[j], t if j == 0 else 0, c)
    low[0] = _no_carry(*mad_lo_cc(c, 38, low[0]))
    return check_weak(low)


def fe8_mul(a, b):
    """a · b: the 16-word product row by row — row i's 8 products by
    mul.wide, then two chains: the low halves into words i..i+7 with the
    carry into word i+8, the high halves into words i+1..i+8 (row 0 adds
    its high halves to its low halves in one chain) — then
    `_reduce_wide`."""
    r = [0] * 16
    lo, hi = zip(*(mul_wide(a[0], b[j]) for j in range(WORDS)))
    r[0] = lo[0]
    c = 0
    for j in range(1, WORDS):
        r[j], c = add_cc(lo[j], hi[j - 1], c)
    r[8] = _no_carry(*add_cc(hi[7], 0, c))
    for i in range(1, WORDS):
        lo, hi = zip(*(mul_wide(a[i], b[j]) for j in range(WORDS)))
        c = 0
        for j in range(WORDS):
            r[i + j], c = add_cc(r[i + j], lo[j], c)
        r[i + 8] = c  # addc.u32 r, 0, 0
        c = 0
        for j in range(WORDS - 1):
            r[i + j + 1], c = add_cc(r[i + j + 1], hi[j], c)
        r[i + 8] = _no_carry(*add_cc(r[i + 8], hi[7], c))
    return _reduce_wide(r)


def fe8_sq(a):
    """a²: the 28 cross products a_i·a_j, i < j, by rows as fe8_mul takes
    them — row 0's 7 in one chain into words 1..8; row i (1..6) its 7 − i
    low halves into words 2i+1..i+7 with the carry into word i+8, its high
    halves into words 2i+2..i+8 — then their sum doubled by one chain
    (carry into word 15), then the 8 squares a_i² added at words 2i, 2i+1
    by one chain (word 0 takes the first low half), then `_reduce_wide`:
    36 products in all."""
    r = [0] * 16
    lo, hi = [0] * WORDS, [0] * WORDS
    for j in range(1, WORDS):
        lo[j], hi[j] = mul_wide(a[0], a[j])
    r[1] = lo[1]
    c = 0
    for j in range(2, WORDS):
        r[j], c = add_cc(lo[j], hi[j - 1], c)
    r[8] = _no_carry(*add_cc(hi[7], 0, c))
    for i in range(1, WORDS - 1):
        lo, hi = zip(*(mul_wide(a[i], a[j]) for j in range(i + 1, WORDS)))
        c = 0
        for k, x in enumerate(lo):
            r[2 * i + 1 + k], c = add_cc(r[2 * i + 1 + k], x, c)
        r[i + 8] = c  # addc.u32 r, 0, 0
        c = 0
        for k, x in enumerate(hi):
            r[2 * i + 2 + k], c = add_cc(r[2 * i + 2 + k], x, c)
        _no_carry(0, c)
    c = 0
    for j in range(1, 15):
        r[j], c = add_cc(r[j], r[j], c)
    r[15] = c  # addc.u32 r15, 0, 0
    sq = [mul_wide(a[j], a[j]) for j in range(WORDS)]
    r[0] = sq[0][0]
    c = 0
    for j in range(1, 16):
        r[j], c = add_cc(r[j], sq[j // 2][j % 2], c)
    _no_carry(0, c)
    return _reduce_wide(r)


# The words of the limbs20 conversion: limb i sits at bit 13i; word k is
# complete once the limbs below bit 32(k + 1) are in.  _EMIT[i] is the
# word emitted after limb i, if any.
_EMIT = {2: 0, 4: 1, 7: 2, 9: 3, 12: 4, 14: 5, 17: 6}


def fe8_from_limbs20(limbs):
    """20 balanced 13-bit limbs (|limb| ≤ 8191) of a signed value V, |V| <
    2^260, → the weak form of V mod p.  A signed 64-bit accumulator takes
    limb i shifted to its offset in the current word and emits a word (its
    low 32 bits, then an arithmetic shift by 32) once no later limb can
    touch it; the last word keeps bits 224..254 and q = V >> 255 ∈ [-32,
    31] folds back as 19q (2^255 ≡ 19) by a chain with the sign of 19q
    extended; a negative total wraps to 2^256 + V' ≡ V' + 38, so the
    chain's carry word then subtracts 38 (giving V' + 2p ≥ 2^256 - 646)."""
    if len(limbs) != 20:
        raise ValueError("20 limbs")
    for x in limbs:
        if not -8191 <= int(x) <= 8191:
            raise ValueError(f"limb {x} outside [-8191, 8191]")
    acc, k, w = 0, 0, []
    for i, x in enumerate(limbs):
        acc += int(x) << (13 * i - 32 * k)
        if not -(1 << 63) <= acc < 1 << 63:
            raise OverflowError("the 64-bit accumulator overflowed")
        if i in _EMIT:
            w.append(acc & M32)
            acc >>= 32  # arithmetic
            k += 1
    w.append(acc & 0x7FFFFFFF)
    q = acc >> 31
    s = 19 * q
    sw, sx = s & M32, (M32 if s < 0 else 0)
    c = 0
    for i in range(WORDS):
        w[i], c = add_cc(w[i], sw if i == 0 else sx, c)
    cc = (sx + c) & M32  # addc.u32 cc, sx, 0
    t = cc & 38
    bw = 0
    for i in range(WORDS):
        w[i], bw = sub_cc(w[i], t if i == 0 else 0, bw)
    _no_carry(0, bw)
    return check_weak(w)


def fe8_to_limbs20_canonical(a):
    """The canonical residue of a (weak form) in [0, p), as 20 balanced
    13-bit limbs, |limb| ≤ 4096 (limbs 0..18 in [-4096, 4095]): fold bit
    255 as 19, then x ≥ p exactly when x + 19 has bit 255 set, which
    selects x + 19 - 2^255 = x - p; then the 13-bit fields, then the
    balanced split c = (u + 4096) >> 13, u -= 8192c, carried serially."""
    check_weak(a)
    x = list(a)
    q = x[7] >> 31
    x[7] &= 0x7FFFFFFF
    c = 0
    for i in range(WORDS):
        x[i], c = add_cc(x[i], 19 * q if i == 0 else 0, c)
    _no_carry(0, c)
    y, c = [], 0
    for i in range(WORDS):
        v, c = add_cc(x[i], 19 if i == 0 else 0, c)
        y.append(v)
    _no_carry(0, c)
    if y[7] >> 31:
        x = y
        x[7] &= 0x7FFFFFFF
    u = []
    for i in range(20):
        bit = 13 * i
        k, s = bit >> 5, bit & 31
        pair = x[k] | ((x[k + 1] if k + 1 < WORDS else 0) << 32)
        u.append((pair >> s) & 8191)
    for i in range(19):
        c = (u[i] + 4096) >> 13
        u[i] -= c * 8192
        u[i + 1] += c
    return u


# -- the complete addition -------------------------------------------------

D2_WORDS = to_words(D2 % P)
IDENTITY = [[0] * WORDS, [1] + [0] * 7, [1] + [0] * 7, [0] * WORDS]


def ge8_add(p, q, neg: bool = False):
    """Complete unified addition (add-2008-hwcd-3, a = -1, k = 2d) on
    (X, Y, Z, T) tuples of elements, the field-op sequence of
    fe25519.cuh ge_add with the ×2 as an add: every coordinate is the
    same residue as the 20-limb arithmetic gives.  With `neg`, p + (−q)
    as the kernel takes it: Y2 − X2 and Y2 + X2 trade places, and so do
    F and G, instead of negating X2 and T2."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    s1, a1 = fe8_sub(Y1, X1), fe8_add(Y1, X1)
    s2, a2 = fe8_sub(Y2, X2), fe8_add(Y2, X2)
    if neg:
        s2, a2 = a2, s2
    C = fe8_mul(fe8_mul(T1, D2_WORDS), T2)
    Dz = fe8_mul(Z1, Z2)
    A = fe8_mul(s1, s2)
    B = fe8_mul(a1, a2)
    D = fe8_add(Dz, Dz)
    E = fe8_sub(B, A)
    F = fe8_sub(D, C)
    G = fe8_add(D, C)
    H = fe8_add(B, A)
    if neg:
        F, G = G, F
    return [fe8_mul(E, F), fe8_mul(G, H), fe8_mul(F, G), fe8_mul(E, H)]


# -- K1: the ZIP215 point expansion of one lane ----------------------------

D_WORDS = to_words(D % P)
SQRTM1_WORDS = to_words(SQRT_M1 % P)
ONE = [1] + [0] * 7


def fe8_sqn(x, n: int):
    for _ in range(n):
        x = fe8_sq(x)
    return x


def fe8_pow22523(z):
    """z^((p − 5)/8) = z^(2^252 − 3): the 2^k − 1 ladder of
    csrc/expand_compressed.cu fe8_pow22523 (251 squarings, 11 products)."""
    t0 = fe8_sq(z)                        # z^2
    t1 = fe8_sqn(t0, 2)                   # z^8
    t1 = fe8_mul(t1, z)                   # z^9
    t0 = fe8_mul(t0, t1)                  # z^11
    t0 = fe8_sq(t0)                       # z^22
    t0 = fe8_mul(t1, t0)                  # z^(2^5-1)
    t1 = fe8_sqn(t0, 5)
    t0 = fe8_mul(t1, t0)                  # z^(2^10-1)
    t1 = fe8_sqn(t0, 10)
    t1 = fe8_mul(t1, t0)                  # z^(2^20-1)
    t2 = fe8_sqn(t1, 20)
    t1 = fe8_mul(t2, t1)                  # z^(2^40-1)
    t1 = fe8_sqn(t1, 10)
    t0 = fe8_mul(t1, t0)                  # z^(2^50-1)
    t1 = fe8_sqn(t0, 50)
    t1 = fe8_mul(t1, t0)                  # z^(2^100-1)
    t2 = fe8_sqn(t1, 100)
    t1 = fe8_mul(t2, t1)                  # z^(2^200-1)
    t1 = fe8_sqn(t1, 50)
    t0 = fe8_mul(t1, t0)                  # z^(2^250-1)
    t0 = fe8_sqn(t0, 2)                   # z^(2^252-4)
    return fe8_mul(t0, z)                 # z^(2^252-3)


def expand_lane(wire33):
    """K1's body for one lane (csrc/expand_compressed.cu): the 33 wire
    bytes (32 of y, little-endian, then the hint) → the canonical limbs of
    X, Y and T (3 × 20; Z = 1).  y is the 32 bytes as 8 words with bit 255
    masked, a weak value (y ≥ p, non-canonical, included); u = y² − 1, v =
    d·y² + 1, r = u·v³·(u·v⁷)^((p−5)/8); the hint's flip bit multiplies r
    by √−1 (by 1 without it) and its neg bit takes fe8_neg, as arithmetic;
    T = x·y."""
    b = [int(x) for x in wire33]
    if len(b) != 33 or not all(0 <= x < 256 for x in b):
        raise ValueError("a lane is 33 bytes")
    y = [b[4 * k] | b[4 * k + 1] << 8 | b[4 * k + 2] << 16 | b[4 * k + 3] << 24
         for k in range(WORDS)]
    y[7] &= 0x7FFFFFFF
    hint = b[32]
    yy = fe8_sq(y)
    u = fe8_sub(yy, ONE)
    v = fe8_add(fe8_mul(yy, D_WORDS), ONE)
    v3 = fe8_mul(fe8_sq(v), v)
    v7 = fe8_mul(fe8_sq(v3), v)
    uv3 = fe8_mul(u, v3)
    r = fe8_mul(uv3, fe8_pow22523(fe8_mul(u, v7)))
    r = fe8_mul(r, SQRTM1_WORDS if hint & 1 else ONE)
    x = fe8_neg(r) if hint & 2 else r
    t = fe8_mul(x, y)
    return [fe8_to_limbs20_canonical(c) for c in (x, y, t)]


# -- K4: the multiples table of one lane -----------------------------------

def tables_lane(limbs80):
    """K4's body for one lane (csrc/build_tables.cu): the lane's 80 input
    limbs (X, Y, Z, T, 20 each, in fe8_from_limbs20's bound) → the 9
    entries' canonical limbs, 9 × 80: entry 0 the identity, entry 1 P (a
    conversion, no addition), then K2's tree through ge8_add: T2 = P + P;
    T3 = T2 + P, T4 = T2 + T2; T5 = T4 + P, T6 = T4 + T2, T7 = T4 + T3,
    T8 = T4 + T4."""
    if len(limbs80) != 80:
        raise ValueError("a lane is 80 limbs")
    p = [fe8_from_limbs20(list(limbs80[20 * k:20 * k + 20]))
         for k in range(4)]
    t2 = ge8_add(p, p)
    t3 = ge8_add(t2, p)
    t4 = ge8_add(t2, t2)
    ents = [IDENTITY, p, t2, t3, t4] + [ge8_add(t4, q)
                                        for q in (p, t2, t3, t4)]
    return [[x for c in e for x in fe8_to_limbs20_canonical(c)]
            for e in ents]


# -- K3: the fold of one (batch, window) -----------------------------------

FOLD_THREADS = 128  # csrc/fold_partials.cu FOLD_THREADS


def _warp_fold(vals, live: int):
    """fold_partials.cu warp_fold on one warp's 32 lane values: halving
    levels s = 16, 8, 4, 2, 1; at each, lane l < s adds lane l + s's value
    (__shfl_down_sync) when l + s < live, then live = min(live, s).  The
    sum lands in lane 0."""
    s = 16
    while s:
        for lane in range(s):
            if lane + s < live:
                vals[lane] = ge8_add(vals[lane], vals[lane + s])
        live = min(live, s)
        s //= 2
    return vals[0]


def fold_lane(rows, threads: int = FOLD_THREADS):
    """K3's fold for one (batch, window), as csrc/fold_partials.cu takes
    it: `rows` the nchunk partials (each 80 limbs in the bound of
    fe8_from_limbs20: X, Y, Z, T) → 80 canonical limbs.  Thread t starts
    from partial t and adds partials t + threads, t + 2·threads, ... in
    order; each warp's accumulators meet in `_warp_fold`; the warps' sums
    meet in one more `_warp_fold` in warp 0.  nchunk − 1 additions; no
    partials give the identity."""
    pts = [[fe8_from_limbs20(list(r[20 * k:20 * k + 20])) for k in range(4)]
           for r in rows]
    held = min(len(pts), threads)
    acc = pts[:held]
    for c0 in range(threads, len(pts), threads):
        for t, p in enumerate(pts[c0:c0 + threads]):
            acc[t] = ge8_add(acc[t], p)
    sums = [_warp_fold(acc[w:w + 32] + [None] * (32 - len(acc[w:w + 32])),
                       len(acc[w:w + 32]))
            for w in range(0, held, 32)]
    res = _warp_fold(sums + [None] * (32 - len(sums)), len(sums)) \
        if sums else IDENTITY
    return [x for c in res for x in fe8_to_limbs20_canonical(c)]
