"""An exact-integer model of csrc/fe25519_u32.cuh, step for step.

The kernels K2 and K2t compute in GF(2^255 - 19) on 8 x 32-bit words with
64-bit products (`mul.wide.u32`) and PTX carry chains (`add.cc`, `addc.cc`,
`sub.cc`, ...).  No
compiler for them runs on the CPU, so this module runs the same
instructions, in the same order, on Python ints: every word is checked to
lie in [0, 2^32) where an instruction reads or writes it, every carry or
borrow flag is 0 or 1, and where the CUDA source drops a carry-out (the
last instruction of a chain without `.cc`) the model asserts that it is 0.
The tests (tests/test_torch_fe_u32.py) hold the model against Python ints
mod p, and the card's self-test kernel (csrc/probes.cu `probe_fe8`) against
the model, word for word.

An element is a list of 8 words, least significant first, a value below
2^256 (the weak form; p = 2^255 - 19 < 2^256, so a residue may have two
representatives).  The closure note in fe25519_u32.cuh gives the bound each
step keeps; `check_weak` is the bound every operation's output must meet.

This module imports nothing outside the port.
"""

from .field import D2, P

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


def fe8_mul(a, b):
    """a · b: the 16-word product row by row — row i's 8 products by
    mul.wide, then two chains: the low halves into words i..i+7 with the
    carry into word i+8, the high halves into words i+1..i+8 (row 0 adds
    its high halves to its low halves in one chain) — then L + 38·H (the
    38·H_j by mul.wide; low halves, then high halves into a top word
    t ≤ 38), then 38·t added by a chain, then its carry's 38 into word 0."""
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
