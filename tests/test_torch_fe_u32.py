"""The exact-integer model of the fe8 field arithmetic of K1, K2, K2t and K3
(`ed25519_consensus_tpu_torch.ops.fe_u32`, the model of
csrc/fe25519_u32.cuh instruction for instruction) against Python ints mod
p, on hypothesis draws and on fixed edge operands: 0, 1, p − 1, p, p + 1,
2^255 − 1, 2^256 − 1, 2^256 − 19k and 2^256 − 38, and limbs20 vectors at
±8191.  Every instruction of the model checks that its words lie in 32
bits and that no carry its CUDA source drops is set, so a run that passes
shows that no word leaves 32 bits and no carry is lost on these inputs;
every operation's output must meet the weak bound (below 2^256).  The
complete addition is held against the exact host addition and, residue
by residue, against the 20-limb plain arithmetic (torch_edwards), whose
op sequence it keeps.  fe8_sq is held against Python ints and against
fe8_mul(a, a) as residues (the models of K1's and K3's bodies are held in
tests/test_torch_fe_u32_kernels.py).  Tolerance: exact."""

import random

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from ed25519_consensus_tpu_torch.ops import edwards, limbs, probes
from ed25519_consensus_tpu_torch.ops import fe_u32 as M
from ed25519_consensus_tpu_torch.ops import torch_edwards as TE
from ed25519_consensus_tpu_torch.ops import torch_field as TF
from ed25519_consensus_tpu_torch.ops.field import P
from ed25519_consensus_tpu_torch.ops.scalar import L

from torch_threads import _one_torch_thread  # noqa: F401


EDGES = probes.FE8_EDGES
words256 = st.integers(min_value=0, max_value=(1 << 256) - 1)
limb = st.integers(min_value=-8191, max_value=8191)
limbs20 = st.lists(limb, min_size=20, max_size=20)


def _weak(w) -> int:
    assert len(w) == 8 and all(0 <= x <= M.M32 for x in w)
    return M.value(w)


def _limbs_value(l) -> int:
    return sum(int(x) << (13 * i) for i, x in enumerate(l))


def _check_field_ops(a: int, b: int) -> None:
    A, B = M.to_words(a), M.to_words(b)
    assert _weak(M.fe8_add(A, B)) % P == (a + b) % P
    assert _weak(M.fe8_sub(A, B)) % P == (a - b) % P
    assert _weak(M.fe8_mul(A, B)) % P == (a * b) % P
    assert _weak(M.fe8_neg(A)) % P == (-a) % P


def _check_square(a: int) -> None:
    """fe8_sq against Python ints mod p, and against fe8_mul(a, a) as a
    residue (the two may give different weak words)."""
    A = M.to_words(a)
    sq = _weak(M.fe8_sq(A))
    assert sq % P == a * a % P
    assert sq % P == M.value(M.fe8_mul(A, A)) % P


def _check_canonical(a: int) -> None:
    got = M.fe8_to_limbs20_canonical(M.to_words(a))
    assert _limbs_value(got) == a % P
    assert all(-4096 <= x <= 4095 for x in got[:19]) and 0 <= got[19] <= 256
    # the conversions compose to the canonical residue
    assert M.fe8_to_limbs20_canonical(M.fe8_from_limbs20(got)) == got


@pytest.mark.parametrize("a", EDGES, ids=[hex(e)[:12] for e in EDGES])
def test_edge_operands(a):
    for b in EDGES:
        _check_field_ops(a, b)
    _check_canonical(a)
    _check_square(a)


@settings(max_examples=300, deadline=None)
@given(words256)
def test_square_mod_p(a):
    _check_square(a)


def test_square_on_random_rows_and_word_patterns():
    """fe8_sq on 500 random operands and on words at 0, 1 and 2^32 − 1 in
    every position (the cross products' carries at their largest)."""
    rng = random.Random(0x5E)
    vals = [rng.getrandbits(256) for _ in range(500)]
    for w in (0, 1, M.M32):
        for k in range(8):
            vals.append(sum((w if i >= k else M.M32) << (32 * i)
                            for i in range(8)))
    for a in vals:
        _check_square(a)


@settings(max_examples=300, deadline=None)
@given(words256, words256)
def test_field_ops_mod_p(a, b):
    _check_field_ops(a, b)


@settings(max_examples=200, deadline=None)
@given(words256)
def test_canonical_limbs(a):
    _check_canonical(a)


@settings(max_examples=300, deadline=None)
@given(limbs20)
def test_from_limbs20(l):
    w = M.fe8_from_limbs20(l)
    assert _weak(w) % P == _limbs_value(l) % P
    canon = M.fe8_to_limbs20_canonical(w)
    assert _limbs_value(canon) == _limbs_value(l) % P


@pytest.mark.parametrize("l", [
    [8191] * 20, [-8191] * 20, [0] * 20, [-1] + [0] * 19,
    [0] * 19 + [-8191], [0] * 19 + [8191], [-8191] + [0] * 19,
    [8191 if i % 2 else -8191 for i in range(20)],
    [-8191 if i % 2 else 8191 for i in range(20)],
    [0] * 18 + [-8191, 8191], [4096] * 19 + [256], [-4096] * 20,
], ids=lambda l: f"{l[0]}..{l[-1]}")
def test_from_limbs20_at_the_bound(l):
    """The limbs20 edges, negative values included (the x = 0 points with
    the sign bit set give −0: all-zero limbs of a negated coordinate)."""
    w = M.fe8_from_limbs20(l)
    assert _weak(w) % P == _limbs_value(l) % P
    assert M.fe8_to_limbs20_canonical(w) == [
        int(x) for x in TF.canonical_limbs20(
            torch.tensor(l, dtype=torch.int32)[:, None])[:, 0]]


def test_torch_canonical_limbs_equal_the_model():
    """torch_field.canonical_limbs20 (the plain versions' last step) and
    the model's fe8_to_limbs20_canonical (the kernels') give the same
    limbs for any limbs in the bound: the representation is unique."""
    rng = random.Random(20)
    rows = [[rng.randint(-8191, 8191) for _ in range(20)]
            for _ in range(400)]
    rows += [[rng.choice((-8191, 8191)) for _ in range(20)]
             for _ in range(50)]
    got = TF.canonical_limbs20(torch.tensor(rows, dtype=torch.int32).T)
    for j, l in enumerate(rows):
        assert [int(x) for x in got[:, j]] == \
            M.fe8_to_limbs20_canonical(M.fe8_from_limbs20(l))


def test_the_model_checks_words_and_carries():
    """A word outside 32 bits, or a dropped carry that is set, raises:
    the checks the passing runs above rely on are live."""
    with pytest.raises(OverflowError):
        M.add_cc(1 << 32, 0)
    with pytest.raises(OverflowError):
        M.mad_lo_cc(-1, 1, 0)
    with pytest.raises(M.CarryLost):
        M._no_carry(5, 1)
    with pytest.raises(ValueError):
        M.fe8_from_limbs20([8192] + [0] * 19)
    with pytest.raises(ValueError):
        M.to_words(1 << 256)


def _point_words(pt):
    return [M.to_words(c % P) for c in (pt.X, pt.Y, pt.Z, pt.T)]


@pytest.mark.parametrize("neg", [False, True])
def test_complete_addition_matches_host_and_the_limb_arithmetic(neg):
    """ge8_add (and its sign flag, p + (−q) by swapping operands) equals
    the exact host addition as a projective point and the 20-limb plain
    addition coordinate by coordinate mod p (the same op sequence), on
    torsion points, random multiples, the identity and doublings."""
    rng = random.Random(0xADD + neg)
    pool = edwards.eight_torsion() + [
        edwards.basepoint_mul(rng.randrange(1, L)) for _ in range(6)]
    pairs = [(a, b) for a in pool[:8] for b in pool[6:]]
    pairs += [(p, p) for p in pool]
    for p, q in pairs:
        got = M.ge8_add(_point_words(p), _point_words(q), neg)
        X, Y, Z, T = (M.value(c) % P for c in got)
        want = p.add(q.neg() if neg else q)
        assert edwards.Point(X, Y, Z, T) == want
        ql = limbs.pack_point_batch([q]).astype("int32")
        if neg:
            ql[0] = -ql[0]
            ql[3] = -ql[3]
        lim = TE.point_add(torch.from_numpy(
            limbs.pack_point_batch([p]).astype("int32")),
            torch.from_numpy(ql)).numpy()[..., 0]
        assert [X, Y, Z, T] == [limbs.limbs_to_int(lim[c]) % P
                                for c in range(4)]


def test_doubling_matches_host_and_the_limb_arithmetic():
    """ge8_dbl (K7's step) equals the host's Point.double coordinate for
    coordinate mod p (the same formula: the doubling K7 takes 128 times)
    and torch_edwards.point_double residue by residue, on the torsion
    points, the identity, random multiples and projective points with
    Z ≠ 1; its words and carries stay inside the model's checks."""
    rng = random.Random(0xDB1)
    pool = edwards.eight_torsion() + [edwards.Point(0, 1, 1, 0)] + [
        edwards.basepoint_mul(rng.randrange(1, L)) for _ in range(6)]
    pool += [edwards.shift128(p) for p in pool[-2:]]  # Z ≠ 1
    pool.append(edwards.Point(0, P - 1, P - 1, 0))  # the identity, Z = −1
    pts = torch.from_numpy(limbs.pack_point_batch(pool).astype("int32"))
    lim = TE.point_double(pts).numpy()
    for i, p in enumerate(pool):
        got = M.ge8_dbl(_point_words(p))
        for c in got:
            _weak(c)
        X, Y, Z, T = (M.value(c) % P for c in got)
        want = p.double()
        assert [X, Y, Z, T] == [c % P for c in (want.X, want.Y, want.Z,
                                                want.T)]
        assert edwards.Point(X, Y, Z, T) == p.add(p)
        assert [X, Y, Z, T] == [limbs.limbs_to_int(lim[c, :, i]) % P
                                for c in range(4)]


def test_doubling_at_the_weak_bound():
    """ge8_dbl on coordinates at the edges of the weak form (2^256 − 1,
    p, p + 1, 2^255 − 1, ...): every output residue is the formula's, no
    carry is lost."""
    for x in EDGES[:6]:
        for y in EDGES[-6:]:
            for z in (EDGES[1], EDGES[-1]):
                got = M.ge8_dbl([M.to_words(x), M.to_words(y),
                                 M.to_words(z), None])
                A, B = x * x % P, y * y % P
                C = 2 * z * z % P
                E = ((x + y) ** 2 - A - B) % P
                G = (B - A) % P
                F = (G - C) % P
                H = (-A - B) % P
                assert [_weak(c) % P for c in got] == [
                    E * F % P, G * H % P, F * G % P, E * H % P]


def test_selftest_plain_version_runs_the_model():
    """probe_fe8's plain version (ops/probes.py) on the self-test operands:
    every edge pair, the limbs20 edges; its blocks are the model's."""
    x = torch.from_numpy(probes.fe8_operands(n_random=4))
    assert x.shape[1] == probes.FE8_IN
    assert x.shape[0] == len(EDGES) ** 2 + 4
    out = probes.fe8_selftest(x)
    assert out.shape == (x.shape[0], probes.FE8_OUT)
    row = [int(v) & M.M32 for v in x[5].tolist()]
    o = [int(v) & M.M32 for v in out[5].tolist()]
    assert o[24:32] == M.fe8_mul(row[0:8], row[8:16])
    canon = [v - (1 << 32) if v >> 31 else v for v in o[40:60]]
    assert canon == M.fe8_to_limbs20_canonical(row[0:8])
    assert o[124:132] == M.fe8_sq(row[0:8])
