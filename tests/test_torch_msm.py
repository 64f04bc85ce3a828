"""The port's device MSM (`ed25519_consensus_tpu_torch.ops.msm`) on the CPU,
where each kernel wrapper runs its plain PyTorch version, against the JAX
package's `msm.dispatch_window_sums_many` on the CPU (its XLA scan kernel,
the reference the Pallas kernel is held to) and the exact host MSM.

Window sums from K2 + K3 (csrc/window_sums.cu, csrc/fold_partials.cu) fold
in another order than the JAX kernel, so they differ LIMB-WISE: every
window is compared as an exact projective point (`Point.__eq__`).  Digit
unpacking and host packing, by contrast, must match exactly.  One JAX call
(B = 2, N = 128, the default packed digits + compressed points) for the
random operands, whose four digit/point wire combinations in the port are
each held to it, and the plain K2t on K4's tables too; two more (B = 1,
N = 256) for the full 196-case ZIP215 matrix, the cold dispatch (K1, K2,
K3) and the resident-tables dispatch (K1, K4, K2t, K3).  The partials of
the default K2 and K2t are canonical limbs.  The plain K3's order (128
accumulators, warp trees) against the JAX package's halving fold, as
points, at chunk counts around its boundaries."""

import functools
import random

import numpy as np
import pytest
import torch

import ed25519_consensus_tpu as J
from ed25519_consensus_tpu import batch as jbatch
from ed25519_consensus_tpu.ops import limbs as jlimbs
from ed25519_consensus_tpu.ops import msm as jmsm
from ed25519_consensus_tpu_torch import Signature, batch
from ed25519_consensus_tpu_torch.ops import edwards, limbs, msm
from ed25519_consensus_tpu_torch.ops import torch_field as TF
from ed25519_consensus_tpu_torch.ops.scalar import L
from ed25519_consensus_tpu_torch.utils import fixtures

from torch_threads import _one_torch_thread  # noqa: F401


B, N = 2, 128


def _adversarial_digits(b, n, seed):
    """(b, 33, n) int8: runs of all −8, all +7 and all 0 lanes, one
    window of −8 everywhere, then uniform digits in [−8, 7]."""
    d = np.random.default_rng(seed).integers(
        -8, 8, size=(b, limbs.NWINDOWS, n)).astype(np.int8)
    q = max(1, n // 8)
    d[:, :, :q] = -8
    d[:, :, q:2 * q] = 7
    d[:, :, 2 * q:3 * q] = 0
    d[:, 5, :] = -8
    return d


def _packed(d):
    return np.stack([limbs.pack_digit_planes(x) for x in d])


def _operands():
    """(plain digits, extended points, compressed wire, host points) for
    B × N lanes: torsion points, the non-canonical encodings, random
    points, identity padding."""
    encs = [p.compress() for p in edwards.eight_torsion()]
    encs += fixtures.non_canonical_point_encodings()
    rng = random.Random(0x3535)
    while len(encs) < 2 * N - 20:
        e = rng.getrandbits(256).to_bytes(32, "little")
        if edwards.decompress(e) is not None:
            encs.append(e)
    w = limbs.identity_wire_batch(B * N)
    pts = [edwards.identity()] * (B * N)
    for i, e in enumerate(encs):
        pt, hint = edwards.decompress_with_hint(e)
        w[:32, i] = np.frombuffer(e, dtype=np.uint8)
        w[32, i] = hint
        pts[i] = pt
    ext = limbs.pack_point_batch(pts).astype(np.int16)
    wire = np.ascontiguousarray(w.reshape(33, B, N).transpose(1, 0, 2))
    ext = np.ascontiguousarray(
        ext.reshape(4, limbs.NLIMBS, B, N).transpose(2, 0, 1, 3))
    return _adversarial_digits(B, N, 11), ext, wire, pts


@pytest.fixture(scope="module")
def operands():
    return _operands()


@pytest.fixture(scope="module")
def reference(operands):
    """The JAX package's window sums in its production wires."""
    d, _, wire, _ = operands
    return np.asarray(jmsm.dispatch_window_sums_many(_packed(d), wire))


def _assert_windows_equal(got, want, batches=B):
    assert got.shape == want.shape == (batches, 4, limbs.NLIMBS,
                                       limbs.NWINDOWS)
    for b in range(batches):
        for w in range(limbs.NWINDOWS):
            assert limbs.unpack_point(got[b, ..., w]) == \
                limbs.unpack_point(want[b, ..., w]), (b, w)


def test_fixture_wires_carry_the_same_points(operands):
    """The compressed wire and the extended points are the same lanes:
    the port's K1 plain version maps one onto the other exactly."""
    from ed25519_consensus_tpu_torch.ops import torch_decompress as TD

    _, ext, wire, pts = operands
    got = TD.expand_compressed_points(torch.from_numpy(wire)).numpy()
    flat = got.transpose(1, 2, 0, 3).reshape(4, limbs.NLIMBS, B * N)
    for i, pt in enumerate(pts):
        assert limbs.unpack_point(flat[..., i]) == pt
    assert limbs.unpack_point(ext[1, ..., 0]) == pts[N]


@pytest.mark.parametrize("dwire", ["packed", "plain"])
@pytest.mark.parametrize("pwire", ["compressed", "extended"])
def test_window_sums_match_reference_as_points(operands, reference, dwire,
                                               pwire):
    d, ext, wire, _ = operands
    digits = _packed(d) if dwire == "packed" else d
    points = wire if pwire == "compressed" else ext
    got = msm.dispatch_window_sums_many(digits, points, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    _assert_windows_equal(got.numpy(), reference)


def _assert_canonical(parts):
    """Every coordinate of (..., 4, NLIMBS) partials is the canonical
    residue's balanced split: limbs 0..18 in [-4096, 4095], limb 19 in
    [0, 256], and canonical_limbs20 leaves it as it is."""
    assert parts.dtype == torch.int32
    assert int(parts[..., :19].min()) >= -4096
    assert int(parts[..., :19].max()) <= 4095
    assert int(parts[..., 19].min()) >= 0
    assert int(parts[..., 19].max()) <= 256
    flat = parts.reshape(-1, limbs.NLIMBS).T
    assert torch.equal(TF.canonical_limbs20(flat), flat)


def test_k2t_plain_on_k4_tables_matches_reference(operands, reference):
    """The verdict path's plain K2t on build_tables_plain's tables (per-
    batch heads of 40 lanes, the boundary inside a chunk) equals the JAX
    package's window sums as points, and so K2's plain version; both
    write canonical limbs."""
    d, ext, _, _ = operands
    digits = torch.from_numpy(_packed(d))
    pts = torch.from_numpy(ext)
    tbl = msm.build_tables_plain(pts)
    k2t = msm.window_partials_tables(digits, tbl[..., :40].contiguous(),
                                     tbl[..., 40:].contiguous())
    k2 = msm.window_partials(digits, pts)
    for parts in (k2, k2t):
        _assert_canonical(parts)
        _assert_windows_equal(msm.fold_partials(parts).numpy(), reference)


def _matrix(pkg_sig, pkg_verifier):
    """The full 196-case ZIP215 matrix (8 torsion and 6 non-canonical
    encodings as A and R, s = 0) as one batch of the given package."""
    encs = [p.compress() for p in edwards.eight_torsion()]
    encs += fixtures.non_canonical_point_encodings()[:6]
    bv = pkg_verifier()
    for A in encs:
        for R in encs:
            bv.queue((A, pkg_sig(R, b"\x00" * 32), b"Zcash"))
    return bv


def test_zip215_matrix_k2_and_k2t_match_reference():
    """The verdict paths on the 196-case ZIP215 matrix, staged alike by
    both packages: the cold dispatch (plain K1, K2, K3) and the
    resident-tables dispatch (plain K1, K4, K2t, K3) equal the JAX
    package's XLA dispatches as points window by window; the partials
    are canonical and the batch verifies (the cofactored check)."""
    mine = _matrix(Signature, batch.Verifier)._stage(random.Random(1))
    ref = _matrix(J.Signature, jbatch.Verifier)._stage(random.Random(1))
    d, w = mine.device_operands(msm.pad_lanes)
    rd, rw = ref.device_operands(msm.pad_lanes)
    assert np.array_equal(d, rd) and np.array_equal(w, rw)
    cold = msm.dispatch_window_sums_many(d[None], w[None], device="cpu")
    _assert_windows_equal(
        cold.numpy(),
        np.asarray(jmsm.dispatch_window_sums_many(d[None], w[None])),
        batches=1)
    head = mine.head_tables_tensor()
    n_head = head.shape[-1]
    nr = msm.pad_lanes(mine.n_cached_terms) - n_head
    dc, rwire = mine.device_operands_cached(lambda n: n_head + nr)
    tables = msm.dispatch_window_sums_many_tables(
        dc[None], head, rwire[None], device="cpu")
    _assert_windows_equal(
        tables.numpy(),
        np.asarray(jmsm.dispatch_window_sums_many_tables(
            dc[None], ref.head_tables_tensor(), rwire[None])), batches=1)
    from ed25519_consensus_tpu_torch.ops import torch_decompress as TD

    pts = TD.expand_compressed_points(torch.from_numpy(w[None]))
    _assert_canonical(msm.window_partials(torch.from_numpy(d[None]), pts))
    for ws in (cold, tables):
        assert msm.combine_window_sums(ws.numpy()).mul_by_cofactor() \
            .is_identity()


def test_expand_digits_matches_jnp_exactly():
    g = np.random.default_rng(5)
    packed = g.integers(0, 256, size=(3, limbs.PACKED_WINDOWS, 256),
                        dtype=np.uint8)
    packed[0, :, :] = np.arange(256, dtype=np.uint8)[None]  # every byte
    got = msm.expand_digits(torch.from_numpy(packed))
    want = np.asarray(jmsm.expand_digits(packed))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)
    # the inverse of host packing, the 33rd plane in row 16's low nibble
    d = _adversarial_digits(1, 64, 6)[0]
    assert np.array_equal(
        msm.expand_digits(torch.from_numpy(limbs.pack_digit_planes(d))
                          ).numpy(), d)


def test_host_packing_matches_reference():
    rng = random.Random(77)
    scal = [0, 1, (1 << 128) - 1, 1 << 127] + [rng.getrandbits(128)
                                            for _ in range(60)]
    mine = limbs.pack_scalar_windows(scal)
    assert np.array_equal(mine, jlimbs.pack_scalar_windows(scal))
    assert np.array_equal(limbs.pack_digit_planes(mine),
                          jlimbs.pack_digit_planes(mine))
    zb = np.frombuffer(rng.getrandbits(128 * 40).to_bytes(640, "little"),
                       dtype=np.uint8).reshape(40, 16)
    assert np.array_equal(limbs.pack_u128_windows(zb),
                          jlimbs.pack_u128_windows(zb))
    assert np.array_equal(limbs.identity_wire_batch(9),
                          jlimbs.identity_wire_batch(9))
    pts = [edwards.basepoint_mul(rng.randrange(L)) for _ in range(5)]
    d1, p1 = msm.pack_msm_operands(scal[:5], pts, n_lanes=64)
    d2, p2 = jmsm.pack_msm_operands(scal[:5], pts, n_lanes=64)
    assert np.array_equal(d1, d2) and np.array_equal(p1, p2)


@pytest.mark.parametrize("dwire", ["packed", "plain"])
def test_ragged_lanes_match_host_msm(dwire):
    """N = 200 (not a multiple of the 64-lane chunk) with torsion points
    and adversarial digits: the combined window sums equal the exact host
    MSM of the scalars the digits encode (mod the full group order 8ℓ)."""
    n = 200
    rng = random.Random(0x200)
    pts = list(edwards.eight_torsion())
    pts += [edwards.basepoint_mul(rng.randrange(1, L)).add(
        edwards.eight_torsion()[i % 8]) for i in range(n - 8)]
    d = _adversarial_digits(1, n, 12)[0]
    wts = [16 ** (limbs.NWINDOWS - 1 - w) for w in range(limbs.NWINDOWS)]
    scal = [sum(int(d[w, i]) * wts[w] for w in range(limbs.NWINDOWS))
            % (8 * L) for i in range(n)]
    ext = limbs.pack_point_batch(pts).astype(np.int16)
    digits = limbs.pack_digit_planes(d) if dwire == "packed" else d
    ws = msm.dispatch_window_sums(digits, ext, device="cpu")
    assert tuple(ws.shape) == (1, 4, limbs.NLIMBS, limbs.NWINDOWS)
    assert msm.combine_window_sums(ws.numpy()) == \
        edwards.multiscalar_mul(scal, pts)


def test_device_msm_wide_scalars_match_host():
    """Scalars up to 2^256 go through the 128-bit split (split_terms)."""
    rng = random.Random(0x256)
    pts = [edwards.basepoint_mul(rng.randrange(1, L)) for _ in range(12)]
    pts += edwards.eight_torsion()[5:7]
    sc = [rng.getrandbits(256) for _ in pts]
    sc[0], sc[1] = 0, 1
    assert msm.device_msm(sc, pts, device="cpu") == \
        edwards.multiscalar_mul(sc, pts)
    assert msm.device_msm([], [], device="cpu").is_identity()


def test_fold_partials_plain_over_many_chunks():
    """More chunks than fold threads (37 > 32): the fold is the group sum
    of the partials for every (b, window)."""
    rng = random.Random(0xF01D)
    pool = [edwards.basepoint_mul(rng.randrange(1, L)) for _ in range(6)]
    pool += edwards.eight_torsion()[1:3]
    nchunk = 37
    idx = np.random.default_rng(8).integers(
        0, len(pool), size=(2, nchunk, limbs.NWINDOWS))
    parts = np.zeros((2, nchunk, limbs.NWINDOWS, 4, limbs.NLIMBS),
                     dtype=np.int32)
    packed = [limbs.pack_point_batch([p])[..., 0] for p in pool]
    for (b, c, w), k in np.ndenumerate(idx):
        parts[b, c, w] = packed[k]
    out = msm.fold_partials(torch.from_numpy(parts)).numpy()
    for b in range(2):
        for w in range(limbs.NWINDOWS):
            want = edwards.identity()
            for c in range(nchunk):
                want = want.add(pool[idx[b, c, w]])
            assert limbs.unpack_point(out[b, ..., w]) == want, (b, w)


@pytest.mark.parametrize("nchunk", [0, 1, 5, 32, 33, 70, 129, 192])
def test_fold_partials_takes_nchunk_minus_one_additions(nchunk,
                                                         monkeypatch):
    """The fold (K3's order: 128 accumulators from chunks t, t + 128, ...,
    then warp trees) starts each accumulator from its first partial:
    nchunk - 1 complete additions per (b, window), none from the identity,
    and the group sum of the partials for any chunk count."""
    rng = random.Random(0xF02D + nchunk)
    pool = [edwards.basepoint_mul(rng.randrange(1, L)) for _ in range(4)]
    pool += edwards.eight_torsion()[1:2]
    idx = np.random.default_rng(nchunk).integers(
        0, len(pool), size=(1, nchunk, limbs.NWINDOWS))
    parts = np.zeros((1, nchunk, limbs.NWINDOWS, 4, limbs.NLIMBS),
                     dtype=np.int32)
    packed = [limbs.pack_point_batch([p])[..., 0] for p in pool]
    for (b, c, w), k in np.ndenumerate(idx):
        parts[b, c, w] = packed[k]
    adds = []
    point_add = msm.E.point_add

    def counted(p, q):
        adds.append(p.shape[-1])  # additions per (b, window) in this call
        return point_add(p, q)

    monkeypatch.setattr(msm.E, "point_add", counted)
    out = msm.fold_partials(torch.from_numpy(parts)).numpy()
    assert sum(adds) == max(nchunk - 1, 0)
    for w in range(limbs.NWINDOWS):
        want = edwards.identity()
        for c in range(nchunk):
            want = want.add(pool[idx[0, c, w]])
        assert limbs.unpack_point(out[0, ..., w]) == want, w


_JAX_FOLD_LANES = 96 * limbs.NWINDOWS  # the widest level at 192 chunks


@functools.lru_cache(maxsize=None)
def _jit_point_add():
    import jax

    from ed25519_consensus_tpu.ops import jnp_edwards as JE

    return jax.jit(JE.point_add)


def _jax_point_add(p, q):
    """jnp_edwards.point_add on (4, 20, ...) arrays, flattened and padded
    to one width, so every level of every fold below runs one compiled
    shape (lanes are independent; the padding is cut off)."""
    import jax.numpy as jnp

    shape = p.shape
    n = int(np.prod(shape[2:]))
    pad = [(0, 0), (0, 0), (0, _JAX_FOLD_LANES - n)]
    out = _jit_point_add()(jnp.pad(p.reshape(4, limbs.NLIMBS, n), pad),
                           jnp.pad(q.reshape(4, limbs.NLIMBS, n), pad))
    return out[..., :n].reshape(shape)


def _jax_fold(parts):
    """The JAX package's fold of the per-block partials over the block
    axis, as ops/pallas_msm.py:424-437 takes it (halving point_adds of the
    jnp arithmetic, an odd block carried), on (B, nchunk, nwin, 4, 20)
    int32 → (B, 4, 20, nwin)."""
    import jax.numpy as jnp

    acc = jnp.transpose(jnp.asarray(parts), (3, 4, 0, 2, 1))
    nb = acc.shape[-1]
    while nb > 1:
        half, odd = nb // 2, nb % 2
        folded = _jax_point_add(acc[..., :half], acc[..., half:2 * half])
        if odd:
            folded = jnp.concatenate([folded, acc[..., 2 * half:]], axis=-1)
        acc, nb = folded, half + odd
    return np.asarray(jnp.transpose(acc[..., 0], (2, 0, 1, 3)))


@pytest.mark.parametrize("nchunk", [0, 1, 2, 31, 32, 33, 159, 192])
def test_fold_partials_plain_equals_the_jax_fold_as_points(nchunk):
    """The plain K3 (128 accumulators, warp trees, canonical limbs) and the
    JAX package's halving fold give the same window sums as points; with
    no chunks the plain K3 gives the identity.  The partials are 20-limb
    sums (balanced, negative limbs) of torsion points and random
    multiples."""
    from ed25519_consensus_tpu_torch.ops import torch_edwards as TE

    rng = random.Random(0xF03D + nchunk)
    pool = edwards.eight_torsion()[1:4] + [
        edwards.basepoint_mul(rng.randrange(1, L)) for _ in range(5)]
    packed = torch.from_numpy(limbs.pack_point_batch(pool).astype(np.int32))
    idx = torch.from_numpy(np.random.default_rng(nchunk).integers(
        0, len(pool), size=(2, nchunk * limbs.NWINDOWS)))
    parts = TE.point_add(packed[..., idx[0]], packed[..., idx[1]]).reshape(
        4, limbs.NLIMBS, 1, nchunk, limbs.NWINDOWS).permute(2, 3, 4, 0, 1) \
        .contiguous()
    got = msm.fold_partials(parts).numpy()
    if not nchunk:
        assert all(limbs.unpack_point(got[0, ..., w]).is_identity()
                   for w in range(limbs.NWINDOWS))
        return
    _assert_windows_equal(got, _jax_fold(parts.numpy()), batches=1)


def test_wrappers_reject_bad_operands():
    pts = torch.zeros((1, 4, limbs.NLIMBS, 64), dtype=torch.int16)
    with pytest.raises(ValueError):
        msm.window_partials(torch.zeros((1, 33, 64), dtype=torch.int32),
                            pts)
    with pytest.raises(ValueError):
        msm.window_partials(torch.zeros((1, 17, 63), dtype=torch.uint8),
                            pts)
    # int16 partials are the int16-fold form's (K3's fold_partials_i16fold);
    # other types, other window counts and the radix-32 int16 form (not
    # built) are refused
    with pytest.raises(ValueError):
        msm.fold_partials(torch.zeros((1, 2, 33, 4, limbs.NLIMBS),
                                      dtype=torch.int8))
    with pytest.raises(ValueError):
        msm.fold_partials(torch.zeros((1, 2, 30, 4, limbs.NLIMBS),
                                      dtype=torch.int32))
    with pytest.raises(ValueError):
        msm.fold_partials(torch.zeros((1, 2, 27, 4, limbs.NLIMBS),
                                      dtype=torch.int16))
    # the 20-limb K3 is built for 33 windows of int32 only
    with pytest.raises(ValueError):
        msm.fold_partials(torch.zeros((1, 2, 27, 4, limbs.NLIMBS),
                                      dtype=torch.int32), arith="l20")
    with pytest.raises(ValueError):
        msm.fold_partials(torch.zeros((1, 2, 33, 4, limbs.NLIMBS),
                                      dtype=torch.int32), arith="l64")
