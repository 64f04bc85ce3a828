"""The port's device MSM (`ed25519_consensus_tpu_torch.ops.msm`) on the CPU,
where each kernel wrapper runs its plain PyTorch version, against the JAX
package's `msm.dispatch_window_sums_many` on the CPU (its XLA scan kernel,
the reference the Pallas kernel is held to) and the exact host MSM.

Window sums from K2 + K3 (csrc/window_sums.cu, csrc/fold_partials.cu) fold
in another order than the JAX kernel, so they differ LIMB-WISE: every
window is compared as an exact projective point (`Point.__eq__`).  Digit
unpacking and host packing, by contrast, must match exactly.  One JAX call
(B = 2, N = 128, the default packed digits + compressed points), so the
file pays one XLA compile; the port's four digit/point wire combinations
of the same operands are each held to it."""

import random

import numpy as np
import pytest
import torch

from ed25519_consensus_tpu.ops import limbs as jlimbs
from ed25519_consensus_tpu.ops import msm as jmsm
from ed25519_consensus_tpu_torch.ops import edwards, limbs, msm
from ed25519_consensus_tpu_torch.ops.scalar import L
from ed25519_consensus_tpu_torch.utils import fixtures

B, N = 2, 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops.  With several test
    workers on one host, torch's intra-op thread pools oversubscribe the
    cores (a 3 s case took minutes); one thread per worker is about as fast
    alone and keeps the workers out of each other's way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _assert_windows_equal(got, want):
    assert got.shape == want.shape == (B, 4, limbs.NLIMBS, limbs.NWINDOWS)
    for b in range(B):
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


@pytest.mark.parametrize("nchunk", [0, 1, 5, 32, 33, 70])
def test_fold_partials_takes_nchunk_minus_one_additions(nchunk,
                                                         monkeypatch):
    """The fold (K3's order) starts each accumulator from its first
    partial: nchunk - 1 complete additions per (b, window), none from the
    identity, and the group sum of the partials for any chunk count."""
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
