"""The models of K1's, K3's and K4's bodies on the 8 × 32-bit arithmetic
(ops/fe_u32.py `expand_lane`, `fold_lane`, `tables_lane`:
csrc/expand_compressed.cu, csrc/fold_partials.cu and csrc/build_tables.cu,
instruction for instruction through the field model) against the plain
K1, K3 and K4 (torch_decompress.expand_compressed_points_plain,
msm.fold_partials_plain, msm.build_tables_plain), limb for limb: K1 on the
ZIP215 matrix encodings under every hint, every non-canonical encoding and
random points; K3's order at chunk counts around its warp and round
boundaries (0, 1, 2, 31, 32, 33, 159, 192; 128 threads a block); K4 on
K1's output for those lanes and on points whose limbs sit at |limb| = 8191.
The card holds each kernel against the same plain versions (chip_smoke.py,
tests/test_torch_cuda.py).  Tolerance: exact."""

import random

import numpy as np
import pytest
import torch

from ed25519_consensus_tpu_torch.ops import edwards, limbs, msm, probes
from ed25519_consensus_tpu_torch.ops import fe_u32 as M
from ed25519_consensus_tpu_torch.ops import torch_decompress as TD
from ed25519_consensus_tpu_torch.ops import torch_edwards as TE
from ed25519_consensus_tpu_torch.ops.scalar import L
from ed25519_consensus_tpu_torch.utils import fixtures


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _k1_lanes():
    """(33-byte lanes, host points or None): the 14 ZIP215 matrix
    encodings (8 torsion points, 6 non-canonical low-order ones), each
    with all four hint values (the host's gives its point; the others are
    field arithmetic the model and the plain version must still agree on),
    the other 20 non-canonical encodings with their host hints, then 32
    random points with theirs (both hint bits occur)."""
    matrix = [p.compress() for p in edwards.eight_torsion()]
    non_canonical = fixtures.non_canonical_point_encodings()
    matrix += non_canonical[:6]
    lanes, pts = [], []
    for e in matrix:
        pt, h = edwards.decompress_with_hint(e)
        for hint in range(4):
            lanes.append(list(e) + [hint])
            pts.append(pt if hint == h else None)
    for e in non_canonical[6:]:
        pt, h = edwards.decompress_with_hint(e)
        lanes.append(list(e) + [h])
        pts.append(pt)
    n_fixed = len(lanes)
    rng = random.Random(0xE1)
    while len(lanes) < n_fixed + 32:
        e = rng.getrandbits(256).to_bytes(32, "little")
        res = edwards.decompress_with_hint(e)
        if res is not None:
            lanes.append(list(e) + [res[1]])
            pts.append(res[0])
    return lanes, pts


def test_expand_lane_equals_the_plain_k1():
    """The model of K1's body (fe_u32.expand_lane: fe8_sq for the
    squarings, canonical limbs out) equals the plain K1 limb for limb on
    every lane, and the host's point where the hint is the host's."""
    lanes, pts = _k1_lanes()
    wire = torch.tensor(lanes, dtype=torch.uint8).T.contiguous()[None]
    plain = TD.expand_compressed_points_plain(wire)[0]  # (4, 20, n)
    for j, lane in enumerate(lanes):
        X, Y, T = M.expand_lane(lane)
        assert [X, Y, [1] + [0] * 19, T] == plain[..., j].tolist(), j
        if pts[j] is not None:
            assert limbs.unpack_point(plain[..., j].numpy()) == pts[j], j


def test_expand_lane_refuses_a_short_lane():
    with pytest.raises(ValueError):
        M.expand_lane([0] * 32)


def _partials(nchunk: int, seed: int):
    """(1, nchunk, 33, 4, 20) int32 partials whose limbs are 20-limb
    point_add outputs (balanced, negative limbs included) of random
    multiples of the basepoint and torsion points."""
    rng = random.Random(seed)
    pool = edwards.eight_torsion()[1:4] + [
        edwards.basepoint_mul(rng.randrange(1, L)) for _ in range(5)]
    packed = torch.from_numpy(
        limbs.pack_point_batch(pool).astype("int32"))  # (4, 20, 8)
    idx = torch.from_numpy(np.random.default_rng(seed).integers(
        0, len(pool), size=(2, nchunk * 33)))
    sums = TE.point_add(packed[..., idx[0]], packed[..., idx[1]])
    return sums.reshape(4, limbs.NLIMBS, 1, nchunk, 33).permute(2, 3, 4, 0, 1) \
        .contiguous()


@pytest.mark.parametrize("nchunk", [0, 1, 2, 31, 32, 33, 159, 192])
def test_fold_lane_equals_the_plain_k3(nchunk):
    """The model of K3's order for one (batch, window) (fe_u32.fold_lane:
    128 threads, partials t, t + 128, ..., warp trees) equals the plain
    K3 limb for limb, on windows 0 and 32."""
    parts = _partials(nchunk, 0xF0 + nchunk)
    plain = msm.fold_partials_plain(parts)
    for w in (0, 32):
        rows = [parts[0, c, w].reshape(-1).tolist() for c in range(nchunk)]
        assert M.fold_lane(rows) == plain[0, ..., w].reshape(-1).tolist(), w


def _k4_points(case: str):
    """(1, 4, 20, n) int16 inputs of K4: K1's plain output on the 14 ZIP215
    matrix encodings (8 torsion points, 6 non-canonical low-order ones)
    under every hint, on the other 20 non-canonical encodings, on 32 random
    points (the R lanes of the tables dispatch); or the |limb| = 8191
    representatives."""
    if case == "extreme":
        return torch.from_numpy(probes.extreme_points(16))[None]
    lanes, _ = _k1_lanes()
    part = {"matrix": lanes[:56], "non_canonical": lanes[56:76],
            "random": lanes[76:]}[case]
    wire = torch.tensor(part, dtype=torch.uint8).T.contiguous()[None]
    return TD.expand_compressed_points_plain(wire)


@pytest.mark.parametrize("case", ["matrix", "non_canonical", "random",
                                  "extreme"])
def test_tables_lane_equals_the_plain_k4(case):
    """The model of K4's body (fe_u32.tables_lane: entry 1 P converted,
    K2's tree T2 = P + P, T3 | T4, T5 … T8 by ge8_add, canonical limbs out)
    equals the plain K4 (build_tables_plain, arith "u32") limb for limb,
    entry by entry, on every lane."""
    pts = _k4_points(case)
    assert case != "extreme" or int(pts.abs().max()) == 8191
    plain = msm.build_tables_plain(pts)[0]  # (9, 4, 20, n)
    for j in range(pts.shape[-1]):
        got = M.tables_lane(pts[0, ..., j].reshape(-1).tolist())
        assert got == plain[..., j].reshape(msm.NTABLE, -1).tolist(), j


def _k7_lanes():
    """(4, 20, n) int16 K1 outputs: the identity, an 8-torsion point, a
    non-canonical low-order encoding and two random points."""
    encs = [edwards.Point(0, 1, 1, 0).compress(),
            edwards.eight_torsion()[3].compress(),
            fixtures.non_canonical_point_encodings()[2]]
    rng = random.Random(0xE7)
    while len(encs) < 5:
        e = rng.getrandbits(256).to_bytes(32, "little")
        if edwards.decompress(e) is not None:
            encs.append(e)
    w = np.zeros((1, 33, len(encs)), dtype=np.uint8)
    for i, e in enumerate(encs):
        w[0, :32, i] = np.frombuffer(e, dtype=np.uint8)
        w[0, 32, i] = edwards.decompress_with_hint(e)[1] | TD.SHIFT128_FLAG
    wire = torch.from_numpy(w)
    return wire, TD.expand_compressed_points_plain(wire)


def test_shift128_lane_equals_the_plain_k7():
    """K7's body (the model: 128 ge8_dbl from K1's limbs) against
    shift128_lanes_plain, limb for limb."""
    wire, pts = _k7_lanes()
    want = TD.shift128_lanes_plain(wire, pts)
    for i in range(pts.shape[-1]):
        lane = pts[0, ..., i].reshape(80).tolist()
        assert M.shift128_lane(lane) == want[0, ..., i].reshape(80).tolist()


def test_shift128_lane_refuses_a_short_lane():
    with pytest.raises(ValueError):
        M.shift128_lane([0] * 60)


def test_tables_lane_refuses_a_short_lane():
    with pytest.raises(ValueError):
        M.tables_lane([0] * 79)
