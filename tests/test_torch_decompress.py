"""On-device ZIP215 point expansion: the port's plain
`expand_compressed_points` (the CPU twin of kernel K1,
csrc/expand_compressed.cu) against the JAX package's
`ops/jnp_decompress.expand_compressed_points` on the same (B, 33, N) wire.

The wire holds the 14 ZIP215 matrix encodings (8 torsion points + 6
non-canonical low-order encodings), the other 20 non-canonical encodings,
random points with random sign bits, and identity padding; the hints come
from the host decompression of each package.  Tolerance: exact int16
equality — the plain K1 against torch_field.canonical_limbs20 of the JAX
output (K1 writes canonical limbs), the 20-limb form (`arith="l20"`)
against the JAX output itself (balanced-limb math on the same op
sequence).  One JAX shape, (2, 33, 48), so the file pays one XLA compile."""

import random

import jax
import numpy as np
import pytest
import torch

from ed25519_consensus_tpu.ops import edwards as jedwards
from ed25519_consensus_tpu.ops import jnp_decompress as JD
from ed25519_consensus_tpu.utils import fixtures as jfixtures
from ed25519_consensus_tpu_torch.ops import edwards, limbs
from ed25519_consensus_tpu_torch.ops import torch_decompress as TD
from ed25519_consensus_tpu_torch.utils import fixtures

B, N = 2, 48
N_RANDOM = 50


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


def _encodings():
    """The matrix encodings, the other non-canonical ones, then random
    decompressable encodings (both sign bits), from a fixed seed."""
    encs = [p.compress() for p in edwards.eight_torsion()]
    encs += fixtures.non_canonical_point_encodings()
    rng = random.Random(0xDEC0)
    n_fixed = len(encs)
    while len(encs) < n_fixed + N_RANDOM:
        e = rng.getrandbits(256).to_bytes(32, "little")
        if edwards.decompress(e) is not None:
            encs.append(e)
    return encs


@pytest.fixture(scope="module")
def wire_and_points():
    encs = _encodings()
    assert len(encs) <= B * N
    w = limbs.identity_wire_batch(B * N)  # identity padding past the end
    pts = [edwards.identity()] * (B * N)
    for i, e in enumerate(encs):
        pt, hint = edwards.decompress_with_hint(e)
        w[:32, i] = np.frombuffer(e, dtype=np.uint8)
        w[32, i] = hint
        pts[i] = pt
    wire = np.ascontiguousarray(w.reshape(33, B, N).transpose(1, 0, 2))
    return wire, pts


def test_host_decompression_and_hints_match_reference():
    """The port's own copy of the host decompression gives the reference's
    points and device-wire hints on every encoding of the wire, and the
    fixture generators agree."""
    assert fixtures.non_canonical_point_encodings() == \
        jfixtures.non_canonical_point_encodings()
    assert [p.compress() for p in edwards.eight_torsion()] == \
        [p.compress() for p in jedwards.eight_torsion()]
    for e in _encodings():
        pt, hint = edwards.decompress_with_hint(e)
        jpt, jhint = jedwards.decompress_with_hint(e)
        assert hint == jhint, e.hex()
        assert (pt.X, pt.Y, pt.Z, pt.T) == (jpt.X, jpt.Y, jpt.Z, jpt.T)
    # non-points are refused alike (about half of all small y are not
    # on the curve)
    refused = 0
    for y in range(2, 40):
        e = y.to_bytes(32, "little")
        mine = edwards.decompress_with_hint(e)
        assert (mine is None) == (jedwards.decompress_with_hint(e) is None)
        refused += mine is None
    assert refused > 0


def test_expand_compressed_matches_jnp_exactly(wire_and_points):
    from ed25519_consensus_tpu_torch.ops import torch_field as TF

    wire, pts = wire_and_points
    got = TD.expand_compressed_points(torch.from_numpy(wire))
    want = np.asarray(jax.jit(JD.expand_compressed_points)(wire))
    assert got.dtype == torch.int16 and tuple(got.shape) == (B, 4, 20, N)
    assert want.dtype == np.int16
    canon = TF.canonical_limbs20(torch.from_numpy(want.copy()).to(torch.int32)
                                 .movedim(2, 0)).movedim(0, 2)
    assert np.array_equal(got.numpy(), canon.numpy())
    l20 = TD.expand_compressed_points(torch.from_numpy(wire), arith="l20")
    assert np.array_equal(l20.numpy(), want)
    # every lane is the host's decompressed point (identity on padding)
    flat = got.permute(1, 2, 0, 3).reshape(4, limbs.NLIMBS, B * N).numpy()
    for i, pt in enumerate(pts):
        assert limbs.unpack_point(flat[..., i]) == pt, i


def test_expand_compressed_chunked_steps_agree(wire_and_points, monkeypatch):
    """The plain version's lane chunking (CHUNK_LANES per step, a ragged
    last step) changes nothing: a 7-lane step gives the same limbs."""
    wire, _ = wire_and_points
    whole = TD.expand_compressed_points_plain(torch.from_numpy(wire))
    monkeypatch.setattr(TD, "CHUNK_LANES", 7)
    stepped = TD.expand_compressed_points_plain(torch.from_numpy(wire))
    assert torch.equal(whole, stepped)


def test_unpack_y_and_pow22523_match_jnp(wire_and_points):
    import jax.numpy as jnp

    from ed25519_consensus_tpu.ops import jnp_field as JF
    from ed25519_consensus_tpu_torch.ops import torch_field as TF

    wire, _ = wire_and_points
    enc = wire[0, :32]
    y_t = TD.unpack_y_limbs(torch.from_numpy(enc))
    y_j = np.asarray(JD.unpack_y_limbs(jnp.asarray(enc), jnp))
    assert np.array_equal(y_t.numpy(), y_j)
    z_t = TF.mul(y_t, y_t)
    z_j = JF.mul(jnp.asarray(y_j), jnp.asarray(y_j))
    got = TD.pow22523(z_t)
    want = np.asarray(jax.jit(lambda z: JD.pow22523(z, jnp))(z_j))
    assert np.array_equal(got.numpy(), want)


def test_expand_compressed_rejects_bad_wire():
    with pytest.raises(ValueError):
        TD.expand_compressed_points(torch.zeros((1, 32, 8),
                                                dtype=torch.uint8))
    with pytest.raises(ValueError):
        TD.expand_compressed_points(torch.zeros((1, 33, 8),
                                                dtype=torch.int16))
