"""The port's plain PyTorch field and point ops against the JAX package's.

`ed25519_consensus_tpu_torch.ops.torch_field` / `torch_edwards` are the
arithmetic of every CUDA kernel of the port (csrc/fe25519.cuh is the same
op sequence), so they must agree with `ops/jnp_field.py` /
`ops/jnp_edwards.py` LIMB FOR LIMB, not only mod p: the int16 stores of
points and tables are exact only while the carry schedule, and with it the
|limb| ≤ 8191 bound, is the reference's.  Tolerance: exact equality.
Inputs are made from seeds with numpy / `random.Random` and go to both."""

import random

import numpy as np
import pytest
import torch

from ed25519_consensus_tpu.ops import field
from ed25519_consensus_tpu.ops import jnp_edwards as JE
from ed25519_consensus_tpu.ops import jnp_field as JF
from ed25519_consensus_tpu_torch.ops import edwards, limbs
from ed25519_consensus_tpu_torch.ops import torch_edwards as TE
from ed25519_consensus_tpu_torch.ops import torch_field as TF
from ed25519_consensus_tpu_torch.ops.scalar import L

jnp = pytest.importorskip("jax.numpy")


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


# Adversarial field values (tests/test_device_parity.py EDGE_VALUES).
EDGE_VALUES = [0, 1, 2, 19, 608, field.P - 1, field.P - 2, field.P - 19,
               (1 << 255) - 20, (1 << 253), 8191, 8192]
N_RANDOM = 52


def _operands():
    """(a, b) as (NLIMBS, n) int32 numpy limbs: edge and random field
    values (canonical limbs), then random balanced limbs anywhere in the
    U bound |limb| ≤ 8191, with all-(+8191) and all-(−8191) columns."""
    rng = random.Random(0xF1E1D)
    a = EDGE_VALUES + [rng.randrange(field.P) for _ in range(N_RANDOM)]
    b = list(reversed(EDGE_VALUES)) + [rng.randrange(field.P)
                                       for _ in range(N_RANDOM)]
    A = limbs.pack_field_batch(a)
    B = limbs.pack_field_batch(b)
    g = np.random.default_rng(0xB0B)
    ua = g.integers(-8191, 8192, size=(limbs.NLIMBS, 64)).astype(np.int32)
    ub = g.integers(-8191, 8192, size=(limbs.NLIMBS, 64)).astype(np.int32)
    ua[:, 0], ub[:, 0] = 8191, 8191
    ua[:, 1], ub[:, 1] = -8191, -8191
    ua[:, 2], ub[:, 2] = 8191, -8191
    return (np.concatenate([A, ua], axis=1).astype(np.int32),
            np.concatenate([B, ub], axis=1).astype(np.int32))


def _host_value(col) -> int:
    return limbs.limbs_to_int(col) % field.P


OPS = {
    "add": (TF.add, JF.add, field.add),
    "sub": (TF.sub, JF.sub, field.sub),
    "mul": (TF.mul, JF.mul, field.mul),
    "mul_small2": (lambda a, b: TF.mul_small(a, 2),
                   lambda a, b: JF.mul_small(a, 2),
                   lambda x, y: 2 * x % field.P),
    "mul_small4": (lambda a, b: TF.mul_small(a, 4),
                   lambda a, b: JF.mul_small(a, 4),
                   lambda x, y: 4 * x % field.P),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_field_op_matches_jnp_limb_for_limb(name):
    top, jop, hop = OPS[name]
    A, B = _operands()
    got = top(torch.from_numpy(A), torch.from_numpy(B))
    want = np.asarray(jop(jnp.asarray(A), jnp.asarray(B)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # and the value is right mod p, inside the U bound
    assert int(got.abs().max()) <= 8191
    for j in range(A.shape[1]):
        assert _host_value(got[:, j].numpy()) == \
            hop(_host_value(A[:, j]), _host_value(B[:, j])), (name, j)


def test_select_and_carry_match_jnp():
    A, B = _operands()
    mask = np.random.default_rng(3).integers(0, 2, A.shape[1]).astype(bool)
    got = TF.select(torch.from_numpy(mask), torch.from_numpy(A),
                    torch.from_numpy(B))
    want = JF.select(jnp.asarray(mask), jnp.asarray(A), jnp.asarray(B))
    assert np.array_equal(got.numpy(), np.asarray(want))
    # carry on wide values (as a product column would be): both sides
    wide = np.random.default_rng(4).integers(
        -(1 << 30), 1 << 30, size=(limbs.NLIMBS, 96)).astype(np.int32)
    for steps in (1, 2, 5):
        got = TF.carry(torch.from_numpy(wide), steps)
        want = JF.carry(jnp.asarray(wide), steps)
        assert np.array_equal(got.numpy(), np.asarray(want)), steps


def test_balanced_carry_shift_is_arithmetic():
    """The balanced carry c = (x + 4096) >> 13 needs an ARITHMETIC right
    shift of negative int32 (floor division by 2^13), as CUDA's `>>` on a
    signed int is.  Pin torch's int32 `>>` to floor division at the
    boundaries, and the carry's residue to |r| ≤ 4096."""
    xs = [-(1 << 31), -(1 << 30) - 1, -1_342_177_280, -8193, -8192, -4097,
          -4096, -4095, -1, 0, 1, 4095, 4096, 8191, 8192,
          1_342_177_280, (1 << 31) - 4097]
    t = torch.tensor(xs, dtype=torch.int32)
    assert (t >> 13).tolist() == [x >> 13 for x in xs]
    assert ((t >> 13).tolist()) == [x // 8192 for x in xs]
    c = (t[1:-1] + 4096) >> 13
    assert c.tolist() == [(x + 4096) // 8192 for x in xs[1:-1]]
    r = t[1:-1] - c * 8192
    assert int(r.abs().max()) <= 4096
    # the product-column extreme of the mul closure proof fits int32
    assert 20 * 8191 * 8191 < (1 << 31)


def _points():
    rng = random.Random(0xED)
    tors = edwards.eight_torsion()
    p1 = [edwards.basepoint_mul(rng.randrange(1, L)) for _ in range(8)]
    p2 = [edwards.basepoint_mul(rng.randrange(1, L)) for _ in range(8)]
    return p1 + tors + tors, p2 + list(reversed(tors)) + tors


def test_point_add_matches_jnp_and_host():
    pts1, pts2 = _points()
    P1 = limbs.pack_point_batch(pts1)
    P2 = limbs.pack_point_batch(pts2)
    got = TE.point_add(torch.from_numpy(P1), torch.from_numpy(P2))
    want = np.asarray(JE.point_add(jnp.asarray(P1), jnp.asarray(P2)))
    assert np.array_equal(got.numpy(), want)
    for j in range(len(pts1)):
        assert limbs.unpack_point(got[..., j].numpy()) == \
            pts1[j].add(pts2[j])


def test_point_add_chain_stays_in_int16_bound():
    """Chained additions (a multiples table, then a window fold) keep
    every limb inside |limb| ≤ 8191, so the kernels' int16 table stores
    are exact; identical to the jnp chain."""
    pts1, _ = _points()
    P = limbs.pack_point_batch(pts1)
    t_acc, j_acc = torch.from_numpy(P), jnp.asarray(P)
    for _ in range(8):
        t_acc = TE.point_add(t_acc, torch.from_numpy(P))
        j_acc = JE.point_add(j_acc, jnp.asarray(P))
        assert int(t_acc.abs().max()) <= 8191
    assert np.array_equal(t_acc.numpy(), np.asarray(j_acc))
    ident = TE.identity_like(t_acc)
    assert np.array_equal(ident.numpy(),
                          np.asarray(JE.identity_like(j_acc)))
