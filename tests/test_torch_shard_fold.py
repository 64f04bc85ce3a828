"""K5, the sharded mesh's cross-shard fold (`msm.fold_shards`), on the CPU:
its plain version against the JAX package's fold of the gathered shard
sums (`parallel/sharded_msm.py:139-145`: a `lax.scan` of
`jnp_edwards.point_add` from the identity, here on the same per-shard
window sums), against the model of one (b, w) (`fe_u32.fold_lane(rows,
32)`), in both call forms, at its limits, and the lab's 20-limb form
against the serial fold it keeps; then the mesh's cold, audit and
resident-head dispatches on a CPU virtual mesh against the single lane.

The shard sums are real: K1, K2 and K3's plain versions
(`msm.dispatch_window_sums_many` on the CPU) over random points and
digits, one seed a shard, for D = 1 to 5 (3 and 5 take the warp tree's
odd levels).  Tolerance: exact — as points against the JAX fold and the
single lane (the JAX fold starts from the identity and adds the shards in
a row, so its limbs differ), limb for limb against the model and between
the call forms; the default form's limbs are canonical."""

import random

import numpy as np
import pytest
import torch

from ed25519_consensus_tpu_torch import batch
from ed25519_consensus_tpu_torch.ops import edwards, limbs, msm
from ed25519_consensus_tpu_torch.ops import fe_u32 as M
from ed25519_consensus_tpu_torch.ops import torch_edwards as TE
from ed25519_consensus_tpu_torch.ops import torch_field as TF
from ed25519_consensus_tpu_torch.parallel import sharded_msm

from torch_threads import _one_torch_thread  # noqa: F401


jax = pytest.importorskip("jax")

B, N = 2, 64
MAX_D = 5


def _wire(n, seed):
    """(33, n) compressed wire of random points."""
    rng = random.Random(seed)
    encs = []
    while len(encs) < n:
        e = rng.getrandbits(256).to_bytes(32, "little")
        if edwards.decompress(e) is not None:
            encs.append(e)
    w = np.zeros((33, n), dtype=np.uint8)
    for i, e in enumerate(encs):
        w[:32, i] = np.frombuffer(e, dtype=np.uint8)
        w[32, i] = edwards.decompress_with_hint(e)[1]
    return w


@pytest.fixture(scope="module")
def shard_sums():
    """MAX_D shards' window sums, (B, 4, NLIMBS, 33) int32 each."""
    out = []
    for k in range(MAX_D):
        d = np.random.default_rng(0x5F + k).integers(
            -8, 8, size=(B, limbs.NWINDOWS, N)).astype(np.int8)
        w = np.stack([_wire(N, 100 * k + b) for b in range(B)])
        out.append(msm.dispatch_window_sums_many(d, w, "cpu"))
    return out


def _jax_fold(parts):
    """The JAX package's cross-shard fold on gathered sums (D, B, 4,
    NLIMBS, 33): scan of point_add from the identity over the shard axis,
    in the point-first layout its shard_map body folds in."""
    import jax.numpy as jnp

    from ed25519_consensus_tpu.ops import jnp_edwards as JE

    g = jnp.transpose(jnp.asarray(parts), (0, 2, 3, 1, 4))

    def fold(acc, p):
        return JE.point_add(acc, p), None

    out, _ = jax.jit(lambda g: jax.lax.scan(
        fold, JE.identity_like(g[0]), g))(g)
    return np.asarray(jnp.transpose(out, (2, 0, 1, 3)))


def same_points(a, b) -> bool:
    """(B, 4, NLIMBS, 33) window sums equal as group elements."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return all(limbs.unpack_point(a[i, ..., w]) ==
               limbs.unpack_point(b[i, ..., w])
               for i in range(a.shape[0]) for w in range(a.shape[-1]))


@pytest.mark.parametrize("D", [1, 2, 3, 4, 5])
def test_plain_k5_equals_the_jax_fold_as_points(shard_sums, D):
    parts = shard_sums[:D]
    got = msm.fold_shards(parts)
    assert got.shape == (B, 4, limbs.NLIMBS, limbs.NWINDOWS)
    assert same_points(got.numpy(), _jax_fold(torch.stack(parts).numpy()))


@pytest.mark.parametrize("D", [1, 3, 5])
def test_plain_k5_writes_canonical_limbs(shard_sums, D):
    got = msm.fold_shards_plain(shard_sums[:D])
    flat = got.movedim(2, 0)  # limbs first
    assert torch.equal(TF.canonical_limbs20(flat), flat)


@pytest.mark.parametrize("D", [1, 2, 3, 4, 5])
def test_plain_k5_equals_its_lane_model(shard_sums, D):
    """fe_u32.fold_lane with 32 threads is K5's warp for one (b, w): lane
    d holds shard d, one halving tree, canonical limbs out."""
    got = msm.fold_shards_plain(shard_sums[:D])
    for b, w in ((0, 0), (1, 17), (0, 32), (1, 5)):
        rows = [p[b, ..., w].reshape(-1).tolist() for p in shard_sums[:D]]
        assert M.fold_lane(rows, 32) == got[b, ..., w].reshape(-1).tolist()


@pytest.mark.parametrize("arith", ["u32", "l20"])
def test_sequence_form_equals_the_stacked_form(shard_sums, arith):
    stacked = torch.stack(shard_sums[:4])
    want = msm.fold_shards(stacked, arith=arith)
    assert torch.equal(msm.fold_shards(shard_sums[:4], arith=arith), want)
    assert torch.equal(msm.fold_shards_plain(list(stacked), arith), want)


def test_no_shards_give_the_identity_and_too_many_raise(shard_sums):
    empty = torch.zeros((0, 3, 4, limbs.NLIMBS, limbs.NWINDOWS),
                        dtype=torch.int32)
    for arith in ("u32", "l20"):
        got = msm.fold_shards(empty, arith=arith)
        assert got.shape == (3, 4, limbs.NLIMBS, limbs.NWINDOWS)
        assert all(limbs.unpack_point(got[b, ..., w].numpy()).is_identity()
                   for b in range(3) for w in range(limbs.NWINDOWS))
    assert msm.MAX_SHARDS == 32
    msm.fold_shards_plain([shard_sums[0]] * 32)
    for call in (msm.fold_shards, msm.fold_shards_plain):
        with pytest.raises(ValueError, match="at most 32"):
            call([shard_sums[0]] * 33)
        with pytest.raises(ValueError, match="at most 32"):
            call(torch.stack([shard_sums[0]] * 33))
    with pytest.raises(ValueError, match="no shard sums"):
        msm.fold_shards([])
    with pytest.raises(ValueError, match="one shape"):
        msm.fold_shards([shard_sums[0], shard_sums[1][:1]])
    with pytest.raises(ValueError):
        msm.fold_shards([shard_sums[0].to(torch.int64)])
    with pytest.raises(ValueError, match="arith"):
        msm.fold_shards(shard_sums[:2], arith="l64")


@pytest.mark.parametrize("D", [1, 2, 5])
def test_l20_plain_is_the_serial_fold(shard_sums, D):
    """The lab's 20-limb K5: shard 0 plus shards 1, 2, ... in a row, the
    limbs as the additions leave them — limb for limb."""
    acc = shard_sums[0].permute(1, 2, 0, 3)
    for p in shard_sums[1:D]:
        acc = TE.point_add(acc, p.permute(1, 2, 0, 3))
    want = acc.permute(2, 0, 1, 3)
    assert torch.equal(msm.fold_shards_plain(shard_sums[:D], "l20"), want)
    got = msm.fold_shards(torch.stack(shard_sums[:D]), arith="l20")
    assert torch.equal(got, want)


def _staged(n_batches, n_sigs, seed):
    """Port-staged batches of one 3-key keyset (a recurring keyset, so the
    resident-head dispatch applies to each)."""
    from ed25519_consensus_tpu_torch import SigningKey

    r = random.Random(seed)
    keys = [SigningKey.new(r) for _ in range(3)]
    out = []
    for b in range(n_batches):
        v = batch.Verifier()
        for i in range(n_sigs):
            sk = keys[i % 3]
            m = b"fold-%d-%d-%d" % (seed, b, i)
            v.queue((sk.verification_key_bytes(), sk.sign(m), m))
        out.append(v._stage(random.Random(seed + b)))
    return out


@pytest.mark.parametrize("D", [2, 3])
def test_mesh_dispatches_equal_the_single_lane(D):
    """The cold, audit and resident-head mesh dispatches on a CPU virtual
    mesh fold their shards with K5 and give the single lane's window sums
    as points; the audit form's slot 0 is the cold form's fold and its
    slots 1.. the shards' sums, which fold back to it."""
    cpu = ["cpu"] * D
    staged = _staged(2, 5, 40 * D)
    pad = max(sharded_msm.shard_pad(s.n_device_terms, D) for s in staged)
    ops = [s.device_operands(lambda n: pad) for s in staged]
    digits = np.stack([o[0] for o in ops])
    wire = np.stack([o[1] for o in ops])
    single = msm.dispatch_window_sums_many(digits, wire, "cpu").numpy()
    cold = sharded_msm.sharded_window_sums_many(digits, wire, D,
                                                devices=cpu)
    assert same_points(cold.numpy(), single)
    audit = sharded_msm.sharded_window_sums_many_audit(digits, wire, D,
                                                       devices=cpu)
    assert audit.shape == (1 + D, 2, 4, limbs.NLIMBS, limbs.NWINDOWS)
    assert torch.equal(audit[0], cold)
    assert torch.equal(msm.fold_shards(list(audit[1:])), cold)

    head = staged[0].head_tensor()
    n_head = head.shape[-1]
    nr = max(sharded_msm.shard_pad_cached(s.n_sigs, n_head, D)
             for s in staged)
    cops = [s.device_operands_cached(lambda n: n_head + nr) for s in staged]
    cdig = np.stack([o[0] for o in cops])
    rwire = np.stack([o[1] for o in cops])
    dh = np.zeros(cdig.shape[:2] + (D * n_head,), dtype=cdig.dtype)
    dh[:, :, :n_head] = cdig[:, :, :n_head]
    dr = np.ascontiguousarray(cdig[:, :, n_head:])
    cached = sharded_msm.sharded_window_sums_many_cached(
        dh, dr, head, rwire, D, devices=cpu)
    want = msm.dispatch_window_sums_many_cached(cdig, head, rwire, "cpu")
    assert same_points(cached.numpy(), want.numpy())
