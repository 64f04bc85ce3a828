"""The port's resident-head mesh form on the CPU against the JAX package's:
`sharded_window_sums_many_cached` over D ∈ {2, 4, 8} virtual shards on
`device="cpu"`, on the mesh-layout chunk the JAX package's scheduler
builds for a resident keyset (head digits on shard 0's columns only, the
R lanes split over the shards), carried across with carry.py.  Also: the
same chunk through the port's cold mesh form, the mesh lane's cached
dispatch through verify_many, and the devcache copies a mesh reads.

A file of its own so that its JAX compiles (one per D) run on another test
worker than test_torch_sharding.py's.  Tolerance: exact, as group
elements."""

import random

import numpy as np
import pytest
import torch

import ed25519_consensus_tpu as J
from ed25519_consensus_tpu import batch as jbatch
from ed25519_consensus_tpu.parallel import sharded_msm as jsharded
from ed25519_consensus_tpu_torch import batch, carry, devcache, health
from ed25519_consensus_tpu_torch.ops import limbs
from ed25519_consensus_tpu_torch.parallel import sharded_msm

jax = pytest.importorskip("jax")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker (the port tests' idiom)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def reset_state():
    yield
    devcache.set_default_cache(None)
    batch._DeviceLane.reset_all()
    batch.reset_device_health()
    batch.last_run_stats.clear()


def same_points(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    fa = a.reshape((-1,) + a.shape[-3:])
    fb = b.reshape((-1,) + b.shape[-3:])
    return all(limbs.unpack_point(x[..., w]) == limbs.unpack_point(y[..., w])
               for x, y in zip(fa, fb) for w in range(x.shape[-1]))


def reference_chunk(d, n_batches=2, n_sigs=5, seed=0):
    """A recurring keyset's chunk as the JAX package's mesh lane stages
    it (batch.py, the resident-head mesh layout): (dh, dr, head, rwire)."""
    r = random.Random(seed)
    keys = [J.SigningKey.new(r) for _ in range(3)]
    staged = []
    for b in range(n_batches):
        v = jbatch.Verifier()
        for i in range(n_sigs):
            sk = keys[i % 3]
            m = b"cached-%d-%d" % (b, i)
            v.queue((sk.verification_key_bytes(), sk.sign(m), m))
        staged.append(v._stage(random.Random(seed + b)))
    head = staged[0].head_tensor()
    n_head = head.shape[-1]
    nr = max(jsharded.shard_pad_cached(s.n_sigs, n_head, d) for s in staged)
    ops = [s.device_operands_cached(lambda n: n_head + nr) for s in staged]
    digits = np.stack([o[0] for o in ops])
    rwire = np.stack([o[1] for o in ops])
    dh = np.zeros((digits.shape[0], digits.shape[1], d * n_head),
                  dtype=digits.dtype)
    dh[:, :, :n_head] = digits[:, :, :n_head]
    dr = np.ascontiguousarray(digits[:, :, n_head:])
    return dh, dr, head, rwire, digits


@pytest.mark.parametrize("d", [2, 4, 8])
def test_cached_form_matches_reference(d):
    """The JAX package's resident-head mesh dispatch and the port's, on the
    same carried chunk: equal window sums as points; and equal to the
    port's own single-lane head-resident dispatch of the same lanes."""
    dh, dr, head, rwire, digits = reference_chunk(d, seed=200 + d)
    want = np.asarray(jsharded.sharded_window_sums_many_cached(
        dh, dr, head, rwire, d))
    cdh, cdr, crw = carry.mesh_chunk_from_reference(dh, dr, rwire, d)
    got = sharded_msm.sharded_window_sums_many_cached(
        cdh, cdr, head, crw, d, devices=["cpu"] * d).numpy()
    assert same_points(got, want)
    from ed25519_consensus_tpu_torch.ops import msm

    single = msm.dispatch_window_sums_many_cached(digits, head, rwire,
                                                  "cpu").numpy()
    assert same_points(got, single)


def test_mesh_chunk_carry_checks_the_layout():
    dh, dr, _head, rwire, _ = reference_chunk(2, seed=7)
    bad = dh.copy()
    bad[..., -1] = 1  # a head digit on shard 1
    with pytest.raises(ValueError, match="shard 0"):
        carry.mesh_chunk_from_reference(bad, dr, rwire, 2)
    with pytest.raises(ValueError, match="split"):
        carry.mesh_chunk_from_reference(dh, dr[..., :-1], rwire, 2)


def test_mesh_lane_dispatches_from_a_resident_head():
    """A recurring keyset on a 2-shard mesh: sighting 1 cold, 2 builds,
    3 dispatches the resident-head mesh form — one head copy for the
    virtual mesh's shared device, read by both shards — with verdicts the
    host oracle's; the tables kind is never used on a mesh."""
    r = random.Random(31)
    keys = [J.SigningKey.new(r) for _ in range(3)]
    cache = devcache.DeviceOperandCache(enabled=True)
    devcache.set_default_cache(cache)
    clock = health.FakeClock()
    for sight in range(3):
        vs = []
        for b in range(2):
            v = batch.Verifier()
            for i, sk in enumerate(keys):
                m = b"resident-%d-%d-%d" % (sight, b, i)
                v.queue((bytes(sk.verification_key_bytes()),
                         _port_sig(sk.sign(m if (sight, b, i) != (2, 1, 0)
                                           else b"tampered")), m))
            vs.append(v)
        got = batch.verify_many(vs, rng=r, chunk=2, hybrid=False,
                                merge="never", mesh=2, device="cpu",
                                health=health.DeviceHealth(clock=clock))
        assert got == [True, sight != 2]
    st = batch.last_run_stats
    assert st["mesh"] == 2
    assert st["devcache"]["dispatch_hits"] == 1
    assert st["devcache"]["table_dispatch_hits"] == 0
    entry = cache.lookup(devcache.keyset_digest(
        b"".join(bytes(k.verification_key_bytes()) for k in keys)))
    assert set(entry._device_refs) == {"cpu"}
    assert entry._ref_chips["cpu"] == {0, 1}
    # a loss of chip 1 drops the copy its shard read; the entry stays
    assert cache.drop_chip(1) == 1 and not entry._device_refs
    assert entry.recheck()


def _port_sig(sig):
    from ed25519_consensus_tpu_torch import Signature

    return Signature.from_bytes(bytes(sig))
