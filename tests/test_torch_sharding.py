"""The port's sharded mesh (`ed25519_consensus_tpu_torch.parallel`) on the
CPU: D shards of one virtual mesh on `device="cpu"` (each wrapper runs its
plain PyTorch version), against the JAX package's sharded functions on
its 8 virtual host devices (tests/conftest.py), on the same operands.

* The audit form — the fold, then each shard's partial sums — equals the
  JAX package's as points, shard by shard, for D ∈ {2, 4, 8}; the plain
  form's sums equal the audit form's fold.  (The resident-head form is
  held in test_torch_sharding_cached.py, so the two files' JAX compiles
  run on two test workers.)
* `sharded_device_msm` equals the host MSM, 8-torsion points included;
  `Verifier.verify(backend="sharded")` accepts a good batch and rejects a
  tampered one.
* Mesh `verify_many` gives the JAX package's verdicts (its host lane) on
  the RFC 8032 vectors, the 196-case ZIP215 matrix and a tampered stream,
  under merge "never" and "always".
* The lane registry keeps one lane per dispatch mode and placement.

These mirror tests/test_sharding.py.  Tolerance: exact, as group elements
(the JAX fold starts from the identity and takes the shards in another
order than K5, so limbs differ while points agree)."""

import random

import numpy as np
import pytest

import ed25519_consensus_tpu as J
import ed25519_consensus_tpu_torch as T
from ed25519_consensus_tpu import batch as jbatch
from ed25519_consensus_tpu.parallel import sharded_msm as jsharded
from ed25519_consensus_tpu_torch import batch, carry, health, routing
from ed25519_consensus_tpu_torch.ops import edwards, limbs
from ed25519_consensus_tpu_torch.ops.scalar import L
from ed25519_consensus_tpu_torch.parallel import sharded_msm
from ed25519_consensus_tpu_torch.utils import fixtures

from torch_threads import _one_torch_thread  # noqa: F401


jax = pytest.importorskip("jax")

rng = random.Random(0x5A4D)


@pytest.fixture(autouse=True)
def reset_state(monkeypatch):
    monkeypatch.setenv("ED25519_TPU_EMA_PRIOR", "30")
    yield
    batch._DeviceLane.reset_all()
    batch.reset_device_health()
    batch.last_run_stats.clear()


def _cpu(d):
    return ["cpu"] * d


def same_points(a, b) -> bool:
    """(..., 4, NLIMBS, 33) window sums equal as group elements, window by
    window."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    fa = a.reshape((-1,) + a.shape[-3:])
    fb = b.reshape((-1,) + b.shape[-3:])
    return all(limbs.unpack_point(x[..., w]) == limbs.unpack_point(y[..., w])
               for x, y in zip(fa, fb) for w in range(x.shape[-1]))


def reference_operands(n_batches, n_sigs, d, seed):
    """JAX-staged operands of `n_batches` batches, padded by the JAX
    package's shard_pad: (digits (B, 17, N) uint8, wire (B, 33, N))."""
    r = random.Random(seed)
    keys = [J.SigningKey.new(r) for _ in range(3)]
    staged = []
    for b in range(n_batches):
        v = jbatch.Verifier()
        for i in range(n_sigs):
            sk = keys[i % 3]
            m = b"shard-%d-%d" % (b, i)
            v.queue((sk.verification_key_bytes(), sk.sign(m), m))
        staged.append(v._stage(random.Random(seed + b)))
    pad = max(jsharded.shard_pad(s.n_device_terms, d) for s in staged)
    ops = [s.device_operands(lambda n: pad) for s in staged]
    return np.stack([o[0] for o in ops]), np.stack([o[1] for o in ops])


@pytest.mark.parametrize("d", [2, 4, 8])
def test_audit_form_matches_reference_shard_by_shard(d):
    """The same operands through the JAX package's audit-form sharded
    dispatch and the port's: the fold and every shard's partial sums
    equal as points; the port's plain form equals its audit fold."""
    digits, wire = reference_operands(2, 5, d, seed=100 + d)
    want = np.asarray(jsharded.sharded_window_sums_many_audit(
        digits, wire, d))
    td, tw = carry.operands_to_device(digits, wire, device="cpu")
    got = sharded_msm.sharded_window_sums_many_audit(
        td, tw, d, devices=_cpu(d)).numpy()
    assert got.shape == want.shape == (1 + d, 2, 4, limbs.NLIMBS, 33)
    for k in range(1 + d):
        assert same_points(got[k], want[k]), f"slot {k}"
    plain = sharded_msm.sharded_window_sums_many(
        digits, wire, d, devices=_cpu(d)).numpy()
    assert np.array_equal(plain, got[0])


def test_sharded_device_msm_matches_host_msm_with_torsion():
    """Σ[c_i]P_i over an 8-shard mesh equals the exact host MSM, with two
    8-torsion points and a zero scalar among the terms."""
    B = edwards.BASEPOINT
    n = 50
    pts = [B.scalar_mul(rng.randrange(1, L)) for _ in range(n - 2)]
    pts += edwards.eight_torsion()[5:7]
    sc = [rng.randrange(L) for _ in range(n)]
    sc[0] = 0
    got = sharded_msm.sharded_device_msm(sc, pts, devices=_cpu(8))
    assert got == edwards.multiscalar_mul(sc, pts)
    assert sharded_msm.sharded_device_msm([], [], devices=_cpu(2)) == \
        edwards.Point(0, 1, 1, 0)


def _queue(entries):
    v = batch.Verifier()
    v.queue_bulk(entries)
    return v


def _entries(n, tamper_at=None, seed=0):
    r = random.Random(seed)
    out = []
    for i in range(n):
        sk = T.SigningKey.new(r)
        m = b"sharded backend %d" % i
        out.append((sk.verification_key_bytes(),
                    sk.sign(m if i != tamper_at else b"tampered"), m))
    return out


def test_verify_sharded_backend_accepts_and_rejects(monkeypatch):
    """backend="sharded" with a device named: the shard count is
    routing.available_devices() (here 2), every shard on the CPU."""
    monkeypatch.setattr(routing, "_device_count", [2])
    timings = {}
    _queue(_entries(12, seed=1)).verify(rng=rng, backend="sharded",
                                        device="cpu", timings=timings)
    assert "sharded" in timings
    with pytest.raises(T.InvalidSignature):
        _queue(_entries(12, tamper_at=7, seed=2)).verify(
            rng=rng, backend="sharded", device="cpu")


def _jax_host_verdicts(batches, monkeypatch, **kw):
    with monkeypatch.context() as m:
        m.setenv("ED25519_TPU_DISABLE_DEVICE", "1")
        vs = []
        for ents in batches:
            v = jbatch.Verifier()
            for vk, sig, msg in ents:
                v.queue((bytes(vk), J.Signature.from_bytes(bytes(sig)), msg))
            vs.append(v)
        return jbatch.verify_many(vs, rng=rng, mesh=0, **kw)


def _mesh_verdicts(batches, d, merge, chunk=8):
    return batch.verify_many(
        [_queue([(bytes(vk), T.Signature.from_bytes(bytes(s)), m)
                 for vk, s, m in ents]) for ents in batches],
        rng=rng, chunk=chunk, hybrid=False, merge=merge, mesh=d,
        device="cpu", health=health.DeviceHealth(clock=health.FakeClock()))


def _rfc8032_batches():
    from test_torch_batch import RFC8032

    return [[(bytes.fromhex(pk), bytes.fromhex(sig), bytes.fromhex(msg))]
            for _sk, pk, sig, msg in RFC8032]


def _matrix_batches(per_batch):
    """The 196 (A, R) pairs, s = 0, in batches of `per_batch` cases."""
    encs = [p.compress() for p in edwards.eight_torsion()]
    encs += fixtures.non_canonical_point_encodings()[:6]
    cases = [(A, R + b"\x00" * 32, b"Zcash") for A in encs for R in encs]
    return [cases[i:i + per_batch] for i in range(0, 196, per_batch)]


@pytest.mark.parametrize("merge", ["never", "always"])
def test_mesh_verify_many_rfc8032_and_tampered_stream(monkeypatch, merge):
    """RFC 8032 vectors and a stream with two tampered batches through a
    2-shard mesh: the JAX package's verdicts (and the host oracle's)."""
    stream = [_entries(3, tamper_at=(1 if b in (2, 5) else None),
                       seed=10 + b) for b in range(7)]
    for batches in (_rfc8032_batches(), stream):
        want = _jax_host_verdicts(batches, monkeypatch, merge=merge)
        assert _mesh_verdicts(batches, 2, merge) == want
        assert batch.last_run_stats["mesh"] == 2
    assert want == [b not in (2, 5) for b in range(7)]


@pytest.mark.parametrize("merge, per_batch", [("never", 14),
                                              ("always", 1)])
def test_mesh_verify_many_zip215_matrix(monkeypatch, merge, per_batch):
    """The 196 small-order × non-canonical (A, R) pairs — as 14 batches of
    14 unmerged, and as 196 batches of one union-merged — accept on the
    mesh as in the JAX package."""
    batches = _matrix_batches(per_batch)
    assert sum(len(b) for b in batches) == 196
    want = _jax_host_verdicts(batches, monkeypatch, merge=merge)
    assert want == [True] * len(batches)
    assert _mesh_verdicts(batches, 2, merge, chunk=14) == want


def test_lane_registry_keeps_one_lane_per_mode():
    """Lanes are per dispatch mode and placement and coexist: repeated
    gets reuse; mesh 1 is the single-device mode; reset_all drains."""
    h = health.DeviceHealth(clock=health.FakeClock())
    solo = batch._DeviceLane.get("cpu", health=h)
    mesh2 = batch._DeviceLane.get("cpu", health=h, mesh=2,
                                  placement=_cpu(2))
    mesh4 = batch._DeviceLane.get("cpu", health=h, mesh=4,
                                  placement=_cpu(4))
    reformed = batch._DeviceLane.get("cpu", health=h, mesh=2,
                                     placement=_cpu(2), chips=(0, 2))
    lanes = [solo, mesh2, mesh4, reformed]
    assert len({id(x) for x in lanes}) == 4
    assert [x._mesh for x in lanes] == [0, 2, 4, 2]
    assert batch._DeviceLane.get("cpu", health=h, mesh=1) is solo
    assert batch._DeviceLane.get("cpu", health=h, mesh=2,
                                 placement=_cpu(2)) is mesh2
    assert all(x._thread.is_alive() for x in lanes)
    assert batch._DeviceLane.reset_all(timeout=30.0)
    assert not any(x._thread.is_alive() for x in lanes)


def test_shard_pads_fit_k2():
    """Every shard holds a whole number of K2's 64-lane chunks, the
    cached layout included, and the pads cover the terms."""
    for n in (1, 63, 64, 65, 1000, 100_514):
        for d in (1, 2, 4, 8):
            total = sharded_msm.shard_pad(n, d)
            assert total >= n and total % d == 0
            assert (total // d) % 64 == 0
            for n_head in (2, 130, 514):
                nr = sharded_msm.shard_pad_cached(n, n_head, d)
                assert nr % d == 0 and nr // d >= -(-n // d)
                assert (n_head + nr // d) % 64 == 0
