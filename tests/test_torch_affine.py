"""The affine point wire (`ED25519_TPU_WIRE=affine`) of the port on the CPU:
K6's plain versions (`msm.expand_affine_points_plain`) against the JAX
package's `ops/msm.py expand_affine_points` — the lab's 20-limb form limb
for limb (the port's torch_field is the JAX package's jnp_field carry for
carry), the default form limb for limb against canonical_limbs20 of the
JAX output — the affine device operands against the JAX package's after
carry.py, and the same verdicts on either wire.  Tolerance: exact — limbs
for the expansion, bytes for the operands."""

import random

import numpy as np
import pytest
import torch

import ed25519_consensus_tpu as J
import ed25519_consensus_tpu_torch as T
from ed25519_consensus_tpu import batch as jbatch
from ed25519_consensus_tpu.ops import msm as jmsm
from ed25519_consensus_tpu_torch import batch, carry, health
from ed25519_consensus_tpu_torch.config import override
from ed25519_consensus_tpu_torch.ops import edwards, limbs, msm
from ed25519_consensus_tpu_torch.ops.field import P


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker (the port tests' idiom)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _affine_limbs(n, seed):
    """(1, 2, NLIMBS, n) int16 X‖Y limbs: real affine points first, then
    limbs at the bound |limb| = 8191 and around zero."""
    r = random.Random(seed)
    pts = [edwards.BASEPOINT.scalar_mul(r.getrandbits(128) + 1).to_affine()
           for _ in range(n // 2)]
    real = limbs.pack_point_affine_batch(pts).astype(np.int16)
    ext = np.random.default_rng(seed).choice(
        np.array([-8191, 8191, -4096, 4096, -1, 0, 1], dtype=np.int16),
        size=(2, limbs.NLIMBS, n - n // 2))
    return np.concatenate([real, ext], axis=-1)[None]


def _canonical(points):
    """canonical_limbs20 of every coordinate of (B, 4, NLIMBS, N) limbs."""
    from ed25519_consensus_tpu_torch.ops import torch_field as F

    x = torch.from_numpy(np.asarray(points).astype(np.int32)).movedim(2, 0)
    return F.canonical_limbs20(x).movedim(0, 2).to(torch.int16)


def test_expand_affine_matches_reference_limb_for_limb():
    """The lab's 20-limb K6 equals the JAX function limb for limb; the
    default K6 equals canonical_limbs20 of it, limb for limb."""
    a = _affine_limbs(40, seed=1)
    want = np.asarray(jmsm.expand_affine_points(a))
    got = msm.expand_affine_points(torch.from_numpy(a), arith="l20")
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy(), want)
    canon = msm.expand_affine_points(torch.from_numpy(a))
    assert canon.dtype == torch.int16
    assert torch.equal(canon, _canonical(want))
    single = msm.expand_affine_points_single(torch.from_numpy(a[0]))
    assert torch.equal(single, canon[0])


def test_expand_affine_at_the_limb_extremes():
    """T = X·Y on limbs at ±8191 stays inside |limb| ≤ 8191, so the 20-limb
    K6's int16 store is exact: the int32 product equals its int16 cast,
    and it is the exact product mod p; the default K6 writes the canonical
    limbs of the same X, Y and product."""
    from ed25519_consensus_tpu_torch.ops import torch_field as F

    for xs, ys in ((8191, 8191), (8191, -8191), (-8191, -8191)):
        a = np.zeros((1, 2, limbs.NLIMBS, 1), np.int16)
        a[0, 0], a[0, 1] = xs, ys
        out = msm.expand_affine_points(torch.from_numpy(a),
                                       arith="l20")[0, ..., 0]
        X = torch.from_numpy(a[0, 0].astype(np.int32))
        Y = torch.from_numpy(a[0, 1].astype(np.int32))
        t32 = F.mul(X, Y)[:, 0]
        assert int(t32.abs().max()) <= 8191
        assert torch.equal(out[3].to(torch.int32), t32)
        xi, yi = (limbs.limbs_to_int(v[:, 0].tolist()) for v in (X, Y))
        assert limbs.limbs_to_int(out[3].tolist()) % P == xi * yi % P
        assert out[2].tolist() == [1] + [0] * (limbs.NLIMBS - 1)
        canon = msm.expand_affine_points(torch.from_numpy(a))
        assert torch.equal(canon, _canonical(out[None, ..., None].numpy()))
        for c, v in ((0, xi), (1, yi), (2, 1), (3, xi * yi)):
            assert limbs.limbs_to_int(canon[0, c, :, 0].tolist()) == v % P


def _pair(n, n_keys, seed, tamper_at=None):
    r = random.Random(seed)
    keys = [T.SigningKey.new(r) for _ in range(n_keys)]
    tv, jv = batch.Verifier(), jbatch.Verifier()
    for i in range(n):
        sk = keys[i % n_keys]
        m = b"affine-%d" % i
        sig = sk.sign(m if i != tamper_at else b"tampered")
        tv.queue((sk.verification_key_bytes(), sig, m))
        jv.queue((bytes(sk.verification_key_bytes()),
                  J.Signature.from_bytes(bytes(sig)), m))
    return tv, jv


def _pad(n):
    return -(-n // 128) * 128


def test_affine_operands_equal_reference_after_carry():
    """Under one blinder seed, the JAX package's affine operands equal the
    port's own and those of the JAX staged batch carried across; a batch
    carried without encodings falls back to the affine wire."""
    tv, jv = _pair(60, 7, seed=3)
    js = jv._stage(random.Random(4))
    want = js.device_operands(_pad, wire="affine")
    assert want[1].dtype == np.int16 and want[1].shape[:2] == (2, 20)
    mine = tv._stage(random.Random(4)).device_operands(_pad, wire="affine")
    shifts = [((p.X, p.Y, p.Z, p.T), enc, hint)
              for p, enc, hint in js.coeff_shifts]
    carried = carry.staged_from_reference(
        js.coeffs, shifts, js.z_blob, js.raw_points, js.enc32, js.hints,
        js.keyset_blob)
    no_enc = carry.staged_from_reference(
        js.coeffs, shifts, js.z_blob, js.raw_points, None, None)
    for got in (mine, carried.device_operands(_pad, wire="affine"),
                no_enc.device_operands(_pad)):
        assert all(x.dtype == y.dtype and np.array_equal(x, y)
                   for x, y in zip(got, want))
    with override(ED25519_TPU_WIRE="affine"):
        assert np.array_equal(carried.device_operands(_pad)[1], want[1])
    # the carried affine operands through the port's window sums accept
    d, w = carry.operands_to_device(*want, device="cpu")
    ws = msm.dispatch_window_sums(d, w, device="cpu").numpy()
    assert msm.combine_window_sums(ws).mul_by_cofactor().is_identity()


@pytest.mark.parametrize("tamper_at", [None, 9])
def test_affine_and_compressed_give_the_same_verdicts(tamper_at):
    ok = tamper_at is None
    for wire in ("compressed", "affine"):
        tv, jv = _pair(30, 4, seed=5, tamper_at=tamper_at)
        with override(ED25519_TPU_WIRE=wire):
            try:
                tv.verify(rng=random.Random(6), device="cpu")
                verdict = True
            except T.InvalidSignature:
                verdict = False
        assert verdict == ok, wire
    try:
        jv.verify(rng=random.Random(6), backend="host")
        assert ok
    except J.InvalidSignature:
        assert not ok


def test_affine_wire_through_verify_many_single_lane_and_mesh():
    """verify_many on the affine wire, the padding batches on the affine
    identity: the single lane and a 2-shard mesh give the host's
    verdicts."""
    batches = [_pair(6, 2, seed=10 + b, tamper_at=2 if b == 1 else None)[0]
               for b in range(3)]
    with override(ED25519_TPU_WIRE="affine"):
        for mesh in (0, 2):
            got = batch.verify_many(
                [v.clone() for v in batches], rng=random.Random(7),
                chunk=2, hybrid=False, merge="never", mesh=mesh,
                device="cpu",
                health=health.DeviceHealth(clock=health.FakeClock()))
            assert got == [True, False, True]
            assert batch.last_run_stats["mesh"] == mesh
    batch._DeviceLane.reset_all()
    batch.reset_device_health()


def test_wire_detection():
    assert msm.wire_of(np.zeros((1, 33, 64), np.uint8)) == "compressed"
    assert msm.wire_of(np.zeros((1, 2, 20, 64), np.int16)) == "affine"
    assert msm.wire_of(np.zeros((1, 4, 20, 64), np.int16)) == "extended"
    ext = torch.from_numpy(limbs.identity_point_batch(64)[None])
    assert msm.expand_points(ext) is ext
    aff = torch.from_numpy(limbs.identity_affine_batch(64))
    assert torch.equal(msm.expand_points_single(aff), ext[0])
    with pytest.raises(ValueError, match="affine"):
        msm.expand_affine_points(torch.zeros((1, 2, 20, 8), dtype=torch.int32))
