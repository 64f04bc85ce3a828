"""The port's native host runtime (`ed25519_consensus_tpu_torch/native.py`,
its own copy of the C++ source in `csrc/host/fe25519.cpp`) against its
exact-Python path and against the JAX package's native module, byte for
byte: ZIP215 decompression (the 26 non-canonical encodings, the 8-torsion,
encodings that are not points, random points), host staging on both walks,
the bulk challenge hashes, the host MSM and the fused host verify.  The
tolerance everywhere is exact equality."""

import hashlib
import random

import numpy as np
import pytest
import torch

import ed25519_consensus_tpu as J
import ed25519_consensus_tpu_torch as T
from ed25519_consensus_tpu import batch as jbatch
from ed25519_consensus_tpu import native as jnative
from ed25519_consensus_tpu_torch import batch, native
from ed25519_consensus_tpu_torch.error import InvalidSignature
from ed25519_consensus_tpu_torch.ops import edwards
from ed25519_consensus_tpu_torch.ops.scalar import L
from ed25519_consensus_tpu_torch.utils import fixtures


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker (the port tests' idiom)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def exact(monkeypatch):
    """Select the port's exact-Python path (ED25519_TPU_DISABLE_NATIVE)."""
    monkeypatch.setenv("ED25519_TPU_DISABLE_NATIVE", "1")
    assert native.load() is None


def _not_points(n, rng):
    out = []
    while len(out) < n:
        e = rng.getrandbits(256).to_bytes(32, "little")
        if edwards.decompress(e) is None:
            out.append(e)
    return out


def _random_points(n, rng):
    out = []
    while len(out) < n:
        e = rng.getrandbits(256).to_bytes(32, "little")
        if edwards.decompress(e) is not None:
            out.append(e)
    return out


ENCODING_SETS = {
    "non_canonical_26": lambda rng: fixtures.non_canonical_point_encodings(),
    "eight_torsion": lambda rng: [p.compress()
                                  for p in edwards.eight_torsion()],
    "not_points": lambda rng: _not_points(24, rng),
    "random_points": lambda rng: _random_points(64, rng),
}


def test_native_builds_into_build_and_passes_its_self_check(monkeypatch):
    lib = native.load()
    assert lib is not None
    path = native.library_path()
    assert path.parent.name == "build" and path.exists()
    assert path.name.startswith("fe25519-host-")
    # the cache key covers the flags (and the source and the host)
    monkeypatch.setattr(native, "CXXFLAGS", native.CXXFLAGS + ["-g"])
    assert native.library_path() != path


def test_disable_native_selects_the_exact_python_path(exact):
    rng = random.Random(3)
    sk = T.SigningKey.new(rng)
    v = batch.Verifier()
    v.queue_bulk([(sk.verification_key_bytes(), sk.sign(b"m%d" % i),
                   b"m%d" % i) for i in range(5)])
    assert native.decompress_batch_buffer(b"\x00" * 32, 1) is None
    assert native.stage_scalars_gid(b"", b"", b"", 0, b"", 0) \
        is NotImplemented
    v.verify(rng=rng, backend="host")
    v.verify(rng=rng, backend="device", device="cpu")


@pytest.mark.parametrize("which", sorted(ENCODING_SETS))
def test_decompression_byte_identical(which, monkeypatch):
    """Raw rows, accept flags and hints of the port's native runtime equal
    the JAX package's native module byte for byte, and its exact path
    equals the JAX package's exact path.  Native and exact agree byte for
    byte on the rows and flags; their hints differ only where x = 0 (the
    y = ±1 encodings with the sign bit set), in the neg bit, which negates
    zero — the reference's two paths differ the same way — and the device
    expands both hint bytes to the same point."""
    encs = ENCODING_SETS[which](random.Random(len(which)))
    blob, n = b"".join(encs), len(encs)
    got = native.decompress_batch_buffer(blob, n)
    ref = jnative.decompress_batch_buffer(blob, n, return_hints=True)
    monkeypatch.setenv("ED25519_TPU_DISABLE_NATIVE", "1")
    exact = batch.decompress_buffer(blob, n)
    ref_exact = jnative.decompress_batch_buffer(blob, n, return_hints=True)
    for a, b, c, d in zip(got, ref, exact, ref_exact):
        assert a.dtype == b.dtype == c.dtype == np.uint8
        assert np.array_equal(a, b) and np.array_equal(c, d)
    assert np.array_equal(got[0], exact[0])
    assert np.array_equal(got[1], exact[1])
    _hints_agree(got[2], exact[2], got[1], encs)
    want_ok = [edwards.decompress(e) is not None for e in encs]
    assert got[1].astype(bool).tolist() == want_ok


def _hints_agree(native_hints, exact_hints, ok, encs):
    """Native and exact hints are equal on every accepted encoding except
    x = 0 points, where they differ in the neg bit alone; there the device
    expands the two to the same point (the limbs may differ: the
    recomputed x is 0 mod p, not the zero limb vector)."""
    from ed25519_consensus_tpu_torch.ops import limbs
    from ed25519_consensus_tpu_torch.ops import torch_decompress as TD

    differ = [i for i in np.nonzero(native_hints != exact_hints)[0]
              if ok[i]]
    for i in differ:
        assert edwards.decompress(encs[i]).X % edwards.P == 0
        assert native_hints[i] ^ exact_hints[i] == 2  # the neg bit only
    if not differ:
        return
    wire = np.zeros((2, 33, len(differ)), dtype=np.uint8)
    wire[:, :32] = np.frombuffer(b"".join(encs[i] for i in differ),
                                 np.uint8).reshape(len(differ), 32).T
    wire[0, 32], wire[1, 32] = native_hints[differ], exact_hints[differ]
    pts = TD.expand_compressed_points_plain(torch.from_numpy(wire)).numpy()
    for j in range(len(differ)):
        assert limbs.unpack_point(pts[0][..., j]) == \
            limbs.unpack_point(pts[1][..., j])


def _entries(n, n_keys, seed, small_order=False):
    rng = random.Random(seed)
    keys = [T.SigningKey.new(rng) for _ in range(n_keys)]
    out = []
    for i in range(n):
        sk = keys[i % n_keys]
        msg = b"native-%d-%d" % (seed, i)
        out.append((sk.verification_key_bytes(), sk.sign(msg), msg))
    if small_order:
        encs = [p.compress() for p in edwards.eight_torsion()]
        encs += fixtures.non_canonical_point_encodings()[:6]
        out += [(A, T.Signature(R, b"\x00" * 32), b"Zcash")
                for A in encs[::3] for R in encs[1::4]]
    return out


def _jax_entries(entries):
    return [(bytes(vk), J.Signature(s.R_bytes, s.s_bytes), m)
            for vk, s, m in entries]


def _staged_fields(s):
    return (s.coeffs, s.z_blob, s.raw_points.tobytes(), s.enc32.tobytes(),
            s.hints.tobytes(), s.keyset_blob,
            [(pt, enc, hint) for pt, enc, hint in s.coeff_shifts])


@pytest.mark.parametrize("walk", ["queue_order", "grouped"])
def test_staging_byte_identical(walk, monkeypatch):
    """The same entries and blinder seed staged by the port's native
    runtime, by its exact-Python path and by the JAX package: identical
    coefficients, blinders, raw point rows, encodings, hints, keyset blob
    and split-high terms."""
    entries = _entries(90, 7, seed=11, small_order=True)
    tv, jv = batch.Verifier(), jbatch.Verifier()
    tv.queue_bulk(entries)
    jv.queue_bulk(_jax_entries(entries))
    if walk == "grouped":
        assert len(tv.signatures) == len(jv.signatures)
    assert tv._buffers_live() == jv._buffers_live() == (
        walk == "queue_order")
    mine = _staged_fields(tv._stage(random.Random(5)))
    ref = jv._stage(random.Random(5))
    ref_fields = list(_staged_fields(ref))
    ref_fields[6] = [(edwards.Point(p.X, p.Y, p.Z, p.T), e, h)
                     for p, e, h in ref_fields[6]]
    assert mine[:6] == tuple(ref_fields[:6])
    assert [(e, h) for _, e, h in mine[6]] == \
        [(e, h) for _, e, h in ref_fields[6]]
    assert [p for p, _, _ in mine[6]] == [p for p, _, _ in ref_fields[6]]
    monkeypatch.setenv("ED25519_TPU_DISABLE_NATIVE", "1")
    ex = tv._stage(random.Random(5))
    ex_fields = _staged_fields(ex)
    assert ex_fields[:4] == mine[:4] and ex_fields[5] == mine[5]
    assert ex_fields[6] == mine[6]
    encs = [bytes(r) for r in ex.enc32]
    _hints_agree(np.frombuffer(mine[4], np.uint8), ex.hints,
                 np.ones(len(encs), np.uint8), encs)


@pytest.mark.parametrize("native_on", [True, False], ids=["native", "exact"])
@pytest.mark.parametrize("fault", ["s_ge_l", "r_not_a_point",
                                   "key_not_a_point"])
def test_staging_rejects_on_both_paths(fault, native_on, monkeypatch):
    if not native_on:
        monkeypatch.setenv("ED25519_TPU_DISABLE_NATIVE", "1")
    entries = _entries(12, 3, seed=13)
    vk, sig, msg = entries[4]
    bad = _not_points(1, random.Random(2))[0]
    if fault == "s_ge_l":
        entries[4] = (vk, T.Signature(sig.R_bytes,
                                      int(L).to_bytes(32, "little")), msg)
    elif fault == "r_not_a_point":
        entries[4] = (vk, T.Signature(bad, sig.s_bytes), msg)
    else:
        entries[4] = (bad, sig, msg)
    v = batch.Verifier()
    v.queue_bulk(entries)
    with pytest.raises(InvalidSignature):
        v._stage(random.Random(1))
    for backend in ("host", "device"):
        with pytest.raises(InvalidSignature):
            v.verify(rng=random.Random(1), backend=backend, device="cpu")


def test_bulk_challenges_match_hashlib_and_queue(monkeypatch):
    entries = _entries(40, 5, seed=17)
    entries[3] = (entries[3][0], entries[3][1], b"x" * 300)
    bulk = batch.Verifier()
    bulk.queue_bulk(entries)
    one = batch.Verifier()
    for e in entries:
        one.queue(e)
    assert bytes(bulk._k_buf) == bytes(one._k_buf)
    jv = jbatch.Verifier()
    jv.queue_bulk(_jax_entries(entries))
    assert bytes(bulk._k_buf) == bytes(jv._k_buf)
    vk, sig, msg = entries[3]
    h = hashlib.sha512(sig.R_bytes + bytes(vk) + msg)
    from ed25519_consensus_tpu_torch.ops import scalar

    assert int.from_bytes(bulk._k_buf[96:128], "little") == \
        scalar.from_hash(h)


def test_host_msm_native_equals_exact(monkeypatch):
    v = batch.Verifier()
    v.queue_bulk(_entries(30, 4, seed=19, small_order=True))
    staged = v._stage(random.Random(2))
    got = staged.host_msm()
    monkeypatch.setenv("ED25519_TPU_DISABLE_NATIVE", "1")
    assert staged.host_msm() == got
    assert got.mul_by_cofactor().is_identity()


@pytest.mark.parametrize("case", ["valid", "tampered", "small_order"])
def test_fused_host_verify_verdicts(case, monkeypatch):
    """The one-call native host verify against the staged exact path and
    the JAX package's host verify."""
    entries = _entries(25, 4, seed=23, small_order=case == "small_order")
    if case == "tampered":
        vk, sig, _ = entries[7]
        entries[7] = (vk, sig, b"tampered")
    want = case != "tampered"

    def verdict(v, **kw):
        try:
            v.verify(rng=random.Random(4), **kw)
            return True
        except (InvalidSignature, J.InvalidSignature):
            return False

    v = batch.Verifier()
    v.queue_bulk(entries)
    timings = {}
    assert verdict(v, backend="host", timings=timings) == want
    assert set(timings) == {"host_fused"}
    jv = jbatch.Verifier()
    jv.queue_bulk(_jax_entries(entries))
    assert verdict(jv, backend="host") == want
    monkeypatch.setenv("ED25519_TPU_DISABLE_NATIVE", "1")
    timings.clear()
    assert verdict(v, backend="host", timings=timings) == want
    assert "msm_host" in timings


def test_chip_smoke_fails_when_the_native_runtime_is_missing(monkeypatch):
    """A broken native build must never pass as a slow run."""
    import chip_smoke

    monkeypatch.setattr(native, "load", lambda: None)
    with pytest.raises(AssertionError, match="native host runtime"):
        chip_smoke.phase_native({})
