"""Batch verification through the port (`ed25519_consensus_tpu_torch`), with
the device MSM on the CPU (`device="cpu"`: every kernel wrapper runs its
plain PyTorch version), against the JAX package's verdicts on the same
signatures.

The cases: the RFC 8032 vectors, the full 196-case ZIP215 small-order ×
non-canonical matrix as one coalesced batch plus its 14 batch-of-one
cases (all accept), the four rejection classes, and a 1k-signature random
batch whose device operands must be byte-identical to the JAX package's
under the same blinder seed — staged by the port itself, and carried
across with `carry.py`."""

import hashlib
import random

import numpy as np
import pytest
import torch

import ed25519_consensus_tpu as J
import ed25519_consensus_tpu_torch as T
from ed25519_consensus_tpu import batch as jbatch
from ed25519_consensus_tpu.ops import msm as jmsm
from ed25519_consensus_tpu_torch import batch, carry
from ed25519_consensus_tpu_torch.ops import edwards, msm
from ed25519_consensus_tpu_torch.ops.scalar import L
from ed25519_consensus_tpu_torch.utils import fixtures

from torch_threads import _one_torch_thread  # noqa: F401


# RFC 8032 §7.1 TEST 1-3 (tests/test_rfc8032.py): (sk, pk, sig, msg) hex.
RFC8032 = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8821"
     "590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b", ""),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da085ac1e"
     "43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00", "72"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac18ff9b5"
     "38d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a", "af82"),
]


def _verdict(verifier, **kw) -> bool:
    try:
        verifier.verify(**kw)
    except (T.InvalidSignature, J.InvalidSignature):
        return False
    return True


def _pair(entries):
    """A port verifier and a JAX-package verifier over the same
    (vk bytes, sig bytes, msg) entries."""
    tv, jv = batch.Verifier(), jbatch.Verifier()
    for vkb, sigb, msg in entries:
        tv.queue((bytes(vkb), T.Signature.from_bytes(bytes(sigb)), msg))
        jv.queue((bytes(vkb), J.Signature.from_bytes(bytes(sigb)), msg))
    return tv, jv


def _both_verdicts(entries, seed=1):
    tv, jv = _pair(entries)
    return (_verdict(tv, rng=random.Random(seed), backend="device",
                     device="cpu"),
            _verdict(jv, rng=random.Random(seed), backend="host"))


@pytest.mark.parametrize("vec", RFC8032, ids=["test1", "test2", "test3"])
def test_rfc8032_vectors(vec):
    sk_hex, pk_hex, sig_hex, msg_hex = vec
    msg = bytes.fromhex(msg_hex)
    for form in (bytes.fromhex(sk_hex),
                 hashlib.sha512(bytes.fromhex(sk_hex)).digest()):
        sk = T.SigningKey.from_bytes(form)
        assert bytes(sk.verification_key_bytes()) == bytes.fromhex(pk_hex)
        assert bytes(sk.sign(msg)) == bytes.fromhex(sig_hex)
    vk = T.VerificationKey.from_bytes(bytes.fromhex(pk_hex))
    vk.verify(T.Signature.from_bytes(bytes.fromhex(sig_hex)), msg)
    entry = (bytes.fromhex(pk_hex), bytes.fromhex(sig_hex), msg)
    assert _both_verdicts([entry]) == (True, True)


def _matrix_encodings():
    encs = [p.compress() for p in edwards.eight_torsion()]
    encs += fixtures.non_canonical_point_encodings()[:6]
    return encs


def test_zip215_matrix_as_one_batch():
    """All 196 (A, R) pairs of the small-order × non-canonical matrix with
    s = 0 in ONE coalesced batch: ZIP215 accepts every one."""
    encs = _matrix_encodings()
    entries = [(A, R + b"\x00" * 32, b"Zcash") for A in encs for R in encs]
    assert len(entries) == 196
    assert _both_verdicts(entries, seed=2) == (True, True)
    tv, _ = _pair(entries)
    tv.verify(rng=random.Random(3), backend="host")


@pytest.mark.parametrize("i", range(14))
def test_zip215_matrix_batch_of_one(i):
    encs = _matrix_encodings()
    A, R = encs[i], encs[(i * 5 + 3) % len(encs)]
    assert _both_verdicts([(A, R + b"\x00" * 32, b"Zcash")], seed=i) == \
        (True, True)


def _good_entries(n, n_keys, seed):
    rng = random.Random(seed)
    keys = [T.SigningKey.new(rng) for _ in range(n_keys)]
    out = []
    for i in range(n):
        sk = keys[i % n_keys]
        msg = b"tx-%d" % i
        out.append((bytes(sk.verification_key_bytes()), bytes(sk.sign(msg)),
                    msg))
    return out


def _non_point():
    y = 2
    while edwards.decompress(y.to_bytes(32, "little")) is not None:
        y += 1
    return y.to_bytes(32, "little")


def _tamper(kind, entries):
    entries = list(entries)
    vkb, sigb, msg = entries[3]
    if kind == "message":
        entries[3] = (vkb, sigb, msg + b"!")
    elif kind == "s_ge_l":
        s = int.from_bytes(sigb[32:], "little") + L
        entries[3] = (vkb, sigb[:32] + s.to_bytes(32, "little"), msg)
    elif kind == "non_point_A":
        entries[3] = (_non_point(), sigb, msg)
    elif kind == "non_point_R":
        entries[3] = (vkb, _non_point() + sigb[32:], msg)
    return entries


@pytest.mark.parametrize("kind", ["message", "s_ge_l", "non_point_A",
                                  "non_point_R"])
def test_bad_batches_are_rejected(kind):
    entries = _tamper(kind, _good_entries(8, 3, seed=0xBAD))
    assert _both_verdicts(entries, seed=4) == (False, False)
    tv, _ = _pair(entries)
    with pytest.raises(T.InvalidSignature):
        tv.verify(rng=random.Random(5), backend="host")
    with pytest.raises(T.InvalidSignature):
        tv.verify_async(rng=random.Random(6), device="cpu").result()


@pytest.fixture(scope="module")
def random_1k():
    return _good_entries(1000, 40, seed=0x1000)


def _pad(n):
    return -(-n // 128) * 128


def test_random_1k_batch_verdicts(random_1k):
    timings = {}
    tv, jv = _pair(random_1k)
    tv.verify(rng=random.Random(7), backend="device", device="cpu",
              timings=timings)
    assert set(timings) == {"stage_host", "device", "combine"}
    assert _verdict(jv, rng=random.Random(7), backend="host")
    tv.verify_async(rng=random.Random(8), device="cpu").result()


def _operands_equal(a, b):
    return all(x.dtype == y.dtype and x.shape == y.shape
               and np.array_equal(x, y) for x, y in zip(a, b))


def test_random_1k_operands_byte_identical(random_1k):
    """Under one blinder seed the port's staging, and the JAX package's
    staged batch carried across by carry.py, give device operands
    byte-identical to the JAX package's `device_operands`; carried to
    tensors they keep dtype and layout."""
    tv, jv = _pair(random_1k)
    js = jv._stage(random.Random(9))
    want = js.device_operands(_pad)
    assert want[0].dtype == np.uint8 and want[1].shape[0] == 33
    mine = tv._stage(random.Random(9))
    assert _operands_equal(mine.device_operands(_pad), want)
    assert mine.n_device_terms == js.n_device_terms
    carried = carry.staged_from_reference(
        js.coeffs, [((p.X, p.Y, p.Z, p.T), enc, hint)
                    for p, enc, hint in js.coeff_shifts],
        js.z_blob, js.raw_points, js.enc32, js.hints, js.keyset_blob)
    assert _operands_equal(carried.device_operands(_pad), want)
    assert carried.host_msm() == mine.host_msm()
    d, w = carry.operands_to_device(*want, device="cpu")
    assert d.dtype == torch.uint8 and w.dtype == torch.uint8
    assert tuple(w.shape) == want[1].shape
    assert np.array_equal(d.numpy(), want[0])
    # the carried operands through the port's window sums accept
    ws = msm.dispatch_window_sums(d, w, device="cpu")
    assert msm.combine_window_sums(ws.numpy()).mul_by_cofactor() \
        .is_identity()


def test_grouped_staging_matches_reference(random_1k):
    """Once the coalescing map is handed out, staging walks the groups:
    operands still equal the JAX package's grouped walk byte for byte,
    and the verdict holds."""
    entries = random_1k[:200]
    tv, jv = _pair(entries)
    assert len(tv.signatures) == len(jv.signatures) == 40
    mine = tv._stage(random.Random(10)).device_operands(jmsm._pad_lanes)
    want = jv._stage(random.Random(10)).device_operands(jmsm._pad_lanes)
    assert _operands_equal(mine, want)
    tv.verify(rng=random.Random(11), backend="device", device="cpu")
