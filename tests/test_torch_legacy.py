"""The port's legacy (pre-ZIP215) oracle and its ZIP215 verdicts over the
legacy corpus (tests/data/legacy_oracle_corpus.json: the 196-case
small-order × non-canonical matrix, the RFC 8032 vectors and their
mutations, random valid and mutated signatures — 256 cases), held against
the JAX package on the same bytes:

* the port's `legacy_verify` equals the JAX package's on every case, and
  both equal the corpus's committed OpenSSL verdict mapped through the two
  data-pinned deltas (the libsodium blacklist of R encodings, the all-zero
  key) — the mapping tests/test_legacy_corpus.py uses;
* the port's ZIP215 verdicts equal the JAX package's, on the host (one
  `VerificationKey.verify` a case) and through the port's
  `verify_many(device="cpu")`, one signature a batch, device only, where
  every kernel runs its plain PyTorch version.

The corpus's live-OpenSSL cases need the `cryptography` package and are
not ported."""

import collections
import json
import random
from pathlib import Path

import pytest

import ed25519_consensus_tpu as J
from ed25519_consensus_tpu.utils import legacy as jlegacy
import ed25519_consensus_tpu_torch as T
from ed25519_consensus_tpu_torch import batch, health
from ed25519_consensus_tpu_torch.ops import edwards
from ed25519_consensus_tpu_torch.utils import fixtures
from ed25519_consensus_tpu_torch.utils import legacy as tlegacy
from ed25519_consensus_tpu_torch.verification_key import VerificationKeyBytes

from torch_threads import _one_torch_thread  # noqa: F401


CORPUS = json.loads((Path(__file__).parent / "data" /
                     "legacy_oracle_corpus.json").read_text())["cases"]
KINDS = sorted(collections.Counter(c["kind"] for c in CORPUS))


def _bytes(c):
    return (bytes.fromhex(c["vk"]), bytes.fromhex(c["sig"]),
            bytes.fromhex(c["msg"]))


def _expected_legacy(vk: bytes, sig: bytes, openssl_ok: bool) -> bool:
    """The corpus's OpenSSL verdict through the two documented deltas."""
    if vk == b"\x00" * 32:
        return False
    R = edwards.decompress(sig[:32])
    if R is not None and R.compress() in fixtures.EXCLUDED_POINT_ENCODINGS:
        return False
    return openssl_ok


def _zip215(pkg, vk, sig, msg) -> bool:
    try:
        pkg.VerificationKey.from_bytes(vk).verify(
            pkg.Signature.from_bytes(sig), msg)
    except pkg.Error:
        return False
    return True


def test_corpus_covers_the_matrix_and_every_family():
    assert len(CORPUS) == 256
    assert sum(c["kind"] == "matrix" for c in CORPUS) == 196
    assert len(KINDS) == 9


def test_blacklist_is_the_reference_packages():
    from ed25519_consensus_tpu.utils import fixtures as jfixtures

    assert fixtures.EXCLUDED_POINT_ENCODINGS == \
        jfixtures.EXCLUDED_POINT_ENCODINGS


@pytest.mark.parametrize("kind", KINDS)
def test_legacy_oracle_equals_reference_and_openssl_mapping(kind):
    cases = [c for c in CORPUS if c["kind"] == kind]
    for c in cases:
        vk, sig, msg = _bytes(c)
        got = tlegacy.legacy_verify(vk, sig, msg)
        assert got == jlegacy.legacy_verify(vk, sig, msg), c
        assert got == _expected_legacy(vk, sig, c["openssl"]), c


@pytest.mark.parametrize("kind", KINDS)
def test_zip215_host_verdicts_equal_reference(kind):
    for c in (c for c in CORPUS if c["kind"] == kind):
        vk, sig, msg = _bytes(c)
        assert _zip215(T, vk, sig, msg) == _zip215(J, vk, sig, msg), c


def test_legacy_and_zip215_diverge_where_the_rules_do():
    """ZIP215 accepts every small-order matrix case (s = 0, both points
    of small order); the legacy rules accept few of them — the
    divergence the oracle exists to show, equal in both packages."""
    zip_ok = legacy_ok = 0
    for c in CORPUS:
        if c["kind"] != "matrix":
            continue
        vk, sig, msg = _bytes(c)
        zip_ok += _zip215(T, vk, sig, msg)
        legacy_ok += tlegacy.legacy_verify(vk, sig, msg)
    assert zip_ok == 196
    assert legacy_ok < zip_ok


def _one_sig_batches(cases):
    """One Verifier per case; a case whose bytes do not parse is an
    invalidated batch, False before any device call."""
    vs = []
    for c in cases:
        vk, sig, msg = _bytes(c)
        v = batch.Verifier()
        try:
            v.queue((VerificationKeyBytes(vk), T.Signature.from_bytes(sig),
                     msg))
        except T.Error:
            v.batch_size = 1
            v.invalidate("malformed wire bytes")
        vs.append(v)
    return vs


def _device_only(vs, merge):
    return batch.verify_many(vs, rng=random.Random(215), chunk=8,
                             hybrid=False, merge=merge, mesh=0,
                             device="cpu",
                             health=health.DeviceHealth(
                                 clock=health.FakeClock()))


def test_zip215_verdicts_through_verify_many_on_the_cpu():
    """The corpus through the port's verify_many on the CPU, device only,
    every verdict equal to the JAX package's host verdict: the 60 cases
    outside the matrix one signature a batch (merge="never"), and the 196
    matrix cases merged into one union the device decides (all True under
    ZIP215, so the union's accept is every member's)."""
    rest = [c for c in CORPUS if c["kind"] != "matrix"]
    got = _device_only(_one_sig_batches(rest), "never")
    assert got == [_zip215(J, *_bytes(c)) for c in rest]
    st = batch.last_run_stats
    assert st["device_batches"] > 0 and st["device_rejects_confirmed"] > 0
    matrix = [c for c in CORPUS if c["kind"] == "matrix"]
    got = _device_only(_one_sig_batches(matrix), "always")
    assert got == [_zip215(J, *_bytes(c)) for c in matrix] == [True] * 196
    st = batch.last_run_stats
    assert st["merged_unions"] == 1 and st["device_unions"] == 1
