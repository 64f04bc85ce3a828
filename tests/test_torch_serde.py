"""The port's serde (hex, JSON, and the reference-compatible layout) held
against the JAX package's on the committed reference fixture
(tests/data/ref_serde_fixtures.json, the RFC 8032 §7.1 vectors in the
layout the reference's serde derives emit): both packages parse every
document into the same objects and emit it back byte for byte, and each
package's hex and JSON text is the other's."""

import json
import random
from pathlib import Path

import pytest

import ed25519_consensus_tpu as J
from ed25519_consensus_tpu import serde as jserde
import ed25519_consensus_tpu_torch as T
from ed25519_consensus_tpu_torch import serde as tserde

from torch_threads import _one_torch_thread  # noqa: F401


FIXTURE = json.loads((Path(__file__).parent / "data" /
                      "ref_serde_fixtures.json").read_text())["cases"]
TYPES = ("Signature", "VerificationKey", "VerificationKeyBytes",
         "SigningKey")


def _objects(pkg, serde, c):
    return {
        "Signature": serde.from_ref_value(pkg.Signature, c["signature"]),
        "VerificationKey": serde.from_ref_value(pkg.VerificationKey,
                                                c["verification_key"]),
        "VerificationKeyBytes": serde.from_ref_value(
            pkg.VerificationKeyBytes, c["verification_key"]),
        "SigningKey": serde.from_ref_value(pkg.SigningKey,
                                           c["signing_key"]),
    }


@pytest.mark.parametrize("case", FIXTURE, ids=lambda c: c["name"])
def test_reference_fixture_round_trips_in_both_packages(case):
    msg = bytes.fromhex(case["msg_hex"])
    t = _objects(T, tserde, case)
    j = _objects(J, jserde, case)
    t["VerificationKey"].verify(t["Signature"], msg)
    assert t["SigningKey"].sign(msg) == t["Signature"]
    assert T.SigningKey.from_seed(bytes.fromhex(
        case["seed_hex"])).to_bytes() == t["SigningKey"].to_bytes()
    for name in TYPES:
        assert t[name].to_bytes() == j[name].to_bytes(), name
        # emit side: the committed document, byte for byte, in both
        assert tserde.to_ref_value(t[name]) == jserde.to_ref_value(j[name])
        assert tserde.to_ref_json(t[name]) == jserde.to_ref_json(j[name])
        # the hex convention: each package reads the other's text
        assert tserde.to_hex(t[name]) == jserde.to_hex(j[name])
        assert tserde.to_json(t[name]) == jserde.to_json(j[name])
        back = tserde.from_json(jserde.to_json(j[name]))
        assert type(back) is type(t[name])
        assert back.to_bytes() == t[name].to_bytes()
    assert tserde.to_ref_value(t["Signature"]) == case["signature"]
    assert tserde.to_ref_value(t["SigningKey"]) == case["signing_key"]
    assert tserde.from_ref_json(
        T.Signature, json.dumps(case["signature"])) == t["Signature"]


def test_errors_match_the_reference_package():
    """Strict parsing: the same inputs fail in both, with the port's
    error types named like the reference's."""
    sk = T.SigningKey.new(random.Random(3))
    h = tserde.to_hex(sk.verification_key())
    bad_inputs = [
        (lambda s, p: s.from_hex(p.VerificationKey, h + " ")),
        (lambda s, p: s.from_hex(p.VerificationKey, "zz" * 32)),
        (lambda s, p: s.from_hex(p.Signature, "00" * 63)),
        (lambda s, p: s.from_json('{"type": "nope", "bytes": ""}')),
        (lambda s, p: s.from_ref_value(p.Signature, {"R_bytes": [0] * 32})),
        (lambda s, p: s.from_ref_value(p.SigningKey, [0] * 32)),
        (lambda s, p: s.from_ref_value(p.VerificationKey, [256] * 32)),
    ]
    for bad in bad_inputs:
        errs = []
        for serde, pkg in ((tserde, T), (jserde, J)):
            with pytest.raises(Exception) as ei:
                bad(serde, pkg)
            errs.append(type(ei.value).__name__)
        assert errs[0] == errs[1]
    # a non-point key fails to deserialize as a VerificationKey in both,
    # and stays unvalidated as VerificationKeyBytes
    from ed25519_consensus_tpu_torch.ops import edwards

    not_a_point = next(
        enc for enc in (y.to_bytes(32, "little") for y in range(2, 64))
        if edwards.decompress(enc) is None)
    for serde, pkg in ((tserde, T), (jserde, J)):
        with pytest.raises(pkg.MalformedPublicKey):
            serde.from_hex(pkg.VerificationKey, not_a_point.hex())
        assert serde.from_hex(pkg.VerificationKeyBytes,
                              not_a_point.hex()).to_bytes() == not_a_point
    with pytest.raises(TypeError):
        tserde.to_hex(b"not a key")
