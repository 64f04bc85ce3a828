"""Human-readable structured serialization with validating deserialize.

The reference derives serde on `Signature` / `VerificationKeyBytes`
(src/signature.rs:6, src/verification_key.rs:33) and bridges
`VerificationKey` deserialization through `TryFrom<VerificationKeyBytes>`
so that *deserializing a validated key validates it*
(src/verification_key.rs:107-109); `SigningKey` gets a hand-written
64-byte tuple impl (src/signing_key.rs:31-78).  Those derives serve two
serde modes: compact binary (bincode — covered here by each type's
`to_bytes`/`from_bytes`, byte-exact) and human-readable formats (JSON &
friends) — covered here.

Two human-readable layers:

* **Hex convention (`to_hex`/`from_hex`, `to_json`/`from_json`)** — every
  type is a lowercase hex string of its compact encoding (64 hex chars
  for 32-byte types, 128 for signatures and signing keys).  This is THIS
  PROJECT'S OWN convention — compact and self-describing — and is NOT
  wire-compatible with documents produced by the reference's serde
  derives.
* **Reference-compatible layout (`to_ref_value`/`from_ref_value`,
  `to_ref_json`/`from_ref_json`)** — byte-for-byte the structures the
  reference's derives emit through a human-readable serializer like
  serde_json: `Signature` as `{"R_bytes": [32 ints], "s_bytes":
  [32 ints]}` (derived struct, src/signature.rs:6-11),
  `VerificationKeyBytes`/`VerificationKey` as a bare 32-int array
  (derived newtype, src/verification_key.rs:33 and the validating
  try_from bridge at :107-109), `SigningKey` as a 64-int array of the
  expanded secret key (hand-written tuple impl,
  src/signing_key.rs:31-78).  Use this layer to interoperate with
  reference-produced documents.

Deserializing a `VerificationKey` ALWAYS validates in both layers
(decompression may fail -> MalformedPublicKey), exactly like the
reference bridge; `VerificationKeyBytes` stays unvalidated by design
(L1 validation-deferral invariant, SURVEY.md §1).
"""

import json

from .signature import Signature
from .signing_key import SigningKey
from .verification_key import VerificationKey, VerificationKeyBytes

# type tag (JSON "type" field) -> class; single source for both directions.
_TYPES = {
    "signature": Signature,
    "verification_key_bytes": VerificationKeyBytes,
    "verification_key": VerificationKey,
    "signing_key": SigningKey,
}
_TAGS = {cls: tag for tag, cls in _TYPES.items()}


def to_hex(obj) -> str:
    """Lowercase hex of the compact encoding (the human-readable serde
    form).  Accepts any of the four public types."""
    if type(obj) not in _TAGS:
        raise TypeError(f"not a serializable ed25519 type: {type(obj)!r}")
    return obj.to_bytes().hex()


def from_hex(cls, s: str):
    """Parse `cls` from its hex form.  `VerificationKey` is validated
    (reference deserialize-validates bridge, src/verification_key.rs:107-109)
    -> raises MalformedPublicKey on a non-point; all types raise
    InvalidSliceLength on wrong length, ValueError on non-hex."""
    if cls not in _TAGS:
        raise TypeError(f"not a serializable ed25519 type: {cls!r}")
    try:
        data = bytes.fromhex(s)
    except (ValueError, TypeError):
        raise ValueError(f"invalid hex string for {cls.__name__}")
    # Strict parse: exactly 2 chars/byte (bytes.fromhex tolerates
    # whitespace — two textually distinct documents must not alias).
    # Case variation IS accepted on input; output is always lowercase.
    if len(s) != 2 * len(data):
        raise ValueError(f"invalid hex string for {cls.__name__}")
    # SigningKey accepts 32 (seed) or 64 (expanded) byte forms, like its
    # TryFrom<&[u8]> (src/signing_key.rs:102-116); the rest are fixed-size.
    return cls.from_bytes(data)


def to_json(obj) -> str:
    """Self-describing JSON document: {"type": tag, "bytes": hex}."""
    hexed = to_hex(obj)  # raises TypeError for unsupported types
    return json.dumps({"type": _TAGS[type(obj)], "bytes": hexed})


def from_json(s: str):
    """Inverse of `to_json`; dispatches on the "type" tag and validates
    where the type validates (VerificationKey)."""
    doc = json.loads(s)
    if (
        not isinstance(doc, dict)
        or not isinstance(doc.get("type"), str)
        or not isinstance(doc.get("bytes"), str)
    ):
        raise ValueError("expected a {'type','bytes'} JSON object")
    tag = doc["type"]
    if tag not in _TYPES:
        raise ValueError(f"unknown type tag {tag!r}")
    return from_hex(_TYPES[tag], doc["bytes"])


# -- reference-compatible human-readable layout ---------------------------


def to_ref_value(obj):
    """The JSON-ready value the reference's serde derives emit for `obj`
    through a human-readable serializer (see module docstring for the
    per-type layouts and reference file:line cites)."""
    if isinstance(obj, Signature):
        return {
            "R_bytes": list(obj.R_bytes),
            "s_bytes": list(obj.s_bytes),
        }
    if isinstance(obj, (VerificationKey, VerificationKeyBytes, SigningKey)):
        # newtype [u8;32] / 64-tuple expanded secret key: bare int array
        return list(obj.to_bytes())
    raise TypeError(f"not a serializable ed25519 type: {type(obj)!r}")


def _ref_bytes(value, n: int, what: str) -> bytes:
    if (
        not isinstance(value, list)
        or len(value) != n
        or not all(isinstance(b, int) and not isinstance(b, bool)
                   and 0 <= b <= 255 for b in value)
    ):
        raise ValueError(f"expected a {n}-element byte array for {what}")
    return bytes(value)


def from_ref_value(cls, value):
    """Parse `cls` from the reference's derived human-readable layout
    (inverse of `to_ref_value`).  `VerificationKey` validates on
    deserialize (reference try_from bridge); `SigningKey` takes the
    64-byte expanded form only, exactly like the reference's tuple
    visitor (src/signing_key.rs:48-78)."""
    if cls is Signature:
        if not isinstance(value, dict) or set(value) != {
            "R_bytes", "s_bytes",
        }:
            raise ValueError(
                "expected a {'R_bytes','s_bytes'} object for Signature")
        return Signature(
            _ref_bytes(value["R_bytes"], 32, "Signature.R_bytes"),
            _ref_bytes(value["s_bytes"], 32, "Signature.s_bytes"),
        )
    if cls in (VerificationKey, VerificationKeyBytes):
        return cls.from_bytes(_ref_bytes(value, 32, cls.__name__))
    if cls is SigningKey:
        return cls.from_bytes(_ref_bytes(value, 64, "SigningKey"))
    raise TypeError(f"not a serializable ed25519 type: {cls!r}")


def to_ref_json(obj) -> str:
    """Reference-compatible JSON text (what serde_json emits from the
    reference's derives)."""
    return json.dumps(to_ref_value(obj), separators=(",", ":"))


def from_ref_json(cls, s: str):
    """Parse `cls` from reference-compatible JSON text."""
    return from_ref_value(cls, json.loads(s))
