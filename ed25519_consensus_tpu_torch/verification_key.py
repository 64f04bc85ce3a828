"""Verification key types and ZIP215 single-signature verification.

Mirrors reference src/verification_key.rs: `VerificationKeyBytes` is a
refinement type over an *unvalidated* 32-byte encoding (cheap to store, hash,
sort); `VerificationKey` is the validated form that caches the negated
decompressed point `minus_A` for the double-base verification
(reference src/verification_key.rs:111-114, 251).

This entire path is host-exact (Python ints) by design: ZIP215 accept/reject
verdicts must be consensus-deterministic and never depend on device
behavior."""

import hashlib

from .error import InvalidSignature, InvalidSliceLength, MalformedPublicKey
from .ops import edwards, scalar
from .signature import Signature


class VerificationKeyBytes:
    """Refinement type for a 32-byte verification key encoding; NOT validated
    as a curve point (reference src/verification_key.rs:34-87).  Hashable and
    totally ordered so it can key maps (the batch verifier's coalescing
    groups by this type, reference src/batch.rs:112-118)."""

    __slots__ = ("_bytes", "_hash")

    def __init__(self, data):
        data = bytes(data)
        if len(data) != 32:
            raise InvalidSliceLength()
        self._bytes = data
        self._hash = None

    @classmethod
    def from_bytes(cls, data) -> "VerificationKeyBytes":
        return cls(data)

    def to_bytes(self) -> bytes:
        return self._bytes

    def as_bytes(self) -> bytes:
        return self._bytes

    def __bytes__(self):
        return self._bytes

    def __eq__(self, other):
        if isinstance(other, VerificationKeyBytes):
            return self._bytes == other._bytes
        return NotImplemented

    def __lt__(self, other):
        if not isinstance(other, VerificationKeyBytes):
            return NotImplemented
        return self._bytes < other._bytes

    def __le__(self, other):
        if not isinstance(other, VerificationKeyBytes):
            return NotImplemented
        return self._bytes <= other._bytes

    def __hash__(self):
        # Cached: the coalescing map hashes each key ~2× per queued
        # signature (bytes are immutable, so this can never go stale).
        h = self._hash
        if h is None:
            h = self._hash = hash(self._bytes)
        return h

    def __repr__(self):
        return f"VerificationKeyBytes({self._bytes.hex()!r})"


class VerificationKey:
    """A validated Ed25519 verification key caching `minus_A` (reference
    src/verification_key.rs:89-190).

    ZIP215 criteria for the encoded key `A_bytes`: it MUST decompress to a
    point on the curve, and non-canonical encodings MUST be accepted."""

    __slots__ = ("A_bytes", "minus_A")

    def __init__(self, A_bytes: VerificationKeyBytes,
                 minus_A: "edwards.Point"):
        self.A_bytes = A_bytes
        self.minus_A = minus_A

    @classmethod
    def from_bytes(cls, data) -> "VerificationKey":
        """Validate an encoding: decompress (ZIP215: non-canonical accepted)
        and cache -A (reference src/verification_key.rs:160-175).  Raises
        MalformedPublicKey if the encoding is not a curve point."""
        if isinstance(data, VerificationKeyBytes):
            vkb = data
        else:
            vkb = VerificationKeyBytes(data)
        A = edwards.decompress(vkb.to_bytes())
        if A is None:
            raise MalformedPublicKey()
        return cls(vkb, A.neg())

    @classmethod
    def from_signing_key(cls, sk) -> "VerificationKey":
        """Derive from a signing key (reference `From<&SigningKey>`,
        src/signing_key.rs:23-29)."""
        return sk.verification_key()

    def to_bytes(self) -> bytes:
        return self.A_bytes.to_bytes()

    def as_bytes(self) -> bytes:
        return self.A_bytes.to_bytes()

    def __bytes__(self):
        return self.A_bytes.to_bytes()

    def __eq__(self, other):
        if isinstance(other, VerificationKey):
            return self.A_bytes == other.A_bytes
        return NotImplemented

    # Total ordering forwards to the byte encoding, exactly like the
    # reference's Ord/PartialOrd impls (src/verification_key.rs:116-127).
    def __lt__(self, other):
        if not isinstance(other, VerificationKey):
            return NotImplemented
        return self.A_bytes < other.A_bytes

    def __le__(self, other):
        if not isinstance(other, VerificationKey):
            return NotImplemented
        return self.A_bytes <= other.A_bytes

    def __gt__(self, other):
        if not isinstance(other, VerificationKey):
            return NotImplemented
        return other.A_bytes < self.A_bytes

    def __ge__(self, other):
        if not isinstance(other, VerificationKey):
            return NotImplemented
        return other.A_bytes <= self.A_bytes

    def __hash__(self):
        return hash(self.A_bytes)

    def __repr__(self):
        return f"VerificationKey({self.to_bytes().hex()!r})"

    def verify(self, signature: Signature, msg: bytes) -> None:
        """ZIP215 verification (reference src/verification_key.rs:225-233):
        k = H(R ‖ A ‖ msg) wide-reduced mod ℓ, then the prehashed check.
        Raises InvalidSignature on failure; returns None on success."""
        h = hashlib.sha512()
        h.update(signature.R_bytes)
        h.update(self.A_bytes.to_bytes())
        h.update(msg)
        self.verify_prehashed(signature, scalar.from_hash(h))

    def verify_prehashed(self, signature: Signature, k: int) -> None:
        """The ZIP215 verification equation (reference
        src/verification_key.rs:238-258):

        * s MUST be canonical (< ℓ) — rejection is consensus-critical;
        * R MUST decompress (non-canonical encodings accepted);
        * [8](R - ([s]B - [k]A)) MUST be the identity — the cofactored
          equation; the cofactorless variant MUST NOT be used.
        """
        s = scalar.from_canonical_bytes(signature.s_bytes)
        if s is None:
            raise InvalidSignature()
        R = edwards.decompress(signature.R_bytes)
        if R is None:
            raise InvalidSignature()
        R_prime = edwards.double_scalar_mul_basepoint(k, self.minus_A, s)
        if not (R - R_prime).mul_by_cofactor().is_identity():
            raise InvalidSignature()
