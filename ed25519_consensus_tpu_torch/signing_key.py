"""Ed25519 signing keys: keygen, RFC8032-style deterministic signing
(reference src/signing_key.rs).

A `SigningKey` caches the clamped scalar `s` (held UNREDUCED, 255-bit, like
dalek `Scalar::from_bits` — the 64-byte serialization must round-trip those
exact bytes), the 32-byte hash `prefix`, and the derived `VerificationKey`
(reference src/signing_key.rs:17-21, 118-150)."""

import hashlib
import secrets

from .error import InvalidSliceLength
from .ops import edwards, scalar
from .signature import Signature
from .verification_key import VerificationKey, VerificationKeyBytes


class SigningKey:
    """An Ed25519 signing key (a.k.a. expanded secret key)."""

    __slots__ = ("s", "prefix", "vk")

    def __init__(self, s: int, prefix: bytes, vk: VerificationKey):
        self.s = s
        self.prefix = prefix
        self.vk = vk

    # -- construction ------------------------------------------------------

    @classmethod
    def from_expanded(cls, h: bytes) -> "SigningKey":
        """Build from a 64-byte expanded secret key (reference
        `From<[u8;64]>`, src/signing_key.rs:118-150): clamp the low half into
        the scalar, cache the high half as `prefix`, derive A = [s]B."""
        if len(h) != 64:
            raise InvalidSliceLength()
        sb = bytearray(h[0:32])
        sb[0] &= 248
        sb[31] &= 127
        sb[31] |= 64
        s = scalar.from_bits(bytes(sb))
        prefix = h[32:64]
        A = edwards.basepoint_mul(s)
        vk = VerificationKey(
            VerificationKeyBytes(A.compress()), A.neg()
        )
        return cls(s, prefix, vk)

    @classmethod
    def from_seed(cls, seed: bytes) -> "SigningKey":
        """Build from a 32-byte seed: SHA-512 expand then clamp (reference
        `From<[u8;32]>`, src/signing_key.rs:161-170)."""
        if len(seed) != 32:
            raise InvalidSliceLength()
        return cls.from_expanded(hashlib.sha512(seed).digest())

    @classmethod
    def from_bytes(cls, data) -> "SigningKey":
        """Parse either form by length: 32 = seed, 64 = expanded (reference
        `TryFrom<&[u8]>`, src/signing_key.rs:102-116)."""
        data = bytes(data)
        if len(data) == 32:
            return cls.from_seed(data)
        if len(data) == 64:
            return cls.from_expanded(data)
        raise InvalidSliceLength()

    @classmethod
    def new(cls, rng=None) -> "SigningKey":
        """Generate a fresh key from 32 random bytes (reference
        src/signing_key.rs:180-184).  `rng` may be a `random.Random` for
        deterministic tests; default is the OS CSPRNG."""
        if rng is None:
            seed = secrets.token_bytes(32)
        else:
            seed = rng.getrandbits(256).to_bytes(32, "little")
        return cls.from_seed(seed)

    # -- accessors ---------------------------------------------------------

    def verification_key(self) -> VerificationKey:
        return self.vk

    def verification_key_bytes(self) -> VerificationKeyBytes:
        return self.vk.A_bytes

    def to_bytes(self) -> bytes:
        """64-byte expanded serialization: clamped-scalar bytes ‖ prefix
        (reference serde tuple format, src/signing_key.rs:31-78,152-158)."""
        return scalar.to_bytes(self.s) + self.prefix

    def __bytes__(self):
        return self.to_bytes()

    def __repr__(self):
        # Unlike the reference Debug impl (which prints secrets,
        # src/signing_key.rs:80-88), redact the secret halves.
        return f"SigningKey(vk={self.vk!r}, s=<redacted>, prefix=<redacted>)"

    def zeroize(self) -> None:
        """Best-effort secret scrubbing (reference `Zeroize`,
        src/signing_key.rs:172-176).  Python ints are immutable so this drops
        references rather than overwriting memory."""
        self.s = 0
        self.prefix = b"\x00" * 32

    # -- signing -----------------------------------------------------------

    def sign(self, msg: bytes) -> Signature:
        """Deterministic RFC8032-style signature (reference
        src/signing_key.rs:188-205): r = H(prefix‖msg), R = [r]B,
        k = H(R‖A‖msg), s = r + k·s  (mod ℓ)."""
        r = scalar.from_wide_bytes(hashlib.sha512(self.prefix + msg).digest())
        R_bytes = edwards.basepoint_mul(r).compress()
        h = hashlib.sha512()
        h.update(R_bytes)
        h.update(self.vk.A_bytes.to_bytes())
        h.update(msg)
        k = scalar.from_hash(h)
        s_bytes = scalar.to_bytes(scalar.add(r, scalar.mul(k, self.s)))
        return Signature(R_bytes, s_bytes)
