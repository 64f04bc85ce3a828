"""Ed25519 signature wire codec (reference src/signature.rs:8-63).

A signature is 64 bytes: R_bytes ‖ s_bytes.  Parsing performs NO validation —
curve membership of R and canonicality of s are checked at verification time
(L1/L2 validation-deferral invariant, SURVEY.md §1)."""

from .error import InvalidSliceLength


class Signature:
    """An Ed25519 signature: 32-byte R encoding + 32-byte s encoding."""

    __slots__ = ("R_bytes", "s_bytes")

    def __init__(self, R_bytes: bytes, s_bytes: bytes):
        if len(R_bytes) != 32 or len(s_bytes) != 32:
            raise InvalidSliceLength()
        self.R_bytes = bytes(R_bytes)
        self.s_bytes = bytes(s_bytes)

    @classmethod
    def from_bytes(cls, data) -> "Signature":
        """Parse a 64-byte encoding (reference `From<[u8;64]>` /
        `TryFrom<&[u8]>`, src/signature.rs:22-46).  One copy at most (of
        a non-`bytes` input) and one length check: the halves of a 64-byte
        string are 32 bytes each, so `__init__`'s checks are skipped."""
        if type(data) is not bytes:
            data = bytes(data)
        if len(data) != 64:
            raise InvalidSliceLength()
        sig = object.__new__(cls)
        sig.R_bytes = data[:32]
        sig.s_bytes = data[32:]
        return sig

    def to_bytes(self) -> bytes:
        return self.R_bytes + self.s_bytes

    def __bytes__(self) -> bytes:
        return self.to_bytes()

    def __eq__(self, other):
        if not isinstance(other, Signature):
            return NotImplemented
        return self.R_bytes == other.R_bytes and self.s_bytes == other.s_bytes

    def __hash__(self):
        return hash((self.R_bytes, self.s_bytes))

    def __repr__(self):
        return (
            f"Signature(R_bytes={self.R_bytes.hex()!r}, "
            f"s_bytes={self.s_bytes.hex()!r})"
        )
