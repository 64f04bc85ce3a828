"""Typed errors mirroring the reference `Error` enum (reference src/error.rs:7-20).

The Rust API returns `Result<(), Error>`; the Pythonic equivalent raises these
exceptions.  Messages match the reference `thiserror` display strings."""


class Error(Exception):
    """Base class for all ed25519-consensus errors."""


class MalformedSecretKey(Error):
    def __init__(self):
        super().__init__("Malformed secret key encoding.")


class MalformedPublicKey(Error):
    def __init__(self):
        super().__init__("Malformed public key encoding.")


class InvalidSignature(Error):
    def __init__(self):
        super().__init__("Invalid signature.")


class InvalidSliceLength(Error):
    def __init__(self):
        super().__init__("Invalid length when parsing byte slice.")
