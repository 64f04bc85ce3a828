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


class DeviceError(RuntimeError):
    """The device that was asked for could not decide the work: a kernel
    that did not build, load or launch, an error the call raised, a call
    past its deadline, a device cooling down after one of those, or no
    placeable CUDA device.  verify_many raises it rather than decide on
    the host what the caller sent to the device; the cause is chained.
    Not an `Error`: it says nothing about the signatures."""


class ConfigError(Error):
    """A malformed ED25519_TPU_* environment knob (config.py registry),
    raised at read time with the knob name, the raw value, and what was
    expected."""

    def __init__(self, name: str, raw: str, expected: str):
        super().__init__(
            f"Invalid value {raw!r} for {name}: expected {expected}."
        )
        self.name = name
        self.raw = raw
        self.expected = expected
