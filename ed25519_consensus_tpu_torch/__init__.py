"""ed25519-consensus-tpu-torch: the PyTorch and CUDA port of
`ed25519_consensus_tpu`, for an NVIDIA H100.

Ed25519 signing and ZIP215 consensus verification with exact host
arithmetic for every accept/reject decision, and hand-written CUDA kernels
(csrc/) for the batch-verification MSM's window sums.  The package imports
`torch` and never `jax`, and imports nothing of `ed25519_consensus_tpu`: it
keeps its own copies of the host modules it needs."""

from . import batch
from .error import (
    DeviceError,
    Error,
    InvalidSignature,
    InvalidSliceLength,
    MalformedPublicKey,
    MalformedSecretKey,
)
from .signature import Signature
from .signing_key import SigningKey
from .verification_key import VerificationKey, VerificationKeyBytes

__all__ = [
    "Error",
    "MalformedSecretKey",
    "MalformedPublicKey",
    "InvalidSignature",
    "InvalidSliceLength",
    "DeviceError",
    "Signature",
    "SigningKey",
    "VerificationKey",
    "VerificationKeyBytes",
    "batch",
]
