"""Legacy (pre-ZIP215) differential verification oracle.

The reference pins the legacy rule set with `ed25519-zebra` v1 as a dev-dep
(reference Cargo.toml:27, tests/util/mod.rs:51-56) — a verifier compatible
with libsodium 1.0.15.  We re-implement that rule set directly, matching the
analytic model the reference encodes in tests/small_order.rs:41-66:

* the all-zero verification key is rejected;
* s must be canonical (< ℓ);
* R (in canonical form) must not be one of the 11 libsodium-blacklisted
  encodings;
* the check RECOMPUTES R: valid iff enc([s]B - [k]A) == R_bytes — which
  both uses the cofactorless equation and rejects non-canonical R encodings.

This oracle exists so conformance tests can prove the ZIP215 and legacy rules
diverge exactly where expected."""

import hashlib

from ..ops import edwards, scalar
from .fixtures import EXCLUDED_POINT_ENCODINGS


def legacy_verify(vk_bytes: bytes, sig_bytes: bytes, msg: bytes) -> bool:
    """Return True iff (vk, sig, msg) verifies under the legacy rules."""
    if len(vk_bytes) != 32 or len(sig_bytes) != 64:
        return False
    if vk_bytes == b"\x00" * 32:
        return False
    R_bytes, s_bytes = sig_bytes[:32], sig_bytes[32:]
    A = edwards.decompress(vk_bytes)
    if A is None:
        return False
    s = scalar.from_canonical_bytes(s_bytes)
    if s is None:
        return False
    R = edwards.decompress(R_bytes)
    if R is None:
        return False
    if R.compress() in EXCLUDED_POINT_ENCODINGS:
        return False
    h = hashlib.sha512()
    h.update(R_bytes)
    h.update(vk_bytes)
    h.update(msg)
    k = scalar.from_hash(h)
    # Cofactorless, R-recomputing check.
    R_check = edwards.basepoint_mul(s).add(A.scalar_mul(k).neg())
    return R_check.compress() == R_bytes
