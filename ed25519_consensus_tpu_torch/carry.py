"""Carrying state across from the JAX package.

The system has no weights: its state is the staged batch and, for a
recurring keyset, the resident head operands and multiples tables.  These
functions take that state as plain numpy arrays, bytes and ints — never as
objects of the JAX package, which the port does not import — and build the
port's own, so that the same blinders give byte-identical device operands
and the same resident bytes in both packages."""

import numpy as np

from .batch import StagedBatch
from .ops import msm
from .ops.edwards import Point


def staged_from_reference(coeffs, coeff_shifts, z_blob, raw_points, enc32,
                          hints, keyset_blob=None) -> StagedBatch:
    """A port StagedBatch from a reference staged batch's fields:

    * coeffs: ints mod ℓ ([B coefficient] + per-key A coefficients);
    * coeff_shifts: one ((X, Y, Z, T), enc, hint) per coefficient — the
      [2^128]·point split term as four ints, its 32-byte encoding and its
      device-wire hint;
    * z_blob: bytes, the n blinders as 16-byte little-endian rows;
    * raw_points: (1+m+n, 128) uint8; enc32: (m+n, 32) uint8;
      hints: (m+n,) uint8; keyset_blob: bytes or None."""
    shifts = [(Point(*(int(c) for c in xyzt)), bytes(enc), int(hint))
              for xyzt, enc, hint in coeff_shifts]
    return StagedBatch(
        coeffs=[int(c) for c in coeffs],
        coeff_shifts=shifts,
        z_blob=bytes(z_blob),
        raw_points=np.ascontiguousarray(raw_points, dtype=np.uint8),
        enc32=np.ascontiguousarray(enc32, dtype=np.uint8),
        hints=np.ascontiguousarray(hints, dtype=np.uint8),
        keyset_blob=None if keyset_blob is None else bytes(keyset_blob),
    )


def resident_from_reference(keyset_blob, head_tensor, head_tables_tensor,
                            cache=None):
    """A reference staged batch's resident state — its `keyset_blob`
    (bytes) and its `head_tensor()` / `head_tables_tensor()` arrays, given
    as numpy — installed in the port's device operand cache (`cache`, the
    process default when None) as the head and tables entries of that
    keyset, hash-pinned to the reference's bytes.  Returns (head entry,
    tables entry); either is None when the cache refuses it."""
    from . import devcache

    if cache is None:
        cache = devcache.default_cache()
    digest = devcache.keyset_digest(bytes(keyset_blob))
    head = np.ascontiguousarray(head_tensor, dtype=np.int16)
    tables = np.ascontiguousarray(head_tables_tensor, dtype=np.int16)
    n_keys = head.shape[-1] // 2 - 1
    return (cache.build(digest, n_keys, head),
            cache.build(digest, n_keys, tables, kind=devcache.KIND_TABLES))


def operands_to_device(digits, wire, device=None):
    """A reference (digits, wire) operand pair — numpy arrays in either
    digit wire and either point wire, with or without a leading batch axis
    — as tensors on `device` (None means CUDA), dtypes and layout kept."""
    dev = msm.resolve_device(device)
    return msm.as_tensor(digits, dev), msm.as_tensor(wire, dev)
