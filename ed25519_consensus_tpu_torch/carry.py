"""Carrying state across from the JAX package.

The system has no weights: its state is the staged batch and, for a
recurring keyset, the resident head operands and multiples tables, the
tenant partitions of those keysets, and the memoized verdicts of the
service's front door.  These functions take that state as plain numpy
arrays, bytes and ints — never as objects of the JAX package, which the
port does not import — and build the port's own, so that the same
blinders give byte-identical device operands, the same resident bytes and
the same memo answers in both packages."""

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
      hints: (m+n,) uint8; keyset_blob: bytes or None.

    A reference batch staged without encodings (enc32 and hints None)
    carries across that way, and its device operands take the affine wire,
    as the reference's do."""
    shifts = [(Point(*(int(c) for c in xyzt)), bytes(enc), int(hint))
              for xyzt, enc, hint in coeff_shifts]

    def u8(a):
        return None if a is None else np.ascontiguousarray(a, np.uint8)

    return StagedBatch(
        coeffs=[int(c) for c in coeffs],
        coeff_shifts=shifts,
        z_blob=bytes(z_blob),
        raw_points=u8(raw_points),
        enc32=u8(enc32),
        hints=u8(hints),
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


def mesh_chunk_from_reference(head_digits, r_digits, rwire, n_devices: int):
    """A reference mesh-layout cached chunk — the (head digits, R digits)
    pair the reference's scheduler builds for a resident keyset on a mesh,
    and its R wire — as the operands of the port's
    `sharded_window_sums_many_cached`, checked: head digits (B, PW,
    D·n_head) with real digits in shard 0's columns only, R digits and
    wire (B, PW, NR) and (B, 33, NR) splitting evenly over D shards.
    Returns the three as contiguous numpy arrays."""
    dh, dr, rw = (np.ascontiguousarray(x) for x in (head_digits, r_digits,
                                                    rwire))
    D = int(n_devices)
    if dh.shape[-1] % D or dr.shape[-1] % D or rw.shape[-1] != dr.shape[-1]:
        raise ValueError(f"the chunk does not split over {D} shards: head "
                         f"{dh.shape}, R digits {dr.shape}, R wire "
                         f"{rw.shape}")
    if dh[..., dh.shape[-1] // D:].any():
        raise ValueError("head digits outside shard 0's columns")
    return dh, dr, rw


def chip_registry_from_reference(states, registry=None):
    """A reference ChipRegistry snapshot — its `chip_states()`, {chip:
    {"state", "suspicion", "probation_passes"}} — applied to the port's
    registry (the process one when None) as it stands: dead chips dead,
    quarantined chips quarantined, probation chips on probation with
    their clean probes so far, every chip with the snapshot's suspicion
    score.  Returns the registry."""
    from . import health

    reg = health.chip_registry() if registry is None else registry
    reg.load_states(states, "carried from the reference")
    return reg


def tenant_map_from_reference(assignments, tenant_epochs, cache=None):
    """A reference devcache's tenant state — `assignments` {keyset digest
    (bytes): tenant} and `tenant_epochs` {tenant: rotation epoch} —
    applied to the port's device operand cache (the process default when
    None): each digest is assigned, and each tenant rotated up to its
    epoch (rotations are counted as in the reference).  Returns the
    cache."""
    from . import devcache

    if cache is None:
        cache = devcache.default_cache()
    for digest, tenant in assignments.items():
        cache.assign_tenant(bytes(digest), str(tenant))
    for tenant, epoch in sorted(tenant_epochs.items()):
        while cache.tenant_epoch_of(tenant) < int(epoch):
            cache.rotate_tenant(tenant, "carried from the reference")
    return cache


def verdict_cache_from_reference(entries, current_pins=None, cache=None):
    """A reference verdict cache's memos absorbed into the port's (the
    process default when `cache` is None).  Each entry is (digest,
    payload, verdict, tenant, pins) or the same with the seal as a sixth
    item, as bytes, bool, str and a 4-tuple of ints (epoch, tenant epoch,
    companion epoch, companion tenant epoch).  With `current_pins`
    {tenant: the reference's live pins}, an entry the reference itself
    would find stale is skipped: carrying must not revive it.  Every
    other entry goes through the port cache's own recovery gate
    (`absorb_entry`: the payload must hash to the digest, the seal —
    given — must derive from the verdict) and is pinned under the port's
    live epochs.  Returns (absorbed, not absorbed — refused by the gate
    or already live —, skipped as stale)."""
    from . import verdictcache

    if cache is None:
        cache = verdictcache.default_cache()
    absorbed = refused = stale = 0
    for entry in entries:
        digest, payload, verdict, tenant, pins = entry[:5]
        seal = bytes(entry[5]) if len(entry) > 5 else None
        if current_pins is not None and tuple(int(x) for x in pins) != \
                tuple(int(x) for x in current_pins.get(tenant, ())):
            stale += 1
            continue
        if cache.absorb_entry(bytes(digest), bytes(payload), bool(verdict),
                              seal=seal, tenant=str(tenant)):
            absorbed += 1
        else:
            refused += 1
    return absorbed, refused, stale
