"""Batch verification with ZIP215 semantics and a host or H100 MSM backend
(reference src/batch.rs), and the throughput scheduler `verify_many`.

The verification equation for n signatures from m distinct keys is the random
linear combination

    [-Σ z_i·s_i]B + Σ [z_i]R_i + Σ [z_i·k_i]A_i = 0       (then ·[8])

with 128-bit random blinders z_i.  Entries are grouped by verification key so
all z_i·k_i terms per key coalesce into one A-coefficient: the MSM has
n + m + 1 terms instead of 2n + 1 (reference src/batch.rs:149-203).

Backend split: ALL rejection decisions — point decompression, `s < ℓ`, and
the final cofactor/identity check — happen on the host with exact integer
math, so a malformed batch never reaches the device and the verdict can
never depend on device behavior.  Only the bulk MSM's window sums are
dispatched, to the host MSM (`backend="host"`) or the CUDA kernels
(`backend="device"`, ops/msm.py).  Host staging and the host MSM run in
the native C++ runtime (native.py) when it builds and passes its
self-check, and in exact Python otherwise (or with
ED25519_TPU_DISABLE_NATIVE=1); both give byte-identical staging."""

import array as _array
import atexit
import collections
import hashlib
import queue
import secrets
import threading

import numpy as np

from . import config as _config
from . import devcache as _devcache
from . import faults as _faults
from . import health as _health
from . import native
from . import routing as _routing
from .error import DeviceError, InvalidSignature
from .health import DeviceHealth
from .ops import edwards, limbs, scalar
from .ops.field import P
from .ops.scalar import L
from .signature import Signature
from .utils import metrics as _metrics
from .verification_key import VerificationKeyBytes


def _as_item(value) -> "Item":
    if isinstance(value, Item):
        return value
    if isinstance(value, tuple) and len(value) == 3:
        return Item.new(*value)
    raise TypeError("expected Item or (vk_bytes, sig, msg) tuple")


def _challenge(R_bytes: bytes, A_bytes: bytes, msg: bytes) -> int:
    h = hashlib.sha512()
    h.update(R_bytes)
    h.update(A_bytes)
    h.update(msg)
    return scalar.from_hash(h)


class Item:
    """A queued batch entry, decoupled from the message lifetime: the
    challenge k = H(R‖A‖msg) is computed eagerly at queue time (reference
    src/batch.rs:70-94)."""

    __slots__ = ("vk_bytes", "sig", "k")

    def __init__(self, vk_bytes: VerificationKeyBytes, sig: Signature, k: int):
        self.vk_bytes = vk_bytes
        self.sig = sig
        self.k = k

    @classmethod
    def new(cls, vk_bytes, sig: Signature, msg: bytes) -> "Item":
        if not isinstance(vk_bytes, VerificationKeyBytes):
            vk_bytes = VerificationKeyBytes(vk_bytes)
        return cls(vk_bytes, sig,
                   _challenge(sig.R_bytes, vk_bytes.to_bytes(), msg))

    def __repr__(self):
        return (
            f"Item(vk_bytes={self.vk_bytes!r}, sig={self.sig!r}, "
            f"k={self.k:#x})"
        )


def _point_row(pt) -> bytes:
    """Canonical 128-byte X‖Y‖Z‖T row of a host point."""
    return b"".join((c % P).to_bytes(32, "little")
                    for c in (pt.X, pt.Y, pt.Z, pt.T))


def _point_from_row(row) -> "edwards.Point":
    b = bytes(row)
    return edwards.Point(*(int.from_bytes(b[32 * i: 32 * i + 32], "little")
                           for i in range(4)))


def decompress_buffer(blob: bytes, n: int):
    """ZIP215 decompression of n concatenated 32-byte encodings in exact
    Python: (raw, ok, hints) with raw (n, 128) uint8 canonical X‖Y‖Z‖T
    rows, ok (n,) uint8, hints (n,) uint8 the device-wire flip/neg bits
    (ops/torch_decompress.py)."""
    raw = np.zeros((n, 128), dtype=np.uint8)
    ok = np.zeros((n,), dtype=np.uint8)
    hints = np.zeros((n,), dtype=np.uint8)
    for i in range(n):
        res = edwards.decompress_with_hint(blob[32 * i: 32 * (i + 1)])
        if res is None:
            continue
        pt, hints[i] = res
        ok[i] = 1
        raw[i] = np.frombuffer(_point_row(pt), dtype=np.uint8)
    return raw, ok, hints


def _decompress(blob: bytes, n: int):
    """Native decompression when the runtime is loaded, exact Python
    otherwise; the two are byte-identical."""
    res = native.decompress_batch_buffer(blob, n)
    return res if res is not None else decompress_buffer(blob, n)


def _evict_one(cache: dict) -> None:
    """Drop one (oldest-inserted) entry, tolerating races: entries of every
    cache below are deterministic functions of their key, so which entry
    goes can never affect a verdict — only a recompute."""
    try:
        cache.pop(next(iter(cache)), None)
    except (StopIteration, RuntimeError):
        pass


# [2^128]A per verification key, for the device MSM's uniform-128-bit
# scalar split (ops/msm.py), as (affine point, encoding, hint).  Keyed by
# the 32-byte encoding; values are deterministic, so never stale.
_shift128_cache = {}
_SHIFT_CACHE_MAX = 1 << 16


def _shift128_for_key(vk_bytes: bytes, A_row) -> "tuple":
    sp = _shift128_cache.get(vk_bytes)
    if sp is None:
        row = native.msm_shift128_row(bytes(A_row))
        if row is not None:
            pt = _point_from_row(row).to_affine()
        else:
            pt = edwards.shift128(_point_from_row(A_row)).to_affine()
        enc, hint = edwards.compress_with_hint(pt)
        sp = (pt, enc, hint)
        if len(_shift128_cache) >= _SHIFT_CACHE_MAX:
            _evict_one(_shift128_cache)
        _shift128_cache[vk_bytes] = sp
    return sp


_B_SHIFT_TRIPLE = None
_B_WIRE = None
_B_RAW_ROW = np.frombuffer(_point_row(edwards.BASEPOINT),
                           dtype=np.uint8).reshape(1, 128)


def _basepoint_shift_triple() -> "tuple":
    """(point, enc, hint) for the cached [2^128]B."""
    global _B_SHIFT_TRIPLE
    if _B_SHIFT_TRIPLE is None:
        pt = edwards.basepoint_shift128().to_affine()
        enc, hint = edwards.compress_with_hint(pt)
        _B_SHIFT_TRIPLE = (pt, enc, hint)
    return _B_SHIFT_TRIPLE


def _basepoint_wire() -> "tuple":
    """(enc, hint) for the basepoint itself (coefficient term 0)."""
    global _B_WIRE
    if _B_WIRE is None:
        _B_WIRE = edwards.compress_with_hint(edwards.BASEPOINT.to_affine())
    return _B_WIRE


def _device_wire_mode() -> str:
    """The device point wire (ED25519_TPU_WIRE): `compressed` (default)
    ships 33 B/term — the 32-byte y encoding and the flip/neg hint — and K1
    recomputes x on the device; `affine` ships 80 B/term of X‖Y limbs and
    K6 rebuilds Z and T.  No production caller needs `affine`: it is kept
    for A/B parity with the JAX package, and it is the wire of a staged
    batch that carries no encodings (carry.staged_from_reference)."""
    return _config.get("ED25519_TPU_WIRE")


def _digits_for_wire(digits: np.ndarray) -> np.ndarray:
    """ED25519_TPU_DIGIT_WIRE: `packed` (default) nibble-packs the digit
    planes to 17 B/term; `plain` ships one digit per byte."""
    if _config.get("ED25519_TPU_DIGIT_WIRE") == "packed":
        return limbs.pack_digit_planes(digits)
    return digits


# -- fused host path caches ------------------------------------------------
# Deterministic per-key (and per-keyset) operands of the one-call native
# host verify: decompressed key rows, [2^128]A rows and prebuilt tables.
# A key's split entry is built at its SECOND sight, so one-shot keys never
# pay for it; recurring validator sets reach the fast path at batch 3.

_key_row_cache = {}
_KEY_ROW_CACHE_MAX = 1 << 16
_host_split_cache = {}
_HOST_SPLIT_CACHE_MAX = 4096
_seen_keys = set()
_SEEN_KEYS_MAX = 1 << 17
_B_SPLIT = None
_keyset_blob_cache = {}
_KEYSET_BLOB_CACHE_MAX = 64


def _key_rows_for(keys) -> "bytes | None":
    """Concatenated raw 128-byte rows for `keys` (32-byte encodings), via
    the cache; misses are decompressed in one native call.  None if any
    key fails ZIP215 decompression (the batch rejects)."""
    rows = [_key_row_cache.get(k) for k in keys]
    missing = [i for i, r in enumerate(rows) if r is None]
    if missing:
        raw, ok, _ = _decompress(
            b"".join(keys[i] for i in missing), len(missing))
        if not ok.all():
            return None
        for j, i in enumerate(missing):
            row = raw[j].tobytes()
            if len(_key_row_cache) >= _KEY_ROW_CACHE_MAX:
                _evict_one(_key_row_cache)
            _key_row_cache[keys[i]] = row
            rows[i] = row
    return b"".join(rows)


def _basepoint_split_entry():
    """(shift_row, tables) for the basepoint coefficient pair; None
    without the native library."""
    global _B_SPLIT
    if _B_SPLIT is None:
        b_row = bytes(_B_RAW_ROW)
        sh = native.msm_shift128_row(b_row)
        if sh is None:
            return None
        _B_SPLIT = (sh, native.msm_build_table(b_row)
                    + native.msm_build_table(sh))
    return _B_SPLIT


def _split_operands_for(keys) -> "tuple | None":
    """(shift_rows, prebuilt) blobs for the fused call's split fast path —
    only when every key has a cached entry (all or nothing)."""
    if len(keys) > _HOST_SPLIT_CACHE_MAX:
        return None  # more recurring keys than the cache holds: thrash
    entries = []
    for kb in keys:
        e = _host_split_cache.get(kb)
        if e is None:
            if kb not in _seen_keys:
                if len(_seen_keys) >= _SEEN_KEYS_MAX:
                    _seen_keys.clear()
                _seen_keys.add(kb)
            else:
                row = _key_row_cache.get(kb)
                sh = None if row is None else native.msm_shift128_row(row)
                if sh is not None:
                    e = (sh, native.msm_build_table(row)
                         + native.msm_build_table(sh))
                    if len(_host_split_cache) >= _HOST_SPLIT_CACHE_MAX:
                        _evict_one(_host_split_cache)
                    _host_split_cache[kb] = e
        entries.append(e)
    bsp = _basepoint_split_entry()
    if bsp is None or any(e is None for e in entries):
        return None
    return (b"".join([bsp[0]] + [e[0] for e in entries]),
            b"".join([bsp[1]] + [e[1] for e in entries]))


def _keyset_operands_for(keys_t: tuple):
    """(key_rows, split) for an ordered keyset of 32-byte encodings via
    the blob cache; None when a key fails decompression."""
    cached = _keyset_blob_cache.get(keys_t)
    if cached is not None:
        return cached
    key_rows = _key_rows_for(list(keys_t))
    if key_rows is None:
        return None
    split = _split_operands_for(list(keys_t))
    if split is not None:
        if len(_keyset_blob_cache) >= _KEYSET_BLOB_CACHE_MAX:
            _evict_one(_keyset_blob_cache)
        _keyset_blob_cache[keys_t] = (key_rows, split)
    return key_rows, split


class StagedBatch:
    """A staged (host-validated) batch in flat buffer form.

    * coeffs: [B_coeff] + per-key A_coeffs, ints mod ℓ (may exceed 2^128 —
      the device path splits them against `coeff_shifts`).
    * coeff_shifts: matching (point, enc, hint) triples for the
      [2^128]·point split terms (basepoint constant + per-key cache).  An
      entry given as None (a key staging did not find in
      `_shift128_cache`) is computed, and cached, when `coeff_shifts` is
      first read; `device_operands(defer=True)` never reads it, and leaves
      that key's [2^128]A to the card (K7).
    * z_blob: the n per-signature 128-bit blinders as 16-byte
      little-endian rows (bytes, n×16).
    * raw_points: ((1+m+n), 128) uint8 — canonical X‖Y‖Z‖T rows for
      [B, A_0..A_{m-1}, R_0..R_{n-1}].
    * enc32 / hints: the (m+n, 32) uint8 original compressed encodings
      for [A..., R...] and their (m+n,) device flip/neg hint bytes — the
      33 B/term compressed device wire.
    * keyset_blob: the 32-byte key encodings in group-id order, the
      content address of the device operand cache.
    * shift128_hits: how many of the keys' [2^128]A triples staging found
      in `_shift128_cache` (one lookup per key)."""

    __slots__ = ("coeffs", "_coeff_shifts", "_deferred", "z_blob",
                 "raw_points", "enc32", "hints", "keyset_blob",
                 "shift128_hits")

    def __init__(self, coeffs, coeff_shifts, z_blob, raw_points,
                 enc32, hints, keyset_blob=None, shift128_hits=0):
        self.coeffs = coeffs
        self._coeff_shifts = list(coeff_shifts)
        # The coefficients whose triple staging left out, as staged: the
        # deferred wire flags these whether or not a read filled them in.
        self._deferred = np.array(
            [j for j, sp in enumerate(self._coeff_shifts) if sp is None],
            dtype=np.int64)
        self.z_blob = z_blob
        self.raw_points = raw_points
        self.enc32 = enc32
        self.hints = hints
        self.keyset_blob = keyset_blob
        self.shift128_hits = shift128_hits

    @property
    def coeff_shifts(self) -> list:
        sh = self._coeff_shifts
        for j in self._deferred.tolist():
            if sh[j] is None:  # coefficient j is key j − 1's
                sh[j] = _shift128_for_key(
                    self.keyset_blob[32 * (j - 1): 32 * j],
                    self.raw_points[j])
        return sh

    @property
    def n_sigs(self) -> int:
        return len(self.z_blob) // 16

    @property
    def n_terms(self) -> int:
        return len(self.coeffs) + self.n_sigs

    @property
    def n_device_terms(self) -> int:
        """n_terms plus one split-high term for every coefficient
        exceeding 128 bits (what device_operands emits)."""
        return self.n_terms + sum(1 for c in self.coeffs if c >> 128)

    @property
    def n_cached_terms(self) -> int:
        """Device term count under the cache-aware ALWAYS-SPLIT layout
        (device_operands_cached): every coefficient contributes a
        split-high term, so the head width is a pure function of the
        keyset and the resident head tensor stays byte-identical batch
        after batch."""
        return 2 * len(self.coeffs) + self.n_sigs

    def head_tensor(self) -> np.ndarray:
        """The keyset HEAD operand tensor, (4, NLIMBS, 2·n_coeff) int16
        extended limbs for [B, A_1..A_m, [2^128]B, [2^128]A_1..A_m] — what
        the device operand cache pins (hash over these bytes) and keeps
        resident.  A pure function of the keyset."""
        n_coeff = len(self.coeffs)
        coeff_pts = limbs.pack_points_from_raw(self.raw_points[:n_coeff])
        shift_pts = limbs.pack_point_batch(
            [sp[0] for sp in self.coeff_shifts]).astype(np.int16)
        return np.ascontiguousarray(
            np.concatenate([coeff_pts, shift_pts], axis=-1))

    def head_tables_tensor(self) -> np.ndarray:
        """The keyset head MULTIPLES-TABLES tensor, (9, 4, NLIMBS,
        2·n_coeff) int16: for every head column P of `head_tensor`, the
        exact [0..8]P table, built in exact host arithmetic and packed as
        canonical limbs (13-bit, so int16 holds them) — what the
        kind="tables" cache entry pins and keeps resident."""
        head = self.head_tensor()
        pts = [limbs.unpack_point(head[..., j])
               for j in range(head.shape[-1])]
        rows = [[edwards.Point(0, 1, 1, 0)] * len(pts), pts]
        for _ in range(7):
            rows.append([a.add(b) for a, b in zip(rows[-1], pts)])
        return np.ascontiguousarray(np.stack(
            [limbs.pack_point_batch(r).astype(np.int16) for r in rows]))

    def device_operands_cached(self, pad_fn):
        """Cache-aware operands for a RESIDENT keyset: the digit planes
        for ALL lanes (the always-split head layout) plus the per-
        signature compressed R wire; the head point bytes come from the
        resident entry.  Lanes [0, n_coeff) carry the low-128-bit
        coefficient digits, [n_coeff, 2·n_coeff) the high digits against
        the split points (zero digits for coefficients under 2^128 —
        [0]P is the identity under the complete law), then the blinder
        digits on the R lanes.  `pad_fn` maps n_cached_terms to the padded
        TOTAL lane count; returns (digits, rwire) with rwire (33,
        N − 2·n_coeff)."""
        mask = (1 << 128) - 1
        n_coeff = len(self.coeffs)
        n_head = 2 * n_coeff
        n = n_head + self.n_sigs
        N = pad_fn(n)
        digits = np.zeros((limbs.NWINDOWS, N), dtype=np.int8)
        digits[:, :n_coeff] = limbs.pack_scalar_windows(
            [c & mask for c in self.coeffs])
        digits[:, n_coeff:n_head] = limbs.pack_scalar_windows(
            [c >> 128 for c in self.coeffs])
        if self.n_sigs:
            zb = np.frombuffer(self.z_blob, dtype=np.uint8).reshape(
                self.n_sigs, 16)
            digits[:, n_head:n] = limbs.pack_u128_windows(zb)
        m = n_coeff - 1  # distinct keys among the coefficient terms
        w = limbs.identity_wire_batch(N - n_head)
        w[:32, : self.n_sigs] = self.enc32[m:].T
        w[32, : self.n_sigs] = self.hints[m:]
        return _digits_for_wire(digits), w

    def host_msm(self):
        """The host-backend MSM over the staged terms: the native C++
        Straus when the runtime is loaded, exact Python otherwise."""
        n = self.n_sigs
        zs = np.zeros((n, 32), dtype=np.uint8)
        zs[:, :16] = np.frombuffer(self.z_blob, dtype=np.uint8).reshape(
            n, 16)
        sblob = b"".join(int(c).to_bytes(32, "little")
                         for c in self.coeffs) + zs.tobytes()
        out = native.vartime_msm_scblob(sblob, self.raw_points)
        if out is not None:
            return out
        zints = [int.from_bytes(self.z_blob[16 * i: 16 * i + 16], "little")
                 for i in range(n)]
        return edwards.multiscalar_mul(
            list(self.coeffs) + zints,
            [_point_from_row(r) for r in self.raw_points])

    def device_operands(self, pad_fn, wire: "str | None" = None, *,
                        defer: bool = False):
        """The padded device operands: signed digit planes — (17, N) uint8
        nibble-packed, or (33, N) int8 with ED25519_TPU_DIGIT_WIRE=plain —
        and the point wire (`wire`, default ED25519_TPU_WIRE):

        * `compressed`: (33, N) uint8 of 32-byte y encodings + flip/neg
          hint bytes; x is recomputed on the device (K1), 33 B/term;
        * `affine`: (2, NLIMBS, N) int16 X‖Y limbs; Z = 1 and T = X·Y
          are rebuilt on the device (K6), 80 B/term — also the wire of a
          batch whose staging captured no encodings.

        Coefficients split into 128-bit chunks against their shift points.
        By default every shift point is the host's (the JAX package's
        operands, byte for byte).  With `defer` (the cold paths' form), on
        the compressed wire, every [2^128]A that staging did not find
        cached is left to the card: that key's split-high lane carries the
        key's own encoding and its hint with bit 2 set
        (torch_decompress.SHIFT128_FLAG), which K7 turns into [2^128]A
        right after K1 expands it; on the affine wire, which has no flag,
        `defer` changes nothing.  Term order: [coeffs..., split-highs...,
        R's...]; padding terms are digit 0 on the wire's identity."""
        if wire is None:
            wire = _device_wire_mode()
        if self.enc32 is None or self.hints is None:
            wire = "affine"  # staging captured no encodings
        defer = defer and wire != "affine"  # the affine wire has no flag
        mask = (1 << 128) - 1
        hi_j = [j for j, c in enumerate(self.coeffs) if c >> 128]
        n_coeff = len(self.coeffs)
        n_head = n_coeff + len(hi_j)
        n = n_head + self.n_sigs
        N = pad_fn(n)
        digits = np.zeros((limbs.NWINDOWS, N), dtype=np.int8)
        digits[:, :n_coeff] = limbs.pack_scalar_windows(
            [c & mask for c in self.coeffs])
        if hi_j:
            digits[:, n_coeff:n_head] = limbs.pack_scalar_windows(
                [self.coeffs[j] >> 128 for j in hi_j])
        if self.n_sigs:
            zb = np.frombuffer(self.z_blob, dtype=np.uint8).reshape(
                self.n_sigs, 16)
            digits[:, n_head:n] = limbs.pack_u128_windows(zb)
        digits = _digits_for_wire(digits)
        if wire == "affine":
            shifts = self.coeff_shifts
            pts = limbs.identity_affine_batch(N)
            pts[..., :n_coeff] = limbs.pack_points_affine_from_raw(
                self.raw_points[:n_coeff])
            if hi_j:
                pts[..., n_coeff:n_head] = limbs.pack_point_affine_batch(
                    [shifts[j][0] for j in hi_j]).astype(np.int16)
            pts[..., n_head:n] = limbs.pack_points_affine_from_raw(
                self.raw_points[n_coeff:])
            return digits, pts
        m = n_coeff - 1  # distinct keys among the coefficient terms
        w = limbs.identity_wire_batch(N)
        b_enc, b_hint = _basepoint_wire()
        w[:32, 0] = np.frombuffer(b_enc, dtype=np.uint8)
        w[32, 0] = b_hint
        if m:
            w[:32, 1:m + 1] = self.enc32[:m].T
            w[32, 1:m + 1] = self.hints[:m]
        hi_j = np.asarray(hi_j, dtype=np.int64)
        lanes = n_coeff + np.arange(len(hi_j))
        deferred = defer & np.isin(hi_j, self._deferred)
        if deferred.any():
            from .ops.torch_decompress import SHIFT128_FLAG

            keys = hi_j[deferred] - 1
            w[:32, lanes[deferred]] = self.enc32[keys].T
            w[32, lanes[deferred]] = self.hints[keys] | SHIFT128_FLAG
        # A deferred key's triple may be None: read the others without
        # filling it in.
        shifts = self._coeff_shifts if defer else self.coeff_shifts
        held = [shifts[j] for j in hi_j[~deferred].tolist()]
        if held:
            w[:32, lanes[~deferred]] = np.frombuffer(
                b"".join(sp[1] for sp in held), dtype=np.uint8).reshape(
                    len(held), 32).T
            w[32, lanes[~deferred]] = [sp[2] for sp in held]
        w[:32, n_head:n] = self.enc32[m:].T
        w[32, n_head:n] = self.hints[m:]
        return digits, w


def _draw_blinders(rng, n: int) -> bytes:
    if rng is None:
        return secrets.token_bytes(16 * n)
    return rng.getrandbits(128 * n).to_bytes(16 * n, "little") if n else b""


class Verifier:
    """A batch verification context (reference src/batch.rs:110-218).

    `signatures` is the public coalescing map, vk_bytes -> [(k, sig), ...]
    in first-seen key order, `k` the challenge's 32-byte little-endian
    encoding.  The queue is kept as columns, its only record: flat
    queue-order buffers of R, s and the challenge, an int32 group id per
    signature, and the key index (raw 32-byte key -> group id, in
    first-seen order).  Staging consumes them without regrouping, and no
    per-signature object outlives queueing.  The map is LAZY: it is
    rebuilt from the columns' last `_unbuilt` entries when something asks
    for it.  Handing the map out (reading or assigning `signatures`)
    makes it authoritative: an outside reference could change it without
    changing its size, so staging then takes the grouped walk over the
    map."""

    def __init__(self):
        self._sig_map = {}
        self._unbuilt = 0
        self._map_exposed = False
        self.batch_size = 0
        self._s_buf = bytearray()
        self._r_buf = bytearray()
        self._k_buf = bytearray()
        self._gid = _array.array("i")
        self._key_index = {}
        self._invalid = None
        # Signatures queued by `queue_bulk`'s one-native-call path.
        self._columnar_sigs = 0

    @property
    def signatures(self):
        m = self._materialized()
        self._map_exposed = True
        return m

    @signatures.setter
    def signatures(self, value):
        self._sig_map = value
        self._unbuilt = 0
        self._map_exposed = True

    def _materialized(self):
        """The coalescing map with the unbuilt entries folded in, WITHOUT
        marking it exposed (in-package readers that neither mutate nor
        leak it)."""
        if self._unbuilt:
            self._materialize()
        return self._sig_map

    def _materialize(self) -> None:
        """Fold the columns' last `_unbuilt` entries into the map: one
        `VerificationKeyBytes` a distinct key, in first-seen order."""
        start = len(self._gid) - self._unbuilt
        self._unbuilt = 0
        keys = list(self._key_index)
        vkbs = {}
        sd = self._sig_map.setdefault
        r, s, k = (bytes(b[32 * start:])
                   for b in (self._r_buf, self._s_buf, self._k_buf))
        for i, g in enumerate(self._gid[start:]):
            vkb = vkbs.get(g)
            if vkb is None:
                vkb = vkbs[g] = VerificationKeyBytes(keys[g])
            o = 32 * i
            sd(vkb, []).append((k[o: o + 32],
                                Signature(r[o: o + 32], s[o: o + 32])))

    def invalidate(self, reason: str = "invalidated") -> None:
        """Mark the WHOLE batch invalid out of band: every later
        verification raises InvalidSignature, so its verdict under
        verify_many is False.  Also bumps the device operand cache epoch:
        whatever made the caller distrust queued data must not leave stale
        keyset operands resident."""
        self._invalid = str(reason)
        _devcache.default_cache().bump_epoch("verifier-invalidate")

    @property
    def invalid_reason(self) -> "str | None":
        return self._invalid

    def _canonical_keyset_blob(self) -> bytes:
        """The keyset blob (32-byte key encodings in group-id order)
        WITHOUT staging or exposing the map: the devcache content
        address."""
        if self._buffers_live():
            return b"".join(self._key_index)
        return b"".join(k.to_bytes() for k in self._materialized())

    def content_payload(self) -> "bytes | None":
        """The canonical content PAYLOAD of the queued batch, the exact
        bytes `content_digest()` hashes: a domain prefix, the batch size,
        the keyset blob, the per-signature group ids and the s/R/k
        queue-order buffers.  The verdict cache (verdictcache.py) stores
        it beside a memoized verdict and re-hashes it on every hit.  None
        under the `content_digest()` conditions."""
        if not self._buffers_live() or self._invalid is not None:
            return None
        return b"".join((
            b"ed25519-tpu-batch-content-v1",
            self.batch_size.to_bytes(8, "little"),
            self._canonical_keyset_blob(),
            self._gid.tobytes(),
            bytes(self._s_buf),
            bytes(self._r_buf),
            bytes(self._k_buf),
        ))

    def content_digest(self) -> "bytes | None":
        """SHA-256 over the queued batch's canonical content (batch size,
        keyset blob, group ids, the s/R/k buffers): two verifiers share a
        digest iff they received byte-identical queue streams.  None when
        the digest cannot vouch for the contents (map exposed, or
        `invalidate()`d).  Streams the parts of `content_payload()`
        through the hash, so it is bitwise sha256(content_payload())
        without the concatenated copy (it runs on every service
        submit)."""
        if not self._buffers_live() or self._invalid is not None:
            return None
        h = hashlib.sha256(b"ed25519-tpu-batch-content-v1")
        h.update(self.batch_size.to_bytes(8, "little"))
        h.update(self._canonical_keyset_blob())
        h.update(self._gid.tobytes())
        h.update(bytes(self._s_buf))
        h.update(bytes(self._r_buf))
        h.update(bytes(self._k_buf))
        return h.digest()

    @property
    def distinct_key_count(self) -> int:
        """Distinct verification keys queued, without exposing the map."""
        return (len(self._key_index) if self._buffers_live()
                else len(self._materialized()))

    def clone(self) -> "Verifier":
        """An independent Verifier holding the same queued batch (keeps
        the fast staging path; an exposed source taints its clones)."""
        nv = Verifier()
        nv._sig_map = {k: list(v) for k, v in self._sig_map.items()}
        nv._unbuilt = self._unbuilt
        nv._map_exposed = self._map_exposed
        nv.batch_size = self.batch_size
        nv._s_buf = bytearray(self._s_buf)
        nv._r_buf = bytearray(self._r_buf)
        nv._k_buf = bytearray(self._k_buf)
        nv._gid = self._gid[:]
        nv._key_index = dict(self._key_index)
        nv._invalid = self._invalid
        nv._columnar_sigs = self._columnar_sigs
        return nv

    def queue(self, item) -> None:
        """Queue an `Item` or `(vk_bytes, sig, msg)` tuple (reference
        src/batch.rs:127-137)."""
        item = _as_item(item)
        ki = self._key_index
        self._gid.append(ki.setdefault(item.vk_bytes.to_bytes(), len(ki)))
        self._s_buf += item.sig.s_bytes
        self._r_buf += item.sig.R_bytes
        self._k_buf += item.k.to_bytes(32, "little")
        self.batch_size += 1
        self._unbuilt += 1

    @_metrics.spanned("queue_bulk")
    def queue_bulk(self, entries) -> None:
        """Queue many `(vk_bytes, sig, msg)` entries with ONE native call
        for all the challenge hashes, straight into the columns: nothing
        of an entry is kept but its bytes.  The same result as `queue` in
        a loop, which is what runs without the native runtime."""
        entries = entries if isinstance(entries, list) else list(entries)
        if not entries:
            return
        vkbs, sigs, msgs = zip(*entries, strict=True)
        keys = [k if type(k) is bytes and len(k) == 32
                else VerificationKeyBytes(k).to_bytes() for k in vkbs]
        rs = [sig.R_bytes for sig in sigs]
        ra = [None] * (2 * len(rs))
        ra[0::2] = rs
        ra[1::2] = keys
        kblob = native.bulk_challenges(b"".join(ra), msgs, raw=True)
        if kblob is NotImplemented:
            for entry in zip(keys, sigs, msgs):
                self.queue(entry)
            return
        ki = self._key_index
        new = [k for k in dict.fromkeys(keys) if k not in ki]
        ki.update(zip(new, range(len(ki), len(ki) + len(new))))
        self._gid.fromlist(list(map(ki.__getitem__, keys)))
        self._r_buf += b"".join(rs)
        self._s_buf += b"".join([sig.s_bytes for sig in sigs])
        self._k_buf += kblob
        self.batch_size += len(keys)
        self._unbuilt += len(keys)
        self._columnar_sigs += len(keys)

    # -- staging (host, exact) --------------------------------------------

    def _buffers_live(self) -> bool:
        """True when the queue-order columns are authoritative: the map
        was never handed out and every column holds the queued count (the
        map is only ever built from them otherwise)."""
        n = self.batch_size
        return (not self._map_exposed and len(self._gid) == n
                and len(self._s_buf) == len(self._r_buf)
                == len(self._k_buf) == 32 * n)

    def _stage(self, rng) -> "StagedBatch":
        """Host staging: decompress all points, enforce `s < ℓ`, sample
        blinders, coalesce per-key A coefficients.  Raises InvalidSignature
        on ANY malformed input — before any device dispatch (all-or-nothing
        semantics, reference src/batch.rs:139-147, 182-203).  The
        queue-order path and the grouped walk give the same MSM (it is
        order-independent)."""
        if self._invalid is not None:
            raise InvalidSignature()
        if self._buffers_live():
            key_bytes = list(self._key_index)
            r_blob = bytes(self._r_buf)
            s_buf, k_buf, gid = self._s_buf, self._k_buf, self._gid
        else:
            groups = list(self._materialized().items())
            key_bytes = [vkb.to_bytes() for vkb, _ in groups]
            r_blob = b"".join(sig.R_bytes for _, sigs in groups
                              for _, sig in sigs)
            s_buf = b"".join(sig.s_bytes for _, sigs in groups
                             for _, sig in sigs)
            k_buf = b"".join(
                k.to_bytes(32, "little") if type(k) is int else bytes(k)
                for _, sigs in groups for k, _ in sigs)
            gid = _array.array("i", (g for g, (_, sigs) in enumerate(groups)
                                     for _ in sigs))
        n = len(gid)
        m = len(key_bytes)
        keyset_blob = b"".join(key_bytes)
        blob = keyset_blob + r_blob
        raw, ok, hints = _decompress(blob, m + n)
        if not ok.all():
            raise InvalidSignature()
        enc32 = np.frombuffer(blob, dtype=np.uint8).reshape(m + n, 32)
        z_blob = _draw_blinders(rng, n)
        res = native.stage_scalars_gid(s_buf, k_buf, z_blob, n, gid, m)
        if res is None:
            raise InvalidSignature()  # some s ≥ ℓ (ZIP215 rule 2)
        if res is NotImplemented:
            B_acc = 0
            A_accs = [0] * m
            s_mv, k_mv = memoryview(s_buf), memoryview(k_buf)
            for i in range(n):
                s = int.from_bytes(s_mv[32 * i: 32 * i + 32], "little")
                if s >= L:
                    raise InvalidSignature()
                k = int.from_bytes(k_mv[32 * i: 32 * i + 32], "little")
                z = int.from_bytes(z_blob[16 * i: 16 * i + 16], "little")
                B_acc += z * s
                A_accs[gid[i]] += z * k
        else:
            B_acc, A_accs = res
        # One lookup a key: a miss stays None, computed only if something
        # reads `coeff_shifts`; the cold dispatches leave it to the card.
        with _metrics.span("stage.shift128"):
            A_shifts = [_shift128_cache.get(kb) for kb in key_bytes]
        return StagedBatch(
            coeffs=[(-B_acc) % L] + [a % L for a in A_accs],
            coeff_shifts=[_basepoint_shift_triple()] + A_shifts,
            z_blob=z_blob,
            raw_points=np.concatenate([_B_RAW_ROW, raw], axis=0),
            enc32=enc32,
            hints=hints,
            keyset_blob=keyset_blob,
            shift128_hits=m - A_shifts.count(None),
        )

    # -- verification ------------------------------------------------------

    def verify(self, rng=None, backend: str = "device", device=None,
               timings=None) -> None:
        """Verify all queued signatures; raises InvalidSignature unless ALL
        are valid (reference src/batch.rs:149-217).

        `backend` selects where the bulk MSM runs: "device" (the default) —
        the window-sum kernels on `device` (None means CUDA, and raises
        without one; "cpu" runs their plain PyTorch versions); "sharded" —
        the same kernels sharded over every visible card
        (parallel/sharded_msm.py), or, with `device` named, over
        `routing.available_devices()` shards all on that device; "host" —
        the host MSM, only when asked for: one fused native call
        (decompression, staging, MSM, cofactor check) when the runtime is
        loaded and the queue-order buffers are live.  All are
        verdict-equivalent by construction.

        `timings`, if a dict, receives wall seconds per stage:
        "stage_host", then "device" and "combine" for the device backend,
        "sharded" (the mesh call and the combine) for the sharded one,
        "msm_host" (or "host_fused") for the host backend."""
        if backend not in ("host", "device", "sharded"):
            raise ValueError(f"unknown backend {backend!r}")
        stage_seconds = {}
        try:
            self._verify(rng, backend, device, stage_seconds)
        finally:
            if timings is not None:
                timings.update(stage_seconds)

    def _verify(self, rng, backend, device, stage_seconds) -> None:
        if backend == "device":
            from .ops import msm

            dev = msm.resolve_device(device)
        elif backend == "sharded":
            from .parallel import sharded_msm

            if device is None:
                _indexed(None)  # raises without a CUDA device
                n_shards, devices = None, None
            else:
                n_shards = _routing.available_devices()
                if n_shards < 1:
                    raise ValueError(
                        "backend='sharded' with a device needs "
                        "routing.available_devices() >= 1 shards")
                devices = (_indexed(device),) * n_shards
        if self._invalid is not None:
            raise InvalidSignature()
        n = self.batch_size
        if backend == "host" and n and self._buffers_live() \
                and native.load() is not None:
            z_blob = _draw_blinders(rng, n)
            with _metrics.timed(stage_seconds, "host_fused"):
                keys_t = tuple(self._key_index)
                ops = _keyset_operands_for(keys_t)
                if ops is None:  # a key failed decompression
                    raise InvalidSignature()
                key_rows, split = ops
                res = native.verify_host_batch(
                    key_rows, self._r_buf, self._s_buf, self._k_buf,
                    z_blob, n, self._gid, len(keys_t), bytes(_B_RAW_ROW),
                    shift_rows=split[0] if split else None,
                    prebuilt=split[1] if split else None)
            if res is not True:  # None = staging reject, False = equation
                raise InvalidSignature()
            return
        with _metrics.timed(stage_seconds, "stage_host"):
            staged = self._stage(rng)
            if backend == "device":
                digits, wire = staged.device_operands(msm.pad_lanes,
                                                      defer=True)
        if backend == "host":
            with _metrics.timed(stage_seconds, "msm_host"):
                ok = staged.host_msm().mul_by_cofactor().is_identity()
        elif backend == "sharded":
            with _metrics.timed(stage_seconds, "sharded"):
                ok = sharded_msm.sharded_staged_msm(
                    staged, n_shards, devices=devices).mul_by_cofactor() \
                    .is_identity()
        else:
            with _metrics.timed(stage_seconds, "device"):
                ws = msm.PendingMSM(
                    msm.dispatch_window_sums(digits, wire, dev)
                ).window_sums()
            with _metrics.timed(stage_seconds, "combine"):
                # Final cofactored identity check: host-exact, always.
                ok = msm.combine_window_sums(ws).mul_by_cofactor() \
                    .is_identity()
        if not ok:
            raise InvalidSignature()

    def verify_async(self, rng=None, device=None) -> "PendingVerification":
        """Stage on the host, dispatch the device window sums, and return
        immediately; the handle's `.result()` blocks on the device, runs
        the exact host Horner combine + cofactored identity check, and
        raises InvalidSignature on a bad batch."""
        from .ops import msm

        dev = msm.resolve_device(device)
        staged = self._stage(rng)
        digits, wire = staged.device_operands(msm.pad_lanes, defer=True)
        return PendingVerification(
            msm.PendingMSM(msm.dispatch_window_sums(digits, wire, dev)))

    def verify_gpu(self, rng=None, timings=None) -> None:
        """Convenience entry point for the CUDA backend (the analog of the
        JAX package's `verify_tpu`)."""
        self.verify(rng=rng, backend="device", timings=timings)


class PendingVerification:
    """Handle for an in-flight device batch verification."""

    __slots__ = ("_pending",)

    def __init__(self, pending):
        self._pending = pending

    def result(self) -> None:
        """Block until the device window sums land; raises InvalidSignature
        unless the whole batch is valid."""
        check = self._pending.result()
        if not check.mul_by_cofactor().is_identity():
            raise InvalidSignature()


# -- the throughput scheduler ------------------------------------------------

# Counters of the most recent verify_many call (read-only snapshot;
# process-cumulative fault counters live in utils.metrics).
last_run_stats = {}

_PENDING = object()


class _DeviceLane:
    """The device lane: ONE worker thread serializing every device call
    (launches + blocking fetch) of verify_many in one dispatch mode on one
    placement — the single-device lane of a device, or a D-shard mesh lane
    over its shards' devices.  verify_many submits pre-packed chunk
    operands and polls for results; a lane whose worker is stuck is
    abandoned (left to die with the process) and a fresh lane is created
    after the health cooldown."""

    # One lane per (dispatch mode, placement): concurrent callers on
    # different devices or meshes must not tear down each other's lane
    # mid-call.  DEVICE_CALL_LOCK serializes their device calls.
    _instances = {}
    # Abandoned-but-possibly-alive lanes: never handed out again, but the
    # atexit drain still retries their workers (a live worker at
    # interpreter teardown can abort the process).
    _abandoned_instances = []
    _instance_lock = threading.Lock()

    @classmethod
    def get(cls, device, health: "DeviceHealth | None" = None,
            mesh: int = 0, placement=None, chips=None) -> "_DeviceLane":
        """The lane of `device` (mesh 0), or of the `mesh`-shard placement
        `placement` (its shards' devices, the first one leading) whose
        chips are `chips` (None: 0 .. mesh − 1).  On CUDA every kernel is
        built and loaded first, so a build or load failure raises in the
        caller's thread and never reaches the worker."""
        import torch

        mesh = _health.normalize_mesh(mesh)
        placement = (tuple(torch.device(d) for d in placement) if mesh
                     else (torch.device(device),))
        if any(d.type == "cuda" for d in placement):
            from .ops import _cuda

            _cuda.load_all()
        chips = tuple(int(c) for c in chips) if chips else None
        key = (mesh, tuple(str(d) for d in placement), chips)
        if health is None:
            health = _health.health_for(mesh)
        with cls._instance_lock:
            inst = cls._instances.get(key)
            if inst is not None and inst.healthy() \
                    and inst._health is not health:
                # A caller injected a different health/clock (tests):
                # retire the old worker (its queue drains to the poison
                # sentinel) and build a lane on the new one.
                inst._stop()
                inst._abandoned = True
                if inst._thread.is_alive() \
                        and inst not in cls._abandoned_instances:
                    cls._abandoned_instances.append(inst)
                inst = None
            if inst is None or not inst.healthy():
                inst = cls(placement, health=health, mesh=mesh, chips=chips)
                cls._instances[key] = inst
            return inst

    @classmethod
    def reset_all(cls, timeout: float = 5.0) -> bool:
        """Shut down every lane worker.  `timeout` is a TOTAL deadline
        across all lanes (50 ms floor per join).  A worker that refuses to
        die is ABANDONED: deregistered, marked stuck, and kept in the
        side registry for the next drain.  Returns True when no worker
        remains alive."""
        _mono = _health.SYSTEM_CLOCK.monotonic
        end = _mono() + timeout
        with cls._instance_lock:
            lanes = list(cls._instances.items())
            abandoned = list(cls._abandoned_instances)
        all_dead = True
        for key, inst in lanes:
            if inst._thread.is_alive():
                inst.shutdown(timeout=max(0.05, end - _mono()))
            stuck = False
            with cls._instance_lock:
                if inst._thread.is_alive():
                    all_dead = False
                    stuck = True
                    inst._abandoned = True
                    if inst not in cls._abandoned_instances:
                        cls._abandoned_instances.append(inst)
                if cls._instances.get(key) is inst:
                    del cls._instances[key]
            if stuck:
                inst._health.mark_lane_stuck()
        for inst in abandoned:
            if inst._thread.is_alive():
                inst.shutdown(timeout=max(0.05, end - _mono()))
            if inst._thread.is_alive():
                all_dead = False
                continue
            with cls._instance_lock:
                if inst in cls._abandoned_instances:
                    cls._abandoned_instances.remove(inst)
        return all_dead

    def __init__(self, placement, health: "DeviceHealth | None" = None,
                 mesh: int = 0, chips=None):
        import torch

        self._mesh = _health.normalize_mesh(mesh)
        self._placement = tuple(torch.device(d) for d in placement)
        self._device = self._placement[0]
        self._chips = tuple(chips) if chips else None
        self._key = (self._mesh, tuple(str(d) for d in self._placement),
                     self._chips)
        self._health = health if health is not None \
            else _health.health_for(self._mesh)
        self._clock = self._health.clock
        self._q = queue.Queue()
        self._results = {}
        self._discarded = set()
        self._started = {}  # cid -> monotonic time the device call began
        self._cv = threading.Condition()
        self._next_id = 0
        self._abandoned = False
        # The chunk whose dispatch raised and whose error the caller has
        # not yet read (`wait`) or dropped (`discard`): until then the
        # worker starts no other chunk, so a sticky error is never
        # followed by a launch into its poisoned context.
        self._held_error = None
        self._stopping = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="ed25519-device-lane")
        self._thread.start()

    def healthy(self) -> bool:
        return self._thread.is_alive() and not self._abandoned

    def submit(self, digits, pts, cached=None, tables=None,
               audit: bool = False) -> int:
        """Queue one chunk dispatch.  Cold path: `digits`/`pts` are the
        full staged operands.  Cached path (`cached` = the looked-up head
        entry): `pts` is the per-signature R wire and `digits` the
        full-lane digit planes — or, on a mesh lane, the (head digits, R
        digits) pair of the mesh layout; the worker takes the head tensor
        from the entry.  `tables` (the looked-up kind="tables" entry,
        single lane only) upgrades the cached dispatch to the
        tables-resident one.  `audit` (cold mesh chunks) runs the
        sentinel-audit form, whose result carries each shard's partial
        sums after the fold.  The worker's `device_call` span belongs to
        the caller's call (its innermost span, when spans are on)."""
        with self._cv:
            cid = self._next_id
            self._next_id += 1
        self._q.put((cid, digits, pts, cached, tables, audit,
                     _metrics.current_span()))
        return cid

    def discard(self, cid: int) -> None:
        """The caller no longer wants this result (it decided on the
        host, or ended the call): drop it on arrival, or skip the call if
        it has not started."""
        with self._cv:
            self._started.pop(cid, None)
            if cid in self._results:
                del self._results[cid]
            else:
                self._discarded.add(cid)
            self._release_error(cid)

    def _release_error(self, cid: int) -> None:
        """Under self._cv: the caller has read or dropped chunk `cid`; if
        its dispatch raised, the worker may go on."""
        if self._held_error == cid:
            self._held_error = None
            self._cv.notify_all()

    def started_at(self, cid: int):
        """Monotonic time the worker ENTERED the device call for `cid`, or
        None while it is still queued."""
        with self._cv:
            return self._started.get(cid)

    def wait(self, cid: int, timeout: float):
        """(result array or None on device error, call seconds, error,
        mesh counters) tuple, or _PENDING on timeout.  The deadline runs
        on the lane's health clock; a VIRTUAL clock only advances
        explicitly, so the wait polls in short real slices instead of
        sleeping."""
        clock = self._clock
        end = clock.monotonic() + timeout
        with self._cv:
            while cid not in self._results:
                left = end - clock.monotonic()
                if left <= 0:
                    if cid not in self._results:
                        return _PENDING
                    self._release_error(cid)
                    return self._results.pop(cid)
                self._cv.wait(0.01 if clock.virtual else left)
            self._release_error(cid)
            return self._results.pop(cid)

    def abandon(self) -> None:
        self._abandoned = True
        with type(self)._instance_lock:
            if type(self)._instances.get(self._key) is self:
                del type(self)._instances[self._key]
            if (self._thread.is_alive()
                    and self not in type(self)._abandoned_instances):
                type(self)._abandoned_instances.append(self)
        self._health.mark_lane_stuck()

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop the worker before interpreter teardown (a worker held
        after an unread error stops without dispatching again)."""
        self._stop()
        self._thread.join(timeout)

    def _stop(self) -> None:
        """Queue the poison sentinel; a worker held after an unread error
        leaves at once."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        self._q.put(None)

    def _dispatch(self, digits, pts, cached, tables, audit):
        """(the chunk's fetch, its (batches, lanes, variant) shape key, the
        dict its mesh dispatch fills with the mesh counters).  Variants: 0
        cold, 1 resident-head, 2 resident-tables, 3 cold audit."""
        from .ops import msm as _msm

        dev = self._device
        n_batches, n_lanes = _chunk_shape(digits)
        tally = {}
        if self._mesh:
            from .parallel import mesh as _mesh_lib
            from .parallel import sharded_msm as _sh

            kw = dict(clock=self._clock, device_ids=self._chips,
                      devices=self._placement, tally=tally)
            if cached is not None:
                dh, dr = digits
                chips = _mesh_lib.shard_chips(self._placement, self._chips)

                def head_on(d):
                    # The copy on `d`, charged to the chips of its shards.
                    return cached.device_ref(d, chips=[
                        c for c, p in zip(chips, self._placement) if p == d])

                def call():
                    return _sh.sharded_window_sums_many_cached(
                        dh, dr, head_on, pts, self._mesh, **kw)
                variant = 1
            elif audit:
                def call():
                    return _sh.sharded_window_sums_many_audit(
                        digits, pts, self._mesh, **kw)
                variant = 3
            else:
                def call():
                    return _sh.sharded_window_sums_many(
                        digits, pts, self._mesh, **kw)
                variant = 0
        elif cached is not None and tables is not None:
            def call():
                return _msm.dispatch_window_sums_many_tables(
                    digits, tables.device_ref(dev), pts, dev)
            variant = 2
        elif cached is not None:
            def call():
                return _msm.dispatch_window_sums_many_cached(
                    digits, cached.device_ref(dev), pts, dev)
            variant = 1
        else:
            def call():
                return _msm.dispatch_window_sums_many(digits, pts, dev)
            variant = 0

        def fetch():
            if dev.type == "cuda":
                import torch

                with torch.cuda.device(dev):
                    return call().cpu().numpy()
            return call().numpy()

        return fetch, (n_batches, n_lanes, variant), tally

    def _run(self):
        from .ops import msm as _msm

        clock = self._clock
        while True:
            item = self._q.get()
            if item is None:
                return
            cid, digits, pts, cached, tables, audit, origin = item
            with self._cv:
                # After a dispatch that raised, no other chunk starts
                # until the caller has read that error or dropped its
                # chunk: the next launch could go into a context the
                # error poisoned.
                while self._held_error is not None:
                    if self._stopping:
                        return
                    self._cv.wait()
                if cid in self._discarded:
                    # the caller no longer wants it: don't spend a device
                    # call on it
                    self._discarded.discard(cid)
                    continue
            t_call = None
            tally = {}
            try:
                with _msm.DEVICE_CALL_LOCK, _metrics.span(
                        "device_call", origin=origin):
                    t_call = clock.monotonic()
                    with self._cv:
                        self._started[cid] = t_call
                    fetch, shape, tally = self._dispatch(
                        digits, pts, cached, tables, audit)
                    # Every device call passes through the fault seam (a
                    # no-op unless a faults.FaultPlan is installed).
                    out = np.asarray(_faults.run_device_call(
                        _faults.SITE_LANE, fetch, clock=clock,
                        mesh=self._mesh, payload=self._chips))
                # Fetch done: any first-use set-up for this shape is over,
                # so later calls are held to the normal deadline.
                _msm.mark_shape_completed(shape[0], shape[1], self._mesh,
                                          cached=shape[2])
            except _faults.LaneDeathSignal:
                # Injected thread death: exit without reporting a result.
                return
            except Exception as e:  # device error: the caller classifies it
                if _config.get("ED25519_TPU_DEBUG"):
                    import traceback

                    traceback.print_exc()
                out, err = None, e
            else:
                err = None
            # The CALL duration (lock acquired → fetch done), not
            # submit-to-finish: queue time behind a pipelined sibling
            # would inflate the turnaround EMA.
            call_dt = (clock.monotonic() - t_call) if t_call is not None \
                else 0.0
            with self._cv:
                self._started.pop(cid, None)
                if cid in self._discarded:
                    self._discarded.discard(cid)
                else:
                    self._results[cid] = (out, call_dt, err, tally)
                    if err is not None:
                        self._held_error = cid
                self._cv.notify_all()


def _chunk_shape(digits) -> "tuple[int, int]":
    """(padded batches, lanes) of a chunk's digits — the mesh layout's
    (head digits, R digits) pair counts both parts' lanes."""
    if isinstance(digits, tuple):
        dh, dr = digits
        return dr.shape[0], dh.shape[2] + dr.shape[2]
    return digits.shape[0], digits.shape[2]


def _shutdown_device_lane():
    # 30 s: a worker mid-build for a discarded chunk finishes and joins;
    # bounded regardless, since a worker stuck in the runtime never
    # returns.
    _DeviceLane.reset_all(timeout=30.0)


atexit.register(_shutdown_device_lane)


def reset_device_health() -> None:
    """Clear the device health state (cooldowns, pauses, probe streak,
    stuck flags, dead chips) — for benches and services that know a
    transient condition has passed."""
    _health.reset_all()


def device_lane_stuck() -> bool:
    """True if any device-lane worker was ever abandoned mid-call."""
    return _health.any_lane_stuck()


def health_for(mesh: int = 0) -> DeviceHealth:
    """The process DeviceHealth verify_many consults when no explicit
    `health` is passed."""
    return _health.health_for(mesh)


# Union-merge policy (verify_many): batches whose average size is at most
# _MERGE_MAX_BATCH are aggregated into super-batches of about
# _MERGE_TARGET_SIGS signatures.  The big MSM amortizes per-batch fixed
# costs AND coalesces recurring keys ACROSS batches.  Soundness is per
# signature: every signature keeps its own 128-bit blinder, so a valid
# union implies every member batch is valid at the 2^-128 bound; a failed
# union is bisected.
_MERGE_TARGET_SIGS = 8192
_MERGE_MAX_BATCH = 2048


def merge_verifiers(group) -> "Verifier":
    """One union Verifier over many (grouping by key coalesces across
    batches; challenges were computed at queue time, so merging is pure
    dict work).  When every member's columns are live the union is
    columnar too (byte concat + a per-key group-id remap), so it keeps the
    fast staging path and its map stays unbuilt; otherwise the members'
    maps merge and the union takes the grouped walk."""
    group = list(group)
    u = Verifier()
    for v in group:
        if v._invalid is not None:
            u._invalid = v._invalid  # an invalid member fails the union
            break
    u.batch_size = sum(v.batch_size for v in group)
    if not all(v._buffers_live() for v in group):
        um = u._sig_map
        for v in group:
            for vkb, sigs in v._materialized().items():
                um.setdefault(vkb, []).extend(sigs)
        return u
    ki = u._key_index
    for v in group:
        lut = np.empty(max(1, len(v._key_index)), np.int32)
        for kb, g in v._key_index.items():
            lut[g] = ki.setdefault(kb, len(ki))
        u._s_buf += v._s_buf
        u._r_buf += v._r_buf
        u._k_buf += v._k_buf
        if len(v._gid):
            remapped = lut[np.frombuffer(v._gid, dtype=np.int32)]
            u._gid.frombytes(remapped.astype(np.int32).tobytes())
        u._columnar_sigs += v._columnar_sigs
    u._unbuilt = u.batch_size
    return u


def _host_verdict(verifier, rng) -> bool:
    try:
        verifier.verify(rng=rng, backend="host")
        return True
    except InvalidSignature:
        return False


def _resolve_union(verifiers, idxs, verdicts, rng):
    """A union failed: bisect its member batches, each level re-verifying
    a half-union on the host with fresh blinders — O(bad · log(members))
    for sparse bad batches."""
    if len(idxs) == 1:
        verdicts[idxs[0]] = _host_verdict(verifiers[idxs[0]], rng)
        return
    mid = len(idxs) // 2
    for half in (idxs[:mid], idxs[mid:]):
        if _host_verdict(merge_verifiers([verifiers[i] for i in half]),
                         rng):
            for i in half:
                verdicts[i] = True
        else:
            _resolve_union(verifiers, half, verdicts, rng)


def _merge_groups(verifiers):
    """Greedy grouping of batch indices into super-batches of about
    _MERGE_TARGET_SIGS signatures (always ≥ 1 batch per group)."""
    groups, cur, cur_sigs = [], [], 0
    for i, v in enumerate(verifiers):
        cur.append(i)
        cur_sigs += v.batch_size
        if cur_sigs >= _MERGE_TARGET_SIGS:
            groups.append(cur)
            cur, cur_sigs = [], 0
    if cur:
        groups.append(cur)
    return groups


# Hedging arms once the ledger's ring of recent dispatches holds this many:
# below it the HEDGE_QUANTILE tail is noise, and the threshold would fall
# to the bare HEDGE_MIN_MS floor.  A quarter of LatencyLedger.WAVE_WINDOW.
_HEDGE_ARM_WAVES = 32


# One in-flight chunk as the scheduler tracks it: `variant` is the
# first-call grace key (0 cold, 1 resident-head, 2 resident-tables, 3 cold
# audit) and `staged` keeps an audited chunk's (digits, pts) operands for
# the sentinel's host recomputation (None otherwise).
_OutstandingChunk = collections.namedtuple(
    "_OutstandingChunk", ("cid", "idxs", "t0", "padded_b", "n_lanes",
                          "variant", "staged"))


# -- sentinel audits ---------------------------------------------------------
#
# A sampled cold mesh chunk dispatches in the audit form, whose result
# carries each shard's partial window sums beside their fold.  The host
# recomputes one sampled batch's sampled shard from the staged operand
# bytes and compares it as a group element, and checks the fold against
# the sum of every partial.  A divergence is attributed to the chip that
# owns the shard (suspicion, then the ChipRegistry's quarantine) — the one
# check that sees a corrupted ACCEPT, which host confirmation of rejects
# cannot.  The audit only reads: it never edits a device result.

_SENTINEL_SEED = 0x53E4713E1


def _sentinel_fires(rate: float, ordinal: int) -> bool:
    """Deterministic sampled-audit draw: a pure function of the cold mesh
    dispatch ordinal, so two identical runs audit identical chunks."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    digest = hashlib.sha256(
        repr((_SENTINEL_SEED, "sentinel", ordinal)).encode()).digest()
    return int.from_bytes(digest[:8], "little") / float(1 << 64) < rate


def _sentinel_draw(ordinal: int, what: str, n: int) -> int:
    """Deterministic [0, n) pick of the audited batch or shard."""
    digest = hashlib.sha256(
        repr((_SENTINEL_SEED, what, ordinal)).encode()).digest()
    return int.from_bytes(digest[:8], "little") % max(1, n)


def _sentinel_lane_values(digits_b) -> "list[int] | None":
    """One batch's digit planes — packed (17, N) uint8 or plain (33, N)
    int8 — as every lane's integer Σ_w d_w·16^(32−w) (the staged 128-bit
    coefficient chunk or blinder); None for any other layout (the audit
    abstains rather than mis-decode)."""
    d = np.asarray(digits_b)
    if d.dtype == np.uint8:
        if d.shape[0] != limbs.PACKED_WINDOWS:
            return None
        lo = ((d & 0xF).astype(np.int64) ^ 8) - 8
        hi = (((d >> 4) & 0xF).astype(np.int64) ^ 8) - 8
        half = limbs.NWINDOWS // 2
        planes = np.empty((limbs.NWINDOWS, d.shape[1]), np.int64)
        planes[0:2 * half:2] = lo[:half]
        planes[1:2 * half:2] = hi[:half]
        planes[2 * half] = lo[half]
    elif d.shape[0] == limbs.NWINDOWS:
        planes = d.astype(np.int64)
    else:
        return None
    # Three 11-window parts, each inside int64 (|part| < 8·16^11 < 2^47).
    parts = []
    for w0 in (0, 11, 22):
        p = np.zeros(planes.shape[1], np.int64)
        for w in range(w0, w0 + 11):
            p = p * 16 + planes[w]
        parts.append(p.tolist())
    return [(a << 88) + (b << 44) + c for a, b, c in zip(*parts)]


def _sentinel_lane_rows(pts_b, lanes) -> "np.ndarray | None":
    """The raw X‖Y‖Z‖T rows of `lanes` from any point wire (compressed,
    affine or extended); None when an encoding fails to decompress.  A
    compressed lane with the shift flag (hint bit 2) gives [2^128] of its
    encoding's point, as K7 makes it."""
    from .ops.torch_decompress import SHIFT128_FLAG

    pts_b = np.asarray(pts_b)
    if pts_b.dtype == np.uint8:  # compressed (33, N): decompress y
        blob = np.ascontiguousarray(pts_b[:32, lanes].T).tobytes()
        raw, ok, _ = _decompress(blob, len(lanes))
        if not ok.all():
            return None
        for j in np.flatnonzero(pts_b[32, lanes] & SHIFT128_FLAG):
            row = native.msm_shift128_row(raw[j].tobytes())
            raw[j] = np.frombuffer(
                row if row is not None else _point_row(
                    edwards.shift128(_point_from_row(raw[j]))),
                dtype=np.uint8)
        return raw
    rows = np.zeros((len(lanes), 128), dtype=np.uint8)
    for j, lane in enumerate(lanes):
        c = [limbs.limbs_to_int(pts_b[k, :, lane]) % P
             for k in range(pts_b.shape[0])]
        if len(c) == 2:  # affine: Z = 1, T = X·Y
            c = [c[0], c[1], 1, c[0] * c[1] % P]
        rows[j] = np.frombuffer(_point_row(edwards.Point(*c)), np.uint8)
    return rows


def _sentinel_shard_sum(values, pts_b, lane_lo: int, lane_hi: int):
    """The host-exact Σ [v_lane]P_lane over one shard's lanes [lo, hi)
    from the staged operand bytes (zero-digit lanes skipped): the native
    MSM when the runtime is loaded, exact Python otherwise.  None when a
    lane's point fails to decode (the caller counts a divergence)."""
    lanes = [lane for lane in range(lane_lo, lane_hi) if values[lane]]
    if not lanes:
        return edwards.Point(0, 1, 1, 0)
    rows = _sentinel_lane_rows(pts_b, lanes)
    if rows is None:
        return None
    vals = [values[lane] for lane in lanes]
    if min(vals) >= 0:
        got = native.vartime_msm_scblob(
            b"".join(v.to_bytes(32, "little") for v in vals), rows)
        if got is not None:
            return got
    acc = edwards.Point(0, 1, 1, 0)
    for v, row in zip(vals, rows):
        pt = _point_from_row(row)
        acc = acc.add(pt.scalar_mul(v) if v >= 0
                      else pt.scalar_mul(-v).neg())
    return acc


def _indexed(device):
    """`device` resolved (None means CUDA, and raises without one), a CUDA
    device given its index."""
    import torch

    from .ops import msm

    dev = msm.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _lane_device(device):
    """The device verify_many's single lane runs on — `device` resolved
    and indexed.  An excluded CUDA device moves the lane to the first
    surviving device, the way the reference reforms onto survivors; with
    every CUDA device excluded by the ChipRegistry it raises
    DeviceError."""
    import torch

    dev = _indexed(device)
    if dev.type != "cuda":
        return dev
    if dev.index in _health.chip_registry().excluded_chips():
        rung, ids = _routing.reform_for(1)
        if rung < 1:
            raise DeviceError(
                f"{dev} and every other CUDA device are marked dead")
        dev = torch.device("cuda", ids[0] if ids else 0)
    return dev


def _one_card_mesh(mesh: int, device) -> bool:
    """A mesh on a named CUDA device is virtual: all its shards run on that
    one card, its only chip, so no reformation rung lies below it."""
    import torch

    return bool(mesh) and device is not None \
        and torch.device(device).type == "cuda"


def _rung_placement(mesh: int, device, chips, logical: bool = False
                    ) -> tuple:
    """The devices a dispatch mode runs on, the lane's device first.  A
    mesh of D shards: `device` repeated when the caller named one — a
    virtual mesh; on a card its every shard is that card's chip unless the
    chips are `logical` (named by the caller), and an excluded card raises
    DeviceError — else the cards `chips` (default 0 .. D − 1), which
    raises ValueError with fewer cards visible.  The single lane: `device`
    (or, after a reformation down to one card, the first surviving
    card)."""
    import torch

    if mesh:
        if device is not None:
            dev = _indexed(device)
            if not logical and dev.type == "cuda" and \
                    dev.index in _health.chip_registry().excluded_chips():
                raise DeviceError(f"mesh={mesh} on {dev}: {dev} is "
                                  f"excluded (dead or quarantined)")
            return (dev,) * mesh
        from .parallel import mesh as mesh_lib

        return mesh_lib.batch_mesh(mesh, device_ids=chips)
    if chips is not None:
        return ((_indexed(device),) if device is not None
                else (torch.device("cuda", chips[0]),))
    return (_lane_device(device),)


def _stats_chips(mesh: int, chips, placement) -> "list[int] | None":
    """`last_run_stats["device_ids"]`: the chips the caller named or a
    reformation chose; else, on a mesh, the chip of each shard of the
    placement (mesh.shard_chips: a card's CUDA index, so a virtual mesh on
    one card names it D times; a CPU shard's position); else None."""
    if chips:
        return list(chips)
    if mesh and placement:
        from .parallel import mesh as mesh_lib

        return list(mesh_lib.shard_chips(placement))
    return None


@_metrics.spanned("verify_many", call=True)
def verify_many(verifiers, rng=None, chunk: int = 8, hybrid: bool = True,
                merge: str = "auto", mesh: "int | None" = None,
                health: "DeviceHealth | None" = None, device=None,
                policy: "_routing.RoutingPolicy | None" = None,
                sentinel_rate: "float | None" = None,
                deadline: "float | None" = None,
                device_ids=None, cache=None) -> "list[bool]":
    """Verify MANY independent batches with union-merging, chunked
    double-buffered device calls, and an opportunistic host lane.

    Small batches are first union-merged into ~_MERGE_TARGET_SIGS-sig
    super-batches (`merge`: "auto" merges when the average batch is small,
    "never" disables, "always" forces).  A valid union decides every member
    batch True at the 2^-128 bound; a failed union is bisected on the host.

    (Super-)batches are stacked `chunk` at a time behind one device call,
    and staging of chunk i+1 overlaps the device call of chunk i.  While a
    chunk is in flight, the otherwise-idle host core verifies further
    batches end to end with the native C++ MSM (`hybrid`), so host and
    device throughput add; while the device is paused as uncompetitive,
    a hybrid call runs on the host lane.  `hybrid=False` forces the
    device: its first chunk is the probe, two chunks stay in flight, and
    the host decides nothing but the device's rejects.

    A recurring keyset (the same validators every height) becomes resident
    in the device operand cache (devcache.py) at its second sighting and
    dispatches from its third through the tables-resident kernels (K4,
    K2t) on the single lane, or the head-resident dispatch — on a mesh,
    or when the tables kind is off or was not admitted.

    `mesh` routing (routing.py): None (auto) asks the RoutingPolicy
    (`policy`, default routing.default_policy()), which picks the full
    healthy mesh of visible cards only above its crossover and with at
    least two cards — so on one card auto is the single lane, and with
    `device` named it always is; 0 or 1 is the single-device lane; D > 1
    is a D-shard mesh (parallel/sharded_msm.py).  A mesh without `device`
    puts shard k on `cuda:k` and raises ValueError with fewer than D cards
    visible; with `device` named, all D shards run on it (a virtual mesh:
    the tests run D shards on "cpu", a one-card machine on "cuda:0").
    Excluded chips (dead or quarantined in the ChipRegistry) reform the
    mesh at entry onto the widest surviving rung.

    `sentinel_rate` (default ED25519_TPU_SENTINEL_RATE) samples cold mesh
    chunks for a sentinel audit (see _sentinel_fires).

    `device_ids` names the call's chips: logical ids, one per shard (one
    for the single lane), that the ChipRegistry, the latency ledger and
    the fault seam's payload use.  The devices stay the rule above
    (`device` when named, so several logical chips can share one card or
    the CPU; else `cuda:<id>`).  A named chip that is excluded reforms
    the call at entry onto the widest surviving rung of logical chips.

    Every completed device call lands in the latency ledger
    (health.LatencyLedger), attributed over the call's chips; a straggler
    streak accrues suspicion (stats["straggler_suspicion_events"]).
    Hedged re-dispatch, in hybrid calls only, is the race of a drained
    pool gated on the ledger: once it holds _HEDGE_ARM_WAVES dispatches,
    the host races a chunk only after its device call outlives
    ED25519_TPU_HEDGE_QUANTILE of them (floored at
    ED25519_TPU_HEDGE_MIN_MS; 0 hedges at once), and each chunk it races
    then is a hedge twin: it re-verifies the chunk's undecided batches
    with fresh blinders, the first decision of a batch wins, and a chunk
    the twin overtakes is discarded unread (stats "hedges_fired",
    "hedges_won", "hedges_lost").  A cold ledger races at once, as does
    an armed one once `deadline` (absolute, on the health clock) no
    longer affords waiting: `now` + the host median reaches it.  A
    forced-device call (`hybrid=False`) records latency and suspicion but
    never races: it never decides on the host.

    Returns a verdict per verifier (True = every queued signature valid),
    each decided by the same exact host math as `verify` (a batch that
    fails host staging is simply False).  A device REJECT is never a
    verdict by itself: it is re-decided on the host, so even a corrupted
    device result cannot fail a valid batch.  The host never decides what
    the device failed to — unlike the JAX package, which re-decides such
    chunks on the host:

    * the kernels are built and loaded before the lane starts;
    * a device error is classified (health.classify_device_error): a
      transient one retries the chunk on the device with bounded backoff
      (twice per call); on a mesh, a fatal one marks its chips dead and an
      ambiguous one smears suspicion over the placement, and the wave's
      undecided batches are re-issued on the widest surviving rung
      (`try_reform`, the mesh N → N/2 → … → one card);
    * anything left — no rung to reform to, a single-lane error that is
      not transient (a fatal one after marking the device dead and arming
      its cooldown, never a retry into a dead context), a chunk that
      misses its deadline, a call during the cooldown — raises
      DeviceError, cause chained;
    * a sentinel divergence records the attributed suspicion and raises
      DeviceError naming the chips.

    `device`: None means CUDA, "cpu" runs the kernels' plain versions.
    `cache` is the device operand cache the call's residency lives in
    (None: `devcache.default_cache()`; a federation replica passes its
    namespaced one).  `health` injects the DeviceHealth and its clock
    (tests drive deadlines with health.FakeClock).  `ED25519_TPU_DISABLE_DEVICE=1` is how a
    caller asks for the host lane alone."""
    from .ops import msm
    from .parallel import mesh as _mesh_lib
    from .parallel.sharded_msm import shard_pad, shard_pad_cached

    _wall = _health.SYSTEM_CLOCK.monotonic
    verifiers = list(verifiers)
    if merge not in ("auto", "never", "always"):
        raise ValueError(f"unknown merge policy {merge!r}")
    do_merge = merge == "always" or (
        merge == "auto" and len(verifiers) >= 2
        and sum(v.batch_size for v in verifiers)
        <= _MERGE_MAX_BATCH * len(verifiers))
    if do_merge:
        with _metrics.span("merge"):
            groups = _merge_groups(verifiers)
            unions = None if len(groups) == len(verifiers) else [
                merge_verifiers([verifiers[i] for i in g]) for g in groups]
        if unions is not None:
            t0 = _wall()
            # `mesh` passes through unresolved: auto routing reads the
            # merged sizes, the ones actually dispatched.
            union_verdicts = verify_many(
                unions, rng=rng, chunk=chunk, hybrid=hybrid, merge="never",
                mesh=mesh, health=health, device=device, policy=policy,
                sentinel_rate=sentinel_rate, deadline=deadline,
                device_ids=device_ids, cache=cache)
            stats = dict(last_run_stats)
            verdicts = [False] * len(verifiers)
            for g, ok in zip(groups, union_verdicts):
                if ok:
                    for i in g:
                        verdicts[i] = True
                else:
                    with _metrics.span("bisect"):
                        _resolve_union(verifiers, g, verdicts, rng)
            # Lane counters of the inner call are in UNION units.
            stats.update(
                batches=len(verifiers),
                sigs=sum(v.batch_size for v in verifiers),
                queue_columnar_sigs=sum(v._columnar_sigs for v in verifiers),
                merged_unions=len(groups),
                host_unions=stats.pop("host_batches", 0),
                device_unions=stats.pop("device_batches", 0),
                seconds=_wall() - t0)
            last_run_stats.clear()
            last_run_stats.update(stats)
            return verdicts

    with _metrics.span("route"):
        # Cache temperature of the call's dominant keyset (non-mutating).
        devcache_cache = (cache if cache is not None
                          else _devcache.default_cache())
        devcache_probe = devcache_cache.probe(None)
        if verifiers and devcache_cache.enabled:
            big = max(verifiers, key=_routing.estimate_device_terms)
            devcache_probe = devcache_cache.probe(
                _devcache.keyset_digest(big._canonical_keyset_blob()))
        device_on = not _config.get("ED25519_TPU_DISABLE_DEVICE")
        mesh = _routing.resolve_mesh(
            mesh, est_terms_per_batch=max(
                (_routing.estimate_device_terms(v) for v in verifiers),
                default=0),
            n_devices=None if device is None else 1, health=health,
            policy=policy)
    if sentinel_rate is None:
        sentinel_rate = _config.get("ED25519_TPU_SENTINEL_RATE")
    sentinel_rate = float(sentinel_rate)
    # Entry reformation: with chips excluded (dead, quarantined or on
    # probation), a mesh runs only the rung the live chip set supports, on
    # the survivors; named chips reform the same way, onto logical chips.
    logical = bool(device_ids)
    chips = tuple(int(c) for c in device_ids) if logical else None
    if logical and len(chips) != max(mesh, 1):
        raise ValueError(f"device_ids names {len(chips)} chips for a "
                         f"mesh of {mesh}")
    entry_reform = None
    if device_on and logical:
        excluded = _health.chip_registry().excluded_chips()
        if excluded & set(chips):
            rung, ids = _routing.reform_for(mesh or 1,
                                            total=max(chips) + 1)
            if rung < 1:
                raise DeviceError(f"device_ids={list(chips)}: every chip "
                                  f"is excluded ({sorted(excluded)})")
            new_mesh = _health.normalize_mesh(rung)
            entry_reform = {"from": mesh, "to": new_mesh,
                            "device_ids": list(ids) if ids else None,
                            "reissued": 0}
            mesh, chips = new_mesh, tuple(ids) if ids else tuple(range(rung))
    elif device_on and mesh and not _one_card_mesh(mesh, device):
        excluded = _health.chip_registry().excluded_chips()
        if excluded:
            rung, chips = _routing.reform_for(mesh)
            if rung < 1:
                raise DeviceError(f"mesh={mesh}: every chip is excluded "
                                  f"({sorted(excluded)})")
            new_mesh = _health.normalize_mesh(rung)
            if new_mesh != mesh or chips is not None:
                entry_reform = {"from": mesh, "to": new_mesh,
                                "device_ids": list(chips) if chips else None,
                                "reissued": 0}
            mesh = new_mesh
    placement = (_rung_placement(mesh, device, chips, logical)
                 if device_on else None)
    lane_dev = placement[0] if placement else None
    if health is None:
        health = _health.health_for(mesh)
    if lane_dev is not None and verifiers and health.in_cooldown():
        raise DeviceError(
            f"{lane_dev} is cooling down after a failed call (until "
            f"{health.cooldown_until:.1f} on the health clock)")
    now = health.now

    verdicts = [False] * len(verifiers)
    remaining = list(range(len(verifiers)))  # tail = host-lane candidates
    _t_begin = _wall()
    stats = {
        "batches": len(verifiers),
        "sigs": sum(v.batch_size for v in verifiers),
        # Of those, the signatures `queue_bulk` queued in one native call.
        "queue_columnar_sigs": sum(v._columnar_sigs for v in verifiers),
        "mesh": mesh,  # the resolved dispatch mode (0 = single device)
        "device": None if lane_dev is None else str(lane_dev),
        "device_ids": _stats_chips(mesh, chips, placement),
        # Every reformation of this call: at entry (chips excluded before
        # dispatch) or mid-wave (a chip failed under an in-flight chunk,
        # whose undecided batches were re-issued on the reformed rung).
        "mesh_reformations": [entry_reform] if entry_reform else [],
        "host_batches": 0,
        "device_batches": 0,
        "device_sick": False,
        "device_measured": False,  # a chunk completed and updated the EMA
        "probed": False,  # a probe chunk was actually dispatched
        "device_errors": 0,  # error chunks (retried, reformed or raised)
        # Device rejects re-decided on the host: CONFIRMED (a genuinely
        # bad batch) or OVERTURNED (the host restored a valid batch a
        # corrupted device result tried to fail).
        "device_rejects_confirmed": 0,
        "device_rejects_overturned": 0,
        "devcache": dict(devcache_probe, dispatch_hits=0,
                         table_dispatch_hits=0),
        "error_classes": {_health.ERROR_TRANSIENT: 0,
                          _health.ERROR_FATAL: 0,
                          _health.ERROR_AMBIGUOUS: 0},
        "transient_retries": 0,
        # The gray-failure trail: hedge pairs fired, won (the twin decided
        # a batch, or the device leg never gave a usable result) and lost
        # (the device landed first everywhere), and the straggler streaks
        # the latency ledger attributed.
        "hedges_fired": 0,
        "hedges_won": 0,
        "hedges_lost": 0,
        "straggler_suspicion_events": 0,
        # Audited mesh chunks, divergences, and the chips they named.
        "sentinel": {"rate": sentinel_rate, "audits": 0, "divergence": 0,
                     "attributed": []},
        # Wall seconds by layer: host staging of device chunks, the
        # device calls (launches + fetch), the host combine + cofactor
        # check of device results, and whole host-lane verifications.
        "stage_seconds": 0.0,
        "device_seconds": 0.0,
        "combine_seconds": 0.0,
        "host_seconds": 0.0,
        "seconds": 0.0,
        # Staging's [2^128]A lookups (one per key of every staged batch),
        # those `_shift128_cache` served, and those the cold dispatches
        # left to the card (the lanes flagged for K7): on the cold paths
        # hits + device = lookups.
        "shift128_lookups": 0,
        "shift128_hits": 0,
        "shift128_device": 0,
        # The mesh layer (parallel/sharded_msm.py), of the device calls
        # counted in device_seconds: the host seconds of the per-shard
        # copies and launches and of the gather to the lead device with
        # K5, and the lanes each chip's shard dispatches carried.
        "mesh_launch_seconds": 0.0,
        "mesh_gather_seconds": 0.0,
        "mesh_lanes": {},
    }

    def add_mesh_tally(tally) -> None:
        for key in ("mesh_launch_seconds", "mesh_gather_seconds"):
            stats[key] += tally.get(key, 0.0)
        lanes = stats["mesh_lanes"]
        for chip, n in tally.get("mesh_lanes", {}).items():
            lanes[chip] = lanes.get(chip, 0) + n

    def _publish():
        stats["seconds"] = _wall() - _t_begin
        last_run_stats.clear()
        last_run_stats.update(stats)

    def _finish(result):
        # Device PARTICIPATION, not wins: host-re-decided rejects count.
        participated = (stats["device_batches"]
                        + stats["device_rejects_confirmed"]
                        + stats["device_rejects_overturned"])
        if (stats["batches"] >= 8 and participated == 0
                and not stats["device_sick"] and stats["host_batches"]):
            if stats["device_measured"]:
                health.note_uncompetitive()
            elif stats["probed"]:
                if health.note_unresolved_probe():
                    _metrics.record_fault("probe_backoff_armed")
        elif stats["device_measured"] or participated:
            health.note_probe_resolved()
        _publish()
        return result

    def stage_one(i):
        try:
            return verifiers[i]._stage(rng)
        except InvalidSignature:
            return None  # malformed input: verdict stays False

    decided = bytearray(len(verifiers))  # first lane to decide wins
    _host_times = []

    def host_verify_one(i):
        if decided[i]:
            return
        decided[i] = 1
        t0 = now()
        w0 = _wall()
        with _metrics.span("recheck"):
            verdicts[i] = _host_verdict(verifiers[i], rng)
        stats["host_seconds"] += _wall() - w0
        stats["host_batches"] += 1
        if len(_host_times) < 64:
            _host_times.append(now() - t0)

    def resident_entry_for(staged):
        """(head entry, tables entry) covering every staged batch of a
        chunk, each None when missing (mixed keysets, first sighting,
        cache off, stale or corrupt — all of which mean the next-colder
        path)."""
        if not devcache_cache.enabled:
            return None, None
        blobs = {s.keyset_blob for s in staged}
        if len(blobs) != 1 or None in blobs:
            return None, None
        digest = _devcache.keyset_digest(staged[0].keyset_blob)
        entry = devcache_cache.lookup(digest)
        tables_on = _config.get("ED25519_TPU_DEVCACHE_TABLES")
        tables = (devcache_cache.lookup(digest, kind=_devcache.KIND_TABLES)
                  if tables_on and entry is not None else None)
        if entry is None and devcache_cache.should_build(digest):
            # Install residency for the NEXT dispatch; this chunk still
            # stages cold (a miss is always the cold path).
            n_keys = len(staged[0].coeffs) - 1
            head = staged[0].head_tensor()
            devcache_cache.build(digest, n_keys, head)
            if tables_on and devcache_cache.can_admit_tables(
                    digest, 9 * head.nbytes):
                devcache_cache.build(
                    digest, n_keys, staged[0].head_tables_tensor(),
                    kind=_devcache.KIND_TABLES)
        elif (entry is not None and tables is None and tables_on
              and devcache_cache.can_admit_tables(
                  digest, 9 * entry.head_tensor.nbytes)):
            # Head resident but tables not: rebuild the tables for the
            # NEXT dispatch; this chunk runs the head-resident dispatch.
            devcache_cache.build(
                digest, entry.n_keys, staged[0].head_tables_tensor(),
                kind=_devcache.KIND_TABLES)
        return entry, tables

    def pad_batch_axis(digits, pts):
        """Pad the batch axis to the full chunk for EVERY dispatch (probe
        and tails included): one fixed shape per dispatch form.  Padding
        batches are zero digits on the wire's identity (compressed,
        affine or extended)."""
        if digits.shape[0] >= chunk:
            return digits, pts
        nb = chunk - digits.shape[0]
        digits = np.concatenate(
            [digits, np.zeros((nb,) + digits.shape[1:], digits.dtype)])
        ident = {2: limbs.identity_affine_batch,
                 33: limbs.identity_wire_batch}.get(
            pts.shape[1], limbs.identity_point_batch)(pts.shape[-1])
        return digits, np.concatenate(
            [pts, np.stack([ident] * nb).astype(pts.dtype)])

    def stage_chunk(vs_idx):
        staged, idxs = [], []
        for i in vs_idx:
            s = stage_one(i)
            if s is not None:
                staged.append(s)
                idxs.append(i)
                stats["shift128_lookups"] += len(s.coeffs) - 1
                stats["shift128_hits"] += s.shift128_hits
        if not staged:
            return None
        entry, tables_entry = resident_entry_for(staged)
        if entry is not None:
            n_head = entry.n_head
            if mesh:
                nr = max(shard_pad_cached(s.n_sigs, n_head, mesh)
                         for s in staged)
            else:
                nr = max(msm.pad_lanes(s.n_cached_terms)
                         for s in staged) - n_head
            with _metrics.span("stage.operands"):
                ops = [s.device_operands_cached(
                    lambda n, nr=nr: n_head + nr) for s in staged]
                digits, pts = pad_batch_axis(
                    np.stack([d for d, _ in ops]),
                    np.stack([p for _, p in ops]))
            if mesh:
                # The mesh layout: head digits on shard 0's head lanes
                # only (zeros elsewhere: identity contributions), R
                # digits split over the shards like the cold operands.
                # The tables-resident dispatch stays single-device.
                dh = np.zeros(digits.shape[:2] + (mesh * n_head,),
                              dtype=digits.dtype)
                dh[..., :n_head] = digits[..., :n_head]
                return (idxs, (dh, np.ascontiguousarray(
                    digits[..., n_head:])), pts, entry, None)
            return idxs, digits, pts, entry, tables_entry
        pad = max(shard_pad(s.n_device_terms, mesh) if mesh
                  else msm.pad_lanes(s.n_device_terms) for s in staged)
        with _metrics.span("stage.operands"):
            ops = [s.device_operands(lambda n: pad, defer=True)
                   for s in staged]
            digits, pts = pad_batch_axis(np.stack([d for d, _ in ops]),
                                         np.stack([p for _, p in ops]))
        if pts.ndim == 3:  # the compressed wire, (B, 33, N): count flags
            from .ops.torch_decompress import SHIFT128_FLAG

            stats["shift128_device"] += int(np.count_nonzero(
                pts[:, 32] & SHIFT128_FLAG))
        return idxs, digits, pts, None, None

    # Work-stealing pipeline.  The device lane is ONE worker thread that
    # serializes every device call; the main thread stages chunks for it,
    # verifies tail batches on the host in the meantime, and polls.  The
    # device is a PROBATIONARY helper in hybrid mode: a probe chunk
    # measures its per-batch turnaround, and further chunks go out only
    # while it beats the host.  A chunk that misses its deadline (3× the
    # turnaround EMA × batches, 2 s floor) marks the device sick and fails
    # the call, unless a mesh can reform around an excluded chip.
    if (lane_dev is None or not verifiers
            or (hybrid and not health.device_allowed())):
        while remaining:
            host_verify_one(remaining.pop())
        return _finish(verdicts)
    with _metrics.span("route"):
        dev = _DeviceLane.get(lane_dev, health=health, mesh=mesh,
                              placement=placement, chips=chips)

    # Seconds-per-batch prior before the first measurement; a malformed
    # ED25519_TPU_EMA_PRIOR raises ConfigError here.
    ema_per_batch = _config.get("ED25519_TPU_EMA_PRIOR")
    ema_is_prior = True
    outstanding = []
    transient_left = [2]
    transient_backoff = _health.Backoff(
        clock=health.clock, base=0.05, factor=2.0, max_delay=0.5,
        jitter=0.0)
    _transient_gate = threading.Event()  # never set: a pure bounded wait
    # Mid-wave reformation budget: each chip-loss event may step the
    # ladder once; a storm that keeps killing chips walks 8 → 4 → 2 → 1
    # and then raises — never a livelock.
    reforms_left = [4]
    sentinel_ord = [0]  # cold mesh submits, the sentinel draw's ordinal

    def _transient_wait():
        """The bounded backoff between transient retries: virtual clocks
        advance, real clocks wait."""
        delay = transient_backoff.arm()
        clk = health.clock
        if getattr(clk, "virtual", False):
            clk.advance(delay)
        else:
            _transient_gate.wait(delay)

    def placement_chips() -> "tuple[int, ...]":
        """The chips the current dispatch runs on, each once: what an
        unattributed error marks dead or smears suspicion over."""
        return tuple(dict.fromkeys(_mesh_lib.shard_chips(placement, chips)))

    def record_chunk_latency(call_dt) -> None:
        """Land one completed device call in the latency ledger over the
        current placement; a straggler streak accrues suspicion."""
        flagged = _health.chip_registry().record_latency(
            placement_chips(), call_dt)
        if flagged:
            stats["straggler_suspicion_events"] += len(flagged)
            _metrics.record_fault("straggler_suspicion", len(flagged))

    # Hedged re-dispatch (hybrid calls only) is the race below, gated on
    # the ledger: the knobs are read once per call, the threshold from the
    # ledger on every check.
    hedge_q_milli = int(round(float(
        _config.get("ED25519_TPU_HEDGE_QUANTILE")) * 1000))
    hedge_floor_s = float(_config.get("ED25519_TPU_HEDGE_MIN_MS")) / 1000.0
    hedged = set()   # cids the host raced as hedge twins
    hedge_wins = set()  # hedged cids whose twin decided a batch

    def hedge_threshold_s() -> "float | None":
        """Seconds a device call may run before the host races it; None
        while the ledger is cold (a zero floor forces hedging regardless)."""
        led = _health.chip_registry().latency
        if hedge_floor_s > 0 and led.wave_samples() < _HEDGE_ARM_WAVES:
            return None
        return max(led.wave_quantile_us(hedge_q_milli) / 1000000.0,
                   hedge_floor_s)

    def host_median() -> float:
        return (sorted(_host_times)[len(_host_times) // 2]
                if _host_times else 0.0)

    def hedge_resolve(cid, twin_won: bool) -> None:
        """Close one hedge pair, won or lost.  `twin_won` forces a win (the
        device leg was dropped or errored)."""
        if cid not in hedged:
            return
        hedged.discard(cid)
        if cid in hedge_wins or twin_won:
            hedge_wins.discard(cid)
            stats["hedges_won"] += 1
            _metrics.record_fault("hedge_won")
        else:
            stats["hedges_lost"] += 1
            _metrics.record_fault("hedge_lost")

    def race_gate() -> "tuple[list, float | None]":
        """Which in-flight chunks the host may race now, and when the next
        one may be raced.  A cold ledger races every chunk at once (no
        hedge counted).  An armed one races a chunk once its device call
        outlives the hedge threshold (or half its own budget, if sooner),
        or every chunk at once when the deadline no longer affords
        waiting; each chunk it races fires a hedge twin."""
        thr = hedge_threshold_s()
        if thr is None:
            return list(outstanding), None
        t_now = now()
        pressed = deadline is not None and t_now + host_median() >= deadline
        ready, wake = [], None
        for r2 in outstanding:
            # A wait must never run into the call's deadline miss.
            t_start = dev.started_at(r2.cid)
            t0 = t_start if t_start is not None else r2.t0
            t_fire = min(t0 + thr, (t0 + call_deadline(r2)[1]) / 2)
            if pressed or r2.cid in hedged or t_now >= t_fire:
                if r2.cid not in hedged:
                    hedged.add(r2.cid)
                    stats["hedges_fired"] += 1
                    _metrics.record_fault("hedge_fired")
                ready.append(r2)
            else:
                wake = t_fire if wake is None else min(wake, t_fire)
        return ready, wake

    def submit(size=None):
        size = chunk if size is None else size
        ch = remaining[:size]
        del remaining[:size]
        w0 = _wall()
        with _metrics.span("stage"):
            pending = stage_chunk(ch)
        stats["stage_seconds"] += _wall() - w0
        if pending is None:
            return
        idxs, digits, pts, cached, tables = pending
        audit = False
        if mesh and cached is None:
            # Sentinel sampling: cold mesh chunks only — the audit
            # recomputes a shard from the staged wire bytes, which the
            # cached form keeps off the wire.
            audit = _sentinel_fires(sentinel_rate, sentinel_ord[0])
            sentinel_ord[0] += 1
        cid = dev.submit(digits, pts, cached=cached, tables=tables,
                         audit=audit)
        if cached is not None:
            stats["devcache"]["dispatch_hits"] += 1
        if tables is not None:
            stats["devcache"]["table_dispatch_hits"] += 1
        variant = 3 if audit else (
            0 if cached is None else (2 if tables is not None else 1))
        padded_b, n_lanes = _chunk_shape(digits)
        outstanding.append(_OutstandingChunk(
            cid, idxs, now(), padded_b, n_lanes, variant,
            (digits, pts) if audit else None))

    @_metrics.spanned("combine")
    def decide_on_device(idxs, out):
        w0 = _wall()
        for j, i in enumerate(idxs):
            if decided[i]:
                continue  # the host stole this batch back first
            ok = msm.combine_window_sums(out[j]).mul_by_cofactor() \
                .is_identity()
            if ok:
                decided[i] = 1
                stats["device_batches"] += 1
                verdicts[i] = True
                continue
            # Device REJECT: never a verdict by itself — a reject can be
            # manufactured by a corrupted device sum, so the exact host
            # path re-decides it before any batch fails.
            host_verify_one(i)
            if verdicts[i]:
                stats["device_rejects_overturned"] += 1
                _metrics.record_fault("device_reject_overturned")
            else:
                stats["device_rejects_confirmed"] += 1
                _metrics.record_fault("device_reject_confirmed")
        stats["combine_seconds"] += _wall() - w0

    def fail(msg, cause):
        """End the call: drop the chunks still in flight and raise
        DeviceError.  The host never decides what the device failed to."""
        for r2 in outstanding:
            dev.discard(r2.cid)
        outstanding.clear()
        _publish()
        raise DeviceError(msg) from cause

    def sentinel_check(rec, folded, partials) -> "list[int] | None":
        """Audit one audited chunk (read-only): recompute a sampled
        batch's sampled shard on the host and compare it as a group
        element, then check the fold against the sum of every partial.
        The sample is drawn among the shards that hold real terms, and
        every all-padding shard is checked too — its partial must be the
        identity, which costs no recomputation.  (Drawing an all-padding
        shard proved nothing: a chip that forged its own partial and the
        fold alike passed whenever the draw missed it.)  None when
        consistent; otherwise the chips the divergence names (every shard
        recomputed when only the fold is off; empty when no shard
        explains it), after recording their suspicion."""
        digits, pts = rec.staged
        sen = stats["sentinel"]
        d_mesh = partials.shape[0]
        j = _sentinel_draw(rec.cid, "batch", len(rec.idxs))
        values = _sentinel_lane_values(digits[j])
        if values is None:
            return None  # not the production digit layout: abstain
        sen["audits"] += 1
        _metrics.record_fault("sentinel_audit")
        per = len(values) // d_mesh
        shard_chips = _mesh_lib.shard_chips(placement, chips)

        def diverges(shard: int) -> bool:
            want = _sentinel_shard_sum(values, pts[j], shard * per,
                                       (shard + 1) * per)
            return want is None or want != msm.combine_window_sums(
                partials[shard, j])

        live = [d for d in range(d_mesh)
                if any(values[d * per:(d + 1) * per])] or [0]
        k = live[_sentinel_draw(rec.cid, "shard", len(live))]
        named = [shard_chips[d] for d in range(d_mesh)
                 if d not in live and diverges(d)]
        if diverges(k):
            named.append(shard_chips[k])
        if not named:
            total = edwards.Point(0, 1, 1, 0)
            for d in range(d_mesh):
                total = total.add(msm.combine_window_sums(partials[d, j]))
            if total == msm.combine_window_sums(folded[j]):
                return None
            named = [shard_chips[d] for d in live
                     if d != k and diverges(d)]
        named = list(dict.fromkeys(named))
        sen["divergence"] += 1
        _metrics.record_fault("sentinel_divergence")
        chipreg = _health.chip_registry()
        if named:
            sen["attributed"].extend(named)
            for c in named:
                chipreg.record_suspicion(c, _health.SENTINEL_SUSPICION,
                                         "sentinel-audit divergence")
        else:
            # The fold lies but every partial checks out: no chip to
            # name, ambiguous suspicion over the placement.
            for c in placement_chips():
                chipreg.record_suspicion(
                    c, _health.AMBIGUOUS_SUSPICION,
                    "sentinel fold inconsistency (unattributed)")
        return named

    def try_reform(reissue_idxs) -> bool:
        """Chip-loss escalation on a mesh: with chips excluded in the
        ChipRegistry, reform onto the widest surviving rung (mesh N →
        N/2 → … → one card; a same-width move onto other cards counts
        too) and re-issue `reissue_idxs` there, on the device.  False when
        this is not a mesh, no chip is excluded, no other rung exists, or
        the budget is spent; the caller then raises."""
        nonlocal mesh, chips, placement, lane_dev, health, dev, \
            ema_is_prior, probed
        if (not mesh or reforms_left[0] <= 0
                or (_one_card_mesh(mesh, device) and not logical)):
            return False
        excluded = _health.chip_registry().excluded_chips()
        if not excluded:
            return False
        # Logical chips name their own universe; the cards' ids None means
        # 0 .. rung − 1.
        total = max(chips) + 1 if logical else None

        def rung_for(width):
            rung, ids = _routing.reform_for(width, total=total)
            if logical and not ids:
                ids = tuple(range(rung))
            return rung, ids

        cur = (mesh, chips)
        rung, ids = rung_for(mesh)
        if (rung, ids) == cur:
            # The live set still supports this shape but the fault hit it
            # anyway: step down one rung.
            rung, ids = rung_for(max(1, mesh // 2))
            if (rung, ids) == cur:
                return False
        if rung < 1:
            return False
        new_mesh = _health.normalize_mesh(rung)
        try:
            new_placement = _rung_placement(new_mesh, device, ids, logical)
        except (ValueError, DeviceError):
            return False
        reforms_left[0] -= 1
        old_mesh = mesh
        process_health = health is _health.health_for(old_mesh)
        mesh, chips, placement = new_mesh, ids, new_placement
        lane_dev = placement[0]
        # Keep the caller's clock across the reformation.
        health = (_health.health_for(new_mesh) if process_health
                  else _health.DeviceHealth(mesh=new_mesh,
                                            clock=health.clock))
        dev = _DeviceLane.get(lane_dev, health=health, mesh=mesh,
                              placement=placement, chips=chips)
        # The old width's EMA does not price the new rung, which earns a
        # fresh probe.
        ema_is_prior = True
        probed = False
        stats.update(mesh=new_mesh, device=str(lane_dev),
                     device_ids=_stats_chips(new_mesh, ids, placement))
        stats["mesh_reformations"].append({
            "from": old_mesh, "to": new_mesh,
            "device_ids": list(ids) if ids else None,
            "dead": sorted(excluded), "reissued": len(reissue_idxs)})
        _metrics.record_fault("mesh_reformed")
        remaining.extend(reissue_idxs)
        return True

    def on_device_error(idxs, err) -> None:
        """Classify a chunk's device error: a transient one re-dispatches
        the chunk's undecided batches (fresh blinders, bounded backoff);
        on a mesh, a fatal one marks its chips dead, an ambiguous one
        smears suspicion, and the wave re-issues on a reformed rung; any
        other case fails the call, a fatal one after marking the device
        dead and arming its cooldown."""
        nonlocal probed
        stats["device_errors"] += 1
        _metrics.record_fault("device_error")
        ev = _health.classify_device_error(err)
        stats["error_classes"][ev.cls] += 1
        undecided = [i for i in idxs if not decided[i]]
        if ev.cls == _health.ERROR_TRANSIENT and transient_left[0] > 0:
            transient_left[0] -= 1
            stats["transient_retries"] += 1
            _metrics.record_fault("device_transient_retry")
            _transient_wait()
            remaining.extend(undecided)
            probed = False  # an errored probe measured nothing
            return
        chipreg = _health.chip_registry()
        where = (f"the mesh of {mesh} on {stats['device']}" if mesh
                 else str(lane_dev))
        if ev.cls == _health.ERROR_FATAL:
            # The chips are gone for this process (a sticky CUDA error
            # poisons a context): mark them dead unless the raiser did.
            # Never a retry into a dead context.
            if not ev.marked and (mesh or lane_dev.type == "cuda"):
                for c in (ev.chips or placement_chips()):
                    chipreg.mark_chip_dead(
                        c, heal_after=ev.heal_after,
                        reason=f"classified-fatal: {ev.reason}")
            _metrics.record_fault("device_fatal_classified")
        elif ev.cls == _health.ERROR_AMBIGUOUS and mesh:
            for c in placement_chips():
                chipreg.record_suspicion(
                    c, _health.AMBIGUOUS_SUSPICION,
                    f"ambiguous device error: {ev.reason}")
        inflight = [i for r2 in outstanding for i in r2.idxs
                    if not decided[i]]
        old_dev = dev
        if try_reform(undecided + inflight):
            # The old lane is healthy as a thread, just pointed at a
            # placement with a dead chip: its leftovers are discarded.
            for r2 in outstanding:
                old_dev.discard(r2.cid)
            outstanding.clear()
            return
        if ev.cls == _health.ERROR_FATAL:
            health.note_deadline_miss()  # cool the failed rung down
        fail(f"a device call on {where} failed ({ev.cls}: {ev.reason})"
             + ("; no reformation rung left" if mesh else ""), err)

    def call_deadline(rec) -> "tuple[float, float]":
        """A chunk's device-call budget and the moment it runs out: the
        deadline clocks the device CALL, not queue time."""
        budget = max(3.0 * ema_per_batch * rec.padded_b, 2.0)
        if ema_is_prior and not msm.shape_completed(
                rec.padded_b, rec.n_lanes, mesh, cached=rec.variant):
            # No measurement yet AND no call of this padded shape has
            # completed: the call pays the device's lazy set-up, and
            # must not be mistaken for a seized device.
            budget = max(budget, 60.0)
        t_start = dev.started_at(rec.cid)
        return budget, ((t_start + budget) if t_start is not None
                        else (rec.t0 + budget + 10.0))

    def poll(block: bool, until: "float | None" = None):
        """Apply finished chunk results; True if progress.  A deadline
        miss abandons the lane, cools the device down and fails the call
        (a mesh with an excluded chip reforms instead).  `until` bounds a
        blocking wait short of the deadline: the race gate's wake-up,
        never a miss."""
        nonlocal ema_per_batch, ema_is_prior
        progress = False
        while outstanding:
            rec = outstanding[0]
            budget, deadline_at = call_deadline(rec)
            t_start = dev.started_at(rec.cid)
            if block and t_start is None:
                # Not visibly started: wait in short slices and re-derive
                # the deadline the moment the worker enters the call.
                with _metrics.span("lane_wait"):
                    while True:
                        wait_end = deadline_at if until is None \
                            else min(deadline_at, until)
                        res = dev.wait(rec.cid, min(
                            0.25, max(0.0, wait_end - now())))
                        if res is not _PENDING:
                            break
                        t_start = dev.started_at(rec.cid)
                        if t_start is not None:
                            deadline_at = t_start + budget
                        if until is not None and now() >= until:
                            break
                        if now() >= deadline_at:
                            break
            elif block:
                wait_end = deadline_at if until is None \
                    else min(deadline_at, until)
                with _metrics.span("lane_wait"):
                    res = dev.wait(rec.cid, max(0.0, wait_end - now()))
            else:
                res = dev.wait(rec.cid, 0.0)
            if res is _PENDING:
                budget, deadline_at = call_deadline(rec)
                if now() < deadline_at:
                    return progress
                health.note_deadline_miss()
                _metrics.record_fault("deadline_miss")
                dev.abandon()
                undecided = [i for r2 in outstanding for i in r2.idxs
                             if not decided[i]]
                for r2 in outstanding:
                    # An abandoned device leg gives no usable result: an
                    # active twin is the pair's decider.
                    hedge_resolve(r2.cid, True)
                outstanding.clear()
                if try_reform(undecided):
                    # A chip died under the in-flight wave: it re-issues
                    # on the reformed rung.
                    return True
                stats["device_sick"] = True
                fail(f"a device call on {stats['device']} missed its "
                     f"{budget:.1f} s deadline", None)
            outstanding.pop(0)
            out, call_dt, err, tally = res
            # A hedge pair resolves when its device leg lands: an errored
            # leg is always the twin's win.
            if out is None and rec.cid in hedged:
                _metrics.record_fault("hedge_device_error")
            hedge_resolve(rec.cid, out is None)
            if out is None:
                on_device_error(rec.idxs, err)
            else:
                stats["device_seconds"] += call_dt
                add_mesh_tally(tally)
                # Timing only: a hedged leg's duration counts too, though
                # its result stays unread where the twin decided.
                record_chunk_latency(call_dt)
                if rec.variant == 3:
                    # Audited mesh chunk: [fold, per-shard partials].  The
                    # audit runs before any of its verdicts publishes.
                    folded, partials = out[0], out[1:]
                    named = sentinel_check(rec, folded, partials)
                    if named is not None:
                        fail(f"sentinel audit of a mesh chunk on "
                             f"{stats['device']} diverged: "
                             + (f"chips {named} named" if named else
                                "fold inconsistent, no chip named")
                             + " (suspicion recorded)", None)
                    out = folded
                # EMA over the device CALL time per PADDED batch.
                per_batch = call_dt / max(1, rec.padded_b)
                ema_per_batch = per_batch if ema_is_prior else (
                    0.6 * ema_per_batch + 0.4 * per_batch)
                ema_is_prior = False
                stats["device_measured"] = True
                decide_on_device(rec.idxs, out)
            progress = True
        return progress

    def device_competitive() -> bool:
        if not _host_times:
            return True  # no host measurement yet: keep probing
        return ema_per_batch < 1.3 * host_median()

    try:
        probed = False
        while remaining or outstanding:
            if remaining and not outstanding and not probed:
                # probe: 2 real batches padded to the full chunk in hybrid
                # mode; forced-device callers' first chunk IS the probe.
                submit(size=min(2, chunk) if hybrid else chunk)
                probed = True
                stats["probed"] = True
            while (remaining and len(outstanding) < 2
                   and (not hybrid or (not ema_is_prior
                                       and device_competitive()))):
                submit()
            poll(block=False)
            if hybrid and remaining and outstanding:
                host_verify_one(remaining.pop())
            elif outstanding and not hybrid:
                poll(block=True)
            elif outstanding:
                ready, wake = race_gate()
                if not ready:
                    # The ledger is armed and no chunk has outlived the
                    # hedge threshold: wait for the device until one does.
                    poll(block=True, until=wake)
                else:
                    # Nothing left in the pool: RACE the in-flight chunks,
                    # re-verifying their batches on the host (last chunk
                    # first), dropping any chunk the host fully overtakes.
                    stole = False
                    for rec in reversed(ready):
                        undecided = [i for i in rec.idxs if not decided[i]]
                        if not undecided:
                            continue
                        if rec.cid in hedged:
                            hedge_wins.add(rec.cid)
                        host_verify_one(undecided[-1])
                        stole = True
                        if len(undecided) == 1:  # chunk fully overtaken
                            # Before dropping an unmeasured young probe,
                            # grace-wait briefly for its timing: the EMA is
                            # what stops pointless re-probing.  A hedged
                            # chunk is late by the ledger's own measure.
                            res = _PENDING
                            grace = health.young_probe_grace
                            t_start = dev.started_at(rec.cid)
                            elapsed = now() - (t_start if t_start is not None
                                               else rec.t0)
                            if ema_is_prior and elapsed < grace \
                                    and rec.cid not in hedged:
                                res = dev.wait(rec.cid, grace - elapsed)
                            outstanding.remove(rec)
                            hedge_resolve(rec.cid, res is _PENDING
                                          or res[0] is None)
                            if res is _PENDING:
                                dev.discard(rec.cid)
                            elif res[0] is None:
                                on_device_error(rec.idxs, res[2])
                            else:
                                record_chunk_latency(res[1])
                                ema_per_batch = res[1] / max(1, rec.padded_b)
                                ema_is_prior = False
                                stats["device_measured"] = True
                        break
                    poll(block=not stole)
            elif remaining and hybrid:
                # The device is not competitive: the host lane takes a batch.
                # A forced-device call whose in-flight chunks all finished in
                # the poll above submits the rest on the next turn instead.
                host_verify_one(remaining.pop())
        return _finish(verdicts)
    finally:
        # However the call leaves (a host-side exception included), no
        # chunk stays outstanding: a lane worker held after an unread
        # error would otherwise start nothing for the next call.
        for r2 in outstanding:
            dev.discard(r2.cid)
        outstanding.clear()


def warm_device_shapes(verifier, rng=None, chunk: int = 8, device=None,
                       mesh: int = 0) -> None:
    """Build and run, OUTSIDE the racing scheduler, the device shapes
    verify_many dispatches for batches shaped like `verifier`: the cold
    (chunk, N) shape and, with the device operand cache on, the
    head-resident and tables-resident shapes — so a call's first chunk
    of each form is held to the normal deadline.  `mesh` > 1 also warms
    the cold mesh dispatch at that width and at its N/2 reformation rung
    (on `device` as a virtual mesh when one is named, else on the cards).
    `device` None means CUDA and raises without one; "cpu" warms the
    plain versions.  A batch that fails staging warms nothing."""
    from .ops import msm
    from .parallel import sharded_msm

    dev = _lane_device(device)
    try:
        staged = verifier._stage(rng)
    except InvalidSignature:
        return
    pad = msm.pad_lanes(staged.n_device_terms)
    d, p = staged.device_operands(lambda n: pad, defer=True)
    with msm.DEVICE_CALL_LOCK:
        msm.dispatch_window_sums_many(
            np.stack([d] * chunk), np.stack([p] * chunk), dev).cpu()
        msm.mark_shape_completed(chunk, pad)
        for rung in (_health.normalize_mesh(mesh),
                     _health.normalize_mesh(mesh) // 2):
            if rung < 2:
                break
            spad = sharded_msm.shard_pad(staged.n_device_terms, rung)
            sd, sp = staged.device_operands(lambda n, spad=spad: spad,
                                            defer=True)
            sharded_msm.sharded_window_sums_many(
                np.stack([sd] * chunk), np.stack([sp] * chunk), rung,
                devices=_rung_placement(rung, device, None)).cpu()
            msm.mark_shape_completed(chunk, spad, rung)
        if not _devcache.default_cache().enabled:
            return
        head = staged.head_tensor()
        n_head = head.shape[-1]
        nr = msm.pad_lanes(staged.n_cached_terms) - n_head
        dc, rw = staged.device_operands_cached(lambda n: n_head + nr)
        ddc, rr = np.stack([dc] * chunk), np.stack([rw] * chunk)
        msm.dispatch_window_sums_many_cached(ddc, head, rr, dev).cpu()
        msm.mark_shape_completed(chunk, n_head + nr, cached=1)
        if _config.get("ED25519_TPU_DEVCACHE_TABLES"):
            msm.dispatch_window_sums_many_tables(
                ddc, staged.head_tables_tensor(), rr, dev).cpu()
            msm.mark_shape_completed(chunk, n_head + nr, cached=2)


def run_probation_probe(verifier, chip: int, rng=None,
                        device=None) -> "bool | None":
    """One probation probe of `chip`: stage `verifier` on the host,
    dispatch its MSM as one single-device call placed on `chip` — on
    `device` when named (a logical chip there: a one-card machine probes
    chip `chip` on cuda:0, the tests on "cpu"), else on cuda:<chip> —
    under DEVICE_CALL_LOCK, through the fault seam with payload (chip,)
    and timed on the registry clock, and compare the combined window sums
    with the host MSM of the same staged terms as group elements.

    * equal sums within the latency gate (LatencyLedger.within_gate): a
      probation PASS, True (after ED25519_TPU_PROBATION_PROBES in a row
      the chip rejoins);
    * a divergence, a probe over the gate, or ANY dispatch failure: a
      FAIL, False — the chip goes back to quarantine; nothing raises;
    * staging that rejects the batch: None, nothing recorded.

    The probe's verifier is probe traffic, never production work, and the
    chip under probation decides nothing: the comparison is exact host
    math.  `device` None means CUDA and raises without one (a caller
    error, not evidence against the chip)."""
    import torch

    from .ops import msm

    reg = _health.chip_registry()
    chip = int(chip)
    dev = (_indexed(device) if device is not None
           else msm.resolve_device(torch.device("cuda", chip)))
    try:
        staged = verifier._stage(rng)
    except InvalidSignature:
        return None
    expected = staged.host_msm()
    try:
        pad = msm.pad_lanes(staged.n_device_terms)
        d, p = staged.device_operands(lambda n: pad, defer=True)

        def probe_call():
            if dev.type == "cuda":
                with torch.cuda.device(dev):
                    return msm.dispatch_window_sums_many(
                        d[None], p[None], dev).cpu().numpy()
            return msm.dispatch_window_sums_many(d[None], p[None],
                                                 dev).numpy()

        with msm.DEVICE_CALL_LOCK:
            t_probe = reg.clock.monotonic()
            out = np.asarray(_faults.run_device_call(
                _faults.SITE_LANE, probe_call, clock=reg.clock, mesh=0,
                payload=(chip,)))
            probe_dt = reg.clock.monotonic() - t_probe
        got = msm.combine_window_sums(out[0])
    except Exception:
        # An erroring chip is not a clean chip: a fail, never propagated.
        reg.record_probation_fail(chip, reason="probe dispatch failed")
        _metrics.record_fault("probation_probe_failed")
        return False
    if got != expected:
        reg.record_probation_fail(chip, reason="probe sum divergence")
        _metrics.record_fault("probation_probe_failed")
        return False
    if not reg.latency.within_gate(probe_dt):
        # Right but slow is still the mesh's gray failure.
        reg.record_probation_fail(
            chip, weight=_health.STRAGGLER_SUSPICION,
            reason="probation probe over latency gate")
        _metrics.record_fault("probation_probe_latency_failed")
        return False
    rejoined = reg.record_probation_pass(chip)
    _metrics.record_fault("probation_probe_passed")
    if rejoined:
        _metrics.record_fault("chip_rejoined")
    return True


def verify_single_many(entries, rng=None, device=None) -> "list[bool]":
    """Per-SIGNATURE verdicts for many independent (vk_bytes, sig, msg)
    entries at batch-verification speed: each entry becomes a
    one-signature batch, verify_many union-merges them into one RLC
    equation and bisects failures.  A malformed entry (bad encoding,
    s ≥ ℓ, wrong-length bytes) is verdict False, never an exception."""
    entries = list(entries)
    staging = Verifier()  # challenge-hash all entries in one native call
    cleaned = []
    for vkb, sig, msg in entries:
        try:
            if not isinstance(vkb, VerificationKeyBytes):
                vkb = VerificationKeyBytes(vkb)
            if not isinstance(sig, Signature):
                sig = Signature.from_bytes(sig)
            cleaned.append((vkb, sig, msg))
        except Exception:
            cleaned.append(None)  # malformed wire bytes: verdict False
    staging.queue_bulk([e for e in cleaned if e is not None])
    # queue_bulk grouped by key in entry order, so per-key iterators hand
    # each entry its own (k, sig) back in order.
    by_key = {vkb: iter(ksigs)
              for vkb, ksigs in staging._materialized().items()}
    verifiers = []
    for e in cleaned:
        v = Verifier()
        v.batch_size = 1
        if e is None:
            v.invalidate("malformed wire bytes")
        else:
            v.signatures[e[0]] = [next(by_key[e[0]])]
        verifiers.append(v)
    return verify_many(verifiers, rng=rng, merge="always", device=device)
