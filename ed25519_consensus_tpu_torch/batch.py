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
import time

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
from .utils.metrics import BatchMetrics
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
    """Concatenated raw 128-byte rows for `keys`, via the cache; misses
    are decompressed in one native call.  None if any key fails ZIP215
    decompression (the batch rejects)."""
    rows = [_key_row_cache.get(k.to_bytes()) for k in keys]
    missing = [i for i, r in enumerate(rows) if r is None]
    if missing:
        raw, ok, _ = _decompress(
            b"".join(keys[i].to_bytes() for i in missing), len(missing))
        if not ok.all():
            return None
        for j, i in enumerate(missing):
            row = raw[j].tobytes()
            if len(_key_row_cache) >= _KEY_ROW_CACHE_MAX:
                _evict_one(_key_row_cache)
            _key_row_cache[keys[i].to_bytes()] = row
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
    for k in keys:
        kb = k.to_bytes()
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
    """(key_rows, split) for an ordered keyset via the blob cache; None
    when a key fails decompression."""
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
      [2^128]·point split terms (basepoint constant + per-key cache).
    * z_blob: the n per-signature 128-bit blinders as 16-byte
      little-endian rows (bytes, n×16).
    * raw_points: ((1+m+n), 128) uint8 — canonical X‖Y‖Z‖T rows for
      [B, A_0..A_{m-1}, R_0..R_{n-1}].
    * enc32 / hints: the (m+n, 32) uint8 original compressed encodings
      for [A..., R...] and their (m+n,) device flip/neg hint bytes — the
      33 B/term compressed device wire.
    * keyset_blob: the 32-byte key encodings in group-id order, the
      content address of the device operand cache."""

    __slots__ = ("coeffs", "coeff_shifts", "z_blob", "raw_points",
                 "enc32", "hints", "keyset_blob")

    def __init__(self, coeffs, coeff_shifts, z_blob, raw_points,
                 enc32, hints, keyset_blob=None):
        self.coeffs = coeffs
        self.coeff_shifts = coeff_shifts
        self.z_blob = z_blob
        self.raw_points = raw_points
        self.enc32 = enc32
        self.hints = hints
        self.keyset_blob = keyset_blob

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

    def device_operands(self, pad_fn):
        """The padded device operands: signed digit planes — (17, N) uint8
        nibble-packed, or (33, N) int8 with ED25519_TPU_DIGIT_WIRE=plain —
        and the compressed point wire, (33, N) uint8 of 32-byte y
        encodings + flip/neg hint bytes (x is recomputed on the device).

        Coefficients split into 128-bit chunks against their cached shift
        points.  Term order: [coeffs..., split-highs..., R's...]; padding
        terms are digit 0 on the identity encoding."""
        mask = (1 << 128) - 1
        lo = [c & mask for c in self.coeffs]
        hi_s, hi_p = [], []
        for c, sp in zip(self.coeffs, self.coeff_shifts):
            h = c >> 128
            if h:
                hi_s.append(h)
                hi_p.append(sp)
        n_coeff = len(lo)
        n_head = n_coeff + len(hi_s)
        n = n_head + self.n_sigs
        N = pad_fn(n)
        digits = np.zeros((limbs.NWINDOWS, N), dtype=np.int8)
        digits[:, :n_coeff] = limbs.pack_scalar_windows(lo)
        if hi_s:
            digits[:, n_coeff:n_head] = limbs.pack_scalar_windows(hi_s)
        if self.n_sigs:
            zb = np.frombuffer(self.z_blob, dtype=np.uint8).reshape(
                self.n_sigs, 16)
            digits[:, n_head:n] = limbs.pack_u128_windows(zb)
        m = n_coeff - 1  # distinct keys among the coefficient terms
        w = limbs.identity_wire_batch(N)
        b_enc, b_hint = _basepoint_wire()
        w[:32, 0] = np.frombuffer(b_enc, dtype=np.uint8)
        w[32, 0] = b_hint
        if m:
            w[:32, 1:n_coeff] = self.enc32[:m].T
            w[32, 1:n_coeff] = self.hints[:m]
        for j, sp in enumerate(hi_p):
            w[:32, n_coeff + j] = np.frombuffer(sp[1], dtype=np.uint8)
            w[32, n_coeff + j] = sp[2]
        w[:32, n_head:n] = self.enc32[m:].T
        w[32, n_head:n] = self.hints[m:]
        return _digits_for_wire(digits), w


def _draw_blinders(rng, n: int) -> bytes:
    if rng is None:
        return secrets.token_bytes(16 * n)
    return rng.getrandbits(128 * n).to_bytes(16 * n, "little") if n else b""


class Verifier:
    """A batch verification context (reference src/batch.rs:110-218).

    `signatures` is the public coalescing map, vk_bytes -> [(k, sig), ...]
    in first-seen key order; `k` is an int (`queue`) or a 32-byte
    little-endian buffer (`queue_bulk`'s one-native-call hash path).  The
    map is LAZY: queued entries park in `_pending` and materialize on
    first access.  Queueing also appends to flat queue-order buffers (s,
    R, challenge and an int32 group id per signature), which staging
    consumes without regrouping.  Handing the map out (reading or
    assigning `signatures`) makes it authoritative: an outside reference
    could change it without changing its size, so staging then takes the
    grouped walk over the map."""

    def __init__(self):
        self._sig_map = {}
        self._pending = []
        self._map_exposed = False
        self.batch_size = 0
        self._s_buf = bytearray()
        self._r_buf = bytearray()
        self._k_buf = bytearray()
        self._gid = _array.array("i")
        self._key_index = {}
        self._invalid = None

    @property
    def signatures(self):
        m = self._materialized()
        self._map_exposed = True
        return m

    @signatures.setter
    def signatures(self, value):
        self._sig_map = value
        self._pending = []
        self._map_exposed = True

    def _materialized(self):
        """The coalescing map with pending entries folded in, WITHOUT
        marking it exposed (in-package readers that neither mutate nor
        leak it)."""
        if self._pending:
            self._materialize()
        return self._sig_map

    def _materialize(self) -> None:
        pending, self._pending = self._pending, []
        sd = self._sig_map.setdefault
        for vkbs, sigs, ks in pending:
            if isinstance(ks, (bytes, bytearray, memoryview)):
                kmv = memoryview(ks)
                for i, (vkb, sig) in enumerate(zip(vkbs, sigs)):
                    sd(vkb, []).append((kmv[32 * i: 32 * i + 32], sig))
            else:
                for vkb, sig, k in zip(vkbs, sigs, ks):
                    sd(vkb, []).append((k, sig))

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
            return b"".join(k.to_bytes() for k in self._key_index)
        return b"".join(k.to_bytes() for k in self._materialized())

    def content_digest(self) -> "bytes | None":
        """SHA-256 over the queued batch's canonical content (batch size,
        keyset blob, group ids, the s/R/k buffers): two verifiers share a
        digest iff they received byte-identical queue streams.  None when
        the digest cannot vouch for the contents (map exposed, or
        `invalidate()`d)."""
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
        nv._pending = list(self._pending)
        nv._map_exposed = self._map_exposed
        nv.batch_size = self.batch_size
        nv._s_buf = bytearray(self._s_buf)
        nv._r_buf = bytearray(self._r_buf)
        nv._k_buf = bytearray(self._k_buf)
        nv._gid = self._gid[:]
        nv._key_index = dict(self._key_index)
        nv._invalid = self._invalid
        return nv

    def queue(self, item) -> None:
        """Queue an `Item` or `(vk_bytes, sig, msg)` tuple (reference
        src/batch.rs:127-137)."""
        item = _as_item(item)
        self._pending.append(((item.vk_bytes,), (item.sig,), (item.k,)))
        self.batch_size += 1
        ki = self._key_index
        self._gid.append(ki.setdefault(item.vk_bytes, len(ki)))
        self._s_buf += item.sig.s_bytes
        self._r_buf += item.sig.R_bytes
        self._k_buf += item.k.to_bytes(32, "little")

    def queue_bulk(self, entries) -> None:
        """Queue many `(vk_bytes, sig, msg)` entries with ONE native call
        for all the challenge hashes; the same result as `queue` in a
        loop, which is what runs without the native runtime."""
        entries = entries if isinstance(entries, list) else list(entries)
        if not entries:
            return
        vkbs, sigs, msgs, ra_parts = [], [], [], []
        for vkb, sig, msg in entries:
            if not isinstance(vkb, VerificationKeyBytes):
                vkb = VerificationKeyBytes(vkb)
            vkbs.append(vkb)
            sigs.append(sig)
            msgs.append(msg)
            ra_parts.append(sig.R_bytes)
            ra_parts.append(vkb.to_bytes())
        kblob = native.bulk_challenges(b"".join(ra_parts), msgs, raw=True)
        if kblob is NotImplemented:
            for vkb, sig, msg in zip(vkbs, sigs, msgs):
                self.queue(Item.new(vkb, sig, msg))
            return
        self._pending.append((vkbs, sigs, kblob))
        ki = self._key_index
        gid_append = self._gid.append
        for vkb in vkbs:
            gid_append(ki.setdefault(vkb, len(ki)))
        self._r_buf += b"".join(ra_parts[0::2])
        self._s_buf += b"".join([sig.s_bytes for sig in sigs])
        self._k_buf += kblob
        self.batch_size += len(entries)

    # -- staging (host, exact) --------------------------------------------

    def _buffers_live(self) -> bool:
        """True when the queue-order buffers are authoritative: the map
        was never handed out, every buffer matches the queued count, and
        every materialized key is one the queue path created."""
        if self._map_exposed:
            return False
        n = self.batch_size
        if not (len(self._s_buf) == 32 * n and len(self._r_buf) == 32 * n
                and len(self._k_buf) == 32 * n and len(self._gid) == n):
            return False
        if self._pending:
            queued = sum(len(p[0]) for p in self._pending) + sum(
                len(lst) for lst in self._sig_map.values())
            return queued == n and all(
                k in self._key_index for k in self._sig_map)
        return len(self._key_index) == len(self._sig_map)

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
            keys = list(self._key_index)
            r_blob = bytes(self._r_buf)
            s_buf, k_buf, gid = self._s_buf, self._k_buf, self._gid
        else:
            groups = list(self._materialized().items())
            keys = [vkb for vkb, _ in groups]
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
        m = len(keys)
        keyset_blob = b"".join(k.to_bytes() for k in keys)
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
        A_shifts = [_shift128_for_key(k.to_bytes(), row)
                    for k, row in zip(keys, raw[:m])]
        return StagedBatch(
            coeffs=[(-B_acc) % L] + [a % L for a in A_accs],
            coeff_shifts=[_basepoint_shift_triple()] + A_shifts,
            z_blob=z_blob,
            raw_points=np.concatenate([_B_RAW_ROW, raw], axis=0),
            enc32=enc32,
            hints=hints,
            keyset_blob=keyset_blob,
        )

    # -- verification ------------------------------------------------------

    def verify(self, rng=None, backend: str = "device", device=None,
               timings=None, metrics=None) -> None:
        """Verify all queued signatures; raises InvalidSignature unless ALL
        are valid (reference src/batch.rs:149-217).

        `backend` selects where the bulk MSM runs: "device" (the default) —
        the window-sum kernels on `device` (None means CUDA, and raises
        without one; "cpu" runs their plain PyTorch versions); "host" —
        the host MSM, only when asked for: one fused native call
        (decompression, staging, MSM, cofactor check) when the runtime is
        loaded and the queue-order buffers are live.  Both are
        verdict-equivalent by construction.

        `timings`, if a dict, receives wall seconds per stage:
        "stage_host", then "device" and "combine" for the device backend,
        "msm_host" (or "host_fused") for the host backend.  `metrics`, if
        a `utils.metrics.BatchMetrics`, is filled likewise."""
        if metrics is None:
            metrics = BatchMetrics()
        if backend not in ("host", "device"):
            raise ValueError(f"unknown backend {backend!r}")
        try:
            self._verify(rng, backend, device, metrics)
        finally:
            if timings is not None:
                timings.update(metrics.stage_seconds)

    def _verify(self, rng, backend, device, metrics) -> None:
        t0 = time.perf_counter()
        metrics.backend = backend
        metrics.batch_size = self.batch_size
        metrics.distinct_keys = self.distinct_key_count
        if backend == "device":
            from .ops import msm

            dev = msm.resolve_device(device)
        if self._invalid is not None:
            raise InvalidSignature()
        n = self.batch_size
        if backend == "host" and n and self._buffers_live() \
                and native.load() is not None:
            z_blob = _draw_blinders(rng, n)
            with metrics.stage("host_fused"):
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
            metrics.total_seconds = time.perf_counter() - t0
            if res is not True:  # None = staging reject, False = equation
                raise InvalidSignature()
            return
        with metrics.stage("stage_host"):
            staged = self._stage(rng)
            if backend == "device":
                digits, wire = staged.device_operands(msm.pad_lanes)
        metrics.msm_terms = staged.n_terms
        if backend == "host":
            with metrics.stage("msm_host"):
                ok = staged.host_msm().mul_by_cofactor().is_identity()
        else:
            with metrics.stage("device"):
                ws = msm.PendingMSM(
                    msm.dispatch_window_sums(digits, wire, dev)
                ).window_sums()
            with metrics.stage("combine"):
                # Final cofactored identity check: host-exact, always.
                ok = msm.combine_window_sums(ws).mul_by_cofactor() \
                    .is_identity()
        metrics.total_seconds = time.perf_counter() - t0
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
        digits, wire = staged.device_operands(msm.pad_lanes)
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
    (launches + blocking fetch) of verify_many on one device.  verify_many
    submits pre-packed chunk operands and polls for results; a lane whose
    worker is stuck is abandoned (left to die with the process) and a
    fresh lane is created after the health cooldown."""

    # One lane per device: concurrent callers on different devices must
    # not tear down each other's lane mid-call.
    _instances = {}
    # Abandoned-but-possibly-alive lanes: never handed out again, but the
    # atexit drain still retries their workers (a live worker at
    # interpreter teardown can abort the process).
    _abandoned_instances = []
    _instance_lock = threading.Lock()

    @classmethod
    def get(cls, device, health: "DeviceHealth | None" = None
            ) -> "_DeviceLane":
        """The device's lane.  On a CUDA device every kernel is built and
        loaded first, so a build or load failure raises in the caller's
        thread and never reaches the worker."""
        import torch

        device = torch.device(device)
        if device.type == "cuda":
            from .ops import _cuda

            _cuda.load_all()
        key = str(device)
        if health is None:
            health = _health.health_for(0)
        with cls._instance_lock:
            inst = cls._instances.get(key)
            if inst is not None and inst.healthy() \
                    and inst._health is not health:
                # A caller injected a different health/clock (tests):
                # retire the old worker (its queue drains to the poison
                # sentinel) and build a lane on the new one.
                inst._q.put(None)
                inst._abandoned = True
                if inst._thread.is_alive() \
                        and inst not in cls._abandoned_instances:
                    cls._abandoned_instances.append(inst)
                inst = None
            if inst is None or not inst.healthy():
                inst = cls(device, health=health)
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

    def __init__(self, device, health: "DeviceHealth | None" = None):
        import torch

        self._device = torch.device(device)
        self._health = health if health is not None \
            else _health.health_for(0)
        self._clock = self._health.clock
        self._q = queue.Queue()
        self._results = {}
        self._discarded = set()
        self._started = {}  # cid -> monotonic time the device call began
        self._cv = threading.Condition()
        self._next_id = 0
        self._abandoned = False
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="ed25519-device-lane")
        self._thread.start()

    def healthy(self) -> bool:
        return self._thread.is_alive() and not self._abandoned

    def submit(self, digits, pts, cached=None, tables=None) -> int:
        """Queue one chunk dispatch.  Cold path: `digits`/`pts` are the
        full staged operands.  Cached path (`cached` = the looked-up head
        entry): `pts` is the per-signature R wire and `digits` the
        full-lane digit planes; the worker takes the head tensor from the
        entry.  `tables` (the looked-up kind="tables" entry) upgrades the
        cached dispatch to the tables-resident one."""
        with self._cv:
            cid = self._next_id
            self._next_id += 1
        self._q.put((cid, digits, pts, cached, tables))
        return cid

    def discard(self, cid: int) -> None:
        """The caller no longer wants this result (it decided on the
        host): drop it on arrival, or skip the call if it has not
        started."""
        with self._cv:
            self._started.pop(cid, None)
            if cid in self._results:
                del self._results[cid]
            else:
                self._discarded.add(cid)

    def started_at(self, cid: int):
        """Monotonic time the worker ENTERED the device call for `cid`, or
        None while it is still queued."""
        with self._cv:
            return self._started.get(cid)

    def wait(self, cid: int, timeout: float):
        """(result array or None on device error, call seconds, error)
        tuple, or _PENDING on timeout.  The deadline runs on the lane's
        health clock; a VIRTUAL clock only advances explicitly, so the
        wait polls in short real slices instead of sleeping."""
        clock = self._clock
        end = clock.monotonic() + timeout
        with self._cv:
            while cid not in self._results:
                left = end - clock.monotonic()
                if left <= 0:
                    return (self._results.pop(cid)
                            if cid in self._results else _PENDING)
                self._cv.wait(0.01 if clock.virtual else left)
            return self._results.pop(cid)

    def abandon(self) -> None:
        self._abandoned = True
        with type(self)._instance_lock:
            key = str(self._device)
            if type(self)._instances.get(key) is self:
                del type(self)._instances[key]
            if (self._thread.is_alive()
                    and self not in type(self)._abandoned_instances):
                type(self)._abandoned_instances.append(self)
        self._health.mark_lane_stuck()

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop the worker before interpreter teardown."""
        self._q.put(None)
        self._thread.join(timeout)

    def _dispatch(self, digits, pts, cached, tables):
        """(the chunk's call, its compile-grace variant)."""
        from .ops import msm as _msm

        dev = self._device
        if cached is not None and tables is not None:
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

        return fetch, variant

    def _run(self):
        from .ops import msm as _msm

        clock = self._clock
        while True:
            item = self._q.get()
            if item is None:
                return
            cid, digits, pts, cached, tables = item
            with self._cv:
                if cid in self._discarded:
                    # the caller already decided on the host: don't spend
                    # a device call on it
                    self._discarded.discard(cid)
                    continue
            t_call = None
            try:
                with _msm.DEVICE_CALL_LOCK:
                    t_call = clock.monotonic()
                    with self._cv:
                        self._started[cid] = t_call
                    fetch, variant = self._dispatch(digits, pts, cached,
                                                    tables)
                    # Every device call passes through the fault seam (a
                    # no-op unless a faults.FaultPlan is installed).
                    out = np.asarray(_faults.run_device_call(
                        _faults.SITE_LANE, fetch, clock=clock))
                # Fetch done: any first-use build for this shape is over,
                # so later calls are held to the normal deadline.
                _msm.mark_shape_completed(digits.shape[0], digits.shape[2],
                                          cached=variant)
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
                    self._results[cid] = (out, call_dt, err)
                self._cv.notify_all()


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
    dict work).  Queue-order buffers merge too (byte concat + a per-key
    group-id remap), so unions keep the fast staging path; members with
    inconsistent buffers leave the union on the grouped walk."""
    group = list(group)
    u = Verifier()
    for v in group:
        if v._invalid is not None:
            u._invalid = v._invalid  # an invalid member fails the union
            break
    buffers_ok = all(v._buffers_live() for v in group)
    if buffers_ok and all(not v._sig_map for v in group):
        for v in group:
            u._pending.extend(v._pending)
            u.batch_size += v.batch_size
    else:
        um = u._materialized()
        for v in group:
            for vkb, sigs in v._materialized().items():
                um.setdefault(vkb, []).extend(sigs)
            u.batch_size += v.batch_size
    if buffers_ok:
        ki = u._key_index
        for v in group:
            lut = np.empty(max(1, len(v._key_index)), np.int32)
            for vkb, g in v._key_index.items():
                lut[g] = ki.setdefault(vkb, len(ki))
            u._s_buf += v._s_buf
            u._r_buf += v._r_buf
            u._k_buf += v._k_buf
            if len(v._gid):
                remapped = lut[np.frombuffer(v._gid, dtype=np.int32)]
                u._gid.frombytes(remapped.astype(np.int32).tobytes())
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


# One in-flight chunk as the scheduler tracks it: `variant` is the
# compile-grace key (0 cold, 1 resident-head, 2 resident-tables).
_OutstandingChunk = collections.namedtuple(
    "_OutstandingChunk", ("cid", "idxs", "t0", "padded_b", "n_lanes",
                          "variant"))


def _lane_device(device):
    """The device verify_many's lane runs on — `device` resolved (None
    means CUDA, and raises without one), a CUDA device given its index.
    An excluded device moves the lane to the first surviving device, the
    way the reference reforms onto survivors; with every CUDA device
    excluded by the ChipRegistry it raises DeviceError."""
    import torch

    from .ops import msm

    dev = msm.resolve_device(device)
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.index in _health.chip_registry().excluded_chips():
        rung, ids = _routing.reform_for(1)
        if rung < 1:
            raise DeviceError(
                f"{dev} and every other CUDA device are marked dead")
        dev = torch.device("cuda", ids[0] if ids else 0)
    return dev


def verify_many(verifiers, rng=None, chunk: int = 8, hybrid: bool = True,
                merge: str = "auto", mesh: "int | None" = None,
                health: "DeviceHealth | None" = None,
                device=None) -> "list[bool]":
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
    K2t), or the head-resident dispatch when the tables kind is off or was
    not admitted.

    Returns a verdict per verifier (True = every queued signature valid),
    each decided by the same exact host math as `verify` (a batch that
    fails host staging is simply False).  A device REJECT is never a
    verdict by itself: it is re-decided on the host, so even a corrupted
    device result cannot fail a valid batch.  The host never decides what
    the device failed to: the kernels are built and loaded before the
    lane starts, and a device error is classified
    (health.classify_device_error) — a transient one retries the chunk on
    the device with bounded backoff (twice per call), anything else raises
    DeviceError from it, a fatal one (a sticky CUDA error) after marking
    the device dead and arming its cooldown, never a retry into a dead
    context.  A chunk that misses its deadline abandons the lane, arms the
    cooldown and raises DeviceError; so does a call made during the
    cooldown.  `ED25519_TPU_DISABLE_DEVICE=1` is how a caller asks for the
    host lane alone.

    `mesh`: None (auto) and 0/1 are the single-device lane; a wider mesh
    raises NotImplementedError (the port has no sharded lane yet).
    `device`: None means CUDA, "cpu" runs the kernels' plain versions.
    `health` injects the DeviceHealth and its clock (tests drive deadlines
    with health.FakeClock)."""
    from .ops import msm

    _wall = _health.SYSTEM_CLOCK.monotonic
    verifiers = list(verifiers)
    if merge not in ("auto", "never", "always"):
        raise ValueError(f"unknown merge policy {merge!r}")
    _routing.resolve_mesh(mesh)
    lane_dev = None
    if not _config.get("ED25519_TPU_DISABLE_DEVICE"):
        lane_dev = _lane_device(device)
    if health is None:
        health = _health.health_for(0)
    if lane_dev is not None and verifiers and health.in_cooldown():
        raise DeviceError(
            f"{lane_dev} is cooling down after a failed call (until "
            f"{health.cooldown_until:.1f} on the health clock)")
    do_merge = merge == "always" or (
        merge == "auto" and len(verifiers) >= 2
        and sum(v.batch_size for v in verifiers)
        <= _MERGE_MAX_BATCH * len(verifiers))
    if do_merge:
        groups = _merge_groups(verifiers)
        if len(groups) < len(verifiers):
            unions = [merge_verifiers([verifiers[i] for i in g])
                      for g in groups]
            t0 = _wall()
            union_verdicts = verify_many(
                unions, rng=rng, chunk=chunk, hybrid=hybrid, merge="never",
                mesh=mesh, health=health, device=device)
            stats = dict(last_run_stats)
            verdicts = [False] * len(verifiers)
            for g, ok in zip(groups, union_verdicts):
                if ok:
                    for i in g:
                        verdicts[i] = True
                else:
                    _resolve_union(verifiers, g, verdicts, rng)
            # Lane counters of the inner call are in UNION units.
            stats.update(
                batches=len(verifiers),
                sigs=sum(v.batch_size for v in verifiers),
                merged_unions=len(groups),
                host_unions=stats.pop("host_batches", 0),
                device_unions=stats.pop("device_batches", 0),
                seconds=_wall() - t0)
            last_run_stats.clear()
            last_run_stats.update(stats)
            return verdicts

    # Cache temperature of the call's dominant keyset (non-mutating).
    devcache_cache = _devcache.default_cache()
    devcache_probe = devcache_cache.probe(None)
    if verifiers and devcache_cache.enabled:
        big = max(verifiers, key=_routing.estimate_device_terms)
        devcache_probe = devcache_cache.probe(
            _devcache.keyset_digest(big._canonical_keyset_blob()))
    now = health.now

    verdicts = [False] * len(verifiers)
    remaining = list(range(len(verifiers)))  # tail = host-lane candidates
    _t_begin = _wall()
    stats = {
        "batches": len(verifiers),
        "sigs": sum(v.batch_size for v in verifiers),
        "mesh": 0,
        "device": None if lane_dev is None else str(lane_dev),
        "host_batches": 0,
        "device_batches": 0,
        "device_sick": False,
        "device_measured": False,  # a chunk completed and updated the EMA
        "probed": False,  # a probe chunk was actually dispatched
        "device_errors": 0,  # error chunks (retried, or the call raised)
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
        # Wall seconds by layer: host staging of device chunks, the
        # device calls (launches + fetch), the host combine + cofactor
        # check of device results, and whole host-lane verifications.
        "stage_seconds": 0.0,
        "device_seconds": 0.0,
        "combine_seconds": 0.0,
        "host_seconds": 0.0,
        "seconds": 0.0,
    }

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
        batches are zero digits on identity encodings."""
        if digits.shape[0] >= chunk:
            return digits, pts
        nb = chunk - digits.shape[0]
        digits = np.concatenate(
            [digits, np.zeros((nb,) + digits.shape[1:], digits.dtype)])
        ident = limbs.identity_wire_batch(pts.shape[-1])
        return digits, np.concatenate([pts, np.stack([ident] * nb)])

    def stage_chunk(vs_idx):
        staged, idxs = [], []
        for i in vs_idx:
            s = stage_one(i)
            if s is not None:
                staged.append(s)
                idxs.append(i)
        if not staged:
            return None
        entry, tables_entry = resident_entry_for(staged)
        if entry is not None:
            n_head = entry.n_head
            nr = max(msm.pad_lanes(s.n_cached_terms) for s in staged) \
                - n_head
            ops = [s.device_operands_cached(lambda n, nr=nr: n_head + nr)
                   for s in staged]
        else:
            pad = max(msm.pad_lanes(s.n_device_terms) for s in staged)
            ops = [s.device_operands(lambda n: pad) for s in staged]
            tables_entry = None
        digits, pts = pad_batch_axis(np.stack([d for d, _ in ops]),
                                     np.stack([p for _, p in ops]))
        return idxs, digits, pts, entry, tables_entry

    # Work-stealing pipeline.  The device lane is ONE worker thread that
    # serializes every device call; the main thread stages chunks for it,
    # verifies tail batches on the host in the meantime, and polls.  The
    # device is a PROBATIONARY helper in hybrid mode: a probe chunk
    # measures its per-batch turnaround, and further chunks go out only
    # while it beats the host.  A chunk that misses its deadline (3× the
    # turnaround EMA × batches, 2 s floor) marks the device sick and fails
    # the call.
    if (lane_dev is None or not verifiers
            or (hybrid and not health.device_allowed())):
        while remaining:
            host_verify_one(remaining.pop())
        return _finish(verdicts)
    dev = _DeviceLane.get(lane_dev, health=health)

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

    def _transient_wait():
        """The bounded backoff between transient retries: virtual clocks
        advance, real clocks wait."""
        delay = transient_backoff.arm()
        clk = health.clock
        if getattr(clk, "virtual", False):
            clk.advance(delay)
        else:
            _transient_gate.wait(delay)

    def submit(size=None):
        size = chunk if size is None else size
        ch = remaining[:size]
        del remaining[:size]
        w0 = _wall()
        pending = stage_chunk(ch)
        stats["stage_seconds"] += _wall() - w0
        if pending is None:
            return
        idxs, digits, pts, cached, tables = pending
        cid = dev.submit(digits, pts, cached=cached, tables=tables)
        if cached is not None:
            stats["devcache"]["dispatch_hits"] += 1
        if tables is not None:
            stats["devcache"]["table_dispatch_hits"] += 1
        variant = 0 if cached is None else (2 if tables is not None else 1)
        outstanding.append(_OutstandingChunk(
            cid, idxs, now(), digits.shape[0], digits.shape[2], variant))

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

    def on_device_error(idxs, err) -> None:
        """Classify a chunk's device error: a transient one re-dispatches
        the chunk's undecided batches (fresh blinders, bounded backoff);
        any other fails the call, a fatal one after marking the device
        dead and arming its cooldown."""
        nonlocal probed
        stats["device_errors"] += 1
        _metrics.record_fault("device_error")
        ev = _health.classify_device_error(err)
        stats["error_classes"][ev.cls] += 1
        if ev.cls == _health.ERROR_TRANSIENT and transient_left[0] > 0:
            transient_left[0] -= 1
            stats["transient_retries"] += 1
            _metrics.record_fault("device_transient_retry")
            _transient_wait()
            remaining.extend(i for i in idxs if not decided[i])
            probed = False  # an errored probe measured nothing
            return
        if ev.cls == _health.ERROR_FATAL:
            # The device is gone for this process (a sticky CUDA error
            # poisons its context): mark it dead unless the raiser did,
            # and cool the lane down.  fail() drops the chunks queued
            # behind it unrun: never a retry into a dead context.
            if not ev.marked and lane_dev.type == "cuda":
                for c in (ev.chips or (lane_dev.index,)):
                    _health.chip_registry().mark_chip_dead(
                        c, heal_after=ev.heal_after,
                        reason=f"classified-fatal: {ev.reason}")
            health.note_deadline_miss()
            _metrics.record_fault("device_fatal_classified")
        fail(f"a device call on {lane_dev} failed ({ev.cls}: {ev.reason})",
             err)

    def poll(block: bool):
        """Apply finished chunk results; True if progress.  A deadline
        miss abandons the lane, cools the device down and fails the
        call."""
        nonlocal ema_per_batch, ema_is_prior
        progress = False
        while outstanding:
            rec = outstanding[0]
            budget = max(3.0 * ema_per_batch * rec.padded_b, 2.0)
            if ema_is_prior and not msm.shape_completed(
                    rec.padded_b, rec.n_lanes, 0, cached=rec.variant):
                # No measurement yet AND no call of this padded shape has
                # completed: the call pays the device's lazy set-up, and
                # must not be mistaken for a seized device.
                budget = max(budget, 60.0)
            # The deadline clocks the device CALL, not queue time.
            t_start = dev.started_at(rec.cid)
            deadline = (t_start + budget) if t_start is not None \
                else (rec.t0 + budget + 10.0)
            if block and t_start is None:
                # Not visibly started: wait in short slices and re-derive
                # the deadline the moment the worker enters the call.
                while True:
                    res = dev.wait(rec.cid,
                                   min(0.25, max(0.0, deadline - now())))
                    if res is not _PENDING:
                        break
                    t_start = dev.started_at(rec.cid)
                    if t_start is not None:
                        deadline = t_start + budget
                    if now() >= deadline:
                        break
            else:
                timeout = max(0.0, deadline - now()) if block else 0.0
                res = dev.wait(rec.cid, timeout)
            if res is _PENDING:
                t_start = dev.started_at(rec.cid)
                deadline = (t_start + budget) if t_start is not None \
                    else (rec.t0 + budget + 10.0)
                if now() < deadline:
                    return progress
                health.note_deadline_miss()
                _metrics.record_fault("deadline_miss")
                dev.abandon()
                stats["device_sick"] = True
                fail(f"a device call on {lane_dev} missed its {budget:.1f} s "
                     f"deadline", None)
            outstanding.pop(0)
            out, call_dt, err = res
            if out is None:
                on_device_error(rec.idxs, err)
            else:
                stats["device_seconds"] += call_dt
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
        t_host = sorted(_host_times)[len(_host_times) // 2]
        return ema_per_batch < 1.3 * t_host

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
        elif outstanding:
            if hybrid:
                # Nothing left in the pool: RACE the in-flight chunks,
                # re-verifying their batches on the host (last chunk
                # first), dropping any chunk the host fully overtakes.
                stole = False
                for ci in range(len(outstanding) - 1, -1, -1):
                    rec = outstanding[ci]
                    undecided = [i for i in rec.idxs if not decided[i]]
                    if not undecided:
                        continue
                    host_verify_one(undecided[-1])
                    stole = True
                    if len(undecided) == 1:  # chunk fully overtaken
                        # Before dropping an unmeasured young probe,
                        # grace-wait briefly for its timing: the EMA is
                        # what stops pointless re-probing.
                        res = _PENDING
                        grace = health.young_probe_grace
                        t_start = dev.started_at(rec.cid)
                        elapsed = now() - (t_start if t_start is not None
                                           else rec.t0)
                        if ema_is_prior and elapsed < grace:
                            res = dev.wait(rec.cid, grace - elapsed)
                        outstanding.pop(ci)
                        if res is _PENDING:
                            dev.discard(rec.cid)
                        elif res[0] is None:
                            on_device_error(rec.idxs, res[2])
                        else:
                            ema_per_batch = res[1] / max(1, rec.padded_b)
                            ema_is_prior = False
                            stats["device_measured"] = True
                    break
                poll(block=not stole)
            else:
                poll(block=True)
        elif remaining:
            # hybrid only: a forced-device call submits all it has
            host_verify_one(remaining.pop())
    return _finish(verdicts)


def warm_device_shapes(verifier, rng=None, chunk: int = 8,
                       device=None) -> None:
    """Build and run, OUTSIDE the racing scheduler, the device shapes
    verify_many dispatches for batches shaped like `verifier`: the cold
    (chunk, N) shape and, with the device operand cache on, the
    head-resident and tables-resident shapes — so a call's first chunk
    of each form is held to the normal deadline.  `device` None means
    CUDA and raises without one; "cpu" warms the plain versions.  A batch
    that fails staging warms nothing."""
    from .ops import msm

    dev = _lane_device(device)
    try:
        staged = verifier._stage(rng)
    except InvalidSignature:
        return
    pad = msm.pad_lanes(staged.n_device_terms)
    d, p = staged.device_operands(lambda n: pad)
    with msm.DEVICE_CALL_LOCK:
        msm.dispatch_window_sums_many(
            np.stack([d] * chunk), np.stack([p] * chunk), dev).cpu()
        msm.mark_shape_completed(chunk, pad)
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
