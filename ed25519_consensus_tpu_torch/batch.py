"""Batch verification with ZIP215 semantics and a host or H100 MSM backend
(reference src/batch.rs).

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
dispatched, to the exact host Straus (`backend="host"`) or the CUDA kernels
(`backend="device"`, ops/msm.py).  Host staging here is exact Python."""

import hashlib
import secrets
import time

import numpy as np

from .error import InvalidSignature
from .ops import edwards, limbs, scalar
from .ops.field import P
from .ops.scalar import L
from .signature import Signature
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


# [2^128]A per verification key, for the device MSM's uniform-128-bit
# scalar split (ops/msm.py), as (affine point, encoding, hint).  Keyed by
# the 32-byte encoding; values are deterministic, so never stale.
_shift128_cache = {}
_SHIFT_CACHE_MAX = 1 << 16


def _shift128_for_key(vk_bytes: bytes, A_row) -> "tuple":
    sp = _shift128_cache.get(vk_bytes)
    if sp is None:
        pt = edwards.shift128(_point_from_row(A_row)).to_affine()
        enc, hint = edwards.compress_with_hint(pt)
        sp = (pt, enc, hint)
        if len(_shift128_cache) >= _SHIFT_CACHE_MAX:
            _shift128_cache.pop(next(iter(_shift128_cache)), None)
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
    * keyset_blob: the 32-byte key encodings in group-id order."""

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

    def host_msm(self):
        """The host-backend MSM over the staged terms (exact Python
        Straus)."""
        n = self.n_sigs
        zs = [int.from_bytes(self.z_blob[16 * i: 16 * i + 16], "little")
              for i in range(n)]
        return edwards.multiscalar_mul(
            list(self.coeffs) + zs,
            [_point_from_row(r) for r in self.raw_points])

    def device_operands(self, pad_fn):
        """The padded device operands: nibble-packed signed digit planes,
        (PACKED_WINDOWS, N) uint8, and the compressed point wire, (33, N)
        uint8 of 32-byte y encodings + flip/neg hint bytes (x is recomputed
        on the device, ops/torch_decompress.py).

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
        digits = limbs.pack_digit_planes(digits)
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
        return digits, w


class Verifier:
    """A batch verification context (reference src/batch.rs:110-218).

    `signatures` is the public coalescing map, vk_bytes -> [(k, sig), ...],
    in first-seen key order (reference src/batch.rs:112-118).  Queueing
    also appends to flat queue-order buffers (s, R, challenge and a group
    id per signature), which staging consumes without regrouping.  Handing
    the map out (reading or assigning `signatures`) makes it authoritative:
    an outside reference could change it without changing its size, so
    staging then takes the grouped walk over the map."""

    def __init__(self):
        self._sig_map = {}
        self._map_exposed = False
        self.batch_size = 0
        self._s_buf = bytearray()
        self._r_buf = bytearray()
        self._k_buf = bytearray()
        self._gid = []
        self._key_index = {}

    @property
    def signatures(self):
        self._map_exposed = True
        return self._sig_map

    @signatures.setter
    def signatures(self, value):
        self._sig_map = value
        self._map_exposed = True

    def queue(self, item) -> None:
        """Queue an `Item` or `(vk_bytes, sig, msg)` tuple (reference
        src/batch.rs:127-137)."""
        item = _as_item(item)
        self._sig_map.setdefault(item.vk_bytes, []).append(
            (item.k, item.sig))
        self.batch_size += 1
        ki = self._key_index
        self._gid.append(ki.setdefault(item.vk_bytes, len(ki)))
        self._s_buf += item.sig.s_bytes
        self._r_buf += item.sig.R_bytes
        self._k_buf += item.k.to_bytes(32, "little")

    def queue_bulk(self, entries) -> None:
        """Queue many `(vk_bytes, sig, msg)` entries; the challenge hashes
        k = H(R‖A‖msg) are computed with hashlib, exactly as `queue`
        computes them one at a time."""
        for vkb, sig, msg in entries:
            self.queue(Item.new(vkb, sig, msg))

    # -- staging (host, exact) --------------------------------------------

    def _buffers_live(self) -> bool:
        """True when the queue-order buffers are authoritative: the map
        was never handed out and every buffer matches the queued count."""
        n = self.batch_size
        return (not self._map_exposed
                and len(self._s_buf) == 32 * n
                and len(self._r_buf) == 32 * n
                and len(self._k_buf) == 32 * n
                and len(self._gid) == n)

    def _stage(self, rng) -> "StagedBatch":
        """Host staging: decompress all points, enforce `s < ℓ`, sample
        blinders, coalesce per-key A coefficients.  Raises InvalidSignature
        on ANY malformed input — before any device dispatch (all-or-nothing
        semantics, reference src/batch.rs:139-147, 182-203).  The
        queue-order path and the grouped walk give the same MSM (it is
        order-independent); the grouped walk serves a map changed from
        outside."""
        if self._buffers_live():
            keys = list(self._key_index)
            r_blob = bytes(self._r_buf)
            s_blob = bytes(self._s_buf)
            k_blob = bytes(self._k_buf)
            gid = self._gid
        else:
            groups = list(self._sig_map.items())
            keys = [vkb for vkb, _ in groups]
            r_blob = b"".join(sig.R_bytes for _, sigs in groups
                              for _, sig in sigs)
            s_blob = b"".join(sig.s_bytes for _, sigs in groups
                              for _, sig in sigs)
            k_blob = b"".join(
                k.to_bytes(32, "little") if type(k) is int else bytes(k)
                for _, sigs in groups for k, _ in sigs)
            gid = [g for g, (_, sigs) in enumerate(groups) for _ in sigs]
        n = len(gid)
        m = len(keys)
        keyset_blob = b"".join(k.to_bytes() for k in keys)
        blob = keyset_blob + r_blob
        raw, ok, hints = decompress_buffer(blob, m + n)
        if not ok.all():
            raise InvalidSignature()
        enc32 = np.frombuffer(blob, dtype=np.uint8).reshape(m + n, 32)
        if rng is None:
            z_blob = secrets.token_bytes(16 * n)
        else:
            z_blob = rng.getrandbits(128 * n).to_bytes(16 * n, "little") \
                if n else b""
        B_acc = 0
        A_accs = [0] * m
        for i in range(n):
            s = int.from_bytes(s_blob[32 * i: 32 * i + 32], "little")
            if s >= L:
                raise InvalidSignature()  # ZIP215 rule 2
            k = int.from_bytes(k_blob[32 * i: 32 * i + 32], "little")
            z = int.from_bytes(z_blob[16 * i: 16 * i + 16], "little")
            B_acc += z * s
            A_accs[gid[i]] += z * k
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
               timings=None) -> None:
        """Verify all queued signatures; raises InvalidSignature unless ALL
        are valid (reference src/batch.rs:149-217).

        `backend` selects where the bulk MSM runs: "device" (the default) —
        the window-sum kernels on `device` (None means CUDA, and raises
        without one; "cpu" runs their plain PyTorch versions); "host" —
        exact Straus in Python, only when asked for.  Both are
        verdict-equivalent by construction.

        `timings`, if a dict, receives wall seconds: "stage_host" (staging
        and operand packing), then for the device backend "device" (the
        device call, copies included) and "combine" (Horner combine and
        cofactor check), for the host backend "msm_host" (MSM and cofactor
        check)."""
        if timings is None:
            timings = {}
        if backend not in ("host", "device"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "device":
            from .ops import msm

            dev = msm.resolve_device(device)
        t0 = time.perf_counter()
        staged = self._stage(rng)
        if backend == "host":
            t1 = time.perf_counter()
            timings["stage_host"] = t1 - t0
            check = staged.host_msm()
            last = "msm_host"
        else:
            digits, wire = staged.device_operands(msm.pad_lanes)
            t1 = time.perf_counter()
            timings["stage_host"] = t1 - t0
            ws = msm.PendingMSM(
                msm.dispatch_window_sums(digits, wire, dev)).window_sums()
            t2 = time.perf_counter()
            timings["device"] = t2 - t1
            t1 = t2
            check = msm.combine_window_sums(ws)
            last = "combine"
        # Final cofactored identity check: host-exact, always.
        ok = check.mul_by_cofactor().is_identity()
        timings[last] = time.perf_counter() - t1
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
