"""Crash-consistent persistence for the verdict memo store: a copy of the
JAX package's `persist.py`, byte for byte in its file format, so a journal
either package writes recovers in the other.

The verdict cache (verdictcache.py) pays for itself on the
mempool→consensus replay stream and would forfeit everything at every
process boundary: an upgrade, an OOM kill, a reboot restart the node cold
when it is most latency-sensitive.  This module makes the memo store
SURVIVE a restart without weakening the consensus rule, by keeping the
disk strictly on the warmth side of the trust ledger:

* **Append-only journal, self-sealed records.**  Every successful store
  appends one record carrying the full content payload, the digest, the
  verdict, the verdict SEAL (verdictcache.verdict_seal), the epoch-pin
  tuple the entry was stored under, and a per-record SHA-256 over the
  framed bytes.
* **Self-describing header.**  The file leads with a magic string, a
  format version and a hashed JSON header pinning the cache namespace, a
  knob fingerprint and the global/tenant epoch pins at write time.
  Version skew, namespace mismatch, knob skew or a header that fails its
  own hash drop the WHOLE file.
* **Trust-disciplined recovery.**  Loading walks the record stream and
  degrades PER RECORD: a torn tail drops the tail; a record whose hash,
  payload re-hash or seal fails drops that record; records staled by a
  later epoch bump (any valid record or the header carries a higher pin)
  drop as stale.  Survivors are ABSORBED through
  `VerdictCache.absorb_entry`, which re-verifies the payload→digest hash
  and the seal again and re-pins the entry under the LIVE epochs; every
  later hit still pays the per-hit re-hash in `lookup()`.  A corrupt disk
  can cost warmth, never a verdict.
* **Atomic compaction.**  When the journal outgrows
  `ED25519_TPU_PERSIST_MAX_BYTES`, the live entries are re-exported
  (`VerdictCache.export_entries`) into a fresh snapshot written to a temp
  file and `os.replace`d over the journal; attach-time compaction scrubs
  corrupt bytes off the disk after each recovery.
* **fsync policy.**  `ED25519_TPU_PERSIST_FSYNC`: `always` (fsync per
  record), `close` (fsync on flush and compaction — the
  `VerifyService.close(drain=True)` path) or `never` (page cache only).
  The policy trades warmth after a crash, nothing else.

Fault seam (`faults.SITE_PERSIST`): every journal append passes through
`faults.run_device_call`, so the `faults.persist_plan` storms corrupt the
on-disk bytes deterministically at a seeded append
(tools/restart_lab.py).  The journal touches the cache only through
`export_entries` / `absorb_entry`, and appends are driven FROM
`VerdictCache.store` after the insert landed.  No module-global mutable
state: a journal is owned by the cache it is attached to.
"""

import hashlib
import json
import os
import struct
import threading

from . import config as _config
from . import faults as _faults
from . import tenancy as _tenancy
from . import verdictcache as _verdictcache
from .utils import metrics as _metrics

__all__ = [
    "FORMAT_VERSION", "VerdictJournal", "attach", "reload",
    "journal_path", "knob_fingerprint", "rewrite_header",
]

MAGIC = b"ed25519-tpu-vjournal\n"
FORMAT_VERSION = 1
_REC_MAGIC = b"VRC1"
_U32 = struct.Struct("<I")
# Knobs whose values change how stored entries are INTERPRETED (not
# merely sized): a journal written under a different regime is dropped
# whole rather than half-understood.  Budget/quota knobs are absent on
# purpose — resizing a cache must not forfeit its disk warmth (the
# absorb path re-applies the live budget discipline anyway).
_FINGERPRINT_KNOBS = ("ED25519_TPU_VERDICT_CACHE_ENABLED",)


def knob_fingerprint() -> str:
    """Hex fingerprint of the interpretation-relevant knob values,
    pinned into every journal header and re-checked at load."""
    parts = [(n, repr(_config.get(n))) for n in _FINGERPRINT_KNOBS]
    return hashlib.sha256(repr(parts).encode()).hexdigest()


def journal_path(directory: str, namespace: str = "") -> str:
    """The journal file for one cache namespace under `directory`: caches
    with their own namespaces get files of their own."""
    ns = namespace or "default"
    return os.path.join(directory, f"verdicts-{ns}.vjournal")


def _encode_header(namespace: str, pins: dict) -> bytes:
    blob = json.dumps(
        {"namespace": namespace, "knobs": knob_fingerprint(),
         "pins": pins},
        sort_keys=True).encode("utf-8")
    head = MAGIC + _U32.pack(FORMAT_VERSION) + _U32.pack(len(blob)) + blob
    return head + hashlib.sha256(head).digest()


def _encode_record(digest: bytes, payload: bytes, verdict: bool,
                   seal: bytes, tenant: str, writer_cls: str,
                   pins) -> bytes:
    meta = json.dumps(
        {"tenant": tenant, "writer_cls": writer_cls,
         "verdict": bool(verdict),
         "pins": [int(p) for p in pins]},
        sort_keys=True).encode("utf-8")
    body = (_U32.pack(len(meta)) + meta + bytes(digest) + bytes(seal)
            + _U32.pack(len(payload)) + bytes(payload))
    framed = _REC_MAGIC + _U32.pack(len(body)) + body
    return framed + hashlib.sha256(framed).digest()


def _parse_header(data: bytes):
    """(header dict, header end offset) or (None, reason) — the
    whole-file gate: anything not provably OUR format at OUR version
    under OUR knob regime is dropped entire."""
    fixed = len(MAGIC) + 2 * _U32.size
    if len(data) < fixed or not data.startswith(MAGIC):
        return None, "bad_magic"
    off = len(MAGIC)
    (version,) = _U32.unpack_from(data, off)
    (blob_len,) = _U32.unpack_from(data, off + _U32.size)
    end = fixed + blob_len + 32
    if version != FORMAT_VERSION:
        return None, "version_skew"
    if blob_len > len(data) - fixed:
        return None, "truncated_header"
    head = data[:fixed + blob_len]
    if hashlib.sha256(head).digest() != data[fixed + blob_len:end]:
        return None, "header_hash"
    try:
        hdr = json.loads(data[fixed:fixed + blob_len].decode("utf-8"))
    except (ValueError, UnicodeDecodeError):
        return None, "header_parse"
    if not isinstance(hdr, dict) or "pins" not in hdr:
        return None, "header_parse"
    return {"header": hdr, "end": end, "version": version}, None


def _parse_records(data: bytes, start: int):
    """Walk the framed record stream from `start`: yields
    (record dict | None, reason | None, next offset).  A reason of
    "torn_tail" terminates the walk (framing can no longer be
    trusted); "record_hash"/"record_parse" drop one record and
    continue on the intact framing."""
    out = []
    off = start
    n = len(data)
    while off < n:
        head_end = off + len(_REC_MAGIC) + _U32.size
        if head_end > n or data[off:off + len(_REC_MAGIC)] != _REC_MAGIC:
            out.append((None, "torn_tail", n))
            break
        (body_len,) = _U32.unpack_from(data, off + len(_REC_MAGIC))
        rec_end = head_end + body_len + 32
        if rec_end > n:
            out.append((None, "torn_tail", n))
            break
        framed = data[off:head_end + body_len]
        if hashlib.sha256(framed).digest() != data[head_end + body_len:
                                                   rec_end]:
            out.append((None, "record_hash", rec_end))
            off = rec_end
            continue
        body = data[head_end:head_end + body_len]
        rec = _decode_body(body)
        if rec is None:
            out.append((None, "record_parse", rec_end))
        else:
            out.append((rec, None, rec_end))
        off = rec_end
    return out


def _decode_body(body: bytes):
    try:
        (meta_len,) = _U32.unpack_from(body, 0)
        off = _U32.size
        meta = json.loads(body[off:off + meta_len].decode("utf-8"))
        off += meta_len
        digest = body[off:off + 32]
        seal = body[off + 32:off + 64]
        off += 64
        (pay_len,) = _U32.unpack_from(body, off)
        off += _U32.size
        payload = body[off:off + pay_len]
        pins = tuple(int(p) for p in meta["pins"])
        if len(digest) != 32 or len(seal) != 32 \
                or len(payload) != pay_len or len(pins) != 4:
            return None
        return {"digest": digest, "seal": seal, "payload": payload,
                "verdict": bool(meta["verdict"]),
                "tenant": str(meta["tenant"]),
                "writer_cls": str(meta["writer_cls"]), "pins": pins}
    except (struct.error, ValueError, KeyError, TypeError,
            UnicodeDecodeError):
        return None


def rewrite_header(path: str, *, version: "int | None" = None,
                   epoch_bump: int = 0) -> bool:
    """Rewrite a journal's header IN PLACE with a self-consistent hash
    — the fault seam's helper (`VersionSkew` / `StaleEpochPins` storms
    must produce a structurally valid header so the load gate under
    test is the version/pin gate, never the hash gate).  Returns False
    when the file has no parseable header to rewrite."""
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError:
        return False
    parsed, _reason = _parse_header(data)
    if parsed is None:
        return False
    hdr = parsed["header"]
    if epoch_bump:
        pins = hdr.get("pins", {})
        pins["epoch"] = int(pins.get("epoch", 0)) + int(epoch_bump)
        hdr["pins"] = pins
    blob = json.dumps(hdr, sort_keys=True).encode("utf-8")
    ver = FORMAT_VERSION if version is None else int(version)
    head = MAGIC + _U32.pack(ver) + _U32.pack(len(blob)) + blob
    head += hashlib.sha256(head).digest()
    tmp = path + ".hdr.tmp"
    with open(tmp, "wb") as fh:
        fh.write(head + data[parsed["end"]:])
    os.replace(tmp, path)
    return True


class VerdictJournal:
    """One cache's on-disk journal (module docstring).  Thread-safe:
    appends from the service's store path, flush from close(), load at
    attach/revival — the internal lock serializes the file ops.

    Observability attributes the fault seam reads: `path`,
    `last_record_span` ((offset, length) of the most recent append) —
    the storm classes act on the real file through them."""

    def __init__(self, path: str, namespace: str = "",
                 fsync: "str | None" = None,
                 max_bytes: "int | None" = None):
        self.path = path
        self.namespace = str(namespace)
        if fsync is None:
            fsync = _config.get("ED25519_TPU_PERSIST_FSYNC")
        if max_bytes is None:
            max_bytes = _config.get("ED25519_TPU_PERSIST_MAX_BYTES")
        self.fsync_policy = str(fsync)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._cache = None
        self.last_record_span: "tuple[int, int] | None" = None
        self.last_load_report: "dict | None" = None
        self.counters = {
            "appends": 0, "append_errors": 0, "compactions": 0,
            "flushes": 0, "loaded": 0, "absorbed": 0,
            "dropped_records": 0, "dropped_files": 0,
        }

    # -- wiring ------------------------------------------------------------

    def attach_cache(self, cache) -> None:
        """Remember the cache whose live entries compaction re-exports
        (export_entries — the sanctioned snapshot surface)."""
        with self._lock:
            self._cache = cache

    # -- the write side ----------------------------------------------------

    def append(self, entry) -> bool:
        """Append one just-stored entry's record; called by
        `VerdictCache.store` AFTER the in-memory insert landed and
        OUTSIDE the cache lock.  Never raises into the store path: a
        failed append costs durability of one record, nothing else.
        Passes the SITE_PERSIST fault seam (call index counts appends;
        ctx.payload is this journal), so the persistence storms corrupt
        the file exactly between two well-formed appends."""
        try:
            with self._lock:
                _faults.run_device_call(
                    _faults.SITE_PERSIST,
                    lambda: self._append_locked(entry),
                    payload=self)
        except (OSError, _faults.InjectedFault):
            with self._lock:
                self.counters["append_errors"] += 1
            _metrics.record_fault("persist_append_error")
            return False
        self._maybe_compact()
        return True

    def _append_locked(self, entry) -> None:
        self._ensure_header_locked()
        rec = _encode_record(
            entry.digest, entry.payload, entry.verdict, entry.seal,
            entry.tenant, entry.writer_cls,
            (entry.epoch, entry.tenant_epoch, entry.companion_epoch,
             entry.companion_tenant_epoch))
        offset = os.path.getsize(self.path)
        with open(self.path, "ab") as fh:
            fh.write(rec)
            if self.fsync_policy == "always":
                fh.flush()
                os.fsync(fh.fileno())
        self.last_record_span = (offset, len(rec))
        self.counters["appends"] += 1

    def _ensure_header_locked(self) -> None:
        if os.path.exists(self.path) and os.path.getsize(self.path) > 0:
            return
        with open(self.path, "wb") as fh:
            fh.write(_encode_header(self.namespace,
                                    self._live_pins_header()))
            if self.fsync_policy == "always":
                fh.flush()
                os.fsync(fh.fileno())

    def _live_pins_header(self) -> dict:
        cache = self._cache
        if cache is None:
            return {"epoch": 0, "companion_epoch": 0,
                    "tenant_epochs": {}, "companion_tenant_epochs": {}}
        tenants = sorted({e.tenant for e in cache.export_entries()}
                         | {_tenancy.DEFAULT_TENANT})
        pins = {t: cache.epoch_pins(t) for t in tenants}
        base = pins[_tenancy.DEFAULT_TENANT]
        return {
            "epoch": base[0], "companion_epoch": base[2],
            "tenant_epochs": {t: p[1] for t, p in pins.items()},
            "companion_tenant_epochs": {t: p[3]
                                        for t, p in pins.items()},
        }

    def flush(self) -> None:
        """Force the journal to the platter (policy permitting) — the
        `VerifyService.close(drain=True)` hook.  Under `never` this is
        a no-op by contract."""
        if self.fsync_policy == "never":
            return
        with self._lock:
            try:
                if os.path.exists(self.path):
                    with open(self.path, "ab") as fh:
                        fh.flush()
                        os.fsync(fh.fileno())
                self.counters["flushes"] += 1
            except OSError:
                return

    def _maybe_compact(self) -> None:
        with self._lock:
            try:
                over = (self._cache is not None
                        and os.path.exists(self.path)
                        and os.path.getsize(self.path) > self.max_bytes)
            except OSError:
                return
        if over:
            self.compact()

    def compact(self) -> "int | None":
        """Atomically rewrite the journal as a snapshot of the attached
        cache's LIVE entries (write temp, fsync, `os.replace`): corrupt
        or stale bytes are scrubbed off the disk, every surviving
        record re-pinned under the live epoch regime.  Returns the
        snapshot's record count (None without an attached cache)."""
        with self._lock:
            cache = self._cache
        if cache is None:
            return None
        entries = cache.export_entries()
        with self._lock:
            tmp = self.path + ".tmp"
            try:
                with open(tmp, "wb") as fh:
                    fh.write(_encode_header(self.namespace,
                                            self._live_pins_header()))
                    for e in entries:
                        fh.write(_encode_record(
                            e.digest, e.payload, e.verdict, e.seal,
                            e.tenant, e.writer_cls,
                            (e.epoch, e.tenant_epoch, e.companion_epoch,
                             e.companion_tenant_epoch)))
                    if self.fsync_policy != "never":
                        fh.flush()
                        os.fsync(fh.fileno())
                os.replace(tmp, self.path)
            except OSError:
                return None
            self.last_record_span = None
            self.counters["compactions"] += 1
        _metrics.record_fault("persist_compaction")
        return len(entries)

    # -- the read side (recovery) ------------------------------------------

    def load_into(self, cache) -> dict:
        """Recovery: parse the journal, apply the trust ladder (module
        docstring — whole-file gate, per-record gates, stale-pin
        drop), and absorb the survivors into `cache` via
        `absorb_entry` (which re-verifies AND re-pins; absorbing never
        re-appends).  Every degradation is counted in the returned
        report — the restart lab's evidence that each injected
        corruption was caught at load."""
        report = {
            "path": self.path, "file_dropped": None, "records": 0,
            "absorbed": 0,
            "dropped": {"torn_tail": 0, "record_hash": 0,
                        "record_parse": 0, "rehash_mismatch": 0,
                        "seal_mismatch": 0, "stale_pins": 0,
                        "absorb_refused": 0},
        }
        try:
            with self._lock, open(self.path, "rb") as fh:
                data = fh.read()
        except OSError:
            self.last_load_report = report
            return report  # no journal yet: a cold start, not an error
        parsed, reason = _parse_header(data)
        if parsed is None:
            report["file_dropped"] = reason
            self._drop_file(report)
            return report
        hdr = parsed["header"]
        if hdr.get("namespace", "") != self.namespace:
            report["file_dropped"] = "namespace_mismatch"
            self._drop_file(report)
            return report
        if hdr.get("knobs") != knob_fingerprint():
            report["file_dropped"] = "knob_skew"
            self._drop_file(report)
            return report
        rows = _parse_records(data, parsed["end"])
        recs = []
        for rec, why, _end in rows:
            if rec is None:
                report["dropped"][why] += 1
                continue
            # The record's own consensus gate, applied BEFORE the pin
            # arithmetic: bytes that cannot vouch for themselves must
            # not even vote on what the max epoch is.
            if hashlib.sha256(rec["payload"]).digest() != rec["digest"]:
                report["dropped"]["rehash_mismatch"] += 1
                continue
            if _verdictcache.verdict_seal(
                    rec["digest"], rec["verdict"]) != rec["seal"]:
                report["dropped"]["seal_mismatch"] += 1
                continue
            recs.append(rec)
        report["records"] = len(rows)
        # Stale-pin rule: the newest epoch regime seen ANYWHERE in the
        # file (header included) wins; records pinned below it were
        # forfeited before the crash and stay forfeited after it.
        pins = hdr.get("pins", {})
        max_epoch = int(pins.get("epoch", 0))
        max_comp = int(pins.get("companion_epoch", 0))
        t_max = {str(t): int(e)
                 for t, e in (pins.get("tenant_epochs") or {}).items()}
        ct_max = {str(t): int(e) for t, e in
                  (pins.get("companion_tenant_epochs") or {}).items()}
        for rec in recs:
            e, te, ce, cte = rec["pins"]
            t = rec["tenant"]
            max_epoch = max(max_epoch, e)
            max_comp = max(max_comp, ce)
            t_max[t] = max(t_max.get(t, 0), te)
            ct_max[t] = max(ct_max.get(t, 0), cte)
        absorbed = 0
        for rec in recs:
            e, te, ce, cte = rec["pins"]
            t = rec["tenant"]
            if (e != max_epoch or ce != max_comp
                    or te != t_max.get(t, 0)
                    or cte != ct_max.get(t, 0)):
                report["dropped"]["stale_pins"] += 1
                continue
            if cache.absorb_entry(
                    rec["digest"], rec["payload"], rec["verdict"],
                    seal=rec["seal"], tenant=t,
                    writer_cls=rec["writer_cls"]):
                absorbed += 1
            else:
                report["dropped"]["absorb_refused"] += 1
        report["absorbed"] = absorbed
        dropped = sum(report["dropped"].values())
        with self._lock:
            self.counters["loaded"] += len(rows)
            self.counters["absorbed"] += absorbed
            self.counters["dropped_records"] += dropped
        if absorbed:
            _metrics.record_fault("persist_absorbed", absorbed)
        if dropped:
            _metrics.record_fault("persist_record_dropped", dropped)
        self.last_load_report = report
        return report

    def _drop_file(self, report: dict) -> None:
        """Whole-file degradation: count it, remember the report, and
        leave the bytes alone — the attach-time compaction that follows
        a load overwrites them with a clean snapshot."""
        with self._lock:
            self.counters["dropped_files"] += 1
        _metrics.record_fault("persist_file_dropped")
        self.last_load_report = report

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            try:
                size = os.path.getsize(self.path) \
                    if os.path.exists(self.path) else 0
            except OSError:
                size = 0
            return {"path": self.path, "namespace": self.namespace,
                    "fsync": self.fsync_policy,
                    "max_bytes": self.max_bytes, "size_bytes": size,
                    **self.counters}

    def __repr__(self):
        st = self.stats()
        return (f"VerdictJournal({st['path']!r}, "
                f"{st['size_bytes']}B, appends={st['appends']}, "
                f"absorbed={st['absorbed']}, "
                f"dropped={st['dropped_records']})")


def attach(cache, directory: "str | None" = None
           ) -> "VerdictJournal | None":
    """Wire persistence onto a VerdictCache: resolve the journal path
    (`directory`, else the `ED25519_TPU_PERSIST_DIR` knob — unset
    disables persistence entirely), LOAD any existing journal through
    the trust ladder, compact the survivors into a clean snapshot, and
    only then register the journal for write-through appends (so
    nothing absorbed during recovery is ever re-appended).  Returns
    the journal, or None when persistence is off or the cache is
    disabled."""
    if directory is None:
        directory = _config.get("ED25519_TPU_PERSIST_DIR")
    if not directory or not getattr(cache, "enabled", False):
        return None
    existing = cache.journal()
    if existing is not None:
        # Idempotent: the cache is already persistent (attached by its
        # owner; the service's lazy attach must not re-run recovery over
        # a live store).
        return existing
    os.makedirs(directory, exist_ok=True)
    journal = VerdictJournal(journal_path(directory, cache.namespace),
                             namespace=cache.namespace)
    journal.attach_cache(cache)
    journal.load_into(cache)
    journal.compact()
    cache.attach_journal(journal)
    return journal


def reload(cache) -> "dict | None":
    """Re-run recovery on an ALREADY-attached cache's journal — a store
    dropped in process (`drop_all`) re-absorbs the disk's surviving
    records instead of re-warming purely from traffic.  Returns the load
    report (None when the cache has no journal)."""
    journal = cache.journal()
    if journal is None:
        return None
    report = journal.load_into(cache)
    journal.compact()
    return report
