"""Device-resident operand cache: content-addressed keyset residency for
the device lane.

In consensus workloads the validator keyset recurs every block, so the
operand bytes of the MSM's HEAD terms — the basepoint and A-coefficient
points and their [2^128]·P split-high partners — are byte-identical batch
after batch.  This cache keeps them on the card:

* **Content addressing.**  An entry is keyed by SHA-256 over the canonical
  keyset blob (the 32-byte key encodings in group-id order).
* **Two kinds per digest.**  `KIND_HEAD` pins the head operand tensor,
  (4, NLIMBS, 2·(m+1)) int16 extended limbs for [B, A_1..A_m, [2^128]B,
  [2^128]A_1..A_m] (`StagedBatch.head_tensor`); `KIND_TABLES` pins their
  [0..8]P multiples tables, (9, 4, NLIMBS, 2·(m+1)) int16
  (`StagedBatch.head_tables_tensor`), so the kernel skips the table build
  for every head lane.  A tables miss falls back to the head-resident
  dispatch, a head miss to cold staging.
* **Hash pinning (the consensus rule).**  Every entry stores the SHA-256
  of the bytes the HOST built, and every hit re-hashes the host mirror; a
  mismatch drops the entry and the batch restages.  A corruption that
  exists only in the device copy is caught one rung later by the
  scheduler's host confirmation of device rejects.
* **Budget + deterministic LRU** over `ED25519_TPU_DEVCACHE_BYTES`.
* **Epochs.**  `bump_epoch()` stales every entry logically; it is wired to
  `Verifier.invalidate()` and — through `health`'s residency-drop
  listener — lane death drops all residency.
* **Second-sight build policy**: a keyset is built at its second sighting
  (which still stages cold) and served from its third.

Every lookup passes through `faults.run_device_call(SITE_DEVCACHE, ...)`,
so corrupt/evict/stale plans land deterministically at this boundary.
"""

import hashlib
import threading

import numpy as np

from . import config as _config
from . import faults as _faults
from . import health as _health
from .utils import metrics as _metrics

__all__ = ["ResidentKeyset", "DeviceOperandCache", "default_cache",
           "set_default_cache", "keyset_digest", "KIND_HEAD",
           "KIND_TABLES"]

KIND_HEAD = "head"
KIND_TABLES = "tables"


def keyset_digest(keyset_blob: bytes) -> bytes:
    """The content address of a canonical keyset blob: SHA-256."""
    return hashlib.sha256(keyset_blob).digest()


class ResidentKeyset:
    """One resident entry: the host mirror (`head_tensor`, operand limbs
    for kind="head", multiples tables for kind="tables"), its pinned hash,
    the build epoch, and one device tensor per device."""

    __slots__ = ("digest", "n_keys", "head_tensor", "head_hash", "epoch",
                 "nbytes", "kind", "_device_refs", "_ref_chips", "_seq")

    def __init__(self, digest: bytes, n_keys: int, head_tensor,
                 epoch: int, kind: str = KIND_HEAD):
        self.digest = digest
        self.n_keys = int(n_keys)
        self.kind = kind
        self.head_tensor = head_tensor
        self.head_hash = hashlib.sha256(head_tensor.tobytes()).digest()
        self.epoch = int(epoch)
        self.nbytes = int(head_tensor.nbytes)
        self._device_refs = {}  # str(torch.device) -> tensor
        # str(torch.device) -> the chips whose shards read that copy (a
        # virtual mesh's shards share one device's copy)
        self._ref_chips = {}
        self._seq = 0  # last-used lookup sequence (cache-maintained)

    @property
    def n_head(self) -> int:
        """Head term count: coefficient terms + split-high terms."""
        return 2 * (self.n_keys + 1)

    def recheck(self) -> bool:
        """True iff the host mirror still hashes to the pinned value —
        the per-hit gate between residency and dispatch."""
        return hashlib.sha256(
            self.head_tensor.tobytes()).digest() == self.head_hash

    def device_ref(self, device, chips=()):
        """The entry's tensor on `device`, copied from the host mirror on
        first use and reused, so a steady-state hit moves no head bytes —
        one copy per distinct device, however many shards of a mesh read
        it.  The copy is taken from a snapshot, never a view of the
        mirror.  Callers pass an indexed device ("cuda:0"), the key of the
        chip-drop accounting, and a mesh lane the `chips` of the shards
        that read the copy."""
        import torch

        dev = torch.device(device)
        key = str(dev)
        ref = self._device_refs.get(key)
        if ref is None:
            ref = torch.from_numpy(np.array(self.head_tensor)).to(dev)
            self._device_refs[key] = ref
        if chips:
            self._ref_chips.setdefault(key, set()).update(
                int(c) for c in chips)
        return ref

    def drop_refs_for_chip(self, chip: int) -> int:
        """Drop every copy that chip `chip` read: the one held on CUDA
        device `chip`, and any copy a mesh placement including that chip
        read (a virtual mesh's shared copy).  The host mirror and the
        pinned hash stay.  Returns the number of copies dropped."""
        chip = int(chip)
        keys = [k for k in self._device_refs
                if k == f"cuda:{chip}" or chip in self._ref_chips.get(k, ())]
        for k in keys:
            del self._device_refs[k]
            self._ref_chips.pop(k, None)
        return len(keys)


class DeviceOperandCache:
    """Content-addressed residency for recurring keysets (module
    docstring).  Thread-safe; injectable (tests construct their own, the
    scheduler uses `default_cache()`)."""

    def __init__(self, budget_bytes: "int | None" = None,
                 enabled: "bool | None" = None):
        if enabled is None:
            enabled = _config.get("ED25519_TPU_DEVCACHE")
        if budget_bytes is None:
            budget_bytes = _config.get("ED25519_TPU_DEVCACHE_BYTES")
        self.budget_bytes = int(budget_bytes)
        self.enabled = bool(enabled) and self.budget_bytes > 0
        self._lock = threading.Lock()
        self._entries: "dict[tuple[bytes, str], ResidentKeyset]" = {}
        self._seen: "set[bytes]" = set()
        self._seen_max = 1 << 16
        self._epoch = 0
        self._lookup_seq = 0
        self.counters = {
            "hits": 0, "misses": 0, "evictions": 0,
            "restage_hash_mismatch": 0, "stale_epoch": 0, "builds": 0,
            "drops": 0, "chip_drops": 0,
        }

    # -- epoch / residency lifecycle --------------------------------------

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def bump_epoch(self, reason: str = "invalidated") -> int:
        """Logically invalidate every resident entry."""
        with self._lock:
            self._epoch += 1
            return self._epoch

    def drop_all(self, reason: str = "dropped") -> int:
        """Drop every resident entry now (lane death, evict-storm fault).
        Returns the number dropped."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self.counters["drops"] += n
        if n:
            _metrics.record_fault("devcache_drop_all")
        self._publish()
        return n

    def drop_chip(self, chip: int, reason: str = "chip-loss") -> int:
        """Drop only the device tensors held on the dead chip; host
        mirrors and pinned hashes stay."""
        with self._lock:
            dropped = sum(e.drop_refs_for_chip(chip)
                          for e in self._entries.values())
            self.counters["chip_drops"] += dropped
        if dropped:
            _metrics.record_fault("devcache_chip_drop", dropped)
        return dropped

    def resident_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def resident_count(self) -> int:
        """Distinct resident KEYSETS (a digest holding both kinds counts
        once)."""
        with self._lock:
            return len({d for d, _k in self._entries})

    # -- lookup / build ----------------------------------------------------

    def probe(self, digest: "bytes | None") -> dict:
        """Non-mutating cache-temperature read: {"hit", "tables_hit",
        "resident_bytes"}.  Counts nothing and touches no recency.
        `tables_hit` is True only when the tables dispatch is reachable:
        head hot too and ED25519_TPU_DEVCACHE_TABLES on."""
        tables_on = _config.get("ED25519_TPU_DEVCACHE_TABLES")
        with self._lock:
            def hot(kind):
                e = (self._entries.get((digest, kind))
                     if digest is not None else None)
                return bool(e is not None and e.epoch == self._epoch
                            and self.enabled)

            head_hot = hot(KIND_HEAD)
            return {"hit": head_hot,
                    "tables_hit": bool(head_hot and tables_on
                                       and hot(KIND_TABLES)),
                    "resident_bytes": sum(
                        x.nbytes for x in self._entries.values())}

    def can_admit_tables(self, digest: "bytes | None",
                         tables_nbytes: int) -> bool:
        """Would a kind="tables" build of `tables_nbytes` fit beside this
        digest's head entry?  Checked BEFORE paying the host table build:
        a tables entry whose admission would evict its own head just
        thrashes."""
        if not self.enabled or digest is None:
            return False
        with self._lock:
            head = self._entries.get((digest, KIND_HEAD))
            need = int(tables_nbytes) + (
                head.nbytes if head is not None else 0)
            return need <= self.budget_bytes

    def lookup(self, digest: bytes,
               kind: str = KIND_HEAD) -> "ResidentKeyset | None":
        """The dispatch-time lookup: a hash-rechecked, current-epoch entry
        of `kind`, or None (miss / stale / corrupt — all of which mean the
        next-colder path)."""
        if not self.enabled:
            return None
        entry = _faults.run_device_call(
            _faults.SITE_DEVCACHE,
            lambda: self._lookup_locked((digest, kind)), payload=self)
        if entry is not None:
            # After the fault seam, so an injected (or real) host-mirror
            # corruption is caught before any dispatch could use it.
            if entry.epoch != self.epoch:
                self._drop((digest, kind), "stale_epoch")
                _metrics.record_fault("devcache_stale_epoch")
                entry = None
            elif not entry.recheck():
                self._drop((digest, kind), "restage_hash_mismatch")
                _metrics.record_fault("devcache_restage_hash_mismatch")
                entry = None
        with self._lock:
            self.counters["hits" if entry is not None else "misses"] += 1
        self._publish()
        return entry

    def _lookup_locked(self, key):
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self._lookup_seq += 1
                e._seq = self._lookup_seq
            return e

    def _drop(self, key, counter: str) -> None:
        with self._lock:
            if self._entries.pop(key, None) is not None:
                self.counters[counter] += 1

    def should_build(self, digest: bytes) -> bool:
        """Second-sight build policy: False (and remember the sighting)
        the first time a keyset is asked about, True from then on."""
        if not self.enabled:
            return False
        with self._lock:
            if digest in self._seen:
                return True
            if len(self._seen) >= self._seen_max:
                self._seen.clear()
            self._seen.add(digest)
            return False

    def build(self, digest: bytes, n_keys: int, head_tensor,
              kind: str = KIND_HEAD) -> "ResidentKeyset | None":
        """Install an entry built from HOST-staged bytes, evicting
        least-recently-used entries past the budget.  None when the tensor
        alone exceeds the whole budget."""
        if not self.enabled:
            return None
        head_tensor = np.ascontiguousarray(head_tensor)
        if head_tensor.nbytes > self.budget_bytes:
            return None
        evicted = 0
        with self._lock:
            entry = ResidentKeyset(digest, n_keys, head_tensor, self._epoch,
                                   kind=kind)
            if kind == KIND_TABLES:
                # The pair travels together: refresh the same digest's
                # head recency first, so this build's eviction pass never
                # picks the head the tables exist to serve beside.
                head = self._entries.get((digest, KIND_HEAD))
                if head is not None:
                    self._lookup_seq += 1
                    head._seq = self._lookup_seq
            self._lookup_seq += 1
            entry._seq = self._lookup_seq
            self._entries[(digest, kind)] = entry
            while (sum(e.nbytes for e in self._entries.values())
                   > self.budget_bytes and len(self._entries) > 1):
                victim = min(self._entries.values(), key=lambda e: e._seq)
                del self._entries[(victim.digest, victim.kind)]
                self.counters["evictions"] += 1
                evicted += 1
            self.counters["builds"] += 1
        if evicted:
            _metrics.record_fault("devcache_evict", evicted)
        self._publish()
        return entry

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "budget_bytes": self.budget_bytes,
                "resident_bytes": sum(
                    e.nbytes for e in self._entries.values()),
                "resident_keysets": len({d for d, _k in self._entries}),
                "resident_entries": len(self._entries),
                "resident_tables": sum(
                    1 for _d, k in self._entries if k == KIND_TABLES),
                "epoch": self._epoch,
                **self.counters,
            }

    def _publish(self) -> None:
        """Mirror the levels into the process gauge registry."""
        with self._lock:
            c = self.counters
            snap = {
                "hits": c["hits"], "misses": c["misses"],
                "evictions": c["evictions"],
                "restages": c["restage_hash_mismatch"] + c["stale_epoch"],
                "resident_bytes": sum(
                    e.nbytes for e in self._entries.values()),
                "resident_keysets": len({d for d, _k in self._entries}),
                "epoch": self._epoch,
            }
        _metrics.set_gauges({"devcache_" + k: v for k, v in snap.items()})

    def __repr__(self):
        st = self.stats()
        return (f"DeviceOperandCache(enabled={st['enabled']}, "
                f"resident={st['resident_keysets']} keysets / "
                f"{st['resident_bytes']}B of {st['budget_bytes']}B, "
                f"epoch={st['epoch']}, hits={st['hits']}, "
                f"misses={st['misses']})")


_default = [None]
_default_lock = threading.Lock()


def default_cache() -> DeviceOperandCache:
    """The process default cache, constructed lazily so env knobs set
    before first use take effect."""
    with _default_lock:
        if _default[0] is None:
            _default[0] = DeviceOperandCache()
        return _default[0]


def set_default_cache(cache: "DeviceOperandCache | None") -> None:
    """Replace the process default (None resets to a fresh env-derived
    instance on next use)."""
    with _default_lock:
        _default[0] = cache


def _on_residency_drop(reason: str) -> None:
    with _default_lock:
        cache = _default[0]
    if cache is not None:
        cache.drop_all(reason)


def _on_chip_drop(chip: int, reason: str) -> None:
    with _default_lock:
        cache = _default[0]
    if cache is not None:
        cache.drop_chip(chip, reason)


# Lane death drops all residency; a dead chip drops its device tensors.
# Registered once at import; the listeners run outside health's locks.
_health.register_residency_drop_listener(_on_residency_drop)
_health.register_chip_drop_listener(_on_chip_drop)
