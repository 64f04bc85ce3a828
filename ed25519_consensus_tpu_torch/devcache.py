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
* **Tenants** (the JAX package's tenant half, `tenancy.py`): a keyset
  digest is assigned to a tenant (`assign_tenant`, which
  `VerifyService.submit(tenant=...)` calls); `rotate_tenant` stales
  exactly that tenant's entries (a validator-set rotation), and with
  `ED25519_TPU_DEVCACHE_TENANT_QUOTA` > 0 the budget is partitioned into
  per-tenant quotas whose eviction never crosses a tenant — a build that
  other tenants' bytes crowd out is refused (`quota_rejected`) before it
  touches any entry.  `quota_suggestions` reports (never arms) per-tenant
  quotas from the observed lookups.

Every lookup passes through `faults.run_device_call(SITE_DEVCACHE, ...)`,
so corrupt/evict/stale plans land deterministically at this boundary.
"""

import hashlib
import threading

import numpy as np

from . import config as _config
from . import faults as _faults
from . import health as _health
from . import tenancy as _tenancy
from .utils import metrics as _metrics

__all__ = ["ResidentKeyset", "DeviceOperandCache", "default_cache",
           "set_default_cache", "keyset_digest", "suggest_tenant_quotas",
           "KIND_HEAD", "KIND_TABLES"]

KIND_HEAD = "head"
KIND_TABLES = "tables"


def keyset_digest(keyset_blob: bytes) -> bytes:
    """The content address of a canonical keyset blob: SHA-256."""
    return hashlib.sha256(keyset_blob).digest()


class ResidentKeyset:
    """One resident entry: the host mirror (`head_tensor`, operand limbs
    for kind="head", multiples tables for kind="tables"), its pinned hash,
    the build epoch, the tenant partition and its rotation epoch at build
    time, and one device tensor per device."""

    __slots__ = ("digest", "n_keys", "head_tensor", "head_hash", "epoch",
                 "tenant", "tenant_epoch", "nbytes", "kind", "_device_refs",
                 "_ref_chips", "_seq")

    def __init__(self, digest: bytes, n_keys: int, head_tensor,
                 epoch: int, tenant: str = _tenancy.DEFAULT_TENANT,
                 tenant_epoch: int = 0, kind: str = KIND_HEAD):
        self.digest = digest
        self.n_keys = int(n_keys)
        self.kind = kind
        self.head_tensor = head_tensor
        self.head_hash = hashlib.sha256(head_tensor.tobytes()).digest()
        self.epoch = int(epoch)
        self.tenant = tenant
        self.tenant_epoch = int(tenant_epoch)
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
                 enabled: "bool | None" = None,
                 tenant_quota_bytes: "int | None" = None):
        if enabled is None:
            enabled = _config.get("ED25519_TPU_DEVCACHE")
        if budget_bytes is None:
            budget_bytes = _config.get("ED25519_TPU_DEVCACHE_BYTES")
        if tenant_quota_bytes is None:
            tenant_quota_bytes = _config.get(
                "ED25519_TPU_DEVCACHE_TENANT_QUOTA")
        self.budget_bytes = int(budget_bytes)
        # > 0 partitions the budget into per-tenant quotas (eviction never
        # crosses a tenant); 0 keeps one shared LRU pool.
        self.tenant_quota_bytes = int(tenant_quota_bytes)
        self.enabled = bool(enabled) and self.budget_bytes > 0
        self._lock = threading.Lock()
        self._entries: "dict[tuple[bytes, str], ResidentKeyset]" = {}
        self._seen: "set[bytes]" = set()
        self._seen_max = 1 << 16
        self._epoch = 0
        self._lookup_seq = 0
        # digest -> tenant (unassigned digests are DEFAULT_TENANT's), and
        # each tenant's rotation epoch.  An assignment is a placement
        # hint, never correctness state.
        self._tenant_of: "dict[bytes, str]" = {}
        self._tenant_epoch: "dict[str, int]" = {}
        self.counters = {
            "hits": 0, "misses": 0, "evictions": 0,
            "restage_hash_mismatch": 0, "stale_epoch": 0, "builds": 0,
            "drops": 0, "tenant_rotations": 0, "quota_rejected": 0,
            "chip_drops": 0,
        }
        self._tenant_counters: "dict[str, dict]" = {}

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

    # -- tenancy (cache QoS + per-tenant rotation) -------------------------

    def assign_tenant(self, digest: "bytes | None", tenant: str) -> None:
        """Assign a keyset digest to a tenant partition, for FUTURE
        builds: a resident entry keeps the partition it was built under
        until it restages."""
        if digest is None:
            return
        with self._lock:
            if len(self._tenant_of) >= self._seen_max:
                # Keep the assignments of every RESIDENT digest (clearing
                # them would revert hot tenants to the default partition);
                # drop only the non-resident remainder.
                resident = {d for d, _k in self._entries}
                self._tenant_of = {
                    d: t for d, t in self._tenant_of.items()
                    if d in resident}
            self._tenant_of[digest] = tenant

    def tenant_of(self, digest: "bytes | None") -> str:
        with self._lock:
            if digest is None:
                return _tenancy.DEFAULT_TENANT
            return self._tenant_of.get(digest, _tenancy.DEFAULT_TENANT)

    def rotate_tenant(self, tenant: str,
                      reason: str = "epoch-rotation") -> int:
        """Validator-set rotation for ONE tenant: bump its rotation epoch,
        staling exactly its entries (they restage and rebuild under the
        new epoch).  Returns the tenant's new epoch."""
        with self._lock:
            e = self._tenant_epoch.get(tenant, 0) + 1
            self._tenant_epoch[tenant] = e
            self.counters["tenant_rotations"] += 1
            self._tenant_tally_locked(tenant, "rotations")
        _metrics.record_fault("devcache_tenant_rotation")
        self._publish()
        return e

    def tenant_epoch_of(self, tenant: str) -> int:
        with self._lock:
            return self._tenant_epoch.get(tenant, 0)

    def _tenant_tally_locked(self, tenant: str, key: str,
                             n: int = 1) -> None:
        # under self._lock
        c = self._tenant_counters.get(tenant)
        if c is None:
            c = {"hits": 0, "misses": 0, "evictions": 0,
                 "stale_epoch": 0, "builds": 0, "rotations": 0,
                 "quota_rejected": 0}
            self._tenant_counters[tenant] = c
        c[key] += n

    def tenant_stats(self) -> "dict[str, dict]":
        """{tenant: {resident_bytes, resident_keysets, epoch, hit_rate,
        hits, misses, evictions, stale_epoch, builds, rotations,
        quota_rejected}}."""
        with self._lock:
            out = {}
            tenants = set(self._tenant_counters) | set(
                self._tenant_epoch) | {
                e.tenant for e in self._entries.values()}
            for t in tenants:
                c = dict(self._tenant_counters.get(t, ()))
                looked = c.get("hits", 0) + c.get("misses", 0)
                out[t] = {
                    "resident_bytes": sum(
                        e.nbytes for e in self._entries.values()
                        if e.tenant == t),
                    "resident_keysets": len({
                        e.digest for e in self._entries.values()
                        if e.tenant == t}),
                    "epoch": self._tenant_epoch.get(t, 0),
                    "hit_rate": (c.get("hits", 0) / looked
                                 if looked else None),
                    **c,
                }
            return out

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
                return bool(
                    e is not None and e.epoch == self._epoch
                    and e.tenant_epoch == self._tenant_epoch.get(
                        e.tenant, 0)
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
        thrashes.  With tenant quotas armed the pair must also fit the
        quota, and the budget net of other tenants' bytes (build()'s own
        refusal rules)."""
        if not self.enabled or digest is None:
            return False
        with self._lock:
            head = self._entries.get((digest, KIND_HEAD))
            need = int(tables_nbytes) + (
                head.nbytes if head is not None else 0)
            if need > self.budget_bytes:
                return False
            quota = self.tenant_quota_bytes
            if quota > 0:
                if need > quota:
                    return False
                tenant = self._tenant_of.get(digest,
                                             _tenancy.DEFAULT_TENANT)
                other = sum(e.nbytes for e in self._entries.values()
                            if e.tenant != tenant)
                if other + need > self.budget_bytes:
                    return False
            return True

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
        stale = False
        entry_tenant = None if entry is None else entry.tenant
        if entry is not None:
            # After the fault seam, so an injected (or real) host-mirror
            # corruption is caught before any dispatch could use it.
            if entry.epoch != self.epoch or entry.tenant_epoch \
                    != self.tenant_epoch_of(entry.tenant):
                # A global bump, or the entry's tenant rotated since build.
                stale = True
                self._drop((digest, kind), "stale_epoch")
                _metrics.record_fault("devcache_stale_epoch")
                entry = None
            elif not entry.recheck():
                self._drop((digest, kind), "restage_hash_mismatch")
                _metrics.record_fault("devcache_restage_hash_mismatch")
                entry = None
        with self._lock:
            self.counters["hits" if entry is not None else "misses"] += 1
            # A found entry (hit, or dropped as stale) tallies against the
            # partition it was built under; a true miss by the current
            # assignment.
            t = (entry_tenant if entry_tenant is not None
                 else self._tenant_of.get(digest, _tenancy.DEFAULT_TENANT))
            self._tenant_tally_locked(
                t, "hits" if entry is not None else "misses")
            if stale:
                self._tenant_tally_locked(t, "stale_epoch")
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
        alone exceeds the whole budget (or, quotas armed, the quota).

        With per-tenant quotas armed (`tenant_quota_bytes > 0`) eviction
        is PARTITIONED: only the building digest's own tenant's entries
        are candidates, for its quota and for the global budget.  If
        other tenants' bytes already crowd the tensor out of the budget,
        the build is refused (`quota_rejected`) before any entry is
        touched."""
        if not self.enabled:
            return None
        head_tensor = np.ascontiguousarray(head_tensor)
        quota = self.tenant_quota_bytes
        if head_tensor.nbytes > self.budget_bytes or (
                quota > 0 and head_tensor.nbytes > quota):
            if quota > 0:
                # A quota refusal is counted (a permanently cold tenant
                # must show why); with quotas off it is the silent cold
                # stage of a keyset too large to be resident.
                with self._lock:
                    tenant = self._tenant_of.get(digest,
                                                 _tenancy.DEFAULT_TENANT)
                    self.counters["quota_rejected"] += 1
                    self._tenant_tally_locked(tenant, "quota_rejected")
                _metrics.record_fault("devcache_quota_rejected")
                self._publish()
            return None
        evicted = 0
        rejected = False
        entry = None
        with self._lock:
            tenant = self._tenant_of.get(digest, _tenancy.DEFAULT_TENANT)

            def total(pred=lambda e: True):
                return sum(e.nbytes for e in self._entries.values()
                           if pred(e))

            if quota > 0 and total(lambda e: e.tenant != tenant) \
                    + head_tensor.nbytes > self.budget_bytes:
                # Feasibility first: the best this build can do is evict
                # its own partition, and that would not make room.
                self.counters["quota_rejected"] += 1
                self._tenant_tally_locked(tenant, "quota_rejected")
                rejected = True
            else:
                entry = ResidentKeyset(
                    digest, n_keys, head_tensor, self._epoch,
                    tenant=tenant,
                    tenant_epoch=self._tenant_epoch.get(tenant, 0),
                    kind=kind)
                if kind == KIND_TABLES:
                    # The pair travels together: refresh the same digest's
                    # head recency first, so this build's eviction pass
                    # never picks the head the tables serve beside.
                    head = self._entries.get((digest, KIND_HEAD))
                    if head is not None:
                        self._lookup_seq += 1
                        head._seq = self._lookup_seq
                self._lookup_seq += 1
                entry._seq = self._lookup_seq
                self._entries[(digest, kind)] = entry

            def evict_own() -> bool:
                own = [e for e in self._entries.values()
                       if e.tenant == tenant]
                if len(own) <= 1:
                    return False
                victim = min(own, key=lambda e: e._seq)
                del self._entries[(victim.digest, victim.kind)]
                self.counters["evictions"] += 1
                self._tenant_tally_locked(tenant, "evictions")
                return True

            if quota > 0 and not rejected:
                # LRU within the tenant's partition: to its quota, then
                # (still own entries only) to the global budget.
                while (total(lambda e: e.tenant == tenant) > quota
                       and evict_own()):
                    evicted += 1
                while total() > self.budget_bytes and evict_own():
                    evicted += 1
            elif quota <= 0:
                while (total() > self.budget_bytes
                       and len(self._entries) > 1):
                    victim = min(self._entries.values(),
                                 key=lambda e: e._seq)
                    del self._entries[(victim.digest, victim.kind)]
                    self.counters["evictions"] += 1
                    self._tenant_tally_locked(victim.tenant, "evictions")
                    evicted += 1
            if entry is not None:
                self.counters["builds"] += 1
                self._tenant_tally_locked(tenant, "builds")
        if evicted:
            _metrics.record_fault("devcache_evict", evicted)
        if rejected:
            _metrics.record_fault("devcache_quota_rejected")
        self._publish()
        return entry

    # -- observability -----------------------------------------------------

    def quota_suggestions(self, verdict_stats: "dict | None" = None
                          ) -> "dict[str, int]":
        """Report-only per-tenant quota suggestions from the observed
        lookups (`suggest_tenant_quotas` over `tenant_stats()`, with a
        `verdictcache.VerdictCache.tenant_stats()` snapshot folded in as
        `verdict_stats`).  Never arms a quota."""
        return suggest_tenant_quotas(self.tenant_stats(),
                                     self.budget_bytes,
                                     verdict_stats=verdict_stats)

    def stats(self) -> dict:
        suggestions = self.quota_suggestions()
        with self._lock:
            return {
                "enabled": self.enabled,
                "quota_suggestions": suggestions,
                "budget_bytes": self.budget_bytes,
                "tenant_quota_bytes": self.tenant_quota_bytes,
                "resident_bytes": sum(
                    e.nbytes for e in self._entries.values()),
                "resident_keysets": len({d for d, _k in self._entries}),
                "resident_entries": len(self._entries),
                "resident_tables": sum(
                    1 for _d, k in self._entries if k == KIND_TABLES),
                "epoch": self._epoch,
                "tenants": sorted(
                    {e.tenant for e in self._entries.values()}),
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


def suggest_tenant_quotas(tenant_stats: "dict[str, dict]",
                          budget_bytes: int,
                          verdict_stats: "dict[str, dict] | None" = None
                          ) -> "dict[str, int]":
    """Per-tenant quota SUGGESTIONS from observed demand, a pure function
    of the snapshots: each tenant weighs lookups · (1 + miss_rate), summed
    over both caches (`verdict_stats`, a verdict cache's tenant_stats,
    optional), and the budget splits in proportion, floored to ints (Σ ≤
    budget).  A tenant with no lookups in either cache suggests 0."""
    budget = max(0, int(budget_bytes))
    weights: "dict[str, float]" = {}
    for stats_map in (tenant_stats, verdict_stats or {}):
        for tenant, st in stats_map.items():
            looked = st.get("hits", 0) + st.get("misses", 0)
            if looked <= 0:
                continue
            hit_rate = st.get("hit_rate")
            miss_rate = 1.0 - (hit_rate if hit_rate is not None else 1.0)
            weights[tenant] = weights.get(tenant, 0.0) \
                + looked * (1.0 + miss_rate)
    total = sum(weights.values())
    if total <= 0 or budget <= 0:
        return {t: 0 for t in weights}
    return {t: int(budget * w / total)
            for t, w in sorted(weights.items())}


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
