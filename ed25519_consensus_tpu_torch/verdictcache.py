"""Content-addressed verdict memoization for the mempool→consensus
double-verify (a copy of the JAX package's `verdictcache.py`).

A consensus node verifies the same (sig, key, msg) set more than once: at
mempool admission, again in the proposed block, again on vote replay.  The
service's intra-wave dedup decides identical concurrent submissions once;
this module is the CROSS-WAVE half: a verdict decided in one dispatcher
wave is replayed to a byte-identical submission later, without occupying
the queue or the device.  The cache is structurally OFF the verdict math
path:

* **Content addressing.**  An entry is keyed by (batch content digest,
  tenant); the digest is SHA-256 over `Verifier.content_payload()` (batch
  size, keyset blob, group ids, the flat s/R/k buffers — the challenge k
  binds the message), so two batches share a digest iff they received
  byte-identical (vk, sig, msg) queue streams.  The tenant partitions the
  store: one tenant's rotation stales exactly its own memos, and quota
  bytes never migrate across tenants.
* **Hash pinning (the consensus rule).**  Every entry stores the FULL
  payload it was decided over and a SEAL binding the verdict bit to the
  digest.  Every hit re-hashes: the payload must hash to the digest and
  the seal must re-derive from (digest, verdict).  A flipped payload byte
  or stored verdict fails and the lookup is a miss — full verification,
  never an error, never a served lie (`faults.CorruptStoredVerdict`).
* **Write-path discipline.**  Nothing reachable from `verify_many` or
  `VerifyService._execute` writes this cache: the service stores AFTER a
  wave's tickets are resolved, and `store` re-derives the payload from the
  verifier (an `invalidate()`d or exposed-map batch stores nothing).
* **Per-class policy.**  Any class's ladder-decided outcome may be
  written (a mempool admission pre-pays the block verify); every hit is
  re-hashed, so a consensus verdict is only served from verified bytes.
* **Epochs.**  A global epoch and per-tenant rotation epochs, checked on
  every hit, plus a `companion` DeviceOperandCache's epochs:
  `Verifier.invalidate()` and `devcache.rotate_tenant()` stale the
  matching memos with no listener plumbing.  A lane death forfeits the
  default instance's device-trust-derived state through
  `health.register_residency_drop_listener` (`forfeit_device_trust`):
  memoized ACCEPTS are dropped and the epoch bumps (refusing in-flight
  stores), while host-confirmed REJECTS ride through, re-pinned.
* **Persistence (persist.py).**  A `VerdictJournal` may be attached
  (`attach_journal`): every landed store writes through an append-only,
  self-sealed record, outside the cache lock.
* **Recovery gate.**  `absorb_entry` admits an entry decided elsewhere
  (a journal record, or the JAX package's store through
  `carry.verdict_cache_from_reference`) only through the same payload +
  seal re-hash as a hit, pinned under the live epochs; absorbing never
  journals.
* **Budget, deterministic LRU, tenant quotas.**  Byte-budgeted
  (`ED25519_TPU_VERDICT_CACHE_BYTES`), strict LRU in lookup order, and
  with `ED25519_TPU_VERDICT_CACHE_TENANT_QUOTA` > 0 per-tenant partitions
  whose eviction never crosses tenants (an infeasible store is refused
  and counted).

Every lookup passes through `faults.run_device_call(SITE_VERDICTCACHE,
...)`, so `faults.verdictcache_plan` storms land at this boundary; all of
them degrade to a full verification.  No clock: recency is dict order.
"""

import hashlib
import threading

from . import config as _config
from . import faults as _faults
from . import health as _health
from . import tenancy as _tenancy
from .utils import metrics as _metrics

__all__ = [
    "VerdictEntry", "VerdictCache", "default_cache",
    "set_default_cache", "verdict_seal",
]

_SEAL_DOMAIN = b"ed25519-tpu-verdict-seal-v1"
# Fixed per-entry bookkeeping bytes charged against the budget on top
# of the stored payload (digest + seal + slots) so empty-payload
# pathologies cannot make entries free.
_ENTRY_OVERHEAD = 96


def verdict_seal(digest: bytes, verdict: bool) -> bytes:
    """The seal binding a stored verdict bit to its content digest:
    SHA-256(domain ‖ digest ‖ verdict byte).  Re-derived on every hit —
    a flipped stored verdict can never be served."""
    return hashlib.sha256(
        _SEAL_DOMAIN + digest + (b"\x01" if verdict else b"\x00")
    ).digest()


class VerdictEntry:
    """One memoized verdict: the content digest, the FULL payload the
    decision was made over (re-hashed on every hit), the verdict, its
    seal, and the epoch pins that stale it."""

    __slots__ = ("digest", "payload", "verdict", "seal", "epoch",
                 "tenant", "tenant_epoch", "companion_epoch",
                 "companion_tenant_epoch", "writer_cls", "nbytes")

    def __init__(self, digest: bytes, payload: bytes, verdict: bool,
                 epoch: int, tenant: str = _tenancy.DEFAULT_TENANT,
                 tenant_epoch: int = 0, companion_epoch: int = 0,
                 companion_tenant_epoch: int = 0,
                 writer_cls: str = _tenancy.CLASS_MEMPOOL):
        self.digest = digest
        self.payload = bytes(payload)
        self.verdict = bool(verdict)
        self.seal = verdict_seal(digest, self.verdict)
        self.epoch = int(epoch)
        self.tenant = tenant
        self.tenant_epoch = int(tenant_epoch)
        self.companion_epoch = int(companion_epoch)
        self.companion_tenant_epoch = int(companion_tenant_epoch)
        self.writer_cls = writer_cls
        self.nbytes = len(self.payload) + _ENTRY_OVERHEAD

    def recheck(self) -> bool:
        """True iff the stored payload still hashes to the digest AND
        the stored verdict still re-derives its seal — the per-hit
        consensus gate between the memo store and a served verdict."""
        if hashlib.sha256(self.payload).digest() != self.digest:
            return False
        return verdict_seal(self.digest, self.verdict) == self.seal


class VerdictCache:
    """Content-addressed verdict store (module docstring).
    Thread-safe; injectable (tests construct their own, the service
    uses `default_cache()`, a federation ReplicaSet namespaces one per
    replica).

    `companion` wires a DeviceOperandCache's epochs into entry
    validity: pass an instance (a replica's namespaced devcache) or
    True to resolve the process-default devcache LIVE at each check
    (the default instance's wiring — `Verifier.invalidate()` and
    `devcache.rotate_tenant()` then invalidate verdict memos with no
    extra plumbing)."""

    def __init__(self, budget_bytes: "int | None" = None,
                 enabled: "bool | None" = None,
                 tenant_quota_bytes: "int | None" = None,
                 namespace: str = "",
                 companion=None):
        self.namespace = str(namespace)
        if enabled is None:
            enabled = _config.get("ED25519_TPU_VERDICT_CACHE_ENABLED")
        if budget_bytes is None:
            budget_bytes = _config.get("ED25519_TPU_VERDICT_CACHE_BYTES")
        if tenant_quota_bytes is None:
            tenant_quota_bytes = _config.get(
                "ED25519_TPU_VERDICT_CACHE_TENANT_QUOTA")
        self.budget_bytes = int(budget_bytes)
        self.tenant_quota_bytes = int(tenant_quota_bytes)
        self.enabled = bool(enabled) and self.budget_bytes > 0
        self._companion = companion
        self._lock = threading.Lock()
        # (content digest, tenant) -> entry: entries are PARTITIONED
        # by tenant even for byte-identical content, so per-tenant
        # rotation stales exactly its own memos and quota accounting
        # can never migrate bytes across partitions — isolation
        # outranks the (rare) cross-tenant share of identical bytes.
        # INSERTION ORDER IS RECENCY: every touch (lookup hit, store)
        # re-inserts at the end, so the dict head is the global LRU
        # victim — O(1) eviction in the default shared pool, no
        # per-entry sequence counters.
        self._entries: "dict[tuple[bytes, str], VerdictEntry]" = {}
        # Running byte totals (global + per tenant), maintained at
        # every insert/evict/drop: _publish and the armed-quota
        # eviction loops run on the service submit/store hot paths and
        # must never pay a full-dict scan under the lock.
        self._resident_bytes = 0
        self._tenant_bytes: "dict[str, int]" = {}
        self._epoch = 0
        self._tenant_epoch: "dict[str, int]" = {}
        self.counters = {
            "hits": 0, "misses": 0, "stores": 0, "evictions": 0,
            "rehash_mismatch": 0, "stale_epoch": 0, "drops": 0,
            # quota_rejected: refusals under ARMED tenant quotas
            # (partition infeasibility); budget_rejected: a payload
            # too large for the global budget, counted regardless of
            # quota state so an operator can see WHY large batches
            # never memoize.
            "quota_rejected": 0, "budget_rejected": 0,
            "tenant_rotations": 0,
            # absorbed counts entries admitted through the recovery
            # gate (absorb_entry), absorb_refused the ones it turned
            # away; forfeits counts accept entries dropped by
            # forfeit_device_trust.
            "absorbed": 0, "absorb_refused": 0, "forfeits": 0,
        }
        self._tenant_counters: "dict[str, dict]" = {}
        # Write-through journal (persist.VerdictJournal), attached by
        # persist.attach AFTER recovery loaded; None keeps the store
        # process-lifetime only.
        self._journal = None

    # -- companions / epochs ----------------------------------------------

    def _companion_cache(self):
        if self._companion is True:
            from . import devcache as _devcache

            return _devcache.default_cache()
        return self._companion

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def bump_epoch(self, reason: str = "invalidated") -> int:
        """Logically invalidate every stored verdict (entries carry
        their build epoch; a stale-epoch lookup is a miss and the batch
        fully re-verifies).  Wired to the residency-drop listener for
        the default instance; the fault seam's StaleEpochOn lands
        here too.  Recorded + republished immediately — a mass
        forfeiture of every memoized verdict must be visible the
        moment it happens, not at the next lookup."""
        with self._lock:
            self._epoch += 1
            e = self._epoch
        _metrics.record_fault("verdictcache_epoch_bump")
        self._publish()
        return e

    def rotate_tenant(self, tenant: str,
                      reason: str = "epoch-rotation") -> int:
        """Stale exactly one tenant's memoized verdicts (validator-set
        rotation at an epoch boundary).  With a companion devcache the
        usual entry point is `devcache.rotate_tenant()` — its rotation
        epoch is part of entry validity — but a standalone cache can be
        rotated directly."""
        with self._lock:
            e = self._tenant_epoch.get(tenant, 0) + 1
            self._tenant_epoch[tenant] = e
            self.counters["tenant_rotations"] += 1
            self._tenant_tally_locked(tenant, "rotations")
        _metrics.record_fault("verdictcache_tenant_rotation")
        self._publish()
        return e

    def tenant_epoch_of(self, tenant: str) -> int:
        with self._lock:
            return self._tenant_epoch.get(tenant, 0)

    def epoch_pins(self, tenant: str) -> "tuple[int, int, int, int]":
        """The full epoch-pin tuple an entry stored NOW would carry:
        (epoch, tenant epoch, companion epoch, companion tenant
        epoch).  The service captures this at ADMISSION and hands it
        back to `store` as `expected_pins`: a verdict decided before
        any epoch moved — a lane death bumping the default store
        mid-wave, a rotation landing between staging and dispatch —
        is then refused rather than re-pinned under the new regime it
        was supposed to be forfeited by."""
        comp = self._companion_cache()
        return (self.epoch, self.tenant_epoch_of(tenant),
                comp.epoch if comp is not None else 0,
                comp.tenant_epoch_of(tenant) if comp is not None else 0)

    def attach_journal(self, journal) -> None:
        """Register a persist.VerdictJournal for write-through appends
        (persist.attach calls this AFTER recovery loaded, so nothing
        absorbed from disk is ever re-appended)."""
        with self._lock:
            self._journal = journal

    def journal(self):
        """The attached journal, or None (persistence off)."""
        with self._lock:
            return self._journal

    def drop_all(self, reason: str = "dropped") -> int:
        """Drop every stored verdict NOW (replica ejection, evict-storm
        fault).  Returns the number dropped."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            self._resident_bytes = 0
            self._tenant_bytes.clear()
            self.counters["drops"] += n
        if n:
            _metrics.record_fault("verdictcache_drop_all")
        self._publish()
        return n

    # -- tenancy tallies ---------------------------------------------------

    def _tenant_tally_locked(self, tenant: str, key: str,
                             n: int = 1) -> None:
        # under self._lock
        c = self._tenant_counters.get(tenant)
        if c is None:
            c = {"hits": 0, "misses": 0, "stores": 0, "evictions": 0,
                 "stale_epoch": 0, "rotations": 0, "quota_rejected": 0}
            self._tenant_counters[tenant] = c
        c[key] += n

    def tenant_stats(self) -> "dict[str, dict]":
        """Per-tenant snapshot: {tenant: {resident_bytes,
        resident_verdicts, hits, misses, stores, evictions,
        stale_epoch, rotations, quota_rejected, hit_rate}} — the second
        demand input `devcache.suggest_tenant_quotas` folds in (one
        sizing function covers both caches)."""
        with self._lock:
            out = {}
            tenants = set(self._tenant_counters) | set(
                self._tenant_epoch) | {
                e.tenant for e in self._entries.values()}
            for t in tenants:
                c = dict(self._tenant_counters.get(t, ()))
                looked = c.get("hits", 0) + c.get("misses", 0)
                out[t] = {
                    "resident_bytes": self._tenant_bytes.get(t, 0),
                    "resident_verdicts": sum(
                        1 for e in self._entries.values()
                        if e.tenant == t),
                    "epoch": self._tenant_epoch.get(t, 0),
                    "hit_rate": (c.get("hits", 0) / looked
                                 if looked else None),
                    **c,
                }
            return out

    # -- lookup (the guarded read path) ------------------------------------

    def lookup(self, digest: "bytes | None",
               tenant: "str | None" = None) -> "VerdictEntry | None":
        """THE read path: returns a re-hashed, current-epoch entry or
        None (miss / stale / corrupt — all of which mean "verify in
        full"; a None digest — exposed map or post-invalidate — always
        bypasses).  Passes through the SITE_VERDICTCACHE fault seam;
        the consensus gate (epoch pins + byte-for-byte re-hash) runs
        AFTER the seam, so injected corruption is caught exactly where
        real corruption would be.  Publishes the verdictcache gauges.
        This is the ONLY sanctioned way to read an entry.

        `tenant` is the SUBMITTING tenant (the service passes it;
        default the shared partition): entries are keyed
        (digest, tenant), so a lookup only ever sees its OWN
        partition's memo — byte-identical content submitted by two
        tenants memoizes per tenant, which is what lets a rotation
        stale exactly one tenant's decisions — and every tally lands
        on the submitting tenant (the quota auto-sizing demand
        input)."""
        if not self.enabled or digest is None:
            return None
        t = tenant if tenant is not None else _tenancy.DEFAULT_TENANT
        # Companion epochs are read OUTSIDE self._lock (the companion
        # has its own lock; never nest them).
        comp = self._companion_cache()
        comp_epoch = comp.epoch if comp is not None else 0
        key = (digest, t)
        entry = _faults.run_device_call(
            _faults.SITE_VERDICTCACHE,
            lambda: self._lookup_locked(key),
            payload=self)
        stale = False
        if entry is not None:
            comp_tenant_epoch = (comp.tenant_epoch_of(t)
                                 if comp is not None else 0)
            if (entry.epoch != self.epoch
                    or entry.tenant_epoch != self.tenant_epoch_of(t)
                    or entry.companion_epoch != comp_epoch
                    or entry.companion_tenant_epoch
                    != comp_tenant_epoch):
                # Global bump, tenant rotation (own or companion —
                # devcache.rotate_tenant lands here), or companion
                # invalidation: the decision predates the epoch and is
                # not replayed.  Degrade to full verification.
                stale = True
                self._drop(key, "stale_epoch", entry)
                _metrics.record_fault("verdictcache_stale_epoch")
                entry = None
            elif not entry.recheck():
                # The consensus gate: stored bytes no longer hash to
                # the digest, or the stored verdict no longer derives
                # its seal (CorruptStoredVerdict's flip lands here).
                # Never served, never an error — a full verification
                # re-decides from the submission's own bytes.
                self._drop(key, "rehash_mismatch", entry)
                _metrics.record_fault("verdictcache_rehash_mismatch")
                entry = None
        with self._lock:
            self.counters["hits" if entry is not None else "misses"] += 1
            self._tenant_tally_locked(
                t, "hits" if entry is not None else "misses")
            if stale:
                self._tenant_tally_locked(t, "stale_epoch")
        self._publish()
        return entry

    def _lookup_locked(self, key) -> "VerdictEntry | None":
        with self._lock:
            e = self._entries.pop(key, None)
            if e is not None:
                # Re-insert at the end: dict order IS recency.
                self._entries[key] = e
            return e

    def _drop(self, key, counter: str, entry=None) -> None:
        """Remove one entry; with `entry` given, remove ONLY if the
        key still maps to that exact object — the staleness/re-hash
        checks run outside the lock, and a fresh entry stored
        concurrently under the same key must not be collateral of an
        old entry's verdict (the drop would silently evict a valid
        memo and miscount it as stale/corrupt)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or (entry is not None and e is not entry):
                return
            del self._entries[key]
            self._resident_bytes -= e.nbytes
            self._tenant_bytes[e.tenant] = \
                self._tenant_bytes.get(e.tenant, 0) - e.nbytes
            self.counters[counter] += 1

    # -- store (the write path; never reachable from verdict math) ---------

    def store(self, verifier, verdict: bool,
              cls: str = _tenancy.CLASS_MEMPOOL,
              tenant: "str | None" = None,
              expected_digest: "bytes | None" = None,
              expected_pins: "tuple | None" = None) -> bool:
        """Memoize one ladder-decided verdict.  The payload is
        RE-DERIVED from the verifier AT STORE TIME: a batch whose
        content can no longer vouch for itself (exposed coalescing map,
        out-of-band `invalidate()` — `content_payload()` returns None)
        stores nothing, and with `expected_digest` (the digest the
        submission was admitted under) a payload that drifted since
        admission also stores nothing.  With `expected_pins` (the
        `epoch_pins` tuple captured at admission) a verdict whose
        epoch regime moved while it was in flight — a lane death
        bumping the store mid-wave, a rotation landing between staging
        and resolution — is refused too: an epoch bump exists to
        forfeit exactly the in-flight decisions, and re-pinning them
        under the new epoch would smuggle them past it.  All three
        refusals are the write side of the trust discipline: only
        bytes that provably ARE the decided bytes, decided under the
        regime still in force, may carry the decision forward.

        Returns True iff a NEW entry landed (an existing same-verdict
        entry just refreshes recency).  Per-class policy: any class's
        outcome may write (writer_cls is recorded); serving is gated by
        the unconditional re-hash in `lookup`, never by class."""
        if not self.enabled:
            return False
        payload = verifier.content_payload()
        if payload is None:
            return False
        digest = hashlib.sha256(payload).digest()
        if expected_digest is not None and digest != expected_digest:
            return False
        tenant = tenant if tenant is not None else _tenancy.DEFAULT_TENANT
        pins = self.epoch_pins(tenant)
        if expected_pins is not None and tuple(expected_pins) != pins:
            return False
        entry = VerdictEntry(
            digest, payload, verdict, pins[0], tenant=tenant,
            tenant_epoch=pins[1], companion_epoch=pins[2],
            companion_tenant_epoch=pins[3], writer_cls=cls)
        quota = self.tenant_quota_bytes
        if entry.nbytes > self.budget_bytes or (
                quota > 0 and entry.nbytes > quota):
            # Counted either way (an operator must be able to see WHY
            # large batches never memoize): budget_rejected names the
            # global-budget overflow, quota_rejected stays a statement
            # about ARMED partitions specifically.
            with self._lock:
                if entry.nbytes > self.budget_bytes:
                    self.counters["budget_rejected"] += 1
                if quota > 0 and entry.nbytes > quota:
                    self.counters["quota_rejected"] += 1
                    self._tenant_tally_locked(tenant, "quota_rejected")
            _metrics.record_fault("verdictcache_budget_rejected")
            self._publish()
            return False
        evicted = 0
        stored = False
        landed = None
        key = (digest, tenant)
        with self._lock:
            def add_bytes(t, delta):
                self._resident_bytes += delta
                self._tenant_bytes[t] = \
                    self._tenant_bytes.get(t, 0) + delta

            existing = self._entries.get(key)
            if existing is not None and existing.verdict == bool(verdict):
                # Idempotent re-store (the dedup fanout's duplicate
                # requests, a replayed leg racing its own miss):
                # refresh recency (delete + re-insert at the end) and
                # the epoch pins, count nothing.
                del self._entries[key]
                self._entries[key] = entry
                add_bytes(tenant, entry.nbytes - existing.nbytes)
                landed = entry
            else:
                if quota > 0:
                    # Cross-tenant eviction is off the table: if OTHER
                    # tenants' bytes already crowd this entry out of
                    # the global budget, refuse now and leave every
                    # partition exactly as found (devcache.build's
                    # feasibility-first rule).  The running per-tenant
                    # byte totals make this check O(1); eviction below
                    # pops the dict-order LRU — O(1) in the shared
                    # pool, a walk to the partition's oldest entry
                    # under an armed quota.
                    other = self._resident_bytes \
                        - self._tenant_bytes.get(tenant, 0)
                    if other + entry.nbytes > self.budget_bytes:
                        self.counters["quota_rejected"] += 1
                        self._tenant_tally_locked(tenant,
                                                  "quota_rejected")
                        entry = None
                if entry is not None:
                    if existing is not None:
                        del self._entries[key]
                        add_bytes(tenant, -existing.nbytes)
                    self._entries[key] = entry
                    add_bytes(tenant, entry.nbytes)
                    stored = True
                    landed = entry

                    def evict_own() -> bool:
                        # Dict order is recency: the first matching
                        # entry IS the partition's LRU.  O(1) in the
                        # default shared pool; with an armed quota the
                        # walk stops at the tenant's own oldest entry.
                        # The just-stored entry sits at the END, so it
                        # is only reachable when it is the partition's
                        # sole entry — never evicted.
                        for k2, e2 in self._entries.items():
                            if k2 == key:
                                continue
                            if quota > 0 and e2.tenant != tenant:
                                continue
                            del self._entries[k2]
                            add_bytes(e2.tenant, -e2.nbytes)
                            self.counters["evictions"] += 1
                            self._tenant_tally_locked(e2.tenant,
                                                      "evictions")
                            return True
                        return False

                    if quota > 0:
                        while (self._tenant_bytes.get(tenant, 0)
                               > quota and evict_own()):
                            evicted += 1
                    while self._resident_bytes > self.budget_bytes \
                            and evict_own():
                        evicted += 1
                    self.counters["stores"] += 1
                    self._tenant_tally_locked(tenant, "stores")
        if evicted:
            _metrics.record_fault("verdictcache_evict", evicted)
        if landed is not None:
            # Write-through persistence OUTSIDE the cache lock: the insert
            # already happened, and a failed append costs the durability of
            # one record, never the store (append swallows its own I/O
            # errors).
            journal = self.journal()
            if journal is not None:
                journal.append(landed)
        self._publish()
        return stored

    # -- the recovery surface (recovery is NOT a verdict) -------------------

    def export_entries(self) -> "list[VerdictEntry]":
        """Snapshot of the live entries in recency order (oldest first);
        an exported entry is only ever re-admitted through
        `absorb_entry`'s gate."""
        with self._lock:
            return list(self._entries.values())

    def absorb_entry(self, digest: bytes, payload: bytes, verdict: bool,
                     *, seal: "bytes | None" = None,
                     tenant: "str | None" = None,
                     writer_cls: str = _tenancy.CLASS_MEMPOOL) -> bool:
        """The RECOVERY write path (`carry.verdict_cache_from_reference`):
        absorb one entry decided elsewhere as a cache-hit CANDIDATE.  The
        same consensus gate as a live hit runs before anything is
        inserted — the payload must re-hash to the digest, and with
        `seal` given the verdict must still derive it (otherwise a
        flipped verdict byte would quietly re-seal itself here).
        Survivors are pinned under the LIVE epoch regime
        (`epoch_pins`): recovery chooses warmth, never answers.  The same
        budget/quota/LRU discipline as `store`; a live entry under the
        same key outranks the absorbed one and only refreshes
        recency."""
        if not self.enabled:
            return False
        payload = bytes(payload)
        verdict = bool(verdict)
        if hashlib.sha256(payload).digest() != digest or (
                seal is not None
                and verdict_seal(digest, verdict) != seal):
            with self._lock:
                self.counters["rehash_mismatch"] += 1
                self.counters["absorb_refused"] += 1
            _metrics.record_fault("verdictcache_absorb_refused")
            self._publish()
            return False
        tenant = tenant if tenant is not None else _tenancy.DEFAULT_TENANT
        pins = self.epoch_pins(tenant)
        entry = VerdictEntry(
            digest, payload, verdict, pins[0], tenant=tenant,
            tenant_epoch=pins[1], companion_epoch=pins[2],
            companion_tenant_epoch=pins[3], writer_cls=writer_cls)
        quota = self.tenant_quota_bytes
        refused = entry.nbytes > self.budget_bytes or (
            quota > 0 and entry.nbytes > quota)
        evicted = 0
        absorbed = False
        key = (digest, tenant)
        if not refused:
            with self._lock:
                def add_bytes(t, delta):
                    self._resident_bytes += delta
                    self._tenant_bytes[t] = \
                        self._tenant_bytes.get(t, 0) + delta

                existing = self._entries.get(key)
                if existing is not None:
                    # Live state outranks the absorbed entry: refresh
                    # recency only.
                    del self._entries[key]
                    self._entries[key] = existing
                else:
                    if quota > 0:
                        other = self._resident_bytes \
                            - self._tenant_bytes.get(tenant, 0)
                        if other + entry.nbytes > self.budget_bytes:
                            refused = True
                    if not refused:
                        self._entries[key] = entry
                        add_bytes(tenant, entry.nbytes)
                        absorbed = True

                        def evict_own() -> bool:
                            # Same walk as store(): dict order is
                            # recency, quota keeps eviction inside the
                            # absorbing tenant's own partition.
                            for k2, e2 in self._entries.items():
                                if k2 == key:
                                    continue
                                if quota > 0 and e2.tenant != tenant:
                                    continue
                                del self._entries[k2]
                                add_bytes(e2.tenant, -e2.nbytes)
                                self.counters["evictions"] += 1
                                self._tenant_tally_locked(
                                    e2.tenant, "evictions")
                                return True
                            return False

                        if quota > 0:
                            while (self._tenant_bytes.get(tenant, 0)
                                   > quota and evict_own()):
                                evicted += 1
                        while self._resident_bytes > self.budget_bytes \
                                and evict_own():
                            evicted += 1
                        self.counters["absorbed"] += 1
        if refused:
            with self._lock:
                self.counters["absorb_refused"] += 1
        if evicted:
            _metrics.record_fault("verdictcache_evict", evicted)
        self._publish()
        return absorbed

    def forfeit_device_trust(self, reason: str = "lane-death") -> int:
        """Lane death / residency abandonment (the health residency-
        drop listener): forfeit exactly the DEVICE-TRUST-DERIVED half
        of the store.  The asymmetry is the scheduler's own ladder
        (faults.py soundness note): a device REJECT is re-decided on
        the host before it can ever become a verdict, so a memoized
        reject is host-confirmed math and SURVIVES — re-pinned under
        the post-bump epoch; a memoized ACCEPT may embed the now-
        distrusted device's arithmetic and is dropped.  The global
        epoch still bumps either way, so in-flight decisions admitted
        under the old regime are refused at store time
        (`expected_pins`) — the bump forfeits in-flight trust, the
        drop forfeits stored accepts, and both leave host-confirmed
        rejects serving (their bytes and seal are still re-checked on
        every hit).  Only entries CURRENT at forfeit time are
        re-pinned — an entry already staled by an earlier bump or
        rotation must not be resurrected by the ride-through.  Returns
        the number of accept entries dropped."""
        # Companion epochs are read OUTSIDE self._lock (lookup's rule:
        # the companion has its own lock; never nest them).
        comp = self._companion_cache()
        comp_epoch = comp.epoch if comp is not None else 0
        with self._lock:
            tenants = {e.tenant for e in self._entries.values()}
        comp_tenant = {t: (comp.tenant_epoch_of(t)
                           if comp is not None else 0) for t in tenants}
        dropped = 0
        with self._lock:
            old = self._epoch
            self._epoch += 1
            for key, e in list(self._entries.items()):
                if e.verdict:
                    del self._entries[key]
                    self._resident_bytes -= e.nbytes
                    self._tenant_bytes[e.tenant] = \
                        self._tenant_bytes.get(e.tenant, 0) - e.nbytes
                    dropped += 1
                elif (e.epoch == old
                        and e.tenant_epoch
                        == self._tenant_epoch.get(e.tenant, 0)
                        and e.companion_epoch == comp_epoch
                        and e.companion_tenant_epoch
                        == comp_tenant.get(e.tenant, 0)):
                    e.epoch = self._epoch
                # else: already stale under some OTHER pin — leave it;
                # the next lookup drops it as stale_epoch.
            self.counters["drops"] += dropped
            self.counters["forfeits"] += dropped
        _metrics.record_fault("verdictcache_epoch_bump")
        if dropped:
            _metrics.record_fault("verdictcache_device_trust_forfeit",
                                  dropped)
        self._publish()
        return dropped

    # -- observability -----------------------------------------------------

    def resident_bytes(self) -> int:
        with self._lock:
            return self._resident_bytes

    def resident_count(self) -> int:
        with self._lock:
            return len(self._entries)

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "namespace": self.namespace,
                "budget_bytes": self.budget_bytes,
                "tenant_quota_bytes": self.tenant_quota_bytes,
                "resident_bytes": self._resident_bytes,
                "resident_verdicts": len(self._entries),
                "epoch": self._epoch,
                "tenants": sorted(
                    {e.tenant for e in self._entries.values()}),
                **self.counters,
            }

    def _publish(self) -> None:
        """Mirror the levels into the process gauge registry
        (utils.metrics) as verdictcache_* — namespaced instances
        publish verdictcache_<ns>_* so replicas never clobber one
        another.  Runs on every lookup/store (the submit hot path):
        reads ONLY the running counters — never an entry scan."""
        with self._lock:
            c = self.counters
            snap = {
                "hits": c["hits"], "misses": c["misses"],
                "stores": c["stores"], "evictions": c["evictions"],
                "rehash_mismatch": c["rehash_mismatch"],
                "stale_epoch": c["stale_epoch"],
                "resident_bytes": self._resident_bytes,
                "resident_verdicts": len(self._entries),
                "epoch": self._epoch,
            }
        prefix = ("verdictcache_" if not self.namespace
                  else f"verdictcache_{self.namespace}_")
        _metrics.set_gauges({prefix + k: v for k, v in snap.items()})

    def __repr__(self):
        st = self.stats()
        return (f"VerdictCache(enabled={st['enabled']}, "
                f"resident={st['resident_verdicts']} verdicts / "
                f"{st['resident_bytes']}B of {st['budget_bytes']}B, "
                f"epoch={st['epoch']}, hits={st['hits']}, "
                f"misses={st['misses']}, stores={st['stores']})")


# -- process default (same injectable-singleton idiom as devcache.py) -----

_default = [None]
_default_lock = threading.Lock()


def default_cache() -> VerdictCache:
    """The process default verdict cache, constructed lazily (env knobs
    set before first use take effect) and companioned to the process-
    default devcache — `Verifier.invalidate()` and
    `devcache.rotate_tenant()` therefore invalidate memoized verdicts
    with no extra wiring.  Tests inject with `set_default_cache`."""
    with _default_lock:
        if _default[0] is None:
            _default[0] = VerdictCache(companion=True)
        return _default[0]


def set_default_cache(cache: "VerdictCache | None") -> None:
    """Replace the process default (None resets to a fresh env-derived
    instance on next use)."""
    with _default_lock:
        _default[0] = cache


# Lane death / abandonment forfeits the default store's DEVICE-TRUST-
# DERIVED state (forfeit_device_trust): memoized accepts decided while
# a now-distrusted device participated are dropped and re-decided on
# demand; host-confirmed rejects ride through, re-pinned — and the
# epoch bump still refuses every in-flight decision at store time
# (same listener contract as devcache's drop_all — runs OUTSIDE
# health's lock).
def _on_residency_drop(reason: str) -> None:
    with _default_lock:
        cache = _default[0]
    if cache is not None:
        cache.forfeit_device_trust(reason)


_health.register_residency_drop_listener(_on_residency_drop)
