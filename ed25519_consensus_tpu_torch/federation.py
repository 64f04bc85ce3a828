"""Federated replicas: one front door over M replica services — a copy of
the JAX package's `federation.py` over the port's `VerifyService`.

A single service survives chip loss and diagnoses silent corruption, but a
WHOLE-replica failure — a host crash, a wedged runtime, a breaker stuck
open — takes it down.  `ReplicaSet` closes that gap: M `VerifyService`
replicas, each with its own breaker, its own namespaced device operand
cache and verdict memo and its own capacity, behind consistent-hash
keyset/tenant → replica affinity so residency stays hot per replica.

The replica ladder, one rung richer than the chip ladder (a replica holds
admitted work a chip does not):

1. **Affinity** — every submission routes by rendezvous hashing over
   (keyset digest, tenant) (`routing.replica_affinity_order`): a recurring
   validator keyset always lands on the same replica, whose namespace
   serves it hot.  The ORDER is policy too: spillover follows it.
2. **Spillover** — a DEGRADED (capacity fraction at or below
   ED25519_TPU_REPLICA_DEGRADED_FRAC) or overloaded replica hands
   lower-class submissions to the next replica in affinity order before
   shedding users; consensus-class tries every live replica, draining ones
   included, so it never loses admission while any replica is alive.
3. **Suspect → drain** — classified evidence
   (`health.classify_device_error` at replica granularity) lands in the
   `health.ReplicaRegistry`: transient and ambiguous failures accumulate
   decaying suspicion; crossing the threshold DRAINS the replica (no new
   work, queued work finishes).
4. **Eject + re-issue** — a drained-empty or fatally failed replica is
   EJECTED: its queued requests are surrendered
   (`VerifyService.surrender_pending`, tickets intact) and re-issued on
   peers in affinity order, where they are RE-VERIFIED with fresh
   blinders.  A request no peer admits is decided on the exact host path
   here — the floor, so an admitted request always resolves.  The ejected
   replica's devcache namespace and memo store drop wholesale.
5. **Probe → rejoin** — suspicion decays, eject relaxes to PROBATION, and
   the replica — revived through the service factory if it crashed — must
   pass ED25519_TPU_REPLICA_PROBES consecutive probes whose truth is known
   by construction before the affinity ring places it again; it then
   imports its live peers' warm-digest hints.  A failing probe re-ejects.

**The port's rule for device errors.**  The port's service fails a device
wave's tickets with the `DeviceError` its `verify_many` raised, where the
JAX service re-decides the wave on the host, so this ReplicaSet sees
errors the JAX one never does.  Each such wave is replica-level evidence:
`pump_replica` hands the service's `last_device_error` to
`_on_replica_error` (transient or ambiguous suspicion by
`classify_device_error`; a fatal class ejects), the tickets keep the
error, and such a batch is never re-decided on the host.  The host floor
of `_reissue` is for a PLACEMENT failure only: an ejected replica's
surrendered request that no peer admits.

Soundness: replica choice is placement, never math — every verdict comes
from some replica's verify_many ladder or the exact host floor.
Determinism: no wall-clock reads in the ladder (all time from the injected
clock), no module-global state, and the whole-replica fault seam
(`faults.SITE_REPLICA`: ReplicaCrash / ReplicaWedge / SplitCapacity) makes
every rung replayable from a seed (tools/traffic_lab.py --fleet).
"""

import random
import threading

from . import batch as _batch
from . import config as _config
from . import devcache as _devcache
from . import faults as _faults
from . import health as _health
from . import persist as _persist
from . import routing as _routing
from . import service as _service
from . import tenancy as _tenancy
from . import verdictcache as _verdictcache
from .utils import metrics as _metrics

__all__ = ["FederatedTicket", "Replica", "ReplicaSet"]


class FederatedTicket:
    """Handle for one federated submission: points at the replica's
    `VerifyTicket` and is RE-POINTED when the federation re-issues the
    request on a peer — the waiter just gets its outcome.  `replica_trail`
    records every placement."""

    __slots__ = ("_lock", "_inner", "replica_id", "replica_trail")

    def __init__(self):
        self._lock = threading.Lock()
        self._inner = None
        self.replica_id = None
        self.replica_trail = []

    def _point_at(self, ticket, rid: int) -> None:
        with self._lock:
            self._inner = ticket
            self.replica_id = rid
            self.replica_trail.append(rid)

    def _current(self):
        with self._lock:
            return self._inner

    def done(self) -> bool:
        t = self._current()
        return t is not None and t.done()

    def result(self, timeout: "float | None" = None) -> bool:
        """Block (wall time) for the outcome: the verdict, or the ticket's
        exception raised.  Waits in short slices, since a failover can
        re-point the inner ticket mid-wait."""
        wall = _health.SYSTEM_CLOCK.monotonic
        deadline = None if timeout is None else wall() + float(timeout)
        while True:
            t = self._current()
            remaining = None if deadline is None else deadline - wall()
            if t is not None:
                if remaining is None:
                    try:
                        return t.result(0.1)
                    except TimeoutError:
                        continue
                if t.done() or remaining > 0:
                    try:
                        return t.result(min(0.1, max(0.0, remaining)))
                    except TimeoutError:
                        if t is not self._current():
                            continue  # re-pointed: keep waiting
                        if wall() >= deadline:
                            raise
                        continue
            if remaining is not None and remaining <= 0:
                raise TimeoutError("federated result not ready")


class Replica:
    """One managed replica: its id, its `VerifyService`, its namespaced
    device operand cache and verdict memo, its namespaced latency ledger,
    and the degraded-capacity seam SplitCapacity writes.  Placement and
    observability state only."""

    __slots__ = ("rid", "service", "cache", "vcache", "degraded_frac",
                 "pumps", "crashed", "latency")

    def __init__(self, rid: int, service, cache, vcache=None):
        self.rid = int(rid)
        self.service = service
        self.cache = cache
        self.vcache = vcache
        self.latency = _health.LatencyLedger(namespace=f"r{rid}")
        # None: derived from the service's own effective capacity; a float
        # is an externally reported fraction.
        self.degraded_frac = None
        self.pumps = 0
        self.crashed = False

    def capacity_fraction(self) -> float:
        """The live effective-capacity fraction: the reported seam when
        set, else effective / configured from the service."""
        if self.degraded_frac is not None:
            return float(self.degraded_frac)
        svc = self.service
        cap = max(1, svc.capacity_sigs)
        return svc.effective_capacity_sigs() / cap


class ReplicaSet:
    """The federation front door: M replicas, affinity routing, spillover,
    the replica ladder and fleet-scope zero-lost (module docstring).

    * `replicas` — replica count M (ids 0..M−1).
    * `service_factory(rid, clock, cache)` — builds one replica's
      `VerifyService` (called again at revival); it must return an
      `auto_start=False` service, since the ReplicaSet pumps them.  The
      default builds services on `device` (None: the card) with per-replica
      breaker seeds.
    * `clock` — the fleet timeline (registry decay, probes, services).
    * `registry` — an injectable `health.ReplicaRegistry`.

    `submit` from any number of threads; one dispatcher calls `process_once`
    (or `pump_forever` from a dedicated thread)."""

    def __init__(self, replicas: int = 3,
                 service_factory=None,
                 clock: "_health.Clock | None" = None,
                 registry: "_health.ReplicaRegistry | None" = None,
                 capacity_sigs: int = 65536,
                 devcache_budget_bytes: "int | None" = None,
                 probe_seed: int = 0,
                 persist_dir: "str | None" = None,
                 device=None):
        if replicas < 1:
            raise ValueError("a federation needs at least one replica")
        self._clock = clock if clock is not None else _health.SYSTEM_CLOCK
        self.registry = registry if registry is not None \
            else _health.ReplicaRegistry(clock=self._clock)
        self.registry.set_clock(self._clock)
        self.capacity_sigs = int(capacity_sigs)
        self.device = device
        self._factory = (service_factory if service_factory is not None
                         else self._default_factory)
        self._lock = threading.Lock()
        self._probe_seed = int(probe_seed)
        self._probe_ord = 0
        self._closed = False
        self.replicas: "dict[int, Replica]" = {}
        # rid -> {id(inner ticket): (FederatedTicket, verifier, deadline,
        # cls, tenant)}: the re-issue bridge, pruned of resolved entries on
        # every pump.
        self._tracked: "dict[int, dict]" = {}
        self.totals = {
            "submitted": 0, "affinity_hits": 0, "spillovers": 0,
            "degraded_spills": 0, "rejected_overloaded": 0,
            "reissued": 0, "host_floor": 0, "ejections": 0,
            "drains_started": 0, "rejoins": 0, "revivals": 0,
            "probes": 0, "probe_failures": 0,
            # Identical concurrent submissions sharing one federated
            # ticket (front-door dedup).
            "dedup_fanout": 0,
            # Warm hints imported from live peers at rejoin, and refused.
            "prewarm_hits": 0, "prewarm_refused": 0,
            # Device waves whose tickets carry a DeviceError (the port's
            # rule: evidence, never a host re-decision).
            "device_error_waves": 0,
        }
        self.error_classes = {_health.ERROR_TRANSIENT: 0,
                              _health.ERROR_FATAL: 0,
                              _health.ERROR_AMBIGUOUS: 0}
        # (content digest, cls, tenant) → (FederatedTicket, deadline, rid,
        # affinity hit): the dedup ledger, pruned on every maintain().
        self._front_dedup: "dict" = {}
        self._dedup_by_replica: "dict[int, int]" = {}
        for rid in range(int(replicas)):
            cache = _devcache.DeviceOperandCache(
                budget_bytes=devcache_budget_bytes, namespace=f"r{rid}")
            # The replica's memo companions ITS devcache, so a rotation on
            # its residency namespace stales exactly its memos.
            vcache = _verdictcache.VerdictCache(
                namespace=f"r{rid}", companion=cache)
            svc = self._factory(rid, self._clock, cache)
            svc.verdict_cache = vcache
            # Each replica journals into its own verdicts-r<rid>.vjournal.
            if persist_dir is not None:
                _persist.attach(vcache, directory=persist_dir)
            self.replicas[rid] = Replica(rid, svc, cache, vcache)
            self._tracked[rid] = {}

    def _default_factory(self, rid: int, clock, cache):
        return _service.VerifyService(
            capacity_sigs=self.capacity_sigs, clock=clock,
            auto_start=False, replica_id=f"r{rid}", cache=cache,
            breaker_seed=rid, device=self.device)

    # -- affinity + admission ---------------------------------------------

    @staticmethod
    def _digest_of(verifier) -> "bytes | None":
        blob = verifier._canonical_keyset_blob()
        return _devcache.keyset_digest(blob) if blob else None

    def _degraded(self, rep: Replica) -> bool:
        frac = _config.get("ED25519_TPU_REPLICA_DEGRADED_FRAC")
        return rep.capacity_fraction() <= frac

    def _candidates(self, digest, tenant: str, cls: str
                    ) -> "tuple[tuple[int, ...], int]":
        """(candidate rids in try order, first-choice rid): the affinity
        order without non-accepting replicas; for lower classes with
        spillover on, degraded replicas move to the back (off: only the
        affinity target); consensus also appends draining replicas."""
        order = _routing.replica_affinity_order(
            digest, tenant, sorted(self.replicas))
        first = order[0] if order else None
        accepting = [r for r in order if self.registry.accepting(r)]
        spill = _config.get("ED25519_TPU_REPLICA_SPILLOVER")
        if cls != _tenancy.CLASS_CONSENSUS:
            if not spill:
                accepting = accepting[:1]
            else:
                healthy = [r for r in accepting
                           if not self._degraded(self.replicas[r])]
                degraded = [r for r in accepting
                            if self._degraded(self.replicas[r])]
                accepting = healthy + degraded
        if cls == _tenancy.CLASS_CONSENSUS:
            draining = self.registry.draining_replicas()
            accepting = accepting + [r for r in order if r in draining]
        return tuple(accepting), first

    def submit(self, entries, deadline: "float | None" = None,
               timeout: "float | None" = None,
               cls: "str | None" = None,
               tenant: "str | None" = None) -> FederatedTicket:
        """Submit one batch to the fleet; returns a `FederatedTicket`.
        Affinity first, then spillover down the same order.  Raises
        `Overloaded` only when no candidate admitted the batch, and
        `ServiceClosed` after `close()`; an admitted request resolves even
        across a replica's death."""
        if cls is None:
            cls = _tenancy.CLASS_MEMPOOL
        _tenancy.class_rank(cls)
        if isinstance(entries, _batch.Verifier):
            v = entries
        else:
            v = _batch.Verifier()
            v.queue_bulk(list(entries))
        with self._lock:
            if self._closed:
                raise _service.ServiceClosed()
        if timeout is not None:
            t = self._clock.monotonic() + float(timeout)
            deadline = t if deadline is None else min(deadline, t)
        digest = self._digest_of(v)
        tenant_name = tenant if tenant is not None \
            else _tenancy.DEFAULT_TENANT
        # Front-door dedup: an identical submission (content digest, class
        # and tenant, so the same home) still in flight with an EQUAL
        # deadline shares its ticket — sharing a ticket shares its failure
        # outcomes too, so only an equal deadline inherits nothing that was
        # not owed.  A None digest never dedups.
        content = v.content_digest()
        if content is not None:
            key = (content, cls, tenant_name)
            with self._lock:
                ent = self._front_dedup.get(key)
                if ent is not None and ent[0].done():
                    # resolved: the verdict memo's business now
                    del self._front_dedup[key]
                    ent = None
                if ent is not None:
                    fed0, dl0, rid0, hit0 = ent
                    if dl0 == deadline:
                        self.totals["submitted"] += 1
                        self.totals["dedup_fanout"] += 1
                        # the shared ticket's placement is this one's too
                        self.totals["affinity_hits"
                                    if hit0 else "spillovers"] += 1
                        self._dedup_by_replica[rid0] = \
                            self._dedup_by_replica.get(rid0, 0) + 1
                        _metrics.record_fault("federation_dedup_fanout")
                        return fed0
        candidates, first = self._candidates(digest, tenant_name, cls)
        with self._lock:
            self.totals["submitted"] += 1
        last_exc = None
        for rid in candidates:
            rep = self.replicas[rid]
            try:
                ticket = rep.service.submit(
                    v, deadline=deadline, cls=cls, tenant=tenant,
                    _content_digest=content)
            except _service.Overloaded as exc:
                last_exc = exc
                continue
            fed = FederatedTicket()
            fed._point_at(ticket, rid)
            with self._lock:
                self._tracked[rid][id(ticket)] = (fed, v, deadline,
                                                  cls, tenant_name)
                if content is not None:
                    # never displace a still-in-flight entry
                    cur = self._front_dedup.get((content, cls, tenant_name))
                    if cur is None or cur[0].done():
                        self._front_dedup[(content, cls, tenant_name)] \
                            = (fed, deadline, rid, rid == first)
            # Ejection race: the dispatcher may have ejected this replica
            # between the candidate check and the enqueue; an ejected or
            # probation replica is never pumped, so sweep it (idempotent).
            if self.registry.state_of(rid) in (
                    _health.REPLICA_EJECTED, _health.REPLICA_PROBATION):
                self._sweep_ejected(rep)
            if rid == first:
                with self._lock:
                    self.totals["affinity_hits"] += 1
            else:
                degraded_spill = (
                    first is not None
                    and self.registry.accepting(first)
                    and self._degraded(self.replicas[first]))
                with self._lock:
                    self.totals["spillovers"] += 1
                    if degraded_spill:
                        # the first choice was alive but degraded: shed
                        # load, not users
                        self.totals["degraded_spills"] += 1
                _metrics.record_fault("federation_spillover")
            return fed
        with self._lock:
            self.totals["rejected_overloaded"] += 1
        _metrics.record_fault("federation_reject_overloaded")
        if last_exc is not None:
            raise last_exc
        raise _service.Overloaded(
            f"no replica available for {cls}-class submission "
            f"({len(self.replicas)} configured, "
            f"{len(candidates)} candidates)")

    # -- the dispatcher ----------------------------------------------------

    def _supervised(self, rep: Replica, fn):
        """Run one replica-scoped call through the whole-replica fault seam:
        ANY exception becomes classified evidence in the replica ladder,
        never an escape.  Returns (ok, value)."""
        try:
            return True, _faults.run_device_call(
                _faults.SITE_REPLICA, fn, clock=self._clock,
                payload=rep)
        except Exception as exc:
            self._on_replica_error(rep, exc)
            return False, None

    def _on_replica_error(self, rep: Replica, exc: Exception) -> None:
        ev = _health.classify_device_error(exc)
        with self._lock:
            self.error_classes[ev.cls] += 1
        state = self.registry.state_of(rep.rid)
        if state in (_health.REPLICA_EJECTED,
                     _health.REPLICA_PROBATION):
            # Already off placement (a probe, or a stale pump racing the
            # eject): _run_probes records a probe failure; a fatal class
            # still marks the service crashed so revival rebuilds it.
            if ev.cls == _health.ERROR_FATAL:
                rep.crashed = True
            return
        if ev.cls == _health.ERROR_FATAL:
            self._eject(rep, f"fatal replica error: {ev.reason}",
                        crashed=True)
            return
        weight = (_health.REPLICA_TRANSIENT_SUSPICION
                  if ev.cls == _health.ERROR_TRANSIENT
                  else _health.REPLICA_AMBIGUOUS_SUSPICION)
        before = self.registry.state_of(rep.rid)
        state = self.registry.record_suspicion(
            rep.rid, weight, f"{ev.cls}: {ev.reason}")
        if state == _health.REPLICA_DRAINING \
                and before != _health.REPLICA_DRAINING:
            with self._lock:
                self.totals["drains_started"] += 1
            _metrics.record_fault("replica_drain_started")

    def _eject(self, rep: Replica, reason: str,
               crashed: bool = False) -> None:
        """Eject the replica, surrender and re-issue its queue, drop its
        residency namespace and its memo store (re-issue is
        re-verification, so peers inherit nothing from them)."""
        self.registry.mark_ejected(rep.rid, reason)
        with self._lock:
            self.totals["ejections"] += 1
        _metrics.record_fault("replica_ejected")
        rep.crashed = rep.crashed or crashed
        rep.cache.drop_all(f"replica-ejected: {reason}")
        if rep.vcache is not None:
            rep.vcache.drop_all(f"replica-ejected: {reason}")
        self._sweep_ejected(rep)

    def _sweep_ejected(self, rep: Replica) -> None:
        """Surrender and re-issue everything still queued on an ejected
        replica's service.  Idempotent, so ejection, the submit race
        re-check, revival and close() all call it."""
        pending = rep.service.surrender_pending()
        with self._lock:
            bridge = self._tracked[rep.rid]
            self._tracked[rep.rid] = {}
        for req in pending:
            entry = bridge.pop(id(req.ticket), None)
            self._reissue(req, entry, exclude=rep.rid)

    def _reissue(self, req, entry, exclude: int) -> None:
        """Re-issue one surrendered request on a peer (fresh blinders), or
        decide it on the exact host path when no peer admits it — a
        placement failure, the only case the host decides here."""
        fed = entry[0] if entry is not None else None
        tenant_name = entry[4] if entry is not None else (
            req.tenant or _tenancy.DEFAULT_TENANT)
        digest = self._digest_of(req.verifier)
        if fed is not None:
            candidates, _first = self._candidates(digest, tenant_name,
                                                  req.cls)
            for rid in candidates:
                if rid == exclude:
                    continue
                rep = self.replicas[rid]
                try:
                    ticket = rep.service.submit(
                        req.verifier, deadline=req.deadline,
                        cls=req.cls, tenant=req.tenant)
                except (_service.Overloaded, _service.ServiceClosed):
                    continue  # unavailable: the floor still owes it
                with self._lock:
                    self.totals["reissued"] += 1
                _metrics.record_fault("federation_reissue")
                fed._point_at(ticket, rid)
                with self._lock:
                    self._tracked[rid][id(ticket)] = (
                        fed, req.verifier, req.deadline, req.cls,
                        tenant_name)
                return
        # The floor: no peer admitted it (or it was never front-door
        # tracked).  rng=None: secrets-grade blinders, never a derivable
        # stream an adversary could aim at.
        with self._lock:
            self.totals["host_floor"] += 1
        _metrics.record_fault("federation_host_floor")
        try:
            verdict = _batch._host_verdict(req.verifier, None)
        except Exception as exc:  # the host path failed: explicit evidence
            req.ticket._fail(exc)
            return
        req.ticket._resolve(verdict)

    def _prune_tracked(self, rid: int) -> None:
        with self._lock:
            tr = self._tracked.get(rid)
            if not tr:
                return
            done = [k for k, entry in tr.items()
                    if entry[0] is not None and entry[0].done()]
            for k in done:
                del tr[k]

    def pump_replica(self, rid: int) -> int:
        """Pump ONE replica one dispatcher wave through the whole-replica
        fault seam, supervised.  Returns the requests it resolved; 0 for
        ejected and probation replicas (probes ride `maintain`).  A wave
        that failed its tickets with a DeviceError is evidence against the
        replica (the port's rule, module docstring)."""
        rep = self.replicas[rid]
        state = self.registry.state_of(rid)
        if state in (_health.REPLICA_EJECTED,
                     _health.REPLICA_PROBATION):
            return 0
        svc = rep.service
        errors_before = svc.totals.get("device_error_waves", 0)
        t_pump = self._clock.monotonic()
        ok, n = self._supervised(
            rep, lambda: svc.process_once(block=False))
        rep.latency.record((rid,), self._clock.monotonic() - t_pump)
        rep.pumps += 1
        if ok and svc.totals.get("device_error_waves", 0) > errors_before:
            with self._lock:
                self.totals["device_error_waves"] += 1
            _metrics.record_fault("federation_device_error_wave")
            self._on_replica_error(rep, svc.last_device_error)
        self._prune_tracked(rid)
        return n if (ok and n) else 0

    def maintain(self) -> None:
        """The non-wave ladder work: drained-empty replicas eject,
        probation replicas get their probes (revival included), and the
        dedup ledger sheds resolved entries."""
        self._advance_drains()
        self._run_probes()
        self._prune_front_dedup()

    def _prune_front_dedup(self) -> None:
        with self._lock:
            done = [k for k, ent in self._front_dedup.items()
                    if ent[0].done()]
            for k in done:
                del self._front_dedup[k]

    def process_once(self) -> int:
        """One dispatcher iteration: pump every placed (or draining)
        replica one wave, then `maintain`.  Returns requests resolved."""
        resolved = 0
        for rid in sorted(self.replicas):
            resolved += self.pump_replica(rid)
        self.maintain()
        return resolved

    def _advance_drains(self) -> None:
        for rid in self.registry.draining_replicas():
            rep = self.replicas[rid]
            if rep.service.stats()["queue_requests"] == 0:
                self._eject(rep, "drain complete")

    def _probe_batch(self, ordinal: int):
        """(expected verdict, Verifier) for one probe, truth by
        construction: even ordinals valid, odd ones carry one tampered
        message."""
        from .signing_key import SigningKey

        rnd = random.Random(_faults._stable_seed(
            self._probe_seed, "replica-probe", ordinal))
        keys = [SigningKey.new(rnd) for _ in range(2)]
        want = ordinal % 2 == 0
        v = _batch.Verifier()
        for j, sk in enumerate(keys):
            m = b"replica probe %d %d" % (ordinal, j)
            sig = sk.sign(m)
            if not want and j == 1:
                m += b"!"
            v.queue((sk.verification_key_bytes(), sig, m))
        return want, v

    def _run_probes(self) -> None:
        for rid in sorted(self.registry.probation_replicas()):
            rep = self.replicas[rid]
            if rep.crashed:
                # Revival through the factory (same namespaced caches,
                # dropped at ejection).  Sweep the old service first: a
                # submission that raced the ejection may still sit there.
                self._sweep_ejected(rep)
                rep.service = self._factory(rid, self._clock, rep.cache)
                rep.service.verdict_cache = rep.vcache
                if rep.vcache is not None \
                        and rep.vcache.journal() is not None:
                    _persist.reload(rep.vcache)
                rep.crashed = False
                rep.degraded_frac = None
                with self._lock:
                    self.totals["revivals"] += 1
                _metrics.record_fault("replica_revived")
            with self._lock:
                self._probe_ord += 1
                self.totals["probes"] += 1
                probe_ord = self._probe_ord
            want, v = self._probe_batch(probe_ord)

            def _probe(rep=rep, v=v):
                ticket = rep.service.submit(
                    v, cls=_tenancy.CLASS_RPC, tenant="_probe")
                rep.service.process_once(block=False)
                return ticket.result(0)

            ok, got = self._supervised(rep, _probe)
            if ok and got == want:
                if self.registry.record_probe_pass(rid):
                    with self._lock:
                        self.totals["rejoins"] += 1
                    _metrics.record_fault("replica_rejoined")
                    self._prewarm_from_peers(rep)
            else:
                with self._lock:
                    self.totals["probe_failures"] += 1
                self.registry.record_probe_fail(
                    rid, reason="probe verdict mismatch"
                    if ok else "probe dispatch failed")

    def _prewarm_from_peers(self, rep: Replica) -> None:
        """At rejoin, import every live peer's warm-digest hints into the
        replica's second-sight ledger, so the fleet's hot keysets build at
        their first post-rejoin sighting.  Hints carry no bytes and no
        trust (devcache.import_warm_hints)."""
        if rep.cache is None:
            return
        hints = []
        for rid2 in sorted(self.replicas):
            peer = self.replicas[rid2]
            if peer is rep or peer.crashed or peer.cache is None:
                continue
            hints.extend(peer.cache.export_warm_hints())
        if not hints:
            return
        accepted, refused = rep.cache.import_warm_hints(hints)
        with self._lock:
            self.totals["prewarm_hits"] += accepted
            self.totals["prewarm_refused"] += refused
        if accepted:
            _metrics.record_fault("replica_prewarm", accepted)

    def pump_forever(self, stop_event: "threading.Event") -> None:
        """Drive `process_once` until `stop_event` is set (an embedding's
        dispatcher thread; the labs call `process_once` directly)."""
        while not stop_event.is_set():
            if self.process_once() == 0:
                stop_event.wait(0.005)

    # -- observability + lifecycle ----------------------------------------

    def affinity_hit_rate(self) -> "float | None":
        with self._lock:
            s = (self.totals["submitted"]
                 - self.totals["rejected_overloaded"])
            hits = self.totals["affinity_hits"]
        return hits / s if s > 0 else None

    def stats(self) -> dict:
        """Fleet snapshot: per-replica state, capacity, queues and caches,
        the ladder ledger, affinity accounting and the lifetime totals."""
        with self._lock:
            totals = dict(self.totals)
            error_classes = dict(self.error_classes)
            dedup_by_replica = dict(self._dedup_by_replica)
        per = {}
        for rid in sorted(self.replicas):
            rep = self.replicas[rid]
            st = rep.service.stats()
            cst = rep.cache.stats()
            per[rid] = {
                "state": self.registry.state_of(rid),
                "suspicion": round(self.registry.suspicion(rid), 4),
                "capacity_fraction": round(rep.capacity_fraction(), 4),
                "queue_requests": st["queue_requests"],
                "queue_sigs": st["queue_sigs"],
                "submitted": st["submitted"],
                "resolved": st["resolved"],
                "breaker_state": st["breaker_state"],
                "devcache": {
                    "namespace": rep.cache.namespace,
                    "resident_keysets": cst["resident_keysets"],
                    "resident_bytes": cst["resident_bytes"],
                    "device_bytes": cst["device_bytes"],
                },
                "verdictcache": {
                    "namespace": (rep.vcache.namespace
                                  if rep.vcache is not None else None),
                    "resident_verdicts": (
                        rep.vcache.resident_count()
                        if rep.vcache is not None else 0),
                    "hits": st.get("verdict_cache_hits", 0),
                    "stores": st.get("verdict_cache_stores", 0),
                },
                "dedup_fanout": dedup_by_replica.get(rid, 0),
                "crashed": rep.crashed,
                "pumps": rep.pumps,
                "latency": {
                    "namespace": rep.latency.namespace,
                    **rep.latency.chip_stats().get(rid, {}),
                },
            }
        return {
            "replicas": per,
            "replica_states": self.registry.replica_states(),
            "affinity_hit_rate": self.affinity_hit_rate(),
            "error_classes": error_classes,
            **totals,
        }

    def close(self) -> None:
        """Stop admitting fleet-wide and drain every live replica (every
        pending request still resolves)."""
        with self._lock:
            self._closed = True
        for rid in sorted(self.replicas):
            rep = self.replicas[rid]
            state = self.registry.state_of(rid)
            if rep.crashed or state in (_health.REPLICA_EJECTED,
                                        _health.REPLICA_PROBATION):
                # not pumpable: re-issue whatever a racing submit left
                self._sweep_ejected(rep)
                continue
            rep.service.close(drain=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
