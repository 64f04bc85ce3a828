"""Deadline-aware verification service: the front door for concurrent
verification traffic (a copy of the JAX package's `service.py` over the
port's `verify_many`).

A consensus node does not call `batch.verify_many` itself: it submits
consensus, mempool and rpc traffic to `VerifyService`, which degrades
gracefully under load and device sickness without ever changing a verdict.
The ladder:

1. **Admit** — per-class bounded queues (capacity in SIGNATURES) with
   priority-aware admission (tenancy.py): each class sheds at its own
   watermark over the TOTAL queue depth, rpc first, mempool at the
   historical high/low pair; consensus never watermark-sheds, only a
   physically full queue rejects it.  Shedding disarms per class below its
   resume watermark.
2. **Memo** — a submission whose content digest finds a re-hashed memo
   (verdictcache.py) resolves at submit, with no queue occupancy and no
   device work; after each wave, every ladder-decided verdict is memoized
   for the next byte-identical submission (the mempool→block
   double-verify).
3. **Coalesce** — the dispatcher drains waves IN PRIORITY ORDER
   (consensus, mempool, rpc; FIFO within a class), decides identical
   submissions of one wave once (intra-wave dedup), and hands the wave to
   `verify_many`, whose union-merge coalesces compatible small batches.
4. **Route and shed** — a request whose deadline expired while queued is
   shed with `DeadlineExceeded` before dispatch; one whose remaining
   budget is below the device-wave estimate is decided on the host.
5. **Breaker** — device waves run behind a circuit breaker (closed → open
   → half-open): error waves, stalls and crashes count as failures; at the
   threshold the breaker opens and every wave runs on the host; after a
   seeded-jitter backoff one half-open probe wave (forced-device) decides
   whether it closes again.

Two rungs are the port's own:

* **The kernels load at construction.**  On a CUDA device the constructor
  builds and loads every kernel a verdict path launches
  (`ops/_cuda.load_all`), so a build or load failure raises there — the
  supervised executor would otherwise absorb it as a crash.
* **A device error wave fails its tickets.**  The port's `verify_many`
  raises `DeviceError` where the JAX package re-decides a failed chunk
  on the host.  The service records the breaker failure ("error", as the
  JAX service does for a wave whose stats carry device errors), counts
  it in `device_error_waves` (and the `service_device_error_wave`
  metric), and fails every ticket of the wave with that `DeviceError`:
  the host never decides what the device failed to, so a broken kernel
  shows on the tickets and not only on a counter.  Breaker transitions
  match the JAX service's; the wave's tickets are where the port departs
  from it on purpose (JAX resolves them with host verdicts).  Any other
  exception out of a device wave is the crash rung (`crash_fallbacks`,
  breaker failure "crash") and fails the wave's tickets the same way; on
  the host route a crash is still re-decided on the host.

The gray-failure half is in: a device wave passes its tightest request
deadline to `verify_many(deadline=)` (hedge affordability; the wave drains
consensus first, so consensus chunks claim the hedge budget first), and
`_note_device_outcome` rolls the wave's hedges and straggler accruals up
into `totals` and publishes them beside the latency ledger's gauges.
Left out until the port has them: the federation's `replica_id` and
`surrender_pending`.  Verdict-store persistence (`persist_dir`,
persist.py) is in.

Soundness is inherited: every verdict comes from `verify_many`'s ladder
(device rejects re-decided on the host) or from the host path — the
service chooses WHO does the work, never what the answer is.  Every
submitted request resolves to exactly one of {verdict, `Overloaded`,
`DeadlineExceeded`, `ServiceClosed`, the device wave's exception}:
nothing is lost (tools/load_soak.py).
"""

import threading
import time
from collections import deque

from . import batch as _batch
from . import config as _config
from . import health as _health
from . import routing as _routing
from . import tenancy as _tenancy
from .error import DeviceError, Error
from .utils import metrics as _metrics

__all__ = [
    "Overloaded", "DeadlineExceeded", "ServiceClosed",
    "CircuitBreaker", "VerifyTicket", "VerifyService",
    "BREAKER_CLOSED", "BREAKER_OPEN", "BREAKER_HALF_OPEN",
]


class Overloaded(Error):
    """The service's bounded queue cannot admit this submission (over
    capacity, or shedding above the high watermark)."""

    def __init__(self, detail: str = ""):
        super().__init__("Verification service overloaded."
                         + (f" ({detail})" if detail else ""))


class DeadlineExceeded(Error):
    """The request's deadline expired before it was dispatched."""

    def __init__(self):
        super().__init__("Verification deadline exceeded.")


class ServiceClosed(Error):
    """The service was closed before this request could be decided."""

    def __init__(self):
        super().__init__("Verification service closed.")


# Routed groups whose verify_many stats VerifyService.wave_stats keeps.
WAVE_STATS_KEPT = 4096

BREAKER_CLOSED = "closed"
BREAKER_HALF_OPEN = "half-open"
BREAKER_OPEN = "open"
_BREAKER_GAUGE = {BREAKER_CLOSED: 0, BREAKER_HALF_OPEN: 1,
                  BREAKER_OPEN: 2}


class CircuitBreaker:
    """Closed → open → half-open supervision of the device path.

    * CLOSED: device allowed.  `failure_threshold` CONSECUTIVE failures
      (error chunks, deadline blows, executor crashes) open it.
    * OPEN: device forbidden; `health.Backoff` arms a seeded-jitter
      exponential delay on the injected clock.  When the delay expires,
      the next `allow_device()` transitions to HALF-OPEN and grants one
      probe.
    * HALF-OPEN: exactly one probe wave is in flight; success closes
      the breaker (backoff reset), failure re-opens it with the next
      (longer) delay.  A probe that never measured the device counts as
      failure — an unobservable device is not a healthy one.

    All transitions are recorded in utils.metrics ("breaker_opened",
    "breaker_half_open", "breaker_closed") and mirrored in the
    "breaker_state" gauge.  Thread-safe; time comes only from the
    injected clock."""

    def __init__(self, clock: "_health.Clock | None" = None,
                 failure_threshold: int = 2,
                 backoff: "_health.Backoff | None" = None,
                 seed: int = 0):
        self.clock = clock if clock is not None else _health.SYSTEM_CLOCK
        self.failure_threshold = int(failure_threshold)
        self.backoff = backoff if backoff is not None else _health.Backoff(
            clock=self.clock, seed=seed)
        self._lock = threading.Lock()
        self._state = BREAKER_CLOSED
        self._consecutive_failures = 0
        self._transitions = []  # (state, clock time) history for tests

    def _enter(self, state: str) -> None:
        # under self._lock
        self._state = state
        self._transitions.append((state, self.clock.monotonic()))
        _metrics.record_fault(
            "breaker_" + {BREAKER_CLOSED: "closed",
                          BREAKER_HALF_OPEN: "half_open",
                          BREAKER_OPEN: "opened"}[state])
        _metrics.set_gauges({"breaker_state": _BREAKER_GAUGE[state]})

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def transitions(self) -> "list[tuple]":
        with self._lock:
            return list(self._transitions)

    def allow_device(self) -> "tuple[bool, bool]":
        """(allowed, is_probe): whether the next wave may touch the
        device, and whether it is the half-open probe (the dispatcher
        forces device participation on probes so they resolve)."""
        with self._lock:
            if self._state == BREAKER_CLOSED:
                return True, False
            if self._state == BREAKER_OPEN and self.backoff.expired():
                self._enter(BREAKER_HALF_OPEN)
                return True, True
            # OPEN with the delay still running, or HALF_OPEN with the
            # probe already granted (the dispatcher serializes waves, so
            # a second caller here means the probe is in flight).
            return False, False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if self._state != BREAKER_CLOSED:
                self.backoff.reset()
                self._enter(BREAKER_CLOSED)

    def record_failure(self, kind: str = "failure") -> None:
        with self._lock:
            self._consecutive_failures += 1
            if self._state == BREAKER_HALF_OPEN or (
                    self._state == BREAKER_CLOSED
                    and self._consecutive_failures
                    >= self.failure_threshold):
                self.backoff.arm()
                self._enter(BREAKER_OPEN)
            elif self._state == BREAKER_OPEN:
                # a failure while already open (e.g. the host fallback
                # noticed more damage): lengthen the wait
                self.backoff.arm()

    def __repr__(self):
        with self._lock:
            return (f"CircuitBreaker(state={self._state!r}, "
                    f"consecutive_failures={self._consecutive_failures}, "
                    f"backoff={self.backoff!r})")


class VerifyTicket:
    """Handle for one submitted batch: resolves to a verdict (bool) or
    raises the explicit outcome (`DeadlineExceeded`, `ServiceClosed`;
    `Overloaded` is raised at submit time and never reaches a ticket).
    `resolved_at` is the `time.perf_counter()` reading at which the
    outcome landed (None before): a latency stamp, never a decision
    input."""

    __slots__ = ("_event", "_outcome", "_value", "resolved_at")

    def __init__(self):
        self._event = threading.Event()
        self._outcome = None  # "ok" | "err"
        self._value = None
        self.resolved_at = None

    def _resolve(self, verdict: bool) -> None:
        self._outcome, self._value = "ok", bool(verdict)
        self.resolved_at = time.perf_counter()
        self._event.set()

    def _fail(self, exc: Exception) -> None:
        self._outcome, self._value = "err", exc
        self.resolved_at = time.perf_counter()
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: "float | None" = None) -> bool:
        """Block (wall time) for the outcome.  Returns the verdict or
        raises the request's explicit error; raises TimeoutError if the
        outcome has not landed within `timeout`."""
        if not self._event.wait(timeout):
            raise TimeoutError("verification result not ready")
        if self._outcome == "ok":
            return self._value
        raise self._value


class _Request:
    __slots__ = ("verifier", "deadline", "ticket", "sigs", "cls",
                 "tenant", "memo_digest", "memo_pins")

    def __init__(self, verifier, deadline, sigs,
                 cls=_tenancy.CLASS_MEMPOOL,
                 tenant=_tenancy.DEFAULT_TENANT,
                 memo_digest=None, memo_pins=None):
        self.verifier = verifier
        self.deadline = deadline  # absolute service-clock time or None
        self.ticket = VerifyTicket()
        self.sigs = sigs
        self.cls = cls
        self.tenant = tenant
        # The content digest and epoch-pin tuple the submission was
        # ADMITTED under (None = no live digest, or the verdict cache
        # was off at admission): the post-wave memo store re-derives
        # the payload and refuses to write under a digest the bytes no
        # longer hash to, OR under an epoch regime that moved while
        # the request was in flight (a mid-wave invalidation/rotation
        # exists precisely to forfeit these decisions).
        self.memo_digest = memo_digest
        self.memo_pins = memo_pins


class _HostOnlyHealth(_health.DeviceHealth):
    """A DeviceHealth that never allows the device: handing it to a
    hybrid verify_many IS the host route (the pure-host loop runs before
    any lane starts).  Shares the service clock so scheduling timestamps
    stay on one timeline."""

    def __init__(self, clock):
        super().__init__(mesh=0, clock=clock)

    def device_allowed(self) -> bool:
        return False


class VerifyService:
    """Bounded, deadline-aware, breaker-supervised verification front
    door over `batch.verify_many` — see the module docstring for the
    degradation ladder.

    Parameters (all optional — defaults serve a single-device node):

    * capacity_sigs / high_watermark / low_watermark / rpc_watermark —
      admission control: absolute signature capacity and the per-class
      shed/resume hysteresis fractions (tenancy.class_policies —
      high/low are the mempool class's pair, exactly the pre-tenancy
      semantics; rpc sheds at its own lower watermark; consensus-class
      never watermark-sheds).  Watermark defaults come from the
      ED25519_TPU_CLASS_WATERMARK_* knobs.
    * wave_max_batches — max requests drained per dispatcher wave.
    * chunk / hybrid / merge / mesh / policy / device — forwarded to
      `verify_many` (mesh=None keeps auto-routing; an explicit mesh is
      the manual override; device=None means CUDA, "cpu" runs the
      kernels' plain versions).  On a CUDA device the constructor
      builds and loads the verdict kernels, so a build failure raises
      here.
    * clock — injectable monotonic clock for ALL service time
      (deadlines, breaker backoff); `health.FakeClock` makes every
      admission/shed/breaker decision deterministic in tests.
    * breaker — injectable CircuitBreaker (built from `clock` and
      `breaker_seed` by default).
    * device_time_prior — seconds a device wave is assumed to take
      before the first measurement; a request whose remaining deadline
      budget is below the current estimate routes host-side.
    * auto_start — start the dispatcher thread; pass False for
      deterministic single-threaded tests driving `process_once()`.
    * cache — an injected DeviceOperandCache for tenant assignment
      (None = the process default): placement state, never a verdict
      input.
    * verdict_cache — an injected verdictcache.VerdictCache (None = the
      process default, resolved live).  Consulted at SUBMIT, before
      coalescing: a re-hashed hit resolves the ticket immediately — no
      queue occupancy, no watermark pressure, no device work — and the
      post-wave write path memoizes each ladder-decided verdict for the
      next byte-identical submission.  A hit replays a bit-identical
      past decision on bit-identical bytes.
    * persist_dir — the verdict journal's directory (persist.py; None =
      the ED25519_TPU_PERSIST_DIR knob, unset keeps the memo
      process-lifetime only).  Attached at the first memo-path submit,
      which loads the journal before any lookup could hit;
      `close(drain=True)` flushes it.

    Thread semantics: `submit` is callable from any number of threads;
    one dispatcher (thread or `process_once` caller) executes waves —
    the service SERIALIZES its own verify_many calls, and reading
    `batch.last_run_stats` right after each call is sound under that
    serialization (concurrent out-of-band verify_many callers would
    race the snapshot; run them through the service instead)."""

    def __init__(self, *, capacity_sigs: int = 65536,
                 high_watermark: "float | None" = None,
                 low_watermark: float = 0.50,
                 rpc_watermark: "float | None" = None,
                 wave_max_batches: int = 64,
                 chunk: int = 8, hybrid: bool = True, merge: str = "auto",
                 mesh: "int | None" = None,
                 policy: "_routing.RoutingPolicy | None" = None,
                 health: "_health.DeviceHealth | None" = None,
                 clock: "_health.Clock | None" = None,
                 breaker: "CircuitBreaker | None" = None,
                 breaker_failure_threshold: int = 2,
                 breaker_seed: int = 0,
                 device_time_prior: float = 2.0,
                 rng=None, auto_start: bool = True,
                 cache=None, verdict_cache=None, device=None,
                 persist_dir: "str | None" = None):
        # Per-class admission policy (tenancy.py): mempool keeps the
        # (high, low) watermark pair — the exact pre-tenancy admission
        # semantics and the class `submit()` defaults to — rpc sheds
        # at its own lower watermark, consensus only at a full queue.
        self.class_policies = _tenancy.class_policies(
            high_watermark=high_watermark,
            low_watermark=low_watermark,
            rpc_watermark=rpc_watermark)
        self.capacity_sigs = int(capacity_sigs)
        self.wave_max_batches = int(wave_max_batches)
        self.chunk = chunk
        self.hybrid = hybrid
        self.merge = merge
        self.mesh = mesh
        self.policy = policy
        self.health = health
        self.device = device
        if (device is None or str(device).startswith("cuda")) \
                and not _config.get("ED25519_TPU_DISABLE_DEVICE"):
            # Build and load every verdict kernel now: a failure raises
            # here, in the caller's thread, instead of being absorbed by
            # the supervised executor as a crash on the first wave.
            from .ops import _cuda, msm

            msm.resolve_device(device)
            _cuda.load_all()
        self._clock = clock if clock is not None else (
            health.clock if health is not None else _health.SYSTEM_CLOCK)
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            clock=self._clock,
            failure_threshold=breaker_failure_threshold,
            seed=breaker_seed)
        self._device_estimate = float(device_time_prior)
        self._rng = rng
        self._host_health = _HostOnlyHealth(self._clock)
        # The device operand cache tenant assignments land in (None = the
        # process default) and the cross-wave verdict cache (None = the
        # process default, resolved live so tests and knob flips take
        # effect).
        self.cache = cache
        self.verdict_cache = verdict_cache
        # Verdict-store persistence (persist.py): attached LAZILY at the
        # first memo-path submit, so recovery loads before the first
        # lookup could hit.
        self._persist_dir = persist_dir
        self._persist_attached = False

        self._cv = threading.Condition()
        # One FIFO queue per traffic class, drained in CLASSES priority
        # order; _queue_sigs is the TOTAL depth every class's watermark
        # is measured against (low classes react to overall pressure,
        # whoever caused it).
        self._queues: "dict[str, deque[_Request]]" = {
            cls: deque() for cls in _tenancy.CLASSES}
        self._queue_sigs = 0
        self._shedding_cls = {cls: False for cls in _tenancy.CLASSES}
        self._closed = False
        self.totals = {
            "submitted": 0, "resolved": 0, "rejected_overloaded": 0,
            "shed_deadline": 0, "waves": 0, "host_waves": 0,
            "device_waves": 0, "probe_waves": 0, "crash_fallbacks": 0,
            # Device-routed waves whose verify_many raised DeviceError;
            # their tickets carry it (the port's rung).
            "device_error_waves": 0,
            # Device-routed waves whose dominant keyset was resident at
            # route time, and chunk dispatches actually served from
            # residency (devcache.py).
            "devcache_hot_waves": 0, "devcache_dispatch_hits": 0,
            # Device waves dispatched on a reformed (degraded) mesh
            # shape instead of the configured one.
            "degraded_waves": 0,
            # Intra-wave dedup: requests whose verdict was decided by an
            # IDENTICAL concurrent submission of the same wave.
            "dedup_fanout": 0,
            # Cross-wave memoization: submissions resolved at the front
            # door from a re-hashed memo, and ladder-decided verdicts
            # written to the memo store after their wave.
            "verdict_cache_hits": 0, "verdict_cache_stores": 0,
            # The gray-failure defence: hedge pairs fired, won and lost
            # across device waves, and the straggler streaks the latency
            # ledger attributed.
            "hedges_fired": 0, "hedges_won": 0, "hedges_lost": 0,
            "straggler_suspicion_events": 0,
        }
        # Per-class lifecycle tallies (the fairness surface the traffic
        # lab and the SLO gates read): every submission lands in
        # exactly one of submitted -> {resolved, rejected_overloaded,
        # shed_deadline} within its class row.
        self.by_class = {
            cls: {"submitted": 0, "resolved": 0,
                  "rejected_overloaded": 0, "shed_deadline": 0}
            for cls in _tenancy.CLASSES}
        # The verify_many stats of the latest routed groups, oldest
        # first: ("device" | "host", batch.last_run_stats snapshot).
        self.wave_stats: "deque[tuple[str, dict]]" = deque(
            maxlen=WAVE_STATS_KEPT)
        self._thread = None
        if auto_start:
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name="ed25519-verify-service")
            self._thread.start()

    # -- admission ---------------------------------------------------------

    def now(self) -> float:
        return self._clock.monotonic()

    def effective_capacity_sigs(self) -> int:
        """The admission-capacity ESTIMATE the per-class watermarks are
        measured against — shrunk by the live healthy-chip fraction
        when the mesh is degraded.  Losing k of N chips cuts
        drain throughput ~k/N, so the same queue depth now represents
        proportionally more drain time; keeping watermarks at the
        full-mesh capacity would admit mempool/rpc load the degraded
        mesh cannot clear inside the consensus deadline.  Scaling the
        watermark base keeps them honest: lower classes shed EARLIER
        under degradation, which is exactly what preserves consensus
        headroom (consensus still never watermark-sheds, and the hard
        physical queue bound — host memory, not chip throughput —
        stays at the configured capacity).  ED25519_TPU_DEGRADED_
        CAPACITY=0 opts out; a host-forced service (mesh=0) never
        scales.

        The fraction is rung/width over the service's CONFIGURED
        dispatch width (the full device count under auto-routing): a
        chip dying OUTSIDE a narrow manual mesh costs this service
        nothing and must not shrink its watermarks, and the achievable
        rung (power-of-two, routing.reform_for) — not the raw healthy
        count — is what the dispatch actually shards over."""
        if self.mesh is not None and _health.normalize_mesh(self.mesh) == 0:
            return self.capacity_sigs
        # excluded = dead ∪ quarantined: a chip the suspicion ledger
        # pulled from placement costs drain throughput like a lost one.
        if not _health.chip_registry().excluded_chips():
            return self.capacity_sigs  # common case: one empty-set read
        if not _config.get("ED25519_TPU_DEGRADED_CAPACITY"):
            return self.capacity_sigs
        width = (_health.normalize_mesh(self.mesh)
                 if self.mesh is not None
                 else _routing.available_devices())
        if width < 2:
            return self.capacity_sigs
        rung, _ids = _routing.reform_for(width)
        if rung >= width:
            return self.capacity_sigs
        return max(1, int(self.capacity_sigs * max(rung, 1) / width))

    def _watermark_sigs(self, cls: str, resume: bool = False
                        ) -> "float | None":
        """The class's shed (or resume) watermark in SIGNATURES, over
        the CURRENT effective capacity — recomputed per decision so
        degradation (and heal/rejoin) moves the thresholds live."""
        p = self.class_policies[cls]
        frac = p.resume_watermark if resume else p.shed_watermark
        return None if frac is None else frac * self.effective_capacity_sigs()

    def submit(self, entries, deadline: "float | None" = None,
               timeout: "float | None" = None,
               cls: "str | None" = None,
               tenant: "str | None" = None) -> VerifyTicket:
        """Submit one batch: a `batch.Verifier` (ownership transfers to
        the service — do not mutate or verify it afterwards) or an
        iterable of `(vk_bytes, sig, msg)` entries.  `deadline` is an
        absolute service-clock time, `timeout` a relative convenience
        (both given: the earlier wins); None means no deadline.

        `cls` names the traffic class (tenancy.CLASSES; default
        mempool — the pre-tenancy admission semantics): it decides the
        admission watermark and the wave drain priority, NEVER the
        verdict.  `tenant` tags the batch's recurring keyset for the
        device operand cache's per-tenant residency quotas (cache
        QoS); it too is purely a resource-placement hint.

        Returns a `VerifyTicket`; raises `Overloaded` when the bounded
        queue cannot admit the batch (beyond capacity, or the class is
        shedding above its watermark) and `ServiceClosed` after
        `close()`.  Admission is decided HERE, synchronously — an
        admitted request is never later dropped for load."""
        if cls is None:
            cls = _tenancy.CLASS_MEMPOOL
        _tenancy.class_rank(cls)  # unknown class names fail loudly
        if isinstance(entries, _batch.Verifier):
            v = entries
        else:
            v = _batch.Verifier()
            v.queue_bulk(list(entries))
        if timeout is not None:
            t = self.now() + float(timeout)
            deadline = t if deadline is None else min(deadline, t)
        # Verdict memoization, PRE-coalescing: a submission whose
        # content digest finds a re-hashed memo resolves RIGHT HERE — it never occupies the queue, never moves a watermark,
        # never reaches a wave.  The served verdict is a bit-identical
        # past decision of the full ladder on bit-identical bytes
        # (verdictcache.py's per-hit re-hash is unconditional — the
        # consensus-class serve rule holds for every class); a miss,
        # a None digest, or a disabled cache all fall through to the
        # normal admission path — full verification is the default.
        memo_digest = None
        memo_pins = None
        tenant_name = (tenant if tenant is not None
                       else _tenancy.DEFAULT_TENANT)
        vc = self._verdict_cache()
        if vc is not None:
            if not self._persist_attached:
                # One-time persistence attach: recovery LOADS the journal,
                # then registers write-through appends.  No directory
                # configured → a cheap no-op; the flag keeps the knob read
                # off the steady-state submit path.
                self._persist_attached = True
                from . import persist as _persist

                _persist.attach(vc, directory=self._persist_dir)
            memo_digest = v.content_digest()
            if memo_digest is not None:
                hit = vc.lookup(memo_digest, tenant=tenant_name)
                if hit is not None:
                    with self._cv:
                        if self._closed:
                            raise ServiceClosed()
                        self.totals["submitted"] += 1
                        self.by_class[cls]["submitted"] += 1
                        self.totals["verdict_cache_hits"] += 1
                        self.totals["resolved"] += 1
                        self.by_class[cls]["resolved"] += 1
                    _metrics.record_fault("service_verdict_cache_hit")
                    ticket = VerifyTicket()
                    ticket._resolve(hit.verdict)
                    return ticket
                # Miss: capture the epoch regime this request will be
                # DECIDED under — the store refuses if it moves while
                # the request is in flight.
                memo_pins = vc.epoch_pins(tenant_name)
        req = _Request(v, deadline, v.batch_size, cls=cls,
                       tenant=tenant_name,
                       memo_digest=memo_digest, memo_pins=memo_pins)
        # Tenant assignment happens BEFORE enqueue: the verifier is
        # still private here (after append the dispatcher may be
        # staging it concurrently), and the partition must be on
        # record before any dispatch could possibly build the keyset —
        # an assignment landing after the enqueue could lose the race
        # and build into the default partition, softening the
        # never-cross-partition eviction guarantee until restage.  The
        # map write is idempotent placement metadata keyed by digest,
        # so a subsequently-rejected submission leaves nothing
        # harmful behind.
        if tenant is not None:
            self._assign_tenant(v, tenant)
        with self._cv:
            if self._closed:
                raise ServiceClosed()
            self.totals["submitted"] += 1
            self.by_class[cls]["submitted"] += 1
            # Per-class watermark hysteresis over TOTAL depth: crossing
            # the class's shed watermark arms shedding for THAT class;
            # only draining below its resume watermark (dispatcher
            # side) disarms it.  Consensus-class has no watermark —
            # only the hard capacity check below can reject it.
            # Watermarks are measured against the EFFECTIVE capacity
            # (shrunk under mesh degradation) so they stay
            # honest about drain time; the hard bound below stays at
            # the configured capacity (host memory, not chip count).
            high = self._watermark_sigs(cls)
            if high is not None and self._queue_sigs >= high:
                self._set_shedding(cls, True)
            if self._shedding_cls[cls]:
                self.totals["rejected_overloaded"] += 1
                self.by_class[cls]["rejected_overloaded"] += 1
                _metrics.record_fault("service_reject_overloaded")
                _metrics.record_fault(
                    f"service_reject_overloaded_{cls}")
                raise Overloaded(
                    f"{cls}-class shedding above its watermark "
                    f"({self._queue_sigs} sigs queued)")
            if self._queue_sigs + req.sigs > self.capacity_sigs:
                self.totals["rejected_overloaded"] += 1
                self.by_class[cls]["rejected_overloaded"] += 1
                _metrics.record_fault("service_reject_overloaded")
                _metrics.record_fault(
                    f"service_reject_overloaded_{cls}")
                raise Overloaded(
                    f"queue full ({self._queue_sigs}+{req.sigs} "
                    f"> {self.capacity_sigs} sigs)")
            self._queues[cls].append(req)
            self._queue_sigs += req.sigs
            self._update_gauges()
            self._cv.notify_all()
        return req.ticket

    def _assign_tenant(self, verifier, tenant: str) -> None:
        """Tag the batch's keyset content address with its tenant
        partition in the device operand cache (quota accounting,
        devcache.py).  No-op when the cache is off or the verifier has
        no canonical keyset blob (mixed construction paths) — those
        batches simply stay in the default partition; placement is an
        optimization hint, never correctness state."""
        from . import devcache as _devcache

        cache = (self.cache if self.cache is not None
                 else _devcache.default_cache())
        if not cache.enabled:
            return
        blob = verifier._canonical_keyset_blob()
        if blob:
            cache.assign_tenant(_devcache.keyset_digest(blob), tenant)

    def _verdict_cache(self):
        """The live verdict-cache instance (injected, else the process
        default), or None when memoization is disabled — submit's hit
        path and process_once's store path both resolve through here so
        knob flips and test injection take effect immediately."""
        from . import verdictcache as _verdictcache

        vc = (self.verdict_cache if self.verdict_cache is not None
              else _verdictcache.default_cache())
        return vc if vc.enabled else None

    def _set_shedding(self, cls: str, flag: bool) -> None:
        # under self._cv
        if self._shedding_cls[cls] != flag:
            self._shedding_cls[cls] = flag
            _metrics.set_gauges({
                f"service_shedding_{cls}": int(flag),
                "service_shedding": int(any(self._shedding_cls.values())),
            })

    def _update_gauges(self) -> None:
        # under self._cv
        _metrics.set_gauges({
            "service_queue_sigs": self._queue_sigs,
            "service_queue_requests":
                sum(len(q) for q in self._queues.values()),
            **{f"service_queue_requests_{cls}": len(q)
               for cls, q in self._queues.items()},
        })

    # -- dispatch ----------------------------------------------------------

    def _queued_requests(self) -> int:
        # under self._cv
        return sum(len(q) for q in self._queues.values())

    def _take_wave(self, block: bool) -> "list[_Request]":
        with self._cv:
            if block:
                while not self._queued_requests() and not self._closed:
                    self._cv.wait(0.05 if self._clock.virtual else None)
            # Priority drain: consensus first, then mempool, then rpc
            # (FIFO within each class) — under overload the wave is
            # consensus-heavy by construction, which is what holds the
            # high-class p99 while low classes queue and shed.
            wave = []
            for cls in _tenancy.CLASSES:
                q = self._queues[cls]
                while q and len(wave) < self.wave_max_batches:
                    req = q.popleft()
                    self._queue_sigs -= req.sigs
                    wave.append(req)
            # Per-class hysteresis disarm: a class resumes admitting
            # once TOTAL depth drains below its resume watermark
            # (over the live effective capacity, like the shed side).
            for cls in self.class_policies:
                low = self._watermark_sigs(cls, resume=True)
                if (self._shedding_cls[cls] and low is not None
                        and self._queue_sigs <= low):
                    self._set_shedding(cls, False)
            self._update_gauges()
            return wave

    def process_once(self, block: bool = False) -> int:
        """One dispatcher iteration: drain a wave, shed expired
        requests, route, execute, resolve.  Returns the number of
        requests resolved.  The background dispatcher calls this in a
        loop; tests with `auto_start=False` call it directly for
        deterministic single-threaded scheduling."""
        wave = self._take_wave(block)
        if not wave:
            return 0
        now = self.now()
        live, shed = [], []
        for req in wave:
            if req.deadline is not None and now >= req.deadline:
                # Shed BEFORE dispatch: expired requests must not spend
                # device/host time, and must resolve explicitly.
                shed.append(req)
            else:
                live.append(req)
        if shed:
            # Tallies land under the lock — stats() publishes a
            # snapshot under _cv, so dispatcher-thread increments
            # racing it are torn reads (CL008).  Ticket resolution
            # stays OUTSIDE the lock (CL009: no effects under locks).
            with self._cv:
                for req in shed:
                    self.totals["shed_deadline"] += 1
                    self.by_class[req.cls]["shed_deadline"] += 1
            for req in shed:
                _metrics.record_fault("service_shed_deadline")
                req.ticket._fail(DeadlineExceeded())
        resolved = len(shed)
        if not live:
            with self._cv:
                self.totals["waves"] += 1
            return resolved

        # Route: requests whose remaining budget is below the device
        # wave estimate fall back host-side NOW (the in-flight rung of
        # the ladder); the rest go wherever the breaker allows.
        urgent, routable = [], []
        with self._cv:
            device_estimate = self._device_estimate
        for req in live:
            if (req.deadline is not None
                    and req.deadline - now < device_estimate):
                urgent.append(req)
            else:
                routable.append(req)
        probe = False
        if routable:
            # Consult the breaker ONLY when a device wave would actually
            # run: allow_device() consumes the half-open probe token,
            # and granting it to a wave that turns out to be all-urgent
            # (likely exactly during an outage, when deadline-carrying
            # traffic is backed up) would latch the breaker HALF_OPEN
            # forever — no probe ever executes, no transition ever
            # fires, the device is silently lost.
            allowed, probe = self.breaker.allow_device()
            if not allowed:
                urgent, routable = urgent + routable, []
        with self._cv:
            self.totals["waves"] += 1
            if urgent:
                self.totals["host_waves"] += 1
            if routable:
                self.totals["device_waves"] += 1
                if probe:
                    self.totals["probe_waves"] += 1
        if urgent:
            _metrics.record_fault("service_host_routed_waves")
            self._execute(urgent, device=False, probe=False)
        if routable:
            self._execute(routable, device=True, probe=probe)
        # Verdict memoization, the WRITE path: runs AFTER the wave's
        # verdict aggregation returned and every ticket is sealed —
        # nothing reachable from _execute's aggregation writes cache
        # state as a side effect of deciding.
        self._store_verdicts(live)
        return resolved + len(live)

    def _store_verdicts(self, reqs) -> None:
        """Memoize each ladder-decided verdict of a completed wave.
        Pure bookkeeping over ALREADY-resolved tickets — by the time
        this runs, every waiter could have read its verdict; nothing
        here can change one.  The store itself re-derives the content
        payload and refuses to write when it no longer hashes to the
        admission-time digest (verdictcache.store), so an invalidate()
        or map exposure that landed mid-flight memoizes nothing."""
        vc = self._verdict_cache()
        if vc is None:
            return
        stored = 0
        for req in reqs:
            t = req.ticket
            if req.memo_digest is None or not t.done() \
                    or t._outcome != "ok":
                continue
            if vc.store(req.verifier, t._value, cls=req.cls,
                        tenant=req.tenant if req.tenant is not None
                        else _tenancy.DEFAULT_TENANT,
                        expected_digest=req.memo_digest,
                        expected_pins=req.memo_pins):
                stored += 1
        if stored:
            with self._cv:
                self.totals["verdict_cache_stores"] += stored

    def _execute(self, reqs, device: bool, probe: bool) -> None:
        """Run one routed group through verify_many under supervision:
        whatever happens — device sickness, injected storms, even an
        exception escaping the scheduler — every ticket resolves (after
        a device wave's failure, to its exception), and verdicts only
        ever come from ladder-decided math.

        INTRA-WAVE DEDUP: real consensus nodes verify the same (sig, key, msg) set
        more than once — mempool admission, then the proposed block —
        and under load those duplicates land in the SAME dispatcher
        wave.  Identical concurrent submissions (byte-identical queue
        streams, `Verifier.content_digest()`) are decided ONCE and the
        verdict fanned out to every waiter: bit-identical by
        construction, since all waiters receive the single
        ladder-decided bool — dedup chooses how often the work runs,
        never what the answer is.  Batches without a live content
        digest (exposed coalescing map, out-of-band invalidation)
        never dedup — full verification is always the safe default."""
        reps, rep_of, seen = [], [], {}
        dedup = 0
        for r in reqs:
            d = r.verifier.content_digest()
            if d is not None and d in seen:
                rep_of.append(seen[d])
                dedup += 1
                _metrics.record_fault("service_dedup_fanout")
                continue
            if d is not None:
                seen[d] = len(reps)
            rep_of.append(len(reps))
            reps.append(r.verifier)
        if dedup:
            with self._cv:
                self.totals["dedup_fanout"] += dedup
        vs = reps
        try:
            if device:
                # Device waves dispatch the REFORMED mesh shape, not
                # the configured one: a manual mesh=D whose
                # chips partially died runs — and, critically, a
                # half-open breaker PROBES — the surviving rung.  A
                # probe forced onto the dead full-width shape would
                # fail forever and re-open the breaker on a perfectly
                # healthy degraded mesh, silently losing the device
                # path until full heal.  verify_many applies the same
                # clamp internally; resolving it here keeps the wave
                # accounting (degraded_waves) on the service surface.
                mesh_arg = self.mesh
                if (mesh_arg is not None
                        and _health.normalize_mesh(mesh_arg) > 1
                        and _health.chip_registry().excluded_chips()):
                    cfg_mesh = _health.normalize_mesh(mesh_arg)
                    rung, _ids = _routing.reform_for(cfg_mesh)
                    mesh_arg = rung if rung > 1 else 0
                    if mesh_arg != cfg_mesh:
                        # counted only when the resolved shape actually
                        # changed — a dead chip OUTSIDE this rung is
                        # not a degraded dispatch
                        with self._cv:
                            self.totals["degraded_waves"] += 1
                # Probe waves force device participation (hybrid=False):
                # a half-open breaker needs evidence, and a host-raced
                # probe that never measures the device would stay
                # half-open forever.  The wave's tightest request deadline
                # bounds hedging.
                dls = [r.deadline for r in reqs if r.deadline is not None]
                verdicts = _batch.verify_many(
                    vs, rng=self._rng, chunk=self.chunk,
                    hybrid=False if probe else self.hybrid,
                    merge=self.merge, mesh=mesh_arg,
                    health=self.health, policy=self.policy,
                    device=self.device,
                    deadline=min(dls) if dls else None)
                stats = dict(_batch.last_run_stats)
                self.wave_stats.append(("device", stats))
                self._note_device_outcome(stats, probe)
            else:
                # The host route: a hybrid call on a health that never
                # allows the device runs the pure-host loop, so the
                # device named here is never touched ("cpu" resolves
                # without a card).
                verdicts = _batch.verify_many(
                    vs, rng=self._rng, chunk=self.chunk, hybrid=True,
                    merge=self.merge, mesh=0, health=self._host_health,
                    device="cpu")
                self.wave_stats.append(
                    ("host", dict(_batch.last_run_stats)))
        except Exception as exc:
            if device:
                # The host never decides what the device failed to: every
                # batch of a device wave carries the exception.  A
                # DeviceError (a chunk's kernel failed to launch or
                # faulted, where the JAX package re-decides it on the
                # host) is the breaker failure "error" the JAX service
                # records for a wave whose stats carry device errors;
                # anything else is the supervised executor's crash.
                if isinstance(exc, DeviceError):
                    with self._cv:
                        self.totals["device_error_waves"] += 1
                    _metrics.record_fault("service_device_error_wave")
                    self.breaker.record_failure("error")
                else:
                    with self._cv:
                        self.totals["crash_fallbacks"] += 1
                    _metrics.record_fault("service_crash_fallback")
                    self.breaker.record_failure("crash")
                verdicts = [exc] * len(vs)
            else:
                # Supervised-executor rung of the host route: an exception
                # out of verify_many must neither lose requests nor poison
                # the service; every batch is re-decided host-side.
                with self._cv:
                    self.totals["crash_fallbacks"] += 1
                _metrics.record_fault("service_crash_fallback")
                verdicts = []
                for v in vs:
                    try:
                        verdicts.append(_batch._host_verdict(v, self._rng))
                    except Exception as host_exc:
                        # the host path itself failed: the ticket
                        # carries the evidence
                        verdicts.append(host_exc)
        for req, ri in zip(reqs, rep_of):
            verdict = verdicts[ri]
            if isinstance(verdict, Exception):
                req.ticket._fail(verdict)
            else:
                req.ticket._resolve(verdict)
        with self._cv:
            for req in reqs:
                self.totals["resolved"] += 1
                self.by_class[req.cls]["resolved"] += 1

    def _note_device_outcome(self, stats: dict, probe: bool) -> None:
        """Feed one device-routed wave's verify_many stats to the
        breaker and the wave-time estimate."""
        dc = stats.get("devcache") or {}
        hedge_keys = ("hedges_fired", "hedges_won", "hedges_lost",
                      "straggler_suspicion_events")
        with self._cv:
            if dc.get("hit"):
                self.totals["devcache_hot_waves"] += 1
            self.totals["devcache_dispatch_hits"] += dc.get(
                "dispatch_hits", 0)
            for k in hedge_keys:
                self.totals[k] += stats.get(k, 0)
            hedge_snap = {k: self.totals[k] for k in hedge_keys}
        # Published outside the lock.
        led = _health.chip_registry().latency
        _metrics.set_gauges({
            "latency_mesh_median_us": led.mesh_median_us(),
            "latency_wave_p95_us": led.wave_quantile_us(950),
            **hedge_snap,
        })
        failed = bool(stats.get("device_sick")) \
            or stats.get("device_errors", 0) > 0
        participated = (
            stats.get("device_batches", 0)
            + stats.get("device_unions", 0)
            + stats.get("device_rejects_confirmed", 0)
            + stats.get("device_rejects_overturned", 0))
        if failed:
            self.breaker.record_failure(
                "stall" if stats.get("device_sick") else "error")
        elif participated:
            self.breaker.record_success()
            # EMA of the device wave time — the in-flight deadline
            # rung's estimate of "how long does handing a wave to the
            # device risk taking".
            dt = float(stats.get("seconds", 0.0))
            if dt > 0:
                with self._cv:
                    self._device_estimate = (
                        0.6 * self._device_estimate + 0.4 * dt)
        elif probe:
            # The forced-device probe never measured the device (e.g. a
            # cold-shape compile grace drained everything host-side):
            # an unobservable device is not a healthy one — back off
            # again rather than flapping closed.
            self.breaker.record_failure("probe_unresolved")

    def _run(self) -> None:
        while True:
            with self._cv:
                if self._closed and not self._queued_requests():
                    return
            self.process_once(block=True)

    # -- lifecycle ---------------------------------------------------------

    def stats(self) -> dict:
        """Snapshot: queue depth, admission state, breaker state, the
        lifetime totals, and the per-class fairness rows."""
        with self._cv:
            reg = _health.chip_registry()
            return {
                "queue_sigs": self._queue_sigs,
                "effective_capacity_sigs": self.effective_capacity_sigs(),
                # The diagnosed chip ledger an operator reads next to the
                # capacity shrink.
                "quarantined_chips": sorted(reg.quarantined_chips()),
                "probation_chips": sorted(reg.probation_chips()),
                "queue_requests": self._queued_requests(),
                "queue_requests_by_class": {
                    cls: len(q) for cls, q in self._queues.items()},
                "shedding": any(self._shedding_cls.values()),
                "shedding_by_class": dict(self._shedding_cls),
                "closed": self._closed,
                "breaker_state": self.breaker.state,
                "device_estimate_s": self._device_estimate,
                "by_class": {cls: dict(row)
                             for cls, row in self.by_class.items()},
                **self.totals,
            }

    def close(self, drain: bool = True) -> None:
        """Stop admitting; by default DRAIN the queue (every pending
        request still resolves — nothing lost), then stop the
        dispatcher and flush the verdict journal (fsync policy
        permitting).  `drain=False` resolves pending requests with
        `ServiceClosed` instead (still explicit, still nothing lost)."""
        pending = []
        with self._cv:
            self._closed = True
            if not drain:
                for q in self._queues.values():
                    pending.extend(q)
                    q.clear()
                self._queue_sigs = 0
                self._update_gauges()
            self._cv.notify_all()
        for req in pending:
            req.ticket._fail(ServiceClosed())
        if pending:
            with self._cv:
                for req in pending:
                    self.totals["resolved"] += 1
                    self.by_class[req.cls]["resolved"] += 1
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            self._thread = None
        else:
            while drain and self.process_once(block=False):
                pass
        if drain:
            # Every verdict the drain decided is already appended; the
            # flush forces the records to the platter so a clean shutdown
            # restarts warm.  A hard kill skips this by definition.
            vc = self._verdict_cache()
            journal = vc.journal() if vc is not None else None
            if journal is not None:
                journal.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
