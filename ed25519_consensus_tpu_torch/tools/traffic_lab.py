"""Open-loop traffic lab: the service SLO proof at production shape — the
port of the JAX package's tools/traffic_lab.py.

Where tools/load_soak.py drives closed-loop storms (every submitter waits
for its previous ticket), this lab replays an OPEN-LOOP arrival schedule —
seeded Poisson / burst / diurnal processes over a mixed tenant-class matrix
(tenancy.py) — against a `VerifyService` on an injected virtual clock, and
reports the SLO surface as a `service_slo` block:

* p50/p99/p999/max verdict latency PER CLASS (virtual seconds),
* shed rate per class (admission `Overloaded` + `DeadlineExceeded`),
* breaker transition count,
* per-tenant device-operand-cache hit rates (``--device`` runs), and
* a replay digest: with a pinned rate the whole run is a pure function of
  the seed, and equal to the JAX tool's at the same seed and rate.

Time model: arrivals, deadlines, admission decisions and wave completions
all live on a `health.FakeClock`.  Real verification runs for every wave
and verdicts are checked against the construction oracle, but a wave's
VIRTUAL cost is `overhead + live_sigs / service_rate`, with `service_rate`
calibrated on the host or pinned with --service-rate.  A pinned rate draws
the arrival processes at itself, as the JAX tool does.  A calibrated rate
changes from run to run with the host's speed, so its schedule is drawn at
`CALIBRATED_DRAW_RATE` and scaled to it: which requests shed and every
verdict are then a pure function of the seed, and only the times (and the
digest, which holds them) follow the host.  Offered load is
``--load`` (default 0.8) of that capacity.  Queue capacity is a fraction
of the run's volume and deadlines are in capacity-drain units (T_cap =
capacity_sigs / service_rate seconds).

Modes: the single-service lab (`run_lab`; ``--device`` sends forced-device
waves one batch a chunk through the kernels on ``--torch-device``, the card
by default, with per-tenant residency, tenant rotation and, with
``--rotation-faults``, a rotation fault window — its DeviceHealth runs on
the lab's FakeClock, so a device call's deadline never self-elapses and
the run stays a pure function of the seed); ``--fleet M`` (`run_fleet`,
a `federation.ReplicaSet` of M host-modelled replicas, with
``--replica-crash`` a seeded ReplicaCrash mid-run); ``--load-sweep``
(`run_load_sweep`, the latency-vs-load curve); ``--slow-chip``
(`run_gray_failure`, the hedging-off/on pair on the slow-chip cost model).

Gates (exit nonzero on violation): nothing lost; verdicts host-identical;
consensus shed rate zero while rpc sheds (--require-rpc-shed, on by
default); consensus p99 under its deadline; in fleet mode also the
affinity hit rate, and with a crash the ejection, the rejoin, rpc sheds on
the survivors and post-rejoin affinity.

Usage:
  python -m ed25519_consensus_tpu_torch.tools.traffic_lab [--seed N]
      [--requests 800] [--load 0.8] [--service-rate SIGS_PER_S]
      [--capacity-frac 0.05] [--device] [--torch-device cuda:0]
      [--rotate-every-frac 0.25] [--rotation-faults]
      [--fleet 3 --replica-crash] [--load-sweep 0.5:1.2:8] [--slow-chip]
      [--json]
"""

import argparse
import functools
import hashlib
import json
import os
import random
import sys
import time

from .. import (SigningKey, batch, config, devcache, faults, federation,
                health, routing, service, tenancy, verdictcache)
from ..utils import metrics

# The JAX knobs ED25519_TPU_TRAFFIC_LAB_SEED and ED25519_TPU_FLEET_LAB_SEED's
# defaults (the port keeps lab seeds out of its knob registry).
DEFAULT_SEED = 0x7AFF1C
FLEET_SEED = 0xF1EE7

# One mixing construction per process: replay digests from the lab and
# schedules from the library must never silently diverge.
_stable_seed = tenancy._stable_seed


# The rate a calibrated run's arrival schedule is drawn at (signatures per
# second of virtual time) before it is scaled to the measured rate.
CALIBRATED_DRAW_RATE = 1.0


def calibrate_service_rate(seed: int, sigs: int = 4,
                           batches: int = 32) -> float:
    """Measured pure-host verification capacity (signatures/second) of
    THIS host — the denominator of the 80%-of-capacity claim.  Uses
    time.perf_counter (metrics timing, not scheduler time — the
    injected-clock rule CL002 covers scheduler/service timestamps)."""
    rnd = random.Random(_stable_seed(seed, "calibrate"))
    keys = [SigningKey.new(rnd) for _ in range(sigs)]
    vs = []
    for b in range(batches):
        v = batch.Verifier()
        for j, sk in enumerate(keys):
            m = b"calibrate %d %d" % (b, j)
            v.queue((sk.verification_key_bytes(), sk.sign(m), m))
        vs.append(v)
    rng = random.Random(_stable_seed(seed, "calibrate-rng"))
    t0 = time.perf_counter()
    for v in vs:
        batch._host_verdict(v, rng)
    dt = max(time.perf_counter() - t0, 1e-6)
    return (batches * sigs) / dt


def service_rate(cfg) -> "tuple[float, float | None]":
    """(rate, draw_rate) of a run: the virtual service rate, and the rate
    its arrival schedule is drawn at (None: at `rate` itself).  A pinned
    `cfg.service_rate` draws at `cfg.draw_rate` when a caller carried one
    over from a calibration, else at itself; a calibrated rate draws at
    `CALIBRATED_DRAW_RATE`."""
    if cfg.service_rate:
        return cfg.service_rate, getattr(cfg, "draw_rate", None)
    return calibrate_service_rate(cfg.seed), CALIBRATED_DRAW_RATE


@functools.lru_cache(maxsize=256)
def tenant_keyset(seed: int, tenant: str, generation: int,
                  sigs: int) -> "tuple":
    """The validator keyset of `tenant` at rotation `generation` —
    fresh deterministic keys per (tenant, generation), so an epoch
    rotation really is a disjoint keyset (new content address, full
    devcache churn).  Memoized: key generation is scalar-mult-priced
    and every request of a generation shares one keyset."""
    rnd = random.Random(_stable_seed(seed, "keys", tenant, generation))
    return tuple(SigningKey.new(rnd) for _ in range(sigs))


class LabRequest:
    """One submitted batch and its full open-loop accounting.  The
    fleet-mode fields (`fed`, `home`, `affinity_hit`, `replica`) stay
    None in the classic single-service runs."""

    __slots__ = ("stream_idx", "seq", "arrival", "cls", "tenant",
                 "sigs", "want", "verifier", "ticket", "kind",
                 "verdict", "done_at", "deadline",
                 "fed", "home", "affinity_hit", "replica")

    def __init__(self, stream_idx, seq, arrival, cls, tenant, sigs,
                 want, verifier, deadline):
        self.stream_idx = stream_idx
        self.seq = seq
        self.arrival = arrival
        self.cls = cls
        self.tenant = tenant
        self.sigs = sigs
        self.want = want
        self.verifier = verifier
        self.deadline = deadline
        self.ticket = None
        self.kind = None       # "verdict" | "overloaded" | "shed_deadline"
        self.verdict = None
        self.done_at = None
        self.fed = None
        self.home = None
        self.affinity_hit = None
        self.replica = None


def build_schedule(matrix, seed, requests_target, load, rate,
                   draw_rate=None):
    """The full arrival schedule: [(t, stream_idx, seq)] sorted by
    (t, stream_idx, seq) — a pure function of (matrix, seed,
    requests_target, load, rate-derived horizon).  With `draw_rate` the
    processes are drawn at that rate and every time is scaled by
    draw_rate / rate: the same events, in the same order, at `rate`."""
    if draw_rate is not None and draw_rate != rate:
        events, horizon = build_schedule(matrix, seed, requests_target,
                                         load, draw_rate)
        k = draw_rate / rate
        return [(t * k, si, j) for t, si, j in events], horizon * k
    mean_sigs = sum(s.fraction * s.sigs for s in matrix) / sum(
        s.fraction for s in matrix)
    horizon = requests_target * mean_sigs / (load * rate)
    events = []
    for si, stream in enumerate(matrix):
        lam = load * rate * stream.fraction / stream.sigs  # batches/s
        kw = dict(stream.kind_kw)
        # Periodic structure scales with the horizon so the same
        # scenario shape replays at any calibrated rate.
        if stream.kind == "burst":
            kw.setdefault("burst_every", horizon / 3.0)
            kw.setdefault("burst_len", horizon / 12.0)
            kw.setdefault("burst_factor", 4.0)
        elif stream.kind == "diurnal":
            kw.setdefault("period", horizon / 2.0)
            kw.setdefault("amplitude", 0.5)
        times = tenancy.arrivals(stream.kind, lam, horizon,
                                 seed=_stable_seed(seed, "arrivals", si),
                                 **kw)
        events.extend((t, si, k) for k, t in enumerate(times))
    events.sort()
    return events, horizon


def build_request(matrix, seed, si, seq, t, rotate_every,
                  deadline_scale, clock_start):
    """Construct the batch for one arrival: keyset of the stream's
    tenant at the CURRENT rotation generation, seeded tampering, host
    oracle truth by construction."""
    stream = matrix[si]
    gen = int(t // rotate_every) if rotate_every else 0
    keys = tenant_keyset(seed, stream.tenant, gen, stream.sigs)
    rnd = random.Random(_stable_seed(seed, "batch", si, seq))
    bad_at = (rnd.randrange(stream.sigs)
              if rnd.random() < stream.bad_rate else -1)
    v = batch.Verifier()
    for j, sk in enumerate(keys):
        m = b"lab %d %d %d" % (si, seq, j)
        sig = sk.sign(m)
        if j == bad_at:
            m += b"!"
        v.queue((sk.verification_key_bytes(), sig, m))
    deadline = (None if stream.deadline_s is None
                else clock_start + t + stream.deadline_s * deadline_scale)
    return LabRequest(si, seq, t, stream.cls, stream.tenant,
                      stream.sigs, bad_at < 0, v, deadline), gen


def run_lab(cfg) -> dict:
    """One full open-loop run; returns the service_slo summary dict
    (cfg is the argparse namespace — tests build it directly)."""
    matrix = tenancy.default_matrix()
    rate, draw_rate = service_rate(cfg)
    schedule, horizon = build_schedule(matrix, cfg.seed, cfg.requests,
                                       cfg.load, rate, draw_rate)
    mean_sigs = sum(s.fraction * s.sigs for s in matrix) / sum(
        s.fraction for s in matrix)
    capacity_sigs = max(48, int(cfg.capacity_frac * cfg.requests
                                * mean_sigs))
    t_cap = capacity_sigs / rate  # the deadline unit (module docstring)
    rotate_every = (horizon * cfg.rotate_every_frac
                    if cfg.rotate_every_frac else 0.0)

    clock = health.FakeClock()
    t0 = clock.monotonic()
    tenants = sorted({s.tenant for s in matrix})
    entry_bytes = None
    cache = devcache.DeviceOperandCache(
        budget_bytes=1 << 26, enabled=bool(cfg.device),
        tenant_quota_bytes=0)
    if cfg.device:
        from ..ops import limbs

        # Budget ~2.5 entries with a ~1.2-entry per-tenant quota: both
        # tenants can hold exactly one hot keyset, rotation churn must
        # evict-and-rebuild strictly inside the rotating tenant's
        # partition.
        entry_bytes = 4 * limbs.NLIMBS * 2 * (matrix[0].sigs + 1) * 2
        cache = devcache.DeviceOperandCache(
            budget_bytes=int(2.5 * entry_bytes), enabled=True,
            tenant_quota_bytes=int(1.2 * entry_bytes))
    devcache.set_default_cache(cache)
    # A FRESH verdict cache per run, companioned to this run's
    # devcache: the lab's batches are unique within a run (no memo
    # effect on its dynamics), but a load sweep replays the SAME
    # seeded scenario several times in one process — ambient memo
    # state from a previous point would fast-path later points and
    # break the replay-digest purity.  Per-run isolation keeps every
    # point the same pure function of the seed.
    vcache = verdictcache.VerdictCache(companion=cache,
                                       namespace="trafficlab")
    verdictcache.set_default_cache(vcache)

    torch_device = getattr(cfg, "torch_device", None)
    svc = service.VerifyService(
        capacity_sigs=capacity_sigs,
        wave_max_batches=cfg.wave_max_batches,
        # chunk=1 in device mode: a wave mixes tenants, and only a
        # keyset-UNIFORM chunk can serve from (or build) devcache
        # residency — one batch per chunk keeps every chunk uniform.
        chunk=1 if cfg.device else 8,
        hybrid=False if cfg.device else True,
        merge="never" if cfg.device else "auto",
        # mesh_chaos runs the lab with mesh=None (auto) so the
        # degraded-capacity watermark shrink engages; the default 0
        # keeps the classic host-modelled lab byte-identical.
        mesh=getattr(cfg, "mesh", 0),
        # The device route's DeviceHealth runs on the lab's FakeClock (a
        # device call's deadline never self-elapses: the run stays a pure
        # function of the seed); the host form never touches a device.
        health=(health.DeviceHealth(mesh=0, clock=clock) if cfg.device
                else service._HostOnlyHealth(clock)),
        device=torch_device if cfg.device else "cpu",
        clock=clock, rng=random.Random(_stable_seed(cfg.seed, "rng")),
        auto_start=False)

    plan = None
    if cfg.rotation_faults and cfg.device:
        # A rotation fault window riding the lookup stream: tenant[0]'s
        # keyset rotates mid-wave, between staging and dispatch.
        plan = faults.devcache_plan(cfg.seed, "rotate", at=3, length=3,
                                    tenant=tenants[0])
        faults.install(plan)

    requests, pending = [], []
    last_gen = {}
    busy_until = [None]

    # Gray-failure cost model (--slow-chip): a seeded fraction of waves
    # land on a placement whose gray chip straggles — the wave's virtual
    # cost multiplies by `factor`.  With hedging ON, the model's armed
    # hedge: once the wave ring is warm, a wave overrunning ratio × median of
    # recent wave costs re-dispatches its batches on the host and
    # completes at the threshold plus one host re-verify —
    # first-valid-wins caps the tail.  The gray draw is a pure function
    # of (seed, wave ordinal), so the hedging-on and hedging-off
    # variants grey out the SAME waves.
    gray_model = getattr(cfg, "gray_model", None)
    gray_rnd = (random.Random(_stable_seed(cfg.seed, "gray"))
                if gray_model else None)
    # The threshold ring starts with a seeded prior (the scenario's
    # expected one-batch wave cost): production services cross the
    # scheduler's arming window within their first few seconds, while
    # the storm models hours — cold-start blast is not the claim under
    # test here (tests/test_torch_straggler.py pins the real gate).
    gray_costs = [cfg.wave_overhead * t_cap + mean_sigs / rate] * 8 \
        if gray_model else []
    gray_stats = {"gray_waves": 0, "hedges_fired": 0,
                  "hedge_saved_s": 0.0}

    def submit_one(t, si, seq):
        req, gen = build_request(matrix, cfg.seed, si, seq, t,
                                 rotate_every, t_cap, t0)
        requests.append(req)
        if rotate_every and last_gen.get(req.tenant, 0) != gen:
            # Epoch boundary: the tenant's validator set rotated.
            last_gen[req.tenant] = gen
            cache.rotate_tenant(req.tenant, "epoch boundary")
        last_gen.setdefault(req.tenant, gen)
        try:
            req.ticket = svc.submit(req.verifier, deadline=req.deadline,
                                    cls=req.cls, tenant=req.tenant)
            pending.append(req)
        except service.Overloaded:
            req.kind = "overloaded"
            req.done_at = clock.monotonic()

    def start_wave():
        now = clock.monotonic()
        inflight = [r for r in pending if not r.ticket.done()]
        if svc.process_once(block=False) == 0:
            busy_until[0] = None
            return
        live_sigs = 0
        resolved = [r for r in inflight if r.ticket.done()]
        for r in resolved:
            try:
                r.verdict = r.ticket.result(0)
                r.kind = "verdict"
                live_sigs += r.sigs
            except service.DeadlineExceeded:
                r.kind = "shed_deadline"
                r.done_at = now
        cost = (cfg.wave_overhead * t_cap + live_sigs / rate
                if live_sigs else 0.0)
        if gray_model and live_sigs:
            if gray_rnd.random() < gray_model["frac"]:
                gray_stats["gray_waves"] += 1
                slow_cost = cost * gray_model["factor"]
                if gray_model["hedging"]:
                    recent = sorted(gray_costs[-128:])
                    median = recent[(len(recent) - 1) // 2]
                    thr = gray_model["ratio"] * median
                    if slow_cost > thr:
                        hedged = thr + live_sigs / rate
                        gray_stats["hedges_fired"] += 1
                        gray_stats["hedge_saved_s"] += slow_cost - hedged
                        slow_cost = hedged
                cost = slow_cost
            gray_costs.append(cost)
        done_at = now + cost
        for r in resolved:
            if r.kind == "verdict":
                r.done_at = done_at
        busy_until[0] = done_at if live_sigs else None
        for r in resolved:
            pending.remove(r)

    try:
        i = 0
        while i < len(schedule) or busy_until[0] is not None \
                or svc.stats()["queue_requests"]:
            t_arr = schedule[i][0] + t0 if i < len(schedule) else None
            if busy_until[0] is not None and (t_arr is None
                                              or busy_until[0] <= t_arr):
                clock.advance_to(busy_until[0])
                busy_until[0] = None
                start_wave()
            elif t_arr is not None:
                clock.advance_to(t_arr)
                submit_one(*schedule[i])
                i += 1
                if busy_until[0] is None:
                    start_wave()
            else:
                start_wave()
        svc.close()
    finally:
        # Never leak the installed fault plan or the tiny injected
        # cache into later in-process work (the test suites call
        # run_lab directly) — whatever happened above.
        if plan is not None:
            faults.uninstall()
        devcache.set_default_cache(None)
        verdictcache.set_default_cache(None)

    summary = summarize(cfg, matrix, requests, svc, cache, rate,
                        capacity_sigs, t_cap, horizon, t0)
    if gray_model:
        summary["gray_failure_run"] = dict(
            gray_stats,
            hedge_saved_s=round(gray_stats["hedge_saved_s"], 6),
            hedging=gray_model["hedging"],
            factor=gray_model["factor"], frac=gray_model["frac"],
            ratio=gray_model["ratio"])
    return summary


def summarize(cfg, matrix, requests, svc, cache, rate, capacity_sigs,
              t_cap, horizon, t0) -> dict:
    by_class = {}
    for cls in tenancy.CLASSES:
        rs = [r for r in requests if r.cls == cls]
        lats = [r.done_at - (t0 + r.arrival) for r in rs
                if r.kind == "verdict"]
        pct = metrics.percentiles(lats)
        shed = sum(1 for r in rs
                   if r.kind in ("overloaded", "shed_deadline"))
        deadlines = [s.deadline_s * t_cap for s in matrix
                     if s.cls == cls and s.deadline_s is not None]
        by_class[cls] = {
            "requests": len(rs),
            "verdicts": len(lats),
            "overloaded": sum(1 for r in rs if r.kind == "overloaded"),
            "shed_deadline": sum(1 for r in rs
                                 if r.kind == "shed_deadline"),
            "shed_rate": round(shed / len(rs), 4) if rs else 0.0,
            "deadline_s": min(deadlines) if deadlines else None,
            "latency_s": {
                "p50": pct[0.5], "p99": pct[0.99], "p999": pct[0.999],
                "max": max(lats) if lats else None,
            },
        }

    lost = sum(1 for r in requests if r.kind is None)
    mismatches = sum(1 for r in requests
                     if r.kind == "verdict" and r.verdict != r.want)
    digest = hashlib.sha256()
    for r in requests:
        digest.update(repr((r.stream_idx, r.seq, round(r.arrival, 9),
                            r.kind, r.verdict,
                            None if r.done_at is None
                            else round(r.done_at - t0, 9))).encode())

    cons = by_class[tenancy.CLASS_CONSENSUS]
    gates = {
        "zero_lost": lost == 0,
        "host_identical_verdicts": mismatches == 0,
        "consensus_shed_rate_zero": cons["shed_rate"] == 0.0,
        "consensus_p99_under_deadline": (
            cons["latency_s"]["p99"] is not None
            and cons["deadline_s"] is not None
            and cons["latency_s"]["p99"] < cons["deadline_s"]),
    }
    if cfg.require_rpc_shed:
        gates["rpc_sheds_under_overload"] = (
            by_class[tenancy.CLASS_RPC]["shed_rate"] > 0.0)

    st = svc.stats()
    summary = {
        "ok": all(gates.values()),
        "gates": gates,
        "seed": cfg.seed,
        "requests": len(requests),
        "lost": lost,
        "verdict_mismatches": mismatches,
        "load": cfg.load,
        "service_rate_sigs_per_s": round(rate, 1),
        "calibrated": not cfg.service_rate,
        "capacity_sigs": capacity_sigs,
        "t_cap_s": t_cap,
        "horizon_s": horizon,
        "device": bool(cfg.device),
        "effective_capacity_sigs": st["effective_capacity_sigs"],
        "rotation_faults": bool(cfg.rotation_faults and cfg.device),
        "by_class": by_class,
        "by_tenant_devcache": cache.tenant_stats() if cfg.device else {},
        "devcache": cache.stats() if cfg.device else {},
        "breaker_transitions": len(svc.breaker.transitions),
        "breaker_state": st["breaker_state"],
        "service_by_class": st["by_class"],
        "waves": st["waves"],
        "replay_digest": digest.hexdigest(),
    }
    return summary


def run_fleet(cfg) -> dict:
    """FLEET mode: replay `--chains` chains
    of Poisson/burst/diurnal arrivals — aggregate offered load
    `--load` × (fleet size × per-replica rate), which with a pinned
    `--service-rate` reaches million-user aggregate rates — through a
    `federation.ReplicaSet` of `--fleet` host-modelled replicas on ONE
    FakeClock.  Optionally (`--replica-crash`) a seeded ReplicaCrash
    kills one replica MID-RUN: its queue re-issues on peers, lower
    classes shed on the survivors, and the ejected replica rejoins
    through host-verified probes — the whole run a pure function of
    the seed.

    Gates: zero lost + host-identical verdicts (fleet-wide), consensus
    shed rate ZERO, per-replica consensus p99 under the deadline, and
    affinity hit-rate ≥ `--affinity-target` (with a crash: measured on
    the post-rejoin tail too, so rejoin provably restores affinity)."""
    chains = max(1, cfg.chains)
    matrix = tenancy.fleet_matrix(chains)
    n_rep = int(cfg.fleet)
    rate, draw_rate = service_rate(cfg)
    fleet_rate = rate * n_rep
    schedule, horizon = build_schedule(matrix, cfg.seed, cfg.requests,
                                       cfg.load, fleet_rate, draw_rate)
    mean_sigs = sum(s.fraction * s.sigs for s in matrix) / sum(
        s.fraction for s in matrix)
    capacity_sigs = max(48, int(cfg.capacity_frac * cfg.requests
                                * mean_sigs / n_rep))
    t_cap = capacity_sigs / rate

    clock = health.FakeClock()
    t0 = clock.monotonic()

    class _FleetRegistry(health.ReplicaRegistry):
        """Registry whose suspicion decay lives on the lab's VIRTUAL
        timescale (the fleet horizon is a fraction of a second of
        virtual time; the production 300 s half-life would never relax
        an eject inside the run).  Behavior, not constants, is under
        test — the production knobs stay untouched."""

        @staticmethod
        def _half_life() -> float:
            return horizon / 40.0

    registry = _FleetRegistry(clock=clock)

    def factory(rid, clk, cache):
        return service.VerifyService(
            capacity_sigs=capacity_sigs, clock=clk, auto_start=False,
            replica_id=f"r{rid}", cache=cache, mesh=0,
            health=service._HostOnlyHealth(clk), device="cpu",
            rng=random.Random(_stable_seed(cfg.seed, "fleet-rng", rid)))

    fs = federation.ReplicaSet(
        n_rep, service_factory=factory, clock=clock, registry=registry,
        capacity_sigs=capacity_sigs, probe_seed=cfg.seed)

    # The affinity HOME of each tenant (generation 0 — fleet mode runs
    # without rotation so homes are stable) and the crash victim: the
    # heaviest chain's home replica, so the outage visibly disturbs
    # affinity and the rejoin visibly restores it.
    home_of = {}
    for s in matrix:
        if s.tenant in home_of:
            continue
        keys = tenant_keyset(cfg.seed, s.tenant, 0, s.sigs)
        blob = b"".join(sk.verification_key_bytes().to_bytes()
                        for sk in keys)
        home_of[s.tenant] = routing.replica_affinity_order(
            devcache.keyset_digest(blob), s.tenant, range(n_rep))[0]
    crash_rid = home_of[matrix[0].tenant]
    crash_t = t0 + 0.35 * horizon if cfg.replica_crash else None
    crash_state = {"installed": False, "ejected_at": None,
                   "rejoined_at": None, "rejoins_seen": 0}

    requests, pending = [], []
    busy = {rid: None for rid in range(n_rep)}

    def submit_one(t, si, seq):
        req, _gen = build_request(matrix, cfg.seed, si, seq, t,
                                  0.0, t_cap, t0)
        requests.append(req)
        req.home = home_of[req.tenant]
        try:
            req.fed = fs.submit(req.verifier, deadline=req.deadline,
                                cls=req.cls, tenant=req.tenant)
            req.replica = req.fed.replica_id
            req.affinity_hit = req.replica == req.home
            pending.append(req)
        except service.Overloaded:
            req.kind = "overloaded"
            req.done_at = clock.monotonic()

    def sweep(rid):
        """Collect newly-resolved requests after a pump of `rid`:
        requests decided BY rid's wave carry its virtual wave cost;
        requests resolved elsewhere (host floor / failover re-issue
        racing) land at now."""
        now = clock.monotonic()
        live, wave = 0, []
        for r in [r for r in pending if r.fed.done()]:
            pending.remove(r)
            r.replica = r.fed.replica_id
            try:
                r.verdict = r.fed.result(0)
                r.kind = "verdict"
                if r.replica == rid:
                    live += r.sigs
                    wave.append(r)
                else:
                    r.done_at = now
            except service.DeadlineExceeded:
                r.kind = "shed_deadline"
                r.done_at = now
        cost = (cfg.wave_overhead * t_cap + live / rate) if live else 0.0
        for r in wave:
            r.done_at = now + cost
        busy[rid] = (now + cost) if live else None

    def pump(rid):
        before = fs.totals["rejoins"]
        fs.pump_replica(rid)
        fs.maintain()
        if cfg.replica_crash:
            if crash_state["ejected_at"] is None \
                    and fs.totals["ejections"]:
                crash_state["ejected_at"] = clock.monotonic() - t0
            if fs.totals["rejoins"] > before \
                    and crash_state["rejoined_at"] is None:
                crash_state["rejoined_at"] = clock.monotonic() - t0
        sweep(rid)

    def queued(rid):
        return fs.replicas[rid].service.stats()["queue_requests"]

    i = 0
    while True:
        if crash_t is not None and not crash_state["installed"] \
                and clock.monotonic() >= crash_t:
            faults.install(faults.replica_plan(
                cfg.seed, "crash", replica=crash_rid, at=0))
            crash_state["installed"] = True
        busy_next = [(t, rid) for rid, t in busy.items()
                     if t is not None]
        t_busy, rid_busy = min(busy_next) if busy_next else (None, None)
        t_arr = schedule[i][0] + t0 if i < len(schedule) else None
        if t_busy is not None and (t_arr is None or t_busy <= t_arr):
            clock.advance_to(t_busy)
            busy[rid_busy] = None
            pump(rid_busy)
        elif t_arr is not None:
            clock.advance_to(t_arr)
            submit_one(*schedule[i])
            i += 1
            for rid in range(n_rep):
                if busy[rid] is None and queued(rid):
                    pump(rid)
        else:
            progressed = False
            for rid in range(n_rep):
                if busy[rid] is None and queued(rid):
                    pump(rid)
                    progressed = True
            if not progressed:
                if pending:
                    # Only maintenance work (probes, drains) is left:
                    # advance the virtual clock a beat so decay-gated
                    # transitions can fire, then try again.
                    clock.advance(horizon / 100.0)
                    fs.maintain()
                    for rid in range(n_rep):
                        pump(rid)
                    continue
                break
    fs.close()
    if crash_state["installed"]:
        faults.uninstall()
    now = clock.monotonic()
    for r in list(pending):
        # close() drained every live replica; anything left resolves
        # now (zero-lost means this sweep finds only done tickets).
        if r.fed.done():
            r.replica = r.fed.replica_id
            try:
                r.verdict = r.fed.result(0)
                r.kind = "verdict"
            except service.DeadlineExceeded:
                r.kind = "shed_deadline"
            r.done_at = now
            pending.remove(r)

    return summarize_fleet(cfg, matrix, requests, fs, rate,
                           capacity_sigs, t_cap, horizon, t0,
                           crash_rid if cfg.replica_crash else None,
                           crash_state)


def summarize_fleet(cfg, matrix, requests, fs, rate, capacity_sigs,
                    t_cap, horizon, t0, crash_rid, crash_state) -> dict:
    n_rep = int(cfg.fleet)
    lost = sum(1 for r in requests if r.kind is None)
    mismatches = sum(1 for r in requests
                     if r.kind == "verdict" and r.verdict != r.want)

    def class_rows(rs):
        rows = {}
        for cls in tenancy.CLASSES:
            crs = [r for r in rs if r.cls == cls]
            lats = [r.done_at - (t0 + r.arrival) for r in crs
                    if r.kind == "verdict"]
            pct = metrics.percentiles(lats)
            shed = sum(1 for r in crs
                       if r.kind in ("overloaded", "shed_deadline"))
            deadlines = [s.deadline_s * t_cap for s in matrix
                         if s.cls == cls and s.deadline_s is not None]
            rows[cls] = {
                "requests": len(crs),
                "shed_rate": round(shed / len(crs), 4) if crs else 0.0,
                "deadline_s": min(deadlines) if deadlines else None,
                "p50": pct[0.5], "p99": pct[0.99],
            }
        return rows

    by_replica = {}
    for rid in range(n_rep):
        rs = [r for r in requests if r.replica == rid]
        homed = [r for r in requests if r.home == rid
                 and r.affinity_hit is not None]
        rows = class_rows(rs)
        cons = rows[tenancy.CLASS_CONSENSUS]
        by_replica[rid] = {
            "requests": len(rs),
            "affinity_hit_rate": (
                round(sum(1 for r in homed if r.affinity_hit)
                      / len(homed), 4) if homed else None),
            "by_class": rows,
            "consensus_p99_s": cons["p99"],
            "consensus_deadline_s": cons["deadline_s"],
            "crashed": rid == crash_rid,
        }

    fleet_rows = class_rows(requests)
    cons = fleet_rows[tenancy.CLASS_CONSENSUS]
    affinity_pairs = [r for r in requests if r.affinity_hit is not None]
    affinity_rate = (sum(1 for r in affinity_pairs if r.affinity_hit)
                     / len(affinity_pairs)) if affinity_pairs else None

    gates = {
        "zero_lost": lost == 0,
        "host_identical_verdicts": mismatches == 0,
        "consensus_shed_rate_zero":
            fleet_rows[tenancy.CLASS_CONSENSUS]["shed_rate"] == 0.0,
        "consensus_p99_under_deadline_per_replica": all(
            row["consensus_p99_s"] is None
            or (row["consensus_deadline_s"] is not None
                and row["consensus_p99_s"] < row["consensus_deadline_s"])
            for row in by_replica.values()),
        "affinity_hit_rate_met": (
            affinity_rate is not None
            and affinity_rate >= cfg.affinity_target),
    }
    tail_affinity = None
    if crash_rid is not None:
        rejoined_at = crash_state["rejoined_at"]
        tail = [r for r in requests
                if rejoined_at is not None and r.arrival > rejoined_at
                and r.affinity_hit is not None]
        tail_affinity = (round(sum(1 for r in tail if r.affinity_hit)
                               / len(tail), 4) if tail else None)
        # Only sheds ARRIVING AFTER the ejection count: rpc routinely
        # sheds a little pre-crash at this load, and the gate's claim
        # is that the OUTAGE pushes the surviving replicas into
        # shedding — a fleet-lifetime count would pass vacuously.
        ejected_at = crash_state["ejected_at"]
        survivors_rpc_shed = sum(
            1 for r in requests
            if r.cls == tenancy.CLASS_RPC
            and r.kind in ("overloaded", "shed_deadline")
            and ejected_at is not None and r.arrival > ejected_at)
        gates.update({
            "replica_ejected": crash_state["ejected_at"] is not None,
            "replica_rejoined": rejoined_at is not None,
            "rpc_sheds_on_survivors": survivors_rpc_shed > 0,
            "tail_affinity_recovered": (
                tail_affinity is not None
                and tail_affinity >= cfg.affinity_target),
        })

    digest = hashlib.sha256()
    for r in requests:
        digest.update(repr((r.stream_idx, r.seq, round(r.arrival, 9),
                            r.kind, r.verdict, r.replica,
                            None if r.done_at is None
                            else round(r.done_at - t0, 9))).encode())

    st = fs.stats()
    return {
        "ok": all(gates.values()),
        "gates": gates,
        "seed": cfg.seed,
        "fleet": n_rep,
        "chains": cfg.chains,
        "requests": len(requests),
        "lost": lost,
        "verdict_mismatches": mismatches,
        "load": cfg.load,
        "service_rate_sigs_per_s": round(rate, 1),
        "aggregate_rate_sigs_per_s": round(rate * n_rep * cfg.load, 1),
        "calibrated": not cfg.service_rate,
        "capacity_sigs_per_replica": capacity_sigs,
        "t_cap_s": t_cap,
        "horizon_s": horizon,
        "affinity_hit_rate": (round(affinity_rate, 4)
                              if affinity_rate is not None else None),
        "tail_affinity_hit_rate": tail_affinity,
        "crash_replica": crash_rid,
        "crash_state": dict(crash_state),
        "by_class": fleet_rows,
        "by_replica": by_replica,
        "federation": {k: v for k, v in st.items()
                       if k not in ("replicas",)},
        "replicas": st["replicas"],
        "replay_digest": digest.hexdigest(),
    }


def parse_load_sweep(spec: str) -> "list[float]":
    """Parse a --load-sweep spec: either a comma list ("0.5,0.8,1.2")
    or lo:hi:n ("0.5:1.2:8" — n evenly-spaced points inclusive)."""
    spec = spec.strip()
    if not spec:
        return []
    if ":" in spec:
        lo_s, hi_s, n_s = spec.split(":")
        lo, hi, n = float(lo_s), float(hi_s), int(n_s)
        if n < 2:
            return [lo]
        return [round(lo + (hi - lo) * k / (n - 1), 6)
                for k in range(n)]
    return [float(x) for x in spec.split(",") if x.strip()]


def run_load_sweep(cfg, loads: "list[float]") -> dict:
    """Drive the SAME seeded scenario across
    the load axis (0.5 → 1.2× capacity) and emit the latency-vs-load
    curve as a first-class artifact inside the `service_slo` bench
    block.  Each point is a full open-loop run_lab at that offered
    load; the INVARIANT gates (zero lost, host-identical verdicts,
    consensus shed rate zero) must hold at EVERY point — above
    capacity the lower classes shed harder and consensus latency
    grows, but consensus is never lost and never shed.  The p99-under-
    deadline and rpc-shed gates are envelope-point claims and are not
    applied across the sweep (the curve IS the deliverable: where p99
    crosses the deadline is what the artifact shows)."""
    rate, draw_rate = service_rate(cfg)
    curve = []
    ok = True
    for load in loads:
        pt_cfg = argparse.Namespace(**vars(cfg))
        pt_cfg.load = load
        pt_cfg.service_rate = rate  # one calibration for the whole sweep
        pt_cfg.draw_rate = draw_rate
        pt_cfg.require_rpc_shed = False
        summary = run_lab(pt_cfg)
        invariants = {
            "zero_lost": summary["gates"]["zero_lost"],
            "host_identical_verdicts":
                summary["gates"]["host_identical_verdicts"],
            "consensus_shed_rate_zero":
                summary["gates"]["consensus_shed_rate_zero"],
        }
        ok = ok and all(invariants.values())
        cons = summary["by_class"][tenancy.CLASS_CONSENSUS]
        curve.append({
            "load": load,
            "requests": summary["requests"],
            "consensus_p50_s": cons["latency_s"]["p50"],
            "consensus_p99_s": cons["latency_s"]["p99"],
            "consensus_deadline_s": cons["deadline_s"],
            "p99_under_deadline":
                summary["gates"]["consensus_p99_under_deadline"],
            "shed_rate_by_class": {
                c: summary["by_class"][c]["shed_rate"]
                for c in tenancy.CLASSES},
            "invariants": invariants,
        })
    return {
        "ok": ok,
        "service_rate_sigs_per_s": round(rate, 1),
        "loads": loads,
        "curve": curve,
    }


def run_gray_failure(cfg) -> dict:
    """--slow-chip: the gray-failure variant pair.  Drive
    the SAME seeded open-loop scenario through the slow-chip cost
    model twice — hedging OFF, then hedging ON — and emit the
    comparison as a first-class block inside the `service_slo` bench
    artifact.  The claim under test: with a gray
    chip straggling on a seeded fraction of waves, hedged re-dispatch
    (first valid result wins) keeps consensus-class p99 inside its
    deadline, while the un-hedged variant eats the full straggler tail.
    Invariant gates (zero lost, host-identical verdicts, consensus
    never shed) must hold in BOTH variants — hedging buys latency,
    never correctness."""
    rate, draw_rate = service_rate(cfg)
    ratio = config.get("ED25519_TPU_STRAGGLER_RATIO")
    variants = {}
    invariants_ok = True
    # The storm point sits below the 0.8 envelope point: hedged
    # re-dispatch SPENDS spare capacity to buy tail latency (every
    # hedge re-verifies real work), so a mesh with no headroom has
    # nothing to hedge with.  0.6 models the provisioning a consensus
    # operator actually runs with.
    load = min(cfg.load, 0.6)
    for hedging in (False, True):
        v_cfg = argparse.Namespace(**vars(cfg))
        v_cfg.service_rate = rate  # one calibration for the pair
        v_cfg.draw_rate = draw_rate
        v_cfg.load = load
        v_cfg.require_rpc_shed = False
        v_cfg.gray_model = {
            "frac": cfg.gray_frac, "factor": cfg.slow_factor,
            "ratio": ratio, "hedging": hedging,
        }
        summary = run_lab(v_cfg)
        # Zero lost and host-identical verdicts hold in BOTH variants —
        # hedging buys latency, never correctness.  Consensus shed rate
        # is deliberately NOT an invariant here: the un-hedged variant
        # blowing consensus deadlines IS the gray-failure finding.
        invariants = {
            "zero_lost": summary["gates"]["zero_lost"],
            "host_identical_verdicts":
                summary["gates"]["host_identical_verdicts"],
        }
        invariants_ok = invariants_ok and all(invariants.values())
        cons = summary["by_class"][tenancy.CLASS_CONSENSUS]
        variants["hedging_on" if hedging else "hedging_off"] = {
            "consensus_p50_s": cons["latency_s"]["p50"],
            "consensus_p99_s": cons["latency_s"]["p99"],
            "consensus_deadline_s": cons["deadline_s"],
            "consensus_shed_rate": cons["shed_rate"],
            "p99_under_deadline":
                summary["gates"]["consensus_p99_under_deadline"],
            "shed_rate_by_class": {
                c: summary["by_class"][c]["shed_rate"]
                for c in tenancy.CLASSES},
            "invariants": invariants,
            **summary["gray_failure_run"],
        }
    on, off = variants["hedging_on"], variants["hedging_off"]
    gates = {
        "invariants_hold_both_variants": invariants_ok,
        "storm_landed_in_both": (on["gray_waves"] > 0
                                 and off["gray_waves"] > 0),
        "hedges_fired_only_when_armed": (
            on["hedges_fired"] > 0 and off["hedges_fired"] == 0),
        # With hedging, consensus rides out the gray chip: never shed,
        # p99 inside the deadline.
        "hedged_consensus_never_shed": on["consensus_shed_rate"] == 0.0,
        "hedged_consensus_p99_under_deadline": on["p99_under_deadline"],
        # Without it, the straggler tail is real damage: consensus
        # deadline-sheds or blows its p99.
        "unhedged_tail_blows": (off["consensus_shed_rate"] > 0.0
                                or not off["p99_under_deadline"]),
    }
    return {
        "ok": all(gates.values()),
        "gates": gates,
        "load": load,
        "slow_factor": cfg.slow_factor,
        "gray_frac": cfg.gray_frac,
        "straggler_ratio": ratio,
        "service_rate_sigs_per_s": round(rate, 1),
        "variants": variants,
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=lambda s: int(s, 0),
                    default=DEFAULT_SEED)
    ap.add_argument("--requests", type=int, default=800,
                    help="target total request count (horizon derives "
                         "from it at the offered load)")
    ap.add_argument("--load", type=float, default=0.8,
                    help="offered load as a fraction of measured "
                         "capacity (the SLO envelope point)")
    ap.add_argument("--service-rate", type=float, default=0.0,
                    help="pin the virtual cost model (sigs/s) instead "
                         "of calibrating — makes the run bit-"
                         "reproducible across hosts")
    ap.add_argument("--capacity-frac", type=float, default=0.05,
                    help="queue capacity as a fraction of total run "
                         "volume")
    ap.add_argument("--wave-max-batches", type=int, default=16)
    ap.add_argument("--wave-overhead", type=float, default=0.02,
                    help="per-wave fixed cost in T_cap units")
    ap.add_argument("--device", action="store_true",
                    help="device-participating waves (forced-device, "
                         "single lane, one batch a chunk): exercises "
                         "per-tenant devcache residency")
    ap.add_argument("--torch-device", default=None,
                    help="torch device of --device waves (default: "
                         "CUDA; \"cpu\" runs the kernels' plain "
                         "versions)")
    ap.add_argument("--rotate-every-frac", type=float, default=0.25,
                    help="tenant keyset rotation period as a fraction "
                         "of the horizon (0 disables rotation)")
    ap.add_argument("--rotation-faults", action="store_true",
                    help="with --device: land a mid-wave rotation "
                         "fault window on the devcache lookup stream")
    ap.add_argument("--require-rpc-shed", dest="require_rpc_shed",
                    action="store_true", default=True)
    ap.add_argument("--no-require-rpc-shed", dest="require_rpc_shed",
                    action="store_false")
    ap.add_argument("--fleet", type=int, default=0,
                    help="FLEET mode: run the federation lab through a "
                         "ReplicaSet of this many host-modelled "
                         "replicas instead of one service (0 = off)")
    ap.add_argument("--chains", type=int, default=50,
                    help="fleet mode: chain (tenant) count for the "
                         "zipf-skewed fleet matrix")
    ap.add_argument("--replica-crash", action="store_true",
                    help="fleet mode: seeded ReplicaCrash kills the "
                         "heaviest chain's home replica mid-run; gates "
                         "add ejection + probe rejoin + post-rejoin "
                         "affinity recovery")
    ap.add_argument("--affinity-target", type=float, default=0.6,
                    help="fleet mode: minimum acceptable affinity "
                         "hit-rate (overall and post-rejoin tail)")
    ap.add_argument("--slow-chip", action="store_true",
                    help="gray-failure storm: run the seeded scenario "
                         "through the slow-chip cost model twice — "
                         "hedging off vs on — and emit the comparison "
                         "as a gray_failure block inside service_slo "
                         "(gates: invariants hold in both, hedged "
                         "consensus p99 under deadline, hedging "
                         "recovers the tail)")
    ap.add_argument("--slow-factor", type=float, default=6.0,
                    help="--slow-chip: straggler cost multiplier on a "
                         "gray wave")
    ap.add_argument("--gray-frac", type=float, default=0.125,
                    help="--slow-chip: seeded fraction of waves whose "
                         "placement hits the gray chip (1/8 = one "
                         "chip of an 8-chip mesh)")
    ap.add_argument("--load-sweep", default="",
                    help="drive the load axis and emit the latency-vs-"
                         "load curve into the service_slo block: a "
                         "comma list (\"0.5,0.8,1.2\") or lo:hi:n "
                         "(\"0.5:1.2:8\"); the envelope-point run at "
                         "--load still executes first")
    ap.add_argument("--json", action="store_true")
    return ap.parse_args(argv)


def warm(cfg) -> None:
    """Warm the --device run's chunk shape on its device (one batch of the
    matrix's consensus size), so the first wave is not a compile."""
    keys = tenant_keyset(cfg.seed, "warm", 0,
                         tenancy.default_matrix()[0].sigs)
    v = batch.Verifier()
    for j, sk in enumerate(keys):
        m = b"warm %d" % j
        v.queue((sk.verification_key_bytes(), sk.sign(m), m))
    batch.warm_device_shapes(v, chunk=1,
                             device=getattr(cfg, "torch_device", None))


def run(cfg) -> dict:
    """The run `cfg` names: the fleet lab with --fleet, else the
    single-service lab, with the load sweep and the gray-failure pair
    folded into its summary when asked."""
    if cfg.fleet:
        if not cfg.seed or cfg.seed == DEFAULT_SEED:
            cfg.seed = FLEET_SEED
        return run_fleet(cfg)
    if cfg.device:
        warm(cfg)
    summary = run_lab(cfg)
    sweep_loads = parse_load_sweep(cfg.load_sweep)
    if sweep_loads:
        sweep = run_load_sweep(cfg, sweep_loads)
        summary["load_sweep"] = sweep
        summary["ok"] = summary["ok"] and sweep["ok"]
    if cfg.slow_chip:
        gray = run_gray_failure(cfg)
        summary["gray_failure"] = gray
        summary["ok"] = summary["ok"] and gray["ok"]
    return summary


def headline(cfg, summary) -> dict:
    """The bench-harvest line: the consensus-class p99 at the SLO point
    (`fleet_slo` for a fleet run, `service_slo` otherwise)."""
    if cfg.fleet:
        cons = summary["by_class"][tenancy.CLASS_CONSENSUS]
        return {
            "metric": "fleet_slo",
            "value": (round(cons["p99"] * 1e3, 3)
                      if cons["p99"] is not None else None),
            "unit": "ms_p99_consensus_verdict_latency",
            "fleet": summary["fleet"],
            "chains": summary["chains"],
            "aggregate_rate_sigs_per_s":
                summary["aggregate_rate_sigs_per_s"],
            "affinity_hit_rate": summary["affinity_hit_rate"],
            "tail_affinity_hit_rate": summary["tail_affinity_hit_rate"],
            "zero_lost": summary["gates"]["zero_lost"],
            "host_identical":
                summary["gates"]["host_identical_verdicts"],
            "shed_rate_by_class": {
                cls: summary["by_class"][cls]["shed_rate"]
                for cls in tenancy.CLASSES},
            "crash_replica": summary["crash_replica"],
            "replay_digest": summary["replay_digest"],
            "ok": summary["ok"],
        }
    cons = summary["by_class"][tenancy.CLASS_CONSENSUS]
    sweep = summary.get("load_sweep")
    return {
        "metric": "service_slo",
        "value": (round(cons["latency_s"]["p99"] * 1e3, 3)
                  if cons["latency_s"]["p99"] is not None else None),
        "unit": "ms_p99_consensus_verdict_latency",
        "deadline_ms": (round(cons["deadline_s"] * 1e3, 3)
                        if cons["deadline_s"] is not None else None),
        "load": summary["load"],
        "service_rate_sigs_per_s": summary["service_rate_sigs_per_s"],
        "shed_rate_by_class": {
            cls: summary["by_class"][cls]["shed_rate"]
            for cls in tenancy.CLASSES},
        "zero_lost": summary["gates"]["zero_lost"],
        "host_identical": summary["gates"]["host_identical_verdicts"],
        "breaker_transitions": summary["breaker_transitions"],
        "devcache_hit_rate_by_tenant": {
            t: ts.get("hit_rate")
            for t, ts in summary["by_tenant_devcache"].items()},
        # The latency-vs-load curve (--load-sweep): consensus p50/p99 and
        # per-class shed rates per offered-load point.
        "load_sweep": (sweep["curve"] if sweep else None),
        # The gray-failure pair (--slow-chip): hedging off vs on.
        "gray_failure": summary.get("gray_failure"),
        "replay_digest": summary["replay_digest"],
        "ok": summary["ok"],
    }


def failed_gates(summary) -> "list[str]":
    failed = [g for g, ok in summary["gates"].items() if not ok]
    gray = summary.get("gray_failure")
    if gray is not None and not gray["ok"]:
        failed += [f"gray_failure.{g}"
                   for g, ok in gray["gates"].items() if not ok]
    return failed


def main(argv=None):
    cfg = parse_args(argv)
    summary = run(cfg)
    if cfg.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    print(json.dumps(headline(cfg, summary)))
    if cfg.fleet:
        print("FLEET_SLO", json.dumps(
            {k: v for k, v in summary.items()
             if k not in ("by_class", "by_replica", "replicas")}))
    else:
        print("SERVICE_SLO", json.dumps(
            {k: v for k, v in summary.items() if k != "by_class"}))
    if not summary["ok"]:
        name = "fleet_slo" if cfg.fleet else "service_slo"
        print(f"VIOLATION: {name} gates failed: {failed_gates(summary)} "
              f"(replay with --seed {summary['seed']:#x})",
              file=sys.stderr)
    sys.stdout.flush()  # os._exit skips buffer flushing
    # Never let interpreter teardown run with a lane worker parked.
    batch._DeviceLane.reset_all(timeout=30.0)
    os._exit(0 if summary["ok"] else 1)


if __name__ == "__main__":
    main()
