"""Priority classes, tenants and the seeded traffic model of the
verification service (a copy of the JAX package's `tenancy.py`).

A deployment verifies for many chains at once (tenants), and each
chain's traffic is a small hierarchy of classes with different
contracts:

* ``consensus`` — consensus-critical signatures (prevotes/precommits,
  block headers).  Never watermark-shed (only a physically full queue
  can reject them), and they drain FIRST in every dispatcher wave.
* ``mempool``   — transaction gossip: deferrable; the service's
  historical (high, low) watermark pair.
* ``rpc``       — external query traffic: first to shed, at a
  watermark below mempool's.

This module is the data layer of that model — class identities and
order, per-class admission policy, and the seeded open-loop arrival
processes — so service.py (the queues) and devcache.py (the per-tenant
residency quotas) speak one vocabulary.  Classes and tenants decide
WHEN work is done and WHOSE bytes stay resident, never what a verdict
is.  Arrival processes are pure functions of (seed, parameters) on a
virtual timeline, seeded through `faults._stable_seed` — the same
construction as the JAX package's, so both produce the same schedules
element for element; no module-global mutable state and no clock
reads.
"""

import math
import random

from . import config as _config
from .faults import _stable_seed

__all__ = [
    "CLASS_CONSENSUS", "CLASS_MEMPOOL", "CLASS_RPC", "CLASSES",
    "DEFAULT_TENANT", "class_rank", "ClassPolicy", "class_policies",
    "poisson_arrivals", "burst_arrivals", "diurnal_arrivals",
    "arrivals", "TrafficStream", "default_matrix", "fleet_matrix",
]

# Priority order, highest first: the dispatcher drains waves in this
# order and admission sheds in the reverse of it.
CLASS_CONSENSUS = "consensus"
CLASS_MEMPOOL = "mempool"
CLASS_RPC = "rpc"
CLASSES = (CLASS_CONSENSUS, CLASS_MEMPOOL, CLASS_RPC)

# The unpartitioned tenant every pre-tenancy caller lands in: quota
# accounting and epoch rotation treat it like any other tenant.
DEFAULT_TENANT = "default"


def class_rank(cls: str) -> int:
    """0 for the highest-priority class; raises ValueError for an
    unknown class name (an admission typo must fail loudly, not land
    spam in the consensus queue)."""
    try:
        return CLASSES.index(cls)
    except ValueError:
        raise ValueError(
            f"unknown traffic class {cls!r} (one of {CLASSES})")


class ClassPolicy:
    """Per-class admission policy: the queue-depth fraction at which
    NEW submissions of this class shed (`shed_watermark`, None = only a
    full queue rejects), and the fraction below which shedding disarms
    (`resume_watermark` — the hysteresis floor).  Fractions are of the
    service's TOTAL signature capacity: low classes react to overall
    pressure, whoever caused it."""

    __slots__ = ("name", "shed_watermark", "resume_watermark")

    def __init__(self, name: str, shed_watermark: "float | None",
                 resume_watermark: "float | None"):
        class_rank(name)  # validate
        if shed_watermark is not None:
            if not 0.0 < shed_watermark <= 1.0:
                raise ValueError(
                    f"{name}: shed watermark must be in (0, 1]")
            if resume_watermark is None or \
                    not 0.0 < resume_watermark <= shed_watermark:
                raise ValueError(
                    f"{name}: resume watermark must be in "
                    f"(0, shed_watermark] (a class that sheds must "
                    f"also be able to disarm)")
        self.name = name
        self.shed_watermark = shed_watermark
        self.resume_watermark = resume_watermark

    def __repr__(self):
        return (f"ClassPolicy({self.name!r}, "
                f"shed={self.shed_watermark}, "
                f"resume={self.resume_watermark})")


def class_policies(high_watermark: "float | None" = None,
                   low_watermark: float = 0.50,
                   rpc_watermark: "float | None" = None
                   ) -> "dict[str, ClassPolicy]":
    """Resolve the per-class admission policies for a service:

    * consensus — never watermark-shed (None): only the hard capacity
      check can reject it, and the lower classes' watermarks exist
      precisely to keep that from happening.
    * mempool   — the service's (high, low) watermark pair, i.e. the
      exact pre-tenancy admission behavior; defaults to the
      ``ED25519_TPU_CLASS_WATERMARK_MEMPOOL`` knob.
    * rpc       — the ``ED25519_TPU_CLASS_WATERMARK_RPC`` knob (or the
      explicit override), scaled to the same shed:resume ratio as
      mempool so both classes breathe with the same hysteresis shape.
      A KNOB-defaulted rpc watermark clamps to the mempool high (a
      caller tuning high below 0.5 keeps working — rpc then sheds
      together with mempool); an EXPLICIT rpc watermark above high is
      a configuration error and raises.
    """
    if high_watermark is None:
        high_watermark = _config.get("ED25519_TPU_CLASS_WATERMARK_MEMPOOL")
    rpc_explicit = rpc_watermark is not None
    if rpc_watermark is None:
        rpc_watermark = _config.get("ED25519_TPU_CLASS_WATERMARK_RPC")
    if not 0.0 < low_watermark <= high_watermark <= 1.0:
        raise ValueError("watermarks must satisfy 0 < low <= high <= 1")
    if not rpc_explicit:
        rpc_watermark = min(rpc_watermark, high_watermark)
    if not 0.0 < rpc_watermark <= high_watermark:
        raise ValueError(
            "rpc watermark must satisfy 0 < rpc <= mempool high "
            "(rpc sheds first, or at worst together)")
    ratio = low_watermark / high_watermark
    return {
        CLASS_CONSENSUS: ClassPolicy(CLASS_CONSENSUS, None, None),
        CLASS_MEMPOOL: ClassPolicy(CLASS_MEMPOOL, high_watermark,
                                   low_watermark),
        CLASS_RPC: ClassPolicy(CLASS_RPC, rpc_watermark,
                               rpc_watermark * ratio),
    }


# -- open-loop arrival processes -------------------------------------------
# Pure functions of (seed, parameters) on a virtual timeline: two runs
# with the same inputs produce byte-identical schedules on any machine
# (random.Random's Mersenne stream is stable across processes, and the
# seed is mixed through SHA-256 — THE faults._stable_seed construction,
# imported rather than re-implemented so fault-plan replay and traffic
# schedules can never silently diverge).


def poisson_arrivals(rate: float, horizon: float,
                     seed: int = 0) -> "list[float]":
    """Arrival timestamps of a homogeneous Poisson process at `rate`
    events/second over [0, horizon): i.i.d. exponential gaps — the
    memoryless open-loop baseline closed-loop storms cannot model."""
    if rate <= 0:
        return []
    rnd = random.Random(_stable_seed(seed, "poisson", rate, horizon))
    out, t = [], 0.0
    while True:
        t += rnd.expovariate(rate)
        if t >= horizon:
            return out
        out.append(t)


def burst_arrivals(rate: float, horizon: float, seed: int = 0,
                   burst_every: float = 10.0, burst_len: float = 2.0,
                   burst_factor: float = 4.0) -> "list[float]":
    """A bursty process: baseline Poisson at `rate`, but inside the
    periodic windows [k·burst_every, k·burst_every + burst_len) the
    rate multiplies by `burst_factor` — the shape of block-boundary
    gossip storms and retry stampedes.  Piecewise-homogeneous, so the
    schedule stays an exact pure function of the seed."""
    if rate <= 0:
        return []
    rnd = random.Random(_stable_seed(seed, "burst", rate, horizon,
                                     burst_every, burst_len,
                                     burst_factor))
    out, t = [], 0.0
    while t < horizon:
        k = math.floor(t / burst_every)
        off = t - k * burst_every
        in_burst = off < burst_len
        r = rate * burst_factor if in_burst else rate
        # Advance at the current window's rate, but never step past the
        # window boundary where the rate changes (re-drawing at a
        # boundary keeps the process exactly piecewise-Poisson).  The
        # boundary crossing ASSIGNS t to the absolute boundary (plus an
        # epsilon) rather than incrementing by the remainder — the
        # incremental form can land epsilon short of the boundary and
        # then crawl by denormal steps forever.
        gap = rnd.expovariate(r)
        next_boundary = k * burst_every + (
            burst_len if in_burst else burst_every)
        if t + gap >= next_boundary:
            t = next_boundary + 1e-12
            continue
        t += gap
        if t < horizon:
            out.append(t)
    return out


def diurnal_arrivals(rate: float, horizon: float, seed: int = 0,
                     period: float = 60.0,
                     amplitude: float = 0.5) -> "list[float]":
    """A slowly-modulated process: rate(t) = rate·(1 + amplitude·
    sin(2πt/period)), realized by thinning a Poisson stream at the peak
    rate — the day/night (or block-interval) swell of real traffic."""
    if rate <= 0:
        return []
    if not 0.0 <= amplitude < 1.0:
        raise ValueError("amplitude must be in [0, 1)")
    peak = rate * (1.0 + amplitude)
    rnd = random.Random(_stable_seed(seed, "diurnal", rate, horizon,
                                     period, amplitude))
    out, t = [], 0.0
    while True:
        t += rnd.expovariate(peak)
        if t >= horizon:
            return out
        r_t = rate * (1.0 + amplitude * math.sin(
            2.0 * math.pi * t / period))
        if rnd.random() < r_t / peak:
            out.append(t)
    return out


_ARRIVAL_KINDS = ("poisson", "burst", "diurnal")


def arrivals(kind: str, rate: float, horizon: float,
             seed: int = 0, **kw) -> "list[float]":
    """Dispatch to one of the arrival processes by name (the traffic
    matrix is data; the lab resolves it here)."""
    if kind == "poisson":
        return poisson_arrivals(rate, horizon, seed)
    if kind == "burst":
        return burst_arrivals(rate, horizon, seed, **kw)
    if kind == "diurnal":
        return diurnal_arrivals(rate, horizon, seed, **kw)
    raise ValueError(
        f"unknown arrival kind {kind!r} (one of {_ARRIVAL_KINDS})")


class TrafficStream:
    """One (tenant, class) stream of the lab's traffic matrix: its
    arrival process, its share of the offered load, its per-request
    relative deadline (virtual seconds; None = none), batch size, and
    the fraction of batches built with one tampered signature (so the
    stream carries False verdicts through every path under test)."""

    __slots__ = ("tenant", "cls", "kind", "fraction", "deadline_s",
                 "sigs", "bad_rate", "kind_kw")

    def __init__(self, tenant: str, cls: str, kind: str,
                 fraction: float, deadline_s: "float | None",
                 sigs: int = 4, bad_rate: float = 0.2, **kind_kw):
        class_rank(cls)
        if kind not in _ARRIVAL_KINDS:
            raise ValueError(f"unknown arrival kind {kind!r}")
        if fraction <= 0:
            raise ValueError("fraction must be positive")
        self.tenant = tenant
        self.cls = cls
        self.kind = kind
        self.fraction = float(fraction)
        self.deadline_s = deadline_s
        self.sigs = int(sigs)
        self.bad_rate = float(bad_rate)
        self.kind_kw = dict(kind_kw)

    def __repr__(self):
        return (f"TrafficStream({self.tenant!r}, {self.cls!r}, "
                f"{self.kind!r}, fraction={self.fraction}, "
                f"deadline_s={self.deadline_s}, sigs={self.sigs})")


def fleet_matrix(chains: int, zipf_s: float = 0.8
                 ) -> "tuple[TrafficStream, ...]":
    """The FLEET-scale traffic matrix: `chains`
    tenants, each a chain with steady consensus traffic (tight
    deadline), mempool gossip (alternating poisson/diurnal shapes),
    and rpc edge traffic (alternating poisson/burst) — three streams
    per chain, fractions summing to 1 so the offered load stays
    exactly the lab's `--load` knob whatever the chain count.

    Chain weights are zipf-skewed (weight ∝ 1/(rank+1)^`zipf_s`) —
    the N ≫ 2 tenants follow-up: a few heavy chains dominate, a long
    tail barely registers, which is both what real multichain traffic
    looks like and what stresses the federation's affinity balance
    (the heavy chain's home replica runs hotter than the fleet
    average).  A pure function of (chains, zipf_s) — no seed: the
    matrix is structure, the arrival processes carry the randomness."""
    if chains < 1:
        raise ValueError("need at least one chain")
    weights = [1.0 / (c + 1) ** float(zipf_s) for c in range(chains)]
    total = sum(weights)
    mem_kinds = ("poisson", "diurnal")
    rpc_kinds = ("poisson", "burst")
    streams = []
    for c in range(chains):
        share = weights[c] / total
        t = f"chain-{c:03d}"
        streams.append(TrafficStream(
            t, CLASS_CONSENSUS, "poisson",
            fraction=share * 0.35, deadline_s=2.0))
        streams.append(TrafficStream(
            t, CLASS_MEMPOOL, mem_kinds[c % 2],
            fraction=share * 0.40, deadline_s=8.0))
        streams.append(TrafficStream(
            t, CLASS_RPC, rpc_kinds[c % 2],
            fraction=share * 0.25, deadline_s=None))
    return tuple(streams)


def default_matrix() -> "tuple[TrafficStream, ...]":
    """The lab's default mixed tenant-class matrix: two chains, each
    with steady consensus traffic and a tight deadline; chain-a gossips
    mempool diurnally; chain-b's rpc edge takes periodic 4× bursts —
    the burst is what pushes total depth through the rpc watermark, so
    a correctly-partitioned service sheds exactly there and nowhere
    above."""
    return (
        TrafficStream("chain-a", CLASS_CONSENSUS, "poisson",
                      fraction=0.20, deadline_s=2.0),
        TrafficStream("chain-b", CLASS_CONSENSUS, "poisson",
                      fraction=0.15, deadline_s=2.0),
        TrafficStream("chain-a", CLASS_MEMPOOL, "diurnal",
                      fraction=0.25, deadline_s=8.0),
        TrafficStream("chain-b", CLASS_MEMPOOL, "poisson",
                      fraction=0.10, deadline_s=8.0),
        TrafficStream("chain-a", CLASS_RPC, "poisson",
                      fraction=0.10, deadline_s=None),
        TrafficStream("chain-b", CLASS_RPC, "burst",
                      fraction=0.20, deadline_s=None),
    )
