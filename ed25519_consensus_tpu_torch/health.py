"""Device health for the verify_many scheduler: one `DeviceHealth` per
dispatch mode with an injectable monotonic `Clock`, the typed error
classifier, the process `ChipRegistry` of chip liveness, suspicion,
probation and latency (its `LatencyLedger`), and the residency-drop
listeners the device operand cache hangs on.

THREAD SEMANTICS:

* Every mutable field of a `DeviceHealth` / `ChipRegistry` is read and
  written only under its internal lock.  No method calls out of the module
  — and in particular never enters the CUDA runtime — while holding it.
* All timestamps come from `self.clock`; nothing in the scheduler paths
  reads `time.monotonic` directly, so a `FakeClock` injection is complete.
* `lane_stuck` additionally latches a PROCESS-wide flag: a worker thread
  wedged inside the CUDA runtime is a process-scoped hazard.

CUDA errors differ from the TPU runtime's in one way that matters here: an
error raised inside a kernel (an illegal address, a trap) is STICKY — it
poisons the device's CUDA context for the rest of the process, and every
later call on that device fails too.  `classify_device_error` therefore
maps such an error to FATAL (never TRANSIENT: retrying into a dead context
only burns the retry budget), and the scheduler marks the chip dead and
arms the cooldown.
"""

import bisect
import collections
import hashlib
import threading
import time

from . import config as _config

__all__ = [
    "Clock", "FakeClock", "SYSTEM_CLOCK", "DeviceHealth", "Backoff",
    "ChipRegistry", "chip_registry", "normalize_mesh", "health_for",
    "LatencyLedger", "SENTINEL_SUSPICION", "AMBIGUOUS_SUSPICION",
    "STRAGGLER_SUSPICION", "STATE_HEALTHY", "STATE_SUSPECTED",
    "STATE_QUARANTINED", "STATE_PROBATION",
    "reset_all", "any_lane_stuck",
    "register_residency_drop_listener", "notify_residency_drop",
    "register_chip_drop_listener", "notify_chip_drop",
    "ERROR_TRANSIENT", "ERROR_FATAL", "ERROR_AMBIGUOUS", "ErrorVerdict",
    "classify_device_error",
]


# -- typed error classification --------------------------------------------
#
# * TRANSIENT — a retryable shape (timeout, link reset): a bounded-backoff
#   retry on the same lane before anything is benched.
# * FATAL     — the device is gone for this process (a sticky CUDA error,
#   or an error that declares named chips dead).
# * AMBIGUOUS — everything unrecognized: the chunk falls to the host, with
#   no retry and no chip death.
#
# The rule table matches explicit types and markers only; an unrecognized
# error can only land in AMBIGUOUS.

ERROR_TRANSIENT = "transient"
ERROR_FATAL = "fatal"
ERROR_AMBIGUOUS = "ambiguous"

_ERROR_CLASSES = (ERROR_TRANSIENT, ERROR_FATAL, ERROR_AMBIGUOUS)

# cudaError_t codes that leave the context unusable (the CUDA runtime API):
# ECC uncorrectable, illegal address, launch timeout, device-side assert,
# hardware stack error, illegal instruction, misaligned address, invalid
# address space, invalid PC, launch failure.
CUDA_STICKY_ERRORS = frozenset({214, 700, 702, 710, 714, 715, 716, 717,
                                718, 719})


class ErrorVerdict:
    """One classified dispatch error: the class, the chips a FATAL error
    attributes (empty = the caller's current placement), whether the
    raiser already marked them dead, the raiser's heal window, and a
    short reason."""

    __slots__ = ("cls", "chips", "marked", "heal_after", "reason")

    def __init__(self, cls, chips=(), marked=False, heal_after=None,
                 reason=""):
        self.cls = cls
        self.chips = tuple(int(c) for c in chips)
        self.marked = bool(marked)
        self.heal_after = heal_after
        self.reason = reason

    def __repr__(self):
        return (f"ErrorVerdict(cls={self.cls!r}, chips={self.chips!r}, "
                f"marked={self.marked}, reason={self.reason!r})")


def _cuda_sticky(err) -> bool:
    """True for an error that poisoned the CUDA context: a launch that
    returned a sticky `cudaError_t` (ops/_cuda.CudaError carries its
    `cuda_error` code), or a CUDA runtime error PyTorch raised when it
    next touched the device (`torch.AcceleratorError`, or a RuntimeError
    whose message carries the runtime's "CUDA error" text)."""
    code = getattr(err, "cuda_error", None)
    if code is not None:
        return int(code) in CUDA_STICKY_ERRORS
    if type(err).__name__ == "AcceleratorError":
        return True
    return isinstance(err, RuntimeError) and "CUDA error" in str(err)


def classify_device_error(err) -> ErrorVerdict:
    """Map one dispatch-time exception to {transient, fatal, ambiguous}.

    In order: a ``device_error_class`` marker (faults.py typed injections)
    declares its class — an invalid marker is AMBIGUOUS; a sticky CUDA
    error is FATAL; ``TimeoutError`` and ``ConnectionError``/``OSError``
    are TRANSIENT; anything else (None included) is AMBIGUOUS."""
    marker = getattr(err, "device_error_class", None)
    if marker is not None:
        if marker in _ERROR_CLASSES:
            return ErrorVerdict(
                marker,
                chips=getattr(err, "chips", ()) or (),
                marked=bool(getattr(err, "chips_marked", False)),
                heal_after=getattr(err, "heal_after", None),
                reason=f"declared:{type(err).__name__}")
        return ErrorVerdict(
            ERROR_AMBIGUOUS,
            reason=f"invalid-marker:{marker!r}:{type(err).__name__}")
    if _cuda_sticky(err):
        # parallel/sharded_msm.py names the chips of the device that
        # raised (`chips`); unnamed, the caller takes its placement.
        return ErrorVerdict(ERROR_FATAL,
                            chips=getattr(err, "chips", ()) or (),
                            reason=f"cuda-sticky:{type(err).__name__}")
    if isinstance(err, TimeoutError):
        return ErrorVerdict(ERROR_TRANSIENT, reason="timeout")
    if isinstance(err, (ConnectionError, OSError)):
        return ErrorVerdict(ERROR_TRANSIENT,
                            reason=f"link:{type(err).__name__}")
    if err is None:
        return ErrorVerdict(ERROR_AMBIGUOUS, reason="no-exception-context")
    return ErrorVerdict(ERROR_AMBIGUOUS,
                        reason=f"unclassified:{type(err).__name__}")


def normalize_mesh(mesh) -> int:
    """THE mesh-key rule shared by the health registry, the device-lane
    registry and the compile-grace keys: mesh <= 1 is the single-device
    lane, 0."""
    return int(mesh) if mesh and int(mesh) > 1 else 0


class Clock:
    """Monotonic time source.  `virtual` tells blocking waiters whether
    time only advances explicitly (they must poll instead of sleeping the
    full timeout)."""

    virtual = False

    def monotonic(self) -> float:
        return time.monotonic()


SYSTEM_CLOCK = Clock()


class FakeClock(Clock):
    """A virtual monotonic clock for deterministic scheduler tests: time
    advances ONLY via `advance`, so deadline and grace logic
    is driven by the test scenario, never by host load."""

    virtual = True

    def __init__(self, start: float = 1000.0):
        self._lock = threading.Lock()
        self._now = float(start)

    def monotonic(self) -> float:
        with self._lock:
            return self._now

    def advance(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError("monotonic clocks cannot go backwards")
        with self._lock:
            self._now += float(seconds)

    def advance_to(self, t: float) -> None:
        """Move to `t` (never backwards)."""
        with self._lock:
            self._now = max(self._now, float(t))


_lane_stuck_latch = [False]
_latch_lock = threading.Lock()

# Residency-drop listeners: a lane abandoned mid-call may leave device
# operand arrays behind on a runtime that is no longer trusted, so
# `mark_lane_stuck` notifies every registered listener (devcache drops all
# residency).  Listeners run outside every lock and must not raise.
_residency_listeners = []


def register_residency_drop_listener(fn) -> None:
    """Register `fn(reason)` to run whenever a lane is marked stuck.
    Idempotent by identity."""
    with _latch_lock:
        if fn not in _residency_listeners:
            _residency_listeners.append(fn)


def notify_residency_drop(reason: str) -> None:
    """Run every residency-drop listener (outside all health locks); a
    listener's failure never breaks the transition that triggered it."""
    with _latch_lock:
        listeners = list(_residency_listeners)
    for fn in listeners:
        try:
            fn(reason)
        except Exception:
            pass


# Chip-drop listeners: a chip marked dead drops only that chip's device
# arrays (devcache registers its per-device drop).  Same contract.
_chip_drop_listeners = []


def register_chip_drop_listener(fn) -> None:
    """Register `fn(chip, reason)` to run whenever a chip is marked dead.
    Idempotent by identity."""
    with _latch_lock:
        if fn not in _chip_drop_listeners:
            _chip_drop_listeners.append(fn)


def notify_chip_drop(chip: int, reason: str) -> None:
    with _latch_lock:
        listeners = list(_chip_drop_listeners)
    for fn in listeners:
        try:
            fn(chip, reason)
        except Exception:
            pass


# Suspicion weights: a sentinel-audit divergence attributed to one chip,
# and an ambiguous dispatch error smeared over every chip of the placement.
SENTINEL_SUSPICION = 1.5
AMBIGUOUS_SUSPICION = 0.25
# A completed straggler streak (the chip's p90 over ratio × mesh median
# for MIN_SAMPLES consecutive dispatches): two cross the default
# threshold, like two sentinel divergences.
STRAGGLER_SUSPICION = 1.5

# Latency-ledger bucket edges in INTEGER microseconds: a geometric ladder
# (~26 % steps) from 100 µs to 790 s, one overflow bucket above.  A
# duration is bucketed once, at the seconds → µs scaling where it is
# recorded, and every quantile is a bucket representative, so no float
# reaches a latency decision.
_LATENCY_MANTISSAS_US = (10, 13, 16, 20, 25, 32, 40, 50, 63, 79)
_LATENCY_EDGES_US = tuple(
    m * 10 ** k for k in range(1, 8) for m in _LATENCY_MANTISSAS_US)
_LATENCY_OVERFLOW_US = _LATENCY_EDGES_US[-1] * 10


class LatencyLedger:
    """Per-chip dispatch-latency quantiles: the latency half of chip
    health.

    `record(chips, seconds)` attributes one completed dispatch's duration
    (measured by the scheduler on its injected clock; the ledger reads no
    clock) to every chip of the placement, bucketed into the integer-µs
    histogram.  Quantiles are nearest-rank over bucket representatives,
    so the same samples give the same integers on any host.

    The straggler rule: once a chip holds ED25519_TPU_STRAGGLER_MIN_SAMPLES
    samples, a dispatch where its ring p90 AND the dispatch itself exceed
    ED25519_TPU_STRAGGLER_RATIO × the mesh median extends its streak; a
    streak of MIN_SAMPLES flags the chip (the registry accrues
    STRAGGLER_SUSPICION) and restarts.  The per-dispatch condition keeps a
    gray flap from flagging: its ring p90 stays high through its normal
    windows, but windows shorter than MIN_SAMPLES keep breaking the
    streak.  The comparison is `p90_us * 1000 > ratio_milli * median_us`,
    the ratio knob collapsed to per-mille once at read.

    Attribution is placement-relative: a full-mesh dispatch smears its
    duration over every chip, so nobody stands out; exactness comes from
    placement diversity (single-chip sweeps, probes, reformed rungs).  The
    ring of recent dispatches across placements gives `wave_quantile_us`
    (the hedge threshold) and `gate_us` (the probation latency gate, ratio
    × mesh median; 0 = no evidence, the gate abstains).

    Latency gates placement and timing, never a verdict.  Every mutable
    field is under `_lock`, a leaf lock: nothing is called while it is
    held."""

    WINDOW = 64        # per-chip ring of bucketed samples
    WAVE_WINDOW = 128  # ring of recent dispatches across placements

    def __init__(self, namespace: str = "chips"):
        self.namespace = str(namespace)
        self._lock = threading.Lock()
        self._samples = {}  # chip -> deque of bucket indices (WINDOW)
        self._streak = {}   # chip -> consecutive over-ratio dispatches
        self._events = {}   # chip -> completed straggler streaks
        self._waves = collections.deque(maxlen=self.WAVE_WINDOW)

    @staticmethod
    def _ratio_milli() -> int:
        return int(round(_config.get("ED25519_TPU_STRAGGLER_RATIO") * 1000))

    @staticmethod
    def _min_samples() -> int:
        return max(1, int(_config.get("ED25519_TPU_STRAGGLER_MIN_SAMPLES")))

    @staticmethod
    def _bucket_of(us: int) -> int:
        return bisect.bisect_left(_LATENCY_EDGES_US, us)

    @staticmethod
    def _rep_us(idx: int) -> int:
        if idx >= len(_LATENCY_EDGES_US):
            return _LATENCY_OVERFLOW_US
        return _LATENCY_EDGES_US[idx]

    @staticmethod
    def _quantile_us(sorted_idxs, q_milli: int) -> int:
        """Nearest-rank quantile (per-mille) over sorted bucket indices,
        as the bucket representative in µs."""
        n = len(sorted_idxs)
        if n == 0:
            return 0
        return LatencyLedger._rep_us(sorted_idxs[(int(q_milli)
                                                  * (n - 1)) // 1000])

    def record(self, chips, seconds) -> "tuple[int, ...]":
        """Land one completed dispatch of `seconds` on every chip of
        `chips`; returns the chips that completed a straggler streak on
        this record (the caller accrues their suspicion)."""
        us = max(0, int(seconds * 1000000))
        idx = self._bucket_of(us)
        cur_us = self._rep_us(idx)
        ratio_milli = self._ratio_milli()
        need = self._min_samples()
        flagged = []
        with self._lock:
            self._waves.append(idx)
            rings = []
            for c in chips:
                c = int(c)
                ring = self._samples.get(c)
                if ring is None:
                    ring = self._samples[c] = collections.deque(
                        maxlen=self.WINDOW)
                ring.append(idx)
                rings.append((c, ring))
            med_us = self._quantile_us(
                sorted(i for r in self._samples.values() for i in r), 500)
            for c, ring in rings:
                if len(ring) < need:
                    continue
                p90_us = self._quantile_us(sorted(ring), 900)
                if (p90_us * 1000 > ratio_milli * med_us
                        and cur_us * 1000 > ratio_milli * med_us):
                    streak = self._streak.get(c, 0) + 1
                    if streak >= need:
                        flagged.append(c)
                        self._events[c] = self._events.get(c, 0) + 1
                        streak = 0
                    self._streak[c] = streak
                else:
                    self._streak[c] = 0
        return tuple(flagged)

    def chip_p90_us(self, chip: int) -> int:
        with self._lock:
            ring = self._samples.get(int(chip))
            return self._quantile_us(sorted(ring), 900) if ring else 0

    def mesh_median_us(self) -> int:
        with self._lock:
            return self._quantile_us(
                sorted(i for r in self._samples.values() for i in r), 500)

    def wave_quantile_us(self, q_milli: int) -> int:
        """Quantile (per-mille) of the recent dispatches across
        placements — the hedge threshold's input; 0 before any."""
        with self._lock:
            return self._quantile_us(sorted(self._waves), q_milli)

    def wave_samples(self) -> int:
        """How many recent dispatches the wave ring holds (hedging stays
        disarmed while the ring is cold)."""
        with self._lock:
            return len(self._waves)

    def gate_us(self) -> int:
        """The probation latency gate: ratio × mesh median in integer µs;
        0 = no latency evidence, the gate abstains."""
        med_us = self.mesh_median_us()
        if med_us <= 0:
            return 0
        return (self._ratio_milli() * med_us) // 1000

    def within_gate(self, seconds) -> bool:
        """Does one probe duration pass the latency gate?"""
        gate = self.gate_us()
        return gate <= 0 or max(0, int(seconds * 1000000)) <= gate

    def chip_stats(self) -> "dict[int, dict]":
        """Per chip, all integers: {samples, p50_us, p90_us, streak,
        straggler_events}."""
        with self._lock:
            out = {}
            for c in sorted(self._samples):
                s = sorted(self._samples[c])
                out[c] = {
                    "samples": len(s),
                    "p50_us": self._quantile_us(s, 500),
                    "p90_us": self._quantile_us(s, 900),
                    "streak": self._streak.get(c, 0),
                    "straggler_events": self._events.get(c, 0),
                }
            return out

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._streak.clear()
            self._events.clear()
            self._waves.clear()

    def __repr__(self):
        with self._lock:
            return ("LatencyLedger(namespace=%r, chips=%r, waves=%d)"
                    % (self.namespace, sorted(self._samples),
                       len(self._waves)))


STATE_HEALTHY = "healthy"
STATE_SUSPECTED = "suspected"
STATE_QUARANTINED = "quarantined"
STATE_PROBATION = "probation"


class ChipRegistry:
    """Process-wide liveness, suspicion and latency of the chips: CUDA
    indices as torch enumerates them, shard positions on a CPU mesh, or the
    logical ids a caller names (`verify_many(device_ids=)`).  What
    placement — the single lane's device, the mesh's reformation ladder —
    reads.

    * REPORTED liveness: `mark_chip_dead(chip, heal_after=None)` is a chip
      loss — a finite `heal_after` (registry-clock seconds) rejoins the
      chip once the window elapses, None is permanent (a sticky CUDA error:
      the context is gone for the process).  Reads prune healed windows,
      so rejoin is a read, not a daemon.
    * DIAGNOSED suspicion: `record_suspicion(chip, weight, reason)` lands
      evidence (SENTINEL_SUSPICION for an attributed sentinel divergence,
      AMBIGUOUS_SUSPICION per placement chip for an ambiguous error,
      STRAGGLER_SUSPICION for a straggler streak of `record_latency`).
      Scores decay with the ED25519_TPU_SUSPICION_HALF_LIFE half-life on
      the registry clock; crossing ED25519_TPU_SUSPICION_THRESHOLD
      QUARANTINES the chip (ED25519_TPU_QUARANTINE=0: report only).
    * Quarantine relaxes to PROBATION on the read side once the score
      decays below half the threshold.  A probation chip stays out of
      placement; `record_probation_pass` (batch.run_probation_probe)
      rejoins it after ED25519_TPU_PROBATION_PROBES consecutive clean
      probes, `record_probation_fail` re-quarantines it with fresh
      suspicion.  `heal_chip` (the operator) rejoins any chip at once.
    * `latency` is the LatencyLedger the scheduler feeds after every
      device call.
    * `excluded_chips()` = dead ∪ quarantined ∪ probation: what placement
      avoids.

    Marking a chip dead or quarantining it notifies the chip-drop
    listeners (devcache drops that chip's device copies).  Liveness,
    suspicion and latency gate placement, never math.  The ledger's lock
    and the registry's are never held together."""

    def __init__(self, clock: "Clock | None" = None):
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        self._lock = threading.Lock()
        self._dead = {}  # chip index -> heal-at time (inf = permanent)
        self._suspicion = {}  # chip -> [score, stamp] (decayed lazily)
        # chip -> STATE_QUARANTINED | STATE_PROBATION (absent: healthy or
        # suspected), and a probation chip's consecutive clean probes.
        self._state = {}
        self._probation_passes = {}
        self.latency = LatencyLedger()

    @staticmethod
    def _threshold() -> float:
        return _config.get("ED25519_TPU_SUSPICION_THRESHOLD")

    def set_clock(self, clock: "Clock | None") -> None:
        with self._lock:
            self.clock = clock if clock is not None else SYSTEM_CLOCK

    def mark_chip_dead(self, chip: int, heal_after: "float | None" = None,
                       reason: str = "chip-loss") -> None:
        chip = int(chip)
        with self._lock:
            heal_at = (float("inf") if heal_after is None
                       else self.clock.monotonic() + float(heal_after))
            # Monotone per chip: a shorter window never shortens an armed
            # longer one.
            self._dead[chip] = max(self._dead.get(chip, 0.0), heal_at)
        notify_chip_drop(chip, reason)

    def heal_chip(self, chip: int) -> None:
        """Operator rejoin: the chip is alive and trusted again (its death,
        quarantine or probation and suspicion are cleared)."""
        chip = int(chip)
        with self._lock:
            self._dead.pop(chip, None)
            self._state.pop(chip, None)
            self._probation_passes.pop(chip, None)
            self._suspicion.pop(chip, None)

    def _prune_dead_locked(self) -> None:
        now = self.clock.monotonic()
        for c in [c for c, t in self._dead.items() if now >= t]:
            del self._dead[c]

    def _decayed_locked(self, chip: int, now: float) -> float:
        rec = self._suspicion.get(chip)
        if rec is None:
            return 0.0
        score, stamp = rec
        hl = _config.get("ED25519_TPU_SUSPICION_HALF_LIFE")
        if hl > 0 and now > stamp:
            score *= 0.5 ** ((now - stamp) / hl)
        rec[0], rec[1] = score, now
        if score < 1e-6:
            del self._suspicion[chip]
            return 0.0
        return score

    def _prune_quarantine_locked(self, now: float) -> None:
        """Read-side relaxation: a quarantined chip whose suspicion decayed
        to half the threshold or below becomes a probation candidate
        (hysteresis: re-quarantine needs fresh evidence)."""
        half = self._threshold() * 0.5
        for c, st in list(self._state.items()):
            if st == STATE_QUARANTINED \
                    and self._decayed_locked(c, now) <= half:
                self._state[c] = STATE_PROBATION
                self._probation_passes[c] = 0

    def suspicion(self, chip: int) -> float:
        """The chip's current (decayed) suspicion score."""
        with self._lock:
            return self._decayed_locked(int(chip), self.clock.monotonic())

    def record_suspicion(self, chip: int, weight: float,
                         reason: str = "suspicion") -> str:
        """Land one piece of evidence against `chip`: decay its score, add
        `weight`; crossing the threshold QUARANTINES it (unless
        ED25519_TPU_QUARANTINE=0), and the chip-drop listeners fire as for
        a chip loss.  Returns the chip's state."""
        chip = int(chip)
        quarantined_now = False
        with self._lock:
            now = self.clock.monotonic()
            score = self._decayed_locked(chip, now) + float(weight)
            self._suspicion[chip] = [score, now]
            if (score >= self._threshold()
                    and self._state.get(chip) != STATE_QUARANTINED
                    and _config.get("ED25519_TPU_QUARANTINE")):
                self._state[chip] = STATE_QUARANTINED
                self._probation_passes.pop(chip, None)
                quarantined_now = True
            state = self._state.get(
                chip, STATE_SUSPECTED if score > 0 else STATE_HEALTHY)
        if quarantined_now:
            notify_chip_drop(chip, f"chip-quarantine: {reason}")
        return state

    def record_latency(self, chips, seconds) -> "tuple[int, ...]":
        """Feed one completed dispatch of `seconds` (on the scheduler's
        clock) over the placement `chips` to the latency ledger, and
        accrue STRAGGLER_SUSPICION for every chip that completed a
        straggler streak — the same ladder as sentinel divergence.
        Returns the flagged chips.  The ledger records first, then each
        flagged chip goes through `record_suspicion`: the two locks are
        never held together."""
        flagged = self.latency.record(chips, seconds)
        for c in flagged:
            self.record_suspicion(c, STRAGGLER_SUSPICION,
                                  "straggler: p90 over ratio x mesh median")
        return flagged

    def quarantine_chip(self, chip: int, reason: str = "quarantine") -> None:
        """Quarantine `chip` outright, its suspicion raised to at least the
        threshold, so it waits out a decay before probation like a chip
        that crossed it (the chip-drop listeners fire if it was not
        quarantined yet)."""
        chip = int(chip)
        with self._lock:
            now = self.clock.monotonic()
            self._suspicion[chip] = [max(self._decayed_locked(chip, now),
                                         self._threshold()), now]
            fresh = self._state.get(chip) != STATE_QUARANTINED
            self._state[chip] = STATE_QUARANTINED
            self._probation_passes.pop(chip, None)
        if fresh:
            notify_chip_drop(chip, f"chip-quarantine: {reason}")

    def load_states(self, states, reason: str = "loaded") -> None:
        """Apply a `chip_states()` snapshot — this registry's or the
        reference package's — chip by chip: its state ("dead" marks the
        chip dead for good), suspicion score and probation passes, as
        they were.  The chip-drop listeners fire for every chip that
        leaves placement."""
        dropped = []
        with self._lock:
            now = self.clock.monotonic()
            for chip, st in sorted(states.items()):
                chip = int(chip)
                score = float(st.get("suspicion", 0.0))
                if score:
                    self._suspicion[chip] = [score, now]
                else:
                    self._suspicion.pop(chip, None)
                state = st["state"]
                if state == "dead":
                    self._dead[chip] = float("inf")
                    dropped.append(chip)
                if state in (STATE_QUARANTINED, STATE_PROBATION):
                    self._state[chip] = state
                    dropped.append(chip)
                else:
                    self._state.pop(chip, None)
                if state == STATE_PROBATION:
                    self._probation_passes[chip] = int(
                        st.get("probation_passes", 0))
                else:
                    self._probation_passes.pop(chip, None)
        for chip in dropped:
            notify_chip_drop(chip, f"chip-state {reason}")

    def chip_state(self, chip: int) -> str:
        """healthy / suspected / quarantined / probation (a read applies
        the decay and the quarantine → probation relaxation)."""
        chip = int(chip)
        with self._lock:
            now = self.clock.monotonic()
            self._prune_quarantine_locked(now)
            st = self._state.get(chip)
            if st is not None:
                return st
            return (STATE_SUSPECTED if self._decayed_locked(chip, now) > 0
                    else STATE_HEALTHY)

    def quarantined_chips(self) -> "frozenset[int]":
        with self._lock:
            self._prune_quarantine_locked(self.clock.monotonic())
            return frozenset(c for c, st in self._state.items()
                             if st == STATE_QUARANTINED)

    def probation_chips(self) -> "frozenset[int]":
        """Chips eligible for (or in) probation probing: out of placement
        until they pass their clean probes."""
        with self._lock:
            self._prune_quarantine_locked(self.clock.monotonic())
            return frozenset(c for c, st in self._state.items()
                             if st == STATE_PROBATION
                             and c not in self._dead)

    def excluded_chips(self) -> "frozenset[int]":
        """The chips placement must avoid right now: reported dead (heal
        windows pruned), quarantined or on probation."""
        with self._lock:
            self._prune_dead_locked()
            self._prune_quarantine_locked(self.clock.monotonic())
            return frozenset(self._dead) | frozenset(self._state)

    def record_probation_pass(self, chip: int) -> bool:
        """One clean probation probe; True when the chip completed its
        probation and REJOINED (state and suspicion cleared)."""
        chip = int(chip)
        with self._lock:
            self._prune_quarantine_locked(self.clock.monotonic())
            if self._state.get(chip) != STATE_PROBATION:
                return False
            n = self._probation_passes.get(chip, 0) + 1
            if n >= _config.get("ED25519_TPU_PROBATION_PROBES"):
                del self._state[chip]
                self._probation_passes.pop(chip, None)
                self._suspicion.pop(chip, None)
                return True
            self._probation_passes[chip] = n
            return False

    def record_probation_fail(self, chip: int,
                              weight: float = SENTINEL_SUSPICION,
                              reason: str = "probation-probe-failed"
                              ) -> None:
        """A probation probe diverged, errored or ran over the latency
        gate: back to QUARANTINED with suspicion at or above the
        threshold, so the chip waits out a full decay before its next
        probation window."""
        chip = int(chip)
        with self._lock:
            now = self.clock.monotonic()
            score = max(self._decayed_locked(chip, now) + float(weight),
                        self._threshold())
            self._suspicion[chip] = [score, now]
            requarantined = self._state.get(chip) != STATE_QUARANTINED
            self._state[chip] = STATE_QUARANTINED
            self._probation_passes.pop(chip, None)
        if requarantined:
            notify_chip_drop(chip, f"chip-requarantine: {reason}")

    def chip_states(self) -> "dict[int, dict]":
        """{chip: {state, suspicion, probation_passes}} for every chip with
        any ledger state ("dead" for a chip reported dead)."""
        with self._lock:
            now = self.clock.monotonic()
            self._prune_dead_locked()
            self._prune_quarantine_locked(now)
            chips = set(self._dead) | set(self._state) | set(self._suspicion)
            return {
                c: {
                    "state": ("dead" if c in self._dead
                              else self._state.get(
                                  c, STATE_SUSPECTED
                                  if self._decayed_locked(c, now) > 0
                                  else STATE_HEALTHY)),
                    "suspicion": round(self._decayed_locked(c, now), 4),
                    "probation_passes": self._probation_passes.get(c, 0),
                }
                for c in sorted(chips)
            }

    def healthy_count(self, total: int) -> int:
        """How many of the chips [0, total) are placeable right now."""
        excluded = self.excluded_chips()
        return sum(1 for c in range(int(total)) if c not in excluded)

    def surviving(self, want: int, total: int) -> "tuple[int, ...] | None":
        """The first `want` placeable chips among [0, total), or None when
        fewer remain."""
        excluded = self.excluded_chips()
        out = [c for c in range(int(total)) if c not in excluded]
        return tuple(out[:int(want)]) if len(out) >= int(want) else None

    def reset(self) -> None:
        """Clear all chip-death, suspicion, quarantine, probation and
        latency state and restore the process clock."""
        with self._lock:
            self._dead.clear()
            self._suspicion.clear()
            self._state.clear()
            self._probation_passes.clear()
            self.clock = SYSTEM_CLOCK
        self.latency.reset()

    def __repr__(self):
        with self._lock:
            return (f"ChipRegistry(dead={sorted(self._dead)}, "
                    f"states={dict(sorted(self._state.items()))})")


_chip_registry = ChipRegistry()


def chip_registry() -> ChipRegistry:
    """The process ChipRegistry."""
    return _chip_registry


class DeviceHealth:
    """Health/backoff state for ONE dispatch mode.  The state machine, in
    degradation-ladder order:

    * `note_deadline_miss()` — a device call blew its turnaround deadline,
      or raised a fatal error: skip the device lane for
      `DEADLINE_COOLDOWN` seconds.
    * `note_uncompetitive()` — the device was MEASURED and still won zero
      batches: pause probing for `UNCOMPETITIVE_PAUSE` seconds.
    * `note_unresolved_probe()` — a call's probe never resolved; a streak
      of `UNRESOLVED_PROBE_LIMIT` arms the shorter
      `UNRESOLVED_PROBE_PAUSE`.
    * `note_probe_resolved()` — a measured probe clears the streak.
    * `mark_lane_stuck()` — a lane worker was abandoned mid-call."""

    DEADLINE_COOLDOWN = 30.0
    UNCOMPETITIVE_PAUSE = 60.0
    UNRESOLVED_PROBE_LIMIT = 2
    UNRESOLVED_PROBE_PAUSE = 30.0

    def __init__(self, mesh: int = 0, clock: "Clock | None" = None):
        self.mesh = normalize_mesh(mesh)
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        self._lock = threading.Lock()
        self._cooldown_until = 0.0
        self._uncompetitive_until = 0.0
        self._unresolved_probe_streak = 0
        # Grace the host race gives a YOUNG fully-overtaken probe to
        # deliver its timing before it is discarded (seconds).
        self._young_probe_grace = 3.0
        self._lane_stuck = False

    def now(self) -> float:
        return self.clock.monotonic()

    def device_allowed(self) -> bool:
        """False while any cooldown/pause is armed."""
        with self._lock:
            now = self.clock.monotonic()
            return (now >= self._cooldown_until
                    and now >= self._uncompetitive_until)

    def in_cooldown(self) -> bool:
        """True while the cooldown of a deadline miss or a fatal error is
        armed (the competitiveness pauses are not cooldowns)."""
        with self._lock:
            return self.clock.monotonic() < self._cooldown_until

    def note_deadline_miss(self) -> None:
        with self._lock:
            self._cooldown_until = (
                self.clock.monotonic() + self.DEADLINE_COOLDOWN)

    def note_uncompetitive(self) -> None:
        with self._lock:
            self._uncompetitive_until = (
                self.clock.monotonic() + self.UNCOMPETITIVE_PAUSE)
            self._unresolved_probe_streak = 0

    def note_unresolved_probe(self) -> bool:
        """Count one unresolved probe; True when the streak reached the
        limit and the re-probe backoff armed."""
        with self._lock:
            self._unresolved_probe_streak += 1
            if self._unresolved_probe_streak >= self.UNRESOLVED_PROBE_LIMIT:
                self._uncompetitive_until = (
                    self.clock.monotonic() + self.UNRESOLVED_PROBE_PAUSE)
                return True
            return False

    def note_probe_resolved(self) -> None:
        with self._lock:
            self._unresolved_probe_streak = 0

    def mark_lane_stuck(self) -> None:
        with self._lock:
            self._lane_stuck = True
        with _latch_lock:
            _lane_stuck_latch[0] = True
        # Outside both locks: a dead/abandoned lane drops all device
        # operand residency.
        notify_residency_drop(f"lane-stuck mesh={self.mesh}")

    def reset(self) -> None:
        """Clear cooldowns, pauses, the streak and the stuck flag; the
        young-probe grace is configuration and is kept."""
        with self._lock:
            self._cooldown_until = 0.0
            self._uncompetitive_until = 0.0
            self._unresolved_probe_streak = 0
            self._lane_stuck = False

    @property
    def cooldown_until(self) -> float:
        with self._lock:
            return self._cooldown_until

    @property
    def uncompetitive_until(self) -> float:
        with self._lock:
            return self._uncompetitive_until

    @property
    def unresolved_probe_streak(self) -> int:
        with self._lock:
            return self._unresolved_probe_streak

    @property
    def lane_stuck(self) -> bool:
        with self._lock:
            return self._lane_stuck

    @property
    def young_probe_grace(self) -> float:
        with self._lock:
            return self._young_probe_grace

    def __repr__(self):
        with self._lock:
            return (f"DeviceHealth(mesh={self.mesh}, "
                    f"cooldown_until={self._cooldown_until:.3f}, "
                    f"uncompetitive_until={self._uncompetitive_until:.3f}, "
                    f"streak={self._unresolved_probe_streak}, "
                    f"lane_stuck={self._lane_stuck})")


class Backoff:
    """Deterministic seeded-jitter exponential backoff on an injectable
    Clock: attempt k waits base·factor^(k−1), capped at `max_delay`,
    scaled by a jitter factor that is a pure function of (seed, attempt)."""

    def __init__(self, clock: "Clock | None" = None, base: float = 1.0,
                 factor: float = 2.0, max_delay: float = 60.0,
                 jitter: float = 0.25, seed: int = 0):
        if not 0.0 <= jitter < 1.0:
            raise ValueError("jitter must be in [0, 1)")
        self.clock = clock if clock is not None else SYSTEM_CLOCK
        self.base = float(base)
        self.factor = float(factor)
        self.max_delay = float(max_delay)
        self.jitter = float(jitter)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._attempt = 0
        self._until = 0.0

    def _jitter_factor(self, attempt: int) -> float:
        digest = hashlib.sha256(
            repr((self.seed, attempt, "backoff")).encode()).digest()
        u = int.from_bytes(digest[:8], "little") / float(1 << 64)
        return 1.0 - self.jitter + 2.0 * self.jitter * u

    def delay_for(self, attempt: int) -> float:
        if attempt < 1:
            return 0.0
        raw = min(self.base * self.factor ** (attempt - 1),
                  self.max_delay)
        return raw * self._jitter_factor(attempt)

    def arm(self) -> float:
        """Advance to the next attempt and arm its delay from now; returns
        the delay."""
        with self._lock:
            self._attempt += 1
            d = self.delay_for(self._attempt)
            self._until = self.clock.monotonic() + d
            return d

    def expired(self) -> bool:
        """True once the armed delay has elapsed (or none is armed)."""
        with self._lock:
            return self.clock.monotonic() >= self._until

    def reset(self) -> None:
        with self._lock:
            self._attempt = 0
            self._until = 0.0

    def __repr__(self):
        with self._lock:
            return (f"Backoff(attempt={self._attempt}, "
                    f"until={self._until:.3f}, base={self.base}, "
                    f"max_delay={self.max_delay})")


_registry: "dict[int, DeviceHealth]" = {}
_registry_lock = threading.Lock()


def health_for(mesh: int = 0) -> DeviceHealth:
    """The process DeviceHealth for a dispatch mode (tests that want an
    isolated fake-clock instance construct `DeviceHealth` directly)."""
    mesh = normalize_mesh(mesh)
    with _registry_lock:
        h = _registry.get(mesh)
        if h is None:
            h = DeviceHealth(mesh=mesh)
            _registry[mesh] = h
        return h


def reset_all() -> None:
    """Reset every registered DeviceHealth, the lane-stuck latch and the
    chip registry."""
    with _registry_lock:
        healths = list(_registry.values())
    for h in healths:
        h.reset()
    with _latch_lock:
        _lane_stuck_latch[0] = False
    _chip_registry.reset()


def any_lane_stuck() -> bool:
    """True if any device-lane worker in this process was ever abandoned
    mid-call."""
    with _latch_lock:
        return _lane_stuck_latch[0]
