"""Deterministic, seedable fault injection for the device dispatch path.

A `FaultPlan` is a deterministic schedule mapping (site, call index) to an
action; `install`ing one makes the dispatch boundaries consult it:

* SITE_LANE — the `_DeviceLane` worker's dispatch (batch.py);
* SITE_SHARDED — every sharded-mesh dispatch (parallel/sharded_msm.py);
  the payload is each shard's chip id (parallel/mesh.shard_chips; None
  reads as 0 .. mesh − 1);
* SITE_DEVCACHE — the device operand cache's lookup (devcache.py); "call
  index" counts lookups and the payload is the cache itself;
* SITE_VERDICTCACHE — the verdict cache's lookup (verdictcache.py); "call
  index" counts memo lookups and the payload is the cache itself;
* SITE_PERSIST — the verdict journal's append (persist.py); "call index"
  counts journal record appends and the payload is the journal itself;
* SITE_REPLICA — the federation's replica pump (federation.py); "call
  index" counts ReplicaSet pumps across all replicas and the payload is
  the `Replica` being pumped.

Fault classes: `ErrorOn` (the call raises), `TypedErrorOn` (raises one of
the classifier's typed shapes), `StallFor` (virtual clocks advance, real
clocks sleep), `FlappingLink` (every other window of calls raises),
`SlowChip` and `GrayFlap` (one chip's calls run late but correct, always
or in alternating windows),
`CorruptSum` (the result comes back with flipped entries),
`KillLane` (the worker thread dies mid-flight), at the sharded seam
`CorruptChipSum` (one chip corrupts its partial sum), `ChipLoss` (chips
die mid-wave, marked dead in the ChipRegistry) and `LinkFlap` (a chip's
link is down in every other window, marked dead then healed), at the
replica seam `ReplicaCrash`, `ReplicaWedge` and `SplitCapacity`, and at the cache seam
`CorruptResidentEntry`, `EvictStorm`, `StaleEpochOn` and `RotateTenant`,
at the memo seam `CorruptStoredVerdict` (`EvictStorm` and
`StaleEpochOn` take either cache seam), and at the journal seam the
persistence storms `TornWrite`, `BitRot`, `TruncateJournal`,
`VersionSkew` and `StaleEpochPins`.

Every decision is a pure function of (plan seed, site, call index), so a
plan replayed over the same call stream injects identically.

No fault class may ever change a verdict: an error past its retries, a
stall past the deadline or a lane death fails the call (verify_many
raises DeviceError and gives no verdict); a corrupted sum can at worst
make the device claim
"reject", which verify_many re-decides on the host, or — one chip's partial
sum, audited — a divergence the sentinel catches (the call raises); a
corrupted, evicted,
stale or rotated resident entry is caught by the cache's epoch and hash
checks and restages; a corrupted, evicted or stale memoized verdict is
caught by the verdict cache's epoch pins and re-hash and verifies in
full; a corrupted journal costs recovered records, never a verdict.
With no plan installed, `run_device_call` is one read and one `is None`
check.
"""

import hashlib
import random
import threading
import time
from contextlib import contextmanager

import numpy as np

__all__ = [
    "SITE_LANE", "SITE_SHARDED", "SITE_DEVCACHE", "SITE_VERDICTCACHE",
    "SITE_PERSIST", "SITE_REPLICA", "InjectedFault",
    "ReplicaCrashError", "ReplicaWedgeError", "LinkFlap", "ReplicaCrash",
    "ReplicaWedge", "SplitCapacity", "mesh_plan", "replica_plan",
    "TransientDispatchError", "FatalChipError", "LaneDeathSignal", "Fault",
    "ErrorOn", "TypedErrorOn", "StallFor", "FlappingLink", "SlowChip",
    "GrayFlap", "CorruptSum", "CorruptChipSum", "KillLane", "ChipLoss",
    "CorruptResidentEntry", "EvictStorm", "StaleEpochOn", "RotateTenant",
    "CorruptStoredVerdict", "TornWrite", "BitRot", "TruncateJournal",
    "VersionSkew", "StaleEpochPins", "FaultPlan", "randomized_plan",
    "storm_plan", "slow_plan", "sentinel_plan", "devcache_plan",
    "verdictcache_plan", "persist_plan", "typed_error_plan",
    "install", "uninstall", "injected", "active_plan", "run_device_call",
]

SITE_LANE = "lane"
SITE_SHARDED = "sharded"
SITE_DEVCACHE = "devcache"
SITE_VERDICTCACHE = "verdictcache"
SITE_PERSIST = "persist"
SITE_REPLICA = "replica"


class InjectedFault(RuntimeError):
    """An injected device fault (no classification marker: the
    classifier's AMBIGUOUS bucket)."""


class TransientDispatchError(InjectedFault):
    """A typed TRANSIENT dispatch error: the scheduler retries the chunk
    with bounded backoff."""

    device_error_class = "transient"


class FatalChipError(InjectedFault):
    """A typed FATAL dispatch error naming the chips that are gone."""

    device_error_class = "fatal"

    def __init__(self, msg: str, chips=(), heal_after: "float | None" = None,
                 chips_marked: bool = False):
        super().__init__(msg)
        self.chips = tuple(int(c) for c in chips)
        self.heal_after = heal_after
        self.chips_marked = bool(chips_marked)


class ReplicaCrashError(InjectedFault):
    """A whole replica service died: FATAL at replica granularity — the
    federation ejects it, re-issues its surrendered queue on peers and
    later revives it into the probation probes."""

    device_error_class = "fatal"

    def __init__(self, msg: str, replica: int = 0):
        super().__init__(msg)
        self.replica = int(replica)


class ReplicaWedgeError(InjectedFault):
    """A replica's pump made no progress (a wedged runtime, a breaker
    stuck open): TRANSIENT — one wedge is a strike, so repeated wedges
    walk suspicion → drain → eject."""

    device_error_class = "transient"

    def __init__(self, msg: str, replica: int = 0):
        super().__init__(msg)
        self.replica = int(replica)


class LaneDeathSignal(Exception):
    """Raised through the lane worker to kill it mid-flight; the worker
    exits WITHOUT reporting a result."""


def _stable_seed(*parts) -> int:
    """A cross-process-deterministic int seed from mixed parts."""
    digest = hashlib.sha256(repr(parts).encode()).digest()
    return int.from_bytes(digest[:8], "little")


def _as_call_set(on):
    """`on` as a membership predicate over call indices: int, iterable of
    ints, or a callable(index) -> bool."""
    if callable(on):
        return on
    if isinstance(on, int):
        return frozenset((on,)).__contains__
    return frozenset(int(i) for i in on).__contains__


class Fault:
    """One fault rule: fires at `site` on the call indices `on` (0-based,
    counted per site)."""

    def __init__(self, on=0, site: str = SITE_LANE):
        self.site = site
        self._fires = _as_call_set(on)

    def fires_on(self, index: int) -> bool:
        return bool(self._fires(index))

    def before(self, ctx) -> None:
        """May stall; may raise to abort the call."""

    def after(self, ctx, out):
        """May transform the completed result."""
        return out

    def kind(self) -> str:
        return type(self).__name__


class ErrorOn(Fault):
    def before(self, ctx):
        raise InjectedFault(
            f"injected device error (site={ctx.site}, call={ctx.index})")


class TypedErrorOn(Fault):
    """Raise one of the classifier's input shapes: ``transient``
    (TransientDispatchError), ``fatal`` (FatalChipError naming `chips`),
    ``ambiguous`` (plain InjectedFault), ``timeout`` (TimeoutError) or
    ``oserror`` (ConnectionResetError)."""

    def __init__(self, kind: str = "transient", on=0,
                 site: str = SITE_LANE, chips=(),
                 heal_after: "float | None" = None):
        if kind not in ("transient", "fatal", "ambiguous", "timeout",
                        "oserror"):
            raise ValueError(f"unknown typed-error kind {kind!r}")
        super().__init__(on=on, site=site)
        self.error_kind = kind
        self.chips = tuple(int(c) for c in chips)
        self.heal_after = heal_after

    def before(self, ctx):
        where = f"(site={ctx.site}, call={ctx.index})"
        if self.error_kind == "transient":
            raise TransientDispatchError(
                f"injected transient dispatch error {where}")
        if self.error_kind == "fatal":
            raise FatalChipError(
                f"injected fatal chip error: chips {list(self.chips)} "
                f"{where}", chips=self.chips, heal_after=self.heal_after)
        if self.error_kind == "timeout":
            raise TimeoutError(f"injected dispatch timeout {where}")
        if self.error_kind == "oserror":
            raise ConnectionResetError(f"injected link reset {where}")
        raise InjectedFault(f"injected ambiguous device error {where}")


class StallFor(Fault):
    """Stall the call for `seconds`: a virtual clock is advanced, a real
    clock sleeps."""

    def __init__(self, seconds: float, on=0, site: str = SITE_LANE):
        super().__init__(on=on, site=site)
        self.seconds = float(seconds)

    def before(self, ctx):
        clock = ctx.clock
        if clock is not None and getattr(clock, "virtual", False):
            clock.advance(self.seconds)
        else:
            time.sleep(self.seconds)


class FlappingLink(Fault):
    """A link that flaps with period `period`: calls in every other
    period-sized window raise ("down"), the rest pass ("up").  The first
    window is up, so a probe on a freshly flapping link still
    measures."""

    def __init__(self, period: int = 2, site: str = SITE_LANE):
        if period < 1:
            raise ValueError("period must be >= 1")
        super().__init__(on=lambda i, p=period: (i // p) % 2 == 1,
                         site=site)
        self.period = period

    def before(self, ctx):
        raise InjectedFault(
            f"flapping link down (site={ctx.site}, call={ctx.index})")


class SlowChip(Fault):
    """A GRAY failure: chip `chip` runs every dispatch it takes part in
    `seconds` slower — no error, no corruption, correct results late.  The
    delay lands only when `chip` is in the call's placement (the lane and
    sharded seams pass the chip ids as payload; None reads as 0 .. mesh −
    1), so a chip reformed out of placement stops slowing anything.  A
    virtual clock advances, a real clock sleeps.  Detecting it is the
    latency ledger's job."""

    def __init__(self, chip: int, seconds: float, on=None,
                 site: str = SITE_LANE):
        # Default: every call — gray failure is a condition, not an event.
        super().__init__(on=(lambda i: True) if on is None else on,
                         site=site)
        self.chip = int(chip)
        self.seconds = float(seconds)

    def kind(self) -> str:
        return f"SlowChip[{self.chip}]"

    def _in_placement(self, ctx) -> bool:
        ids = (tuple(ctx.payload) if ctx.payload
               else tuple(range(ctx.mesh or 1)))
        return self.chip in ids

    def before(self, ctx):
        if not self._in_placement(ctx):
            return
        clock = ctx.clock
        if clock is not None and getattr(clock, "virtual", False):
            clock.advance(self.seconds)
        else:
            time.sleep(self.seconds)


class GrayFlap(SlowChip):
    """Alternating gray failure: slow for `period` calls, normal for the
    next `period`, and so on, the first window slow (a pure function of
    the per-site call index).  Windows shorter than
    ED25519_TPU_STRAGGLER_MIN_SAMPLES must never complete a straggler
    streak: the no-oscillation fixture."""

    def __init__(self, chip: int, seconds: float, period: int = 4,
                 site: str = SITE_LANE):
        if period < 1:
            raise ValueError("period must be >= 1")
        super().__init__(
            chip, seconds,
            on=lambda i, p=period: (i // p) % 2 == 0, site=site)
        self.period = int(period)

    def kind(self) -> str:
        return f"GrayFlap[{self.chip}]"


def _host_copy(out):
    """A numpy copy of a result (an array, or a tensor on any device) and
    the function that puts a corrupted copy back in the result's form."""
    if hasattr(out, "detach"):  # a torch tensor: back on its device
        import torch

        arr = out.detach().cpu().numpy().copy()
        return arr, lambda a: torch.from_numpy(a).to(out.device)
    return np.array(out, copy=True), lambda a: a


def _flip_rows(arr, rng, flips: int) -> None:
    """Flip `flips` random low bits in every leading-axis slice of arr."""
    rows = arr.reshape(arr.shape[0], -1) if arr.ndim > 1 \
        else arr.reshape(1, -1)
    for row in rows:
        for _ in range(max(1, flips)):
            row[rng.randrange(row.size)] ^= 1 << rng.randrange(12)


class CorruptSum(Fault):
    """Complete the call, then flip `flips` entries in EVERY leading-axis
    slice of the result — a corrupted device sum.  Random corruption moves
    a valid batch's combined point off the 8-torsion coset, so it becomes
    a device REJECT, which verify_many re-decides on the host."""

    def __init__(self, on=0, site: str = SITE_LANE, flips: int = 4):
        super().__init__(on=on, site=site)
        self.flips = int(flips)

    def after(self, ctx, out):
        arr, back = _host_copy(out)
        _flip_rows(arr, random.Random(_stable_seed(
            ctx.plan.seed, ctx.site, ctx.index, "corrupt")), self.flips)
        return back(arr)


class CorruptChipSum(Fault):
    """ONE chip of the mesh silently corrupts ITS partial window sums: the
    call completes and the fold is poisoned by exactly that shard.

    On a plain sharded result (B, 4, NLIMBS, 33) the fault flips entries
    per batch slice, like CorruptSum.  On an AUDIT-form result (1 + D, B,
    4, NLIMBS, 33) it corrupts the folded rows AND the chip's own partial,
    so the sentinel's host recomputation of that shard diverges and names
    the chip.  `flip_accept=True` overwrites them with identity window
    sums instead — the device then claims ACCEPT for every batch, the
    direction only the sentinel audit can see.  A chip outside the call's
    placement corrupts nothing."""

    def __init__(self, chip: int, on=0, site: str = SITE_SHARDED,
                 flips: int = 4, flip_accept: bool = False):
        super().__init__(on=on, site=site)
        self.chip = int(chip)
        self.flips = int(flips)
        self.flip_accept = bool(flip_accept)

    def kind(self) -> str:
        return ("CorruptChipSum[accept]" if self.flip_accept
                else "CorruptChipSum")

    def _shard_of(self, ctx) -> "int | None":
        ids = (tuple(ctx.payload) if ctx.payload
               else tuple(range(ctx.mesh or 1)))
        return ids.index(self.chip) if self.chip in ids else None

    def after(self, ctx, out):
        shard = self._shard_of(ctx)
        if shard is None:
            return out
        arr, back = _host_copy(out)
        rng = random.Random(_stable_seed(
            ctx.plan.seed, ctx.site, ctx.index, "chip-corrupt", self.chip))
        targets = [arr[0], arr[1 + shard]] if arr.ndim == 5 else [arr]
        for t in targets:
            if self.flip_accept:
                t[...] = 0
                t[..., 1, 0, :] = 1  # Y limb 0
                t[..., 2, 0, :] = 1  # Z limb 0
            else:
                _flip_rows(t, rng, self.flips)
        return back(arr)


class KillLane(Fault):
    """Kill the lane worker mid-flight.  `advance` pre-advances a virtual
    clock, so the orphaned chunk's deadline expires deterministically."""

    def __init__(self, on=0, advance: float = 3600.0):
        super().__init__(on=on, site=SITE_LANE)
        self.advance = float(advance)

    def before(self, ctx):
        clock = ctx.clock
        if clock is not None and getattr(clock, "virtual", False) \
                and self.advance:
            clock.advance(self.advance)
        raise LaneDeathSignal(f"injected lane death (call={ctx.index})")


class ChipLoss(Fault):
    """Chip(s) die AT the faulted dispatch: marked dead in the process
    ChipRegistry, and the call raises a FatalChipError naming them (already
    marked) — the shape of a card dropping out mid-wave, which takes the
    whole sharded call down with it.  `chip` is one index or an iterable;
    `heal_after` (registry-clock seconds) makes the loss transient.  The
    scheduler then reforms the mesh onto the survivors and re-issues the
    wave's undecided batches on the device."""

    def __init__(self, chip, on=0, heal_after: "float | None" = None,
                 site: str = SITE_SHARDED):
        super().__init__(on=on, site=site)
        self.chips = (tuple(int(c) for c in chip)
                      if hasattr(chip, "__iter__") else (int(chip),))
        self.heal_after = heal_after

    def before(self, ctx):
        from . import health as _health

        reg = _health.chip_registry()
        for c in self.chips:
            reg.mark_chip_dead(
                c, heal_after=self.heal_after,
                reason=f"injected chip loss (site={ctx.site}, "
                       f"call={ctx.index})")
        raise FatalChipError(
            f"injected chip loss: chips {list(self.chips)} died mid-wave "
            f"(site={ctx.site}, call={ctx.index})",
            chips=self.chips, heal_after=self.heal_after, chips_marked=True)


class LinkFlap(Fault):
    """Chip `chip`'s link flaps with period `period` over the faulted
    site's calls: in every other period-sized window the chip is marked
    dead (with a `heal_after` window on the registry clock) and the call
    raises a FatalChipError naming it; in the others the chip is healed,
    so routing reforms back up.  Unlike `FlappingLink`, which only errors
    calls, the flap is visible to the reformation ladder."""

    def __init__(self, chip: int, period: int = 2,
                 site: str = SITE_SHARDED, heal_after: float = 30.0):
        if period < 1:
            raise ValueError("period must be >= 1")
        super().__init__(on=lambda i: True, site=site)
        self.chip = int(chip)
        self.period = int(period)
        self.heal_after = float(heal_after)

    def before(self, ctx):
        from . import health as _health

        down = (ctx.index // self.period) % 2 == 1
        reg = _health.chip_registry()
        if down:
            reg.mark_chip_dead(
                self.chip, heal_after=self.heal_after,
                reason=f"injected link flap (site={ctx.site}, "
                       f"call={ctx.index})")
            raise FatalChipError(
                f"flapping link down: chip {self.chip} "
                f"(site={ctx.site}, call={ctx.index})",
                chips=(self.chip,), heal_after=self.heal_after,
                chips_marked=True)
        reg.heal_chip(self.chip)


class ReplicaCrash(Fault):
    """Kill replica `replica` of a federation at its first pump inside the
    window (SITE_REPLICA; the payload is the Replica pumped): raises
    ReplicaCrashError, FATAL, so the ReplicaSet ejects it, re-issues its
    queue on peers and later revives it.  One event: the fault latches
    after firing, so the revived replica's probes are not re-crashed."""

    def __init__(self, replica: int, on=0):
        super().__init__(on=on, site=SITE_REPLICA)
        self.replica = int(replica)
        self._fired = [False]

    def before(self, ctx):
        if self._fired[0]:
            return
        if ctx.payload is None or \
                getattr(ctx.payload, "rid", None) != self.replica:
            return
        self._fired[0] = True
        raise ReplicaCrashError(
            f"injected replica crash: replica {self.replica} died "
            f"mid-wave (call={ctx.index})", replica=self.replica)


class ReplicaWedge(Fault):
    """Replica `replica`'s pumps inside the window wedge: a virtual clock
    advances `seconds` and the pump raises ReplicaWedgeError (TRANSIENT),
    so the replica is ejected only on accumulated evidence."""

    def __init__(self, replica: int, on=0, seconds: float = 5.0):
        super().__init__(on=on, site=SITE_REPLICA)
        self.replica = int(replica)
        self.seconds = float(seconds)

    def before(self, ctx):
        if ctx.payload is None or \
                getattr(ctx.payload, "rid", None) != self.replica:
            return
        clock = ctx.clock
        if clock is not None and getattr(clock, "virtual", False):
            clock.advance(self.seconds)
        raise ReplicaWedgeError(
            f"injected replica wedge: replica {self.replica} made no "
            f"progress (call={ctx.index})", replica=self.replica)


class SplitCapacity(Fault):
    """Replica `replica` loses `frac` of its capacity at the faulted pump:
    the Replica's `degraded_frac` is set, which the federation router
    reads as its effective-capacity fraction.  No raise: the replica keeps
    serving, degraded, and lower classes spill to healthy peers."""

    def __init__(self, replica: int, on=0, frac: float = 0.5):
        super().__init__(on=on, site=SITE_REPLICA)
        self.replica = int(replica)
        self.frac = float(frac)

    def before(self, ctx):
        if ctx.payload is None or \
                getattr(ctx.payload, "rid", None) != self.replica:
            return
        ctx.payload.degraded_frac = self.frac


class CorruptResidentEntry(Fault):
    """Flip bytes in the looked-up resident entry's HOST mirror.  The
    cache's hash re-check runs after this seam on every hit, so the
    corruption forces a restage before any dispatch could use it."""

    def __init__(self, on=0, flips: int = 4):
        super().__init__(on=on, site=SITE_DEVCACHE)
        self.flips = int(flips)

    def after(self, ctx, out):
        if out is not None:
            rng = random.Random(_stable_seed(
                ctx.plan.seed, ctx.site, ctx.index, "resident"))
            flat = out.head_tensor.reshape(-1)
            for _ in range(max(1, self.flips)):
                flat[rng.randrange(flat.size)] ^= 1 << rng.randrange(8)
        return out


class EvictStorm(Fault):
    """Drop EVERY entry at the faulted lookup (the payload is the cache):
    the lookup becomes a miss and the batch restages, or — at the
    verdict cache's seam — verifies in full."""

    def __init__(self, on=0, site: str = SITE_DEVCACHE):
        super().__init__(on=on, site=site)

    def before(self, ctx):
        if ctx.payload is not None:
            ctx.payload.drop_all("evict-storm fault")


class StaleEpochOn(Fault):
    """Bump the cache epoch at the faulted lookup, so the entry about to
    be returned is stale and restages (or, a memo, verifies in full)."""

    def __init__(self, on=0, site: str = SITE_DEVCACHE):
        super().__init__(on=on, site=site)

    def before(self, ctx):
        if ctx.payload is not None:
            ctx.payload.bump_epoch("stale-epoch fault")


class CorruptStoredVerdict(Fault):
    """Flip the STORED VERDICT BIT of the looked-up verdict-cache entry
    (SITE_VERDICTCACHE; `out` is the entry the lookup found), and with
    `flip_payload` a payload byte too.  The cache's per-hit re-hash runs
    after this seam: the flipped bit fails the seal (a flipped payload
    byte the digest), the entry drops, and the submission verifies in
    full — a corrupted stored verdict is never published."""

    def __init__(self, on=0, flip_payload: bool = False):
        super().__init__(on=on, site=SITE_VERDICTCACHE)
        self.flip_payload = bool(flip_payload)

    def after(self, ctx, out):
        if out is not None:
            out.verdict = not out.verdict
            if self.flip_payload:
                rng = random.Random(_stable_seed(
                    ctx.plan.seed, ctx.site, ctx.index, "verdict"))
                b = bytearray(out.payload)
                if b:
                    b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
                out.payload = bytes(b)
        return out


class RotateTenant(Fault):
    """Rotate ONE tenant's keyset epoch at the faulted devcache lookup (a
    validator-set rotation landing mid-wave): that tenant's resident
    entries go stale and restage; every other tenant's residency is
    untouched."""

    def __init__(self, on=0, tenant: str = "default"):
        super().__init__(on=on, site=SITE_DEVCACHE)
        self.tenant = tenant

    def before(self, ctx):
        if ctx.payload is not None:
            ctx.payload.rotate_tenant(self.tenant,
                                      "rotation fault (mid-wave)")


# -- persistence storms (SITE_PERSIST; ctx.payload is the journal) --------
#
# All five act AFTER a completed journal append: the file is corrupted
# between two well-formed writes, the state a crash or rot leaves for the
# next process's recovery to judge.  A journal record only re-enters a
# cache through the absorb re-hash gate, so every storm degrades to
# dropped records (or a dropped file) and full verification.


class TornWrite(Fault):
    """Tear the LAST appended record: truncate the file so only `frac`
    of that record's bytes survive (a crash or a full disk mid-append).
    Recovery's framing walk drops the torn tail; every record before it
    still loads."""

    def __init__(self, on=0, frac: float = 0.5):
        super().__init__(on=on, site=SITE_PERSIST)
        self.frac = float(frac)

    def after(self, ctx, out):
        span = getattr(ctx.payload, "last_record_span", None)
        if span is not None:
            offset, length = span
            keep = offset + max(1, int(length * self.frac))
            with open(ctx.payload.path, "rb+") as fh:
                fh.truncate(keep)
        return out


class BitRot(Fault):
    """Flip bit(s) inside the LAST appended record's bytes (seeded from
    the plan) under an intact file structure.  The per-record hash, the
    payload re-hash or the seal gate catches it at load."""

    def __init__(self, on=0, flips: int = 1):
        super().__init__(on=on, site=SITE_PERSIST)
        self.flips = int(flips)

    def after(self, ctx, out):
        span = getattr(ctx.payload, "last_record_span", None)
        if span is not None:
            offset, length = span
            rng = random.Random(_stable_seed(
                ctx.plan.seed, ctx.site, ctx.index, "bitrot"))
            with open(ctx.payload.path, "rb+") as fh:
                for _ in range(max(1, self.flips)):
                    pos = offset + rng.randrange(length)
                    fh.seek(pos)
                    b = fh.read(1)
                    fh.seek(pos)
                    fh.write(bytes((b[0] ^ (1 << rng.randrange(8)),)))
        return out


class TruncateJournal(Fault):
    """Truncate the journal's RECORD REGION to `frac` of its bytes (the
    header survives): a lost tail bigger than one append.  Recovery loads
    every record before the cut and drops the torn remainder."""

    def __init__(self, on=0, frac: float = 0.5):
        super().__init__(on=on, site=SITE_PERSIST)
        self.frac = float(frac)

    def after(self, ctx, out):
        from . import persist as _persist

        path = ctx.payload.path
        with open(path, "rb") as fh:
            data = fh.read()
        parsed, _reason = _persist._parse_header(data)
        if parsed is not None:
            start = parsed["end"]
            keep = start + int((len(data) - start) * self.frac)
            with open(path, "rb+") as fh:
                fh.truncate(keep)
        return out


class VersionSkew(Fault):
    """Rewrite the journal header to a FUTURE format version with a VALID
    header hash (persist.rewrite_header), so the gate under test is the
    version gate: recovery drops the whole file."""

    def __init__(self, on=0, skew: int = 1):
        super().__init__(on=on, site=SITE_PERSIST)
        self.skew = int(skew)

    def after(self, ctx, out):
        from . import persist as _persist

        _persist.rewrite_header(
            ctx.payload.path,
            version=_persist.FORMAT_VERSION + max(1, self.skew))
        return out


class StaleEpochPins(Fault):
    """Bump the header's GLOBAL epoch pin far above every record's, with
    a VALID header hash: the gate under test is the stale-pin rule, and
    recovery drops every record as pre-forfeiture."""

    def __init__(self, on=0, bump: int = 1000):
        super().__init__(on=on, site=SITE_PERSIST)
        self.bump = int(bump)

    def after(self, ctx, out):
        from . import persist as _persist

        _persist.rewrite_header(ctx.payload.path,
                                epoch_bump=max(1, self.bump))
        return out


class _CallContext:
    __slots__ = ("plan", "site", "index", "clock", "payload", "mesh")

    def __init__(self, plan, site, index, clock, payload=None, mesh=None):
        self.plan = plan
        self.site = site
        self.index = index
        self.clock = clock
        self.payload = payload
        self.mesh = mesh


class FaultPlan:
    """A deterministic schedule of faults over the device-call stream;
    call indices are counted per site, in dispatch order."""

    def __init__(self, faults=(), seed: int = 0):
        self.faults = list(faults)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._counts = {}
        self._log = []

    def calls_seen(self, site: str = SITE_LANE) -> int:
        with self._lock:
            return self._counts.get(site, 0)

    def injection_log(self) -> "list[tuple]":
        """(site, index, fault kind) of every fault applied, in order."""
        with self._lock:
            return list(self._log)

    def run(self, site: str, fn, *, clock=None, payload=None, mesh=None):
        with self._lock:
            idx = self._counts.get(site, 0)
            self._counts[site] = idx + 1
        fired = [f for f in self.faults
                 if f.site == site and f.fires_on(idx)]
        ctx = _CallContext(self, site, idx, clock, payload, mesh)
        if fired:
            with self._lock:
                self._log.extend((site, idx, f.kind()) for f in fired)
        for f in fired:
            f.before(ctx)
        out = fn()
        for f in fired:
            out = f.after(ctx, out)
        return out


def randomized_plan(seed: int, error_rate: float = 0.1,
                    stall_rate: float = 0.05, stall_seconds: float = 0.05,
                    corrupt_rate: float = 0.05, flap_period: int = 0,
                    slow_rate: float = 0.0, slow_seconds: float = 0.25,
                    slow_chip: int = 0,
                    site: str = SITE_LANE) -> FaultPlan:
    """Per call index, draw independently (from the seed) whether to
    error, stall or corrupt; rates are per-call probabilities.
    `flap_period` > 0 adds a FlappingLink on top; `slow_rate` > 0 adds
    gray-failure draws: chip `slow_chip` runs the drawn calls
    `slow_seconds` late but correct."""

    def drawn(kind, rate):
        def fires(i, kind=kind, rate=rate):
            return random.Random(
                _stable_seed(seed, site, i, kind)).random() < rate
        return fires

    faults = [
        ErrorOn(on=drawn("error", error_rate), site=site),
        StallFor(stall_seconds, on=drawn("stall", stall_rate), site=site),
        CorruptSum(on=drawn("corrupt", corrupt_rate), site=site),
    ]
    if flap_period:
        faults.append(FlappingLink(period=flap_period, site=site))
    if slow_rate:
        faults.append(SlowChip(slow_chip, slow_seconds,
                               on=drawn("slow", slow_rate), site=site))
    return FaultPlan(faults, seed=seed)


def storm_plan(seed: int, kind: str, at: int = 0, length: int = 1,
               seconds: float = 6.0, site: str = SITE_LANE,
               advance: float = 3600.0, chip: int = 0) -> FaultPlan:
    """One contiguous window of faults over the device-call stream:
    ``error`` (every call in [at, at+length) raises), ``stall`` (each
    stalls `seconds`), ``crash`` (the lane worker dies at those calls) or
    ``slow`` (a gray window: chip `chip` runs every call of the window it
    takes part in `seconds` late, correct)."""
    window = range(at, at + max(1, length))
    if kind == "error":
        faults = [ErrorOn(on=window, site=site)]
    elif kind == "stall":
        faults = [StallFor(seconds, on=window, site=site)]
    elif kind == "crash":
        faults = [KillLane(on=window, advance=advance)]
    elif kind == "slow":
        faults = [SlowChip(chip, seconds, on=window, site=site)]
    else:
        raise ValueError(f"unknown storm kind {kind!r}")
    return FaultPlan(faults, seed=seed)


def slow_plan(seed: int, chip: int, seconds: float,
              base_seconds: float = 0.0, kind: str = "persistent",
              period: int = 4,
              sites: "tuple[str, ...]" = (SITE_LANE,)) -> FaultPlan:
    """A GRAY-failure schedule: chip `chip` is `seconds` slow per dispatch
    it takes part in.  Default seam: SITE_LANE only — every scheduler
    dispatch (single lane, mesh, probation probe) crosses it once, while a
    mesh dispatch crosses SITE_SHARDED inside it too, so slowing both
    would charge the delay twice.

    `base_seconds` > 0 also stalls EVERY call at the same seams by that
    much: on a FakeClock real compute is invisible, so the healthy mesh
    needs a modelled cost for "10× slower" to mean anything (base 10 ms,
    seconds 90 ms: one chip at 10×).  `kind`: ``"persistent"`` (SlowChip)
    or ``"flap"`` (GrayFlap with `period`)."""
    faults = []
    for site in sites:
        if base_seconds > 0:
            faults.append(StallFor(base_seconds, on=lambda i: True,
                                   site=site))
        if kind == "persistent":
            faults.append(SlowChip(chip, seconds, site=site))
        elif kind == "flap":
            faults.append(GrayFlap(chip, seconds, period=period, site=site))
        else:
            raise ValueError(f"unknown slow-plan kind {kind!r}")
    return FaultPlan(faults, seed=seed)


def mesh_plan(seed: int, kind: str, chips=(0,), at: int = 0,
              stagger: int = 0, heal_after: "float | None" = None,
              period: int = 2, site: str = SITE_SHARDED) -> FaultPlan:
    """A chip-loss schedule over the sharded dispatch stream:
    ``"chip-loss"`` — every chip of `chips` dies at call `at + k·stagger`
    (stagger 0: one mid-wave event killing them together), transiently
    with `heal_after`; ``"link-flap"`` — `chips[0]`'s link flaps with
    `period`."""
    chips = [int(c) for c in chips] or [0]
    if kind == "chip-loss":
        if stagger <= 0:
            faults = [ChipLoss(chips, on=at, heal_after=heal_after,
                               site=site)]
        else:
            faults = [ChipLoss(c, on=at + k * stagger,
                               heal_after=heal_after, site=site)
                      for k, c in enumerate(chips)]
    elif kind == "link-flap":
        faults = [LinkFlap(chips[0], period=period, site=site)]
    else:
        raise ValueError(f"unknown mesh fault kind {kind!r}")
    return FaultPlan(faults, seed=seed)


def replica_plan(seed: int, kind: str, replica: int = 0, at: int = 0,
                 length: int = 1, seconds: float = 5.0,
                 frac: float = 0.5) -> FaultPlan:
    """A whole-replica fault schedule over the federation's pump stream
    (SITE_REPLICA): ``"crash"`` — replica `replica` dies at its first pump
    with index ≥ `at`; ``"wedge"`` — its pumps in [at, at+length) wedge
    for `seconds` each; ``"split-capacity"`` — it loses `frac` of its
    capacity from pump `at` on."""
    if kind == "crash":
        faults = [ReplicaCrash(replica, on=lambda i, a=at: i >= a)]
    elif kind == "wedge":
        faults = [ReplicaWedge(replica,
                               on=range(at, at + max(1, length)),
                               seconds=seconds)]
    elif kind == "split-capacity":
        faults = [SplitCapacity(replica, on=lambda i, a=at: i >= a,
                                frac=frac)]
    else:
        raise ValueError(f"unknown replica fault kind {kind!r}")
    return FaultPlan(faults, seed=seed)


def sentinel_plan(seed: int, kind: str, chip: int = 0, on=None,
                  at: int = 0, length: int = 1, flips: int = 4,
                  site: str = SITE_SHARDED) -> FaultPlan:
    """A per-chip corruption schedule for the sentinel audit:
    ``"corrupt-chip"`` (chip `chip` corrupts its partial sums at the
    faulted sharded calls) or ``"flip-accept"`` (the result becomes
    identity window sums: every batch a device ACCEPT, which only the
    audit catches).  `on` replaces the [at, at+length) window with any
    membership spec, e.g. `on=lambda i: True` for a persistent
    corruptor."""
    window = on if on is not None else range(at, at + max(1, length))
    if kind == "corrupt-chip":
        faults = [CorruptChipSum(chip, on=window, flips=flips, site=site)]
    elif kind == "flip-accept":
        faults = [CorruptChipSum(chip, on=window, flip_accept=True,
                                 site=site)]
    else:
        raise ValueError(f"unknown sentinel fault kind {kind!r}")
    return FaultPlan(faults, seed=seed)


def devcache_plan(seed: int, kind: str, at: int = 0, length: int = 1,
                  flips: int = 4, tenant: str = "default") -> FaultPlan:
    """A fault window over the device operand cache's LOOKUP stream:
    ``corrupt`` (flip host-mirror bytes), ``evict`` (drop all residency),
    ``stale`` (bump the epoch) or ``rotate`` (rotate `tenant`'s keyset
    epoch: exactly that tenant's entries restage)."""
    window = range(at, at + max(1, length))
    if kind == "corrupt":
        faults = [CorruptResidentEntry(on=window, flips=flips)]
    elif kind == "evict":
        faults = [EvictStorm(on=window)]
    elif kind == "stale":
        faults = [StaleEpochOn(on=window)]
    elif kind == "rotate":
        faults = [RotateTenant(on=window, tenant=tenant)]
    else:
        raise ValueError(f"unknown devcache fault kind {kind!r}")
    return FaultPlan(faults, seed=seed)


def verdictcache_plan(seed: int, kind: str, at: int = 0,
                      length: int = 1) -> FaultPlan:
    """A fault window over the VERDICT CACHE's lookup stream:
    ``corrupt-verdict`` (flip the stored verdict bit: the seal re-hash
    catches it), ``corrupt-payload`` (the bit and a payload byte: the
    digest re-hash catches it), ``evict`` (drop every stored verdict) or
    ``stale`` (bump the cache epoch)."""
    window = range(at, at + max(1, length))
    if kind == "corrupt-verdict":
        faults = [CorruptStoredVerdict(on=window)]
    elif kind == "corrupt-payload":
        faults = [CorruptStoredVerdict(on=window, flip_payload=True)]
    elif kind == "evict":
        faults = [EvictStorm(on=window, site=SITE_VERDICTCACHE)]
    elif kind == "stale":
        faults = [StaleEpochOn(on=window, site=SITE_VERDICTCACHE)]
    else:
        raise ValueError(f"unknown verdictcache fault kind {kind!r}")
    return FaultPlan(faults, seed=seed)


def persist_plan(seed: int, kind: str, at: int = 0, length: int = 1,
                 frac: float = 0.5, flips: int = 1,
                 skew: int = 1, bump: int = 1000) -> FaultPlan:
    """A persistence-storm window over the VERDICT JOURNAL's append stream
    (SITE_PERSIST; indices count record appends): ``torn`` (tear the
    appended record at `frac` of its bytes), ``bitrot`` (flip `flips`
    bits in it), ``truncate`` (cut the record region to `frac`),
    ``version-skew`` (header at FORMAT_VERSION + `skew`, valid hash) or
    ``stale-pins`` (header epoch pin + `bump`, valid hash).  Each
    degrades to dropped records or a dropped file and full verification."""
    window = range(at, at + max(1, length))
    if kind == "torn":
        faults = [TornWrite(on=window, frac=frac)]
    elif kind == "bitrot":
        faults = [BitRot(on=window, flips=flips)]
    elif kind == "truncate":
        faults = [TruncateJournal(on=window, frac=frac)]
    elif kind == "version-skew":
        faults = [VersionSkew(on=window, skew=skew)]
    elif kind == "stale-pins":
        faults = [StaleEpochPins(on=window, bump=bump)]
    else:
        raise ValueError(f"unknown persist fault kind {kind!r}")
    return FaultPlan(faults, seed=seed)


def typed_error_plan(seed: int, kind: str, at: int = 0, length: int = 1,
                     chips=(), heal_after: "float | None" = None,
                     site: str = SITE_LANE) -> FaultPlan:
    """Every call in [at, at+length) raises the `kind` shape (TypedErrorOn
    kinds)."""
    window = range(at, at + max(1, length))
    return FaultPlan([TypedErrorOn(kind, on=window, chips=chips,
                                   heal_after=heal_after, site=site)],
                     seed=seed)


_active = [None]
_active_lock = threading.Lock()


def install(plan: FaultPlan) -> FaultPlan:
    with _active_lock:
        if _active[0] is not None:
            raise RuntimeError("a FaultPlan is already installed")
        _active[0] = plan
    return plan


def uninstall() -> None:
    with _active_lock:
        _active[0] = None


def active_plan() -> "FaultPlan | None":
    with _active_lock:
        return _active[0]


@contextmanager
def injected(plan: FaultPlan):
    """`with faults.injected(plan): ...` — install for the block and
    uninstall on exit."""
    install(plan)
    try:
        yield plan
    finally:
        uninstall()


def run_device_call(site: str, fn, *, clock=None, payload=None,
                    mesh=None):
    """The seam the dispatch boundaries call: apply the active plan's
    faults for this (site, call) around `fn`.  `mesh` is the sharded
    dispatch's shard count.  No plan → `fn()`."""
    plan = _active[0]
    if plan is None:
        return fn()
    return plan.run(site, fn, clock=clock, payload=payload, mesh=mesh)
