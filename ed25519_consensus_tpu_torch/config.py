"""The ``ED25519_TPU_*`` environment knobs the port reads, under the JAX
package's names and meanings.

This module is the one place the port reads the environment.  Every knob
has a declared type with one parsing convention, a default and a one-line
doc.  Malformed numeric values raise :class:`ConfigError` at read time with
the knob name and the raw value.  Reads are live: nothing is cached, so a
long-running process can flip an opt-out knob mid-flight.

Type conventions:

* ``choice``  — lowercased and matched against ``choices``; anything else
  falls back to the default.
* ``opt-in``  — boolean, default False; ONLY ``1``/``true``/``yes`` enable.
* ``opt-out`` — boolean, default True; ONLY ``0``/``false``/``no`` disable.
* ``flag``    — boolean, default False; any non-empty value enables.
* ``float`` / ``int`` — parsed strictly; unset or empty means the default.
* ``path``    — raw string; unset returns the default, an explicitly
  empty value is returned as is (and reads as "off" where a path is
  optional).

The registry holds 36 of the JAX registry's 54 knobs.  Left out on
purpose: ``ED25519_TPU_MSM_KERNEL`` (it picks a TPU kernel, Pallas or the
XLA scan; the port picks the CUDA kernel or its plain twin by a call's
``device=``), ``ED25519_TPU_PALLAS_BODY`` and ``ED25519_TPU_WIN_CHUNK``
(TPU tuning knobs of the window-sum kernel's body and windows per grid
step: on the H100 every value but the default measured slower, so the
verdict path launches the default K2 and K2t with no knob, and the kernel
lab reaches the other forms by argument), the TPU-measured routing and
hot-scale constants, the JAX compile-cache directory, the quota auto-sizer
(the port's cache always publishes its suggestions) and the labs' seed
knobs (each port lab's ``--seed`` default equals the JAX knob's default).
README's knob table renders :func:`knob_table`.
"""

import contextlib
import os

from .error import ConfigError

__all__ = ["ConfigError", "Knob", "KNOBS", "get", "get_raw", "override",
           "validate_all", "knob_table"]

_OPT_IN_TRUE = ("1", "true", "yes")
_OPT_OUT_FALSE = ("0", "false", "no")
_TYPES = ("choice", "opt-in", "opt-out", "flag", "float", "int", "path")


class Knob:
    """One registered environment knob."""

    __slots__ = ("name", "type", "default", "choices", "doc")

    def __init__(self, name: str, type: str, default, doc: str,
                 choices: "tuple | None" = None):
        if type not in _TYPES:
            raise ValueError(f"unknown knob type {type!r}")
        self.name = name
        self.type = type
        self.default = default
        self.choices = choices
        self.doc = doc

    def read(self):
        """The knob's current value (live read)."""
        raw = os.environ.get(self.name)
        if self.type == "choice":
            v = (raw or "").lower()
            return v if v in self.choices else self.default
        if self.type == "opt-in":
            return (raw or "").lower() in _OPT_IN_TRUE
        if self.type == "opt-out":
            return (raw or "").lower() not in _OPT_OUT_FALSE
        if self.type == "flag":
            return bool(raw)
        if self.type == "path":
            return self.default if raw is None else raw
        if not raw:
            return self.default
        try:
            return float(raw) if self.type == "float" else int(raw)
        except ValueError:
            raise ConfigError(self.name, raw,
                              f"a {self.type}" + (
                                  "" if self.default is None
                                  else f" (default {self.default})"))


def _k(name, type, default, doc, choices=None):
    return name, Knob(name, type, default, doc, choices)


KNOBS: "dict[str, Knob]" = dict([
    _k("ED25519_TPU_WIRE", "choice", "compressed",
       "Device point wire: `compressed` (33 B/term, x recomputed on the "
       "device by K1) or `affine` (80 B/term X‖Y limbs, T and Z by K6; no "
       "production caller needs it: it is kept for A/B parity with the "
       "JAX package).",
       ("compressed", "affine")),
    _k("ED25519_TPU_DIGIT_WIRE", "choice", "packed",
       "Scalar digit wire: `packed` (two signed radix-16 digits/byte, "
       "17 B/term) or `plain` (one digit/byte).", ("packed", "plain")),
    _k("ED25519_TPU_DEBUG", "flag", False,
       "Any non-empty value prints device-lane tracebacks before the "
       "error is classified."),
    _k("ED25519_TPU_DISABLE_DEVICE", "opt-in", False,
       "Force verify_many's pure-host lane (re-checked live on every "
       "call)."),
    _k("ED25519_TPU_DISABLE_NATIVE", "opt-in", False,
       "Skip the native C++ host runtime; every caller has an "
       "exact-Python path (re-checked live on every load())."),
    _k("ED25519_TPU_EMA_PRIOR", "float", 0.2,
       "Seconds-per-batch device turnaround prior before the first "
       "measurement (deadline budget is 3×EMA×batches, 2 s floor)."),
    _k("ED25519_TPU_MIN_LANES", "int", None,
       "Floor on the padded device lane count, so many small batches "
       "share one padded shape; unset/0 keeps tight padding."),
    _k("ED25519_TPU_DEVCACHE", "opt-out", True,
       "Set to 0/false/no to disable the device-resident operand cache "
       "(recurring-keyset residency, devcache.py)."),
    _k("ED25519_TPU_DEVCACHE_BYTES", "int", 1 << 26,
       "Device operand cache residency budget in bytes (deterministic "
       "LRU eviction above it); 0 also disables residency."),
    _k("ED25519_TPU_DEVCACHE_TABLES", "opt-out", True,
       "Set to 0/false/no to disable the resident multiples-TABLES kind "
       "of the device operand cache; head residency is unaffected."),
    _k("ED25519_TPU_SENTINEL_RATE", "float", 0.0,
       "Sampled sentinel-audit rate over cold sharded chunk dispatches "
       "(0..1): an audited chunk returns each shard's partial sums, one "
       "sampled shard is recomputed on the host, and a divergence is "
       "attributed to its chip; 0 disables auditing."),
    _k("ED25519_TPU_SUSPICION_THRESHOLD", "float", 3.0,
       "Decayed per-chip suspicion score at which the ChipRegistry "
       "quarantines a chip (a sentinel divergence weighs 1.5, an "
       "ambiguous dispatch error 0.25 per placement chip)."),
    _k("ED25519_TPU_SUSPICION_HALF_LIFE", "float", 300.0,
       "Half-life (registry-clock seconds) of per-chip suspicion "
       "scores; decay below half the threshold relaxes quarantine to "
       "probation eligibility."),
    _k("ED25519_TPU_PROBATION_PROBES", "int", 3,
       "Consecutive clean host-verified probe chunks a probation chip "
       "must pass (batch.run_probation_probe) before it rejoins "
       "production placement."),
    _k("ED25519_TPU_QUARANTINE", "opt-out", True,
       "Set to 0/false/no to make the chip-suspicion ledger "
       "report-only: scores still accumulate and decay, but no chip "
       "is ever quarantined (placement never changes)."),
    _k("ED25519_TPU_CLASS_WATERMARK_MEMPOOL", "float", 0.85,
       "Queue-depth fraction of service capacity at which NEW "
       "mempool-class submissions shed (the VerifyService "
       "high-watermark default; consensus-class never watermark-"
       "sheds)."),
    _k("ED25519_TPU_CLASS_WATERMARK_RPC", "float", 0.50,
       "Queue-depth fraction of service capacity at which NEW "
       "rpc-class submissions shed; must not exceed the mempool "
       "watermark (rpc sheds first under overload)."),
    _k("ED25519_TPU_DEGRADED_CAPACITY", "opt-out", True,
       "Set to 0/false/no to stop VerifyService from shrinking its "
       "admission-watermark base by the live healthy-chip fraction "
       "when the mesh is degraded (chip loss); the hard queue bound "
       "never shrinks either way."),
    _k("ED25519_TPU_DEVCACHE_TENANT_QUOTA", "int", 0,
       "Per-tenant device-operand-cache residency quota in bytes "
       "(cache QoS): >0 partitions the byte budget so one tenant's "
       "keyset churn can never evict another tenant's entries; 0 "
       "keeps the single shared LRU pool."),
    _k("ED25519_TPU_VERDICT_CACHE_ENABLED", "opt-out", True,
       "Set to 0/false/no to disable the content-addressed verdict "
       "cache (verdictcache.py — the mempool→consensus double-verify "
       "memo); every submission then verifies in full."),
    _k("ED25519_TPU_VERDICT_CACHE_BYTES", "int", 1 << 24,
       "Verdict cache residency budget in bytes (stored content "
       "payloads; deterministic LRU eviction above it); 0 also "
       "disables memoization."),
    _k("ED25519_TPU_VERDICT_CACHE_TENANT_QUOTA", "int", 0,
       "Per-tenant verdict-cache residency quota in bytes: >0 "
       "partitions the byte budget so one tenant's replay churn can "
       "never evict another tenant's memoized verdicts; 0 keeps the "
       "single shared LRU pool."),
    _k("ED25519_TPU_PERSIST_DIR", "path", None,
       "Directory for the verdict-store journal/snapshot files "
       "(persist.py — crash-consistent restart warmth); unset/empty "
       "disables persistence and the memo store is process-lifetime "
       "only."),
    _k("ED25519_TPU_PERSIST_FSYNC", "choice", "close",
       "Verdict-journal fsync policy: `always` (fsync every appended "
       "record), `close` (fsync on service drain/flush and snapshot "
       "compaction), or `never` (page cache only); the policy trades "
       "post-crash WARMTH, never correctness — an unsynced record is "
       "simply one the loader never sees.",
       ("always", "close", "never")),
    _k("ED25519_TPU_PERSIST_MAX_BYTES", "int", 1 << 26,
       "Verdict-journal size in bytes above which the next append "
       "triggers an atomic snapshot compaction (live entries "
       "re-exported to a temp file, then rename) — bounds disk growth "
       "from append-only churn."),
    _k("ED25519_TPU_STRAGGLER_RATIO", "float", 3.0,
       "Relative-straggler rule: a chip whose recent p90 dispatch "
       "latency exceeds this ratio times the mesh-wide median (for "
       "ED25519_TPU_STRAGGLER_MIN_SAMPLES consecutive dispatches) "
       "accrues STRAGGLER_SUSPICION; also scales the probation "
       "latency gate.  The comparison runs in scaled integers inside "
       "health.LatencyLedger — this knob is collapsed to per-mille "
       "once at read."),
    _k("ED25519_TPU_STRAGGLER_MIN_SAMPLES", "int", 8,
       "Minimum per-chip latency samples before the straggler rule "
       "evaluates, AND the consecutive over-ratio streak length that "
       "accrues one STRAGGLER_SUSPICION event — alternating gray-flap "
       "windows shorter than this never accrue (no quarantine "
       "oscillation)."),
    _k("ED25519_TPU_HEDGE_QUANTILE", "float", 0.95,
       "Hedge threshold: a dispatched chunk whose elapsed time "
       "crosses this quantile of recent wave durations (latency "
       "ledger, per-mille nearest-rank) becomes a hedge candidate — "
       "its undecided batches re-verify with fresh blinders on the "
       "host; first valid result wins, the loser is discarded "
       "unread.  The port hedges hybrid calls only: the host races a "
       "chunk once it crosses the threshold."),
    _k("ED25519_TPU_HEDGE_MIN_MS", "float", 50.0,
       "Floor (milliseconds) under the ledger-derived hedge "
       "threshold, so cold ledgers and fast devices don't hedge every "
       "wave; 0 force-hedges every outstanding chunk (test/lab "
       "knob)."),
    _k("ED25519_TPU_REPLICA_SUSPICION_THRESHOLD", "float", 3.0,
       "Per-replica decayed suspicion score at which the federation "
       "ReplicaRegistry starts DRAINING a replica (fatal replica "
       "errors eject directly; transient/ambiguous evidence "
       "accumulates here)."),
    _k("ED25519_TPU_REPLICA_SUSPICION_HALF_LIFE", "float", 300.0,
       "Half-life (registry-clock seconds) of per-replica suspicion "
       "scores; decay below half the threshold relaxes an ejected "
       "replica to probation eligibility."),
    _k("ED25519_TPU_REPLICA_PROBES", "int", 2,
       "Consecutive clean host-verified probe batches an ejected "
       "replica must pass (federation.ReplicaSet probe cycle) before "
       "it rejoins the affinity ring."),
    _k("ED25519_TPU_REPLICA_SPILLOVER", "opt-out", True,
       "Set to 0/false/no to disable affinity-preserving spillover: "
       "a degraded/overloaded replica then sheds submissions instead "
       "of handing them to the next replica in rendezvous order "
       "(consensus-class still tries every live replica either way)."),
    _k("ED25519_TPU_REPLICA_DEGRADED_FRAC", "float", 0.5,
       "Effective-capacity fraction at or below which a replica is "
       "treated as DEGRADED by the federation router: lower-class "
       "traffic spills to healthy peers before that replica sheds "
       "users (a replica at the 2-chip rung sheds load, not users)."),
    _k("ED25519_TPU_RACE_AUDIT", "opt-in", False,
       "Race-audit switch, read by analysis/harness.py before it imports "
       "the package (not by the verdict path): set, the harness "
       "instruments the port's locks and the fields of "
       "analysis/guards.toml and runs the lock-order audit and the "
       "Eraser-style write-race sanitizer (analysis/race_audit.py) over "
       "its workload, and a field two or more threads wrote with no "
       "common held lock, or a lock cycle, fails the run; unset, the "
       "same workload runs bare, the baseline of the monitors' cost.  "
       "`consensuslint --race-audit` sets it for its child.  Race "
       "evidence gates the audit, never verdicts."),
    _k("ED25519_TPU_RACE_AUDIT_OUT", "path", None,
       "Where a monitored harness run (RACE_AUDIT set) writes its report "
       "(tracked fields, per-field locksets, flagged races, the lock "
       "graph) as JSON, unless `--out` names another path; "
       "`consensuslint --stats` reads it back for the race_audit_fields "
       "gauge."),
])


def get(name: str):
    """Parsed value of a registered knob (live read).  KeyError for an
    unregistered name, ConfigError for a malformed value."""
    return KNOBS[name].read()


def get_raw(name: str) -> "str | None":
    """The raw (unparsed) environment value of a registered knob, or None
    when unset: for callers that need the unset/empty/value distinction.
    KeyError for an unregistered name."""
    KNOBS[name]  # unregistered names must not silently read the env
    return os.environ.get(name)


@contextlib.contextmanager
def override(**knobs):
    """Scoped environment overrides for registered knobs, restored on
    exit (even on error); a value of None unsets the knob for the
    scope."""
    for name in knobs:
        KNOBS[name]  # unregistered names must not silently write the env
    old = {}
    try:
        for name, value in knobs.items():
            old[name] = os.environ.get(name)
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = str(value)
        yield
    finally:
        for name, prev in old.items():
            if prev is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = prev


def validate_all() -> "dict[str, ConfigError]":
    """Parse every registered knob against the current environment;
    {knob name: ConfigError} for each malformed one (empty: the
    environment is clean).  An entry point can call it at start-up to fail
    fast instead of mid-traffic."""
    errors = {}
    for name, knob in KNOBS.items():
        try:
            knob.read()
        except ConfigError as e:
            errors[name] = e
    return errors


def knob_table() -> "list[tuple[str, str, str, str]]":
    """(name, type, default, doc) rows for every registered knob: the
    data behind README's knob table of the port."""
    rows = []
    for name, knob in KNOBS.items():
        if knob.type == "choice":
            ty = "choice of " + "/".join(knob.choices)
        else:
            ty = knob.type
        default = "unset" if knob.default is None else str(knob.default)
        rows.append((name, ty, default, knob.doc))
    return rows
