"""Lightweight observability for the batch pipeline: process-cumulative
fault/recovery counters fed by the verify_many degradation ladder, a gauge
registry for levels (the device operand cache publishes its hit/miss/
residency levels here), and per-verify `BatchMetrics`."""

import threading
import time
from contextlib import contextmanager

# -- fault/recovery counters ----------------------------------------------
# Process-cumulative tallies of every degradation-ladder transition
# ("device_error", "deadline_miss", "device_reject_confirmed",
# "device_reject_overturned", "probe_backoff_armed", the devcache
# events...) and of the gray-failure defence: "hedge_fired",
# "hedge_won", "hedge_lost", "hedge_device_error" (the scheduler's hedged
# re-dispatch), "straggler_suspicion" (straggler streaks the latency
# ledger attributed), "probation_probe_passed", "probation_probe_failed",
# "probation_probe_latency_failed" and "chip_rejoined"
# (batch.run_probation_probe).  Injected and real device faults land in
# the same counters.  Per-call counts live in batch.last_run_stats.

_fault_lock = threading.Lock()
_fault_counters: dict = {}


def record_fault(kind: str, n: int = 1) -> None:
    with _fault_lock:
        _fault_counters[kind] = _fault_counters.get(kind, 0) + n


def fault_counters() -> dict:
    """Snapshot of the process-cumulative fault/recovery counters."""
    with _fault_lock:
        return dict(_fault_counters)


# -- gauges ----------------------------------------------------------------
# Levels published as a family: the devcache's, the service's hedge and
# straggler totals with the latency ledger's "latency_mesh_median_us" and
# "latency_wave_p95_us" (VerifyService after every device wave), and
# "routing_measured_wave_overhead_us" (the routing read, report only).

_gauge_lock = threading.Lock()
_gauges: dict = {}


def set_gauges(values: dict) -> None:
    """Publish a family of related gauges in one lock trip."""
    with _gauge_lock:
        _gauges.update(values)


def gauges() -> dict:
    """Snapshot of the process-wide gauge registry."""
    with _gauge_lock:
        return dict(_gauges)


class BatchMetrics:
    """Per-verify() metrics: batch size, coalescing ratio, per-stage wall
    times."""

    def __init__(self):
        self.batch_size = 0
        self.distinct_keys = 0
        self.msm_terms = 0
        self.backend = None
        self.stage_seconds = {}
        self.total_seconds = 0.0

    @property
    def coalescing_ratio(self) -> float:
        """m/n — 1.0 means no coalescing benefit, →0 means maximal."""
        if not self.batch_size:
            return 1.0
        return self.distinct_keys / self.batch_size

    @property
    def sigs_per_sec(self) -> float:
        if not self.total_seconds:
            return 0.0
        return self.batch_size / self.total_seconds

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stage_seconds[name] = (
                self.stage_seconds.get(name, 0.0) + time.perf_counter() - t0
            )

    def as_dict(self) -> dict:
        return {
            "batch_size": self.batch_size,
            "distinct_keys": self.distinct_keys,
            "msm_terms": self.msm_terms,
            "backend": self.backend,
            "coalescing_ratio": round(self.coalescing_ratio, 4),
            "sigs_per_sec": round(self.sigs_per_sec, 1),
            "stage_seconds": {
                k: round(v, 6) for k, v in self.stage_seconds.items()
            },
            "total_seconds": round(self.total_seconds, 6),
        }

    def __repr__(self):
        return f"BatchMetrics({self.as_dict()})"
