"""Lightweight observability for the batch pipeline: process-cumulative
fault/recovery counters fed by the verify_many degradation ladder, a gauge
registry for levels (the device operand cache publishes its hit/miss/
residency levels here), nearest-rank `percentiles` for the labs' latency
rows, `timed` stage seconds for `Verifier.verify(timings=...)`, and an
in-memory span recorder over the verify path, off unless a caller turns it
on (`enable_spans`, `disable_spans`, `drain_spans`)."""

import collections
import functools
import itertools
import math
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
# (batch.run_probation_probe), and the replica ladder's "replica_*" and
# "federation_*" events (federation.py: ejections, drains, revivals,
# rejoins, prewarm, spillovers, re-issues, the host floor, dedup fan-out
# and device-error waves).  Injected and real device faults land in
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


def percentiles(values, fractions=(0.5, 0.99, 0.999)) -> dict:
    """Nearest-rank percentiles (the ceil(f·n)-th order statistic) over a
    finite sample: every value reported was observed, and two runs over
    one sample agree bit for bit.  {fraction: value}, None for an empty
    sample."""
    if not values:
        return {f: None for f in fractions}
    s = sorted(values)
    return {
        f: s[min(len(s) - 1, max(0, math.ceil(f * len(s)) - 1))]
        for f in fractions
    }


@contextmanager
def timed(seconds: dict, name: str):
    """Add the wall seconds of the block to `seconds[name]`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0


# -- spans -----------------------------------------------------------------
# While on, every `with span(name):` appends one record
#
#     (name, start, end, span_id, parent_id, call_id, thread)
#
# to a bounded in-memory buffer when the block ends.  Times are
# time.perf_counter() seconds, the clock a caller can tie a device
# timeline to.  The parent is the innermost span open on the same thread
# (a per-thread stack), or, for work handed to another thread, the root
# of the `origin` span's call.  A span opened with `call=True` outside
# any call starts one: it takes the next call id and becomes the root
# that every span beneath it, and every span given it as origin, carries.
# `thread` is threading.get_ident().  When off, `span` returns one shared
# no-op and nothing else runs.  Nothing is written anywhere: the caller
# drains the buffer.

SPAN_BUFFER_MAX = 1 << 16

_spans_on = False
_span_buffer = collections.deque(maxlen=SPAN_BUFFER_MAX)
_span_ids = itertools.count(1)
_call_ids = itertools.count(1)
_span_local = threading.local()


def _span_stack() -> list:
    stack = getattr(_span_local, "stack", None)
    if stack is None:
        stack = _span_local.stack = []
    return stack


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "span_id", "parent_id", "call_id", "root_id",
                 "start", "_call", "_origin")

    def __init__(self, name: str, call: bool, origin):
        self.name = name
        self._call = call
        self._origin = origin

    def __enter__(self):
        stack = _span_stack()
        origin = self._origin
        if origin is not None:
            parent_id, call_id, root_id = (origin.root_id, origin.call_id,
                                           origin.root_id)
        elif stack:
            top = stack[-1]
            parent_id, call_id, root_id = (top.span_id, top.call_id,
                                           top.root_id)
        else:
            parent_id = call_id = root_id = None
        self.span_id = next(_span_ids)
        if self._call and call_id is None:
            call_id, root_id = next(_call_ids), self.span_id
        self.parent_id, self.call_id, self.root_id = (parent_id, call_id,
                                                      root_id)
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        _span_stack().pop()  # `with` blocks nest: this span is the top
        _span_buffer.append((self.name, self.start, end, self.span_id,
                             self.parent_id, self.call_id,
                             threading.get_ident()))
        return False


def span(name: str, call: bool = False, origin=None):
    """A context manager recording one span named `name` (see above);
    the shared no-op while the recorder is off.  `origin` is a span of
    another thread (`current_span()` there) whose call this one serves."""
    if not _spans_on:
        return _NO_SPAN
    return _Span(name, call, origin)


def spanned(name: str, call: bool = False):
    """Decorate a function so that each call of it runs inside
    `span(name, call)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _spans_on:
                return fn(*args, **kwargs)
            with _Span(name, call, None):
                return fn(*args, **kwargs)
        return inner
    return wrap


def current_span():
    """The innermost span open on this thread, to hand to work another
    thread does for it; None while the recorder is off or none is open."""
    if not _spans_on:
        return None
    stack = _span_stack()
    return stack[-1] if stack else None


def enable_spans() -> None:
    """Start recording (the buffer keeps the newest SPAN_BUFFER_MAX
    spans)."""
    global _spans_on
    _spans_on = True


def disable_spans() -> None:
    """Stop recording; what the buffer holds stays to be drained."""
    global _spans_on
    _spans_on = False


def drain_spans() -> list:
    """Remove and return every recorded span, oldest first."""
    out = []
    while True:
        try:
            out.append(_span_buffer.popleft())
        except IndexError:
            return out
