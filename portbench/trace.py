"""The traced run's device timeline, from `torch.profiler` with CUDA
activity only, and the host spans the harness records around its calls.

`busy_s` is the union of every kernel, copy and set interval on the card
inside the window; the idle share is 1 - busy_s / window_s.  The device's
clock is tied to the host's by a marker: right after the profiler starts,
with the card idle, the harness notes the host time and launches one fill;
that fill's start on the device is the same moment.  No trace file is
written."""

import time

MARKER_NAME = "Fill"


def _device_events(prof):
    """[(name, start_ns, end_ns)] of the device's activities."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns()))
    return out


class DeviceTrace:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t_mark = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize(self.device)
        self.t_mark = time.perf_counter()
        torch.empty(1, device=self.device).fill_(1.0)
        torch.cuda.synchronize(self.device)

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize(self.device)
        self.prof.stop()

    def timeline(self):
        """[(name, host_start_s, host_end_s)] sorted by start, on the
        harness's perf_counter clock; None when the profiler saw no device
        activity."""
        events = sorted(_device_events(self.prof), key=lambda e: e[1])
        if not events:
            return None
        marks = [e for e in events if MARKER_NAME in e[0]]
        offset_ns = (marks[0][1] if marks else events[0][1]) \
            - int(self.t_mark * 1e9)
        return [(n, (s - offset_ns) / 1e9, (e - offset_ns) / 1e9)
                for n, s, e in events]


def summarize(timeline, w0: float, w1: float, spans) -> dict:
    """busy_s, window_s, the ten device operations that took most time,
    and the ten longest idle gaps, each named by the innermost harness span
    open on the host at its middle."""
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in timeline
              if e > w0 and s < w1]
    per_op = {}
    for n, s, e in inside:
        per_op[n] = per_op.get(n, 0.0) + (e - s)
    merged = []
    for _, s, e in sorted(inside, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    gaps, t = [], w0
    for s, e in merged:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))

    def label(mid):
        best = None
        for name, s, e in spans:
            if s <= mid < e and (best is None or s >= best[1]):
                best = (name, s)
        return best[0] if best else "harness"

    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return {
        "busy_s": busy,
        "window_s": w1 - w0,
        "device_ops": sorted(([n, v] for n, v in per_op.items()),
                             key=lambda x: x[1], reverse=True)[:10],
        "idle_gaps": [[label((s + e) / 2), e - s] for s, e in gaps[:10]],
        "kernel_seconds": per_op,
    }
