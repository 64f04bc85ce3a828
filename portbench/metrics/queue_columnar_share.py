"""Queueing's columnar path: of every signature the window's calls
verified, the share `Verifier.queue_bulk` queued in one native call
straight into the queue-order columns (Σ
`last_run_stats["queue_columnar_sigs"]` / Σ sigs).  1.0 wherever the
port's native host library loads; 0 where it fell back to the exact-Python
`queue` loop.  None where no call's stats carry the counter (a port
without it)."""


def read(ctx):
    calls = [c for c in ctx.record.get("calls") or []
             if "queue_columnar_sigs" in c["stats"]]
    sigs = sum(c["sigs"] for c in calls)
    if not sigs:
        return None
    return sum(c["stats"]["queue_columnar_sigs"] for c in calls) / sigs
