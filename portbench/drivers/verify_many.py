"""Closed-loop driver: each call builds the call's batches as fresh
`batch.Verifier`s with `queue_bulk` and hands them to `batch.verify_many`
with the workload's keyword arguments, then starts the next call.

The warm-up makes calls -warm_calls .. -1 and the window calls 0, 1, ...,
so the traffic knows which units the window holds.  The record keeps, per
call, its host-clock times (start, end of queueing, end), its units (batch
indices), the verdict of each unit or the exception that ended the call,
and the call's `batch.last_run_stats`."""

import time


class Driver:
    def __init__(self, workload: dict, traffic, device: str):
        from ed25519_consensus_tpu_torch import batch
        from ed25519_consensus_tpu_torch.signature import Signature

        self._batch = batch
        self._sig = Signature
        self.traffic = traffic
        self.kwargs = dict(workload["entry"]["kwargs"], device=device)
        self.warm_calls = int(workload["entry"].get("warm_calls", 2))
        self.next_call = -self.warm_calls

    def _verifier(self, unit: int):
        entries, _ = self.traffic.batch(unit)
        v = self._batch.Verifier()
        sig = self._sig.from_bytes
        v.queue_bulk([(A, sig(s), m) for A, s, m in entries])
        return v

    def _call(self, spans) -> dict:
        units = self.traffic.call_units(self.next_call)
        self.next_call += 1
        t0 = time.perf_counter()
        verifiers = [self._verifier(u) for u in units]
        tq = time.perf_counter()
        rec = {"t0": t0, "tq": tq, "units": units,
               "sigs": sum(v.batch_size for v in verifiers)}
        try:
            rec["verdicts"] = self._batch.verify_many(verifiers,
                                                      **self.kwargs)
            rec["error"] = None
        except Exception as exc:  # a failed call is recorded, not fatal
            rec["verdicts"] = None
            rec["error"] = f"{type(exc).__name__}: {exc}"
        rec["t1"] = time.perf_counter()
        rec["stats"] = dict(self._batch.last_run_stats)
        if spans is not None:
            spans.append(("queue", t0, tq))
            spans.append(("verify_many", tq, rec["t1"]))
        return rec

    def warm(self) -> None:
        """The cell's own calls, untimed, until every shape the window
        dispatches has run (and, for a recurring keyset, its residency is
        built)."""
        while self.next_call < 0:
            rec = self._call(None)
            if rec["error"]:
                raise RuntimeError(f"warm-up call failed: {rec['error']}")

    def window(self, seconds: float, spans) -> dict:
        calls = []
        self.next_call = 0
        start = time.perf_counter()
        end = start + seconds
        while time.perf_counter() < end:
            calls.append(self._call(spans))
        return {"kind": "closed", "start": start, "seconds": seconds,
                "end": calls[-1]["t1"] if calls else start,
                "calls": calls}

    def outcomes(self, record) -> "list[tuple[int, object]]":
        """(unit, verdict or error string) for every unit of the window."""
        out = []
        for c in record["calls"]:
            for i, u in enumerate(c["units"]):
                out.append((u, c["error"] if c["verdicts"] is None
                            else c["verdicts"][i]))
        return out

    def summary(self, record) -> dict:
        """The window's calls, and those that rejected a unit (the host
        decided it again, bisecting a failed union): their count and
        seconds beside the median seconds of the others."""
        calls = record["calls"]
        secs = [c["t1"] - c["t0"] for c in calls]
        rej = [s for c, s in zip(calls, secs)
               if c["verdicts"] is not None and False in c["verdicts"]]
        rest = sorted(s for s in secs if s not in rej)
        return {"calls": len(calls), "calls_rejecting": len(rej),
                "rejecting_call_s": rej,
                "other_call_s_median": rest[len(rest) // 2] if rest
                else None}

    def close(self) -> None:
        pass
