"""The device call (`_DeviceLane`, `ops/msm.dispatch_window_sums_many*`:
launches, copies and the lane's queue, on the host clock): the sum of
`last_run_stats["device_seconds"]` over the window's calls, per signature."""


def read(ctx):
    calls = ctx.record.get("calls")
    if not calls:
        return None
    return 1e6 * sum(c["stats"].get("device_seconds", 0.0)
                     for c in calls) / sum(c["sigs"] for c in calls)
