"""Residency (`devcache.DeviceOperandCache`): device dispatches served from
resident multiples tables (`last_run_stats["devcache"]
["table_dispatch_hits"]`) over all device dispatches.  A call dispatches
its units (its batches, or the unions it merged them into) `chunk` at a
time, every one of them on the device in a `hybrid=False` call."""


def read(ctx):
    calls = ctx.record.get("calls")
    if not calls:
        return None
    chunk = int(ctx.workload["entry"]["kwargs"].get("chunk", 8))
    hits = dispatches = 0
    for c in calls:
        st = c["stats"]
        units = st.get("merged_unions", st.get("batches", 0))
        dispatches += -(-units // chunk)
        hits += st.get("devcache", {}).get("table_dispatch_hits", 0)
    return hits / dispatches if dispatches else None
