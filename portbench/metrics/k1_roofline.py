"""K1 (`csrc/expand_compressed.cu`): its roofline share over the window,
the least time its work needs (roofline.bound_s of the bytes and
operations roofline.K1Reckoner works out for each dispatch from the
harness's own inputs) over K1's device time in the profiler's trace.

A dispatch is reckoned as the port stages it: a call's units are
union-merged as `batch.verify_many` merges them (`merge="auto"` merges
when the mean batch is at most 2,048 signatures, greedily into unions of
8,192 or more), then dispatched `chunk` at a time, all cold or all from a
resident keyset.  A call of any other shape reads nothing."""

from portbench import roofline

MERGE_TARGET_SIGS = 8192
MERGE_MAX_BATCH = 2048
K1_KERNEL = "expand_compressed_kernel"


def _groups(batches, merge: str) -> list:
    sizes = [len(b) for b in batches]
    if not (merge == "always" or (
            merge == "auto" and len(batches) >= 2
            and sum(sizes) <= MERGE_MAX_BATCH * len(batches))):
        return batches
    groups, cur = [], []
    for b in batches:
        cur += b
        if len(cur) >= MERGE_TARGET_SIGS:
            groups.append(cur)
            cur = []
    if cur:
        groups.append(cur)
    return groups


def dispatch_work(ctx) -> "list | None":
    """K1's (bytes, operations, multiply-adds) for every dispatch of the
    window, in order; None for a window the reckoning does not cover."""
    kw = ctx.workload["entry"]["kwargs"]
    chunk = int(kw.get("chunk", 8))
    merge = kw.get("merge", "auto")
    rk = roofline.K1Reckoner(ctx.traffic, int(ctx.workload["compare"].get(
        "workers", 1)))
    plan = []
    for c in ctx.record.get("calls") or []:
        if c["error"]:
            return None
        groups = _groups([ctx.traffic.batch(u)[0] for u in c["units"]],
                         merge)
        n_disp = -(-len(groups) // chunk)
        hits = c["stats"]["devcache"]["dispatch_hits"]
        if hits not in (0, n_disp):
            return None
        plan += [(groups[i:i + chunk], hits > 0)
                 for i in range(0, len(groups), chunk)]
    rk.prime([e for batches, resident in plan for b in batches
              for e in rk.encodings(b, resident)])
    return [rk.dispatch(batches, chunk, resident)
            for batches, resident in plan] or None


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    k1_s = sum(v for n, v in t["kernel_seconds"].items()
               if n.startswith(K1_KERNEL))
    work = dispatch_work(ctx) if k1_s else None
    if not work:
        return None
    return 100.0 * sum(roofline.bound_s(w) for w in work) / k1_s
