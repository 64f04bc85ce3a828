"""The mesh fold on the device: the profiler's time of K5
(`fold_shards_kernel`, csrc/fold_partials.cu) and of the peer copies that
bring the other cards' partial sums to the lead card (`Memcpy PtoP`), over
the window, per signature.  None without a device trace or where neither
ran (a single-device run, or a virtual mesh with no K5)."""

FOLD_KERNEL = "fold_shards_kernel"
PEER_COPY = "PtoP"


def read(ctx):
    t = ctx.trace
    calls = ctx.record.get("calls")
    if t is None or not calls:
        return None
    secs = sum(v for n, v in t["kernel_seconds"].items()
               if n.startswith(FOLD_KERNEL) or PEER_COPY in n)
    if not secs:
        return None
    return 1e6 * secs / sum(c["sigs"] for c in calls)
