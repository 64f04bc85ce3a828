"""Host staging's [2^128]A per key (`batch._shift128_for_key`): the share of
staging's lookups that `batch._shift128_cache` served, Σ
`last_run_stats["shift128_hits"]` / Σ `["shift128_lookups"]` over the
window's calls.  None where the calls' stats carry no lookups (a port
without these counters)."""


def read(ctx):
    calls = ctx.record.get("calls")
    if not calls:
        return None
    lookups = sum(c["stats"].get("shift128_lookups", 0) for c in calls)
    if not lookups:
        return None
    return sum(c["stats"].get("shift128_hits", 0) for c in calls) / lookups
