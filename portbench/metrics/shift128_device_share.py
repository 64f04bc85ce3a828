"""Host staging's [2^128]A per key, the share the card computed: Σ
`last_run_stats["shift128_device"]` / Σ `["shift128_lookups"]` over the
window's calls, the keys whose split-high lane the cold dispatches sent
for K7 to double, of every key staged.  With `shift128_hit_share` it sums
to 1 where every dispatch is cold.  None where the calls' stats carry no
lookups, or no `shift128_device` counter (a port that computes every
[2^128]A on the host)."""


def read(ctx):
    calls = ctx.record.get("calls")
    if not calls or not any("shift128_device" in c["stats"] for c in calls):
        return None
    lookups = sum(c["stats"].get("shift128_lookups", 0) for c in calls)
    if not lookups:
        return None
    return sum(c["stats"].get("shift128_device", 0) for c in calls) / lookups
