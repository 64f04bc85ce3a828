"""The scheduler (`batch.verify_many` outside staging, the device call and
the combine: union-merge, the host's bisection of a failed union, the wait
for the lane): the harness's span around each `verify_many` call less that
call's `stage_seconds`, `device_seconds` and `combine_seconds`, per
signature."""


def read(ctx):
    calls = ctx.record.get("calls")
    if not calls:
        return None
    rest = sum((c["t1"] - c["tq"]) - sum(
        c["stats"].get(k, 0.0) for k in (
            "stage_seconds", "device_seconds", "combine_seconds"))
        for c in calls)
    return 1e6 * rest / sum(c["sigs"] for c in calls)
