"""Host staging (`Verifier._stage`, `StagedBatch.device_operands*`): the sum of
`last_run_stats["stage_seconds"]` over the window's calls, per signature."""


def read(ctx):
    calls = ctx.record.get("calls")
    if not calls:
        return None
    return 1e6 * sum(c["stats"].get("stage_seconds", 0.0)
                     for c in calls) / sum(c["sigs"] for c in calls)
