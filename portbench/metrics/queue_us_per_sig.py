"""Queueing (`Verifier.queue_bulk`, with each signature's parse): the
harness's span around building a call's verifiers, per signature."""


def read(ctx):
    calls = ctx.record.get("calls")
    if not calls:
        return None
    return 1e6 * sum(c["tq"] - c["t0"] for c in calls) / sum(
        c["sigs"] for c in calls)
