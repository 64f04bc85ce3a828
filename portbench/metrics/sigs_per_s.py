"""Signatures of every call begun in the window, over the time from the
window's start to the end of the last of those calls (host clock)."""


def read(ctx):
    rec = ctx.record
    if rec["kind"] != "closed" or not rec["calls"]:
        return None
    return sum(c["sigs"] for c in rec["calls"]) / (rec["end"] - rec["start"])
