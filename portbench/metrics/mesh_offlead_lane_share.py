"""The mesh's placement: of every lane the window's mesh dispatches
carried (`last_run_stats["mesh_lanes"]`, {chip id: lanes}), the share on
chips other than the placement's first (`device_ids[0]`).  About 0.75 on
four cards; 0 for a virtual mesh on one card, whose shards all name that
card.  None where no call dispatched on a mesh (a port without the
counter)."""


def read(ctx):
    total = off = 0
    for c in ctx.record.get("calls") or []:
        lanes = c["stats"].get("mesh_lanes")
        ids = c["stats"].get("device_ids")
        if not lanes or not ids:
            continue
        total += sum(lanes.values())
        off += sum(n for chip, n in lanes.items() if chip != ids[0])
    return off / total if total else None
