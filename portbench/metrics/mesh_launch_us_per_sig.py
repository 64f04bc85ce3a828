"""The mesh layer's launches (`parallel/sharded_msm.py`, span
`mesh.launch`: each shard's operands copied to its card and K1, K2, K3
launched there, on the host clock): the sum of
`last_run_stats["mesh_launch_seconds"]` over the window's calls, per
signature.  None where no call dispatched on a mesh (`mesh_lanes` empty or
missing: a port without the mesh counters)."""


def read(ctx):
    calls = ctx.record.get("calls")
    if not calls or not any(c["stats"].get("mesh_lanes") for c in calls):
        return None
    return 1e6 * sum(c["stats"].get("mesh_launch_seconds", 0.0)
                     for c in calls) / sum(c["sigs"] for c in calls)
