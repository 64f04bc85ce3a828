"""Mesh-chaos lab: seeded chip-loss storms against the degraded mesh — the
port of the JAX package's tools/mesh_chaos.py.

The property under test: losing k of N chips costs about k/N throughput,
never correctness and never a lost request.  Two phases, both pure
functions of the seed:

**Phase A — reformation storm (real dispatches).**  Forced-device
recurring-keyset waves on the full mesh of logical chips while ChipLoss
faults (`faults.mesh_plan(kind="chip-loss")`) land at the sharded seam
MID-WAVE: kill 1 chip, then 2 more, then every chip but one (the
cumulative 1 → 3 → 7-of-8 storm), each loss with a heal window.  The
scheduler must walk the ladder — mesh(8) → mesh(4) → mesh(2) → the single
lane — re-issuing the wave's chunks on each reformed rung, with every
verdict equal to the host oracle's at every rung.  After the heal window
the registry prunes and a last wave runs the FULL mesh again (rejoin); the
port forces that wave onto the device too, where the JAX lab lets the host
race it.

**Phase B — degraded SLO (open loop, through the traffic lab).**  The
traffic-lab scenario at 80% of capacity AT EACH DEGRADED RUNG: chips are
marked dead, the virtual service rate scales by the surviving fraction (the
k/N model; a calibrated rate's schedules are drawn as the traffic lab draws
them, independent of the measured rate), and the service runs with
mesh=None so its degraded-capacity
watermark shrink engages where two or more cards are visible.  Gates per
rung: zero lost, host-identical verdicts, consensus shed rate zero and
consensus p99 under its deadline at that rung's capacity.  Heal-all must
then reform routing back to the full width.

**The port's departure.**  A mesh failure with no rung left raises
`DeviceError` in the port (the host never decides what the device failed
to); the storm never gets there, since one chip always survives.

Usage:
  python -m ed25519_consensus_tpu_torch.tools.mesh_chaos [--seed N]
      [--devices 8] [--requests 300] [--load 0.8]
      [--service-rate SIGS_PER_S] [--heal-s 600] [--device cpu]
      [--skip-storm] [--json]

The chips are logical (`verify_many(device_ids=)`): every shard runs on
`--device`, the card by default, "cpu" for the kernels' plain versions.
Exit status is nonzero unless every gate holds.
"""

import argparse
import json
import os
import random
import sys

from .. import SigningKey, batch, devcache, faults, health, routing, tenancy
from ..ops import msm
from ..parallel.sharded_msm import shard_pad
from . import traffic_lab

# The JAX knob ED25519_TPU_MESH_CHAOS_SEED's default (the port keeps lab
# seeds out of its knob registry).
DEFAULT_SEED = 0xC41905

_stable_seed = tenancy._stable_seed


def make_wave(seed, keys, tag, n_batches=2, bad_rate=0.25):
    """A keyset-uniform wave of verifiers and its host-oracle truth: each
    batch tampered (one signature) with probability bad_rate, so the storm
    carries real False verdicts through every rung."""
    vs, want = [], []
    for b in range(n_batches):
        rnd = random.Random(_stable_seed(seed, "wave", tag, b))
        bad = rnd.random() < bad_rate
        v = batch.Verifier()
        for j, sk in enumerate(keys):
            msg = b"mesh-chaos %s %d %d" % (tag.encode(), b, j)
            sig = sk.sign(msg if not (bad and j == 0) else b"tampered")
            v.queue((sk.verification_key_bytes(), sig, msg))
        vs.append(v)
        want.append(not bad)
    return vs, want


def _participated(stats) -> int:
    return (stats.get("device_batches", 0)
            + stats.get("device_rejects_confirmed", 0)
            + stats.get("device_rejects_overturned", 0))


def run_reformation_storm(seed, devices=8, heal_s=600.0,
                          device="cuda") -> dict:
    """Phase A: the cumulative 1 → 3 → (devices−1) chip-loss storm under
    forced-device dispatches on logical chips 0 .. devices−1 of `device`,
    then heal and rejoin.  Everything runs on one FakeClock (deadlines
    never self-elapse), every rung's chunk shape is pre-marked completed,
    and each stage's fault is one seeded mid-wave event."""
    batch.reset_device_health()
    clock = health.FakeClock()
    hp = health.DeviceHealth(mesh=devices, clock=clock)
    health.chip_registry().set_clock(clock)
    # Cold dispatches only: every rung's operand path stays the same.
    devcache.set_default_cache(devcache.DeviceOperandCache(enabled=False))
    rnd = random.Random(_stable_seed(seed, "keys"))
    keys = [SigningKey.new(rnd) for _ in range(4)]
    rng = random.Random(_stable_seed(seed, "rng"))
    ids = tuple(range(devices))

    probe_v, _ = make_wave(seed, keys, "shape-probe", n_batches=1,
                           bad_rate=0.0)
    n_terms = probe_v[0]._stage(None).n_device_terms
    m = devices
    while m >= 2:
        msm.mark_shape_completed(2, shard_pad(n_terms, m), m)
        m //= 2
    msm.mark_shape_completed(2, msm.pad_lanes(n_terms), 0)

    # Highest-numbered chips die first, so every reformed rung is the
    # canonical prefix mesh; each stage is ONE mid-wave event.
    stages = [
        ("kill-1", [devices - 1], devices // 2),
        ("kill-3", [devices - 2, devices - 3], devices // 4),
        ("kill-%d" % (devices - 1), list(range(1, devices - 3)), 0),
    ]
    results = {"stages": [], "ok": True}
    try:
        for tag, chips, want_mesh in stages:
            plan = faults.mesh_plan(seed, "chip-loss", chips=chips, at=0,
                                    heal_after=heal_s)
            vs, want = make_wave(seed, keys, tag)
            with faults.injected(plan):
                got = batch.verify_many(
                    vs, rng=rng, chunk=2, hybrid=False, merge="never",
                    mesh=devices, health=hp, device=device,
                    device_ids=ids)
            stats = dict(batch.last_run_stats)
            refs = stats.get("mesh_reformations", [])
            stage = {
                "stage": tag,
                "dead": sorted(health.chip_registry().dead_chips()),
                "mesh_after": stats.get("mesh"),
                "device_ids": stats.get("device_ids"),
                "reformations": refs,
                "host_identical": got == want,
                "zero_lost": len(got) == len(want),
                "device_participated": _participated(stats),
                "reissued": sum(r.get("reissued", 0) for r in refs),
                "ok": (got == want and len(got) == len(want)
                       and stats.get("mesh") == want_mesh
                       and len(refs) >= 1
                       and _participated(stats) >= 1),
            }
            results["stages"].append(stage)
            results["ok"] = results["ok"] and stage["ok"]

        # The heal window: the registry prunes on read, routing reforms
        # back to the full width, and the rejoin wave runs it.
        clock.advance(heal_s + 1.0)
        rejoined = routing.reform_for(devices) == (devices, None)
        vs, want = make_wave(seed, keys, "rejoin")
        got = batch.verify_many(
            vs, rng=rng, chunk=2, hybrid=False, merge="never",
            mesh=devices, health=hp, device=device, device_ids=ids)
        stats = dict(batch.last_run_stats)
        results["rejoin"] = {
            "registry_full_width": rejoined,
            "mesh": stats.get("mesh"),
            "reformations": stats.get("mesh_reformations", []),
            "host_identical": got == want,
            "device_participated": _participated(stats),
            "ok": (rejoined and got == want
                   and stats.get("mesh") == devices
                   and not stats.get("mesh_reformations")
                   and _participated(stats) >= 1),
        }
        results["ok"] = results["ok"] and results["rejoin"]["ok"]
    finally:
        devcache.set_default_cache(None)
        batch.reset_device_health()  # also resets the chip registry
    return results


def run_degraded_slo(cfg) -> dict:
    """Phase B: the traffic-lab scenario at `cfg.load` of capacity at each
    degraded rung (full / half / one chip), chips marked dead, then
    heal-all and a routing rejoin check."""
    devices = cfg.devices
    # A calibrated rate draws every rung's schedule at the lab's fixed
    # draw rate (traffic_lab.service_rate): the rungs' outcomes are a
    # pure function of the seed, whatever the host measures.
    rate, draw_rate = traffic_lab.service_rate(cfg)
    rungs = [("full", 0), ("half", devices // 2),
             ("one-chip", devices - 1)]
    out = {"rungs": [], "ok": True, "service_rate_sigs_per_s": rate}
    reg = health.chip_registry()
    try:
        for tag, n_dead in rungs:
            reg.heal_all()
            for c in range(devices - n_dead, devices):
                reg.mark_chip_dead(c, reason="mesh-chaos slo rung")
            frac = (devices - n_dead) / devices
            lab_cfg = argparse.Namespace(
                seed=_stable_seed(cfg.seed, "slo", tag),
                requests=cfg.requests, load=cfg.load,
                # The k/N model: the degraded mesh drains at the surviving
                # fraction of the rate, and the offered load tracks it.
                service_rate=rate * frac, draw_rate=draw_rate,
                capacity_frac=0.05, wave_max_batches=16,
                wave_overhead=0.02, device=False,
                rotate_every_frac=0.0, rotation_faults=False,
                require_rpc_shed=True, json=False, mesh=None)
            summary = traffic_lab.run_lab(lab_cfg)
            rung = {
                "rung": tag, "dead_chips": n_dead,
                "effective_capacity_sigs":
                    summary["effective_capacity_sigs"],
                "capacity_sigs": summary["capacity_sigs"],
                "gates": summary["gates"],
                "consensus_p99_s":
                    summary["by_class"]["consensus"]["latency_s"]["p99"],
                "shed_rate_by_class": {
                    c: summary["by_class"][c]["shed_rate"]
                    for c in tenancy.CLASSES},
                "replay_digest": summary["replay_digest"],
                "ok": summary["ok"],
            }
            # The shrink itself is a gate where a mesh can exist: a
            # degraded rung reports a proportionally smaller base.
            if n_dead and routing.available_devices() >= 2:
                rung["ok"] = rung["ok"] and (
                    rung["effective_capacity_sigs"]
                    < rung["capacity_sigs"])
            out["rungs"].append(rung)
            out["ok"] = out["ok"] and rung["ok"]
        reg.heal_all()
        out["rejoin_full_width"] = (
            routing.available_devices() < 2
            or routing.reform_for(devices)[0] == devices)
        out["ok"] = out["ok"] and out["rejoin_full_width"]
    finally:
        reg.heal_all()
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=lambda s: int(s, 0), default=DEFAULT_SEED)
    ap.add_argument("--devices", type=int, default=8,
                    help="logical chips of the storm's mesh (and the "
                         "chip world of the SLO rungs)")
    ap.add_argument("--requests", type=int, default=300,
                    help="open-loop requests per SLO rung (phase B)")
    ap.add_argument("--load", type=float, default=0.8)
    ap.add_argument("--service-rate", type=float, default=0.0,
                    help="pin the virtual cost model (sigs/s) instead "
                         "of calibrating")
    ap.add_argument("--heal-s", type=float, default=600.0,
                    help="chip heal window (virtual seconds) before "
                         "the mesh rejoins full width")
    ap.add_argument("--device", default="cuda",
                    help="torch device every shard of the storm runs on "
                         "(default: the card; cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--skip-storm", action="store_true",
                    help="phase B only (no mesh dispatches)")
    ap.add_argument("--json", action="store_true")
    return ap.parse_args(argv)


def chaos(cfg) -> dict:
    """Both phases → the summary ({"ok", "reformation_storm",
    "degraded_slo", ...})."""
    summary = {"seed": cfg.seed, "devices": cfg.devices,
               "device": cfg.device, "ok": True}
    if not cfg.skip_storm:
        summary["reformation_storm"] = run_reformation_storm(
            cfg.seed, devices=cfg.devices, heal_s=cfg.heal_s,
            device=cfg.device)
        summary["ok"] = summary["ok"] and \
            summary["reformation_storm"]["ok"]
    summary["degraded_slo"] = run_degraded_slo(cfg)
    summary["ok"] = summary["ok"] and summary["degraded_slo"]["ok"]
    return summary


def headline(summary) -> dict:
    """The bench-harvest line: the deepest degraded rung's consensus
    p99."""
    rungs = summary["degraded_slo"]["rungs"]
    deepest = rungs[-1] if rungs else {}
    storm = summary.get("reformation_storm")
    return {
        "metric": "mesh_chaos",
        "value": (round(deepest["consensus_p99_s"] * 1e3, 3)
                  if deepest.get("consensus_p99_s") is not None
                  else None),
        "unit": "ms_p99_consensus_verdict_latency_deepest_rung",
        "devices": summary["devices"],
        "storm_ok": storm["ok"] if storm is not None else None,
        "storm_rungs": ([s["mesh_after"] for s in storm["stages"]]
                        if storm is not None else None),
        "slo_ok": summary["degraded_slo"]["ok"],
        "shed_rate_by_class_deepest":
            deepest.get("shed_rate_by_class"),
        "ok": summary["ok"],
    }


def main(argv=None):
    cfg = parse_args(argv)
    summary = chaos(cfg)
    if cfg.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    print(json.dumps(headline(summary)))
    print("MESH_CHAOS", json.dumps(
        {k: v for k, v in summary.items() if k != "degraded_slo"}))
    if not summary["ok"]:
        print(f"VIOLATION: mesh_chaos gates failed "
              f"(replay with --seed {cfg.seed:#x})", file=sys.stderr)
    sys.stdout.flush()  # os._exit skips buffer flushing
    # Never let interpreter teardown run with a lane worker parked.
    batch._DeviceLane.reset_all(timeout=30.0)
    os._exit(0 if summary["ok"] else 1)


if __name__ == "__main__":
    main()
