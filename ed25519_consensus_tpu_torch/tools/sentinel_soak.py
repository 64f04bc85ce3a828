"""Sentinel soak: the self-diagnosing mesh's gate — the port of the JAX
package's tools/sentinel_soak.py.

The reformation ladder survives chips that are REPORTED dead; this soak
proves the detection layer that produces such reports from evidence.  The
failure under test is a chip that silently corrupts its partial Edwards
sum — every wave it touches fails on the device, or, worse, a crafted
corruption turns a should-reject wave into a device ACCEPT, which host
confirmation of rejects never sees — while the mesh looks healthy.  Two
phases, both pure functions of the seed, on a FakeClock:

**Phase A — persistent corruptor.**  One chip of the 8-mesh corrupts its
partial on every sharded call (`faults.CorruptChipSum`), the sentinel audit
armed at rate 1.0.  Gates: the divergence is attributed to exactly that
chip, which is QUARANTINED within K waves (K = the suspicion threshold over
the per-divergence weight); after quarantine 7 of 8 chips are available,
the dispatch runs the widest surviving rung (4) and decides on the device
with no divergence; a service's effective capacity shrinks with the
quarantine; and the crafted reject→accept flip on the reformed mesh is
caught by the audit.

**Phase B — transient corruptor.**  A chip corrupts until it is
quarantined, then stops.  Its suspicion decays on the clock, the read side
relaxes quarantine to PROBATION, `batch.run_probation_probe` passes on it
ED25519_TPU_PROBATION_PROBES times, the chip REJOINS, routing reforms back
to the full 8-mesh, and a last full-width wave verifies host-identically
with no reformation.

**The port's departure.**  Where the JAX package re-decides a distrusted
chunk on the host, the port's `verify_many` raises `DeviceError` naming
the chip (the host never decides what the device failed to).  So a storm
wave passes when it raised naming the corrupting chip, or when its
verdicts equal the host oracle's; the soak counts the raised waves and
never re-decides them.  A flip caught by the audit is a raised wave whose
divergence names the flipping chip.

Usage:
  python -m ed25519_consensus_tpu_torch.tools.sentinel_soak [--seed N]
      [--devices 8] [--chip 5] [--transient-chip 3] [--device cpu]
      [--json]

The chips are logical (`verify_many(device_ids=)`): every shard of the
mesh runs on `--device` — one card by default, "cpu" for the kernels'
plain versions.  Exit status is nonzero unless every gate holds."""

import argparse
import json
import os
import random
import sys

from .. import (SigningKey, batch, config, devcache, faults, health,
                routing, service)
from ..error import DeviceError
from ..ops import msm
from ..parallel.sharded_msm import shard_pad

# The JAX knob ED25519_TPU_SENTINEL_SOAK_SEED's default (the port keeps lab
# seeds out of its knob registry).
DEFAULT_SEED = 0x5E47

_stable_seed = faults._stable_seed


def make_wave(seed, keys, tag, n_batches=2, bad_rate=0.25):
    """A keyset-uniform wave of verifiers and its host-oracle truth:
    seeded tampering keeps real False verdicts in the machinery."""
    vs, want = [], []
    for b in range(n_batches):
        rnd = random.Random(_stable_seed(seed, "wave", tag, b))
        bad = rnd.random() < bad_rate
        v = batch.Verifier()
        for j, sk in enumerate(keys):
            msg = b"sentinel-soak %s %d %d" % (tag.encode(), b, j)
            sig = sk.sign(msg if not (bad and j == 0) else b"tampered")
            v.queue((sk.verification_key_bytes(), sig, msg))
        vs.append(v)
        want.append(not bad)
    return vs, want


def premark_shapes(seed, keys, devices):
    """Mark every rung's chunk shape (plain and audited) completed, so the
    soak exercises detection, not the first-call grace."""
    probe, _ = make_wave(seed, keys, "shape-probe", n_batches=1,
                         bad_rate=0.0)
    n_terms = probe[0]._stage(None).n_device_terms
    m = devices
    while m >= 2:
        pad = shard_pad(n_terms, m)
        msm.mark_shape_completed(2, pad, m)
        msm.mark_shape_completed(2, pad, m, cached=3)
        m //= 2
    msm.mark_shape_completed(2, msm.pad_lanes(n_terms), 0)


def waves_to_quarantine() -> int:
    """The detection bound: ceil(threshold / sentinel weight) audited
    chunks cross the threshold, and a 2-batch wave at chunk 2 is one
    audited chunk (an integer-scaled ceiling)."""
    threshold = config.get("ED25519_TPU_SUSPICION_THRESHOLD")
    return max(1, -(-int(threshold * 1000)
                    // int(health.SENTINEL_SUSPICION * 1000)))


def run_wave(seed, keys, tag, hp, rng, mesh, device, bad_rate=0.25):
    """One forced-device audited wave on logical chips 0 .. mesh − 1 →
    (passed, raised, stats): passed is host-identical verdicts, or a
    DeviceError raised by a sentinel divergence."""
    vs, want = make_wave(seed, keys, tag, bad_rate=bad_rate)
    try:
        got = batch.verify_many(vs, rng=rng, chunk=2, hybrid=False,
                                merge="never", mesh=mesh, health=hp,
                                sentinel_rate=1.0, device=device,
                                device_ids=tuple(range(mesh)))
    except DeviceError:
        st = dict(batch.last_run_stats)
        return st["sentinel"]["divergence"] > 0, True, st
    return got == want, False, dict(batch.last_run_stats)


def _setup(seed, devices, rng_tag):
    batch.reset_device_health()  # a fresh chip ledger and latency ledger
    clock = health.FakeClock()
    hp = health.DeviceHealth(mesh=devices, clock=clock)
    health.chip_registry().set_clock(clock)
    # Cold dispatches only: the audit samples the cold sharded wire.
    devcache.set_default_cache(devcache.DeviceOperandCache(enabled=False))
    rnd = random.Random(_stable_seed(seed, "keys"))
    keys = [SigningKey.new(rnd) for _ in range(4)]
    premark_shapes(seed, keys, devices)
    return clock, hp, keys, random.Random(_stable_seed(seed, rng_tag))


def run_persistent_corruptor(seed, devices=8, chip=5, device="cuda") -> dict:
    """Phase A (see the module docstring)."""
    clock, hp, keys, rng = _setup(seed, devices, "rng")
    reg = health.chip_registry()
    k_waves = waves_to_quarantine()
    results = {"ok": True, "chip": chip, "k_wave_bound": k_waves,
               "waves": []}
    try:
        plan = faults.sentinel_plan(seed, "corrupt-chip", chip=chip,
                                    on=lambda i: True)
        detected_at = None
        with faults.injected(plan):
            for w in range(k_waves):
                passed, raised, st = run_wave(seed, keys, "storm-%d" % w,
                                              hp, rng, devices, device)
                results["waves"].append({
                    "wave": w, "passed": passed, "raised": raised,
                    "sentinel": st["sentinel"], "mesh": st.get("mesh")})
                results["ok"] = results["ok"] and passed
                if reg.chip_state(chip) == health.STATE_QUARANTINED:
                    detected_at = w
                    break
        attributions = [c for wv in results["waves"]
                        for c in wv["sentinel"]["attributed"]]
        results.update({
            "detected_at_wave": detected_at,
            "quarantined_within_bound": detected_at is not None,
            "raised_waves": sum(wv["raised"] for wv in results["waves"]),
            "attributions": attributions,
            "attribution_exact": (bool(attributions)
                                  and set(attributions) == {chip}),
        })
        results["ok"] = (results["ok"]
                         and results["quarantined_within_bound"]
                         and results["attribution_exact"])

        # The corruptor is out: the mesh reforms to the widest surviving
        # rung and keeps deciding on the device.
        avail = routing.healthy_device_count(devices)
        rung, ids = routing.reform_for(devices)
        passed, raised, st = run_wave(seed, keys, "reformed", hp, rng,
                                      devices, device)
        participated = (st.get("device_batches", 0)
                        + st.get("device_rejects_confirmed", 0)
                        + st.get("device_rejects_overturned", 0))
        results["reformed"] = {
            "available_chips": avail,
            "available_fraction": avail / devices,
            "reformed_rung": rung,
            "device_ids": list(ids) if ids else None,
            "mesh_after": st.get("mesh"),
            "stats_device_ids": st.get("device_ids"),
            "host_identical": passed and not raised,
            "device_participated": participated,
            "sentinel_divergence": st["sentinel"]["divergence"],
            "ok": (passed and not raised and avail == devices - 1
                   and rung == devices // 2
                   and st.get("mesh") == devices // 2
                   and participated >= 1
                   and st["sentinel"]["divergence"] == 0),
        }
        results["ok"] = results["ok"] and results["reformed"]["ok"]

        # The service's admission base shrinks for a quarantined chip as
        # for a lost one.
        svc = service.VerifyService(capacity_sigs=8000, mesh=devices,
                                    clock=clock, auto_start=False,
                                    device=device)
        st_svc = svc.stats()
        svc.close()
        results["service"] = {
            "capacity_sigs": 8000,
            "effective_capacity_sigs": st_svc["effective_capacity_sigs"],
            "quarantined_chips": st_svc["quarantined_chips"],
            "ok": (st_svc["effective_capacity_sigs"] < 8000
                   and st_svc["quarantined_chips"] == [chip]),
        }
        results["ok"] = results["ok"] and results["service"]["ok"]

        # The crafted reject→accept flip on the reformed mesh: every batch
        # bad, one chip's sums forced to identity.  The audit must catch
        # it before any verdict publishes: the wave raises, naming it.
        flip_chip = 0
        plan = faults.sentinel_plan(seed, "flip-accept", chip=flip_chip,
                                    on=lambda i: True)
        with faults.injected(plan):
            passed, raised, st = run_wave(seed, keys, "flip", hp, rng,
                                          devices, device, bad_rate=1.0)
        results["flip_accept"] = {
            "passed": passed,
            "raised": raised,
            "sentinel_divergence": st["sentinel"]["divergence"],
            "attributed": st["sentinel"]["attributed"],
            "ok": (raised and st["sentinel"]["divergence"] >= 1
                   and st["sentinel"]["attributed"] == [flip_chip]),
        }
        results["ok"] = results["ok"] and results["flip_accept"]["ok"]
    finally:
        devcache.set_default_cache(None)
        batch.reset_device_health()
    return results


def run_transient_corruptor(seed, devices=8, chip=3, device="cuda") -> dict:
    """Phase B (see the module docstring)."""
    clock, hp, keys, rng = _setup(seed, devices, "rng2")
    reg = health.chip_registry()
    results = {"ok": True, "chip": chip}
    try:
        # Corrupt until quarantined (bounded as in phase A), then stop.
        plan = faults.sentinel_plan(seed, "corrupt-chip", chip=chip,
                                    on=lambda i: True)
        passed_all, raised_waves = True, 0
        with faults.injected(plan):
            for w in range(waves_to_quarantine()):
                passed, raised, _st = run_wave(
                    seed, keys, "transient-storm-%d" % w, hp, rng,
                    devices, device)
                passed_all = passed_all and passed
                raised_waves += raised
                if reg.chip_state(chip) == health.STATE_QUARANTINED:
                    break
        results["storm_passed"] = passed_all
        results["raised_waves"] = raised_waves
        results["quarantined"] = (
            reg.chip_state(chip) == health.STATE_QUARANTINED)
        results["ok"] = passed_all and results["quarantined"]

        # Suspicion decays on the registry clock; the read side relaxes
        # quarantine to probation.
        clock.advance(6 * config.get("ED25519_TPU_SUSPICION_HALF_LIFE"))
        results["probation_eligible"] = (
            reg.chip_state(chip) == health.STATE_PROBATION)
        results["ok"] = results["ok"] and results["probation_eligible"]

        # Clean probation probes on the chip until it rejoins.
        probes = []
        for p in range(config.get("ED25519_TPU_PROBATION_PROBES")):
            pv, _ = make_wave(seed, keys, "probe-%d" % p, n_batches=1,
                              bad_rate=0.0)
            probes.append(batch.run_probation_probe(pv[0], chip, rng=rng,
                                                    device=device))
        results["probes"] = probes
        results["rejoined"] = (reg.chip_state(chip) == health.STATE_HEALTHY
                               and not reg.excluded_chips())
        results["ok"] = results["ok"] and all(probes) \
            and results["rejoined"]

        # Full width again: routing reforms back over the chip and the
        # last wave runs the whole mesh with no reformation.
        results["reform_full_width"] = (
            routing.reform_for(devices) == (devices, None))
        passed, raised, st = run_wave(seed, keys, "rejoined", hp, rng,
                                      devices, device)
        results["rejoin_wave"] = {
            "host_identical": passed and not raised,
            "mesh": st.get("mesh"),
            "reformations": st.get("mesh_reformations", []),
            "ok": (passed and not raised and st.get("mesh") == devices
                   and not st.get("mesh_reformations")),
        }
        results["ok"] = (results["ok"] and results["reform_full_width"]
                         and results["rejoin_wave"]["ok"])
    finally:
        devcache.set_default_cache(None)
        batch.reset_device_health()
    return results


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=lambda s: int(s, 0), default=DEFAULT_SEED)
    ap.add_argument("--devices", type=int, default=8,
                    help="logical chips of the mesh")
    ap.add_argument("--chip", type=int, default=5,
                    help="the persistently corrupting chip (phase A)")
    ap.add_argument("--transient-chip", type=int, default=3,
                    help="the transiently corrupting chip (phase B)")
    ap.add_argument("--device", default="cuda",
                    help="torch device every shard runs on (default: the "
                         "card; cpu runs the kernels' plain versions)")
    ap.add_argument("--json", action="store_true")
    return ap.parse_args(argv)


def soak(args) -> dict:
    """Both phases → the summary ({"ok", "persistent", "transient",
    ...})."""
    summary = {"seed": args.seed, "devices": args.devices,
               "device": args.device}
    summary["persistent"] = run_persistent_corruptor(
        args.seed, devices=args.devices, chip=args.chip, device=args.device)
    summary["transient"] = run_transient_corruptor(
        args.seed, devices=args.devices, chip=args.transient_chip,
        device=args.device)
    summary["ok"] = summary["persistent"]["ok"] \
        and summary["transient"]["ok"]
    return summary


def headline(summary) -> dict:
    """The one-line result: how fast a silent corruptor is diagnosed."""
    pers = summary["persistent"]
    return {
        "metric": "sentinel_soak",
        "value": pers.get("detected_at_wave"),
        "unit": "waves_to_quarantine_persistent_corruptor",
        "k_wave_bound": pers.get("k_wave_bound"),
        "attribution_exact": pers.get("attribution_exact"),
        "available_fraction_after_quarantine":
            pers.get("reformed", {}).get("available_fraction"),
        "reformed_rung": pers.get("reformed", {}).get("reformed_rung"),
        "flip_accept_caught": pers.get("flip_accept", {}).get("ok"),
        "transient_rejoined": summary["transient"].get("rejoined"),
        "ok": summary["ok"],
    }


def main(argv=None):
    args = parse_args(argv)
    summary = soak(args)
    if args.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    print(json.dumps(headline(summary)))
    print("SENTINEL_SOAK", json.dumps(summary))
    if not summary["ok"]:
        print(f"VIOLATION: sentinel_soak gates failed (replay with --seed "
              f"{args.seed:#x})", file=sys.stderr)
    sys.stdout.flush()  # os._exit skips buffer flushing
    batch._DeviceLane.reset_all(timeout=30.0)
    os._exit(0 if summary["ok"] else 1)


if __name__ == "__main__":
    main()
