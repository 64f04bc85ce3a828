"""Restart lab: hard-kill / revive-from-disk chaos for the durable verdict
state — the port of the JAX package's tools/restart_lab.py, over the
port's `persist`, `VerifyService` and the seeded mempool→block→vote-replay
schedule and virtual cost model of `tools/replay_lab.py`.

Each scenario lives TWICE.  Life 1 drives the replay-lab schedule against
a `VerifyService` whose verdict cache journals to disk, then hard-kills it
at a seeded point mid-traffic: no close(), no drain, no final flush —
whatever the append path already wrote is all the disk has.  Life 2 builds
a fresh service and caches, attaches the same journal directory (running
persist.py's trust-ladder recovery), re-submits every leg the kill
orphaned, and finishes the schedule.  A cold control runs the same two
lives with persistence off.

Then the recovery discipline is attacked: the two-life scenario replays
under each seeded `SITE_PERSIST` storm (`faults.persist_plan`) — torn tail
(`torn`), flipped bits (`bitrot`), lost tail (`truncate`), format-version
skew (`version-skew`) and a stale epoch-pin header (`stale-pins`).  Life
2's load report is the evidence that the corruption was caught at load
and degraded to lost warmth, never to a served verdict.

Gates (exit nonzero on violation):

* zero lost — every leg of every scenario, across BOTH lives, resolves to
  a verdict;
* verdicts bit-identical to the host oracle (truth by construction) in
  every scenario and every life;
* clean recovery absorbed at least one journaled verdict;
* post-restart replayed-leg hit rate (first life-2 sighting of content
  resolved before the kill) ≥ --hit-rate-floor (0.4) in the clean
  scenario, and ≥ --warmth-margin (0.25) above the cold control's;
* every storm is visibly caught: torn/bitrot leave nonzero drop counts,
  truncate loses absorbed records vs clean, version-skew drops the whole
  file, stale-pins drops re-pinned records — verdicts still exact.

The lab is a pure function of --seed (default DEFAULT_SEED, the JAX lab's
default) and host-only on its FakeClock, like the replay lab: every wave
routes to the host, so no kernel runs and no card is needed.  Its replay
digest equals the JAX lab's at the same seed and sizes.

Usage:
  python -m ed25519_consensus_tpu_torch.tools.restart_lab [--seed N]
      [--txs 40] [--sigs 4] [--service-rate 20000] [--json]
"""

import argparse
import hashlib
import json
import random
import shutil
import sys
import tempfile

from .. import devcache, faults, health, persist, service, tenancy
from .. import verdictcache
from . import replay_lab as _replay

_stable_seed = tenancy._stable_seed

DEFAULT_SEED = 0x5EED17

STORM_KINDS = ("torn", "bitrot", "truncate", "version-skew",
               "stale-pins")
# The seeded hard kill lands in this window (fractions of the event-time
# horizon T = --txs): late enough that a real working set is journaled,
# early enough that most block/replay legs still lie ahead.
KILL_WINDOW = (0.45, 0.62)


class LifeRecord(_replay.LegRecord):
    """A replay-lab LegRecord that also remembers which life (1 =
    pre-kill, 2 = revived) submitted it."""

    __slots__ = ("life",)


def kill_time(cfg) -> float:
    rnd = random.Random(_stable_seed(cfg.seed, "kill"))
    return cfg.txs * rnd.uniform(*KILL_WINDOW)


def storm_plan(cfg, kind):
    """One seeded SITE_PERSIST storm, its window in the journal's
    early-middle appends (life 1 appends well past it)."""
    rnd = random.Random(_stable_seed(cfg.seed, "storm", kind))
    at = 8 + rnd.randrange(6)
    return faults.persist_plan(cfg.seed, kind, at=at, length=2,
                               frac=0.5, flips=2, skew=1, bump=1000)


def _build_caches(memo_on: bool):
    devc = devcache.DeviceOperandCache(budget_bytes=1 << 20, enabled=False)
    vcache = verdictcache.VerdictCache(
        budget_bytes=1 << 22, enabled=memo_on, tenant_quota_bytes=0,
        namespace="restartlab", companion=devc)
    return devc, vcache


def _build_service(cfg, clock, devc, vcache, life: int):
    total_sigs = (3 * cfg.txs
                  + int(round(cfg.fresh_frac * cfg.txs)) + 1) * cfg.sigs
    # Host-only: the health never allows the device; device="cpu" names
    # a device that needs no card.
    return service.VerifyService(
        capacity_sigs=2 * total_sigs, auto_start=False, clock=clock,
        mesh=0, health=service._HostOnlyHealth(clock),
        rng=random.Random(_stable_seed(cfg.seed, "rng", life)),
        cache=devc, verdict_cache=vcache, device="cpu")


def _run_life(cfg, life, clock, t0, svc, devc, events, keysets,
              records, resolved, warm, plan=None):
    """Drive one life's slice of the schedule.  Life 1 returns with
    requests possibly unresolved (the hard kill); life 2 drains and
    closes.  `resolved` maps content ident → True once any leg of that
    content got a verdict; `warm` accumulates the life-2 first-sighting
    hit accounting."""
    rate = float(cfg.service_rate)
    overhead_s = cfg.wave_overhead * cfg.sigs / rate
    pending = []
    device_seconds = [0.0]
    first_seen = set()

    def drain():
        while True:
            if svc.process_once(block=False) == 0:
                return
            done = [r for r in pending if r.ticket.done()]
            live = 0
            for r in done:
                pending.remove(r)
                r.verdict = r.ticket.result(0)
                resolved[r.ident.rsplit("/", 1)[0]] = True
                live += r.sigs
            cost = (overhead_s + live / rate) if live else 0.0
            if cost:
                clock.advance(cost)
                device_seconds[0] += cost
            now = clock.monotonic()
            for r in done:
                r.done_at = now

    def submit(rec, entries):
        content = rec.ident.rsplit("/", 1)[0]
        ticket = svc.submit(entries, cls=rec.cls, tenant=rec.tenant)
        rec.ticket = ticket
        rec.life = life
        records.append(rec)
        if life == 2 and content not in first_seen:
            first_seen.add(content)
            if resolved.get(content):
                warm["candidates"] += 1
                if ticket.done():
                    warm["hits"] += 1
        if ticket.done():
            rec.hit = True
            rec.verdict = ticket.result(0)
            resolved[content] = True
            rec.done_at = clock.monotonic()
        else:
            pending.append(rec)
            drain()

    if plan is not None:
        faults.install(plan)
    try:
        for t, _tb, kind, payload in events:
            target = t0 + t * cfg.sigs / rate
            if clock.monotonic() < target:
                clock.advance_to(target)
            if kind == "rotate":
                devc.rotate_tenant(payload[0], "restart-lab rotation")
                continue
            if kind == "leg":
                i, tenant, leg, name, cls = payload
                entries, want = _replay.tx_material(
                    cfg.seed, keysets[tenant], f"tx-{i}", cfg.sigs,
                    cfg.bad_rate)
                rec = LifeRecord(f"tx-{i}/{name}", cls, tenant,
                                 name, cfg.sigs, want)
                submit(rec, entries)
            else:
                f, tenant = payload
                entries, want = _replay.tx_material(
                    cfg.seed, keysets[tenant], f"fresh-{f}", cfg.sigs,
                    cfg.fresh_bad_rate)
                rec = LifeRecord(f"fresh-{f}", tenancy.CLASS_RPC,
                                 tenant, "fresh", cfg.sigs, want)
                submit(rec, entries)
        if life == 2:
            drain()
            svc.close()
            drain()
    finally:
        if plan is not None:
            faults.uninstall()
    return device_seconds[0], pending


def run_scenario(cfg, label: str, persist_on: bool = True,
                 plan=None) -> dict:
    """One two-life scenario in its own journal directory: life 1 up to
    the seeded hard kill (storms injected on the append path), then a
    from-scratch life 2 that recovers from disk, re-submits the orphans
    and finishes the schedule."""
    schedule = _replay.build_schedule(cfg)
    kt = kill_time(cfg)
    keysets = {t: _replay.tx_keys(cfg.seed, t, cfg.sigs)
               for t in _replay.TENANTS}
    clock = health.FakeClock()
    t0 = clock.monotonic()
    records, resolved = [], {}
    warm = {"candidates": 0, "hits": 0}
    pdir = tempfile.mkdtemp(prefix="restart-lab-")
    try:
        # -- life 1: journal attached, storms live, hard kill --------------
        devc1, vcache1 = _build_caches(memo_on=True)
        if persist_on:
            persist.attach(vcache1, directory=pdir)
        svc1 = _build_service(cfg, clock, devc1, vcache1, life=1)
        pre = [e for e in schedule if e[0] < kt]
        post = [e for e in schedule if e[0] >= kt]
        _, orphans = _run_life(cfg, 1, clock, t0, svc1, devc1, pre,
                               keysets, records, resolved, warm,
                               plan=plan)
        appends1 = (vcache1.journal().stats()["appends"]
                    if persist_on and vcache1.journal() is not None
                    else 0)
        # The hard kill: svc1 and vcache1 are abandoned mid-flight — no
        # close, no drain, no flush.  Orphaned requests are dropped here
        # and MUST be re-submitted by life 2.
        for r in orphans:
            records.remove(r)

        # -- life 2: fresh caches and service, recover from disk -----------
        devc2, vcache2 = _build_caches(memo_on=True)
        if persist_on:
            persist.attach(vcache2, directory=pdir)
        load_report = (vcache2.journal().last_load_report
                       if persist_on and vcache2.journal() is not None
                       else None)
        svc2 = _build_service(cfg, clock, devc2, vcache2, life=2)
        redo = [(0.0, 0, "leg", (int(r.ident.split("/")[0][3:]),
                                 r.tenant,
                                 _replay.LEG_NAMES.index(r.leg_name),
                                 r.leg_name, r.cls))
                for r in orphans if r.ident.startswith("tx-")]
        redo += [(0.0, 1, "fresh", (int(r.ident.split("-")[1]),
                                    r.tenant))
                 for r in orphans if r.ident.startswith("fresh-")]
        dsec2, leftover = _run_life(cfg, 2, clock, t0, svc2, devc2,
                                    redo + post, keysets, records,
                                    resolved, warm)
    finally:
        shutil.rmtree(pdir, ignore_errors=True)

    lost = (sum(1 for r in records if r.verdict is None)
            + len(leftover))
    mismatches = sum(1 for r in records
                     if r.verdict is not None and r.verdict != r.want)
    digest = hashlib.sha256()
    for r in records:
        digest.update(repr((r.ident, r.cls, r.verdict, r.hit,
                            r.life)).encode())
    rate = (round(warm["hits"] / warm["candidates"], 4)
            if warm["candidates"] else None)
    return {
        "label": label,
        "persist": persist_on,
        "requests": len(records),
        "lost": lost,
        "verdict_mismatches": mismatches,
        "killed_at_t": round(kt, 4),
        "orphans_resubmitted": len(orphans),
        "life1_appends": appends1,
        "load_report": load_report,
        "warm_candidates": warm["candidates"],
        "warm_hits": warm["hits"],
        "post_restart_hit_rate": rate,
        "life2_device_seconds": round(dsec2, 9),
        "verdictcache_life2": vcache2.stats(),
        "replay_digest": digest.hexdigest(),
    }


def _storm_caught(kind: str, rep, clean_absorbed: int) -> bool:
    """Did life 2's load report visibly catch this storm's damage?  Each
    kind has its own degradation signature."""
    if rep is None:
        return False
    d = rep["dropped"]
    if kind == "torn":
        return d["torn_tail"] + d["record_hash"] > 0
    if kind == "bitrot":
        return (d["record_hash"] + d["rehash_mismatch"]
                + d["seal_mismatch"]) > 0
    if kind == "truncate":
        return (rep["absorbed"] < clean_absorbed
                or sum(d.values()) > 0)
    if kind == "version-skew":
        return rep["file_dropped"] == "version_skew"
    if kind == "stale-pins":
        return d["stale_pins"] > 0
    raise ValueError(f"unknown storm kind {kind!r}")


def run_lab(cfg) -> dict:
    """The full lab: clean kill/revive, cold control and the five
    SITE_PERSIST storms — one summary, one gate set."""
    clean = run_scenario(cfg, "clean", persist_on=True)
    cold = run_scenario(cfg, "cold", persist_on=False)
    storms = {}
    for kind in STORM_KINDS:
        storms[kind] = run_scenario(cfg, kind, persist_on=True,
                                    plan=storm_plan(cfg, kind))
    runs = [clean, cold, *storms.values()]
    clean_rate = clean["post_restart_hit_rate"]
    cold_rate = cold["post_restart_hit_rate"] or 0.0
    clean_absorbed = (clean["load_report"] or {}).get("absorbed", 0)
    gates = {
        "zero_lost": all(r["lost"] == 0 for r in runs),
        "host_identical_verdicts": all(
            r["verdict_mismatches"] == 0 for r in runs),
        "recovery_absorbed": clean_absorbed > 0,
        "post_restart_hit_rate_met": (
            clean_rate is not None
            and clean_rate >= cfg.hit_rate_floor),
        "warmer_than_cold": (
            clean_rate is not None
            and clean_rate >= cold_rate + cfg.warmth_margin),
    }
    for kind in STORM_KINDS:
        gates[f"storm_{kind}_caught"] = _storm_caught(
            kind, storms[kind]["load_report"], clean_absorbed)
    return {
        "ok": all(gates.values()),
        "gates": gates,
        "seed": cfg.seed,
        "txs": cfg.txs,
        "sigs": cfg.sigs,
        "clean": clean,
        "cold": cold,
        "storms": storms,
        "replay_digest": clean["replay_digest"],
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=lambda s: int(s, 0), default=DEFAULT_SEED)
    ap.add_argument("--txs", type=int, default=40,
                    help="transactions; each is submitted 3x "
                         "(mempool -> block -> vote replay)")
    ap.add_argument("--sigs", type=int, default=4,
                    help="signatures per transaction batch")
    ap.add_argument("--service-rate", type=float, default=20000.0,
                    help="pinned virtual verification rate (sigs/s)")
    ap.add_argument("--wave-overhead", type=float, default=0.25,
                    help="per-wave fixed cost in per-batch-cost units")
    ap.add_argument("--fresh-frac", type=float, default=0.25)
    ap.add_argument("--bad-rate", type=float, default=0.25,
                    help="fraction of transactions carrying one "
                         "tampered signature (False verdicts ride "
                         "the journal too)")
    ap.add_argument("--fresh-bad-rate", type=float, default=0.3)
    ap.add_argument("--hit-rate-floor", type=float, default=0.4,
                    help="minimum post-restart hit rate on the first "
                         "life-2 sighting of pre-kill content")
    ap.add_argument("--warmth-margin", type=float, default=0.25,
                    help="clean recovery must beat the cold control's "
                         "post-restart hit rate by at least this")
    ap.add_argument("--json", action="store_true")
    return ap.parse_args(argv)


def main(argv=None):
    cfg = parse_args(argv)
    summary = run_lab(cfg)
    if cfg.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    print(json.dumps({
        "metric": "restart_warmth",
        "value": summary["clean"]["post_restart_hit_rate"],
        "unit": "post_restart_first_sighting_hit_rate",
        "cold_rate": summary["cold"]["post_restart_hit_rate"],
        "recovered_records": (summary["clean"]["load_report"]
                              or {}).get("absorbed"),
        "life1_appends": summary["clean"]["life1_appends"],
        "storms_caught": {
            k: summary["gates"][f"storm_{k}_caught"]
            for k in STORM_KINDS},
        "zero_lost": summary["gates"]["zero_lost"],
        "host_identical": summary["gates"]["host_identical_verdicts"],
        "replay_digest": summary["replay_digest"],
        "ok": summary["ok"],
    }))
    print("RESTART_WARMTH", json.dumps(
        {k: v for k, v in summary.items() if k != "storms"}))
    if not summary["ok"]:
        failed = [g for g, ok in summary["gates"].items() if not ok]
        print(f"VIOLATION: restart_warmth gates failed: {failed} "
              f"(replay with --seed {summary['seed']:#x})",
              file=sys.stderr)
    sys.exit(0 if summary["ok"] else 1)


if __name__ == "__main__":
    main()
