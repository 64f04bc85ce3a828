"""Replay lab: the mempool→block→vote-replay scenario the verdict
cache exists for — the port of the JAX package's tools/replay_lab.py,
over the port's `VerifyService` and `verdictcache`.

A consensus node sees the same (sig, key, msg) set three times: at
mempool admission, again inside the proposed block, again on vote
replay.  This lab replays exactly that shape — every transaction
submitted 3× across classes (mempool → consensus → consensus), with
interleaved fresh rpc traffic and a MID-RUN tenant rotation — against
a `VerifyService` on a FakeClock, twice: memo ON and memo OFF, under
the SAME seeded schedule and the SAME virtual device-cost model
(`cost = overhead + live_sigs / rate` per verifying wave; a memo hit
resolves at the front door and costs zero device work).  The headline
is the `verdict_memo` bench block: EFFECTIVE consensus-class
throughput — consensus signatures resolved per virtual device-second
— with the memo on vs off, i.e. how much consensus work a unit of
device work buys once the double-verify stops being paid twice.

Then the trust discipline is attacked: the same scenario replays under
seeded `SITE_VERDICTCACHE` storms (`faults.verdictcache_plan`) —
stored-verdict corruption (every hit in the window serves a flipped
accept/reject candidate), stale-epoch storms, and evict storms.  The
corruption run additionally requires the per-hit re-hash to have
actually FIRED (`rehash_mismatch` > 0): a flipped stored verdict must
be caught and fully re-verified, never published.

Gates (exit nonzero on violation):

* zero lost — every submission of every run resolves to a verdict;
* verdicts bit-identical to the host oracle (truth by construction,
  tampered batches included) in EVERY run: memo on, memo off, every
  fault storm, and across the mid-run rotation;
* replayed-leg hit rate ≥ --hit-rate-floor (0.6) in the memo run;
* effective consensus-class sigs/s (memo on) ≥ --speedup-floor (1.8)
  × the memo-off run's, at equal virtual device work accounting;
* the corruption storm's flipped verdicts were all caught by the
  re-hash (rehash_mismatch > 0, verdicts still oracle-identical).

The whole lab is a pure function of --seed (default DEFAULT_SEED, the
JAX lab's default): the virtual rate is pinned, arrivals and
tampering are seeded, and the replay digest is bit-stable across runs
and machines — and equal to the JAX lab's at the same seed and sizes.
The lab is host-only on its FakeClock: the service routes every wave to
the host (a health that never allows the device), so no kernel runs and
no card is needed.

Usage:
  python -m ed25519_consensus_tpu_torch.tools.replay_lab [--seed N]
      [--txs 60] [--sigs 4] [--service-rate 20000] [--json]
"""

import argparse
import hashlib
import json
import random
import sys

from .. import (
    SigningKey, devcache, faults, health, service, tenancy, verdictcache,
)

_stable_seed = tenancy._stable_seed

DEFAULT_SEED = 0x2E91A1

TENANTS = ("chain-a", "chain-b")
ROTATED_TENANT = "chain-b"
LEG_CLASSES = (tenancy.CLASS_MEMPOOL, tenancy.CLASS_CONSENSUS,
               tenancy.CLASS_CONSENSUS)
LEG_NAMES = ("mempool", "block", "replay")


def tx_keys(seed, tenant, sigs):
    rnd = random.Random(_stable_seed(seed, "keys", tenant))
    return [SigningKey.new(rnd) for _ in range(sigs)]


def tx_material(seed, keys, ident, sigs, bad_rate):
    """(entries, want) for one logical transaction batch — rebuilt
    byte-identically for every leg (each submission owns its
    Verifier), truth known by construction."""
    rnd = random.Random(_stable_seed(seed, "tx", ident))
    bad_at = rnd.randrange(sigs) if rnd.random() < bad_rate else -1
    entries = []
    for j in range(sigs):
        sk = keys[j]
        m = b"replay-lab %s %d" % (ident.encode(), j)
        sig = sk.sign(m)
        if j == bad_at:
            m += b"!"
        entries.append((sk.verification_key_bytes(), sig, m))
    return entries, bad_at < 0


def build_schedule(cfg):
    """The seeded event schedule, shared verbatim by every run of the
    lab: [(t, kind, payload)] sorted by (t, tiebreak) where kind is
    "leg" (tx leg submission), "fresh" (one-shot rpc batch), or
    "rotate" (the mid-run validator-set rotation of ROTATED_TENANT).
    A pure function of (seed, txs, sigs)."""
    T = cfg.txs
    events = []
    for i in range(T):
        tenant = TENANTS[i % len(TENANTS)]
        for leg, (name, cls) in enumerate(zip(LEG_NAMES, LEG_CLASSES)):
            t = float(i) + (0.0, 0.35 * T, 0.7 * T)[leg]
            events.append((t, 0, "leg", (i, tenant, leg, name, cls)))
    rnd = random.Random(_stable_seed(cfg.seed, "fresh"))
    n_fresh = max(1, int(round(cfg.fresh_frac * T)))
    for f in range(n_fresh):
        t = rnd.uniform(0.0, 1.7 * T)
        events.append((t, 1, "fresh", (f, TENANTS[f % len(TENANTS)])))
    events.append((0.95 * T, 2, "rotate", (ROTATED_TENANT,)))
    events.sort(key=lambda e: (e[0], e[1], repr(e[3])))
    return events


class LegRecord:
    """One submission's accounting: identity, oracle truth, outcome."""

    __slots__ = ("ident", "cls", "tenant", "leg_name", "sigs", "want",
                 "verdict", "hit", "done_at", "ticket")

    def __init__(self, ident, cls, tenant, leg_name, sigs, want):
        self.ident = ident
        self.cls = cls
        self.tenant = tenant
        self.leg_name = leg_name
        self.sigs = sigs
        self.want = want
        self.verdict = None
        self.hit = False
        self.done_at = None
        self.ticket = None


def run_scenario(cfg, memo_on: bool, plan=None) -> dict:
    """One full seeded run: returns the per-run summary (outcomes,
    virtual device seconds, hit accounting, cache counters).  The
    schedule, batches, and cost model are identical across memo
    on/off/fault runs — only the memo layer differs."""
    schedule = build_schedule(cfg)
    rate = float(cfg.service_rate)
    overhead_s = cfg.wave_overhead * cfg.sigs / rate
    keysets = {t: tx_keys(cfg.seed, t, cfg.sigs) for t in TENANTS}

    clock = health.FakeClock()
    t0 = clock.monotonic()
    devc = devcache.DeviceOperandCache(budget_bytes=1 << 20, enabled=False)
    vcache = verdictcache.VerdictCache(
        budget_bytes=1 << 22, enabled=memo_on, tenant_quota_bytes=0,
        namespace="replaylab", companion=devc)
    total_sigs = (3 * cfg.txs + int(round(cfg.fresh_frac * cfg.txs)) + 1
                  ) * cfg.sigs
    # Host-only: the health never allows the device, so every wave runs
    # the pure-host loop; device="cpu" names a device that needs no card.
    svc = service.VerifyService(
        capacity_sigs=2 * total_sigs, auto_start=False, clock=clock,
        mesh=0, health=service._HostOnlyHealth(clock),
        rng=random.Random(_stable_seed(cfg.seed, "rng")),
        cache=devc, verdict_cache=vcache, device="cpu")

    records, pending = [], []
    device_seconds = [0.0]

    def drain():
        """Pump waves until idle, charging each verifying wave's
        virtual cost (overhead + live_sigs/rate) to the clock and the
        device-seconds ledger.  Memo hits never get here — they
        resolved at submit for free."""
        while True:
            if svc.process_once(block=False) == 0:
                return
            done = [r for r in pending if r.ticket.done()]
            live = 0
            for r in done:
                pending.remove(r)
                r.verdict = r.ticket.result(0)
                live += r.sigs
            cost = (overhead_s + live / rate) if live else 0.0
            if cost:
                clock.advance(cost)
                device_seconds[0] += cost
            now = clock.monotonic()
            for r in done:
                r.done_at = now

    def submit(rec, entries):
        ticket = svc.submit(entries, cls=rec.cls, tenant=rec.tenant)
        rec.ticket = ticket
        records.append(rec)
        if ticket.done():
            # Resolved at the front door: a re-hashed memo hit — no
            # queue occupancy, no device work.
            rec.hit = True
            rec.verdict = ticket.result(0)
            rec.done_at = clock.monotonic()
        else:
            pending.append(rec)
            drain()

    if plan is not None:
        faults.install(plan)
    try:
        for t, _tb, kind, payload in schedule:
            target = t0 + t * cfg.sigs / rate
            if clock.monotonic() < target:
                clock.advance_to(target)
            if kind == "rotate":
                # Mid-run validator-set rotation: lands on the
                # COMPANION devcache — the wiring under test — and
                # must stale exactly this tenant's memoized verdicts.
                devc.rotate_tenant(payload[0], "replay-lab rotation")
                continue
            if kind == "leg":
                i, tenant, leg, name, cls = payload
                entries, want = tx_material(
                    cfg.seed, keysets[tenant], f"tx-{i}", cfg.sigs,
                    cfg.bad_rate)
                submit(LegRecord(f"tx-{i}/{name}", cls, tenant, name,
                                 cfg.sigs, want), entries)
            else:
                f, tenant = payload
                entries, want = tx_material(
                    cfg.seed, keysets[tenant], f"fresh-{f}", cfg.sigs,
                    cfg.fresh_bad_rate)
                submit(LegRecord(f"fresh-{f}", tenancy.CLASS_RPC,
                                 tenant, "fresh", cfg.sigs, want),
                       entries)
        drain()
        svc.close()
        drain()
    finally:
        if plan is not None:
            faults.uninstall()

    lost = sum(1 for r in records if r.verdict is None)
    mismatches = sum(1 for r in records
                     if r.verdict is not None and r.verdict != r.want)
    replayed = [r for r in records if r.leg_name in ("block", "replay")]
    replay_hits = sum(1 for r in replayed if r.hit)
    cons_sigs = sum(r.sigs for r in records
                    if r.cls == tenancy.CLASS_CONSENSUS
                    and r.verdict is not None)
    dsec = device_seconds[0]
    digest = hashlib.sha256()
    for r in records:
        digest.update(repr((r.ident, r.cls, r.verdict, r.hit,
                            None if r.done_at is None
                            else round(r.done_at - t0, 9))).encode())
    st = svc.stats()
    return {
        "memo": memo_on,
        "requests": len(records),
        "lost": lost,
        "verdict_mismatches": mismatches,
        "replayed_legs": len(replayed),
        "replayed_hits": replay_hits,
        "replayed_hit_rate": (round(replay_hits / len(replayed), 4)
                              if replayed else None),
        "device_seconds": round(dsec, 9),
        "consensus_sigs": cons_sigs,
        "effective_consensus_sigs_per_s": (
            round(cons_sigs / dsec, 3) if dsec > 0 else None),
        "verdict_cache_hits": st["verdict_cache_hits"],
        "verdict_cache_stores": st["verdict_cache_stores"],
        "verdictcache": vcache.stats(),
        "waves": st["waves"],
        "replay_digest": digest.hexdigest(),
    }


def run_lab(cfg) -> dict:
    """The full lab: memo run, baseline run, and the three
    SITE_VERDICTCACHE storms — one summary, one gate set."""
    memo = run_scenario(cfg, memo_on=True)
    base = run_scenario(cfg, memo_on=False)
    storms = {}
    for kind in ("corrupt-verdict", "stale", "evict"):
        plan = faults.verdictcache_plan(cfg.seed, kind, at=0,
                                       length=4096)
        storms[kind] = run_scenario(cfg, memo_on=True, plan=plan)

    eff_on = memo["effective_consensus_sigs_per_s"]
    eff_off = base["effective_consensus_sigs_per_s"]
    speedup = (round(eff_on / eff_off, 4)
               if eff_on and eff_off else None)
    corrupt = storms["corrupt-verdict"]
    gates = {
        "zero_lost": all(r["lost"] == 0 for r in
                         [memo, base, *storms.values()]),
        "host_identical_verdicts": all(
            r["verdict_mismatches"] == 0
            for r in [memo, base, *storms.values()]),
        "replayed_hit_rate_met": (
            memo["replayed_hit_rate"] is not None
            and memo["replayed_hit_rate"] >= cfg.hit_rate_floor),
        "speedup_met": (speedup is not None
                        and speedup >= cfg.speedup_floor),
        "rotation_staled_memo": (
            memo["verdictcache"]["stale_epoch"] > 0),
        "corruption_caught_by_rehash": (
            corrupt["verdictcache"]["rehash_mismatch"] > 0
            and corrupt["verdict_mismatches"] == 0),
    }
    return {
        "ok": all(gates.values()),
        "gates": gates,
        "seed": cfg.seed,
        "txs": cfg.txs,
        "sigs": cfg.sigs,
        "service_rate_sigs_per_s": float(cfg.service_rate),
        "speedup": speedup,
        "memo": memo,
        "baseline": base,
        "storms": storms,
        "replay_digest": memo["replay_digest"],
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seed", type=lambda s: int(s, 0),
                    default=DEFAULT_SEED)
    ap.add_argument("--txs", type=int, default=60,
                    help="transactions; each is submitted 3x "
                         "(mempool -> block -> vote replay)")
    ap.add_argument("--sigs", type=int, default=4,
                    help="signatures per transaction batch")
    ap.add_argument("--service-rate", type=float, default=20000.0,
                    help="pinned virtual verification rate (sigs/s) — "
                         "the cost-model denominator; pinned (never "
                         "calibrated) so the run is a pure function "
                         "of the seed")
    ap.add_argument("--wave-overhead", type=float, default=0.25,
                    help="per-wave fixed cost in per-batch-cost units")
    ap.add_argument("--fresh-frac", type=float, default=0.25,
                    help="one-shot fresh rpc batches as a fraction of "
                         "--txs (interleaved, never replayed)")
    ap.add_argument("--bad-rate", type=float, default=0.25,
                    help="fraction of transactions carrying one "
                         "tampered signature (False verdicts ride "
                         "every cache path)")
    ap.add_argument("--fresh-bad-rate", type=float, default=0.3)
    ap.add_argument("--hit-rate-floor", type=float, default=0.6,
                    help="minimum acceptable hit rate on the replayed "
                         "(block + vote-replay) legs")
    ap.add_argument("--speedup-floor", type=float, default=1.8,
                    help="minimum acceptable effective consensus-class "
                         "throughput ratio, memo on vs off")
    ap.add_argument("--json", action="store_true")
    return ap.parse_args(argv)


def main(argv=None):
    cfg = parse_args(argv)
    summary = run_lab(cfg)
    if cfg.json:
        print(json.dumps(summary, indent=2, sort_keys=True))
    # The bench-harvest line (same shape as bench.py metric blocks):
    # the headline is the effective consensus-throughput multiple.
    print(json.dumps({
        "metric": "verdict_memo",
        "value": summary["speedup"],
        "unit": "x_effective_consensus_sigs_per_s_vs_cache_off",
        "replayed_hit_rate": summary["memo"]["replayed_hit_rate"],
        "effective_on": summary["memo"][
            "effective_consensus_sigs_per_s"],
        "effective_off": summary["baseline"][
            "effective_consensus_sigs_per_s"],
        "device_seconds_on": summary["memo"]["device_seconds"],
        "device_seconds_off": summary["baseline"]["device_seconds"],
        "verdict_cache_hits": summary["memo"]["verdict_cache_hits"],
        "rehash_catches_under_corruption": summary["storms"][
            "corrupt-verdict"]["verdictcache"]["rehash_mismatch"],
        "zero_lost": summary["gates"]["zero_lost"],
        "host_identical": summary["gates"]["host_identical_verdicts"],
        "replay_digest": summary["replay_digest"],
        "ok": summary["ok"],
    }))
    print("VERDICT_MEMO", json.dumps(
        {k: v for k, v in summary.items() if k != "storms"}))
    if not summary["ok"]:
        failed = [g for g, ok in summary["gates"].items() if not ok]
        print(f"VIOLATION: verdict_memo gates failed: {failed} "
              f"(replay with --seed {summary['seed']:#x})",
              file=sys.stderr)
    sys.exit(0 if summary["ok"] else 1)


if __name__ == "__main__":
    main()
