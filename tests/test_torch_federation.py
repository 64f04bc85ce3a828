"""The port's federation (`ed25519_consensus_tpu_torch.federation`) against
the JAX package's: each case of tests/test_federation.py runs both
`ReplicaSet`s on their own `FakeClock` with the same seeded keys and
batches, and compares the affinity order and the pinned `replica_for`
fixture, the registry's state after each event, placements, spillovers,
ejections, re-issues and the host floor (exact) and the verdicts (bit for
bit).  Also here: the front-door dedup and the namespaced verdict stores of
tests/test_verdictcache.py, the namespaced journals and the rejoin
pre-warm of tests/test_persist.py, and the port's own rules — a device
wave's DeviceError is replica-level evidence its tickets keep (never a
host re-decision), replicas on one device share its lane without
poisoning it, an ejected replica frees its own namespace's device tensors
and no peer's, and the fleet state carries across from the reference.

Every replica service runs on the CPU: the host route for the
federation's cases (as the JAX tests run them), `device="cpu"` (the
kernels' plain versions) for the device-route cases."""

import hashlib
import random

import numpy as np
import pytest

from ed25519_consensus_tpu import SigningKey as JSigningKey
from ed25519_consensus_tpu import batch as jbatch
from ed25519_consensus_tpu import config as jconfig
from ed25519_consensus_tpu import devcache as jdevcache
from ed25519_consensus_tpu import faults as jfaults
from ed25519_consensus_tpu import federation as jfederation
from ed25519_consensus_tpu import health as jhealth
from ed25519_consensus_tpu import persist as jpersist
from ed25519_consensus_tpu import routing as jrouting
from ed25519_consensus_tpu import service as jservice
from ed25519_consensus_tpu import tenancy as jtenancy
from ed25519_consensus_tpu import verdictcache as jverdictcache
from ed25519_consensus_tpu_torch import (SigningKey, batch, carry, config,
                                         devcache, faults, federation,
                                         health, persist, routing, service,
                                         tenancy, verdictcache)
from ed25519_consensus_tpu_torch.error import DeviceError

from torch_threads import _one_torch_thread  # noqa: F401


class Pkg:
    """One package's modules under one name, so a scenario runs on both."""

    def __init__(self, port: bool):
        self.port = port
        if port:
            (self.SigningKey, self.batch, self.devcache, self.faults,
             self.federation, self.health, self.routing, self.service,
             self.tenancy, self.verdictcache, self.persist) = (
                SigningKey, batch, devcache, faults, federation, health,
                routing, service, tenancy, verdictcache, persist)
        else:
            (self.SigningKey, self.batch, self.devcache, self.faults,
             self.federation, self.health, self.routing, self.service,
             self.tenancy, self.verdictcache, self.persist) = (
                JSigningKey, jbatch, jdevcache, jfaults, jfederation,
                jhealth, jrouting, jservice, jtenancy, jverdictcache,
                jpersist)
        seeds = random.Random(0xFED5)
        self.keys = {t: [self.SigningKey.from_seed(
            seeds.getrandbits(256).to_bytes(32, "little"))
            for _ in range(3)]
            for t in ("chain-a", "chain-b", "chain-c")}

    def verifier(self, tenant, i, bad=False, tag=b"fed"):
        v = self.batch.Verifier()
        for j, sk in enumerate(self.keys[tenant]):
            m = b"%s %s %d %d" % (tag, tenant.encode(), i, j)
            sig = sk.sign(m)
            if bad and j == 1:
                m += b"!"
            v.queue((sk.verification_key_bytes(), sig, m))
        return v

    def digest(self, tenant):
        v = self.verifier(tenant, 0)
        return self.devcache.keyset_digest(v._canonical_keyset_blob())

    def service_kw(self):
        return {"device": "cpu"} if self.port else {}

    def host_factory(self, capacity=4096):
        """Host-route replica services on the fleet clock: the federation
        is under test, not the device lane."""

        def factory(rid, clock, cache):
            return self.service.VerifyService(
                capacity_sigs=capacity, clock=clock, auto_start=False,
                replica_id=f"r{rid}", cache=cache, mesh=0,
                health=self.service._HostOnlyHealth(clock),
                rng=random.Random(rid), **self.service_kw())

        return factory

    def make_set(self, replicas=3, capacity=4096, **kw):
        clock = self.health.FakeClock()
        fs = self.federation.ReplicaSet(
            replicas, service_factory=self.host_factory(capacity),
            clock=clock, capacity_sigs=capacity, **kw)
        return fs, clock


PORT, REF = Pkg(True), Pkg(False)


@pytest.fixture(autouse=True)
def reset_state():
    def reset():
        for f in (faults, jfaults):
            if f.active_plan():
                f.uninstall()
        for d in (devcache, jdevcache):
            d.set_default_cache(None)
        batch.reset_device_health()
        jbatch.reset_device_health()

    reset()
    yield
    batch._DeviceLane.reset_all()
    reset()


def drain(fs, rounds=50):
    for _ in range(rounds):
        if fs.process_once() == 0:
            break


def totals(fs):
    """The fleet totals both packages keep (the port adds
    device_error_waves, which the JAX fleet never sees)."""
    return {k: v for k, v in fs.totals.items() if k != "device_error_waves"}


def fleet_view(fs):
    """Everything a fleet decided, placement and ladder: totals, error
    classes, registry states, affinity hit rate and per-replica rows."""
    st = fs.stats()
    per = {rid: {k: row[k] for k in (
        "state", "suspicion", "capacity_fraction", "queue_requests",
        "queue_sigs", "submitted", "resolved", "breaker_state",
        "dedup_fanout", "crashed", "pumps")}
        for rid, row in st["replicas"].items()}
    for rid, row in st["replicas"].items():
        per[rid]["namespaces"] = (row["devcache"]["namespace"],
                                  row["verdictcache"]["namespace"])
        per[rid]["resident_keysets"] = row["devcache"]["resident_keysets"]
        per[rid]["resident_verdicts"] = \
            row["verdictcache"]["resident_verdicts"]
    return {"totals": totals(fs), "error_classes": st["error_classes"],
            "states": st["replica_states"],
            "affinity_hit_rate": st["affinity_hit_rate"], "replicas": per}


def outcome(ticket):
    try:
        return ticket.result(5)
    except Exception as exc:  # noqa: BLE001 - the outcome is the type
        return type(exc).__name__


def both(scenario):
    """Run `scenario(P)` on both packages; their traces must be equal."""
    got, want = scenario(PORT), scenario(REF)
    assert got == want
    return got


# -- consistent-hash affinity (pure functions) ------------------------------

def test_affinity_order_is_a_pure_deterministic_function():
    d = b"\x01" * 32
    o1 = routing.replica_affinity_order(d, "chain-a", range(5))
    assert o1 == routing.replica_affinity_order(d, "chain-a", range(5))
    assert sorted(o1) == [0, 1, 2, 3, 4]
    assert o1 != routing.replica_affinity_order(d, "chain-b", range(5)) \
        or o1 != routing.replica_affinity_order(
            b"\x02" * 32, "chain-a", range(5))
    assert routing.replica_affinity_order(None, "t", range(3)) == \
        routing.replica_affinity_order(None, "t", range(3))
    # the JAX order, byte for byte, over digests, tenants and sizes
    for i in range(64):
        dg = hashlib.sha256(b"aff-%d" % i).digest() if i % 7 else None
        for tenant in ("chain-a", "t", "_probe"):
            for m in (1, 3, 8):
                assert routing.replica_affinity_order(dg, tenant, range(m)) \
                    == jrouting.replica_affinity_order(dg, tenant, range(m))
    assert routing.replica_score(d, "t", 2)[1] == 2


def test_replica_for_pinned_fixture():
    """The JAX package's committed assignment fixture: a pure function of
    (keyset digest, tenant, replica count)."""
    digests = [hashlib.sha256(b"keyset-%d" % i).digest() for i in range(6)]
    got3 = [routing.replica_for(d, "chain-a", 3) for d in digests]
    got4 = [routing.replica_for(d, "chain-a", 4) for d in digests]
    assert got3 == [0, 0, 1, 2, 2, 1]
    assert got4 == [0, 0, 1, 2, 3, 1]
    assert got3 == [jrouting.replica_for(d, "chain-a", 3) for d in digests]
    with pytest.raises(ValueError):
        routing.replica_for(digests[0], "chain-a", 0)


def test_affinity_minimal_disruption_on_add_and_remove():
    digests = [hashlib.sha256(b"d%d" % i).digest() for i in range(200)]
    for d in digests:
        o3 = routing.replica_affinity_order(d, "t", range(3))
        o4 = routing.replica_affinity_order(d, "t", range(4))
        assert o4 == jrouting.replica_affinity_order(d, "t", range(4))
        if o4[0] != 3:
            assert o4[0] == o3[0]
        survivors = [r for r in range(3) if r != o3[0]]
        assert routing.replica_affinity_order(d, "t", survivors)[0] == o3[1]
        others = [r for r in range(3) if r != o3[2]]
        assert routing.replica_affinity_order(d, "t", others)[0] == o3[0]


# -- the replica registry ladder --------------------------------------------

def _registry_trace(P, events):
    """Apply `events` to a fresh registry on a FakeClock; the trace is the
    return value and the replica_states() snapshot after each event."""
    clock = P.health.FakeClock()
    reg = P.health.ReplicaRegistry(clock=clock)
    trace = []
    for ev in events:
        name, args = ev[0], ev[1:]
        if name == "advance":
            clock.advance(*args)
            ret = None
        else:
            ret = getattr(reg, name)(*args)
            if isinstance(ret, (frozenset, set)):
                ret = sorted(ret)
            elif isinstance(ret, float):
                ret = round(ret, 9)
        trace.append((name, ret, reg.replica_states()))
    return trace


@pytest.mark.parametrize("events", [
    # suspicion accumulates, decays and drains
    [("state_of", 1), ("record_suspicion", 1, 1.0, "wedge"),
     ("state_of", 1), ("accepting", 1), ("advance", 300.0),
     ("suspicion", 1)] + [("record_suspicion", 1, 1.0, "wedge")] * 4
    + [("accepting", 1), ("draining_replicas",)],
    # eject relaxes to probation, then two clean probes rejoin
    [("mark_ejected", 0, "crash"), ("state_of", 0), ("suspicion", 0),
     ("advance", 601.0), ("state_of", 0), ("accepting", 0),
     ("record_probe_pass", 0), ("record_probe_pass", 0), ("state_of", 0),
     ("suspicion", 0)],
    # a failed probe re-ejects with the suspicion pinned
    [("mark_ejected", 2, "crash"), ("advance", 601.0), ("state_of", 2),
     ("record_probe_pass", 2), ("record_probe_fail", 2, "mismatch"),
     ("state_of", 2), ("suspicion", 2), ("advance", 601.0),
     ("record_probe_pass", 2), ("ejected_replicas",),
     ("probation_replicas",)],
    # placeable and the snapshot, then reset
    [("mark_draining", 1), ("mark_ejected", 2, "crash"),
     ("placeable", range(4)), ("replica_states",), ("reset",),
     ("placeable", range(4))],
], ids=["suspicion_accumulates_decays_and_drains",
        "eject_relaxes_to_probation_then_rejoins",
        "probe_fail_reejects_with_pinned_suspicion",
        "registry_placeable_and_snapshot"])
def test_replica_registry_walks_as_the_reference(events):
    """The four registry cases of the JAX file: the same events give the
    same return values and the same states after each of them."""
    trace = _registry_trace(PORT, events)
    assert trace == _registry_trace(REF, events)
    states = [t[2] for t in trace]
    assert states  # the walk itself is the JAX case's assertions:
    names = [t[0] for t in trace]
    if "mark_draining" in names:
        assert trace[2][1] == (0, 3) and trace[-1][1] == (0, 1, 2, 3)
    if names[:2] == ["state_of", "record_suspicion"]:
        assert trace[0][1] == health.REPLICA_HEALTHY
        assert trace[2][1] == health.REPLICA_SUSPECT
        assert trace[5][1] == 0.5
        assert trace[-3][1] == health.REPLICA_DRAINING
        assert trace[-1][1] == [1]


# -- ReplicaSet routing + verdicts ------------------------------------------

def test_submissions_land_on_affinity_home_and_verdicts_match():
    def scenario(P):
        fs, _clock = P.make_set()
        feds = []
        for i in range(12):
            tenant = ("chain-a", "chain-b", "chain-c")[i % 3]
            bad = i % 4 == 0
            feds.append((fs.submit(P.verifier(tenant, i, bad),
                                   cls="consensus", tenant=tenant),
                         tenant, not bad))
        drain(fs)
        homes = {}
        for f, tenant, want in feds:
            assert f.result(5) == want
            homes.setdefault(tenant, set()).add(f.replica_id)
        assert all(len(rids) == 1 for rids in homes.values())
        assert fs.affinity_hit_rate() == 1.0
        assert fs.totals["spillovers"] == 0
        trace = ([(f.result(0), f.replica_trail) for f, _t, _w in feds],
                 fleet_view(fs))
        fs.close()
        return trace

    both(scenario)


def test_tenant_assignment_lands_in_the_replica_namespaced_cache():
    def scenario(P):
        fs, _clock = P.make_set()
        f = fs.submit(P.verifier("chain-a", 0), tenant="chain-a")
        home = f.replica_id
        digest = P.digest("chain-a")
        assert fs.replicas[home].cache.tenant_of(digest) == "chain-a"
        assert fs.replicas[home].cache.namespace == f"r{home}"
        for rid, rep in fs.replicas.items():
            if rid != home:
                assert rep.cache.tenant_of(digest) == \
                    P.tenancy.DEFAULT_TENANT
        drain(fs)
        trace = (home, outcome(f), fleet_view(fs))
        fs.close()
        return trace

    both(scenario)


def test_overload_spills_to_next_replica_in_affinity_order():
    def scenario(P):
        fs, _clock = P.make_set(capacity=12)
        order = P.routing.replica_affinity_order(
            P.digest("chain-a"), "chain-a", range(3))
        feds = [fs.submit(P.verifier("chain-a", i), cls="consensus",
                          tenant="chain-a") for i in range(6)]
        landed = [f.replica_id for f in feds]
        assert landed[:4] == [order[0]] * 4
        assert landed[4] == order[1]
        assert fs.totals["spillovers"] >= 1
        view = fleet_view(fs)
        drain(fs)
        assert all(f.result(5) is True for f in feds)
        trace = (landed, view, fleet_view(fs))
        fs.close()
        return trace

    both(scenario)


def test_consensus_admitted_while_any_replica_alive():
    def scenario(P):
        fs, _clock = P.make_set(capacity=24)
        for rid in range(3):
            for i in range(4):
                fs.replicas[rid].service.submit(
                    P.verifier("chain-a", 100 * rid + i), cls="mempool")
        with pytest.raises(P.service.Overloaded):
            fs.submit(P.verifier("chain-a", 999), cls="rpc",
                      tenant="chain-a")
        fed = fs.submit(P.verifier("chain-a", 1000), cls="consensus",
                        tenant="chain-a")
        drain(fs)
        assert fed.result(5) is True
        trace = (fed.replica_trail, fleet_view(fs))
        fs.close()
        return trace

    both(scenario)


def test_split_capacity_spills_lower_classes_keeps_consensus():
    def scenario(P):
        fs, _clock = P.make_set()
        order = P.routing.replica_affinity_order(
            P.digest("chain-b"), "chain-b", range(3))
        home = order[0]
        plan = P.faults.replica_plan(7, "split-capacity", replica=home,
                                     at=0, frac=0.25)
        with P.faults.injected(plan):
            fs.process_once()
            assert fs.replicas[home].capacity_fraction() == 0.25
            f_mem = fs.submit(P.verifier("chain-b", 1), cls="mempool",
                              tenant="chain-b")
            f_con = fs.submit(P.verifier("chain-b", 2), cls="consensus",
                              tenant="chain-b")
            assert f_mem.replica_id == order[1]
            assert f_con.replica_id == home
            assert fs.totals["degraded_spills"] >= 1
            drain(fs)
            assert f_mem.result(5) is True and f_con.result(5) is True
            trace = (f_mem.replica_trail, f_con.replica_trail,
                     fleet_view(fs), plan.injection_log())
        fs.close()
        return trace

    both(scenario)


def test_spillover_knob_off_sheds_instead_of_spilling(monkeypatch):
    monkeypatch.setenv("ED25519_TPU_REPLICA_SPILLOVER", "0")

    def scenario(P):
        fs, _clock = P.make_set(capacity=12)
        for i in range(4):
            fs.submit(P.verifier("chain-a", i), cls="mempool",
                      tenant="chain-a")
        with pytest.raises(P.service.Overloaded):
            fs.submit(P.verifier("chain-a", 9), cls="mempool",
                      tenant="chain-a")
        fed = fs.submit(P.verifier("chain-a", 10), cls="consensus",
                        tenant="chain-a")
        assert fed.replica_id is not None
        drain(fs)
        trace = (fed.replica_trail, outcome(fed), fleet_view(fs))
        fs.close()
        return trace

    both(scenario)


# -- whole-replica failover -------------------------------------------------

def crash_home(P, tenant):
    home = P.routing.replica_affinity_order(
        P.digest(tenant), tenant, range(3))[0]
    return home, P.faults.replica_plan(11, "crash", replica=home, at=0)


def test_replica_crash_reissues_queue_zero_lost_host_identical():
    def scenario(P):
        fs, _clock = P.make_set()
        home, plan = crash_home(P, "chain-a")
        feds = []
        for i in range(6):
            bad = i % 3 == 0
            feds.append((fs.submit(P.verifier("chain-a", i, bad),
                                   cls="consensus", tenant="chain-a"),
                         not bad))
        assert all(f.replica_id == home for f, _ in feds)
        with P.faults.injected(plan):
            drain(fs)
            for f, want in feds:
                assert f.result(5) == want
                assert f.replica_id != home
                assert f.replica_trail[0] == home
            st = fs.stats()
            assert st["ejections"] == 1
            assert st["reissued"] == 6
            assert st["replicas"][home]["state"] == P.health.REPLICA_EJECTED
            assert st["error_classes"]["fatal"] == 1
            trace = ([(f.result(0), f.replica_trail) for f, _ in feds],
                     fleet_view(fs), plan.injection_log())
        fs.close()
        return trace

    both(scenario)


def test_crash_drops_the_replica_devcache_namespace():
    def scenario(P):
        fs, _clock = P.make_set()
        home, plan = crash_home(P, "chain-b")
        cache = fs.replicas[home].cache
        cache.build(b"\x07" * 32, 3, np.zeros((4, 20, 8), np.int16))
        assert cache.resident_count() == 1
        f = fs.submit(P.verifier("chain-b", 0), tenant="chain-b")
        with P.faults.injected(plan):
            drain(fs)
        assert cache.resident_count() == 0
        assert cache.counters["drops"] == 1
        trace = (outcome(f), f.replica_trail, fleet_view(fs))
        fs.close()
        return trace

    both(scenario)


def test_crashed_replica_rejoins_via_host_verified_probes():
    def scenario(P):
        fs, clock = P.make_set()
        home, plan = crash_home(P, "chain-a")
        fs.submit(P.verifier("chain-a", 0), cls="consensus",
                  tenant="chain-a")
        views = []
        with P.faults.injected(plan):
            drain(fs)
            assert fs.registry.state_of(home) == P.health.REPLICA_EJECTED
            views.append(fleet_view(fs))
            clock.advance(601.0)
            for _ in range(4):
                fs.process_once()
                views.append(fleet_view(fs))
        st = fs.stats()
        assert st["revivals"] == 1 and st["rejoins"] == 1
        assert st["probes"] >= 2
        assert fs.registry.state_of(home) == P.health.REPLICA_HEALTHY
        f = fs.submit(P.verifier("chain-a", 5), cls="consensus",
                      tenant="chain-a")
        assert f.replica_id == home
        drain(fs)
        assert f.result(5) is True
        trace = (views, fleet_view(fs))
        fs.close()
        return trace

    both(scenario)


def test_wedge_storm_walks_suspect_drain_eject():
    def scenario(P):
        fs, clock = P.make_set()
        victim = 1
        plan = P.faults.replica_plan(3, "wedge", replica=victim, at=0,
                                     length=30, seconds=0.5)
        states = []
        with P.faults.injected(plan):
            fs.process_once()
            assert fs.registry.state_of(victim) == P.health.REPLICA_SUSPECT
            for _ in range(4):
                fs.process_once()
                states.append(fs.registry.replica_states())
            assert fs.registry.state_of(victim) == P.health.REPLICA_EJECTED
            assert fs.error_classes[P.health.ERROR_TRANSIENT] >= 3
        clock.advance(601.0)
        for _ in range(4):
            fs.process_once()
            states.append(fs.registry.replica_states())
        st = fs.stats()
        assert st["rejoins"] == 1 and st["revivals"] == 0
        trace = (states, fleet_view(fs), plan.injection_log())
        fs.close()
        return trace

    both(scenario)


def test_host_floor_when_no_peer_admits_the_reissue():
    """A 2-replica fleet: one crashes while the other is full, so the
    surrendered work is decided on the exact host path — the placement
    floor, the one case the federation decides on the host."""

    def scenario(P):
        clock = P.health.FakeClock()
        fs = P.federation.ReplicaSet(
            2, service_factory=P.host_factory(9), clock=clock,
            capacity_sigs=9)
        a = fs.submit(P.verifier("chain-a", 0), cls="consensus",
                      tenant="chain-a")
        victim = a.replica_id
        other = 1 - victim
        for i in range(3):
            fs.replicas[other].service.submit(
                P.verifier("chain-b", i), cls="consensus")
        plan = P.faults.replica_plan(5, "crash", replica=victim, at=0)
        with P.faults.injected(plan):
            fs.pump_replica(victim)
        assert a.result(5) is True
        assert fs.totals["host_floor"] >= 1
        view = fleet_view(fs)
        drain(fs)
        trace = (a.replica_trail, view, fleet_view(fs))
        fs.close()
        return trace

    both(scenario)


def test_federated_ticket_trail_and_stats_shape():
    def scenario(P):
        fs, _clock = P.make_set()
        f = fs.submit(P.verifier("chain-c", 0), tenant="chain-c")
        assert f.replica_trail == [f.replica_id]
        st = fs.stats()
        assert set(st["replicas"]) == {0, 1, 2}
        for row in st["replicas"].values():
            assert row["state"] == P.health.REPLICA_HEALTHY
            assert 0.0 < row["capacity_fraction"] <= 1.0
        assert st["submitted"] == 1
        drain(fs)
        assert f.result(5) is True
        trace = (f.replica_trail, fleet_view(fs))
        fs.close()
        return trace

    both(scenario)


def test_surrender_pending_returns_queue_without_failing_tickets():
    def scenario(P):
        clock = P.health.FakeClock()
        svc = P.service.VerifyService(
            capacity_sigs=64, clock=clock, auto_start=False, mesh=0,
            health=P.service._HostOnlyHealth(clock), **P.service_kw())
        tickets = [svc.submit(P.verifier("chain-a", i), cls="consensus")
                   for i in range(3)]
        reqs = svc.surrender_pending()
        assert len(reqs) == 3
        assert svc.stats()["queue_requests"] == 0
        assert all(not t.done() for t in tickets)
        assert all(r.verifier.batch_size == 3 and r.cls == "consensus"
                   for r in reqs)
        reqs[0].ticket._resolve(True)
        assert tickets[0].result(0) is True
        st = svc.stats()
        trace = ([r.sigs for r in reqs], st["queue_sigs"],
                 st["shedding_by_class"], st["replica_id"])
        svc.close()
        return trace

    both(scenario)


def test_racing_submission_onto_ejected_replica_is_swept():
    def scenario(P):
        fs, _clock = P.make_set()
        home, plan = crash_home(P, "chain-a")
        with P.faults.injected(plan):
            fs.submit(P.verifier("chain-a", 0), cls="consensus",
                      tenant="chain-a")
            drain(fs)
            assert fs.registry.state_of(home) == P.health.REPLICA_EJECTED
            ejections_before = fs.totals["ejections"]
            rep = fs.replicas[home]
            v = P.verifier("chain-a", 1)
            ticket = rep.service.submit(v, cls="consensus",
                                        tenant="chain-a")
            fed = P.federation.FederatedTicket()
            fed._point_at(ticket, home)
            fs._tracked[home][id(ticket)] = (fed, v, None, "consensus",
                                             "chain-a")
            fs._sweep_ejected(rep)
            drain(fs)
            assert fed.result(5) is True
            assert fed.replica_id != home
            assert fs.totals["ejections"] == ejections_before
            trace = (fed.replica_trail, fleet_view(fs))
        fs.close()
        return trace

    both(scenario)


def test_per_replica_latency_ledger_is_namespaced():
    def scenario(P):
        fs, _clock = P.make_set()
        try:
            assert [fs.replicas[r].latency.namespace for r in (0, 1, 2)] \
                == ["r0", "r1", "r2"]
            f = fs.submit(P.verifier("chain-a", 0), tenant="chain-a")
            drain(fs)
            assert f.result(5) is True
            rows = fs.stats()["replicas"]
            for rid, row in rows.items():
                assert row["latency"]["namespace"] == f"r{rid}"
            pumped = [rid for rid, row in rows.items()
                      if row["latency"].get("samples")]
            assert pumped
            for rid in pumped:
                led = fs.replicas[rid].latency
                assert set(led.chip_stats()) == {rid}
                assert all(isinstance(x, int)
                           for x in led.chip_stats()[rid].values())
            # on a FakeClock every pump takes 0 s: the rows are the same
            return {rid: row["latency"] for rid, row in rows.items()}
        finally:
            fs.close()

    both(scenario)


# -- namespaced verdict stores + the front-door dedup -----------------------

def test_replicas_get_namespaced_verdict_caches():
    fs, _clock = PORT.make_set(3)
    try:
        assert sorted(r.vcache.namespace
                      for r in fs.replicas.values()) == ["r0", "r1", "r2"]
        for r in fs.replicas.values():
            assert r.service.verdict_cache is r.vcache
            assert r.vcache._companion is r.cache
    finally:
        fs.close()


@pytest.mark.parametrize("bad", [False, True])
def test_front_door_dedup_shares_one_ticket(bad):
    """Identical concurrent submissions share ONE federated ticket, for a
    True and a False verdict, as in the JAX package."""

    def scenario(P):
        fs, _clock = P.make_set(3)
        try:
            t1 = fs.submit(P.verifier("chain-a", 1, bad=bad, tag=b"vc"),
                           tenant="chain-a")
            t2 = fs.submit(P.verifier("chain-a", 1, bad=bad, tag=b"vc"),
                           tenant="chain-a")
            t3 = fs.submit(P.verifier("chain-a", 1, bad=bad, tag=b"vc"),
                           tenant="chain-a")
            assert t2 is t1 and t3 is t1
            assert fs.totals["dedup_fanout"] == 2
            assert fs.affinity_hit_rate() == 1.0
            drain(fs)
            assert t1.result(5) is (not bad)
            st = fs.stats()
            assert sum(row["dedup_fanout"]
                       for row in st["replicas"].values()) == 2
            t4 = fs.submit(P.verifier("chain-a", 1, bad=bad, tag=b"vc"),
                           tenant="chain-a")
            assert t4 is not t1
            assert t4.done() and t4.result(0) is (not bad)
            assert fs.totals["dedup_fanout"] == 2
            return fleet_view(fs)
        finally:
            fs.close()

    both(scenario)


def test_front_door_dedup_skips_incompatible_deadlines_and_classes():
    def scenario(P):
        fs, _clock = P.make_set(3)
        try:
            v0 = P.verifier("chain-b", 7, tag=b"vc")
            t1 = fs.submit(v0.clone(), tenant="chain-b",
                           cls=P.tenancy.CLASS_MEMPOOL)
            t2 = fs.submit(v0.clone(), tenant="chain-b",
                           cls=P.tenancy.CLASS_CONSENSUS)
            assert t2 is not t1
            t3 = fs.submit(v0.clone(), tenant="chain-b",
                           cls=P.tenancy.CLASS_MEMPOOL, timeout=5.0)
            assert t3 is not t1
            assert fs.totals["dedup_fanout"] == 0
            drain(fs)
            return ([outcome(t) for t in (t1, t2, t3)], fleet_view(fs))
        finally:
            fs.close()

    both(scenario)


def test_failover_reissue_can_warm_and_hit_the_peers_store():
    def scenario(P):
        fs, _clock = P.make_set(3)
        try:
            v = P.verifier("chain-a", 3, tag=b"vc")
            t1 = fs.submit(v.clone(), tenant="chain-a")
            home = t1.replica_id
            drain(fs)
            assert t1.result(5) is True
            assert fs.replicas[home].vcache.resident_count() == 1
            fs._eject(fs.replicas[home], "test ejection", crashed=True)
            assert fs.replicas[home].vcache.resident_count() == 0
            t2 = fs.submit(v.clone(), tenant="chain-a")
            peer = t2.replica_id
            assert peer != home
            drain(fs)
            assert t2.result(5) is True
            t3 = fs.submit(v.clone(), tenant="chain-a")
            assert t3.replica_id == peer
            assert t3.done() and t3.result(0) is True
            assert fs.replicas[peer].service.stats()[
                "verdict_cache_hits"] == 1
            return (home, peer, fleet_view(fs))
        finally:
            fs.close()

    both(scenario)


# -- namespaced journals and the rejoin pre-warm ----------------------------

def _vc_verifier(P, tag: bytes):
    sk = P.SigningKey.from_seed(hashlib.sha256(b"vcfed-" + tag).digest())
    v = P.batch.Verifier()
    v.queue((sk.verification_key_bytes(), sk.sign(tag), tag))
    return v


def test_federation_namespaced_journals_and_revival_reload(tmp_path):
    def scenario(P):
        d = tmp_path / ("port" if P.port else "jax")
        d.mkdir()
        fs, _clock = P.make_set(2, persist_dir=str(d))
        try:
            for rid in (0, 1):
                rep = fs.replicas[rid]
                assert rep.vcache.journal() is not None
                assert rep.vcache.journal().path == P.persist.journal_path(
                    str(d), f"r{rid}")
            rep = fs.replicas[0]
            rep.vcache.store(_vc_verifier(P, b"p-fed"), True)
            rep.vcache.drop_all("simulated replica crash")
            digest = _vc_verifier(P, b"p-fed").content_digest()
            assert rep.vcache.lookup(digest) is None
            report = P.persist.reload(rep.vcache)
            assert report["absorbed"] == 1
            assert rep.vcache.lookup(digest) is not None
            assert fs.replicas[1].vcache.lookup(digest) is None
            names = sorted(p.name for p in d.iterdir())
            return names, report["absorbed"]
        finally:
            fs.close()

    names, absorbed = both(scenario)
    assert names == ["verdicts-r0.vjournal", "verdicts-r1.vjournal"]
    # the journals cross-read: the reference's r0 journal loads in the port
    vc = verdictcache.VerdictCache(namespace="r0")
    report = persist.attach(vc, directory=str(tmp_path / "jax")) \
        .last_load_report
    assert report["absorbed"] == 1


def test_federation_rejoin_prewarm_imports_peer_hints():
    def scenario(P):
        fs, _clock = P.make_set(3)
        try:
            digest = bytes(range(32))
            peer = fs.replicas[1].cache
            peer._seen.add(digest)
            assert peer.build(digest, 1,
                              np.zeros((1, 40), dtype=np.uint32)) \
                is not None
            assert peer.export_warm_hints() == [digest]
            rep = fs.replicas[0]
            fs._prewarm_from_peers(rep)
            assert fs.totals["prewarm_hits"] == 1
            assert rep.cache.should_build(digest)
            control = bytes(reversed(range(32)))
            assert not rep.cache.should_build(control)
            return totals(fs)
        finally:
            fs.close()

    both(scenario)


def test_prewarm_refuses_malformed_hints():
    for dc in (devcache, jdevcache):
        c = dc.DeviceOperandCache(budget_bytes=1 << 16, enabled=True)
        assert c.import_warm_hints([b"short", 7, b"\x00" * 32]) == (1, 2)
        off = dc.DeviceOperandCache(budget_bytes=1 << 16, enabled=False)
        assert off.import_warm_hints([b"\x00" * 32]) == (0, 1)


def test_lane_death_and_chip_loss_reach_every_namespace():
    """A lane death drops the residency of every live cache — each
    replica's namespace as well as the process default — and a lost chip
    drops the device copies it read in every namespace."""
    caches = [devcache.DeviceOperandCache(budget_bytes=1 << 20,
                                          enabled=True, namespace=ns)
              for ns in ("r0", "r1")]
    devcache.set_default_cache(devcache.DeviceOperandCache(
        budget_bytes=1 << 20, enabled=True))
    for c in caches + [devcache.default_cache()]:
        e = c.build(b"\x05" * 32, 3, np.zeros((4, 20, 8), np.int16))
        e.device_ref("cpu", chips=(2,))
        assert c.stats()["device_bytes"] > 0
    health.notify_chip_drop(2, "test chip loss")
    for c in caches + [devcache.default_cache()]:
        assert c.stats()["device_bytes"] == 0
        assert c.resident_count() == 1
    health.notify_residency_drop("test lane death")
    for c in caches + [devcache.default_cache()]:
        assert c.resident_count() == 0


def test_namespaced_cache_stats_and_gauges():
    from ed25519_consensus_tpu_torch.utils import metrics

    c = devcache.DeviceOperandCache(budget_bytes=1 << 20, enabled=True,
                                    namespace="r7")
    jc = jdevcache.DeviceOperandCache(budget_bytes=1 << 20, enabled=True,
                                      namespace="r7")
    for cache in (c, jc):
        cache.build(b"\x01" * 32, 3, np.zeros((4, 20, 8), np.int16))
    st, jst = c.stats(), jc.stats()
    for k in ("namespace", "resident_bytes", "resident_keysets", "builds"):
        assert st[k] == jst[k], k
    assert metrics.gauges()["devcache_r7_resident_keysets"] == 1
    assert st["device_bytes"] == 0  # no device copy yet


# -- the port's own rules ---------------------------------------------------

def _device_factory(capacity=4096, breaker_failure_threshold=2, chunk=8):
    """Device-route replica services on the CPU (the kernels' plain
    versions), forced-device, each with its own DeviceHealth on the fleet
    clock."""

    def factory(rid, clock, cache):
        return service.VerifyService(
            capacity_sigs=capacity, clock=clock, auto_start=False,
            replica_id=f"r{rid}", cache=cache, mesh=0, hybrid=False,
            merge="never", health=health.DeviceHealth(clock=clock),
            rng=random.Random(rid), device="cpu", chunk=chunk,
            breaker_failure_threshold=breaker_failure_threshold)

    return factory


def test_device_error_wave_is_replica_evidence_never_a_host_verdict(
        monkeypatch):
    """The port's rule: a device wave whose verify_many raised DeviceError
    fails its tickets with it (the JAX service would resolve them from the
    host), and the ReplicaSet lands the error as suspicion against that
    replica, classified by classify_device_error — the host floor and the
    host verdict path never run."""
    monkeypatch.setenv("ED25519_TPU_MIN_LANES", "128")
    host_calls = []
    real_host = batch._host_verdict

    def counting_host(v, rng=None):
        host_calls.append(v)
        return real_host(v, rng)

    monkeypatch.setattr(batch, "_host_verdict", counting_host)
    clock = health.FakeClock()
    fs = federation.ReplicaSet(3, service_factory=_device_factory(),
                               clock=clock)
    try:
        fed = fs.submit(PORT.verifier("chain-a", 0), cls="consensus",
                        tenant="chain-a")
        home = fed.replica_id
        plan = faults.FaultPlan([faults.ErrorOn(on=range(0, 8))], seed=1)
        with faults.injected(plan):
            fs.pump_replica(home)
        with pytest.raises(DeviceError):
            fed.result(5)
        assert fed.replica_trail == [home]  # not re-issued either
        assert fs.totals["device_error_waves"] == 1
        assert fs.totals["host_floor"] == 0 and fs.totals["reissued"] == 0
        ev = health.classify_device_error(
            fs.replicas[home].service.last_device_error)
        assert fs.error_classes[ev.cls] == 1
        assert ev.cls == health.ERROR_AMBIGUOUS
        assert fs.registry.suspicion(home) == pytest.approx(
            health.REPLICA_AMBIGUOUS_SUSPICION)
        assert fs.registry.state_of(home) == health.REPLICA_SUSPECT
        assert not host_calls, "a failed device wave was decided on the host"
        # the replica keeps serving on the device once the fault is gone
        fed2 = fs.submit(PORT.verifier("chain-a", 1), cls="consensus",
                         tenant="chain-a")
        drain(fs)
        assert fed2.result(5) is True
        assert not host_calls
    finally:
        fs.close()


def test_device_error_evidence_walks_the_ladder_to_drain_and_eject(
        monkeypatch):
    """Repeated DeviceError waves accumulate ambiguous suspicion until the
    replica drains and, drained empty, is ejected — every failed ticket
    still carries its DeviceError.  (The breaker threshold is raised so
    every wave stays on the device route.)"""
    monkeypatch.setenv("ED25519_TPU_MIN_LANES", "128")
    clock = health.FakeClock()
    fs = federation.ReplicaSet(
        3, service_factory=_device_factory(breaker_failure_threshold=100),
        clock=clock)
    try:
        home = None
        outcomes = []
        plan = faults.FaultPlan([faults.ErrorOn(on=lambda i: True)], seed=2)
        with faults.injected(plan):
            for i in range(6):
                fed = fs.submit(PORT.verifier("chain-b", i), cls="consensus",
                                tenant="chain-b")
                home = fed.replica_id if home is None else home
                if fed.replica_id != home:
                    break
                fs.process_once()
                outcomes.append(outcome(fed))
        assert set(outcomes) == {"DeviceError"}
        assert fs.totals["drains_started"] == 1
        assert fs.registry.state_of(home) == health.REPLICA_EJECTED
        assert fs.error_classes[health.ERROR_AMBIGUOUS] == len(outcomes)
        assert len(outcomes) == int(
            config.get("ED25519_TPU_REPLICA_SUSPICION_THRESHOLD")
            / health.REPLICA_AMBIGUOUS_SUSPICION)
    finally:
        fs.close()


def test_replicas_on_one_device_share_its_lane_unpoisoned(monkeypatch):
    """Replica services on one device share its lane: a chunk error in one
    replica's wave (raised DeviceError) leaves the next replica's chunk
    to run on that lane and decide on the device — each replica has its
    own DeviceHealth, so one's cooldown is not another's."""
    monkeypatch.setenv("ED25519_TPU_MIN_LANES", "128")
    clock = health.FakeClock()
    fs = federation.ReplicaSet(3, service_factory=_device_factory(),
                               clock=clock)
    try:
        feds = {t: fs.submit(PORT.verifier(t, 0, bad=(t == "chain-c")),
                             cls="consensus", tenant=t)
                for t in ("chain-a", "chain-b", "chain-c")}
        homes = {t: f.replica_id for t, f in feds.items()}
        first = min(homes.values())
        plan = faults.FaultPlan([faults.ErrorOn(on=0)], seed=3)
        with faults.injected(plan):
            drain(fs)
        got = {t: outcome(f) for t, f in feds.items()}
        for t, rid in homes.items():
            if rid == first:
                assert got[t] == "DeviceError"
            else:
                assert got[t] == (t != "chain-c")
                st = fs.replicas[rid].service.wave_stats[-1]
                assert st[0] == "device"
                assert st[1]["device_batches"] \
                    + st[1]["device_rejects_confirmed"] >= 1
    finally:
        fs.close()


def test_eject_frees_its_namespace_device_tensors_and_no_peers(monkeypatch):
    """Residency is per replica: each home builds its keyset's entries in
    its own namespace through `verify_many(cache=)`, the device copies are
    counted per namespace, and ejecting one replica drops exactly its
    bytes.  One batch a chunk: only a keyset-uniform chunk touches the
    cache, and two chains may share a home."""
    monkeypatch.setenv("ED25519_TPU_MIN_LANES", "128")
    clock = health.FakeClock()
    fs = federation.ReplicaSet(3, service_factory=_device_factory(chunk=1),
                               clock=clock)
    try:
        tenants = ("chain-a", "chain-b", "chain-c")
        for i in range(4):  # sightings 1-2 cold, then resident
            feds = [fs.submit(PORT.verifier(t, i), cls="consensus",
                              tenant=t) for t in tenants]
            drain(fs)
            assert all(f.result(5) is True for f in feds)
        before = {rid: rep.cache.stats()
                  for rid, rep in fs.replicas.items()}
        homes = {fs.submit(PORT.verifier(t, 9), cls="consensus",
                           tenant=t).replica_id for t in tenants}
        drain(fs)
        for rid in homes:
            assert before[rid]["resident_keysets"] >= 1
            assert before[rid]["device_bytes"] > 0
            assert before[rid]["namespace"] == f"r{rid}"
        victim = min(homes)
        fs._eject(fs.replicas[victim], "test ejection", crashed=True)
        after = {rid: rep.cache.stats()
                 for rid, rep in fs.replicas.items()}
        assert after[victim]["device_bytes"] == 0
        assert after[victim]["resident_keysets"] == 0
        for rid in homes - {victim}:
            assert after[rid]["device_bytes"] > 0
            assert after[rid]["resident_keysets"] == \
                before[rid]["resident_keysets"]
        # the process default cache held none of it
        assert devcache.default_cache().resident_count() == 0
    finally:
        fs.close()


def test_fleet_state_carries_across_from_the_reference():
    """A JAX fleet's ladder state and warm hints, carried into the port,
    give the same states and the same second-sight answers."""
    jclock = jhealth.FakeClock()
    jreg = jhealth.ReplicaRegistry(clock=jclock)
    jreg.record_suspicion(0, 1.0)
    jreg.mark_draining(1)
    jreg.mark_ejected(2)
    jreg.mark_ejected(3)
    jclock.advance(601.0)
    jreg.record_probe_pass(3)
    snap = jreg.replica_states()
    assert snap[3]["state"] == jhealth.REPLICA_PROBATION
    clock = health.FakeClock()
    reg = carry.replica_registry_from_reference(snap, clock=clock)
    assert reg.replica_states() == snap
    assert reg.placeable(range(5)) == jreg.placeable(range(5))
    # one more clean probe rejoins replica 3 in both
    assert reg.record_probe_pass(3) is jreg.record_probe_pass(3) is True
    assert reg.replica_states() == jreg.replica_states()

    jc = jdevcache.DeviceOperandCache(budget_bytes=1 << 20, enabled=True)
    digest = bytes(range(32))
    jc._seen.add(digest)
    jc.build(digest, 1, np.zeros((1, 40), dtype=np.uint32))
    c = devcache.DeviceOperandCache(budget_bytes=1 << 20, enabled=True)
    assert carry.warm_hints_from_reference(jc.export_warm_hints(), c) \
        == (1, 0)
    assert c.should_build(digest)


@pytest.mark.parametrize("name", [
    "ED25519_TPU_REPLICA_SUSPICION_THRESHOLD",
    "ED25519_TPU_REPLICA_SUSPICION_HALF_LIFE",
    "ED25519_TPU_REPLICA_PROBES", "ED25519_TPU_REPLICA_SPILLOVER",
    "ED25519_TPU_REPLICA_DEGRADED_FRAC"])
def test_replica_knob_matches_the_reference(name, monkeypatch):
    mine, ref = config.KNOBS[name], jconfig.KNOBS[name]
    assert (mine.type, mine.default) == (ref.type, ref.default)
    assert config.get(name) == jconfig.get(name)
    monkeypatch.setenv(name, "0")
    assert config.get(name) == jconfig.get(name)


def test_replica_faults_classify_as_the_reference():
    """The replica errors, and the port's DeviceError, classify as the JAX
    classifier classifies them."""
    for mine, ref in ((faults.ReplicaCrashError("x", replica=2),
                       jfaults.ReplicaCrashError("x", replica=2)),
                      (faults.ReplicaWedgeError("x", replica=1),
                       jfaults.ReplicaWedgeError("x", replica=1))):
        a, b = health.classify_device_error(mine), \
            jhealth.classify_device_error(ref)
        assert (a.cls, a.reason) == (b.cls, b.reason)
        assert mine.replica == ref.replica
    ev = health.classify_device_error(DeviceError("a chunk failed"))
    assert ev.cls == jhealth.classify_device_error(
        RuntimeError("a chunk failed")).cls == health.ERROR_AMBIGUOUS
    for kind, kw in (("crash", {}), ("wedge", {"length": 3}),
                     ("split-capacity", {"frac": 0.25})):
        mine = faults.replica_plan(5, kind, replica=1, at=2, **kw)
        ref = jfaults.replica_plan(5, kind, replica=1, at=2, **kw)
        assert [type(f).__name__ for f in mine.faults] == \
            [type(f).__name__ for f in ref.faults]
        assert [f.fires_on(i) for f in mine.faults for i in range(8)] == \
            [f.fires_on(i) for f in ref.faults for i in range(8)]
    with pytest.raises(ValueError):
        faults.replica_plan(5, "nope")
    for kind in ("chip-loss", "link-flap"):
        mine = faults.mesh_plan(5, kind, chips=(3, 4), at=1, stagger=2)
        ref = jfaults.mesh_plan(5, kind, chips=(3, 4), at=1, stagger=2)
        assert [type(f).__name__ for f in mine.faults] == \
            [type(f).__name__ for f in ref.faults]
        assert [f.fires_on(i) for f in mine.faults for i in range(8)] == \
            [f.fires_on(i) for f in ref.faults for i in range(8)]


def test_link_flap_marks_and_heals_as_the_reference():
    clock = health.FakeClock()
    health.chip_registry().set_clock(clock)
    plan = faults.mesh_plan(1, "link-flap", chips=(2,), period=2)
    seen = []
    for i in range(6):
        try:
            plan.run(faults.SITE_SHARDED, lambda: "ok")
            seen.append("up")
        except faults.FatalChipError as exc:
            seen.append(exc.chips)
        seen.append(sorted(health.chip_registry().excluded_chips()))
    assert seen == ["up", [], "up", [], (2,), [2], (2,), [2], "up", [],
                    "up", []]
