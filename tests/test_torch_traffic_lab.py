"""The port's open-loop traffic lab and mesh-chaos lab
(`ed25519_consensus_tpu_torch.tools.traffic_lab`, `.mesh_chaos`) against
the JAX tools: the cases of tests/test_traffic_lab.py on the port, and the
replay digests of `run_lab` and `run_fleet` (with and without
--replica-crash) equal to the JAX tool's at the pinned service rate and
seed; plus the mesh-chaos storm at test size on logical chips of the CPU,
mirroring tests/test_mesh_degrade.py's reformation case.

Every run pins its virtual service rate, so each is a pure function of the
seed.  The single-service `--device` case runs the kernels' plain versions
on the CPU and stays slow-marked, as in the JAX file."""

import argparse
import importlib.util
import random
import sys
from pathlib import Path

import pytest

from ed25519_consensus_tpu import batch as jbatch
from ed25519_consensus_tpu import devcache as jdevcache
from ed25519_consensus_tpu import tenancy as jtenancy
from ed25519_consensus_tpu_torch import (batch, devcache, faults, health,
                                         routing, tenancy)
from ed25519_consensus_tpu_torch.tools import mesh_chaos, traffic_lab as lab
from ed25519_consensus_tpu_torch.utils import metrics

from torch_threads import _one_torch_thread  # noqa: F401


ROOT = Path(__file__).resolve().parent.parent


def _load_reference_lab():
    tools_dir = str(ROOT / "tools")
    if tools_dir not in sys.path:
        sys.path.insert(0, tools_dir)
    spec = importlib.util.spec_from_file_location(
        "_reference_traffic_lab", ROOT / "tools" / "traffic_lab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load_reference_lab()


@pytest.fixture(autouse=True)
def reset_state():
    def reset():
        devcache.set_default_cache(None)
        jdevcache.set_default_cache(None)
        batch.reset_device_health()
        jbatch.reset_device_health()
        batch.last_run_stats.clear()

    reset()
    yield
    if faults.active_plan():
        faults.uninstall()
    batch._DeviceLane.reset_all()
    reset()


def make_cfg(**over):
    """The namespace run_lab consumes, test-sized: pinned virtual rate
    (bit-reproducible), host only."""
    cfg = argparse.Namespace(
        seed=0x7AFF1C, requests=150, load=0.8,
        service_rate=50_000.0, capacity_frac=0.05,
        wave_max_batches=16, wave_overhead=0.02,
        device=False, rotate_every_frac=0.25, rotation_faults=False,
        require_rpc_shed=True, json=False)
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def make_fleet_cfg(**over):
    cfg = make_cfg(fleet=3, chains=12, requests=300,
                   service_rate=20_000.0, load=0.7,
                   replica_crash=False, affinity_target=0.5)
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def test_schedule_is_deterministic_and_open_loop():
    matrix = tenancy.default_matrix()
    s1, h1 = lab.build_schedule(matrix, 7, 200, 0.8, 50_000.0)
    s2, h2 = lab.build_schedule(matrix, 7, 200, 0.8, 50_000.0)
    s3, _ = lab.build_schedule(matrix, 8, 200, 0.8, 50_000.0)
    assert s1 == s2 and h1 == h2
    assert s1 != s3
    assert s1 == sorted(s1)
    assert {si for _, si, _ in s1} == set(range(len(matrix)))
    assert 0.5 * 200 < len(s1) < 2.0 * 200
    # the JAX tool's schedule, event for event
    assert (s1, h1) == ref.build_schedule(jtenancy.default_matrix(), 7, 200,
                                          0.8, 50_000.0)


def test_lab_zero_lost_host_identical_and_replay_digest():
    s1 = lab.run_lab(make_cfg())
    s2 = lab.run_lab(make_cfg())
    assert s1["lost"] == 0
    assert s1["verdict_mismatches"] == 0
    assert s1["replay_digest"] == s2["replay_digest"]
    s3 = lab.run_lab(make_cfg(seed=0xD1FF))
    assert s3["replay_digest"] != s1["replay_digest"]
    for row in s1["by_class"].values():
        assert row["requests"] == (row["verdicts"] + row["overloaded"]
                                   + row["shed_deadline"])
    # the JAX tool's run: the same digest, classes and breaker
    r = ref.run_lab(make_cfg())
    assert s1["replay_digest"] == r["replay_digest"]
    assert s1["by_class"] == r["by_class"]
    assert (s1["waves"], s1["breaker_transitions"], s1["gates"]) == \
        (r["waves"], r["breaker_transitions"], r["gates"])


def test_overload_sheds_rpc_first_consensus_p99_holds():
    s = lab.run_lab(make_cfg())
    cons = s["by_class"][tenancy.CLASS_CONSENSUS]
    rpc = s["by_class"][tenancy.CLASS_RPC]
    assert cons["shed_rate"] == 0.0
    assert cons["overloaded"] == 0 and cons["shed_deadline"] == 0
    assert rpc["shed_rate"] > 0.0, s["by_class"]
    assert cons["latency_s"]["p99"] < cons["deadline_s"]
    assert s["gates"]["consensus_shed_rate_zero"]
    assert s["gates"]["rpc_sheds_under_overload"]
    assert s["ok"], s["gates"]


def test_slo_gate_fails_loudly_on_broken_envelope():
    s = lab.run_lab(make_cfg(load=8.0, requests=120))
    assert not s["gates"]["consensus_shed_rate_zero"] or \
        not s["gates"]["consensus_p99_under_deadline"]
    assert s["ok"] is False
    assert s["lost"] == 0 and s["verdict_mismatches"] == 0
    assert s["replay_digest"] == ref.run_lab(
        make_cfg(load=8.0, requests=120))["replay_digest"]


def test_percentiles_nearest_rank():
    from ed25519_consensus_tpu.utils import metrics as jmetrics

    vals = list(range(1, 101))
    random.Random(3).shuffle(vals)
    p = metrics.percentiles(vals)
    assert p[0.5] == 50 and p[0.99] == 99 and p[0.999] == 100
    assert metrics.percentiles([])[0.5] is None
    assert metrics.percentiles([7.0]) == {0.5: 7.0, 0.99: 7.0, 0.999: 7.0}
    xs = [random.Random(5).random() for _ in range(37)]
    assert metrics.percentiles(xs, (0.1, 0.5, 0.9)) == \
        jmetrics.percentiles(xs, (0.1, 0.5, 0.9))


def test_load_sweep_emits_invariant_gated_curve():
    assert lab.parse_load_sweep("0.5:1.2:8") == [
        0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2]
    assert lab.parse_load_sweep("0.5,1.2") == [0.5, 1.2]
    assert lab.parse_load_sweep("") == []
    sweep = lab.run_load_sweep(make_cfg(requests=80), [0.5, 1.2])
    assert sweep["ok"], sweep
    curve = sweep["curve"]
    assert [pt["load"] for pt in curve] == [0.5, 1.2]
    for pt in curve:
        assert all(pt["invariants"].values()), pt
        assert pt["shed_rate_by_class"]["consensus"] == 0.0
    assert curve[1]["shed_rate_by_class"]["rpc"] >= \
        curve[0]["shed_rate_by_class"]["rpc"]
    assert curve == ref.run_load_sweep(make_cfg(requests=80),
                                       [0.5, 1.2])["curve"]


@pytest.mark.slow
def test_lab_device_mode_reports_tenant_hit_rates(monkeypatch):
    """--device on the CPU (the kernels' plain versions): waves dispatch
    forced-device one batch a chunk with per-tenant devcache partitions
    and rotation faults; zero lost, host-identical, and the hot tenants'
    hit rates publish."""
    monkeypatch.setenv("ED25519_TPU_MIN_LANES", "128")
    s = lab.run_lab(make_cfg(requests=80, device=True,
                             rotation_faults=True,
                             require_rpc_shed=False, torch_device="cpu"))
    assert s["lost"] == 0 and s["verdict_mismatches"] == 0
    assert s["by_tenant_devcache"], "tenant hit rates must publish"
    assert s["devcache"]["tenant_rotations"] >= 1


# -- fleet mode ---------------------------------------------------------------


def test_fleet_zero_lost_host_identical_and_replay_digest():
    s1 = lab.run_fleet(make_fleet_cfg())
    s2 = lab.run_fleet(make_fleet_cfg())
    assert s1["lost"] == 0
    assert s1["verdict_mismatches"] == 0
    assert s1["ok"], s1["gates"]
    assert s1["replay_digest"] == s2["replay_digest"]
    assert s1["affinity_hit_rate"] >= 0.5
    assert s1["requests"] > 0
    r = ref.run_fleet(make_fleet_cfg())
    assert s1["replay_digest"] == r["replay_digest"]
    assert s1["by_replica"] == r["by_replica"]


def test_fleet_replica_crash_reissues_and_rejoins():
    """Killing 1 of 3 replicas mid-run loses nothing, verdicts stay
    host-identical, consensus never sheds while rpc sheds on the
    survivors, and the ejected replica rejoins through probes with the
    post-rejoin affinity back over target — the JAX tool's run, digest for
    digest."""
    s1 = lab.run_fleet(make_fleet_cfg(replica_crash=True))
    assert s1["ok"], s1["gates"]
    g = s1["gates"]
    assert g["zero_lost"] and g["host_identical_verdicts"]
    assert g["consensus_shed_rate_zero"]
    assert g["replica_ejected"] and g["replica_rejoined"]
    assert g["rpc_sheds_on_survivors"]
    assert g["tail_affinity_recovered"]
    fed = s1["federation"]
    assert fed["ejections"] >= 1 and fed["rejoins"] >= 1
    assert fed["device_error_waves"] == 0
    s2 = lab.run_fleet(make_fleet_cfg(replica_crash=True))
    assert s1["replay_digest"] == s2["replay_digest"]
    r = ref.run_fleet(make_fleet_cfg(replica_crash=True))
    assert s1["replay_digest"] == r["replay_digest"]
    assert s1["crash_state"] == r["crash_state"]
    assert {k: v for k, v in fed.items() if k != "device_error_waves"} \
        == r["federation"]


def test_fleet_matrix_shape_and_zipf_skew():
    m = tenancy.fleet_matrix(50)
    assert len(m) == 150
    assert abs(sum(s.fraction for s in m) - 1.0) < 1e-9
    tenants = [s.tenant for s in m]
    assert len(set(tenants)) == 50
    head = sum(s.fraction for s in m if s.tenant == "chain-000")
    tail = sum(s.fraction for s in m if s.tenant == "chain-049")
    assert head > 5 * tail
    for t in ("chain-000", "chain-049"):
        assert {s.cls for s in m if s.tenant == t} == set(tenancy.CLASSES)


def test_main_parses_the_reference_command_line(capsys):
    """The port's CLI takes the JAX tool's flags; a fleet seed defaults to
    the JAX fleet knob's default."""
    cfg = lab.parse_args(["--fleet", "3", "--replica-crash"])
    assert (cfg.fleet, cfg.replica_crash, cfg.requests, cfg.chains,
            cfg.seed) == (3, True, 800, 50, lab.DEFAULT_SEED)
    from ed25519_consensus_tpu import config as jconfig

    assert lab.DEFAULT_SEED == \
        jconfig.KNOBS["ED25519_TPU_TRAFFIC_LAB_SEED"].default
    assert lab.FLEET_SEED == jconfig.KNOBS["ED25519_TPU_FLEET_LAB_SEED"].default
    cfg = lab.parse_args(["--device", "--torch-device", "cpu"])
    assert cfg.device and cfg.torch_device == "cpu"
    small = lab.parse_args(["--fleet", "3", "--chains", "12", "--requests",
                            "120", "--service-rate", "20000"])
    s = lab.run(small)
    assert small.seed == lab.FLEET_SEED
    line = lab.headline(small, s)
    assert line["metric"] == "fleet_slo" and line["ok"] == s["ok"]


# -- mesh chaos ---------------------------------------------------------------


def test_mesh_chaos_storm_reforms_each_rung_and_rejoins(monkeypatch):
    """The reformation storm at the tool's 8 logical chips on the CPU: 1,
    then 3, then 7 chips die mid-wave; each wave reforms (8 → 4 → 2 → the
    single lane), re-issues and is decided on the device with the host
    oracle's verdicts; after the heal window the full mesh runs again."""
    monkeypatch.setenv("ED25519_TPU_MIN_LANES", "128")
    monkeypatch.setattr(routing, "_device_count", [8])
    out = mesh_chaos.run_reformation_storm(mesh_chaos.DEFAULT_SEED,
                                           devices=8, device="cpu")
    assert out["ok"], out
    assert [s["mesh_after"] for s in out["stages"]] == [4, 2, 0]
    for s in out["stages"]:
        assert s["host_identical"] and s["zero_lost"]
        assert s["reissued"] >= 2 and s["device_participated"] >= 1
    assert out["stages"][-1]["dead"] == [1, 2, 3, 4, 5, 6, 7]
    assert out["rejoin"]["mesh"] == 8 and not out["rejoin"]["reformations"]
    assert not health.chip_registry().excluded_chips()


def test_mesh_chaos_degraded_slo_holds_at_every_rung():
    cfg = mesh_chaos.parse_args(["--device", "cpu", "--skip-storm",
                                 "--requests", "120",
                                 "--service-rate", "50000"])
    s = mesh_chaos.chaos(cfg)
    assert s["ok"], s
    rungs = s["degraded_slo"]["rungs"]
    assert [r["rung"] for r in rungs] == ["full", "half", "one-chip"]
    for r in rungs:
        assert r["gates"]["zero_lost"] and r["gates"]["consensus_shed_rate_zero"]
    line = mesh_chaos.headline(s)
    assert line["metric"] == "mesh_chaos" and line["storm_ok"] is None
    assert mesh_chaos.DEFAULT_SEED == 0xC41905


def test_calibrated_schedule_is_drawn_independent_of_the_measured_rate():
    """A calibrated rate draws at CALIBRATED_DRAW_RATE and scales: the same
    events in the same order at any measured rate, times scaled by it; a
    pinned rate keeps the JAX tool's draw."""
    matrix = tenancy.default_matrix()
    draw = lab.CALIBRATED_DRAW_RATE
    s1, h1 = lab.build_schedule(matrix, 7, 200, 0.8, 15_000.0, draw)
    s2, h2 = lab.build_schedule(matrix, 7, 200, 0.8, 35_000.0, draw)
    assert [e[1:] for e in s1] == [e[1:] for e in s2]
    assert h1 * 15_000.0 == pytest.approx(h2 * 35_000.0, rel=1e-12)
    for (t1, _, _), (t2, _, _) in zip(s1, s2):
        assert t1 * 15_000.0 == pytest.approx(t2 * 35_000.0, rel=1e-12)
    assert lab.build_schedule(matrix, 7, 200, 0.8, 50_000.0, None) == \
        lab.build_schedule(matrix, 7, 200, 0.8, 50_000.0)
    assert lab.service_rate(make_cfg()) == (50_000.0, None)


def _outcome(summary):
    return ({c: (row["requests"], row["shed_rate"])
             for c, row in summary["by_class"].items()}, summary["gates"],
            summary.get("affinity_hit_rate"))


@pytest.mark.parametrize("mode", ["lab", "fleet", "mesh_chaos"])
def test_calibrated_run_outcome_does_not_follow_the_host_speed(
        monkeypatch, mode):
    """Two calibrations that differ (a faster and a slower host) give the
    same sheds, verdicts and gates: the outcome is a pure function of the
    seed, only the times follow the measured rate."""
    outcomes = []
    for measured in (15_000.0, 35_000.0):
        monkeypatch.setattr(lab, "calibrate_service_rate",
                            lambda seed, m=measured: m)
        if mode == "lab":
            s = lab.run_lab(make_cfg(service_rate=0.0))
            outcomes.append((_outcome(s), {
                c: (row["verdicts"], row["overloaded"], row["shed_deadline"])
                for c, row in s["by_class"].items()}))
        elif mode == "fleet":
            s = lab.run_fleet(make_fleet_cfg(service_rate=0.0,
                                             replica_crash=True))
            outcomes.append(_outcome(s))
        else:
            s = mesh_chaos.run_degraded_slo(mesh_chaos.parse_args(
                ["--device", "cpu", "--skip-storm", "--requests", "120"]))
            assert s["service_rate_sigs_per_s"] == measured
            outcomes.append([(r["gates"], r["shed_rate_by_class"])
                             for r in s["rungs"]])
    assert outcomes[0] == outcomes[1]
