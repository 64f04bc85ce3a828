"""The port's gray-failure labs on the CPU, at a reduced size through their
own arguments (tools/straggler_lab.py, tools/sentinel_soak.py and
tools/load_soak.py's slowchip storm): three or four logical chips instead
of eight, ED25519_TPU_STRAGGLER_MIN_SAMPLES lowered to 2, one soak round.
Every gate of every phase must hold, as at full size on the card
(chip_smoke.py's phase_gray runs them at the JAX tools' defaults)."""

import pytest

from ed25519_consensus_tpu import config as jconfig
from ed25519_consensus_tpu_torch import batch, config, health, routing
from ed25519_consensus_tpu_torch.tools import (load_soak, sentinel_soak,
                                               straggler_lab)

from torch_threads import _one_torch_thread  # noqa: F401


SEED = 0x6A7


@pytest.fixture(autouse=True)
def reset_state(monkeypatch):
    monkeypatch.setattr(routing, "_device_count", [4])
    batch.reset_device_health()
    yield
    batch._DeviceLane.reset_all()
    batch.reset_device_health()
    batch.last_run_stats.clear()


def test_lab_defaults_equal_the_reference_tools():
    s = straggler_lab.parse_args([])
    assert s.seed == jconfig.KNOBS["ED25519_TPU_STRAGGLER_LAB_SEED"].default
    assert (s.devices, s.chip, s.min_samples, s.device) == (8, 5, 4, "cuda")
    t = sentinel_soak.parse_args([])
    assert t.seed == jconfig.KNOBS["ED25519_TPU_SENTINEL_SOAK_SEED"].default
    assert (t.devices, t.chip, t.transient_chip, t.device) == \
        (8, 5, 3, "cuda")
    assert (straggler_lab.BASE_S, straggler_lab.SLOW_S) == (0.010, 0.090)
    with config.override(ED25519_TPU_STRAGGLER_MIN_SAMPLES=4):
        assert straggler_lab.quarantine_round_bound() == 16
    assert sentinel_soak.waves_to_quarantine() == 2


def test_straggler_lab_persistent_straggler_is_quarantined():
    with config.override(ED25519_TPU_STRAGGLER_MIN_SAMPLES=2):
        r = straggler_lab.run_persistent_straggler(SEED, devices=3, chip=1,
                                                   device="cpu")
    assert r["ok"], r
    assert r["detected_at_round"] < r["round_bound"] == 8
    assert r["straggler_events"] == {1: 3} and r["survivors"] == 2
    assert r["consensus_p99_us"] == r["healthy_p99_us"] == 10000


def test_straggler_lab_gray_flap_never_accrues():
    with config.override(ED25519_TPU_STRAGGLER_MIN_SAMPLES=2):
        r = straggler_lab.run_gray_flap(SEED, devices=3, chip=1,
                                        device="cpu")
    assert r["ok"], r
    assert (r["rounds"], r["straggler_events"], r["state"]) == \
        (6, 0, health.STATE_HEALTHY)


def test_straggler_lab_hedge_phase_under_the_ports_rule():
    r = straggler_lab.run_hedge_phase(SEED, device="cpu")
    assert r["ok"], r
    d = r["deadline"]
    assert d["got"] == d["want"] and d["inside_deadline"]
    assert (d["hedges_fired"], d["hedges_won"], d["hedges_lost"],
            d["device_decided_batches"]) == (1, 1, 0, 0)
    assert r["race"]["got"] == r["race"]["want"]
    assert r["race"]["device_accepts"] == 0


def test_sentinel_soak_persistent_corruptor():
    r = sentinel_soak.run_persistent_corruptor(SEED, devices=4, chip=1,
                                               device="cpu")
    assert r["ok"], r
    assert r["detected_at_wave"] == 1 and r["raised_waves"] == 2
    assert r["attributions"] == [1, 1]
    re = r["reformed"]
    assert (re["available_chips"], re["reformed_rung"], re["mesh_after"],
            re["stats_device_ids"]) == (3, 2, 2, [0, 2])
    assert r["service"]["effective_capacity_sigs"] == 4000
    assert r["flip_accept"]["attributed"] == [0]


def test_sentinel_soak_transient_corruptor_rejoins():
    r = sentinel_soak.run_transient_corruptor(SEED, devices=4, chip=3,
                                              device="cpu")
    assert r["ok"], r
    assert r["probes"] == [True] * config.get("ED25519_TPU_PROBATION_PROBES")
    assert r["rejoin_wave"]["mesh"] == 4
    assert r["rejoin_wave"]["reformations"] == []


def test_load_soak_slowchip_storm_loses_nothing():
    args = load_soak.parse_args(["--device", "cpu", "--storm", "slowchip",
                                 "--rounds", "1", "--submitters", "2"])
    summary = load_soak.soak(args)
    assert summary["ok"], summary
    assert summary["injected"] > 0 and summary["verdicts"] > 0
    assert summary["crash"] == summary["device_error"] == 0
