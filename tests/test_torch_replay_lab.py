"""The port's service tools on the CPU:

* the replay lab (ed25519_consensus_tpu_torch/tools/replay_lab.py), the
  seeded mempool→block→vote-replay scenario on a FakeClock, gives the
  JAX lab's replay digest, per-run accounting and `verdict_memo` block at
  the same seed and sizes — memo on, memo off and under every
  SITE_VERDICTCACHE storm — and passes its own gates;
* a short overload soak (tools/load_soak.py) with `--device cpu` loses
  nothing and returns host-identical verdicts, through an error storm
  that takes the device-error rung (its tickets carry the DeviceError)
  and a fault-free overload round;
* the restart lab (tools/restart_lab.py), the seeded hard kill and revive
  from the verdict journal, gives the JAX lab's replay digest, load
  reports (absorbed and dropped records) and warmth for the clean
  scenario, the cold control and each of the five SITE_PERSIST storms at
  the JAX lab's test config, and passes its own gates."""

import argparse
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

from ed25519_consensus_tpu import config as jconfig
from ed25519_consensus_tpu import devcache as jdevcache
from ed25519_consensus_tpu import verdictcache as jverdictcache
from ed25519_consensus_tpu_torch import devcache, verdictcache
from ed25519_consensus_tpu_torch.tools import load_soak
from ed25519_consensus_tpu_torch.tools import replay_lab, restart_lab

from torch_threads import _one_torch_thread  # noqa: F401


ROOT = Path(__file__).resolve().parent.parent


def _reference_lab(name="replay_lab"):
    tools_dir = str(ROOT / "tools")
    if tools_dir not in sys.path:
        sys.path.insert(0, tools_dir)
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def reset_default_caches():
    """Epochs and default caches are per package: both packages' defaults
    go back to fresh after every test."""
    yield
    for dc, vc in ((devcache, verdictcache), (jdevcache, jverdictcache)):
        dc.set_default_cache(None)
        vc.set_default_cache(None)


def _cfg(**kw):
    cfg = vars(replay_lab.parse_args([]))
    cfg.update(txs=16, sigs=3, **kw)
    return argparse.Namespace(**cfg)


_RUN_KEYS = ("requests", "lost", "verdict_mismatches", "replayed_legs",
             "replayed_hits", "replayed_hit_rate", "device_seconds",
             "consensus_sigs", "effective_consensus_sigs_per_s",
             "verdict_cache_hits", "verdict_cache_stores", "waves",
             "replay_digest")


@pytest.mark.parametrize("seed", [replay_lab.DEFAULT_SEED, 7])
def test_replay_lab_equals_reference_lab(seed):
    port = replay_lab.run_lab(_cfg(seed=seed))
    ref = _reference_lab().run_lab(_cfg(seed=seed))
    # the port's default seed is the JAX lab's (its knob's default)
    assert replay_lab.parse_args([]).seed == jconfig.KNOBS[
        "ED25519_TPU_REPLAY_LAB_SEED"].default == replay_lab.DEFAULT_SEED
    assert port["ok"] and ref["ok"]
    assert port["gates"] == ref["gates"]
    assert port["replay_digest"] == ref["replay_digest"]
    assert port["speedup"] == ref["speedup"]
    for name in ("memo", "baseline"):
        for k in _RUN_KEYS:
            assert port[name][k] == ref[name][k], (name, k)
    for kind, run in port["storms"].items():
        for k in _RUN_KEYS:
            assert run[k] == ref["storms"][kind][k], (kind, k)
        for k in ("hits", "misses", "stores", "rehash_mismatch",
                  "stale_epoch", "evictions", "drops"):
            assert run["verdictcache"][k] == \
                ref["storms"][kind]["verdictcache"][k], (kind, k)


def test_replay_lab_main_prints_the_memo_block():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-m", "ed25519_consensus_tpu_torch.tools.replay_lab",
         "--txs", "8", "--sigs", "2"], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert '"metric": "verdict_memo"' in r.stdout
    assert "VERDICT_MEMO" in r.stdout


@pytest.mark.parametrize("storm,rounds", [("error", 1), ("none", 1)])
def test_load_soak_on_the_cpu_loses_nothing(storm, rounds):
    args = load_soak.parse_args(["--device", "cpu", "--storm", storm,
                                 "--rounds", str(rounds)])
    summary = load_soak.soak(args)
    assert summary["ok"], summary
    assert summary["verdicts"] > 0 and summary["crash_fallbacks"] == 0
    assert summary["crash"] == 0
    if storm == "error":
        assert summary["injected"] > 0
        assert summary["device_error_waves"] > 0
        assert summary["device_error"] > 0
    else:
        assert summary["device_error"] == 0


# -- the restart lab --------------------------------------------------------


def _restart_cfg(**kw):
    """tests/test_restart_lab.py's config."""
    cfg = vars(restart_lab.parse_args([]))
    cfg.update(seed=0x5EED17, txs=30, sigs=3)
    cfg.update(kw)
    return argparse.Namespace(**cfg)


_SCENARIO_KEYS = ("label", "persist", "requests", "lost",
                  "verdict_mismatches", "killed_at_t", "orphans_resubmitted",
                  "life1_appends", "warm_candidates", "warm_hits",
                  "post_restart_hit_rate", "life2_device_seconds",
                  "replay_digest")


def _report(rep):
    return None if rep is None else {k: v for k, v in rep.items()
                                     if k != "path"}


def test_restart_lab_equals_reference_lab():
    port = restart_lab.run_lab(_restart_cfg())
    ref = _reference_lab("restart_lab").run_lab(_restart_cfg())
    assert restart_lab.parse_args([]).seed == jconfig.KNOBS[
        "ED25519_TPU_RESTART_LAB_SEED"].default == restart_lab.DEFAULT_SEED
    assert port["ok"] and ref["ok"]
    assert port["gates"] == ref["gates"] == {g: True for g in port["gates"]}
    assert port["replay_digest"] == ref["replay_digest"]
    runs = [("clean", port["clean"], ref["clean"]),
            ("cold", port["cold"], ref["cold"])]
    runs += [(k, port["storms"][k], ref["storms"][k])
             for k in restart_lab.STORM_KINDS]
    for name, ours, theirs in runs:
        for k in _SCENARIO_KEYS:
            assert ours[k] == theirs[k], (name, k)
        assert _report(ours["load_report"]) == \
            _report(theirs["load_report"]), name
        for k in ("hits", "misses", "stores", "absorbed", "absorb_refused",
                  "rehash_mismatch", "stale_epoch"):
            assert ours["verdictcache_life2"][k] == \
                theirs["verdictcache_life2"][k], (name, k)
    clean = port["clean"]
    assert clean["load_report"]["absorbed"] > 0
    assert clean["post_restart_hit_rate"] >= 0.4
    assert clean["life2_device_seconds"] < port["cold"]["life2_device_seconds"]
    assert port["storms"]["version-skew"]["load_report"]["file_dropped"] \
        == "version_skew"
    for run in port["storms"].values():
        assert run["verdictcache_life2"]["rehash_mismatch"] == 0


def test_restart_lab_is_a_pure_function_of_the_seed():
    a = restart_lab.run_scenario(_restart_cfg(), "clean")
    b = restart_lab.run_scenario(_restart_cfg(), "clean")
    c = restart_lab.run_scenario(_restart_cfg(seed=0xD1FF), "clean")
    assert a["replay_digest"] == b["replay_digest"] != c["replay_digest"]


def test_restart_lab_main_prints_the_warmth_block():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run(
        [sys.executable, "-m",
         "ed25519_consensus_tpu_torch.tools.restart_lab", "--txs", "24",
         "--sigs", "2"], cwd=str(ROOT), env=env, capture_output=True,
        text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert '"metric": "restart_warmth"' in r.stdout
    assert "RESTART_WARMTH" in r.stdout
