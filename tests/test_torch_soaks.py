"""The port's verdict soaks on the CPU (ed25519_consensus_tpu_torch/tools/
soak.py, device_soak.py, chaos_soak.py), held against the JAX tools:

* soak — at 4 rounds and the seed 0xD00D, the entry stream and the
  per-call oracle's verdicts hash equal to the JAX tool's `random_entry`
  stream and oracle run the same way (the JAX tool is loaded inside a
  monkeypatch scope: it sets ED25519_TPU_DISABLE_DEVICE at import), and
  `run` leaves the environment as it found it;
* device_soak — its pool is the JAX tool's pool (the JAX file runs at
  import and ends in os._exit, so its loop is restated here, never
  imported); two passes on the CPU hold every batch against the host; three
  passes over a prefix of the pool reach the resident-tables dispatch;
* chaos_soak — its pools and plans are the JAX tool's; three rounds with a
  flapping link meet the port's gate (a finished round with injected
  faults, a DeviceError round, no wrong verdict); a round the flap reaches
  raises, and a soak of nothing but raised rounds fails the gate; one
  round on a two-shard CPU mesh."""

import importlib.util
import os
import random
from pathlib import Path

import pytest
import torch

from ed25519_consensus_tpu_torch import (
    SigningKey, batch, devcache, faults, health,
)
from ed25519_consensus_tpu_torch.tools import chaos_soak, device_soak, soak

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_state():
    devcache.set_default_cache(devcache.DeviceOperandCache(enabled=True))
    batch.reset_device_health()
    yield
    if faults.active_plan() is not None:
        faults.uninstall()
    devcache.set_default_cache(None)
    batch.reset_device_health()
    batch.last_run_stats.clear()


def _load_reference_tool(name, monkeypatch):
    """A JAX tool loaded by path; its import-time environment writes land
    in `monkeypatch`'s scope."""
    monkeypatch.setenv("ED25519_TPU_DISABLE_DEVICE", "1")
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- soak -------------------------------------------------------------------


def _reference_soak(ref, rounds, seed):
    """The JAX tool's main loop, hashing what soak.run hashes."""
    import hashlib

    from ed25519_consensus_tpu import SigningKey as JSigningKey
    from ed25519_consensus_tpu import batch as jbatch
    from ed25519_consensus_tpu.ops import edwards as jedwards
    from ed25519_consensus_tpu.utils import fixtures as jfixtures

    rng = random.Random(seed)
    keys = [JSigningKey.new(rng) for _ in range(24)]
    encs = [p.compress() for p in jedwards.eight_torsion()]
    encs += jfixtures.non_canonical_point_encodings()[:6]
    stream, verdicts = hashlib.sha256(), hashlib.sha256()
    for _ in range(rounds):
        n_batches = rng.randrange(1, 24)
        vs, expect, flat, flat_expect = [], [], [], []
        for _ in range(n_batches):
            n = rng.choice([0, 1, 2, 3, 8, 32, 64, 150, 300])
            entries = [ref.random_entry(rng, keys, encs) for _ in range(n)]
            for e in entries:
                stream.update(soak.entry_bytes(e))
            v = jbatch.Verifier()
            if rng.random() < 0.5:
                v.queue_bulk(entries)
            else:
                for e in entries:
                    v.queue(e)
            ok_all = True
            for e in entries:
                ok = ref.oracle(*e)
                if rng.random() < 0.1:
                    flat.append(e)
                    flat_expect.append(ok)
                ok_all = ok_all and ok
            expect.append(ok_all)
            vs.append(v)
        verdicts.update(repr((expect, flat_expect)).encode())
        merge = rng.choice(["auto", "always", "never"])
        assert jbatch.verify_many(vs, rng=rng, merge=merge,
                                  chunk=rng.choice([2, 4, 8])) == expect
        if flat:
            assert jbatch.verify_single_many(flat, rng=rng) == flat_expect
    return stream.hexdigest(), verdicts.hexdigest()


def test_soak_stream_and_verdicts_equal_the_reference(monkeypatch):
    monkeypatch.delenv("ED25519_TPU_DISABLE_DEVICE", raising=False)
    summary = soak.run(rounds=4, seed=0xD00D, log=lambda m: None)
    assert "ED25519_TPU_DISABLE_DEVICE" not in os.environ
    assert summary["ok"] and summary["rounds"] == 4
    assert summary["sigs"] > 1000
    with monkeypatch.context() as m:
        ref = _load_reference_tool("soak", m)
        want = _reference_soak(ref, 4, 0xD00D)
    assert (summary["stream_sha256"], summary["verdicts_sha256"]) == want


def test_soak_catches_a_wrong_oracle(monkeypatch):
    """The soak is not vacuous: an oracle that accepts everything makes
    the round fail."""
    monkeypatch.setattr(soak, "oracle", lambda *e: True)
    with pytest.raises(SystemExit, match="round 0"):
        soak.run(rounds=1, seed=0xD00D, log=lambda m: None)


# -- device_soak ------------------------------------------------------------


def _reference_device_pool(seed, batches):
    """The JAX tool's pool, its loop restated (tools/device_soak.py:13-36)
    over the JAX package → [content digest], [its truth]."""
    from ed25519_consensus_tpu import Signature as JSignature
    from ed25519_consensus_tpu import SigningKey as JSigningKey
    from ed25519_consensus_tpu import batch as jbatch
    from ed25519_consensus_tpu.ops import edwards as jedwards
    from ed25519_consensus_tpu.utils import fixtures as jfixtures

    rng = random.Random(seed)
    keys = [JSigningKey.new(rng) for _ in range(48)]
    encs = [p.compress() for p in jedwards.eight_torsion()]
    encs += jfixtures.non_canonical_point_encodings()[:6]
    digests, want = [], []
    for i in range(batches):
        bv = jbatch.Verifier()
        n = rng.randrange(20, 400)
        bad = rng.random() < 0.5
        bad_at = rng.randrange(n) if bad else -1
        for j in range(n):
            if rng.random() < 0.05:
                A = rng.choice(encs)
                R = rng.choice(encs)
                bv.queue((A, JSignature(R, b"\x00" * 32), b"Zcash"))
                continue
            sk = rng.choice(keys)
            m = b"soak %d %d" % (i, j)
            sig = sk.sign(m)
            if j == bad_at:
                m = m + b"!"
            bv.queue((sk.verification_key_bytes(), sig, m))
        digests.append(bv.content_digest())
        want.append(not bad)
    return digests, want


def test_device_soak_pool_is_the_reference_pool():
    """The first 12 batches of the pool (the keys are drawn first, so the
    prefix pins the key derivation too)."""
    vs, want = device_soak.make_pool(
        random.Random(device_soak.DEFAULT_SEED), 12)
    ref_digests, ref_want = _reference_device_pool(device_soak.DEFAULT_SEED,
                                                   12)
    assert [v.content_digest() for v in vs] == ref_digests
    assert all(20 <= v.batch_size < 400 for v in vs)
    # no torsion entry lands on a tamper's index here, so the construction
    # truth is the JAX tool's "half tampered" truth too
    assert want == ref_want and 0 < sum(want) < 12


def test_device_soak_holds_every_batch_against_the_host():
    summary = device_soak.run(device="cpu", passes=2, batches=8,
                              clock=health.FakeClock(), log=lambda m: None)
    assert summary["ok"], summary["wrong"]
    assert summary["host_equals_truth"] and summary["chunk"] == 1
    for rec in summary["passes"]:
        assert rec["wrong"] == []
        # every batch decided on the device; the host saw only the
        # device's rejects, all confirmed
        assert rec["device_batches"] + rec["rejects_confirmed"] == 8
        assert rec["host_batches"] == rec["rejects_confirmed"]
        assert rec["rejects_overturned"] == 0


def test_device_soak_third_pass_dispatches_from_resident_tables():
    summary = device_soak.run(device="cpu", passes=3, batches=4,
                              clock=health.FakeClock(), log=lambda m: None)
    assert summary["ok"], summary["wrong"]
    hits = [rec["table_dispatch_hits"] for rec in summary["passes"]]
    assert hits[:2] == [0, 0] and hits[2] == 4, hits
    assert summary["rejects_overturned"] == 0


# -- chaos_soak -------------------------------------------------------------


def test_chaos_pools_and_plans_are_the_reference(monkeypatch):
    from ed25519_consensus_tpu import SigningKey as JSigningKey
    from ed25519_consensus_tpu import faults as jfaults

    with monkeypatch.context() as m:
        ref = _load_reference_tool("chaos_soak", m)
    for seed in (chaos_soak.DEFAULT_SEED, 4):
        rnd, jrnd = random.Random(seed), random.Random(seed)
        keys = [SigningKey.new(rnd) for _ in range(16)]
        jkeys = [JSigningKey.new(jrnd) for _ in range(16)]
        for _ in range(3):
            rs = rnd.getrandbits(32)
            assert rs == jrnd.getrandbits(32)
            vs, want = chaos_soak.make_pool(random.Random(rs ^ 0x5EED),
                                            keys, 12, 4)
            jvs, jwant = ref.make_pool(random.Random(rs ^ 0x5EED), jkeys,
                                       12, 4)
            assert want == jwant
            assert [v.content_digest() for v in vs] == \
                [v.content_digest() for v in jvs]
            for flap in (0, 2):
                kw = dict(error_rate=0.15, stall_rate=0.05,
                          stall_seconds=0.05, corrupt_rate=0.10,
                          flap_period=flap)
                ours = faults.randomized_plan(rs, **kw)
                theirs = jfaults.randomized_plan(rs, **kw)
                assert [[f.kind() for f in ours.faults if f.fires_on(i)]
                        for i in range(16)] == \
                    [[f.kind() for f in theirs.faults if f.fires_on(i)]
                     for i in range(16)]


def _chaos(*argv):
    return chaos_soak.soak(chaos_soak.parse_args(["--device", "cpu",
                                                  *argv]),
                           clock=health.FakeClock(), log=lambda m: None)


def test_chaos_soak_with_a_flap_meets_the_gate():
    """Seed 4's three rounds: a corrupted sum the host overturns (the
    round finishes with verdicts), and injected errors (the call raises
    DeviceError, counted, never re-decided on the host)."""
    summary = _chaos("--seed", "4", "--rounds", "3", "--flap", "2")
    assert summary["ok"] and summary["proved"]
    assert summary["wrong_rounds"] == 0
    assert summary["finished_with_faults"] >= 1
    assert summary["rounds_raised"] >= 1
    assert summary["injected"] > 0
    assert summary["device_rejects_overturned"] >= 1
    assert summary["rounds_raised"] + summary["rounds_finished"] == 3


def test_chaos_round_the_flap_reaches_raises_and_proves_nothing():
    """Three chunks a round: the flap's first down window (call 2) is
    reached, the round raises DeviceError, and a soak whose every faulted
    round raised fails the gate — with no wrong verdict."""
    summary = _chaos("--rounds", "1", "--flap", "2", "--batches", "24")
    assert summary["fault_kinds"].get("FlappingLink") == 1
    assert summary["rounds_raised"] == 1
    assert summary["wrong_rounds"] == 0
    assert not summary["proved"] and not summary["ok"]


def test_chaos_soak_on_a_two_shard_cpu_mesh():
    """One round at the sharded seam (seed 6: a corrupted mesh sum, which
    the host overturns)."""
    summary = _chaos("--seed", "6", "--rounds", "1", "--mesh", "2")
    assert summary["ok"] and summary["wrong_rounds"] == 0
    assert summary["mesh"] == 2 and summary["rounds_finished"] == 1
    assert summary["fault_kinds"] == {"CorruptSum": 1}
    assert summary["device_rejects_overturned"] >= 1
