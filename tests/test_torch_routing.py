"""The port's routing policy (`ed25519_consensus_tpu_torch.routing`) against
the JAX package's: the same crossover model N*(D) = a / (b·(1 − 1/D)) and
the same mesh decisions for the same constants; auto routing that stays on
the single lane with one card visible (or with a device named); a mesh
without a device that raises with fewer cards than shards; and constants
that are the card's own, not the TPU's."""

import random

import pytest
import torch

from ed25519_consensus_tpu import health as jhealth
from ed25519_consensus_tpu import routing as jrouting
import ed25519_consensus_tpu_torch as T
from ed25519_consensus_tpu_torch import batch, config, health, routing


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per test worker (the port tests' idiom)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def reset_state():
    yield
    routing.set_default_policy(None)
    batch._DeviceLane.reset_all()
    batch.reset_device_health()
    jhealth.reset_all()


def _verifiers(n, seed=1):
    r = random.Random(seed)
    out = []
    for b in range(n):
        v = batch.Verifier()
        for i in range(3):
            sk = T.SigningKey.new(r)
            m = b"route-%d-%d" % (b, i)
            v.queue((sk.verification_key_bytes(), sk.sign(m), m))
        out.append(v)
    return out


@pytest.mark.parametrize("a, b", [(0.030, 1.3e-6), (2e-4, 5e-8)])
def test_crossover_and_choice_match_reference(a, b):
    mine = routing.RoutingPolicy(fixed_cost_s=a, per_term_s=b)
    ref = jrouting.RoutingPolicy(fixed_cost_s=a, per_term_s=b)
    for d in (1, 2, 4, 8):
        assert mine.crossover_terms(d) == pytest.approx(ref.crossover_terms(d))
    h = health.DeviceHealth(mesh=8, clock=health.FakeClock())
    jh = jhealth.DeviceHealth(mesh=8, clock=jhealth.FakeClock())
    n8, n2 = mine.crossover_terms(8), mine.crossover_terms(2)
    for est in (0, int(n8) - 1, int(n8) + 1, int(n2) + 1, 10 ** 9):
        for d in (1, 2, 8):
            assert mine.choose_mesh(est, n_devices=d, health=h) == \
                ref.choose_mesh(est, n_devices=d, health=jh)
    h.note_deadline_miss()
    jh.note_deadline_miss()
    assert mine.choose_mesh(10 ** 9, n_devices=8, health=h) == \
        ref.choose_mesh(10 ** 9, n_devices=8, health=jh) == 0


def test_one_card_auto_routing_is_the_single_lane(monkeypatch):
    """With one card visible the policy never picks a mesh, whatever the
    batch; with a device named, auto routing is the single lane too."""
    pol = routing.RoutingPolicy(fixed_cost_s=1e-9, per_term_s=1.0)
    monkeypatch.setattr(routing, "_device_count", [1])
    assert pol.choose_mesh(10 ** 9) == 0
    assert routing.resolve_mesh(None, 10 ** 9, policy=pol) == 0
    monkeypatch.setattr(routing, "_device_count", [4])
    assert pol.choose_mesh(10 ** 9) == 4
    assert routing.resolve_mesh(None, 10 ** 9, n_devices=1, policy=pol) == 0
    routing.set_default_policy(pol)
    vs = _verifiers(2)
    assert batch.verify_many(vs, rng=random.Random(2), merge="never",
                             device="cpu", hybrid=False) == [True, True]
    assert batch.last_run_stats["mesh"] == 0
    assert routing.resolve_mesh(2) == 2 and routing.resolve_mesh(1) == 0


def test_mesh_without_a_device_needs_the_cards(monkeypatch):
    """mesh=D with no device puts shard k on cuda:k: with fewer cards
    visible than D (none here) it raises, as the JAX package's mesh
    does; with the CPU named, the D shards run there."""
    vs = _verifiers(2)
    with pytest.raises(ValueError, match="requested 2 CUDA devices, have 0"):
        batch.verify_many(vs, mesh=2)
    assert batch.verify_many(vs, mesh=2, device="cpu", merge="never",
                             hybrid=False) == [True, True]
    assert batch.last_run_stats["mesh"] == 2


def test_constants_are_the_cards_own(monkeypatch):
    """The default policy holds the card's measured a and b, unscaled: no
    TPU constant, no environment override, no resident-keyset factor.
    The one override is a RoutingPolicy installed as the default."""
    pol = routing.default_policy()
    assert (pol.fixed_cost_s, pol.per_term_s) == (
        routing.DEFAULT_FIXED_COST_S, routing.DEFAULT_PER_TERM_S)
    assert routing.DEFAULT_FIXED_COST_S != jrouting.DEFAULT_FIXED_COST_S
    assert routing.DEFAULT_PER_TERM_S != jrouting.DEFAULT_PER_TERM_S
    assert pol.crossover_terms(2) == pytest.approx(
        routing.DEFAULT_FIXED_COST_S / (routing.DEFAULT_PER_TERM_S * 0.5))
    for name in ("ED25519_TPU_MESH_FIXED_COST", "ED25519_TPU_MESH_PER_TERM",
                 "ED25519_TPU_AUTO_MESH", "ED25519_TPU_DEVCACHE_HOT_SCALE",
                 "ED25519_TPU_DEVCACHE_TABLES_HOT_SCALE"):
        assert name not in config.KNOBS
        monkeypatch.setenv(name, "0")
    assert routing.RoutingPolicy().crossover_terms(2) == \
        pol.crossover_terms(2)
    monkeypatch.setattr(routing, "_device_count", [8])
    routing.set_default_policy(routing.RoutingPolicy(fixed_cost_s=0.5,
                                                     per_term_s=2e-7))
    assert routing.default_policy().crossover_terms(2) == \
        pytest.approx(0.5 / (2e-7 * 0.5))
    assert routing.resolve_mesh(None, 10 ** 7) == 8
    routing.set_default_policy(routing.RoutingPolicy(auto_mesh=False))
    assert routing.resolve_mesh(None, 10 ** 9) == 0


def test_auto_routing_follows_live_health(monkeypatch):
    """A half-dead mesh routes like a half-size one (N* from the live
    healthy count), as in the JAX package."""
    monkeypatch.setattr(routing, "_device_count", [8])
    pol = routing.RoutingPolicy(fixed_cost_s=0.030, per_term_s=1.3e-6)
    h = health.DeviceHealth(mesh=8, clock=health.FakeClock())
    between = int((pol.crossover_terms(8) + pol.crossover_terms(4)) / 2)
    assert pol.choose_mesh(between, n_devices=8, health=h) == 8
    for c in (4, 5, 6, 7):
        health.chip_registry().mark_chip_dead(c)
    assert pol.choose_mesh(between, n_devices=8, health=h) == 0
    assert pol.choose_mesh(int(pol.crossover_terms(4)) + 1000,
                           n_devices=8, health=h) == 4
