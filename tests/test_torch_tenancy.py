"""The port's tenancy model and the device operand cache's tenant half,
held against the JAX package on identical seeded inputs:

* class order, ranks and the per-class admission policies (knob defaults,
  the rpc clamp, every validation error) equal the JAX package's;
* the seeded arrival processes (poisson, burst, diurnal) and the traffic
  matrices (`default_matrix`, `fleet_matrix`) equal it element for
  element;
* a scenario of tenant assignments, builds under armed quotas (evictions
  inside a partition, the feasibility-first refusal, an over-quota
  tensor), rotations and lookups, driven through both packages' caches
  on the same numpy tensors, gives equal `tenant_stats`, counters,
  evictions, refusals and quota suggestions;
* `carry.tenant_map_from_reference` carries the JAX cache's assignments
  and rotation epochs across."""

import hashlib

import numpy as np
import pytest

from ed25519_consensus_tpu import devcache as jdevcache
from ed25519_consensus_tpu import tenancy as jtenancy
from ed25519_consensus_tpu_torch import carry, config, devcache, tenancy


def test_classes_and_ranks_equal():
    assert tenancy.CLASSES == jtenancy.CLASSES
    assert tenancy.DEFAULT_TENANT == jtenancy.DEFAULT_TENANT
    for cls in tenancy.CLASSES:
        assert tenancy.class_rank(cls) == jtenancy.class_rank(cls)
    for mod in (tenancy, jtenancy):
        with pytest.raises(ValueError):
            mod.class_rank("gossip")


def _policy_tuple(pols):
    return {k: (p.name, p.shed_watermark, p.resume_watermark)
            for k, p in pols.items()}


@pytest.mark.parametrize("kw", [
    {}, {"high_watermark": 0.9, "low_watermark": 0.4},
    {"high_watermark": 0.3, "low_watermark": 0.2}, {"rpc_watermark": 0.2},
    {"high_watermark": 0.6, "low_watermark": 0.6, "rpc_watermark": 0.6},
])
def test_class_policies_equal(kw):
    assert _policy_tuple(tenancy.class_policies(**kw)) == \
        _policy_tuple(jtenancy.class_policies(**kw))


@pytest.mark.parametrize("kw", [
    {"high_watermark": 1.5}, {"low_watermark": 0.0},
    {"high_watermark": 0.5, "rpc_watermark": 0.7},
    {"high_watermark": 0.5, "low_watermark": 0.6},
])
def test_class_policy_errors_equal(kw):
    for mod in (tenancy, jtenancy):
        with pytest.raises(ValueError):
            mod.class_policies(**kw)


def test_class_policy_knobs_are_read_alike(monkeypatch):
    monkeypatch.setenv("ED25519_TPU_CLASS_WATERMARK_MEMPOOL", "0.7")
    monkeypatch.setenv("ED25519_TPU_CLASS_WATERMARK_RPC", "0.9")
    assert _policy_tuple(tenancy.class_policies()) == \
        _policy_tuple(jtenancy.class_policies())
    monkeypatch.setenv("ED25519_TPU_CLASS_WATERMARK_RPC", "lots")
    with pytest.raises(config.ConfigError):
        tenancy.class_policies()


@pytest.mark.parametrize("kind,kw", [
    ("poisson", {}),
    ("burst", {"burst_every": 5.0, "burst_len": 1.5, "burst_factor": 6.0}),
    ("diurnal", {"period": 20.0, "amplitude": 0.7}),
])
@pytest.mark.parametrize("seed", [0, 0x7AFF1C])
def test_arrival_processes_equal_element_for_element(kind, kw, seed):
    a = tenancy.arrivals(kind, 40.0, 30.0, seed=seed, **kw)
    b = jtenancy.arrivals(kind, 40.0, 30.0, seed=seed, **kw)
    assert len(a) > 100
    assert a == b


def test_arrival_errors_equal():
    for mod in (tenancy, jtenancy):
        assert mod.arrivals("poisson", 0.0, 10.0) == []
        with pytest.raises(ValueError):
            mod.arrivals("tidal", 1.0, 10.0)
        with pytest.raises(ValueError):
            mod.diurnal_arrivals(1.0, 10.0, amplitude=1.0)


def _streams(ms):
    return [(s.tenant, s.cls, s.kind, s.fraction, s.deadline_s, s.sigs,
             s.bad_rate, s.kind_kw) for s in ms]


@pytest.mark.parametrize("chains,zipf", [(1, 0.8), (5, 0.8), (12, 1.3)])
def test_traffic_matrices_equal(chains, zipf):
    assert _streams(tenancy.default_matrix()) == \
        _streams(jtenancy.default_matrix())
    a = tenancy.fleet_matrix(chains, zipf_s=zipf)
    assert _streams(a) == _streams(jtenancy.fleet_matrix(chains, zipf))
    assert abs(sum(s.fraction for s in a) - 1.0) < 1e-12


# -- the devcache's tenant half -------------------------------------------

def _tensor(tag: int, n_keys: int = 3) -> np.ndarray:
    """A head-shaped int16 tensor, seeded by `tag`."""
    rng = np.random.default_rng(tag)
    return rng.integers(-4096, 4096, size=(4, 20, 2 * (n_keys + 1)),
                        dtype=np.int16)


def _digest(tag: int) -> bytes:
    return hashlib.sha256(b"keyset-%d" % tag).digest()


def _scenario(mod, quota: int):
    """The same calls on a cache of `mod`'s: three tenants, builds past
    the quota (own-partition eviction), a build other tenants crowd out
    (refused), an over-quota tensor, lookups (hits, misses, stale after
    a rotation) and the tables kind beside a head."""
    nb = _tensor(0).nbytes
    cache = mod.DeviceOperandCache(budget_bytes=6 * nb, enabled=True,
                                   tenant_quota_bytes=quota)
    log = []
    for tag in range(12):
        cache.assign_tenant(_digest(tag), ("chain-a", "chain-b",
                                           "chain-c")[tag % 3])
    for tag in (0, 3, 6, 1, 4, 9, 12, 7, 2, 5):
        e = cache.build(_digest(tag), 3, _tensor(tag))
        log.append(("build", tag, e is not None))
    big = np.zeros((4, 20, 2 * 40), np.int16)
    log.append(("big", cache.build(_digest(11), 39, big) is not None))
    for tag in (0, 3, 6, 1, 4, 9, 7, 2, 5, 8):
        e = cache.lookup(_digest(tag))
        log.append(("lookup", tag, e is not None))
    log.append(("rotate", cache.rotate_tenant("chain-b", "test")))
    for tag in (1, 4, 7, 0):
        e = cache.lookup(_digest(tag))
        log.append(("after-rotate", tag, e is not None))
    log.append(("admit", cache.can_admit_tables(_digest(0), 2 * nb)))
    log.append(("probe", sorted(cache.probe(_digest(3)).items())))
    for tag in range(12):
        log.append(("tenant_of", tag, cache.tenant_of(_digest(tag))))
    log.append(("epochs", [cache.tenant_epoch_of(t)
                           for t in ("chain-a", "chain-b", "default")]))
    return cache, log


@pytest.mark.parametrize("quota", [0, 2 * _tensor(0).nbytes + 1,
                                   3 * _tensor(0).nbytes])
def test_quota_and_rotation_scenario_equals_reference(quota, monkeypatch):
    # The JAX cache publishes its suggestions only behind this knob; the
    # port's always does.
    monkeypatch.setenv("ED25519_TPU_DEVCACHE_QUOTA_AUTOSIZE", "1")
    tc, tlog = _scenario(devcache, quota)
    jc, jlog = _scenario(jdevcache, quota)
    assert tlog == jlog
    assert tc.tenant_stats() == jc.tenant_stats()
    ts, js = tc.stats(), jc.stats()
    for k in ("evictions", "quota_rejected", "builds", "hits", "misses",
              "stale_epoch", "tenant_rotations", "resident_bytes",
              "resident_keysets", "tenants", "quota_suggestions"):
        assert ts[k] == js[k], k
    if quota:
        assert ts["quota_rejected"] > 0 and ts["evictions"] > 0
    assert tc.quota_suggestions(verdict_stats={"chain-z": {
        "hits": 3, "misses": 1, "hit_rate": 0.75}}) == \
        jc.quota_suggestions(verdict_stats={"chain-z": {
            "hits": 3, "misses": 1, "hit_rate": 0.75}})
    monkeypatch.delenv("ED25519_TPU_DEVCACHE_QUOTA_AUTOSIZE")
    assert ts["quota_suggestions"] and \
        tc.stats()["quota_suggestions"] == ts["quota_suggestions"]


def test_suggest_tenant_quotas_equals_reference():
    stats = {"a": {"hits": 10, "misses": 30, "hit_rate": 0.25},
             "b": {"hits": 50, "misses": 0, "hit_rate": 1.0},
             "c": {"hits": 0, "misses": 0, "hit_rate": None}}
    verdicts = {"a": {"hits": 4, "misses": 4, "hit_rate": 0.5},
                "d": {"hits": 1, "misses": 9, "hit_rate": 0.1}}
    for budget in (0, 1000, 1 << 26):
        got = devcache.suggest_tenant_quotas(stats, budget, verdicts)
        assert got == jdevcache.suggest_tenant_quotas(stats, budget,
                                                      verdicts)
        assert sum(got.values()) <= budget


def test_tenant_map_carries_across():
    jc, _ = _scenario(jdevcache, 0)
    jc.rotate_tenant("chain-c")
    jc.rotate_tenant("chain-c")
    tc = devcache.DeviceOperandCache(budget_bytes=1 << 20, enabled=True)
    carry.tenant_map_from_reference(dict(jc._tenant_of),
                                    dict(jc._tenant_epoch), cache=tc)
    for tag in range(13):
        assert tc.tenant_of(_digest(tag)) == jc.tenant_of(_digest(tag))
    for t in ("chain-a", "chain-b", "chain-c", "default"):
        assert tc.tenant_epoch_of(t) == jc.tenant_epoch_of(t)
    # a build after the carry lands in the carried partition, at the
    # carried rotation epoch
    e = tc.build(_digest(2), 3, _tensor(2))
    assert (e.tenant, e.tenant_epoch) == ("chain-c", 2)
