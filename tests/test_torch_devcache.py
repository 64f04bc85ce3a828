"""The port's resident-keyset path on the CPU, where every kernel wrapper
runs its plain PyTorch version, against the JAX package on the same bytes.

* K4 (`build_tables_plain`) equals the JAX package's
  `msm.build_multiples_tables` byte for byte, and `head_tensor()` /
  `head_tables_tensor()` equal the JAX package's byte for byte.
* The resident dispatches (`dispatch_window_sums_many_tables`,
  `dispatch_window_sums_many_cached`) equal the JAX package's (its XLA
  twins `_compiled_tables_dispatch` and `_compiled_assemble_cached`, with
  ED25519_TPU_MIN_LANES=128 so each form is one executable) as group
  elements, window by window — not limb for limb: the fold order differs.
* K2t's forms agree with each other limb for limb, and its tables hold
  limbs at the |limb| = 8191 extremes exactly.
* The device operand cache's unit semantics, and forced-device
  `verify_many` verdicts through every residency path — hits, misses,
  tables knob off, corrupt / stale / evicted entries, invalidation, lane
  death — equal to the host oracle and to the JAX package's verify_many,
  False verdicts included.  Scheduling time runs on health.FakeClock."""

import random

import numpy as np
import pytest
import torch

import ed25519_consensus_tpu as J
from ed25519_consensus_tpu import batch as jbatch
from ed25519_consensus_tpu.ops import msm as jmsm
import ed25519_consensus_tpu_torch as T
from ed25519_consensus_tpu_torch import (
    batch,
    carry,
    devcache,
    faults,
    health,
)
from ed25519_consensus_tpu_torch.ops import edwards, limbs, msm
from ed25519_consensus_tpu_torch.ops import torch_field as F
from ed25519_consensus_tpu_torch.ops.field import P
from ed25519_consensus_tpu_torch.ops.scalar import L
from ed25519_consensus_tpu_torch.utils import fixtures
from ed25519_consensus_tpu_torch.utils import metrics

from torch_threads import _one_torch_thread  # noqa: F401


rng = random.Random(0x7D3C)

# 14 recurring keys, as many as the small-order matrix has: both workloads
# then share one head width, and the JAX side one executable per form.
_KEYS = [T.SigningKey.new(rng) for _ in range(14)]


@pytest.fixture(autouse=True)
def reset_state(monkeypatch):
    """A fresh injected cache per test, the lanes' min-lane floor pinned
    (one padded shape), and nothing left behind."""
    monkeypatch.setenv("ED25519_TPU_MIN_LANES", "128")
    monkeypatch.setenv("ED25519_TPU_EMA_PRIOR", "10")
    cache = devcache.DeviceOperandCache(budget_bytes=1 << 26, enabled=True)
    devcache.set_default_cache(cache)
    yield cache
    faults.uninstall()
    devcache.set_default_cache(None)
    batch.reset_device_health()
    batch.last_run_stats.clear()


# -- workloads ---------------------------------------------------------------

def small_order_encodings():
    encs = [p.compress() for p in edwards.eight_torsion()]
    return encs + fixtures.non_canonical_point_encodings()[:6]


def matrix_entries(stride: int = 3):
    """A small-order matrix subset (every (A, R) pair at stride, s = 0 —
    all valid under ZIP215): the 14 torsion / non-canonical keys."""
    encs = small_order_encodings()
    return [(A, T.Signature(R, b"\x00" * 32), b"Zcash")
            for i, A in enumerate(encs) for j, R in enumerate(encs)
            if (i * len(encs) + j) % stride == 0]


def recurring_entries(tag: bytes, bad: bool = False):
    """One batch over the fixed 14-key validator set, fresh messages per
    call; `bad` tampers one signature."""
    out = []
    for i, sk in enumerate(_KEYS):
        msg = b"devcache-%s-%d" % (tag, i)
        sig = sk.sign(msg if not (bad and i == 0) else b"tampered")
        out.append((sk.verification_key_bytes(), sig, msg))
    return out


def port_verifier(entries):
    v = batch.Verifier()
    v.queue_bulk(entries)
    return v


def jax_verifier(entries):
    v = jbatch.Verifier()
    v.queue_bulk([(bytes(vk), J.Signature(s.R_bytes, s.s_bytes), m)
                  for vk, s, m in entries])
    return v


def host_verdicts(batches):
    return [batch._host_verdict(port_verifier(e), rng) for e in batches]


def jax_verdicts(batches, monkeypatch):
    """The JAX package's verify_many on the same batches, on its host lane
    (its device dispatch math is held to the port's at the window-sum
    level below)."""
    with monkeypatch.context() as m:
        m.setenv("ED25519_TPU_DISABLE_DEVICE", "1")
        return jbatch.verify_many([jax_verifier(e) for e in batches],
                                  rng=random.Random(1), chunk=2,
                                  merge="never", mesh=0)


def fake_health():
    return health.DeviceHealth(clock=health.FakeClock())


def run_forced_device(batches, h):
    """Forced-device verify_many on the CPU, chunk = 2."""
    return batch.verify_many([port_verifier(e) for e in batches], rng=rng,
                             chunk=2, hybrid=False, merge="never",
                             device="cpu", health=h)


def stream(monkeypatch, reps, bad_reps=(), cache=None):
    """The recurring-keyset stream, two batches per rep; asserts every
    rep's verdicts equal the host oracle and the JAX package's.  Returns
    the per-rep devcache stats."""
    h = fake_health()
    out = []
    for rep in range(reps):
        bad = rep in bad_reps
        batches = [recurring_entries(b"r%d" % rep, bad=bad),
                   recurring_entries(b"r%d-b" % rep)]
        want = [not bad, True]
        assert run_forced_device(batches, h) == want
        assert host_verdicts(batches) == want
        assert jax_verdicts(batches, monkeypatch) == want
        out.append(dict(batch.last_run_stats["devcache"]))
    return out


# -- K4, head tensors, and the dispatches against the JAX package ------------

def _staged_pair(entries, seed=5):
    return (port_verifier(entries)._stage(random.Random(seed)),
            jax_verifier(entries)._stage(random.Random(seed)))


@pytest.mark.parametrize("workload", ["recurring", "small_order"])
def test_head_tensors_and_k4_equal_reference(workload):
    entries = (recurring_entries(b"heads") if workload == "recurring"
               else matrix_entries())
    mine, ref = _staged_pair(entries)
    head = mine.head_tensor()
    assert head.dtype == np.int16 and head.shape == (
        4, limbs.NLIMBS, 2 * len(mine.coeffs))
    assert np.array_equal(head, ref.head_tensor())
    host_tbl = mine.head_tables_tensor()
    assert np.array_equal(host_tbl, ref.head_tables_tensor())
    k4 = msm.build_multiples_tables(np.stack([head, head[..., ::-1]]),
                                    device="cpu").numpy()
    want = np.asarray(jmsm.build_multiples_tables(
        np.stack([head, head[..., ::-1]])))
    assert k4.dtype == np.int16 and np.array_equal(k4, want)
    # host tables are canonical, K4's balanced: the same group elements
    for j in range(head.shape[-1]):
        for k in range(msm.NTABLE):
            assert limbs.unpack_point(k4[0, k][..., j]) == \
                limbs.unpack_point(host_tbl[k][..., j])


def test_k4_on_expanded_wire_equals_reference():
    """K4 on K1's output over torsion, non-canonical and random points
    (the R lanes of the tables dispatch), byte for byte."""
    from ed25519_consensus_tpu_torch.ops import torch_decompress as TD

    encs = small_order_encodings() + fixtures.non_canonical_point_encodings()
    r = random.Random(9)
    while len(encs) < 64:
        e = r.getrandbits(256).to_bytes(32, "little")
        if edwards.decompress(e) is not None:
            encs.append(e)
    w = limbs.identity_wire_batch(len(encs))
    for i, e in enumerate(encs):
        w[:32, i] = np.frombuffer(e, np.uint8)
        w[32, i] = edwards.decompress_with_hint(e)[1]
    pts = TD.expand_compressed_points(torch.from_numpy(w[None]))
    got = msm.build_multiples_tables(pts, device="cpu").numpy()
    assert np.array_equal(got, np.asarray(
        jmsm.build_multiples_tables(pts.numpy())))


def _windows_equal(a, b):
    return all(limbs.unpack_point(a[i, ..., w]) ==
               limbs.unpack_point(b[i, ..., w])
               for i in range(a.shape[0]) for w in range(a.shape[-1]))


@pytest.mark.parametrize("workload", ["recurring", "small_order"])
def test_resident_dispatches_equal_reference_as_points(workload):
    """Both resident dispatches on the port's CPU path equal the JAX
    package's XLA twins on the same operands as group elements, window by
    window; the batch's verdict holds."""
    entries = (recurring_entries(b"disp") if workload == "recurring"
               else matrix_entries())
    stageds = [_staged_pair(entries, seed=s) for s in (1, 2)]
    N = msm.pad_lanes(stageds[0][0].n_cached_terms)
    assert N == 128
    ops = [s.device_operands_cached(lambda n: N) for s, _ in stageds]
    ref_ops = [r.device_operands_cached(lambda n: N) for _, r in stageds]
    for (d, w), (rd, rw) in zip(ops, ref_ops):
        assert np.array_equal(d, rd) and np.array_equal(w, rw)
    digits = np.stack([d for d, _ in ops])
    rwire = np.stack([w for _, w in ops])
    mine, ref = stageds[0]
    tables = msm.dispatch_window_sums_many_tables(
        digits, mine.head_tables_tensor(), rwire, device="cpu").numpy()
    cached = msm.dispatch_window_sums_many_cached(
        digits, mine.head_tensor(), rwire, device="cpu").numpy()
    want_t = np.asarray(jmsm.dispatch_window_sums_many_tables(
        digits, ref.head_tables_tensor(), rwire))
    want_c = np.asarray(jmsm.dispatch_window_sums_many_cached(
        digits, ref.head_tensor(), rwire))
    assert _windows_equal(tables, want_t)
    assert _windows_equal(cached, want_c)
    assert _windows_equal(tables, cached)
    for b in range(2):
        assert msm.combine_window_sums(tables[b:b + 1]).mul_by_cofactor() \
            .is_identity()


def _tables_operands(seed=3, B=2, n_head=70, N=192):
    """Digits and K4 tables over random points, the head boundary inside
    a chunk."""
    from ed25519_consensus_tpu_torch.ops import torch_decompress as TD

    r = random.Random(seed)
    w = limbs.identity_wire_batch(B * N)
    i = 0
    while i < B * (N - 7):
        e = r.getrandbits(256).to_bytes(32, "little")
        res = edwards.decompress_with_hint(e)
        if res is not None:
            w[:32, i] = np.frombuffer(e, np.uint8)
            w[32, i] = res[1]
            i += 1
    wire = torch.from_numpy(np.ascontiguousarray(
        w.reshape(33, B, N).transpose(1, 0, 2)))
    pts = TD.expand_compressed_points(wire)
    d = np.random.default_rng(seed).integers(
        -8, 8, size=(B, limbs.NWINDOWS, N)).astype(np.int8)
    d[:, :, :9] = -8
    return torch.from_numpy(d), pts, msm.multiples_tables(pts), n_head


def test_k2t_forms_agree_limb_for_limb():
    """K2t with per-batch head tables (TH = B) equals the split into head
    and R tables and the full-tables form (n_head = N), limb for limb, on
    packed and plain digits; and equals K2 on the same points as points."""
    d, pts, tbl, n_head = _tables_operands()
    packed = torch.from_numpy(np.stack(
        [limbs.pack_digit_planes(x) for x in d.numpy()]))
    full = msm.window_partials_tables(d, tbl)
    split = msm.window_partials_tables(d, tbl[..., :n_head],
                                       tbl[..., n_head:])
    assert torch.equal(full, split)
    assert torch.equal(split, msm.window_partials_tables(
        packed, tbl[..., :n_head], tbl[..., n_head:]))
    # TH = 1: one head table shared by both batches
    shared = tbl[:1, ..., :n_head].expand(2, -1, -1, -1, -1)
    assert torch.equal(
        msm.window_partials_tables(d, tbl[:1, ..., :n_head],
                                   tbl[..., n_head:]),
        msm.window_partials_tables(d, shared.contiguous(),
                                   tbl[..., n_head:]))
    k2 = msm.fold_partials(msm.window_partials(d, pts)).numpy()
    assert _windows_equal(msm.fold_partials(full).numpy(), k2)


def _extreme_repr(pt, coord: int, sign: int):
    """pt scaled by λ (X, Y, Z, T all times λ: the same projective point)
    so coordinate `coord` is the field element whose limbs are all
    sign·8191, returned with those limbs in place — the |limb| = 8191
    extreme of the bound the field code assumes."""
    ext = [sign * 8191] * limbs.NLIMBS
    target = limbs.limbs_to_int(ext) % P
    c = (pt.X, pt.Y, pt.Z, pt.T)[coord] % P
    lam = target * pow(c, P - 2, P) % P
    out = np.stack([limbs.int_to_limbs(v * lam % P)
                    for v in (pt.X, pt.Y, pt.Z, pt.T)])
    out[coord] = ext
    return out.astype(np.int16)


def test_tables_at_the_limb_extremes():
    """Field ops at |limb| = 8191 agree with exact integers mod p, and
    K2t on head tables whose entries carry all-8191 and all-(−8191) limbs
    (canonical resident head tables reach 8191, K4's balanced ones −8191)
    gives exactly the host MSM."""
    for a_sign, b_sign in ((1, 1), (1, -1), (-1, -1)):
        a = torch.full((limbs.NLIMBS, 1), 8191 * a_sign, dtype=torch.int32)
        b = torch.full((limbs.NLIMBS, 1), 8191 * b_sign, dtype=torch.int32)
        ai, bi = (limbs.limbs_to_int(x[:, 0].tolist()) for x in (a, b))
        for op, want in ((F.mul, ai * bi), (F.add, ai + bi),
                         (F.sub, ai - bi)):
            got = op(a, b)
            assert limbs.limbs_to_int(got[:, 0].tolist()) % P == want % P
            assert int(got.abs().max()) <= 8191
    r = random.Random(21)
    n = 16
    pts = [edwards.BASEPOINT.scalar_mul(r.getrandbits(64) + 1)
           for _ in range(n)]
    tbl = np.zeros((1, msm.NTABLE, 4, limbs.NLIMBS, n), np.int16)
    for j, pt in enumerate(pts):
        tbl[0, 0, 1, 0, j] = tbl[0, 0, 2, 0, j] = 1
        for k in range(1, msm.NTABLE):
            mult = pt.scalar_mul(k)
            tbl[0, k, ..., j] = _extreme_repr(mult, (k + j) % 4,
                                              1 if (k + j) % 2 else -1)
    d = np.random.default_rng(5).integers(
        -8, 8, size=(1, limbs.NWINDOWS, n)).astype(np.int8)
    ws = msm.fold_partials(msm.window_partials_tables(
        torch.from_numpy(d), torch.from_numpy(tbl))).numpy()
    scal = [sum(int(d[0, w, i]) * 16 ** (32 - w) for w in range(33))
            for i in range(n)]
    want = edwards.multiscalar_mul([s % L for s in scal], pts)
    assert msm.combine_window_sums(ws) == want


def test_tables_wrappers_check_operands_and_never_fall_back():
    d, pts, tbl, n_head = _tables_operands(N=64, n_head=30)
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        msm.window_partials_tables(d, tbl[..., :n_head].to(meta),
                                   tbl[..., n_head:])
    with pytest.raises(ValueError):
        msm.multiples_tables(pts.to(meta))
    with pytest.raises(ValueError):  # 3 head batches for B = 2
        msm.window_partials_tables(
            d, tbl[:1, ..., :n_head].expand(3, -1, -1, -1, -1),
            tbl[..., n_head:])
    with pytest.raises(ValueError):  # N does not match the digits
        msm.window_partials_tables(d, tbl[..., :n_head],
                                   tbl[..., n_head + 1:])


# -- the cache's unit semantics --------------------------------------------

def test_content_addressing_second_sight_and_lru(reset_state):
    cache = reset_state
    d1 = devcache.keyset_digest(b"\x01" * 32)
    assert not cache.should_build(d1) and cache.should_build(d1)
    head = np.zeros((4, 20, 4), dtype=np.int16)
    small = devcache.DeviceOperandCache(budget_bytes=3 * head.nbytes,
                                        enabled=True)
    digests = [devcache.keyset_digest(bytes([i]) * 32) for i in range(4)]
    for d in digests[:3]:
        small.build(d, 1, head)
    small.lookup(digests[0])  # 0 is now the most recently used
    small.build(digests[3], 1, head)  # evicts the LRU entry, 1
    assert small.lookup(digests[1]) is None
    assert small.lookup(digests[0]) is not None
    assert small.counters["evictions"] == 1
    assert small.build(digests[1], 1, np.zeros((4, 20, 400),
                                               np.int16)) is None
    off = devcache.DeviceOperandCache(budget_bytes=0, enabled=True)
    assert not off.enabled and off.lookup(d1) is None
    entry = cache.build(d1, 1, head)
    assert entry.n_head == 4 and cache.lookup(d1) is entry
    g = metrics.gauges()
    assert g["devcache_resident_keysets"] == 1
    assert g["devcache_resident_bytes"] == cache.resident_bytes()


def test_tables_kind_hash_pinning_probe_and_admission(reset_state,
                                                      monkeypatch):
    cache = reset_state
    d = devcache.keyset_digest(b"\x07" * 32)
    tables = np.arange(9 * 4 * 20 * 4, dtype=np.int16).reshape(9, 4, 20, 4)
    te = cache.build(d, 1, tables, kind=devcache.KIND_TABLES)
    assert not cache.probe(d)["tables_hit"]  # no head: not reachable
    cache.build(d, 1, np.zeros((4, 20, 4), np.int16))
    st = cache.stats()
    assert st["resident_keysets"] == 1 and st["resident_tables"] == 1
    assert cache.probe(d)["tables_hit"]
    monkeypatch.setenv("ED25519_TPU_DEVCACHE_TABLES", "0")
    assert not cache.probe(d)["tables_hit"] and cache.probe(d)["hit"]
    monkeypatch.delenv("ED25519_TPU_DEVCACHE_TABLES")
    assert te.recheck()
    te.head_tensor[0, 0, 0, 0] ^= 1
    assert cache.lookup(d, kind=devcache.KIND_TABLES) is None
    assert cache.counters["restage_hash_mismatch"] == 1
    assert cache.lookup(d) is not None  # the head is untouched
    # the thrash window: tables alone fit, head + tables do not
    head = np.zeros((4, 20, 4), np.int16)
    tight = devcache.DeviceOperandCache(
        budget_bytes=9 * head.nbytes + head.nbytes // 2, enabled=True)
    tight.build(d, 1, head)
    assert not tight.can_admit_tables(d, 9 * head.nbytes)
    roomy = devcache.DeviceOperandCache(budget_bytes=10 * head.nbytes,
                                        enabled=True)
    roomy.build(d, 1, head)
    assert roomy.can_admit_tables(d, 9 * head.nbytes)


def test_epoch_lane_death_chip_drop_and_device_refs(reset_state):
    cache = reset_state
    d = devcache.keyset_digest(b"\x08" * 32)
    head = np.arange(4 * 20 * 4, dtype=np.int16).reshape(4, 20, 4)
    e = cache.build(d, 1, head)
    cache.build(d, 1, np.zeros((9, 4, 20, 4), np.int16),
                kind=devcache.KIND_TABLES)
    ref = e.device_ref("cpu")
    assert ref is e.device_ref("cpu")  # reused
    e.head_tensor[0, 0, 0] ^= 1  # the device copy is not a view
    assert int(ref[0, 0, 0]) != int(e.head_tensor[0, 0, 0])
    e.head_tensor[0, 0, 0] ^= 1
    e._device_refs["cuda:0"] = ref
    health.chip_registry().mark_chip_dead(0, heal_after=1.0)
    assert "cuda:0" not in e._device_refs and "cpu" in e._device_refs
    assert cache.counters["chip_drops"] == 1
    cache.bump_epoch("test")
    assert cache.lookup(d, kind=devcache.KIND_TABLES) is None
    assert cache.lookup(d) is None
    assert cache.counters["stale_epoch"] == 2
    cache.build(d, 1, head)
    health.DeviceHealth(clock=health.FakeClock()).mark_lane_stuck()
    assert cache.resident_count() == 0


def test_carry_installs_the_reference_resident_state(reset_state):
    """A JAX staged batch's keyset blob and resident arrays, carried as
    numpy, become the port's entries; the port then dispatches from
    them."""
    cache = reset_state
    _, ref = _staged_pair(recurring_entries(b"carry"))
    head_e, tbl_e = carry.resident_from_reference(
        ref.keyset_blob, ref.head_tensor(), ref.head_tables_tensor())
    digest = devcache.keyset_digest(ref.keyset_blob)
    assert cache.lookup(digest) is head_e
    assert cache.lookup(digest, kind=devcache.KIND_TABLES) is tbl_e
    assert np.array_equal(tbl_e.head_tensor, ref.head_tables_tensor())
    assert head_e.n_head == ref.head_tensor().shape[-1]
    # the next sighting of the keyset dispatches from the carried tables
    h = fake_health()
    assert run_forced_device([recurring_entries(b"carry-2")], h) == [True]
    assert batch.last_run_stats["devcache"]["table_dispatch_hits"] == 1


# -- verdicts through every residency path ---------------------------------

def test_recurring_keyset_through_tables_path(reset_state, monkeypatch):
    """Sight 1 stages cold, sight 2 builds head + tables, sight 3+
    dispatch from resident tables: verdicts equal the host oracle and the
    JAX package's, False verdicts included."""
    dcs = stream(monkeypatch, reps=5, bad_reps=(1, 4))
    assert all(dc["tables_hit"] for dc in dcs[2:])
    assert [dc["table_dispatch_hits"] for dc in dcs] == [0, 0, 1, 1, 1]
    st = reset_state.stats()
    assert st["resident_tables"] == 1 and st["resident_keysets"] == 1


def test_tables_knob_off_keeps_the_head_path(reset_state, monkeypatch):
    monkeypatch.setenv("ED25519_TPU_DEVCACHE_TABLES", "0")
    dcs = stream(monkeypatch, reps=4, bad_reps=(2,))
    assert [dc["dispatch_hits"] for dc in dcs] == [0, 0, 1, 1]
    assert all(dc["table_dispatch_hits"] == 0 for dc in dcs)
    assert reset_state.stats()["resident_tables"] == 0


def test_cache_off_equals_cold_cache(reset_state, monkeypatch):
    devcache.set_default_cache(devcache.DeviceOperandCache(enabled=False))
    dcs = stream(monkeypatch, reps=2, bad_reps=(0,))
    assert not any(dc["dispatch_hits"] for dc in dcs)


def test_small_order_matrix_through_resident_paths(reset_state):
    """The small-order matrix subset, cold, build, then from resident
    tables and from resident heads: all accept, as the host oracle."""
    cache = reset_state
    h = fake_health()
    assert host_verdicts([matrix_entries()]) == [True]
    for _ in range(3):
        assert run_forced_device([matrix_entries(), matrix_entries()],
                                 h) == [True, True]
    assert batch.last_run_stats["devcache"]["table_dispatch_hits"] == 1
    with pytest.MonkeyPatch.context() as m:
        m.setenv("ED25519_TPU_DEVCACHE_TABLES", "0")
        assert run_forced_device([matrix_entries()], h) == [True]
        assert batch.last_run_stats["devcache"]["dispatch_hits"] == 1
    assert cache.stats()["resident_tables"] == 1


@pytest.mark.parametrize("kind,counter", [
    ("corrupt", "restage_hash_mismatch"), ("stale", "stale_epoch"),
    ("evict", "drops")])
def test_faulted_residency_restages_never_a_verdict(kind, counter,
                                                    reset_state,
                                                    monkeypatch):
    """A corrupt, stale or evicted resident entry at the lookup seam (the
    seam carries head and tables lookups) falls back a rung; verdicts
    equal the host oracle and the JAX package's throughout."""
    cache = reset_state
    stream(monkeypatch, reps=2)  # warm residency
    plan = faults.devcache_plan(seed=0xD3, kind=kind, at=0, length=2)
    with faults.injected(plan):
        stream(monkeypatch, reps=3, bad_reps=(1,))
    assert plan.calls_seen(faults.SITE_DEVCACHE) >= 2
    assert cache.counters[counter] >= 1


def test_invalidate_mid_stream_restages(reset_state, monkeypatch):
    cache = reset_state
    stream(monkeypatch, reps=3)
    assert cache.counters["hits"] >= 2
    doomed = port_verifier(recurring_entries(b"doomed"))
    doomed.invalidate("poison sighted")
    assert doomed.invalid_reason == "poison sighted"
    assert batch.verify_many([doomed], device="cpu",
                             health=fake_health()) == [False]
    dcs = stream(monkeypatch, reps=2, bad_reps=(0,))
    assert cache.counters["stale_epoch"] >= 1
    assert dcs[1]["table_dispatch_hits"] == 1  # resident again
    assert cache.stats()["epoch"] >= 1


def test_lane_death_mid_stream_drops_residency(reset_state, monkeypatch):
    """KillLane on a hot dispatch: the worker dies, the deadline machinery
    abandons the lane (which drops all residency) and the call raises
    DeviceError, never a host verdict; the stream rebuilds residency
    after — verdicts host-identical."""
    cache = reset_state
    stream(monkeypatch, reps=3)
    assert cache.resident_count() == 1
    h = fake_health()
    batches = [recurring_entries(b"kill", bad=True),
               recurring_entries(b"kill-b")]
    with faults.injected(faults.storm_plan(seed=1, kind="crash", at=0)):
        with pytest.raises(batch.DeviceError, match="deadline"):
            run_forced_device(batches, h)
    st = batch.last_run_stats
    assert st["device_sick"] and st["host_batches"] == 0
    assert cache.resident_count() == 0 and cache.counters["drops"] >= 2
    batch.reset_device_health()
    dcs = stream(monkeypatch, reps=3)
    assert dcs[-1]["table_dispatch_hits"] == 1


def test_cached_operand_layout_matches_head_tensor():
    """The cached operands plus the resident head describe the cold
    operands' MSM: the R columns of the cold wire are the cached R wire,
    and the head columns follow head_tensor's order."""
    v = port_verifier(recurring_entries(b"layout"))
    staged = v._stage(rng)
    n_coeff = len(staged.coeffs)
    digits, rwire = staged.device_operands_cached(lambda n: n)
    assert digits.shape[-1] == staged.n_cached_terms
    assert rwire.shape == (33, staged.n_cached_terms - 2 * n_coeff)
    _, cold = staged.device_operands(lambda m: m)
    assert np.array_equal(cold[:, -staged.n_sigs:],
                          rwire[:, :staged.n_sigs])
    head = staged.head_tensor()
    assert np.array_equal(head[..., :n_coeff], limbs.pack_points_from_raw(
        staged.raw_points[:n_coeff]))
    assert v._canonical_keyset_blob() == staged.keyset_blob
    assert len(staged.keyset_blob) == 32 * len(_KEYS)
