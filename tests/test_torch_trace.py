"""The port's span recorder (`utils.metrics`: `span`, `enable_spans`,
`disable_spans`, `drain_spans`) and the spans `batch.verify_many` records
at its layer boundaries, on the CPU (`device="cpu"`: the lane's dispatches
run the kernels' plain versions).  Also the always-on `shift128_lookups` /
`shift128_hits` counters of `last_run_stats`, and `Verifier.verify`'s
`timings`."""

import inspect
import random
import threading
import time

import pytest
import torch

import ed25519_consensus_tpu_torch as T
from ed25519_consensus_tpu_torch import batch, devcache
from ed25519_consensus_tpu_torch.utils import metrics

rng = random.Random(0x7A ^ 0x5EED)

NAME, START, END, SPAN_ID, PARENT_ID, CALL_ID, THREAD = range(7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    metrics.disable_spans()
    metrics.drain_spans()
    yield
    metrics.disable_spans()
    metrics.drain_spans()


def make_entries(n_batches, sigs_per_batch=3, bad=()):
    out = []
    for b in range(n_batches):
        ents = []
        for i in range(sigs_per_batch):
            sk = T.SigningKey.new(rng)
            msg = b"trace-%d-%d" % (b, i)
            sig = sk.sign(msg if (b not in bad or i != 0) else b"tampered")
            ents.append((sk.verification_key_bytes(), sig, msg))
        out.append(ents)
    return out


def verifiers(batches):
    out = []
    for ents in batches:
        v = batch.Verifier()
        v.queue_bulk(ents)
        out.append(v)
    return out


BAD = 4
N_BATCHES = 6


@pytest.fixture(scope="module")
def merged_call():
    """One traced `verify_many` over a merged set of six batches (fresh
    keys), the fifth tampered: (verdicts, spans, stats, batches)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ED25519_TPU_MIN_LANES", "128")
        devcache.set_default_cache(devcache.DeviceOperandCache(enabled=True))
        try:
            batches = make_entries(N_BATCHES, bad={BAD})
            metrics.enable_spans()
            metrics.drain_spans()
            vs = verifiers(batches)
            out = batch.verify_many(vs, rng=rng, device="cpu", hybrid=False,
                                    merge="always")
            metrics.disable_spans()
            spans = metrics.drain_spans()
            stats = dict(batch.last_run_stats)
        finally:
            metrics.disable_spans()
            metrics.drain_spans()
            devcache.set_default_cache(None)
            batch.last_run_stats.clear()
    return out, spans, stats, batches


def by_name(spans, name):
    return [s for s in spans if s[NAME] == name]


def test_recorder_off_records_nothing():
    """Off (the default): `span` hands out one shared no-op, nothing is
    recorded, and a queued batch leaves no span."""
    assert metrics.span("a") is metrics.span("b", call=True)
    with metrics.span("a") as sp:
        assert sp is None
        assert metrics.current_span() is None
    batch.Verifier().queue_bulk(make_entries(1)[0])
    assert metrics.drain_spans() == []


def test_span_times_are_perf_counter_seconds():
    metrics.enable_spans()
    t0 = time.perf_counter()
    with metrics.span("outer"):
        with metrics.span("inner"):
            pass
    t1 = time.perf_counter()
    inner, outer = metrics.drain_spans()
    assert (inner[NAME], outer[NAME]) == ("inner", "outer")
    for s in (inner, outer):
        assert t0 <= s[START] <= s[END] <= t1
    assert outer[START] <= inner[START] and inner[END] <= outer[END]
    assert inner[PARENT_ID] == outer[SPAN_ID] and outer[PARENT_ID] is None
    assert inner[THREAD] == outer[THREAD] == threading.get_ident()
    assert inner[CALL_ID] is None and outer[CALL_ID] is None


def test_parents_come_from_each_threads_own_stack():
    """A span opened on another thread while one is open here is no
    child of it; given it as `origin`, it joins its call under the root."""
    metrics.enable_spans()
    got = {}

    def worker(origin):
        with metrics.span("plain"):
            pass
        with metrics.span("handed", origin=origin):
            got["thread"] = threading.get_ident()

    with metrics.span("root", call=True) as root:
        with metrics.span("child") as child:
            t = threading.Thread(target=worker, args=(child,))
            t.start()
            t.join(10)
    assert not t.is_alive()
    spans = {s[NAME]: s for s in metrics.drain_spans()}
    assert spans["plain"][PARENT_ID] is None
    assert spans["plain"][CALL_ID] is None
    assert spans["handed"][PARENT_ID] == root.span_id
    assert spans["handed"][CALL_ID] == root.call_id == spans["root"][CALL_ID]
    assert spans["handed"][THREAD] == got["thread"] != spans["root"][THREAD]
    assert spans["child"][PARENT_ID] == root.span_id


def test_verify_many_records_the_layer_tree(merged_call):
    """A merged set with one tampered batch: the outer call's merge and
    bisection, the inner call on the union with its routing, staging
    (⊃ the per-key [2^128]A), the wait on the lane and the combine (⊃ the
    host's re-check of the device's reject), all in one call."""
    out, spans, stats, _ = merged_call
    assert out == [i != BAD for i in range(N_BATCHES)]
    assert stats["merged_unions"] == 1
    assert len(by_name(spans, "queue_bulk")) == N_BATCHES
    for s in by_name(spans, "queue_bulk"):
        assert s[PARENT_ID] is None and s[CALL_ID] is None
    ids = {s[SPAN_ID]: s for s in spans}
    call = [s for s in spans if s[CALL_ID] is not None]
    assert len({s[CALL_ID] for s in call}) == 1
    (outer,) = [s for s in by_name(spans, "verify_many")
                if s[PARENT_ID] is None]
    (inner,) = [s for s in by_name(spans, "verify_many")
                if s[PARENT_ID] == outer[SPAN_ID]]

    def parent(s):
        return ids[s[PARENT_ID]]

    for name in ("merge", "bisect"):
        (s,) = by_name(spans, name)
        assert parent(s) is outer
    for name in ("route", "stage", "lane_wait", "combine"):
        got = by_name(spans, name)
        assert got and all(parent(s) is inner for s in got), name
    # staging a device chunk, or the host's own staging of a batch it
    # decides again (none where the native runtime decides it fused)
    for s in by_name(spans, "stage.shift128"):
        assert parent(s)[NAME] in ("stage", "recheck", "bisect")
    assert any(parent(s)[NAME] == "stage"
               for s in by_name(spans, "stage.shift128"))
    assert any(parent(s)[NAME] == "stage"
               for s in by_name(spans, "stage.operands"))
    (recheck,) = by_name(spans, "recheck")
    assert parent(recheck)[NAME] == "combine"
    assert stats["device_rejects_confirmed"] == 1
    # children lie inside their parents (same thread)
    for s in call:
        p = ids.get(s[PARENT_ID])
        if p is not None and p[THREAD] == s[THREAD]:
            assert p[START] <= s[START] and s[END] <= p[END]


def test_device_call_runs_on_the_lane_worker(merged_call):
    _, spans, _, _ = merged_call
    (outer,) = [s for s in by_name(spans, "verify_many")
                if s[PARENT_ID] is None]
    (dc,) = by_name(spans, "device_call")
    assert dc[THREAD] != outer[THREAD]
    assert dc[CALL_ID] == outer[CALL_ID]
    assert dc[PARENT_ID] == outer[SPAN_ID]
    (wait,) = by_name(spans, "lane_wait")
    assert wait[START] <= dc[END] <= wait[END]


def test_shift128_counters(merged_call, monkeypatch):
    """One lookup per distinct key staged.  A cold dispatch leaves every
    key it did not find in `_shift128_cache` to the card (K7), so the
    first call and a second over the same keys find none; the second
    builds the union's residency, whose head holds every key's [2^128]A
    and caches it, so a third finds every one, and its resident dispatch
    leaves nothing to the card."""
    _, _, stats, batches = merged_call
    keys = {bytes(vk) for ents in batches for vk, _, _ in ents}
    assert stats["shift128_lookups"] == len(keys)
    assert stats["shift128_hits"] == 0  # fresh keys
    assert stats["shift128_device"] == len(keys)
    monkeypatch.setenv("ED25519_TPU_MIN_LANES", "128")
    # The shape is warm now, so the first device call's budget would be
    # 3 × prior × 8 batches: a loaded CPU must not read as a seized device.
    monkeypatch.setenv("ED25519_TPU_EMA_PRIOR", "10.0")
    devcache.set_default_cache(devcache.DeviceOperandCache(enabled=True))
    try:
        seen = []
        for _ in range(3):
            out = batch.verify_many(verifiers(batches), rng=rng,
                                    device="cpu", hybrid=False,
                                    merge="always")
            assert out == [i != BAD for i in range(N_BATCHES)]
            st = batch.last_run_stats
            assert st["shift128_lookups"] == len(keys)
            seen.append((st["shift128_hits"], st["shift128_device"]))
    finally:
        devcache.set_default_cache(None)
    assert seen == [(0, len(keys)), (0, len(keys)), (len(keys), 0)]
    assert metrics.drain_spans() == []  # the recorder was off


def test_buffer_keeps_the_newest_spans_up_to_its_bound():
    metrics.enable_spans()
    n = metrics.SPAN_BUFFER_MAX + 10
    for i in range(n):
        with metrics.span(str(i)):
            pass
    got = [s[NAME] for s in metrics.drain_spans()]
    assert got == [str(i) for i in range(10, n)]
    assert metrics.drain_spans() == []


def test_verify_timings_keep_their_stage_keys(monkeypatch):
    """`Verifier.verify(timings=...)` fills its stage seconds; the
    `metrics=` parameter and `BatchMetrics` are gone."""
    assert "metrics" not in inspect.signature(
        batch.Verifier.verify).parameters
    assert not hasattr(metrics, "BatchMetrics")
    monkeypatch.setenv("ED25519_TPU_MIN_LANES", "128")
    v = batch.Verifier()
    v.queue_bulk(make_entries(1, sigs_per_batch=4)[0])
    timings = {"kept": -1.0}
    v.verify(rng=rng, backend="device", device="cpu", timings=timings)
    assert set(timings) == {"kept", "stage_host", "device", "combine"}
    assert all(timings[k] > 0 for k in ("stage_host", "device", "combine"))
