"""The yardstick of K1's roofline: the copied prices, pinned to what
`chip_smoke.py`'s `k1_work` gives on one fixed wire, and the harness's
reckoning of every dispatch, checked against the wires the port hands K1
in a run."""

import importlib.util
import time

import numpy as np
import pytest

from portbench import roofline
from portbench.tests import tiny

# chip_smoke.k1_work on FIXED_WIRE (B = 2, N = 64, hints 0..3 in turn):
# (bytes, int32 operations, multiply-adds).
CHIP_SMOKE_K1_WORK = (24704, 5704000, 1678464)


def fixed_wire():
    B, N = 2, 64
    w = (np.arange(B * 33 * N, dtype=np.int64).reshape(B, 33, N) * 37
         % 256).astype(np.uint8)
    w[:, 32] = (np.arange(B * N).reshape(B, N) % 4).astype(np.uint8)
    return w


def test_k1_work_pinned_to_chip_smoke():
    assert roofline.k1_work(fixed_wire()) == CHIP_SMOKE_K1_WORK


def test_bound_is_the_larger_of_bytes_and_operations():
    w = roofline.k1_work(fixed_wire())
    assert roofline.bound_s(w) == pytest.approx(
        max(w[0] / 3.35e12, w[1] / (128 * 132 * 1.98e9),
            w[2] / (64 * 132 * 1.98e9)))
    assert roofline.bound_s(w) == w[1] / roofline.INT32_OPS_PER_S


def test_wire_hint_matches_the_port_native_staging():
    from ed25519_consensus_tpu_torch import native

    from portbench.traffic import signer

    if native.load() is None:
        pytest.skip("the port's native host library did not build here")
    encs = [e for e, _, _ in signer.zip215_matrix()[::14]]
    encs += signer.stepped_points(12345, 40)
    encs += signer.stepped_points(99 << 128, 20, 1 << 128)
    _, ok, hints = native.decompress_batch_buffer(b"".join(encs), len(encs))
    assert ok.all()
    assert [roofline.wire_hint(e) for e in encs] == [int(h) for h in hints]


@pytest.mark.parametrize("cell", ["zcash.sync", "cometbft.sync"])
def test_reckoning_equals_the_wires_k1_gets(cell, monkeypatch):
    from ed25519_consensus_tpu_torch.ops import msm

    from portbench import harness

    seen = []
    real = msm.expand_compressed_points

    def spy(points, *a, **kw):
        seen.append((time.perf_counter(), roofline.k1_work(
            np.asarray(points.cpu()))))
        return real(points, *a, **kw)

    monkeypatch.setattr(msm, "expand_compressed_points", spy)
    keep = {}
    tiny.run(cell, seconds=1.5, trace=1, keep=keep)
    ctx = keep["ctx"]
    rec = ctx.record
    got = [w for t, w in seen if rec["start"] <= t <= rec["end"]]
    reader = harness.module_from("metrics", "k1_roofline")
    want = reader.dispatch_work(ctx)
    assert want is not None and got == want
    if cell == "cometbft.sync":  # resident: only the R lanes reach K1
        assert all(c["stats"]["devcache"]["dispatch_hits"]
                   for c in rec["calls"])
