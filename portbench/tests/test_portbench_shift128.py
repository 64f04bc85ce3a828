"""`shift128_hit_share`, the per-layer reading of the port's always-on
`shift128_lookups` / `shift128_hits` counters, in tiny runs of each cell on
the CPU; and that a run leaves the port's span recorder off and empty."""

import pytest

from portbench import harness
from portbench.tests import tiny

CELLS = ["zcash.sync", "cometbft.sync"]


def _reader():
    return harness.module_from("metrics", "shift128_hit_share")


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_shift128_counters(cell):
    from ed25519_consensus_tpu_torch.utils import metrics

    keep = {}
    res = tiny.run(cell, seed=2**31 + 79, seconds=1.5, trace=1, keep=keep)
    share = res["metrics"]["shift128_hit_share"]
    assert share["unit"] == "1"
    assert 0.0 <= share["value"] <= 1.0
    calls = keep["ctx"].record["calls"]
    lookups = sum(c["stats"]["shift128_lookups"] for c in calls)
    hits = sum(c["stats"]["shift128_hits"] for c in calls)
    assert 0 <= hits <= lookups and share["value"] == hits / lookups
    if cell == "cometbft.sync":  # the warm-up staged the fixed validator set
        assert share["value"] == 1.0
    assert metrics.drain_spans() == []  # the harness never turns spans on


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_records_no_program_span(cell):
    from ed25519_consensus_tpu_torch.utils import metrics

    keep = {}
    res = tiny.run(cell, trace=0, keep=keep)
    assert "shift128_hit_share" not in res["metrics"]
    assert not any("spans" in c for c in keep["ctx"].record["calls"])
    assert metrics.drain_spans() == []
    assert metrics.span("a") is metrics.span("b")  # the shared no-op


@pytest.mark.parametrize("stats", [
    [{}],                                           # a port without them
    [{"shift128_lookups": 0, "shift128_hits": 0}],  # nothing staged
])
def test_no_lookups_read_none(stats):
    ctx = harness.Context(record={"calls": [{"stats": st, "sigs": 1}
                                            for st in stats]})
    assert _reader().read(ctx) is None
    assert _reader().read(harness.Context(record={"calls": []})) is None


def test_share_sums_over_the_calls():
    calls = [{"stats": {"shift128_lookups": 3, "shift128_hits": 0}},
             {"stats": {"shift128_lookups": 1, "shift128_hits": 1}}]
    assert _reader().read(harness.Context(record={"calls": calls})) == 0.25
