"""`shift128_device_share`, the per-layer reading of the port's always-on
`shift128_device` / `shift128_lookups` counters: in tiny runs of each cell
on the CPU (zcash.sync's keys are fresh, so the card computes nearly every
[2^128]A; cometbft.sync's set is resident after the warm-up, so none), and
on stats written here."""

import pytest

from portbench import harness
from portbench.tests import tiny

CELLS = ["zcash.sync", "cometbft.sync"]


def _reader():
    return harness.module_from("metrics", "shift128_device_share")


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_device_counter(cell):
    keep = {}
    res = tiny.run(cell, seed=2**31 + 83, seconds=1.5, trace=1, keep=keep)
    share = res["metrics"]["shift128_device_share"]
    assert share["unit"] == "1"
    calls = keep["ctx"].record["calls"]
    lookups = sum(c["stats"]["shift128_lookups"] for c in calls)
    device = sum(c["stats"]["shift128_device"] for c in calls)
    hits = sum(c["stats"]["shift128_hits"] for c in calls)
    assert share["value"] == device / lookups
    if cell == "zcash.sync":  # every dispatch cold: hit or card, each key
        assert hits + device == lookups and share["value"] >= 0.99
    else:  # the warm-up made the validator set resident
        assert share["value"] == 0.0
        assert res["metrics"]["shift128_hit_share"]["value"] == 1.0


@pytest.mark.parametrize("stats", [
    [{}],                                            # a port without them
    [{"shift128_lookups": 4, "shift128_hits": 4}],   # no device counter
    [{"shift128_lookups": 0, "shift128_device": 0}],  # nothing staged
])
def test_no_counter_or_no_lookups_read_none(stats):
    ctx = harness.Context(record={"calls": [{"stats": st, "sigs": 1}
                                            for st in stats]})
    assert _reader().read(ctx) is None
    assert _reader().read(harness.Context(record={"calls": []})) is None


def test_share_sums_over_the_calls():
    calls = [{"stats": {"shift128_lookups": 3, "shift128_hits": 0,
                        "shift128_device": 3}},
             {"stats": {"shift128_lookups": 1, "shift128_hits": 1,
                        "shift128_device": 0}}]
    assert _reader().read(harness.Context(record={"calls": calls})) == 0.75
