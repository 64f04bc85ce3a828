"""A run of a cell at a tiny size on the CPU, through the port's plain
PyTorch versions of its kernels: for the tests, which cannot reach a card."""

import argparse
import time

from portbench import harness

TINY = {
    "zcash.sync": {"traffic": {"pool_keys": 131, "batch_size": 48,
                               "batches_per_call": 4}},
    "cometbft.sync": {"traffic": {"validators": 8, "heights": 12,
                                  "batches_per_call": 6,
                                  "tamper_within_calls": 2},
                      "entry": {"warm_calls": 2}},
}


def run(cell: str, seed: int = 2**31 + 5, seconds: float = 1.0,
        trace: int = 0, control: bool = False, keep=None) -> dict:
    import torch

    torch.set_num_threads(2)  # test workers share the machine's cores
    overrides = dict(TINY[cell], device="cpu", require_chip=False,
                     compare={"sample": 2, "workers": 1})
    if keep is not None:
        overrides["keep"] = keep
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=trace, control=control)
    return harness.run(args, time.perf_counter(), overrides)


if __name__ == "__main__":
    import sys

    harness.emit(run(sys.argv[1]))
    print(" ".join(harness.forbidden_modules()) or "none")
    print(" ".join(sorted({m.split(".", 1)[0] for m in sys.modules})))
