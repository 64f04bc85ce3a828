"""Micro-probes and the stage profile of the window-sum kernel on the card.
The port of the JAX package's tools/microbench_pallas.py (`:1-262`).

    python -m ed25519_consensus_tpu_torch.tools.microbench
    python -m ed25519_consensus_tpu_torch.tools.microbench --profile-ledger [B N]

With no argument: the micro-probes, a chain of dependent int32 additions,
multiplies, multiply-adds and shifts on a (32, 128) tile (additions also on
(8, 128)), and a chain of field multiplies on (20, 32, 128) and (20, 8,
128), each timed at two chain lengths (CHAIN_STEPS, FMUL_STEPS); the slope
is the cost of one step (ns per operation, µs per field multiply).

`--profile-ledger`: the stage decomposition of one production-shape call
(B = 8, N = 12,288 by default) as differences of four real forms at the
same shape, each the median of 5 CUDA-event times: the full call (K2 + K3),
K2 alone, K2t on prebuilt tables (TB = B), and K2s, the select-only form.
It prints one `device_program_profile` JSON line with the JAX tool's keys:
table_build_ms = K2 − K2t, fold_in_kernel_ms = K2t − K2s, select_ms = K2s,
xla_fold_ms = full − K2 (here the K3 fold).  The windows per block are the
port's default, every window in one block, unless `win_chunk` is given.

Without a CUDA device it prints a "skipped" line and exits 0.
"""

import argparse
import json
import sys

import numpy as np
import torch

from ..ops import msm, probes
from ..ops.limbs import NLIMBS, NWINDOWS
from . import kernel_lab
from .kernel_lab import device_name, log, timed_calls


# Chain lengths.  The JAX tool's (64, 512) steps and (1, 8) multiplies
# run shorter on the card than the launch around them (their slopes came
# out negative, PERF.md), so the port's probes time chains long enough for
# the kernel to dominate; the lengths are arguments.
CHAIN_STEPS = (4096, 65536)
FMUL_STEPS = (64, 1024)


def probe_chain(op: str, tile=(32, 128), n_steps=CHAIN_STEPS, device=None,
                reps: int = 5) -> dict:
    """The chain of `op` on an (S, L) tile at two lengths; ns per step
    from the slope (the JAX tool's probe_chain, `:41-79`)."""
    dev = msm.resolve_device(device)
    S, L = tile
    x = torch.from_numpy(np.arange(S * L, dtype=np.int32).reshape(S, L)
                         % 97).to(dev)
    t = [timed_calls(lambda n=n: probes.chain(x, op, n), dev, reps)
         for n in n_steps]
    per_op = (t[1] - t[0]) / (n_steps[1] - n_steps[0])
    log(f"#   chain[{op}] tile={tuple(tile)}: {per_op * 1e9:.4f} ns/op "
        f"(t{n_steps[0]}={t[0] * 1e3:.4f}ms t{n_steps[1]}="
        f"{t[1] * 1e3:.4f}ms)")
    return {"op": op, "tile": list(tile), "n_steps": list(n_steps),
            "ms": [v * 1e3 for v in t], "ns_per_op": per_op * 1e9}


def probe_fmul(tile=(32, 128), n_steps=FMUL_STEPS, device=None,
               reps: int = 5) -> dict:
    """A chain of field multiplies (the kernels' fe_mul) on a (20, S, L)
    tile at two lengths; µs per multiply from the slope (the JAX tool's
    probe_fmul, `:82-116`)."""
    dev = msm.resolve_device(device)
    S, L = tile
    x = torch.from_numpy(np.arange(NLIMBS * S * L, dtype=np.int32)
                         .reshape(NLIMBS, S, L) % 1000).to(dev)
    t = [timed_calls(lambda n=n: probes.fmul_chain(x, n), dev, reps)
         for n in n_steps]
    per = (t[1] - t[0]) / (n_steps[1] - n_steps[0])
    log(f"#   fmul chain tile={tuple(tile)}: {per * 1e6:.4f} us/fmul "
        f"(t{n_steps[0]}={t[0] * 1e3:.4f}ms t{n_steps[1]}="
        f"{t[1] * 1e3:.4f}ms)")
    return {"tile": list(tile), "n_steps": list(n_steps),
            "ms": [v * 1e3 for v in t], "us_per_fmul": per * 1e6}


def run_probes(device=None, reps: int = 5) -> list:
    """The JAX tool's default probe set (its main, `:251-257`)."""
    out = [probe_chain(op, device=device, reps=reps)
           for op in ("add", "mul", "madd", "shift")]
    out.append(probe_chain("add", tile=(8, 128), device=device, reps=reps))
    out.append(probe_fmul(device=device, reps=reps))
    out.append(probe_fmul(tile=(8, 128), device=device, reps=reps))
    return out


def profile_forms(digits, ext, tables, win_chunk: int):
    """The four forms of the stage profile on tensors already on one
    device: {name: zero-argument call}."""
    return {
        "pipeline_full": lambda: msm.window_sums_many(
            digits, ext, win_chunk=win_chunk, body="rolled",
            device=digits.device),
        "kernel_full": lambda: msm.window_partials(
            digits, ext, win_chunk=win_chunk),
        "kernel_tables": lambda: msm.window_partials_tables(
            digits, tables, win_chunk=win_chunk),
        "kernel_select_only": lambda: msm.select_only(
            digits, tables, win_chunk=win_chunk),
    }


def profile_ledger(chunk_b: int = 8, n_lanes: int = 12288, reps: int = 5,
                   win_chunk=None, device=None, operands=None) -> dict:
    """The `device_program_profile` block (the JAX tool's profile_ledger,
    `:119-229`): every bucket the difference of two real forms' medians at
    the same (chunk_b, n_lanes).  `operands`: the lab's radix-16 (digits,
    extended points) tensors on the device, built here when None.  Returns
    the ledger (printed as JSON)."""
    dev = msm.resolve_device(device)
    W = NWINDOWS if win_chunk is None else win_chunk
    if operands is None:
        _, _, digits, ext = kernel_lab.build_operands(n_lanes, B=chunk_b)
        operands = (torch.from_numpy(digits).to(dev),
                    torch.from_numpy(ext).to(dev))
    d, e = operands
    tables = msm.multiples_tables(e)
    forms = {}
    for name, fn in profile_forms(d, e, tables, W).items():
        forms[name] = timed_calls(fn, dev, reps)
        log(f"#   {name}: {forms[name] * 1e3:.4f} ms/call")
    ms = {k: v * 1e3 for k, v in forms.items()}
    ledger = {
        "device": device_name(dev),
        "shape": [chunk_b, n_lanes],
        "win_chunk": W,
        "reps": reps,
        "total_ms": ms["pipeline_full"],
        "kernel_ms": ms["kernel_full"],
        "table_build_ms": ms["kernel_full"] - ms["kernel_tables"],
        "select_ms": ms["kernel_select_only"],
        "fold_in_kernel_ms": ms["kernel_tables"] - ms["kernel_select_only"],
        "xla_fold_ms": ms["pipeline_full"] - ms["kernel_full"],
        "terms_per_sec_full": chunk_b * n_lanes / forms["pipeline_full"],
        "terms_per_sec_tables_resident": chunk_b * n_lanes / (
            forms["kernel_tables"]
            + forms["pipeline_full"] - forms["kernel_full"]),
    }
    print(json.dumps({"device_program_profile": ledger}), flush=True)
    return ledger


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile-ledger", nargs="*", type=int, default=None,
                    metavar=("B", "N"),
                    help="emit the stage profile at shape [B N] (default "
                         "8 12288) instead of the micro-probes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        what = "profile ledger" if args.profile_ledger is not None \
            else "micro-probes"
        log(f"# {what}: SKIPPED — no CUDA device (the probes and the "
            f"profile time the card)")
        return 0
    dev = torch.device("cuda")
    log(f"# device: {device_name(dev)}; torch {torch.__version__}")
    kernel_lab.build_kernels()
    if args.profile_ledger is not None:
        shape = args.profile_ledger + [8, 12288][len(args.profile_ledger):]
        profile_ledger(chunk_b=shape[0], n_lanes=shape[1], device=dev)
    else:
        run_probes(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
