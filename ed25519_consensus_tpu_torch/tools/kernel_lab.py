"""The kernel lab: every form of the window-sum kernel on the card, timed at
the production dispatch shape and gated on parity with the exact host MSM.
The port of the JAX package's tools/kernel_lab.py (`:24-296`).

    python -m ed25519_consensus_tpu_torch.tools.kernel_lab --exp sweep [--out F]
    python -m ed25519_consensus_tpu_torch.tools.kernel_lab --exp EXP

`--exp sweep` runs every form in `SWEEP` at B = 8 stacked batches of
N = 12,288 lanes over 64 distinct basepoint multiples (98,304 terms a call),
checks batch 0's window sums, Horner-combined on the host, against the exact
host MSM (the native runtime's, else exact Python; its time is logged),
times each form (CUDA events, the median of the repetitions, K1 excluded:
the operands are extended points), and prints one `kernel_sweep` JSON line
naming the fastest form whose parity holds and the arguments that pin it.  A
form that fails to build, fit, launch or agree is marked `error` or
`parity: fail` and never selected.  The other experiments are the JAX lab's
`exp_variant` forms at two lane counts, with the slope per 4,096 lanes.

Without a CUDA device every experiment prints a "skipped" line and exits 0:
the lab measures the card.  Its forms are held against the JAX package on
the CPU by tests/test_torch_variants.py and tests/test_torch_lab.py, which
call these functions with device="cpu" (the plain versions, host clock).
"""

import argparse
import json
import random
import statistics
import sys
import time

import numpy as np
import torch

from .. import native
from ..ops import edwards, msm

# The sweep: (name, entry, window_bits, keyword arguments, pin).  `entry`
# "many" is msm.window_sums_many on extended points, "tables_full"
# msm.window_sums_many_tables_full on batch 0's prebuilt tables (TB = 1).
# `pin`: what selects the form — the resident tables of the main path, or
# an argument of window_sums_many (window_bits, tbl_dtype, fold_dtype,
# win_chunk, body, chunk, arith).  An argument names a lab form, not a
# setting a verdict path can take: the verdict path runs the defaults.
SWEEP = (
    # the default K2 and K2t (csrc/window_sums_u32.cuh), then the 20-limb
    # kernels they replaced (arith="l20", csrc/window_sums.cuh)
    ("rolled-w33", "many", 4, {"win_chunk": 33},
     {"win_chunk": "33"}),
    ("rolled-w33-l20", "many", 4, {"win_chunk": 33, "arith": "l20"},
     {"arith": "l20"}),
    ("tables-w33", "tables_full", 4, {"win_chunk": 33},
     {"resident": "devcache tables (ED25519_TPU_DEVCACHE_TABLES)"}),
    ("tables-w33-l20", "tables_full", 4, {"win_chunk": 33, "arith": "l20"},
     {"resident": "devcache tables", "arith": "l20"}),
    # the JAX sweep's candidates (tools/kernel_lab.py:160-181)
    ("rolled-w11", "many", 4, {"win_chunk": 11},
     {"win_chunk": "11"}),
    ("int16-fold-w11", "many", 4, {"win_chunk": 11, "fold_dtype": "int16"},
     {"win_chunk": "11", "fold_dtype": "int16"}),
    ("radix32-w9", "many", 5, {"win_chunk": 9},
     {"window_bits": "5", "win_chunk": "9"}),
    ("radix32-w27", "many", 5, {"win_chunk": 27},
     {"window_bits": "5", "win_chunk": "27"}),
    ("tables-ref-w11", "tables_full", 4, {"win_chunk": 11},
     {"resident": "devcache tables (ED25519_TPU_DEVCACHE_TABLES)",
      "win_chunk": "11"}),
    # the JAX lab's exp_variant forms (tools/kernel_lab.py:252-276)
    ("int32-table-c64", "many", 4, {"tbl_dtype": "int32", "win_chunk": 33},
     {"tbl_dtype": "int32"}),
    ("int32-table-c32", "many", 4,
     {"tbl_dtype": "int32", "chunk": 32, "win_chunk": 33},
     {"tbl_dtype": "int32", "chunk": "32"}),
    ("hybrid-w33", "many", 4, {"body": "hybrid", "win_chunk": 33},
     {"body": "hybrid"}),
    ("hybrid-w3", "many", 4, {"body": "hybrid", "win_chunk": 3},
     {"body": "hybrid", "win_chunk": "3"}),
    ("rolled-w3", "many", 4, {"win_chunk": 3},
     {"win_chunk": "3"}),
    ("rolled-w1", "many", 4, {"win_chunk": 1},
     {"win_chunk": "1"}),
    # the port's other radix-32 instantiations
    ("radix32-int32-table-c32", "many", 5,
     {"tbl_dtype": "int32", "win_chunk": 27},
     {"window_bits": "5", "tbl_dtype": "int32"}),
    ("tables-radix32-w27", "tables_full", 5, {"win_chunk": 27},
     {"window_bits": "5", "resident": "devcache tables"}),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def build_operands(n_lanes: int, B: int = 1, seed: int = 7,
                   window_bits: int = 4):
    """(scalars, host points, digits (B, nwin, N) int8, extended points
    (B, 4, NLIMBS, N) int16): 64 distinct basepoint multiples tiled over
    the lanes and uniform 128-bit scalars, every batch alike.  The same
    seed gives the same terms at both radixes."""
    rng = random.Random(seed)
    pts = [edwards.BASEPOINT.scalar_mul(rng.randrange(1, 2**252))
           for _ in range(min(n_lanes, 64))]
    pts = [pts[i % len(pts)] for i in range(n_lanes)]
    sc = [rng.randrange(2**128) for _ in range(n_lanes)]
    digits, ext = msm.pack_msm_operands(sc, pts, n_lanes=n_lanes,
                                        window_bits=window_bits)
    digits = np.broadcast_to(digits, (B,) + digits.shape).copy()
    ext = np.broadcast_to(ext, (B,) + ext.shape).copy()
    return sc, pts, digits, ext


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_calls(fn, dev, reps: int = 5) -> float:
    """Median seconds of fn() over `reps` runs after one warm-up run: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    sync(dev)
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
    return statistics.median(times)


def host_msm(sc, pts):
    """The exact host MSM Σ[c_i]P_i: the native runtime's vartime MSM, or
    exact Python without it; logs which and its time."""
    t = time.perf_counter()
    lib = native.load()
    if lib is not None:
        want, how = native._vartime_msm_raw(lib, sc, pts), "native"
    else:
        want, how = edwards.multiscalar_mul(sc, pts), "exact Python"
    log(f"#   host MSM of {len(sc)} terms ({how}): "
        f"{time.perf_counter() - t:.3f} s")
    return want


def check_parity(out, want, label: str, window_bits: int = 4) -> bool:
    """Batch 0's window sums, Horner-combined on the host, against the
    exact host MSM `want`."""
    got = msm.combine_window_sums(out[:1].cpu().numpy(),
                                  window_bits=window_bits)
    ok = got == want
    log(f"#   parity[{label}]: {'OK' if ok else 'MISMATCH'}")
    return ok


def sweep_form(entry: str, window_bits: int, kw: dict):
    """msm.kernel_form of a sweep form: (base, suffix, chunk, W) of the K2
    or K2t instantiation it launches."""
    arith = kw.get("arith", "u32")
    if entry == "tables_full":
        return msm.kernel_form("window_sums_tables", window_bits,
                               win_chunk=kw["win_chunk"], arith=arith)
    return msm.kernel_form("window_sums", window_bits,
                           kw.get("tbl_dtype", "int16"),
                           kw.get("fold_dtype", "int32"),
                           kw.get("body", "rolled"), kw.get("chunk", 64),
                           kw["win_chunk"], arith)


def sweep_call(entry: str, window_bits: int, kw: dict, digits, ext,
               tables, dev):
    """One call of a sweep form on tensors already on `dev`; `tables` is
    the table tensor for `tables_full` forms."""
    if entry == "tables_full":
        return msm.window_sums_many_tables_full(
            digits, tables, window_bits=window_bits, device=dev, **kw)
    return msm.window_sums_many(digits, ext, window_bits=window_bits,
                                body=kw.pop("body", "rolled"), device=dev,
                                **kw)


def sweep_operands(chunk_b: int, n_lanes: int, dev):
    """({window_bits: (digits, extended points) on `dev`}, the exact host
    MSM of batch 0): the sweep's operands at both radixes, which carry the
    same terms, so one host MSM serves both."""
    ops = {}
    want = None
    for wb in (4, 5):
        sc, pts, digits, ext = build_operands(n_lanes, B=chunk_b,
                                              window_bits=wb)
        ops[wb] = (torch.from_numpy(digits).to(dev),
                   torch.from_numpy(ext).to(dev))
        if want is None:
            want = host_msm(sc, pts)
    return ops, want


def exp_sweep(chunk_b: int = 8, n_lanes: int = 12288, out_path=None,
              device=None, reps: int = 5, emit: bool = True,
              operands=None) -> dict:
    """The variant sweep (the JAX lab's exp_sweep, `:135-222`): every form
    of `SWEEP` at (chunk_b, n_lanes), parity-gated, timed; returns the
    `kernel_sweep` dict (printed as one JSON line when `emit`).
    `operands`: sweep_operands' result, made here when None."""
    dev = msm.resolve_device(device)
    ops, want = operands or sweep_operands(chunk_b, n_lanes, dev)
    tables = {}
    results = {}
    for name, entry, wb, kw, pin in SWEEP:
        row = {"pin": pin}
        digits, ext = ops[wb]
        try:
            t0 = time.perf_counter()
            if entry == "tables_full" and wb not in tables:
                tables[wb] = msm.multiples_tables(ext[:1], window_bits=wb)

            def fn(entry=entry, wb=wb, kw=kw, digits=digits, ext=ext):
                return sweep_call(entry, wb, dict(kw), digits, ext,
                                  tables.get(wb), dev)

            out = fn()
            sync(dev)
            row["first_call_s"] = round(time.perf_counter() - t0, 3)
            row["parity"] = "ok" if check_parity(out, want, name, wb) \
                else "fail"
            t = timed_calls(fn, dev, reps)
        except Exception as e:  # noqa: BLE001 - disqualify, keep sweeping
            row["error"] = f"{type(e).__name__}: {str(e)[:200]}"
            results[name] = row
            log(f"#   {name}: FAILED {row['error']}")
            continue
        row["ms_per_call"] = t * 1e3
        row["terms_per_sec"] = chunk_b * n_lanes / t
        results[name] = row
        log(f"#   {name}: {row['ms_per_call']:.4f} ms/call -> "
            f"{row['terms_per_sec']:.0f} terms/s (parity {row['parity']})")
    ok_rows = {n: r for n, r in results.items() if r.get("parity") == "ok"}
    selected = (max(ok_rows, key=lambda n: ok_rows[n]["terms_per_sec"])
                if ok_rows else None)
    sweep = {"kernel_sweep": {
        "device": device_name(dev),
        "shape": [chunk_b, n_lanes],
        "reps": reps,
        "results": results,
        "selected": selected,
        "pin": results[selected]["pin"] if selected else None,
    }}
    if emit:
        print(json.dumps(sweep), flush=True)
    if out_path:
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(sweep, f, indent=1, sort_keys=True)
            f.write("\n")
    return sweep


def exp_variant(name: str, device=None, sizes=(4096, 16384), reps: int = 5,
                **kw):
    """One form at two lane counts (B = 1): parity at the first, times at
    both, and the slope per 4,096 lanes (the JAX lab's exp_variant,
    `:105-132`).  Returns {"rows": [(n_lanes, seconds)], "slope_s"}, or
    None when the form failed."""
    dev = msm.resolve_device(device)
    wb = kw.pop("window_bits", 4)
    log(f"# exp {name}: window_bits={wb} {kw}")
    rows = []
    for n_lanes in sizes:
        sc, pts, digits, ext = build_operands(n_lanes, window_bits=wb)
        d = torch.from_numpy(digits).to(dev)
        e = torch.from_numpy(ext).to(dev)

        def fn(d=d, e=e):
            return msm.window_sums_many(d, e, window_bits=wb, device=dev,
                                        **{"body": "rolled", **kw})

        try:
            t0 = time.perf_counter()
            out = fn()
            sync(dev)
            log(f"#   n={n_lanes}: first call {time.perf_counter() - t0:.3f}"
                f" s")
        except Exception as e:  # noqa: BLE001 - report, keep the lab going
            log(f"#   n={n_lanes}: FAILED {type(e).__name__}: "
                f"{str(e)[:200]}")
            return None
        if n_lanes == sizes[0] and not check_parity(
                out, host_msm(sc, pts), name, wb):
            return None
        t = timed_calls(fn, dev, reps)
        rows.append((n_lanes, t))
        log(f"#   n={n_lanes}: {t * 1e3:.4f} ms/call")
    (n1, t1), (n2, t2) = rows[0], rows[-1]
    slope = (t2 - t1) / ((n2 - n1) / 4096)
    log(f"#   slope: {slope * 1e3:.4f} ms per 4096-term block")
    return {"rows": rows, "slope_s": slope}


def exp_baseline(device=None, reps: int = 5):
    """The default form at 4,096 / 8,192 / 16,384 lanes, and B = 1 against
    B = 4 stacked batches (the JAX lab's exp_baseline, `:70-102`)."""
    dev = msm.resolve_device(device)
    log("# exp baseline: the default form")
    exp_variant("default", device=dev, sizes=(4096, 8192, 16384), reps=reps)
    sc, pts, digits, ext = build_operands(4096, B=4)
    d = torch.from_numpy(digits).to(dev)
    e = torch.from_numpy(ext).to(dev)
    t = timed_calls(lambda: msm.window_sums_many(
        d, e, win_chunk=33, body="rolled", device=dev), dev, reps)
    log(f"#   n=4096 B=4: {t * 1e3:.4f} ms/call ({t * 1e3 / 4:.4f} "
        f"ms/batch)")


# --exp name -> (label, keyword arguments) of an exp_variant form: the JAX
# lab's, with its tile (S, 128) read as lanes a block (S = 16 → 32 lanes,
# 32 → 64).  Its int16-table tile-8/16 forms (s8, s16, all8) have no
# instantiation here: int16 tables at 32 lanes are not built.
_VARIANTS = {
    "i32": ("int32-table-c32", {"tbl_dtype": "int32", "chunk": 32}),
    "i32big": ("int32-table-c64", {"tbl_dtype": "int32"}),
    "w1": ("winchunk1", {"win_chunk": 1}),
    "w3": ("winchunk3", {"win_chunk": 3}),
    "w11": ("winchunk11", {"win_chunk": 11}),
    "w11i32": ("winchunk11-i32-c32",
               {"tbl_dtype": "int32", "chunk": 32, "win_chunk": 11}),
    "rolled": ("rolled-w11", {"win_chunk": 11}),
    "hybrid": ("hybrid-w3", {"body": "hybrid", "win_chunk": 3}),
    "i16fold": ("int16-fold-w11", {"fold_dtype": "int16", "win_chunk": 11}),
    "r32": ("radix32-w27", {"window_bits": 5, "win_chunk": 27}),
}
_GROUPS = {"all": ("i32", "w11", "r32"), "allw": ("w1", "w3", "w11",
                                                 "w11i32"),
           "ab": ("rolled", "hybrid")}
_EXPS = ("baseline", "sweep", "rolledB8") + tuple(_VARIANTS) + tuple(_GROUPS)


def build_kernels() -> None:
    """Builds every missing source at once (one nvcc each, in parallel):
    the lab's forms are outside the verdict set a verdict path builds, and
    would otherwise build one by one at their first launches."""
    from ..ops import _cuda

    t = time.perf_counter()
    built = _cuda.build_all()
    log(f"# built {len(built)} sources in {time.perf_counter() - t:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # choices= so a stale experiment name errors instead of running nothing
    ap.add_argument("--exp", default="baseline", choices=_EXPS)
    ap.add_argument("--out", default=None,
                    help="sweep only: also write the kernel_sweep JSON to "
                         "this path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log(f"# {args.exp}: SKIPPED — no CUDA device (the lab times the "
            f"kernels on the card; its forms are held against the JAX "
            f"package on the CPU by tests/test_torch_variants.py)")
        return 0
    dev = torch.device("cuda")
    log(f"# device: {device_name(dev)}, {torch.cuda.device_count()} "
        f"visible; torch {torch.__version__}")
    build_kernels()
    if args.exp == "sweep":
        exp_sweep(out_path=args.out, device=dev)
    elif args.exp == "baseline":
        exp_baseline(dev)
    elif args.exp == "rolledB8":
        sc, pts, digits, ext = build_operands(12288, B=8)
        d = torch.from_numpy(digits).to(dev)
        e = torch.from_numpy(ext).to(dev)
        t = timed_calls(lambda: msm.window_sums_many(
            d, e, win_chunk=11, body="rolled", device=dev), dev)
        log(f"#   B=8 N=12288 rolled-w11: {t * 1e3:.4f} ms/call "
            f"({t * 1e3 / 8:.4f} ms/batch)")
    else:
        for key in _GROUPS.get(args.exp, (args.exp,)):
            label, kw = _VARIANTS[key]
            exp_variant(label, device=dev, **dict(kw))
    return 0


if __name__ == "__main__":
    sys.exit(main())
