"""The benchmark's run: set-up from the seed, one measured window, the
comparison with the reference, and the result line.

Everything that belongs to one cell, configuration, traffic kind, driver
or metric sits in a file of its own and is found by name:

* `BENCHMARK.json` (at the root) names the cells and metrics;
* `portbench/workloads/<cell>.json` holds the cell's configuration name,
  its entry (driver and keyword arguments), its traffic (generator kind
  and parameters) and its comparison's sample size;
* `portbench/configs/<file>` holds the deployment's sizes and guarantees;
* `portbench/traffic/<kind>.py`, `portbench/drivers/<driver>.py` and
  `portbench/metrics/<metric>.py` are the generator, the driver and each
  metric's reader.

A metric's reader is `read(ctx) -> float | None`; None leaves the metric
out of the line."""

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

from portbench import compare

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ed25519_consensus_tpu")


class Refusal(Exception):
    """A run that must print no result: exit 2 with the reason."""


def forbidden_modules() -> "list[str]":
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (the port's name only starts with the latter's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def load_spec(cell: str) -> dict:
    """The cell's workload file, its configuration, and the metrics
    BENCHMARK.json has it report."""
    bench = ROOT / "BENCHMARK.json"
    if not bench.is_file():
        raise Refusal(f"{bench.name} is missing")
    spec = json.loads(bench.read_text())
    if cell not in {w["name"] for w in spec["workloads"]}:
        raise Refusal(f"{bench.name} has no cell {cell!r}")
    wl_file = PKG / "workloads" / f"{cell}.json"
    if not wl_file.is_file():
        raise Refusal(f"no workload file {wl_file.relative_to(ROOT)}")
    workload = json.loads(wl_file.read_text())
    cfg = {c["name"]: c for c in spec["configs"]}[workload["config"]]
    config = json.loads((ROOT / cfg["file"]).read_text())

    def applies(m):
        return cell in m.get("workloads", [cell])

    return {"workload": workload, "config": config,
            "end_to_end": [m for m in spec["end_to_end"] if applies(m)],
            "per_layer": [m for m in spec["per_layer"] if applies(m)]}


def module_from(folder: str, name: str):
    """portbench/<folder>/<name>.py as a module (names may hold dots)."""
    path = PKG / folder / f"{name}.py"
    if not path.is_file():
        raise Refusal(f"{path.relative_to(ROOT)} is missing")
    mod_name = f"portbench.{folder}.{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's own `build/` holds its kernels and host library)."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ.setdefault("USE_FLAX", "0")


def make_traffic(spec: dict, seed: int, overrides: dict):
    """The cell's traffic: the generator its kind names, given the
    configuration's sizes and the workload's traffic parameters."""
    sizes = {k: v for k, v in spec["config"].items()
             if isinstance(v, (int, float))}
    params = {**sizes, **spec["workload"]["traffic"],
              **overrides.get("traffic", {})}
    gen = module_from("traffic", params["kind"])
    return gen.Traffic(params, seed), params


class Context:
    """What a metric's reader may read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def read_metrics(metrics, ctx) -> dict:
    out = {}
    for m in metrics:
        value = module_from("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_info(torch, device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                device))}


def power_limit() -> "str | None":
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run(args, t_start: float, overrides: "dict | None" = None) -> dict:
    """One run; returns the result object (the caller prints it)."""
    overrides = overrides or {}
    spec = load_spec(args.workload)
    workload = spec["workload"]
    chips = int(workload["chips"])
    device_name = overrides.get("device", workload["entry"]["device"])
    cache_dirs()
    import torch

    device = torch.device(device_name)
    if overrides.get("require_chip", True):
        if not torch.cuda.is_available():
            raise Refusal("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < chips:
            raise Refusal(f"{torch.cuda.device_count()} CUDA devices, the "
                          f"cell needs {chips}")
    traffic, params = make_traffic(spec, args.seed, overrides)
    if args.control:
        return control_run(args, spec, traffic,
                           overrides.get("compare", workload["compare"]))
    if device.type == "cuda":
        from ed25519_consensus_tpu_torch import native
        from ed25519_consensus_tpu_torch.ops import _cuda

        if native.load() is None:
            raise Refusal("the port's native host library did not load")
        _cuda.load_all()
    entry = dict(workload["entry"], **overrides.get("entry", {}))
    driver = module_from("drivers", entry["driver"]).Driver(
        dict(workload, entry=entry, traffic=params), traffic, device_name)
    try:
        driver.warm()
        spans = [] if args.trace else None
        dtrace = None
        if args.trace and device.type == "cuda":
            from portbench import trace as trace_mod

            dtrace = trace_mod.DeviceTrace(device)
            dtrace.start()
        setup_s = time.perf_counter() - t_start
        record = driver.window(float(args.seconds), spans)
        trace = None
        if dtrace is not None:
            dtrace.stop()
            timeline = dtrace.timeline()
            if timeline is not None:
                trace = trace_mod.summarize(timeline, record["start"],
                                            record["end"], spans)
        dev = device_info(torch, device, chips)
    finally:
        driver.close()
    found = forbidden_modules()
    if found:
        raise Refusal(f"modules loaded that the port must not load: "
                      f"{', '.join(found)}")
    outcomes = driver.outcomes(record)
    cmp = overrides.get("compare", workload["compare"])
    verdicts = compare.compare(
        traffic, outcomes, args.seed, int(cmp["sample"]),
        int(cmp.get("workers", 4)))
    ctx = Context(record=record, driver=driver, setup_s=setup_s,
                  trace=trace, workload=workload, params=params,
                  traffic=traffic)
    if "keep" in overrides:  # tests read what the metrics read
        overrides["keep"]["ctx"] = ctx
    metrics = read_metrics(spec["per_layer"] if args.trace
                           else spec["end_to_end"], ctx)
    checks = {
        "verdict_mismatches": {"value": verdicts["mismatches"],
                               "limit": 0},
        "missing_verdicts": {"value": verdicts["failed"], "limit": 0},
        "device_rejects_overturned": {"value": overturned_rejects(record),
                                      "limit": 0},
        "tampered_units_unjudged": {
            "value": len(traffic.tampered) - verdicts["tampered"],
            "limit": 0},
    }
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if trace is not None:
        dev["busy_s"] = trace["busy_s"]
        dev["window_s"] = trace["window_s"]
    result = {"correct": correct, "attempted": len(outcomes),
              "failed": verdicts["failed"], "metrics": metrics,
              "device": dev}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
        result["power_limit"] = power_limit()
    result["window"] = driver.summary(record)
    result["compared"] = {"units": verdicts["compared"],
                          "tampered": verdicts["tampered"]}
    result["checks"] = checks
    return result


def overturned_rejects(record) -> int:
    """Device rejects of the window that the host overturned (a wrong
    K1-K4/K2t/K3 output), from the calls' `last_run_stats`."""
    return sum(c["stats"].get("device_rejects_overturned", 0)
               for c in record["calls"])


def control_run(args, spec, traffic, cmp) -> dict:
    """The control: the reference, with one guarantee broken, in the
    program's place, over the units of a window of the cell's size, judged
    by the same comparison (compare._control_jobs)."""
    n = int(spec["workload"]["compare"]["control_units"])
    outcomes = [(u, True) for u in range(n)]
    res = compare.compare(traffic, outcomes, args.seed,
                                int(cmp["sample"]),
                                int(cmp.get("workers", 4)),
                                control=spec["workload"]["compare"]["control"])
    return {"correct": res["mismatches"] == 0, "attempted": n, "failed": 0,
            "metrics": {}, "device": {"platform": "control"},
            "compared": {"units": res["compared"],
                         "tampered": res["tampered"]},
            "checks": {"verdict_mismatches": {"value": res["mismatches"],
                                              "limit": 0}}}


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="run the control (not a measurement)")
    return p.parse_args(argv)


def emit(result: dict) -> None:
    print(json.dumps(result, allow_nan=False), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    try:
        result = run(args, t_start)
    except Refusal as exc:
        print(f"portbench: {exc}", file=sys.stderr, flush=True)
        return 2
    emit(result)
    return 0
