"""The port's race-audit harness: layers 3 and 4 over real threads.

What the JAX package's ``tests/conftest.py`` does for its own suites under
``ED25519_TPU_RACE_AUDIT=1``, as the port's own code, in one process.  The
harness reads that knob (through the port's ``config``, loaded before the
package): set, the run is audited as below; unset, the same workload runs
bare, with no monitor installed, as the baseline of the monitors' cost.
``consensuslint --race-audit`` sets it for its child.

1. ``arm()`` loads ``lockorder.py`` and ``race_audit.py`` STANDALONE, by
   file path, and installs the lock instrumentation BEFORE
   ``ed25519_consensus_tpu_torch`` is imported: the package's
   ``__init__`` imports ``batch``, whose module-level locks (and those of
   ``ops/msm``, ``health``, ``faults``, the metrics) are created at import
   and must be created instrumented.  Only locks created from the port's
   own files are instrumented (``lockorder._creation_site``).
2. ``instrument()`` patches the classes of ``guards.toml`` so every field
   the map guards reports its writes (``instrumented()``): a plain dict
   becomes a ``TrackedDict`` whose mutations are seen, any other value's
   rebinding is seen (in-place changes of a set, list or deque are not).
   The class-level fields in ``NOT_INSTRUMENTED`` are left out, each with
   its reason.
3. A workload runs on real threads: ``run_suites`` (pytest in-process over
   the port's threaded suites), ``cpu_scenario`` (a VerifyService on a
   FakeClock with concurrent submitters and a ReplicaSet pump through a
   replica crash) or ``device_workload`` (the cometbft128 stream through a
   ``VerifyService(device=..., hybrid=False)`` with four submitter threads,
   a ``ReplicaSet(3)`` pass through a crash and rejoin, a hybrid
   ``verify_many`` stream; every verdict held to the host's).
4. ``finish()`` writes the report (the race monitor's fields and flags and
   the lock graph's edges, cycles and layers) to ``--out`` or
   ``ED25519_TPU_RACE_AUDIT_OUT``, and the run fails on a flagged field, a
   lock cycle or a wrong verdict.

Run it as a script (never with ``-m``, which would import the package
before the locks are instrumented); without the knob each runs bare::

    export ED25519_TPU_RACE_AUDIT=1
    python ed25519_consensus_tpu_torch/analysis/harness.py --suites
    python ed25519_consensus_tpu_torch/analysis/harness.py --scenario
    python ed25519_consensus_tpu_torch/analysis/harness.py \\
        --device cuda:0 --fixture stream.json

or through ``python -m ed25519_consensus_tpu_torch.tools.consensuslint
--race-audit [--device cuda:0]``, which starts it in a subprocess.  The
last line of its output is the report's summary as JSON.  Exit codes: 0
clean, 1 a flagged field, a lock cycle, a wrong verdict or a failed suite.
"""

import importlib.util
import json
import os
import random
import sys
import threading
import time
import types

_HERE = os.path.dirname(os.path.abspath(__file__))
PORT_ROOT = os.path.dirname(_HERE)
REPO_ROOT = os.path.dirname(PORT_ROOT)
PACKAGE = os.path.basename(PORT_ROOT)

# The port's threaded suites (the JAX audit's eight, as the port names
# them).
SUITES = tuple(f"tests/test_torch_{name}.py" for name in (
    "service", "scheduler", "federation", "persist", "verdictcache",
    "straggler", "tenancy", "sentinel"))

# Fields guards.toml guards that no instance write reaches: class-level
# state, changed in place on the class, which the instance __setattr__
# the race monitor patches never sees.  (module, class, field) -> reason.
NOT_INSTRUMENTED = {
    ("batch", "_DeviceLane", "_instances"):
        "class-level lane registry, changed in place under _instance_lock",
    ("batch", "_DeviceLane", "_abandoned_instances"):
        "class-level list of abandoned lanes, appended under _instance_lock",
}


def _load(name: str, filename: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_HERE, filename))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def arm():
    """Install the lock instrumentation and wire the race monitor to its
    held-lock stacks → (lockorder, race_audit) modules.  Raises when the
    package was already imported: its module-level locks would be raw."""
    if PACKAGE in sys.modules:
        raise RuntimeError(f"{PACKAGE} is already imported: arm() must run "
                           f"before it, or its module-level locks are raw")
    lo = _load("_ed25519_torch_lockorder", "lockorder.py")
    ra = _load("_ed25519_torch_race_audit", "race_audit.py")
    lo.install()
    ra.MONITOR.held_provider = (
        lambda: [(name, oid) for oid, name in lo.MONITOR._stack()])
    return lo, ra


def instrumented() -> "dict[tuple[str, str], list[str]]":
    """{(module, class): fields}: every field guards.toml guards, less
    NOT_INSTRUMENTED.  Imports the package: call it after arm()."""
    from ed25519_consensus_tpu_torch.analysis import guards

    out = {}
    for g in guards.load_guards():
        key = (g.module[:-len(".py")].replace("/", "."), g.cls)
        fields = out.setdefault(key, [])
        fields += [f for f in g.fields
                   if (*key, f) not in NOT_INSTRUMENTED and f not in fields]
    return out


def instrument(ra) -> int:
    """Patch every class of guards.toml → the number of fields.  Each
    field goes in as a dict field: the patched __setattr__ notes every
    assignment and swaps a plain dict value for a TrackedDict, so the
    value's runtime type picks the instrumentation.  A field that is a
    class attribute, and is not in NOT_INSTRUMENTED with its reason, is an
    error: no instance write would ever report it."""
    import importlib

    def klass(module, cls):
        return getattr(importlib.import_module(f"{PACKAGE}.{module}"), cls)

    for module, cls, field in NOT_INSTRUMENTED:
        if field not in vars(klass(module, cls)):
            raise RuntimeError(f"{module}.{cls}.{field} is excluded as "
                               f"class-level state, and is not")
    n = 0
    for (module, cls), fields in instrumented().items():
        k = klass(module, cls)
        static = [f for f in fields if f in vars(k)]
        if static:
            raise RuntimeError(f"{module}.{cls}: class-level {static} can "
                               f"not be instrumented; list them in "
                               f"NOT_INSTRUMENTED with a reason")
        ra.instrument_class(k, f"{module}.{cls}", dict_fields=fields)
        n += len(fields)
    return n


def finish(lo, ra, out: "str | None" = None) -> dict:
    """The run's report: {"race": ..., "locks": ..., "fields_tracked",
    "flagged", "cycles"}, written as JSON to `out` when given."""
    ra.uninstrument_all()
    race = ra.finish()
    locks = lo.finish()
    report = {"fields_tracked": race["fields_tracked"],
              "flagged": race["flagged"], "cycles": locks["cycles"],
              "race": race, "locks": locks}
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        tmp = out + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        os.replace(tmp, out)
    return report


# -- workloads ----------------------------------------------------------------


class _Guard:
    """pytest plugin: the session must run on the port's instrumentation.
    tests/conftest.py installs the JAX package's own audit over it when
    ED25519_TPU_LOCK_AUDIT or ED25519_TPU_RACE_AUDIT is set in the
    environment; that run could not see the port's locks."""

    def __init__(self, lo):
        self.lo = lo

    def pytest_sessionstart(self, session):
        import threading as _threading

        if _threading.Lock is not self.lo._lock_factory:
            raise RuntimeError(
                "tests/conftest.py installed the JAX package's lock audit "
                "over the port's (ED25519_TPU_LOCK_AUDIT or "
                "ED25519_TPU_RACE_AUDIT is set); run without them")


def run_suites(lo, files=SUITES, extra=()) -> int:
    """pytest in-process over `files` (repo-relative) → pytest's exit
    code; `lo` None for a bare run.  The harness has read
    ED25519_TPU_RACE_AUDIT by now, and unsets it for the session: the
    reference's tests/conftest.py reads the same name and would install
    the JAX package's audit over the port's."""
    import pytest

    from ed25519_consensus_tpu_torch import config

    args = [os.path.join(REPO_ROOT, f) for f in files]
    args += ["-q", "-p", "no:cacheprovider", "-m", "not slow",
             "--rootdir", REPO_ROOT, *extra]
    plugins = [] if lo is None else [_Guard(lo)]
    with config.override(ED25519_TPU_RACE_AUDIT=None):
        return int(pytest.main(args, plugins=plugins))


def _entries(keys, msgs):
    return [(k.verification_key_bytes(), k.sign(m), m)
            for k, m in zip(keys, msgs)]


def cpu_scenario(log=print) -> dict:
    """A short threaded run on the CPU: four submitter threads against a
    VerifyService on a FakeClock pumped by a dispatcher thread (device
    waves on the plain kernels and host waves), then a ReplicaSet(3)
    pumped through one replica's crash while two threads submit.  →
    {"verdicts", "wrong", "seconds"}."""
    import torch

    from ed25519_consensus_tpu_torch import (SigningKey, batch, faults,
                                             federation, health, service)

    # The plain kernels run many small torch ops: one intra-op thread is
    # about as fast alone and keeps several such processes on one host
    # from oversubscribing its cores.
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    rng = random.Random(0xA11D)
    keys = [SigningKey.new(rng) for _ in range(6)]
    reqs = []
    for i in range(16):
        msgs = [b"audit %d/%d" % (i, j) for j in range(len(keys))]
        ents = _entries(keys, msgs)
        if i % 5 == 3:
            vk, sig, _ = ents[2]
            ents[2] = (vk, sig, b"tampered")
        reqs.append((ents, i % 5 != 3))
    clock = health.FakeClock()
    got, wrong = {}, []
    with service.VerifyService(device="cpu", auto_start=False, clock=clock,
                               health=health.DeviceHealth(clock=clock),
                               hybrid=False, chunk=2, merge="never",
                               mesh=0) as svc:
        tickets = {}

        def submitter(k):
            for i in range(k, len(reqs), 4):
                cls = ("consensus", "mempool")[i % 2]
                tickets[i] = svc.submit(reqs[i][0], cls=cls,
                                        tenant=f"t{i % 3}")

        subs = [threading.Thread(target=submitter, args=(k,))
                for k in range(4)]
        stop = threading.Event()

        def dispatcher():
            while not stop.is_set():
                if svc.process_once() == 0:
                    time.sleep(0.001)

        disp = threading.Thread(target=dispatcher)
        disp.start()
        for t in subs:
            t.start()
        for t in subs:
            t.join()
        deadline = time.perf_counter() + 120.0
        while len(tickets) < len(reqs) or not all(
                t.done() for t in tickets.values()):
            if time.perf_counter() > deadline:
                break
            time.sleep(0.002)
        stop.set()
        disp.join()
        for i, t in tickets.items():
            got[("svc", i)] = t.result(0)
    fclock = health.FakeClock()

    def host_replica(rid, clk, cache):
        return service.VerifyService(
            capacity_sigs=4096, clock=clk, auto_start=False,
            replica_id=f"r{rid}", cache=cache, mesh=0, device="cpu",
            health=service._HostOnlyHealth(clk))

    fs = federation.ReplicaSet(3, service_factory=host_replica,
                               clock=fclock)
    try:
        feds = {}
        first = batch.Verifier()
        first.queue_bulk(reqs[0][0])
        feds[0] = fs.submit(first, cls="consensus", tenant="chain-0")

        def fleet_submitter(k):
            for i in range(1 + k, len(reqs), 2):
                v = batch.Verifier()
                v.queue_bulk(reqs[i][0])
                feds[i] = fs.submit(v, cls="consensus",
                                    tenant=f"chain-{i % 3}")

        subs = [threading.Thread(target=fleet_submitter, args=(k,))
                for k in range(2)]
        with faults.injected(faults.replica_plan(
                1, "crash", replica=feds[0].replica_id)):
            for t in subs:
                t.start()
            deadline = time.perf_counter() + 120.0
            while (any(t.is_alive() for t in subs)
                   or not all(f.done() for f in feds.values())):
                if time.perf_counter() > deadline:
                    break
                fs.process_once()
            for t in subs:
                t.join()
        for i, f in feds.items():
            got[("fleet", i)] = f.result(0)
        ejected = fs.totals["ejections"]
    finally:
        fs.close()
    batch._DeviceLane.reset_all()
    for (kind, i), v in got.items():
        if v is not reqs[i][1]:
            wrong.append(f"{kind} {i}: {v!r}, host {reqs[i][1]}")
    if len(got) != 2 * len(reqs):
        wrong.append(f"{2 * len(reqs) - len(got)} request(s) lost")
    if not ejected:
        wrong.append("the crashed replica was never ejected")
    rec = {"verdicts": len(got), "wrong": wrong,
           "seconds": time.perf_counter() - t0}
    log(f"harness: cpu scenario {json.dumps(rec)}")
    return rec


def load_stream(path: str):
    """The fixture a caller wrote with `dump_stream` → (heights, tampered
    height, the host's verdicts or None); per height, (vk bytes,
    signature, msg) triples."""
    from ed25519_consensus_tpu_torch import Signature

    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    heights = [[(bytes.fromhex(vk), Signature.from_bytes(bytes.fromhex(s)),
                 bytes.fromhex(m)) for vk, s, m in h]
               for h in data["heights"]]
    return heights, data["bad"], data.get("host")


def dump_stream(path: str, heights, bad: int, host=None) -> None:
    """Write a commit stream for `--fixture`; `host`, the verdicts the
    exact host path gave each height, spares the harness recomputing
    them."""
    data = {"bad": bad, "host": host, "heights": [
        [(bytes(vk).hex(), sig.to_bytes().hex(), m.hex())
         for vk, sig, m in h] for h in heights]}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f)


def device_workload(heights, device: str, truth=None, log=print) -> dict:
    """The card run: (a) every commit of `heights` through
    VerifyService(device=device, hybrid=False) with its dispatcher thread
    and four submitter threads; (b) a ReplicaSet(3) of such services
    pumped through one pass of the first 48 commits (three chains), the
    home of chain 0 crashed halfway, then revived, probed on the card and
    rejoined; (c) a hybrid verify_many over the first 64 commits, one batch
    a commit, the host pool racing the lane.  Every verdict is held to the
    host's: `truth`, or `_host_verdict` of each commit.  → {"legs": ...,
    "wrong", "seconds"}."""
    from ed25519_consensus_tpu_torch import (batch, config, faults,
                                             federation, health, service,
                                             verdictcache)

    rng = random.Random(0xA11D)

    def verifier(ents):
        v = batch.Verifier()
        v.queue_bulk(ents)
        return v

    # One forced-device call before the clock starts: a fresh process
    # creates its CUDA context and loads the kernels here, so the legs'
    # seconds compare across processes.
    batch.verify_many([verifier(heights[0])], rng=rng, hybrid=False,
                      merge="never", device=device, mesh=0)
    t0 = time.perf_counter()
    if truth is None:
        truth = [batch._host_verdict(verifier(h), rng) for h in heights]
    t_truth = time.perf_counter() - t0
    wrong, legs = [], {}

    # (a) the front door: four submitters and the dispatcher thread
    t = time.perf_counter()
    # the memo off: every commit is verified on the card
    svc = service.VerifyService(
        device=device, hybrid=False, mesh=0, merge="never", chunk=8,
        verdict_cache=verdictcache.VerdictCache(enabled=False))
    tickets = {}
    try:
        def submitter(k):
            for i in range(k, len(heights), 4):
                tickets[i] = svc.submit(heights[i], cls="consensus",
                                        tenant="chain-0")

        subs = [threading.Thread(target=submitter, args=(k,))
                for k in range(4)]
        for th in subs:
            th.start()
        for th in subs:
            th.join()
        got = {i: tk.result(120.0) for i, tk in tickets.items()}
        st = svc.stats()
    finally:
        svc.close()
    wrong += [f"service commit {i}" for i in range(len(heights))
              if got.get(i) is not truth[i]]
    legs["service"] = {"commits": len(got),
                       "seconds": time.perf_counter() - t,
                       "device_waves": st["device_waves"],
                       "host_waves": st["host_waves"]}

    # (b) one fleet pass through a crash and a rejoin
    t = time.perf_counter()
    n_fleet = min(48, len(heights))

    def factory(rid, clock, cache):
        return service.VerifyService(
            clock=clock, auto_start=False, replica_id=f"r{rid}",
            cache=cache, device=device, hybrid=False, merge="never",
            mesh=0, chunk=8, health=health.DeviceHealth(mesh=0),
            breaker_seed=rid)

    with config.override(ED25519_TPU_VERDICT_CACHE_ENABLED="0"):
        fs = federation.ReplicaSet(3, service_factory=factory,
                                   device=device)
    feds = {}
    try:
        half = n_fleet // 2
        for block in (range(0, half), range(half, n_fleet)):
            if block.start == half:
                home = feds[0].replica_trail[0]
                faults.install(faults.replica_plan(0xA11D, "crash",
                                                   replica=home, at=0))
            sent = [i for i in block]
            for i in sent:
                feds[i] = fs.submit(verifier(heights[i]), cls="consensus",
                                    tenant=f"chain-{i % 3}")
            deadline = time.perf_counter() + 120.0
            while not all(feds[i].done() for i in sent) and \
                    time.perf_counter() < deadline:
                if fs.process_once() == 0:
                    time.sleep(0.0005)
        faults.uninstall()
        with config.override(ED25519_TPU_REPLICA_SUSPICION_HALF_LIFE="0.001"):
            deadline = time.perf_counter() + 30.0
            while fs.totals["rejoins"] < 1 and \
                    time.perf_counter() < deadline:
                fs.process_once()
                time.sleep(0.002)
        fleet = {k: fs.totals[k] for k in ("ejections", "reissued",
                                           "revivals", "probes", "rejoins",
                                           "host_floor")}
    finally:
        faults.uninstall()
        fs.close()
    wrong += [f"fleet commit {i}" for i in range(n_fleet)
              if feds[i].result(0) is not truth[i]]
    if not (fleet["ejections"] and fleet["rejoins"]):
        wrong.append(f"the fleet pass did not eject and rejoin: {fleet}")
    legs["fleet"] = {"commits": n_fleet, **fleet,
                     "seconds": time.perf_counter() - t}

    # (c) a hybrid verify_many stream: the host pool against the lane
    t = time.perf_counter()
    n_hyb = min(64, len(heights))
    out = batch.verify_many([verifier(h) for h in heights[:n_hyb]],
                            rng=rng, hybrid=True, merge="never",
                            device=device, mesh=0)
    wrong += [f"hybrid commit {i}" for i in range(n_hyb)
              if out[i] is not truth[i]]
    legs["hybrid"] = {"commits": n_hyb, "seconds": time.perf_counter() - t,
                      "device_batches":
                          batch.last_run_stats.get("device_batches"),
                      "host_batches": batch.last_run_stats.get("host_batches")}
    if not batch._DeviceLane.reset_all(timeout=60.0):
        wrong.append("a device-lane worker did not stop")
    rec = {"legs": legs, "wrong": wrong, "truth_seconds": t_truth,
           "seconds": time.perf_counter() - t0}
    log(f"harness: device workload {json.dumps(rec)}")
    return rec


# -- entry point --------------------------------------------------------------


def _parse(argv):
    import argparse

    ap = argparse.ArgumentParser(
        description="the port's lock-order and write-race audit")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--suites", nargs="*", default=None,
                      help="pytest over these files (default: SUITES)")
    mode.add_argument("--scenario", action="store_true",
                      help="the short CPU scenario")
    mode.add_argument("--device", default=None,
                      help="the device workload on this device (cuda:0)")
    ap.add_argument("--fixture", default=None,
                    help="with --device: the stream dump_stream wrote "
                         "(default: 64 heights of 128 signers, signed "
                         "here)")
    ap.add_argument("--out", default=None,
                    help="report path of a monitored run (default: "
                         "ED25519_TPU_RACE_AUDIT_OUT)")
    return ap.parse_args(argv)


def _signed_stream(n_heights: int, n_keys: int = 128):
    from ed25519_consensus_tpu_torch import SigningKey

    rng = random.Random(0xC0E7)
    keys = [SigningKey.new(rng) for _ in range(n_keys)]
    heights = [_entries(keys, [b"vote/height=%d/round=0/val=%d" % (h, i)
                               for i in range(n_keys)])
               for h in range(n_heights)]
    bad = min(77, n_heights - 1)
    vk, sig, _ = heights[bad][5]
    heights[bad][5] = (vk, sig, b"vote/tampered")
    return heights, bad


def _boot_config():
    """The port's config module, read before the package is imported: a
    bare parent module whose path is the port's directory resolves
    config's relative import of `error` without running the package's
    __init__ (whose module-level locks must wait for arm())."""
    name = "_ed25519_torch_boot"
    if name not in sys.modules:
        boot = types.ModuleType(name)
        boot.__path__ = [PORT_ROOT]
        sys.modules[name] = boot
    return importlib.import_module(f"{name}.config")


def main(argv=None) -> int:
    args = _parse(argv)
    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)
    t0 = time.perf_counter()
    boot = _boot_config()
    monitored = boot.get("ED25519_TPU_RACE_AUDIT")
    lo = ra = out = None
    n_fields = 0
    if monitored:
        out = args.out or boot.get("ED25519_TPU_RACE_AUDIT_OUT") or None
        lo, ra = arm()
        n_fields = instrument(ra)
    failed = []
    if args.scenario:
        rec = cpu_scenario()
        failed += rec["wrong"]
    elif args.device:
        truth = None
        if args.fixture:
            heights, _bad, truth = load_stream(args.fixture)
        else:
            heights, _bad = _signed_stream(64)
        rec = device_workload(heights, args.device, truth=truth)
        failed += rec["wrong"]
    else:
        files = args.suites if args.suites else SUITES
        rc = run_suites(lo, files)
        rec = {"suites": list(files), "pytest_exit": rc}
        if rc != 0:
            failed.append(f"pytest exited {rc}")
    seconds = time.perf_counter() - t0
    summary = {"seconds": seconds, "monitored": bool(monitored),
               "instrumented_fields": n_fields, "workload": rec}
    if not monitored:
        summary.update(fields_tracked=0, flagged=[], cycles=[], lock_edges=0,
                       lock_layers=[], report=None, failed=failed)
        print(json.dumps(summary, sort_keys=True))
        return 1 if failed else 0
    import torch

    # torch's own locks (the CUDA lazy-init lock, created when the package
    # imported torch under the instrumentation) stay raw
    lazy = getattr(torch.cuda, "_initialization_lock", None)
    summary["torch_locks_raw"] = lazy is not None and not isinstance(
        lazy, (lo._InstrumentedLock, lo._InstrumentedRLock))
    if not summary["torch_locks_raw"]:
        failed.append("torch's lazy-init lock was instrumented")
    report = finish(lo, ra, out)
    failed += [f"write race: {f}" for f in report["flagged"]]
    failed += ["lock cycle: " + " -> ".join(c) for c in report["cycles"]]
    print(ra.render(report["race"]))
    print(lo.render(report["locks"]))
    summary.update(
        fields_tracked=report["fields_tracked"], flagged=report["flagged"],
        cycles=report["cycles"], lock_edges=len(report["locks"]["edges"]),
        lock_layers=report["locks"]["partial_order"], report=out)
    summary["failed"] = failed
    sys.stdout.flush()
    print(json.dumps(summary, sort_keys=True))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
