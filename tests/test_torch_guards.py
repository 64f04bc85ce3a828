"""The concurrency half of the port's analysis (analysis/guards.py,
lockorder.py, race_audit.py, harness.py) against the JAX package's, on
the CPU.

* CL008/CL009 parity: every fixture of the reference's tests/test_guards.py
  is checked by both packages' rules at the matching package-relative
  path (the reference test's own helpers swapped for ones that run both);
  findings and messages must be equal.
* The committed guards.toml maps the port's own classes and resolves
  against the port's tree; drift is an error.
* Monitor parity: the same scripted event sequences, fed to both
  LockOrderMonitors and both RaceMonitors, give equal reports.  One case
  differs on purpose: a hand-off from a joined thread to the next thread
  started.  The interpreter may give the second thread the first one's
  identity, and the reference keys writers by identity; the port keys them
  by a per-thread serial, so the hand-off is two writers and is clean.  The
  port's result is asserted; the reference's is not relied on.
* The harness: a short threaded scenario in a subprocess (the analysis
  loads before the package); the eight-suite run is marked slow (about a
  minute: it re-runs those suites).
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys
import threading
import weakref
from pathlib import Path

import pytest

from ed25519_consensus_tpu.analysis import guards as jguards
from ed25519_consensus_tpu.analysis import linter as jlinter
from ed25519_consensus_tpu.analysis import lockorder as jlockorder
from ed25519_consensus_tpu.analysis import race_audit as jrace
from ed25519_consensus_tpu_torch.analysis import guards, linter, lockorder
from ed25519_consensus_tpu_torch.analysis import race_audit

from torch_threads import _one_torch_thread  # noqa: F401


ROOT = Path(__file__).resolve().parent.parent
REF_TESTS = ROOT / "tests" / "test_guards.py"
JPKG, PPKG = "ed25519_consensus_tpu/", "ed25519_consensus_tpu_torch/"


def _fixture_tests() -> "list[str]":
    tree = ast.parse(REF_TESTS.read_text(encoding="utf-8"))
    return [n.name for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")
            and not n.args.args
            and {x.id for x in ast.walk(n) if isinstance(x, ast.Name)}
            & {"cl008", "cl009"}]


def _key(findings, prefix):
    return sorted((f.rule, f.path[len(prefix):], f.line, f.col, f.symbol,
                   f.message) for f in findings)


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location("_reference_test_guards",
                                                  REF_TESTS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", _fixture_tests())
def test_rule_parity_on_reference_fixtures(name, reference, monkeypatch):
    pairs = []

    def both(rule, relpath, source, guard_list=None):
        jmod = jlinter.ParsedModule(path="<f>", source=source,
                                    relpath=JPKG + relpath)
        pmod = linter.ParsedModule(path="<f>", source=source,
                                   relpath=PPKG + relpath)
        if rule == "CL008":
            j = list(jguards.check_cl008(jmod, guards=guard_list))
            p = list(guards.check_cl008(pmod, guards=[
                guards.ClassGuard(g.module, g.cls, g.lock, g.fields,
                                  g.accessors) for g in guard_list]))
        else:
            j = list(jguards.check_cl009(jmod))
            p = list(guards.check_cl009(pmod))
        pairs.append((relpath, _key(j, JPKG), _key(p, PPKG)))
        return j

    monkeypatch.setattr(reference, "cl008",
                        lambda r, s, g: both("CL008", r, s, g))
    monkeypatch.setattr(reference, "cl009",
                        lambda r, s: both("CL009", r, s))
    getattr(reference, name)()
    assert pairs
    for relpath, jkey, pkey in pairs:
        assert pkey == jkey, relpath


def test_parity_collects_both_rules():
    names = _fixture_tests()
    assert sum("cl008" in n for n in names) >= 9
    assert sum("cl009" in n for n in names) >= 12


def test_cl009_holds_synchronisation_under_a_lock():
    """The port's dispatch verbs include a stream or device synchronise."""
    src = ("class S:\n"
           "    def drain(self, stream):\n"
           "        with self._lock:\n"
           "            stream.synchronize()\n")
    findings = list(guards.check_cl009(linter.ParsedModule(
        path="<f>", source=src, relpath=PPKG + "batch.py")))
    assert [f.rule for f in findings] == ["CL009"]


# -- the committed map -------------------------------------------------------

PORT_CLASSES = {"VerifyService", "CircuitBreaker", "_DeviceLane",
                "LatencyLedger", "ChipRegistry", "ReplicaRegistry",
                "DeviceOperandCache", "VerdictCache", "VerdictJournal",
                "ReplicaSet"}


def test_committed_map_resolves_against_the_port():
    committed = guards.load_guards()
    guards.verify_mapping(guards=committed)
    assert {g.cls for g in committed} == PORT_CLASSES
    st = guards.guard_stats(committed)
    assert st["guarded_classes"] == 10 and st["guarded_fields"] >= 50
    lane = {g.lock: g for g in committed if g.cls == "_DeviceLane"}
    # the port's own fields: the sticky-error hold and the device-error
    # wave the federation reads
    assert "_held_error" in lane["_cv"].fields
    svc = next(g for g in committed if g.cls == "VerifyService")
    assert "last_device_error" in svc.fields


def test_committed_map_against_the_reference():
    """Every field the reference maps is mapped by the port too, under the
    same lock, where the port's class has it."""
    mine = {(g.module, g.cls, g.lock): g.fields for g in guards.load_guards()}
    for g in jguards.load_guards():
        assert g.fields <= mine[(g.module, g.cls, g.lock)], (g.cls, g.lock)


def test_real_tree_has_no_concurrency_finding():
    findings = [f for f in linter.lint_package()
                if f.rule in ("CL008", "CL009")]
    assert findings == []


_DRIFT_SRC = ("import threading\n"
              "class Box:\n"
              "    def __init__(self):\n"
              "        self._lock = threading.Lock()\n"
              "        self._state = 'closed'\n"
              "    def _set_locked(self, v):\n"
              "        self._state = v\n")


@pytest.mark.parametrize("guard,match", [
    (("Box", "_lock", ["_old_state"], ()), "renamed field"),
    (("Box", "_mutex", ["_state"], ()), "renamed lock"),
    (("Box", "_lock", ["_state"], ["_set_held"]), "renamed accessor"),
    (("Crate", "_lock", ["_state"], ()), "not found"),
], ids=["field", "lock", "accessor", "class"])
def test_drift_is_an_error(guard, match, tmp_path):
    (tmp_path / "box.py").write_text(_DRIFT_SRC)
    cls, lock, fields, acc = guard
    with pytest.raises(guards.GuardsError, match=match):
        guards.verify_mapping(
            guards=[guards.ClassGuard("box.py", cls, lock, fields, acc)],
            package_root=str(tmp_path))
    guards.verify_mapping(
        guards=[guards.ClassGuard("box.py", "Box", "_lock", ["_state"],
                                  ["_set_locked"])],
        package_root=str(tmp_path))


def test_guards_waiver_round_trip():
    src = ("class Box:\n"
           "    def poke(self):\n"
           "        self._state = 'open'\n")
    found = list(guards.check_cl008(
        linter.ParsedModule(path="<f>", source=src, relpath=PPKG + "box.py"),
        guards=[guards.ClassGuard("box.py", "Box", "_lock", ["_state"])]))
    waivers = [{"rule": "CL008", "path": PPKG + "box.py",
                "symbol": "Box.poke", "reason": "test"}]
    active, waived = linter.apply_waivers(found, waivers)
    assert active == [] and len(waived) == 1
    with pytest.raises(linter.WaiverError, match="stale"):
        linter.apply_waivers([], waivers)


# -- lock-order monitor parity -----------------------------------------------

def _ab_ba(m):
    m.note_acquired(1, "A")
    m.note_wait(2, "B")
    m.note_acquired(2, "B")
    m.note_released(2)
    m.note_released(1)
    m.note_acquired(2, "B")
    m.note_wait(1, "A")
    m.note_acquired(1, "A")


def _layers(m):
    for (a, b), (ai, bi) in ((("A", "B"), (1, 2)), (("B", "C"), (2, 3)),
                             (("A", "C"), (1, 3))):
        m.note_acquired(ai, a)
        m.note_wait(bi, b)
        m.note_acquired(bi, b)
        m.note_released(bi)
        m.note_released(ai)


def _same_site(m):
    m.note_acquired(1, "S")
    m.note_wait(1, "S")      # re-entry: nothing
    m.note_wait(2, "S")      # another instance of the site: a self-edge


def _rlock_depth(m):
    m.note_acquired(1, "R")
    m.note_acquired(1, "R")
    depth = m.note_released_all(1)
    for _ in range(depth):
        m.note_acquired(1, "R")
    m.note_released(1)
    m.note_wait(2, "L")
    m.note_acquired(2, "L")


@pytest.mark.parametrize("script", [_ab_ba, _layers, _same_site,
                                    _rlock_depth],
                         ids=["ab-ba", "layers", "same-site", "rlock-depth"])
def test_lockorder_monitor_parity(script):
    mine, ref = lockorder.LockOrderMonitor(), jlockorder.LockOrderMonitor()
    script(mine)
    script(ref)
    assert mine.report() == ref.report()


def test_lockorder_expected_reports():
    m = lockorder.LockOrderMonitor()
    _ab_ba(m)
    assert len(m.report()["cycles"]) == 1
    m = lockorder.LockOrderMonitor()
    _layers(m)
    assert m.report()["partial_order"] == [["A"], ["B"], ["C"]]
    m = lockorder.LockOrderMonitor()
    _same_site(m)
    assert m.find_cycles() == [["S", "S"]]


def test_install_instruments_only_the_ports_locks(monkeypatch):
    """Locks created from the port's files are instrumented; the test's
    and the reference's stay raw (torch's: the harness scenario below)."""
    monkeypatch.setattr(lockorder, "MONITOR", lockorder.LockOrderMonitor())
    code = compile("import threading\nlk = threading.Lock()\n"
                   "rk = threading.RLock()\n",
                   str(Path(lockorder.PORT_ROOT) / "_fixture_locks.py"),
                   "exec")
    lockorder.install()
    try:
        ns = {}
        exec(code, ns)
        mine = threading.Lock()
        jns = {}
        exec(compile("import threading\nlk = threading.Lock()\n",
                     str(ROOT / "ed25519_consensus_tpu" / "_f.py"), "exec"),
             jns)
    finally:
        lockorder.uninstall()
    assert isinstance(ns["lk"], lockorder._InstrumentedLock)
    assert isinstance(ns["rk"], lockorder._InstrumentedRLock)
    assert ns["lk"].name.startswith(
        "ed25519_consensus_tpu_torch/_fixture_locks.py:")
    assert not isinstance(mine, lockorder._InstrumentedLock)
    assert not isinstance(jns["lk"], lockorder._InstrumentedLock)
    with ns["lk"]:
        with ns["rk"]:
            pass
    assert lockorder.MONITOR.edges()
    assert not lockorder.installed()


# -- race monitor parity -----------------------------------------------------

def _monitor(mod):
    m = mod.RaceMonitor()
    held = {}
    m.held_provider = lambda: held.get(threading.get_ident(), ())
    return m, held


def _normal(report):
    """A report without writer ids (identities vs serials differ)."""
    out = {"fields_tracked": report["fields_tracked"],
           "flagged": report["flagged"], "fields": {}}
    for label, insts in report["fields"].items():
        out["fields"][label] = [
            {k: v for k, v in inst.items() if k != "samples"}
            | {"held": [s["held"] for s in inst["samples"]]}
            for inst in insts]
    return out


def _interleaved(m, held, locks_a, locks_b):
    b_go, a_finish = threading.Event(), threading.Event()

    def a():
        held[threading.get_ident()] = locks_a
        m.note("Svc.totals", 7)
        b_go.set()
        a_finish.wait(10)
        m.note("Svc.totals", 7)

    def b():
        b_go.wait(10)
        held[threading.get_ident()] = locks_b
        m.note("Svc.totals", 7)
        a_finish.set()

    ta, tb = threading.Thread(target=a), threading.Thread(target=b)
    ta.start()
    tb.start()
    ta.join(10)
    tb.join(10)
    assert not ta.is_alive() and not tb.is_alive()


def _run(fn):
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    t.join(10)
    assert not t.is_alive()


def _disjoint(m, held):
    _interleaved(m, held, (("lock_a", 1),), (("lock_b", 2),))


def _common(m, held):
    _interleaved(m, held, (("lock_a", 1), ("the_cv", 9)),
                 (("lock_b", 2), ("the_cv", 9)))


def _single(m, held):
    _run(lambda: [m.note("Lane._results", 3) for _ in range(100)])


def _tracked(mod):
    def script(m, held):
        d = mod.TrackedDict(m, "C.counters", 11,
                            {"hits": 0, "rows": {"a": 1}})
        d["hits"] = 1
        d.update(misses=2)
        d.setdefault("evictions", 0)
        d.setdefault("hits", 99)
        d.pop("misses")
        del d["evictions"]
        d.clear()
    return script


@pytest.mark.parametrize("case", ["disjoint", "common", "single", "tracked"])
def test_race_monitor_parity(case):
    reports = []
    for mod in (race_audit, jrace):
        m, held = _monitor(mod)
        script = {"disjoint": _disjoint, "common": _common,
                  "single": _single, "tracked": _tracked(mod)}[case]
        script(m, held)
        reports.append(_normal(m.report()))
    assert reports[0] == reports[1]
    if case == "disjoint":
        assert reports[0]["flagged"] == ["Svc.totals#7"]
    if case == "common":
        assert reports[0]["fields"]["Svc.totals"][0]["lockset"] == ["the_cv"]


def test_race_init_handoff_never_flagged():
    """Construction on one thread, then a single worker started after it
    joined: two writers, one after sharing, never flagged — with no lock
    anywhere.  The port counts the worker as a second writer even when
    the interpreter hands it the joined thread's identity."""
    m, _ = _monitor(race_audit)
    _run(lambda: m.note("Svc._queue_sigs", 5))
    _run(lambda: [m.note("Svc._queue_sigs", 5) for _ in range(50)])
    assert m.flagged() == []
    (entry,) = m.report()["fields"]["Svc._queue_sigs"]
    assert entry["state"] == "shared" and entry["threads"] == 2


def test_writer_serials_are_per_thread_not_per_identity():
    m = race_audit.RaceMonitor()
    seen = []
    for _ in range(3):
        _run(lambda: seen.append((threading.get_ident(), m.writer())))
    assert [w for _, w in seen] == [1, 2, 3]
    assert m.writer() == 4 and m.writer() == 4


def test_recycled_id_never_merges_histories():
    m = race_audit.RaceMonitor()

    class O:
        pass

    class Dead:
        pass

    live, tmp = O(), Dead()
    wref = weakref.ref(tmp)
    del tmp
    m._serials[id(live)] = (wref, 41)
    m._serial_count = 41
    assert m._owner_key(live) == 42 == m._owner_key(live)
    assert m._owner_key(7) == 7


def test_tracked_dict_keeps_stored_identity():
    m, _ = _monitor(race_audit)
    d = race_audit.TrackedDict(m, "C.rows", 11)
    row = {"quota_rejected": 0}
    d["Y"] = row
    row["quota_rejected"] += 1
    assert d["Y"] is row and d["Y"]["quota_rejected"] == 1


def test_instrument_class_tracks_and_uninstruments(tmp_path):
    m, _ = _monitor(race_audit)

    class Crate:
        def __init__(self):
            self.totals = {"waves": 0}
            self._epoch = 0

    race_audit.instrument_class(Crate, "Crate", dict_fields=("totals",),
                                attr_fields=("_epoch",), monitor=m)
    try:
        c = Crate()
        assert isinstance(c.totals, race_audit.TrackedDict)
        c.totals["waves"] += 1
        c._epoch = 1
        c._unrelated = "x"
        assert set(m.report()["fields"]) == {"Crate.totals", "Crate._epoch"}
    finally:
        race_audit.uninstrument_all(m)
    assert type(Crate().totals) is dict
    out = tmp_path / "race.json"
    report = race_audit.finish(write_path=str(out), monitor=m)
    assert json.loads(out.read_text()) == report


def test_harness_instruments_the_guarded_classes():
    """The harness instruments every field guards.toml guards, less the
    class-level ones it lists with a reason: the map equals the
    instrumented fields plus the exclusions."""
    from ed25519_consensus_tpu_torch.analysis import harness

    mapped = set()
    for g in guards.load_guards():
        mapped |= {(g.module[:-3], g.cls, f) for f in g.fields}
    inst = {(mod, cls, f)
            for (mod, cls), fields in harness.instrumented().items()
            for f in fields}
    assert {c for _, c, _ in inst} == PORT_CLASSES
    assert not inst & set(harness.NOT_INSTRUMENTED)
    assert inst | set(harness.NOT_INSTRUMENTED) == mapped
    for (mod, cls, f), why in harness.NOT_INSTRUMENTED.items():
        klass = getattr(importlib.import_module(
            f"ed25519_consensus_tpu_torch.{mod}"), cls)
        assert f in vars(klass) and why, (cls, f)


# -- the harness -------------------------------------------------------------

def _harness(*argv, audit=True, timeout=240):
    from ed25519_consensus_tpu_torch.analysis import harness

    env = {k: v for k, v in os.environ.items()
           if k != "ED25519_TPU_RACE_AUDIT"}
    if audit:
        env["ED25519_TPU_RACE_AUDIT"] = "1"
    r = subprocess.run([sys.executable, harness.__file__, *argv],
                       cwd=str(ROOT), capture_output=True, text=True,
                       timeout=timeout, env=env)
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    return r, summary


def test_race_harness_cpu_scenario(tmp_path):
    out = tmp_path / "race.json"
    r, summary = _harness("--scenario", "--out", str(out))
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert summary["monitored"] is True
    assert summary["failed"] == [] and summary["flagged"] == []
    assert summary["cycles"] == [] and summary["fields_tracked"] > 0
    assert summary["lock_edges"] > 0
    assert summary["workload"]["verdicts"] == 32
    assert summary["torch_locks_raw"] is True
    report = json.loads(out.read_text())
    assert report["fields_tracked"] == summary["fields_tracked"]


def test_race_harness_without_the_knob_runs_bare(tmp_path):
    """ED25519_TPU_RACE_AUDIT unset: the same scenario, no monitor, no
    report (the baseline of the monitors' cost)."""
    out = tmp_path / "race.json"
    r, summary = _harness("--scenario", "--out", str(out), audit=False)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert summary["monitored"] is False and summary["failed"] == []
    assert summary["fields_tracked"] == 0 == summary["instrumented_fields"]
    assert summary["workload"]["verdicts"] == 32
    assert not out.exists()


def test_harness_refuses_an_imported_package():
    from ed25519_consensus_tpu_torch.analysis import harness

    with pytest.raises(RuntimeError, match="already imported"):
        harness.arm()


@pytest.mark.slow
def test_race_audit_over_the_eight_threaded_suites(tmp_path):
    """`consensuslint --race-audit`: the eight suites re-run under the
    monitors (about a minute), no flagged field, no lock cycle."""
    out = tmp_path / "race.json"
    r = subprocess.run(
        [sys.executable, "-m", "ed25519_consensus_tpu_torch.tools."
         "consensuslint", "--race-audit", "--out", str(out)],
        cwd=str(ROOT), capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    report = json.loads(out.read_text())
    assert report["flagged"] == [] and report["cycles"] == []
    assert report["fields_tracked"] > 1000
