"""Layer 3 of the port's consensus-safety analysis: lock-order
verification.

The port holds a dozen locks (the service condition, the breaker, the
device-health registry and each DeviceHealth, the chip and replica
registries and the latency ledger, the caches, the journal, the fault
plan, the metrics counters and gauges, the device-lane registry and
condition, and ``ops.msm.DEVICE_CALL_LOCK``).  This module turns their
intended hierarchy into a CHECKED partial order:

* ``install()`` replaces ``threading.Lock``/``threading.RLock`` with
  factories that return instrumented wrappers, but ONLY for locks created
  from the port's own source files (``ed25519_consensus_tpu_torch/``).
  Every other lock stays real and raw: the standard library's, torch's
  (the ``torch.cuda`` lazy-init lock among them, created at torch's
  import), the tests' and the JAX package's, which a test session may
  import beside the port.  ``threading.Condition``/``Event``/``queue``
  pick the wrappers up when constructed from port code.
* Every BLOCKING acquire taken while other instrumented locks are held
  records a directed edge (held → acquired), keyed by the lock's creation
  site (file + class/attribute name), with per-thread held-stacks kept
  through ``Condition.wait``'s release/reacquire protocol.
* ``finish()`` checks the graph for cycles.  An acyclic graph IS a
  consistent partial order, derived topologically into layers; a cycle is
  a latent deadlock and fails the run.

The same per-thread held-lock stacks feed the write-race sanitizer
(``race_audit.py``).  This module must stay importable STANDALONE (stdlib
only, no package imports): ``analysis/harness.py`` loads it by file path
before ``ed25519_consensus_tpu_torch`` itself, so that the package's
module-level locks are created instrumented.
"""

import json
import linecache
import os
import re
import threading
import _thread

__all__ = [
    "LockOrderMonitor", "MONITOR", "install", "uninstall", "installed",
    "finish", "render", "REPO_ROOT", "PORT_ROOT",
]

PORT_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PORT_ROOT)

_REAL_LOCK = _thread.allocate_lock
_REAL_RLOCK = threading._CRLock or threading._PyRLock  # type: ignore


class LockOrderMonitor:
    """The acquisition graph: nodes are lock creation sites, edges are
    'held A while blocking-acquiring B' observations with counts."""

    def __init__(self):
        self._mu = _REAL_LOCK()
        self._edges: "dict[tuple[str, str], int]" = {}
        self._nodes: "set[str]" = set()
        self._tls = threading.local()

    # -- per-thread held stack --------------------------------------------

    def _stack(self):
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def note_node(self, name: str) -> None:
        with self._mu:
            self._nodes.add(name)

    def note_wait(self, obj_id: int, name: str) -> None:
        """About to BLOCK on `name`: record an edge from every
        currently-held (distinct) lock.  Recursive re-acquisition of
        the same OBJECT records nothing — an RLock cannot deadlock
        against itself — but holding a *different instance* from the
        same creation site records a name -> name self-edge: two
        threads nesting two same-site locks in opposite instance order
        is a classic AB/BA deadlock the site-keyed graph cannot
        distinguish from safe nesting, so any same-site nesting must
        fail the audit and get an instance-level ordering review."""
        held = []
        seen = set()
        for hid, hname in self._stack():
            if hid == obj_id or hname in seen:
                continue
            seen.add(hname)
            held.append(hname)
        if not held:
            return
        with self._mu:
            for hname in held:
                key = (hname, name)
                self._edges[key] = self._edges.get(key, 0) + 1

    def note_acquired(self, obj_id: int, name: str) -> None:
        self._stack().append((obj_id, name))

    def note_released(self, obj_id: int) -> None:
        st = self._stack()
        for i in range(len(st) - 1, -1, -1):
            if st[i][0] == obj_id:
                del st[i]
                return

    def note_released_all(self, obj_id: int) -> int:
        """RLock._release_save: every recursion level goes at once.
        Returns how many levels were held so _acquire_restore can put
        back exactly that many."""
        st = self._stack()
        n = sum(1 for e in st if e[0] == obj_id)
        st[:] = [e for e in st if e[0] != obj_id]
        return n

    # -- analysis ----------------------------------------------------------

    def edges(self) -> "dict[tuple[str, str], int]":
        with self._mu:
            return dict(self._edges)

    def nodes(self) -> "set[str]":
        with self._mu:
            return set(self._nodes) | {
                n for e in self._edges for n in e}

    def find_cycles(self) -> "list[list[str]]":
        """Every elementary cycle reachable in the edge graph (DFS with
        an on-stack set; reports each cycle once by its entry node)."""
        graph: "dict[str, list[str]]" = {}
        for (a, b) in self.edges():
            graph.setdefault(a, []).append(b)
        cycles = []
        done = set()

        def dfs(node, path, on_path):
            if node in on_path:
                i = path.index(node)
                cyc = path[i:] + [node]
                # dedup on the node SET without the repeated closing
                # node, so [A,B,A] found from A and [B,A,B] found from
                # B count as the one A<->B cycle they are
                key = tuple(sorted(cyc[:-1]))
                if key not in done:
                    done.add(key)
                    cycles.append(cyc)
                return
            path.append(node)
            on_path.add(node)
            for nxt in graph.get(node, ()):
                dfs(nxt, path, on_path)
            path.pop()
            on_path.discard(node)

        for start in sorted(graph):
            dfs(start, [], set())
        return cycles

    def partial_order(self) -> "list[list[str]]":
        """Kahn layering of the observed graph (only meaningful when
        acyclic): level 0 holds the outermost locks (never acquired
        while something else is held above them), each next level is
        acquired under the previous ones."""
        edges = self.edges()
        nodes = {n for e in edges for n in e}
        preds: "dict[str, set]" = {n: set() for n in nodes}
        succs: "dict[str, set]" = {n: set() for n in nodes}
        for (a, b) in edges:
            preds[b].add(a)
            succs[a].add(b)
        levels = []
        remaining = set(nodes)
        while remaining:
            layer = sorted(n for n in remaining
                           if not (preds[n] & remaining))
            if not layer:  # cycle: report the rest as one layer
                levels.append(sorted(remaining))
                break
            levels.append(layer)
            remaining -= set(layer)
        return levels

    def report(self) -> dict:
        edges = self.edges()
        return {
            "nodes": sorted(self.nodes()),
            "edges": sorted(
                [[a, b, n] for (a, b), n in edges.items()]),
            "cycles": self.find_cycles(),
            "partial_order": self.partial_order(),
        }


MONITOR = LockOrderMonitor()

_THIS_FILE = os.path.abspath(__file__)


def _creation_site() -> "str | None":
    """Name the lock by WHERE it was created: the first stack frame
    outside this module and the threading/queue stdlib machinery.
    Returns None for frames outside the port's package directory (those
    locks stay real).  Names:  'pkg/file.py:VAR' for module-level locks,
    'pkg/file.py:Class.attr' for instance locks."""
    import sys

    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        base = os.path.basename(fn)
        if os.path.abspath(fn) == _THIS_FILE or base in (
                "threading.py", "queue.py", "functools.py"):
            f = f.f_back
            continue
        break
    if f is None:
        return None
    fn = os.path.abspath(f.f_code.co_filename)
    if not fn.startswith(PORT_ROOT + os.sep):
        return None
    rel = os.path.relpath(fn, REPO_ROOT).replace(os.sep, "/")
    line = linecache.getline(f.f_code.co_filename, f.f_lineno)
    m = re.search(r"self\.(\w+)\s*(?::[^=]+)?=", line)
    if m:
        cls = type(f.f_locals["self"]).__name__ \
            if "self" in f.f_locals else f.f_code.co_name
        return f"{rel}:{cls}.{m.group(1)}"
    m = re.match(r"\s*(\w+)\s*(?::[^=]+)?=", line)
    if m and f.f_code.co_name == "<module>":
        return f"{rel}:{m.group(1)}"
    ctx = f.f_code.co_name if f.f_code.co_name != "<module>" \
        else f"L{f.f_lineno}"
    return f"{rel}:{ctx}"


class _InstrumentedLock:
    """A non-reentrant lock wrapper feeding the monitor.  Deliberately
    does NOT expose _is_owned/_release_save (threading.Condition's
    plain-Lock fallbacks go through acquire/release, which keeps the
    bookkeeping exact)."""

    _reentrant = False

    def __init__(self, real, name: str):
        self._real = real
        self.name = name
        MONITOR.note_node(name)

    def acquire(self, blocking=True, timeout=-1):
        if blocking:
            MONITOR.note_wait(id(self), self.name)
        ok = self._real.acquire(blocking, timeout)
        if ok:
            MONITOR.note_acquired(id(self), self.name)
        return ok

    def release(self):
        self._real.release()
        MONITOR.note_released(id(self))

    def locked(self):
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<{type(self).__name__} {self.name} at {id(self):#x}>"


class _InstrumentedRLock(_InstrumentedLock):
    """Reentrant wrapper; exposes the RLock protocol Condition needs
    (_is_owned / _release_save / _acquire_restore) with held-stack
    bookkeeping so a Condition.wait never leaves stale 'held' state."""

    _reentrant = True

    def acquire(self, blocking=True, timeout=-1):
        # Re-entering an OWNED RLock can never block: recording a wait
        # here would paint a false edge from every other held lock to
        # this one (and a false cycle with the genuine outer-nesting
        # edge).  Only a first acquisition is a potential wait.
        if blocking and not self._real._is_owned():
            MONITOR.note_wait(id(self), self.name)
        ok = self._real.acquire(blocking, timeout)
        if ok:
            MONITOR.note_acquired(id(self), self.name)
        return ok

    def _is_owned(self):
        return self._real._is_owned()

    def _release_save(self):
        # Condition treats the saved state as opaque, so it can carry
        # the held-stack depth: wait() under a reentrantly-held RLock
        # must restore EVERY recursion level into the monitor's stack,
        # or the inner `with` exit pops the lone entry and later
        # blocking acquires miss their (this -> other) edges.
        state = self._real._release_save()
        depth = MONITOR.note_released_all(id(self))
        return (state, depth)

    def _acquire_restore(self, state):
        state, depth = state
        MONITOR.note_wait(id(self), self.name)
        self._real._acquire_restore(state)
        for _ in range(max(1, depth)):
            MONITOR.note_acquired(id(self), self.name)

    def locked(self):  # CRLock has no locked() on some versions
        locked = getattr(self._real, "locked", None)
        return locked() if locked is not None else False


_real_threading_lock = None
_real_threading_rlock = None


def _lock_factory():
    name = _creation_site()
    real = _REAL_LOCK()
    if name is None:
        return real
    return _InstrumentedLock(real, name)


def _rlock_factory():
    name = _creation_site()
    real = _REAL_RLOCK()
    if name is None:
        return real
    return _InstrumentedRLock(real, name)


def install() -> None:
    """Swap threading.Lock/RLock for the instrumenting factories.  Must
    run BEFORE the audited package is imported (its module-level locks
    are created at import time).  Idempotent."""
    global _real_threading_lock, _real_threading_rlock
    if installed():
        return
    _real_threading_lock = threading.Lock
    _real_threading_rlock = threading.RLock
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory


def uninstall() -> None:
    global _real_threading_lock, _real_threading_rlock
    if not installed():
        return
    threading.Lock = _real_threading_lock
    threading.RLock = _real_threading_rlock
    _real_threading_lock = _real_threading_rlock = None


def installed() -> bool:
    return _real_threading_lock is not None


def finish(write_path: "str | None" = None) -> dict:
    """The run-end check: the aggregated report, optionally written to
    `write_path` as JSON.  The caller (harness.py) fails the run on any
    of its `cycles`."""
    report = MONITOR.report()
    if write_path:
        with open(write_path, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.write("\n")
    return report


def render(report: dict) -> str:
    lines = ["lock-order audit:"]
    for i, layer in enumerate(report["partial_order"]):
        lines.append(f"  level {i}: " + ", ".join(layer))
    lines.append(f"  {len(report['edges'])} distinct edges, "
                 f"{len(report['cycles'])} cycle(s)")
    for cyc in report["cycles"]:
        lines.append("  CYCLE: " + " -> ".join(cyc))
    return "\n".join(lines)
