"""race_audit — the port's dynamic write-race sanitizer (Eraser lockset).

The dynamic complement of CL008 (``guards.py``): the static rule proves
every *lexical* access of a guarded field sits inside the owning lock's
``with`` block, but it cannot see dict-valued fields mutated through
helper indirection, fields the mapping does not cover, or a lock taken on
one path and forgotten on another.  This module watches real threads do
the mutating.

* ``lockorder.py`` instruments every lock the port creates and keeps a
  per-thread stack of held locks; the harness (``harness.py``) wires that
  stack in as this module's ``held_provider``.
* Hot objects are instrumented at class level (:func:`instrument_class`):
  dict-valued fields become a :class:`TrackedDict` whose mutators report
  ``(field, writer, held-lock-set)``; scalar fields report through a
  patched ``__setattr__``.  Tracking is per instance, keyed by a
  weakref-checked generation serial, never raw ``id()``.  Values stored
  into a tracked dict keep their identity (the sanitizer never changes
  program semantics), so mutations of an inserted row go unseen; the
  insertion itself is the event.
* Writers are keyed by a **per-thread serial**, drawn from a counter the
  first time a thread writes and kept in a ``threading.local`` slot,
  never by ``threading.get_ident()``: the interpreter reuses a joined
  thread's identity for the next thread it starts, so keyed by identity a
  hand-off from a constructing thread to a worker started after it joined
  would look like one thread.  With serials every thread is a new writer.
* Per field, the Eraser state machine: EXCLUSIVE while only its first
  writer writes (construction needs no lock); the first write from a
  second writer moves it to SHARED and seeds the candidate lockset with
  that write's held-set; every later write intersects its held-set in.  A
  field is FLAGGED when two or more writers wrote it after sharing and the
  candidate lockset is empty.  A field only ever written by one writer is
  never flagged, and neither is a hand-off to a single later writer.

Race evidence gates the audit run, never a verdict: nothing in the
package imports this module, and the instrumentation only observes
mutations the code already performs.  Stdlib only; loaded standalone by
file path.
"""

import _thread
import json
import os
import threading
import weakref

__all__ = [
    "RaceMonitor", "TrackedDict", "MONITOR", "instrument_class",
    "uninstrument_all", "finish", "render",
]

_EXCLUSIVE = "exclusive"
_SHARED = "shared"

# Keep a few held-set samples per field so a flagged report shows
# WHICH lock each thread believed it was protected by.
_SAMPLES_PER_FIELD = 4


class RaceMonitor:
    """Collects (field, thread, held-lock-set) write events and runs
    the per-field lockset state machine."""

    def __init__(self):
        # The raw thread primitive: lockorder.install() swaps the
        # threading.Lock/RLock factories, and the monitor's own mutex
        # must never appear in the audited acquisition graph.
        self._mu = _thread.allocate_lock()
        # () -> iterable of (lock_name, lock_id) currently held by the
        # calling thread; wired by the harness to the lock-order
        # monitor's per-thread stack.  Default: no lock evidence.
        self.held_provider = None
        # (label, owner_serial) -> field state
        self._fields = {}
        self._instrumented = []
        # id(obj) -> (weakref | None, serial): generation tracking so
        # a recycled address never merges two objects' histories.
        self._serials = {}
        self._serial_count = 0
        # per-thread writer serials (see the module docstring)
        self._tls = threading.local()
        self._writer_count = 0

    # -- event intake ------------------------------------------------------

    def _held(self) -> frozenset:
        provider = self.held_provider
        if provider is None:
            return frozenset()
        try:
            return frozenset(tuple(pair) for pair in provider())
        except Exception:
            return frozenset()

    def writer(self) -> int:
        """The calling thread's writer serial, drawn on its first call."""
        w = getattr(self._tls, "writer", None)
        if w is None:
            with self._mu:
                self._writer_count += 1
                w = self._tls.writer = self._writer_count
        return w

    def _owner_key(self, owner) -> int:
        """Generation serial for `owner` (caller holds _mu).  An int
        is an opaque caller-managed token (unit tests); an object is
        weakref-checked so a recycled id() starts a fresh history."""
        if isinstance(owner, int):
            return owner
        oid = id(owner)
        ent = self._serials.get(oid)
        if ent is not None:
            wref, serial = ent
            if wref is None or wref() is owner:
                return serial
        self._serial_count += 1
        serial = self._serial_count
        try:
            wref = weakref.ref(owner)
        except TypeError:
            wref = None
        self._serials[oid] = (wref, serial)
        return serial

    def note(self, label: str, owner) -> None:
        """One write of instance `owner`'s field `label` by the
        calling thread, under whatever locks it currently holds.
        `owner` is the instance itself (or an opaque int token)."""
        tid = self.writer()
        held = self._held()
        with self._mu:
            owner = self._owner_key(owner)
            st = self._fields.get((label, owner))
            if st is None:
                self._fields[(label, owner)] = {
                    "state": _EXCLUSIVE, "first_thread": tid,
                    "writes": 1, "shared_threads": set(),
                    "lockset": None, "samples": [(tid, held)],
                }
                return
            st["writes"] += 1
            if st["state"] == _EXCLUSIVE:
                if tid == st["first_thread"]:
                    return  # still initialization-exclusive
                # second thread: the object is shared from here on
                st["state"] = _SHARED
                st["lockset"] = held
                st["shared_threads"] = {tid}
            else:
                st["lockset"] = st["lockset"] & held
                st["shared_threads"].add(tid)
            if len(st["samples"]) < _SAMPLES_PER_FIELD or not held:
                st["samples"].append((tid, held))
                del st["samples"][:-_SAMPLES_PER_FIELD]

    # -- reporting ---------------------------------------------------------

    def flagged(self) -> "list[tuple[str, int]]":
        """Fields mutated by >=2 threads (post-sharing) whose held
        sets have empty intersection — the write races."""
        with self._mu:
            return sorted(
                key for key, st in self._fields.items()
                if st["state"] == _SHARED
                and len(st["shared_threads"]) >= 2
                and not st["lockset"])

    def report(self) -> dict:
        with self._mu:
            fields = {}
            for (label, owner), st in sorted(self._fields.items()):
                fields.setdefault(label, []).append({
                    "owner": owner,
                    "state": st["state"],
                    "writes": st["writes"],
                    "threads": (1 if st["state"] == _EXCLUSIVE
                                else 1 + len(st["shared_threads"]
                                             - {st["first_thread"]})),
                    "lockset": sorted(n for n, _ in (st["lockset"]
                                                     or ())),
                    "samples": [
                        {"thread": t,
                         "held": sorted(n for n, _ in h)}
                        for t, h in st["samples"]],
                })
        flagged = [f"{label}#{owner}" for label, owner in self.flagged()]
        return {
            "fields_tracked": sum(len(v) for v in fields.values()),
            "flagged": flagged,
            "fields": fields,
        }

    def reset(self) -> None:
        with self._mu:
            self._fields.clear()
            self._serials.clear()


MONITOR = RaceMonitor()


class TrackedDict(dict):
    """A dict whose mutators report to the race monitor.  Stored
    values are kept AS-IS — wrapping a nested dict would copy it and
    break callers that retain the original reference (the sanitizer
    must never change program semantics), so mutations of an
    already-inserted row go unseen; the insertion itself is the
    tracked event."""

    __slots__ = ("_m", "_label", "_owner")

    def __init__(self, monitor, label, owner, initial=None):
        self._m = monitor
        self._label = label
        self._owner = owner
        super().__init__(initial or ())

    def _note(self):
        self._m.note(self._label, self._owner)

    def __setitem__(self, k, v):
        self._note()
        dict.__setitem__(self, k, v)

    def __delitem__(self, k):
        self._note()
        dict.__delitem__(self, k)

    def pop(self, *a):
        self._note()
        return dict.pop(self, *a)

    def popitem(self):
        self._note()
        return dict.popitem(self)

    def clear(self):
        self._note()
        dict.clear(self)

    def update(self, *a, **kw):
        self._note()
        dict.update(self, *a, **kw)

    def setdefault(self, k, default=None):
        if k in self:
            return dict.__getitem__(self, k)
        self._note()
        dict.__setitem__(self, k, default)
        return default


def instrument_class(cls, label: str, dict_fields=(), attr_fields=(),
                     monitor: "RaceMonitor | None" = None):
    """Patch `cls.__setattr__` so instances report writes: assigning a
    plain dict to a `dict_fields` name swaps in a TrackedDict for that
    (class, field, instance); assigning any `attr_fields` name records
    a scalar write event.  Instances created BEFORE the patch keep
    plain dicts — the harness instruments at session start, before any
    test builds an instance."""
    monitor = monitor or MONITOR
    dset = frozenset(dict_fields)
    aset = frozenset(attr_fields)
    orig = cls.__setattr__

    def __setattr__(self, name, value, _orig=orig, _label=label,
                    _dset=dset, _aset=aset, _m=monitor):
        if name in _dset:
            _m.note(f"{_label}.{name}", self)
            if type(value) is dict:
                value = TrackedDict(_m, f"{_label}.{name}", self,
                                    value)
        elif name in _aset:
            _m.note(f"{_label}.{name}", self)
        _orig(self, name, value)

    cls.__setattr__ = __setattr__
    monitor._instrumented.append((cls, orig))
    return cls


def uninstrument_all(monitor: "RaceMonitor | None" = None) -> None:
    monitor = monitor or MONITOR
    while monitor._instrumented:
        cls, orig = monitor._instrumented.pop()
        cls.__setattr__ = orig


def render(report: dict) -> str:
    lines = [
        "race audit: %d field(s) tracked, %d flagged"
        % (report["fields_tracked"], len(report["flagged"]))
    ]
    for name in report["flagged"]:
        label = name.rsplit("#", 1)[0]
        lines.append(f"  RACE {name}")
        for inst in report["fields"].get(label, ()):
            if f"{label}#{inst['owner']}" != name:
                continue
            for s in inst["samples"]:
                lines.append(
                    "    thread %d held %s"
                    % (s["thread"], s["held"] or ["<no locks>"]))
    return "\n".join(lines)


def finish(write_path: "str | None" = None,
           monitor: "RaceMonitor | None" = None) -> dict:
    """Run-end: the report, optionally written as JSON to
    `write_path`."""
    monitor = monitor or MONITOR
    report = monitor.report()
    if write_path:
        tmp = write_path + ".tmp"
        os.makedirs(os.path.dirname(os.path.abspath(write_path)),
                    exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        os.replace(tmp, write_path)
    return report
