"""guards — the concurrency half of the port's consensus-safety catalog.

Two rules over the port's heavily threaded modules (the service, batch's
device lane, health's registries and latency ledger, devcache,
verdictcache, persist, federation):

* **CL008 guarded-by discipline** — the committed ``guards.toml`` maps
  ``module / Class / field`` to the field's OWNING LOCK attribute.  Every
  read or write of a guarded field must sit lexically inside ``with
  self.<lock>`` (``cls.<lock>`` / ``type(self).<lock>`` /
  ``ClassName.<lock>`` for class-level state), inside an
  ``<lock>.acquire()``-balanced method, inside ``__init__`` (the object is
  not shared yet), or inside an allowlisted ACCESSOR method whose contract
  is "caller holds the lock".  Everything else is a finding.
  :func:`verify_mapping` re-resolves every entry against the port's tree,
  and a renamed class, field, lock or accessor is an ERROR
  (:class:`GuardsError`), as a stale waiver is.
* **CL009 locks-never-hold-effects** — inside any ``with`` block whose
  context is a repo lock (an attribute/name ending in ``lock`` / ``_cv``
  / ``_mu``; ``DEVICE_CALL_LOCK`` is excluded, since holding it across a
  dispatch is its purpose), the effects the failure model forbids under
  locks are findings: listener notification, device dispatch entry points
  and stream or device synchronisation, ``time.sleep`` and a blocking
  ``.wait()`` on a DIFFERENT object's condition, filesystem writes (the
  verdict journal serializing its OWN file under its OWN lock in
  persist.py is the one sanctioned shape), and print/logging of
  secret-bearing state.  Metrics calls stay sanctioned: the metrics locks
  are the bottom of the hierarchy.

Both rules are registered in the CL001-CL009 catalog (``linter.py``), so
waivers, stats, the CLI and the fixtures compose unchanged.  Both are
syntactic approximations; the dynamic half is ``race_audit.py`` over real
threads (``harness.py``).
"""

import ast
import os

from .linter import Finding, _parse_toml, _pkg_rel

__all__ = [
    "GuardsError", "ClassGuard", "GUARDS_PATH", "load_guards",
    "verify_mapping", "check_cl008", "check_cl009", "guard_stats",
]

GUARDS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "guards.toml")


class GuardsError(ValueError):
    """A malformed guards.toml entry, or one that drifted from the
    source it maps (renamed class/field/lock/accessor) — an ERROR,
    never a silent no-op: a stale mapping reads as coverage that no
    longer exists."""


class ClassGuard:
    """One guards.toml entry: every listed field of `cls` (in `module`)
    is owned by `lock`; `accessors` are the methods whose contract is
    'caller holds the lock'."""

    __slots__ = ("module", "cls", "lock", "fields", "accessors")

    def __init__(self, module, cls, lock, fields, accessors=()):
        self.module = module
        self.cls = cls
        self.lock = lock
        self.fields = frozenset(fields)
        self.accessors = frozenset(accessors)

    def __repr__(self):
        return (f"ClassGuard({self.module}:{self.cls} lock={self.lock} "
                f"fields={sorted(self.fields)})")


def _split(csv: str) -> "list[str]":
    return [p.strip() for p in csv.split(",") if p.strip()]


def load_guards(path: "str | None" = None) -> "list[ClassGuard]":
    """The committed field→lock mapping.  Raises GuardsError for a
    structurally malformed file (missing keys, empty field lists)."""
    path = path or GUARDS_PATH
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        data = _parse_toml(f.read())
    out = []
    for i, g in enumerate(data.get("guard", [])):
        for field in ("module", "class", "lock", "fields"):
            if not g.get(field):
                raise GuardsError(
                    f"guard #{i + 1} is missing required key {field!r}")
        fields = _split(g["fields"])
        if not fields:
            raise GuardsError(f"guard #{i + 1} lists no fields")
        out.append(ClassGuard(g["module"], g["class"], g["lock"],
                              fields, _split(g.get("accessors", ""))))
    return out


# -- drift detection (stale mappings are errors) ---------------------------


def _class_def(tree: ast.Module, name: str) -> "ast.ClassDef | None":
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


def _class_attr_names(cdef: ast.ClassDef) -> "set[str]":
    """Every attribute the class defines: `self.x = ...` anywhere in
    its methods plus class-level `x = ...` assignments."""
    names = set()
    for node in ast.walk(cdef):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id in ("self", "cls"):
                    names.add(t.attr)
        if isinstance(node, ast.ClassDef) and node is cdef:
            for stmt in node.body:
                if isinstance(stmt, ast.Assign):
                    names.update(t.id for t in stmt.targets
                                 if isinstance(t, ast.Name))
                elif isinstance(stmt, ast.AnnAssign) \
                        and isinstance(stmt.target, ast.Name):
                    names.add(stmt.target.id)
    return names


def _method_names(cdef: ast.ClassDef) -> "set[str]":
    return {n.name for n in cdef.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def verify_mapping(guards: "list[ClassGuard] | None" = None,
                   package_root: "str | None" = None) -> None:
    """Re-resolve every guards.toml entry against the real tree: the
    module file, the class, the lock attribute, every guarded field,
    and every accessor method must all still exist.  A rename anywhere
    raises GuardsError (same policy as stale waivers) so the mapping is
    maintained in the same commit as the code it covers."""
    from .linter import PACKAGE_ROOT

    root = package_root or PACKAGE_ROOT
    if guards is None:
        guards = load_guards()
    problems = []
    trees: "dict[str, ast.Module | None]" = {}
    for g in guards:
        if g.module not in trees:
            p = os.path.join(root, *g.module.split("/"))
            if not os.path.exists(p):
                trees[g.module] = None
            else:
                with open(p, encoding="utf-8") as f:
                    trees[g.module] = ast.parse(f.read(), filename=p)
        tree = trees[g.module]
        if tree is None:
            problems.append(f"{g.module}: module file does not exist")
            continue
        cdef = _class_def(tree, g.cls)
        if cdef is None:
            problems.append(f"{g.module}: class {g.cls} not found")
            continue
        attrs = _class_attr_names(cdef)
        methods = _method_names(cdef)
        if g.lock not in attrs:
            problems.append(
                f"{g.module}:{g.cls}: lock attribute {g.lock!r} is "
                f"never assigned (renamed lock?)")
        for field in sorted(g.fields):
            if field not in attrs:
                problems.append(
                    f"{g.module}:{g.cls}: guarded field {field!r} is "
                    f"never assigned (renamed field?)")
        for acc in sorted(g.accessors):
            if acc not in methods:
                problems.append(
                    f"{g.module}:{g.cls}: accessor {acc!r} is not a "
                    f"method (renamed accessor?)")
    if problems:
        raise GuardsError(
            "guards.toml drifted from the source it maps — fix the "
            "mapping in the same commit: " + "; ".join(problems))


# -- CL008: guarded-by discipline ------------------------------------------


def _owner_receiver(expr, cls: str) -> bool:
    """Does `expr` name the owning object: self / cls / type(self) /
    the class itself?"""
    if isinstance(expr, ast.Name):
        return expr.id in ("self", "cls") or expr.id == cls
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name) \
            and expr.func.id == "type" and len(expr.args) == 1 \
            and isinstance(expr.args[0], ast.Name) \
            and expr.args[0].id == "self":
        return True
    return False


def _is_lock_ctx(expr, lock: str, cls: str) -> bool:
    return (isinstance(expr, ast.Attribute) and expr.attr == lock
            and _owner_receiver(expr.value, cls))


def _inside_lock(mod, node, lock: str, cls: str) -> bool:
    n = node
    while n is not None:
        if isinstance(n, ast.With):
            for item in n.items:
                if _is_lock_ctx(item.context_expr, lock, cls):
                    return True
        n = mod.parent_of(n)
    return False


def _enclosing_function(mod, node):
    n = node
    while n is not None:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return n
        n = mod.parent_of(n)
    return None


def _acquire_balanced(fn, lock: str, cls: str) -> bool:
    """The `.acquire()`-region approximation: a method that explicitly
    calls `self.<lock>.acquire()` manages the lock by hand (try/finally
    release) and its body counts as held."""
    if fn is None:
        return False
    for n in ast.walk(fn):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr == "acquire" \
                and _is_lock_ctx(n.func.value, lock, cls):
            return True
    return False


def check_cl008(mod, guards: "list[ClassGuard] | None" = None):
    """Yield a finding for every guarded-field access outside the
    owning lock's lexical scope (and outside __init__ / the accessor
    allowlist)."""
    if guards is None:
        guards = load_guards()
    rel = _pkg_rel(mod.relpath)
    by_field: "dict[str, list[ClassGuard]]" = {}
    for g in guards:
        if g.module != rel:
            continue
        for f in g.fields:
            by_field.setdefault(f, []).append(g)
    if not by_field:
        return

    balanced: "dict[tuple[int, str], bool]" = {}
    for node in mod.walk():
        if not (isinstance(node, ast.Attribute)
                and node.attr in by_field):
            continue
        sym = mod.symbol_of(node)
        parts = sym.split(".")
        for g in by_field[node.attr]:
            named_class = (isinstance(node.value, ast.Name)
                           and node.value.id == g.cls)
            if named_class:
                pass  # ClassName._field is guarded wherever it appears
            elif not _owner_receiver(node.value, g.cls):
                continue  # someone else's attribute of the same name
            elif parts[0] != g.cls:
                continue  # self.<field> inside a DIFFERENT class
            if sym == g.cls:
                break  # class-body declaration (the field's definition)
            method = parts[1] if not named_class and len(parts) > 1 \
                else parts[-1]
            if not named_class and method == "__init__":
                break  # construction: the object is not shared yet
            if method in g.accessors:
                break
            if _inside_lock(mod, node, g.lock, g.cls):
                break
            fn = _enclosing_function(mod, node)
            key = (id(fn), g.lock)
            if key not in balanced:
                balanced[key] = _acquire_balanced(fn, g.lock, g.cls)
            if balanced[key]:
                break
            kind = ("write" if isinstance(node.ctx,
                                          (ast.Store, ast.Del))
                    else "read")
            yield Finding(
                "CL008", mod.relpath, node.lineno, node.col_offset,
                sym,
                f"guarded field `{g.cls}.{node.attr}` {kind} outside "
                f"`with self.{g.lock}` — guards.toml maps it to that "
                f"lock; hold it, or add the method to the entry's "
                f"accessor allowlist if the caller holds it by "
                f"contract")
            break


# -- CL009: locks never hold effects ---------------------------------------

# With-contexts that count as "a repo lock is held".  The device-call
# serialization lock is excluded by name: holding it ACROSS the device
# dispatch is its entire purpose.
_CL009_EXCLUDED_LOCKS = frozenset(("DEVICE_CALL_LOCK",))

_CL009_NOTIFY = frozenset(("notify_chip_drop", "notify_residency_drop"))
_CL009_DISPATCH_PREFIXES = ("dispatch_window_sums", "sharded_window_sums")
_CL009_DISPATCH_NAMES = frozenset(
    ("device_put", "block_until_ready", "warm_device_shapes",
     "run_probation_probe", "synchronize"))
_CL009_SECRET_HINTS = frozenset(("s", "prefix", "secret", "signing_key"))


def _lockish_name(expr) -> "str | None":
    """The terminal name of a with-context that looks like a repo lock
    (`self._lock`, `cls._instance_lock`, `_latch_lock`, `self._cv`,
    `self._mu`), or None."""
    name = None
    if isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    if name is None or name in _CL009_EXCLUDED_LOCKS:
        return None
    low = name.lower()
    if low.endswith("lock") or low.endswith("_cv") or low.endswith("_mu"):
        return name
    return None


def _call_name(func) -> "str | None":
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _receiver_chain(expr) -> "list[str]":
    parts = []
    n = expr
    while isinstance(n, ast.Attribute):
        parts.append(n.attr)
        n = n.value
    if isinstance(n, ast.Name):
        parts.append(n.id)
    return parts


def _open_writes(call: ast.Call) -> bool:
    if not (isinstance(call.func, ast.Name) and call.func.id == "open"):
        return False
    mode = None
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    return isinstance(mode, str) and any(c in mode for c in "wa+x")


def _mentions_secret(call: ast.Call) -> bool:
    for n in ast.walk(call):
        if isinstance(n, ast.Attribute) and n.attr in _CL009_SECRET_HINTS:
            return True
        if isinstance(n, ast.Name) and "secret" in n.id.lower():
            return True
    return False


def _cl009_effect(node, mod, lock_exprs) -> "str | None":
    """Why this node is a banned effect under a held repo lock, or
    None.  `lock_exprs` are the ast.dump fingerprints of the held
    with-contexts (so `self._cv.wait()` under `with self._cv` stays
    the sanctioned shape)."""
    if not isinstance(node, ast.Call):
        return None
    name = _call_name(node.func)
    if name is None:
        return None
    if name in _CL009_NOTIFY:
        return (f"`{name}()` under a held lock — drop/rotation "
                f"listeners fire OUTSIDE all locks (the residency-"
                f"listener contract, docs/failure-model.md)")
    if "listener" in name.lower():
        return (f"listener invocation `{name}()` under a held lock — "
                f"callbacks run outside all locks")
    if name in _CL009_DISPATCH_NAMES or any(
            name.startswith(p) for p in _CL009_DISPATCH_PREFIXES):
        return (f"device dispatch `{name}()` under a held repo lock — "
                f"dispatch serializes on DEVICE_CALL_LOCK only; "
                f"holding scheduler/cache locks across it stalls "
                f"every other thread for a device call")
    if name == "sleep":
        return ("`sleep()` while holding a lock — a timed hold turns "
                "every contender into a straggler")
    if name == "wait" and isinstance(node.func, ast.Attribute):
        recv = ast.dump(node.func.value)
        if recv not in lock_exprs:
            return ("blocking `.wait()` on a DIFFERENT object's "
                    "condition/event while holding a lock — the "
                    "sanctioned shape is waiting on the condition you "
                    "hold (`with self._cv: self._cv.wait()`)")
        return None
    if name == "fsync" or _open_writes(node):
        return (f"filesystem write (`{name}`) under a held repo lock "
                f"— the verdict journal serializes its own file under "
                f"its own lock (persist.py); nothing else may hold a "
                f"lock across disk I/O")
    if name == "append":
        chain = [p.lower() for p in _receiver_chain(node.func)]
        if any("journal" in p for p in chain[1:]):
            return ("journal append under a held repo lock — "
                    "write-through persistence runs OUTSIDE the cache "
                    "lock (verdictcache.store's documented contract)")
        return None
    is_print = isinstance(node.func, ast.Name) and name == "print"
    is_log = isinstance(node.func, ast.Attribute) and name in (
        "debug", "info", "warning", "error", "critical", "exception",
        "log")
    if (is_print or is_log) and _mentions_secret(node):
        return ("print/logging of secret-bearing state under a held "
                "lock — secrets never reach an output surface, locked "
                "or not (CL005), and a lock held across I/O is a "
                "stall")
    return None


def check_cl009(mod):
    """Yield a finding for every banned effect lexically inside a
    `with <repo-lock>` block."""
    rel = _pkg_rel(mod.relpath)
    # The verdict journal's OWN lock legitimately serializes its OWN
    # file: persist.py's VerdictJournal is the one sanctioned
    # fs-write-under-lock site.
    journal_owns_fs = rel == "persist.py"

    def held_locks(node) -> "set[str]":
        held = set()
        n = mod.parent_of(node)
        while n is not None:
            if isinstance(n, ast.With):
                for item in n.items:
                    if _lockish_name(item.context_expr) is not None:
                        held.add(ast.dump(item.context_expr))
            n = mod.parent_of(n)
        return held

    for node in mod.walk():
        if not isinstance(node, ast.Call):
            continue
        locks = held_locks(node)
        if not locks:
            continue
        why = _cl009_effect(node, mod, locks)
        if why is None:
            continue
        if journal_owns_fs and ("filesystem write" in why
                                or "journal append" in why):
            sym = mod.symbol_of(node)
            if sym.split(".")[0] == "VerdictJournal":
                continue
        yield Finding("CL009", mod.relpath, node.lineno,
                      node.col_offset, mod.symbol_of(node), why)


# -- stats (the --guards / --stats surface) --------------------------------


def guard_stats(guards: "list[ClassGuard] | None" = None) -> dict:
    if guards is None:
        guards = load_guards()
    return {
        "guard_entries": len(guards),
        "guarded_fields": sum(len(g.fields) for g in guards),
        "guard_accessors": sum(len(g.accessors) for g in guards),
        "guarded_classes": len({(g.module, g.cls) for g in guards}),
    }
