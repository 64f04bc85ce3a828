"""consensuslint — the AST layer of the port's consensus-safety analysis.

A small rule engine over the port's syntax trees (every ``.py`` file of
``ed25519_consensus_tpu_torch/``, its ``tools/`` included) enforcing the
numbered invariant catalog the JAX package states in
docs/consensus-invariants.md, retargeted to the port's modules:

* **CL001 float-free consensus path** — no float literals and no float
  dtypes in the modules whose arithmetic feeds a verdict (``ops/``,
  ``parallel/``: the torch twins, ``fe_u32``, the CUDA bindings, the
  probes) or in batch.py's verdict-path symbols and health.py's latency
  ledger.
* **CL002 injected clocks only** — no raw ``time.time``/``time.monotonic``
  calls anywhere outside ``health.Clock``.
* **CL003 central knob registry** — no raw ``os.environ``/``os.getenv``
  outside ``config.py``.
* **CL004 no new module-global mutable state** in the scheduler, service
  and lab modules; the reviewed globals are an explicit allowlist.
* **CL005 secret hygiene** in signing_key.py.
* **CL006 verdict-path discipline** — no bare or overbroad ``except`` and
  no verdict aggregation ordered by dict/set iteration.
* **CL007 verdict-cache write-path discipline** — no memo store from a
  verdict-aggregation symbol, no raw entry read outside verdictcache.py.
* **CL008 / CL009** — the concurrency pair (``analysis/guards.py``):
  guarded-by discipline against ``guards.toml`` and no effects under a
  held lock.

Findings are ``(rule, path, line, symbol, message)``; a committed waiver
(``waivers.toml``) suppresses a finding by (rule, path, symbol) with a
one-line justification, and a waiver that matches nothing is an error.

Every scope list below names a module or symbol of the port's own tree,
and :func:`verify_scopes` resolves each one against the source: a list
entry the port renamed or removed is an error (:class:`ScopeError`), as
a stale waiver is, since a rule whose scope resolves to nothing would
lint nothing and still report clean.
"""

import ast
import hashlib
import json
import os

__all__ = [
    "Finding", "ParsedModule", "RULES", "RULE_IDS",
    "iter_package_files", "lint_paths", "lint_package", "lint_module",
    "load_waivers", "apply_waivers", "WaiverError", "ScopeError",
    "verify_scopes", "stats", "publish_gauges", "render_stats",
    "PACKAGE_ROOT", "REPO_ROOT", "WAIVERS_PATH", "MANIFEST_PATH",
    "SASS_MANIFEST_PATH",
]

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE_ROOT)
PACKAGE_NAME = os.path.basename(PACKAGE_ROOT)
_HERE = os.path.dirname(os.path.abspath(__file__))
WAIVERS_PATH = os.path.join(_HERE, "waivers.toml")
MANIFEST_PATH = os.path.join(_HERE, "twin_manifest.json")
SASS_MANIFEST_PATH = os.path.join(_HERE, "sass_manifest.json")

RULE_IDS = ("CL001", "CL002", "CL003", "CL004", "CL005", "CL006",
            "CL007", "CL008", "CL009")

# CL001 scope inside batch.py: the symbols on the verdict path (staging,
# the challenge, exact verification, the union/bisection machinery).
# The scheduler half of batch.py legitimately holds float timeouts/EMAs.
_CL001_BATCH_SYMBOLS = (
    "Item", "StagedBatch", "Verifier._stage", "_challenge",
    "merge_verifiers", "_host_verdict", "_resolve_union",
    "verify_single_many", "PendingVerification",
)

# CL001 scope inside health.py: the latency ledger and its registry entry
# point.  Durations are bucketed to integer µs at the recording boundary
# and every quantile and gate comparison runs in scaled integers, so
# detection is bit-identical across hosts.
_CL001_HEALTH_SYMBOLS = (
    "LatencyLedger", "ChipRegistry.record_latency",
)

_FLOAT_DTYPES = frozenset(
    ("float16", "float32", "float64", "bfloat16", "float_", "cfloat",
     "cdouble", "complex64", "complex128"))
# torch's short spellings (``torch.float``, ``torch.half``,
# ``torch.double``) are float dtypes only on a torch/numpy module: an
# Edwards point's ``.double()`` is the group doubling.
_FLOAT_DTYPE_ALIASES = frozenset(("float", "half", "double"))
_DTYPE_MODULES = frozenset(("torch", "np", "numpy"))

# CL004: the scheduler/service/lab modules under the module-global
# freeze, and the module-level mutable names that are reviewed state
# (caches, registries, the injectable-default slots).  Adding a name
# here is a reviewed act; adding a global without adding it fails lint.
# ops/msm.py is in scope: its completed-shape set decides a device
# call's deadline grace, and a leak of it between tests has already
# failed a run, so a second such global must be a reviewed act too.
_CL004_MODULES = ("batch.py", "service.py", "health.py", "routing.py",
                  "faults.py", "devcache.py", "tenancy.py",
                  "federation.py", "verdictcache.py", "persist.py",
                  "ops/msm.py",
                  "tools/traffic_lab.py", "tools/mesh_chaos.py",
                  "tools/sentinel_soak.py", "tools/replay_lab.py",
                  "tools/restart_lab.py", "tools/straggler_lab.py")
_CL004_ALLOWED = {
    "batch.py": frozenset((
        "_shift128_cache", "_key_row_cache", "_host_split_cache",
        "_seen_keys", "_keyset_blob_cache", "last_run_stats",
    )),
    "service.py": frozenset(("_BREAKER_GAUGE",)),
    # the device-health registry, the lane-stuck latch and the
    # append-only listener wiring (devcache residency and chip drops)
    "health.py": frozenset(("_lane_stuck_latch", "_registry",
                            "_residency_listeners",
                            "_chip_drop_listeners")),
    "routing.py": frozenset(("_device_count", "_default")),
    "faults.py": frozenset(("_active",)),
    # injectable-singleton slots: only the default instance lives at
    # module level, never the cache dict itself
    "devcache.py": frozenset(("_default",)),
    "verdictcache.py": frozenset(("_default",)),
    # the shapes whose first device call completed (first-call grace)
    "ops/msm.py": frozenset(("_shapes_completed",)),
}
_LOCK_CONSTRUCTORS = frozenset(
    ("Lock", "RLock", "Condition", "Event", "Semaphore",
     "BoundedSemaphore", "Barrier"))

_CL006_MODULES = ("batch.py", "service.py", "tenancy.py",
                  "federation.py", "verdictcache.py", "persist.py",
                  "tools/traffic_lab.py", "tools/mesh_chaos.py",
                  "tools/sentinel_soak.py", "tools/replay_lab.py",
                  "tools/restart_lab.py", "tools/straggler_lab.py")
_CL005_SECRET_ATTRS = frozenset(("s", "prefix"))
_CL005_SECRET_CALLS = frozenset(("to_bytes", "__bytes__"))


class Finding:
    """One rule violation at a source location."""

    __slots__ = ("rule", "path", "line", "col", "symbol", "message")

    def __init__(self, rule, path, line, col, symbol, message):
        self.rule = rule
        self.path = path
        self.line = line
        self.col = col
        self.symbol = symbol
        self.message = message

    def key(self):
        """The waiver-matching identity: (rule, path, symbol)."""
        return (self.rule, self.path, self.symbol)

    def as_dict(self):
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "symbol": self.symbol,
                "message": self.message}

    def __str__(self):
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.symbol}] {self.message}")

    def __repr__(self):
        return f"Finding({self})"


class ParsedModule:
    """One parsed source file plus the lookup tables the rules share:
    enclosing-symbol qualnames per node and the module's import
    aliases for `time` and `os`."""

    def __init__(self, path: str, source: str, relpath: "str | None" = None):
        self.path = path
        self.relpath = relpath if relpath is not None else _relpath(path)
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self._symbol = {}
        self._parent = {}
        self.time_aliases = set()
        self.os_aliases = set()
        self.time_func_aliases = set()   # from time import monotonic, time
        self.environ_aliases = set()     # from os import environ/getenv
        self._index(self.tree, "<module>")

    def _index(self, node, symbol):
        for child in ast.iter_child_nodes(node):
            self._parent[id(child)] = node
            child_symbol = symbol
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                child_symbol = (child.name if symbol == "<module>"
                                else f"{symbol}.{child.name}")
            self._symbol[id(child)] = child_symbol
            if isinstance(child, ast.Import):
                for a in child.names:
                    if a.name == "time":
                        self.time_aliases.add(a.asname or a.name)
                    if a.name == "os":
                        self.os_aliases.add(a.asname or a.name)
            elif isinstance(child, ast.ImportFrom):
                if child.module == "time":
                    for a in child.names:
                        if a.name in ("time", "monotonic"):
                            self.time_func_aliases.add(a.asname or a.name)
                elif child.module == "os":
                    for a in child.names:
                        if a.name in ("environ", "getenv"):
                            self.environ_aliases.add(a.asname or a.name)
            self._index(child, child_symbol)

    def symbol_of(self, node) -> str:
        """Innermost enclosing class/function qualname (the waiver
        anchor), or "<module>" at top level.  For a def/class node
        itself this is the ENCLOSING symbol, matching 'where was this
        added'."""
        return self._symbol.get(id(node), "<module>")

    def parent_of(self, node):
        return self._parent.get(id(node))

    def walk(self):
        return ast.walk(self.tree)


def _relpath(path: str) -> str:
    ap = os.path.abspath(path)
    if ap.startswith(REPO_ROOT + os.sep):
        return os.path.relpath(ap, REPO_ROOT).replace(os.sep, "/")
    return os.path.basename(path)


def _pkg_rel(relpath: str) -> str:
    """Path relative to the package dir ('' prefix stripped), so rule
    scopes read naturally ("ops/", "batch.py")."""
    prefix = PACKAGE_NAME + "/"
    return relpath[len(prefix):] if relpath.startswith(prefix) else relpath


# -- rule implementations --------------------------------------------------


def _is_float_dtype_attr(node) -> bool:
    if not isinstance(node, ast.Attribute):
        return False
    return node.attr in _FLOAT_DTYPES or (
        node.attr in _FLOAT_DTYPE_ALIASES
        and isinstance(node.value, ast.Name)
        and node.value.id in _DTYPE_MODULES)


def _check_cl001(mod: ParsedModule):
    rel = _pkg_rel(mod.relpath)
    in_scope_module = rel.startswith("ops/") or rel.startswith("parallel/")
    is_batch = rel == "batch.py"
    is_health = rel == "health.py"
    if not (in_scope_module or is_batch or is_health):
        return

    def scoped(node) -> bool:
        if in_scope_module:
            return True
        syms = (_CL001_HEALTH_SYMBOLS if is_health
                else _CL001_BATCH_SYMBOLS)
        sym = mod.symbol_of(node)
        return any(sym == s or sym.startswith(s + ".")
                   for s in syms)

    for node in mod.walk():
        if not scoped(node):
            continue
        if isinstance(node, ast.Constant) and type(node.value) is float:
            yield Finding(
                "CL001", mod.relpath, node.lineno, node.col_offset,
                mod.symbol_of(node),
                f"float literal {node.value!r} in consensus-path code "
                f"(the verdict path is exact integer math)")
        elif _is_float_dtype_attr(node):
            yield Finding(
                "CL001", mod.relpath, node.lineno, node.col_offset,
                mod.symbol_of(node),
                f"float dtype `{node.attr}` in consensus-path code")
        elif (isinstance(node, ast.Constant)
              and isinstance(node.value, str)
              and node.value in _FLOAT_DTYPES):
            yield Finding(
                "CL001", mod.relpath, node.lineno, node.col_offset,
                mod.symbol_of(node),
                f"float dtype string {node.value!r} in consensus-path "
                f"code")
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr in ("astype", "to", "type")
              and any(isinstance(a, ast.Name) and a.id == "float"
                      for a in node.args)):
            yield Finding(
                "CL001", mod.relpath, node.lineno, node.col_offset,
                mod.symbol_of(node),
                f"{node.func.attr}(float) in consensus-path code")


def _check_cl002(mod: ParsedModule):
    rel = _pkg_rel(mod.relpath)
    if rel == "health.py":
        return  # the one sanctioned home of the raw clock (health.Clock)
    for node in mod.walk():
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        bad = None
        if (isinstance(f, ast.Attribute)
                and f.attr in ("time", "monotonic")
                and isinstance(f.value, ast.Name)
                and f.value.id in mod.time_aliases):
            bad = f"{f.value.id}.{f.attr}"
        elif (isinstance(f, ast.Name) and f.id in mod.time_func_aliases):
            bad = f.id
        if bad:
            yield Finding(
                "CL002", mod.relpath, node.lineno, node.col_offset,
                mod.symbol_of(node),
                f"raw `{bad}()` call — all scheduler/service time must "
                f"come from an injected health.Clock "
                f"(health.SYSTEM_CLOCK.monotonic for wall time)")


def _check_cl003(mod: ParsedModule):
    rel = _pkg_rel(mod.relpath)
    if rel == "config.py":
        return  # THE sanctioned reader
    for node in mod.walk():
        if (isinstance(node, ast.Attribute)
                and node.attr in ("environ", "getenv")
                and isinstance(node.value, ast.Name)
                and node.value.id in mod.os_aliases):
            yield Finding(
                "CL003", mod.relpath, node.lineno, node.col_offset,
                mod.symbol_of(node),
                f"raw `os.{node.attr}` read — every ED25519_TPU_* knob "
                f"goes through the config.py registry")
        elif (isinstance(node, ast.Name)
              and node.id in mod.environ_aliases
              and isinstance(node.ctx, ast.Load)):
            yield Finding(
                "CL003", mod.relpath, node.lineno, node.col_offset,
                mod.symbol_of(node),
                f"raw `{node.id}` (from os import) — use the config.py "
                f"registry")


def _is_lock_call(value) -> bool:
    if not isinstance(value, ast.Call):
        return False
    f = value.func
    name = f.attr if isinstance(f, ast.Attribute) else (
        f.id if isinstance(f, ast.Name) else None)
    return name in _LOCK_CONSTRUCTORS


def _is_mutable_value(value) -> bool:
    if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                          ast.ListComp, ast.SetComp)):
        return True
    if isinstance(value, ast.Call) and isinstance(value.func, ast.Name) \
            and value.func.id in ("dict", "list", "set", "bytearray",
                                  "deque", "defaultdict", "OrderedDict",
                                  "Counter"):
        return True
    return False


def _check_cl004(mod: ParsedModule):
    rel = _pkg_rel(mod.relpath)
    if rel not in _CL004_MODULES:
        return
    allowed = _CL004_ALLOWED.get(rel, frozenset())
    for node in mod.tree.body:
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        if not names or names == ["__all__"]:
            continue
        if _is_lock_call(value):
            continue  # locks/conditions are the sanctioned global kind
        if not _is_mutable_value(value):
            continue
        for name in names:
            if name in allowed:
                continue
            yield Finding(
                "CL004", mod.relpath, node.lineno, node.col_offset,
                "<module>",
                f"new module-global mutable state `{name}` in a "
                f"scheduler/service module — use an injectable object "
                f"(see health.DeviceHealth) or add it to the reviewed "
                f"CL004 allowlist")


def _references_secret(node) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in _CL005_SECRET_ATTRS \
                and isinstance(n.value, ast.Name) \
                and n.value.id == "self":
            return True
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                and n.func.attr in _CL005_SECRET_CALLS:
            return True
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id == "bytes" and n.args \
                and isinstance(n.args[0], ast.Name) \
                and n.args[0].id == "self":
            return True
    return False


def _check_cl005(mod: ParsedModule):
    rel = _pkg_rel(mod.relpath)
    if rel != "signing_key.py":
        return
    for node in mod.walk():
        sym = mod.symbol_of(node)
        in_repr = sym.rsplit(".", 1)[-1] in ("__repr__", "__str__",
                                             "__format__")
        if in_repr and (isinstance(node, (ast.JoinedStr, ast.Return))
                        or (isinstance(node, ast.Call))):
            if _references_secret(node):
                yield Finding(
                    "CL005", mod.relpath, node.lineno, node.col_offset,
                    sym,
                    "secret bytes reachable from __repr__/__str__ — "
                    "SigningKey debug output must redact `s`, `prefix` "
                    "and the serialized secret")
                continue
        if isinstance(node, ast.Call):
            f = node.func
            is_print = isinstance(f, ast.Name) and f.id == "print"
            is_logging = (isinstance(f, ast.Attribute)
                          and f.attr in ("debug", "info", "warning",
                                         "error", "critical", "exception",
                                         "log"))
            if (is_print or is_logging) and _references_secret(node):
                yield Finding(
                    "CL005", mod.relpath, node.lineno, node.col_offset,
                    sym,
                    "secret bytes passed to print/logging in "
                    "signing_key.py")


_VERDICT_NAME = ("verdict", "verdicts", "result", "results")


def _iter_is_unordered(it) -> "str | None":
    """Why this For-iterable is dict/set-iteration-ordered, or None."""
    if isinstance(it, ast.Set) or isinstance(it, ast.SetComp):
        return "set display"
    if isinstance(it, ast.Call):
        f = it.func
        if isinstance(f, ast.Name) and f.id in ("set", "frozenset"):
            return f"{f.id}() call"
        if isinstance(f, ast.Attribute) and f.attr in ("keys", "values",
                                                       "items"):
            return f".{f.attr}() dict view"
    return None


def _writes_verdict(body) -> "int | None":
    """Line of the first statement in `body` that stores into a
    verdict-named target (subscript assignment or .append), or None."""
    for stmt in body:
        for n in ast.walk(stmt):
            if isinstance(n, (ast.Assign, ast.AugAssign)):
                targets = n.targets if isinstance(n, ast.Assign) else [
                    n.target]
                for t in targets:
                    base = t
                    if isinstance(base, ast.Subscript):
                        base = base.value
                    if isinstance(base, ast.Name) \
                            and base.id in _VERDICT_NAME:
                        return n.lineno
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr in ("append", "extend") \
                    and isinstance(n.func.value, ast.Name) \
                    and n.func.value.id in _VERDICT_NAME:
                return n.lineno
    return None


def _check_cl006(mod: ParsedModule):
    rel = _pkg_rel(mod.relpath)
    if rel not in _CL006_MODULES:
        return
    for node in mod.walk():
        if isinstance(node, ast.ExceptHandler):
            if node.type is None:
                yield Finding(
                    "CL006", mod.relpath, node.lineno, node.col_offset,
                    mod.symbol_of(node),
                    "bare `except:` on the verdict path — catch the "
                    "specific error the ladder handles")
            elif isinstance(node.type, ast.Name) \
                    and node.type.id in ("Exception", "BaseException"):
                yield Finding(
                    "CL006", mod.relpath, node.lineno, node.col_offset,
                    mod.symbol_of(node),
                    f"overbroad `except {node.type.id}` on the verdict "
                    f"path — narrow it or waive with the supervision "
                    f"rationale")
        elif isinstance(node, ast.For):
            why = _iter_is_unordered(node.iter)
            if why:
                line = _writes_verdict(node.body)
                if line is not None:
                    yield Finding(
                        "CL006", mod.relpath, node.lineno,
                        node.col_offset, mod.symbol_of(node),
                        f"verdict aggregation ordered by {why} — "
                        f"verdicts must be keyed by submission order, "
                        f"never by dict/set iteration order")


# CL007: the verdict memo store is read-only on the verdict
# path.  Scope: the modules that can reach a VerdictCache.  Two checks:
#
# * WRITE-ON-DECIDE — inside the verdict-aggregation symbols, any call
#   to a cache WRITE verb on a cache-named receiver is a finding: a
#   store that happens as a side effect of deciding couples the memo
#   layer into the verdict math (the stores belong to process_once,
#   after every ticket is sealed).
# * UNGUARDED READ — outside verdictcache.py itself, any access to the
#   raw entry map (`_entries`) or the unguarded lookup internals
#   (`_lookup_locked`, `peek`) on a cache-named receiver is a finding:
#   `lookup()` is the only read API, because it is where the per-hit
#   byte-for-byte re-hash lives — a verdict derived from an entry that
#   skipped it would trust stored bytes nothing re-checked.
#
# Like CL006 this is a syntactic approximation (direct calls, not a
# call graph); the semantic half — a flipped stored verdict is never
# published — is pinned by the CorruptStoredVerdict fault tests.
_CL007_MODULES = ("batch.py", "service.py", "verdictcache.py",
                  "federation.py", "persist.py",
                  "tools/replay_lab.py", "tools/restart_lab.py",
                  "tools/straggler_lab.py")
_CL007_VERDICT_SYMBOLS = (
    "verify_many", "_host_verdict", "_resolve_union",
    "verify_single_many", "Verifier.verify", "VerifyService._execute",
)
_CL007_WRITE_METHODS = frozenset(
    ("store", "put", "record_verdict", "insert"))
_CL007_RAW_READS = frozenset(("_entries", "_lookup_locked", "peek"))
_CL007_RECEIVER_HINTS = ("cache", "vc", "memo")


def _cl007_cache_receiver(node) -> bool:
    """Heuristic: does this attribute/call receiver name a cache?  Any
    Name id or Attribute attr along the chain containing a receiver
    hint ("cache", "vc", "memo") counts — self.verdict_cache, vc,
    rep.vcache, memo_store all match."""
    parts = []
    n = node
    while isinstance(n, ast.Attribute):
        parts.append(n.attr)
        n = n.value
    if isinstance(n, ast.Name):
        parts.append(n.id)
    return any(any(h in p.lower() for h in _CL007_RECEIVER_HINTS)
               for p in parts)


def _check_cl007(mod: ParsedModule):
    rel = _pkg_rel(mod.relpath)
    if rel not in _CL007_MODULES:
        return
    is_verdictcache = rel == "verdictcache.py"

    def in_verdict_symbol(node) -> bool:
        sym = mod.symbol_of(node)
        return any(sym == s or sym.startswith(s + ".")
                   for s in _CL007_VERDICT_SYMBOLS)

    for node in mod.walk():
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _CL007_WRITE_METHODS \
                and _cl007_cache_receiver(node.func.value) \
                and in_verdict_symbol(node):
            yield Finding(
                "CL007", mod.relpath, node.lineno, node.col_offset,
                mod.symbol_of(node),
                f"verdict-cache write `.{node.func.attr}()` inside "
                f"verdict aggregation — the memo store is read-only "
                f"on the verdict path; stores belong to the "
                f"post-wave bookkeeping (VerifyService.process_once)")
        elif not is_verdictcache and isinstance(node, ast.Attribute) \
                and node.attr in _CL007_RAW_READS \
                and _cl007_cache_receiver(node.value):
            yield Finding(
                "CL007", mod.relpath, node.lineno, node.col_offset,
                mod.symbol_of(node),
                f"raw verdict-cache entry access `.{node.attr}` "
                f"bypasses the per-hit re-hash guard — go through "
                f"VerdictCache.lookup()")


def _check_cl008(mod):
    # Lazy import: guards.py imports Finding/_parse_toml from this
    # module, so the rule body resolves at call time, not import time.
    from . import guards
    return guards.check_cl008(mod)


def _check_cl009(mod):
    from . import guards
    return guards.check_cl009(mod)


RULES = {
    "CL001": _check_cl001,
    "CL002": _check_cl002,
    "CL003": _check_cl003,
    "CL004": _check_cl004,
    "CL005": _check_cl005,
    "CL006": _check_cl006,
    "CL007": _check_cl007,
    "CL008": _check_cl008,
    "CL009": _check_cl009,
}


# -- the walk --------------------------------------------------------------


def iter_package_files(root: "str | None" = None):
    """Every .py file of the package (sorted, deterministic)."""
    root = root or PACKAGE_ROOT
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return out


def lint_module(mod: ParsedModule) -> "list[Finding]":
    findings = []
    for rule_id in RULE_IDS:
        findings.extend(RULES[rule_id](mod) or ())
    return findings


def lint_paths(paths) -> "list[Finding]":
    findings = []
    for path in paths:
        if os.path.isdir(path):
            findings.extend(lint_paths(iter_package_files(path)))
            continue
        with open(path, encoding="utf-8") as f:
            source = f.read()
        findings.extend(lint_module(ParsedModule(path, source)))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint_package(root: "str | None" = None) -> "list[Finding]":
    """The whole walk: CL001-CL009 over every .py file of the package
    (tools/ included) and CL001's float scan over the kernel sources of
    csrc/, after every scope list resolved (:func:`verify_scopes`)."""
    from . import sass_audit

    root = root or PACKAGE_ROOT
    verify_scopes(root)
    findings = lint_paths([root])
    findings.extend(sass_audit.source_findings(root))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


# -- scope resolution (a stale scope list is an error) ---------------------


class ScopeError(ValueError):
    """A rule's scope list names a module, symbol or allowlisted global
    that does not exist in the port's tree: the rule would lint nothing
    there and still report clean."""


def _defined_symbols(tree) -> "set[str]":
    """Every class/function qualname of a module."""
    out = set()

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                name = f"{prefix}{child.name}"
                out.add(name)
                visit(child, name + ".")
    visit(tree, "")
    return out


def _module_globals(tree) -> "set[str]":
    names = set()
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign) else
                   [node.target] if isinstance(node, ast.AnnAssign) else ())
        names.update(t.id for t in targets if isinstance(t, ast.Name))
    return names


def scope_lists() -> "dict[str, tuple]":
    """Every scope list, as (modules, {module: symbols}) per rule:
    the data :func:`verify_scopes` resolves."""
    return {
        "CL001": ((), {"batch.py": _CL001_BATCH_SYMBOLS,
                       "health.py": _CL001_HEALTH_SYMBOLS}),
        "CL004": (_CL004_MODULES, {}),
        "CL006": (_CL006_MODULES, {}),
        "CL007": (_CL007_MODULES, {None: _CL007_VERDICT_SYMBOLS}),
    }


def verify_scopes(root: "str | None" = None) -> None:
    """Resolve every module, symbol and allowlisted global the rules
    name against the tree at `root` (default: the package).  Raises
    ScopeError listing each one that does not resolve."""
    root = root or PACKAGE_ROOT
    trees: "dict[str, ast.Module | None]" = {}

    def tree_of(rel):
        if rel not in trees:
            p = os.path.join(root, *rel.split("/"))
            if os.path.exists(p):
                with open(p, encoding="utf-8") as f:
                    trees[rel] = ast.parse(f.read(), filename=p)
            else:
                trees[rel] = None
        return trees[rel]

    problems = []
    for rule, (modules, symbols) in scope_lists().items():
        for rel in modules:
            if tree_of(rel) is None:
                problems.append(f"{rule}: module {rel} does not exist")
        for rel, names in symbols.items():
            homes = modules if rel is None else (rel,)
            defined = set()
            for home in homes:
                t = tree_of(home)
                if t is not None:
                    defined |= _defined_symbols(t)
            for name in names:
                if name not in defined:
                    problems.append(
                        f"{rule}: symbol {name} is not defined in "
                        f"{' or '.join(homes)}")
    for rel, names in sorted(_CL004_ALLOWED.items()):
        if rel not in _CL004_MODULES:
            problems.append(f"CL004: allowlisted module {rel} is not "
                            f"in the rule's modules")
            continue
        t = tree_of(rel)
        have = _module_globals(t) if t is not None else set()
        for name in sorted(names):
            if name not in have:
                problems.append(f"CL004: allowlisted global {rel}:{name} "
                                f"is never assigned at module level")
    if problems:
        raise ScopeError("a scope list names what the tree does not "
                         "hold — fix the list in the same commit: "
                         + "; ".join(problems))


# -- waivers ---------------------------------------------------------------


class WaiverError(ValueError):
    """A malformed or unused waiver — both fail the lint run: the
    waiver file must exactly excuse the findings that exist, no more."""


def _parse_toml(text: str) -> dict:
    """Parse the waiver file: stdlib tomllib on 3.11+, else a strict
    subset parser (array-of-tables of string keys) — the build image
    runs 3.10 and the waiver format deliberately fits the subset."""
    try:
        import tomllib
    except ImportError:
        tomllib = None
    if tomllib is not None:
        try:
            return tomllib.loads(text)
        except tomllib.TOMLDecodeError as e:
            # Same typed failure as the subset parser below: the CLI
            # (and load_soak's lint gate) turn WaiverError into a clean
            # exit-2, never a raw traceback.
            raise WaiverError(f"waivers.toml: {e}") from e
    data: dict = {}
    current = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("[[") and line.endswith("]]"):
            name = line[2:-2].strip()
            current = {}
            data.setdefault(name, []).append(current)
            continue
        if "=" in line and current is not None:
            key, _, val = line.partition("=")
            key = key.strip()
            val = val.strip()
            if len(val) >= 2 and val[0] == val[-1] and val[0] in "\"'":
                current[key] = val[1:-1]
            else:
                raise WaiverError(
                    f"waivers.toml:{lineno}: only quoted string values "
                    f"are supported ({raw.strip()!r})")
            continue
        raise WaiverError(f"waivers.toml:{lineno}: unparseable line "
                          f"{raw.strip()!r}")
    return data


def load_waivers(path: "str | None" = None) -> "list[dict]":
    path = path or WAIVERS_PATH
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        data = _parse_toml(f.read())
    waivers = data.get("waiver", [])
    for i, w in enumerate(waivers):
        for field in ("rule", "path", "symbol", "reason"):
            if not w.get(field):
                raise WaiverError(
                    f"waiver #{i + 1} is missing required field "
                    f"{field!r} (every waiver carries a one-line "
                    f"justification)")
        if w["rule"] not in RULE_IDS:
            raise WaiverError(
                f"waiver #{i + 1} names unknown rule {w['rule']!r}")
    return waivers


def apply_waivers(findings, waivers):
    """Split findings into (active, waived); raises WaiverError for any
    waiver that matched nothing (stale waivers are errors)."""
    used = [False] * len(waivers)
    active, waived = [], []
    for f in findings:
        matched = False
        for i, w in enumerate(waivers):
            if (w["rule"], w["path"], w["symbol"]) == f.key():
                used[i] = True
                matched = True
        (waived if matched else active).append(f)
    stale = [w for i, w in enumerate(waivers) if not used[i]]
    if stale:
        desc = "; ".join(
            f"{w['rule']} {w['path']} [{w['symbol']}]" for w in stale)
        raise WaiverError(
            f"stale waiver(s) matched no finding — delete them: {desc}")
    return active, waived


# -- stats (the soak-tooling surface) --------------------------------------


def _file_hash(path: str) -> "str | None":
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def manifest_hash() -> "str | None":
    """sha256 of the committed twin manifest (analysis/ir_audit.py), or
    None when it has not been generated yet."""
    return _file_hash(MANIFEST_PATH)


def stats(findings=None, waivers=None) -> dict:
    """Rule counts, waiver count and the two manifests' hashes — the
    numbers `consensuslint --stats` publishes into utils.metrics gauges
    so the soak tooling can hold the waiver count to its ratchet."""
    if findings is None:
        findings = lint_package()
    if waivers is None:
        waivers = load_waivers()
    active, waived = apply_waivers(findings, waivers)
    rule_counts = {rid: 0 for rid in RULE_IDS}
    for f in findings:
        rule_counts[f.rule] += 1
    return {
        "rule_counts": rule_counts,
        "findings_total": len(findings),
        "findings_active": len(active),
        "findings_waived": len(waived),
        "waiver_count": len(waivers),
        "manifest_hash": manifest_hash(),
        "sass_manifest_hash": _file_hash(SASS_MANIFEST_PATH),
    }


def publish_gauges(st: "dict | None" = None) -> dict:
    """Mirror `stats()` into the process-wide utils.metrics gauges:
    consensuslint_waivers, consensuslint_findings_active/_waived, the
    per-rule consensuslint_<rule> counts, twin_manifest_hash and
    sass_manifest_hash."""
    from ..utils import metrics

    st = st if st is not None else stats()
    values = {
        "consensuslint_waivers": st["waiver_count"],
        "consensuslint_findings_active": st["findings_active"],
        "consensuslint_findings_waived": st["findings_waived"],
        "twin_manifest_hash": st["manifest_hash"],
        "sass_manifest_hash": st["sass_manifest_hash"],
    }
    for rid, n in st["rule_counts"].items():
        values[f"consensuslint_{rid}"] = n
    metrics.set_gauges(values)
    return st


def render_stats(st: dict) -> str:
    return json.dumps(st, indent=2, sort_keys=True)
