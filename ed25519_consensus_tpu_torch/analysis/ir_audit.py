"""Layer 2, CPU half: the integer-only audit of the port's torch twins.

The JAX package traced its device MSM to jaxprs (``jax.make_jaxpr``) and
held them to a manifest.  The port's counterpart of a jaxpr is the stream
of aten operators a torch twin dispatches: each variant below runs once on
the CPU, at the smallest shape it accepts, under a
``TorchDispatchMode`` that records every aten operator and the dtype of
every tensor it reads or writes.  The checks:

* every dtype is an integer type or bool: no float, no complex;
* no denylisted operator appears: random draws (``rand*``, ``normal``,
  ``bernoulli``, ``uniform``, ``multinomial``, ``exponential``,
  ``dropout``) make a verdict depend on more than its inputs, and a
  ``_to_copy`` to a float dtype is a float round-trip;
* the mesh variants (D = 2 on the CPU, through K5's plain version) record
  their kernel-entry schedule: per shard K1, K2, K3 (the head-resident
  dispatch: K1, K2, K3 too), then exactly one K5.  This is the port's form
  of the JAX audit's one-``all_gather`` contract: the port runs one
  process and K5 reads the shards in place, so no collective exists;
* the whole surface (operators, dtypes, schedule per variant) matches the
  committed ``twin_manifest.json``, compared when the recorded torch
  version equals the running one (an aten decomposition can change
  between releases); any drift fails with a diff.  After a reviewed
  change of a twin, regenerate it with ``consensuslint --ir-audit
  --write-manifest`` in the same commit.

Every variant runs in the 8 x 32-bit arithmetic the card runs
(``ops/fe_u32.py``, ``arith="u32"``) and, where the function takes
``arith``, in the 20-limb one (``l20``) too.
"""

import contextlib
import json
import os

from .linter import MANIFEST_PATH

__all__ = [
    "DENYLIST", "KERNEL_ENTRIES", "Recorder", "trace", "audit_summary",
    "trace_variants", "build_manifest", "diff_manifests", "load_manifest",
    "write_manifest", "main",
]

# aten operator names (the overload packet, "aten.<name>") that have no
# business in a verification twin.
DENYLIST = ("rand", "normal", "bernoulli", "uniform", "multinomial",
            "exponential", "dropout", "poisson", "cauchy", "geometric",
            "log_normal")
_FLOAT_PREFIXES = ("float", "bfloat", "complex", "half", "double", "cfloat",
                   "cdouble")

# The kernel wrappers of ops/msm.py whose entry order is the schedule:
# module attribute → the kernel's name.
KERNEL_ENTRIES = (
    ("expand_compressed_points", "K1"),
    ("window_partials", "K2"),
    ("window_partials_tables", "K2t"),
    ("fold_partials", "K3"),
    ("multiples_tables", "K4"),
    ("fold_shards", "K5"),
    ("expand_affine_points", "K6"),
    ("shift128_lanes", "K7"),
)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


class Recorder:
    """A dispatch mode recording aten operators and tensor dtypes."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        rec = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                rec._note(func, args, kwargs, out)
                return out

        self.mode = _Mode()
        self.ops = set()
        self.dtypes = set()
        self.float_copies = set()
        self.calls = 0

    def _note(self, func, args, kwargs, out):
        import torch
        from torch.utils._pytree import tree_leaves

        name = str(func.overloadpacket)
        self.ops.add(name)
        self.calls += 1
        for x in tree_leaves((args, kwargs, out)):
            if isinstance(x, torch.Tensor):
                self.dtypes.add(_dtype_name(x.dtype))
            elif isinstance(x, torch.dtype):
                self.dtypes.add(_dtype_name(x))
        if name == "aten._to_copy" and isinstance(out, torch.Tensor) \
                and _dtype_name(out.dtype).startswith(_FLOAT_PREFIXES):
            self.float_copies.add(_dtype_name(out.dtype))


@contextlib.contextmanager
def _schedule():
    """Record the order in which ops/msm.py's kernel wrappers are entered
    (outermost entries only) → the list, filled while the block runs."""
    from ..ops import msm

    order, depth = [], [0]
    saved = {}

    def wrap(fn, tag):
        def entry(*a, **kw):
            if depth[0] == 0:
                order.append(tag)
            depth[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
        return entry

    for attr, tag in KERNEL_ENTRIES:
        saved[attr] = getattr(msm, attr)
        setattr(msm, attr, wrap(saved[attr], tag))
    try:
        yield order
    finally:
        for attr, fn in saved.items():
            setattr(msm, attr, fn)


def trace(fn, *args, **kwargs) -> "tuple[dict, object]":
    """Run `fn(*args, **kwargs)` under the recorder → (summary, result);
    summary = {"ops", "dtypes", "schedule", "float_copies"}."""
    rec = Recorder()
    with _schedule() as order, rec.mode:
        out = fn(*args, **kwargs)
    return {"ops": sorted(rec.ops), "dtypes": sorted(rec.dtypes),
            "schedule": list(order),
            "float_copies": sorted(rec.float_copies)}, out


def audit_summary(name: str, summary: dict) -> "list[str]":
    """The manifest-free checks: integer-only dtypes, a clean denylist,
    no float copy."""
    problems = []
    for dt in summary["dtypes"]:
        if dt.startswith(_FLOAT_PREFIXES):
            problems.append(f"{name}: non-integer dtype {dt!r} in the "
                            f"twin: the consensus MSM is integer-only")
    for op in summary["ops"]:
        base = op.split(".", 1)[-1]
        for bad in DENYLIST:
            if bad in base:
                problems.append(f"{name}: denylisted operator {op!r}")
                break
    for dt in summary.get("float_copies", ()):
        problems.append(f"{name}: a copy to {dt} (a float round-trip)")
    return problems


def expected_schedule(name: str, shards: int) -> "list[str] | None":
    """The mesh variants' kernel-entry contract, or None for the others."""
    if not name.startswith("mesh-"):
        return None
    return ["K1", "K2", "K3"] * shards + ["K5"]


# -- the audited variants ------------------------------------------------------

_B = 1            # batch axis
_N = 64           # lanes: one 64-lane chunk
_N_MESH = 128     # two shards of one chunk each
_MESH = 2


def _operands(B=_B, N=_N, plain_windows=None):
    """Zero digits (packed, or `plain_windows` int8 planes) and compressed
    identity encodings (y = 1).  Tracing reads what runs, not values, and
    every twin takes the same path for any digits."""
    import numpy as np

    from ..ops import limbs

    if plain_windows is None:
        digits = np.zeros((B, limbs.PACKED_WINDOWS, N), dtype=np.uint8)
    else:
        digits = np.zeros((B, plain_windows, N), dtype=np.int8)
    pts = np.stack([limbs.identity_wire_batch(N)] * B)
    return digits, pts


def trace_variants() -> dict:
    """name → (callable, shards): every audited twin variant."""
    import numpy as np
    import torch

    from ..ops import limbs, msm
    from ..parallel import sharded_msm

    cpu = "cpu"
    digits, pts = _operands()
    head = limbs.identity_point_batch(_N // 2)
    head_t = torch.from_numpy(head)
    rwire = pts[..., _N // 2:]
    head_tables = msm.build_tables_plain(head_t[None])[0]
    affine = np.stack([limbs.identity_affine_batch(_N)] * _B)
    tables_full = msm.build_tables_plain(torch.from_numpy(
        np.stack([limbs.identity_point_batch(_N)] * _B)))
    r32_digits, r32_pts = _operands(plain_windows=msm.nwindows(
        limbs.WINDOW_BITS_R32))
    m_digits, m_pts = _operands(N=_N_MESH)
    m_head = limbs.identity_point_batch(_N // 2)
    m_head_digits = np.zeros((_B, limbs.PACKED_WINDOWS, _MESH * (_N // 2)),
                             dtype=np.uint8)
    m_r_digits = np.zeros((_B, limbs.PACKED_WINDOWS, _MESH * (_N // 2)),
                          dtype=np.uint8)
    m_rwire = np.concatenate([pts[..., _N // 2:]] * _MESH, axis=-1)
    devices = [cpu] * _MESH

    v = {}
    for arith in ("u32", "l20"):
        v[f"chain-compressed-{arith}"] = (
            lambda a=arith: msm.window_sums_many(digits, pts, arith=a,
                                                 device=cpu), 1)
        v[f"k6-expand-affine-{arith}"] = (
            lambda a=arith: msm.expand_affine_points_plain(
                torch.from_numpy(affine), arith=a), 1)
        v[f"tables-in-{arith}"] = (
            lambda a=arith: msm.window_sums_many_tables_full(
                digits, tables_full, arith=a, device=cpu), 1)
    # K1, then K7 on a lane with the shift flag (hint bit 2): the cold
    # dispatch of a batch with a fresh key.
    shifted = pts.copy()
    shifted[:, 32, 1] |= 4
    v["chain-compressed-shift128"] = (
        lambda: msm.window_sums_many(digits, shifted, device=cpu), 1)
    v["chain-affine-u32"] = (
        lambda: msm.window_sums_many(digits, affine, device=cpu), 1)
    v["head-resident"] = (
        lambda: msm.dispatch_window_sums_many_cached(digits, head, rwire,
                                                     device=cpu), 1)
    v["tables-resident"] = (
        lambda: msm.dispatch_window_sums_many_tables(
            digits, head_tables, rwire, device=cpu), 1)
    v["lab-hybrid"] = (
        lambda: msm.window_sums_many(digits, pts, body="hybrid",
                                     device=cpu), 1)
    v["lab-int32-table"] = (
        lambda: msm.window_sums_many(digits, pts, tbl_dtype="int32",
                                     device=cpu), 1)
    v["lab-w3"] = (
        lambda: msm.window_sums_many(digits, pts, win_chunk=3,
                                     device=cpu), 1)
    v["lab-int16-fold"] = (
        lambda: msm.window_sums_many(digits, pts, fold_dtype="int16",
                                     device=cpu), 1)
    v["lab-radix32"] = (
        lambda: msm.window_sums_many(r32_digits, r32_pts,
                                     window_bits=limbs.WINDOW_BITS_R32,
                                     device=cpu), 1)
    v["mesh-cold"] = (
        lambda: sharded_msm.sharded_window_sums_many(
            m_digits, m_pts, _MESH, devices=devices), _MESH)
    v["mesh-sentinel-audit"] = (
        lambda: sharded_msm.sharded_window_sums_many_audit(
            m_digits, m_pts, _MESH, devices=devices), _MESH)
    v["mesh-head-resident"] = (
        lambda: sharded_msm.sharded_window_sums_many_cached(
            m_head_digits, m_r_digits, m_head, m_rwire, _MESH,
            devices=devices), _MESH)
    return v


def build_manifest(variants=None) -> "tuple[dict, list[str]]":
    """Trace every variant → (manifest, problems), problems being the
    manifest-free invariant violations and schedule breaches."""
    import torch

    variants = trace_variants() if variants is None else variants
    manifest = {"torch": torch.__version__.split("+")[0], "variants": {}}
    problems = []
    for name, (fn, shards) in sorted(variants.items()):
        summary, _out = trace(fn)
        problems += audit_summary(name, summary)
        want = expected_schedule(name, shards)
        if want is not None and summary["schedule"] != want:
            problems.append(f"{name}: kernel schedule {summary['schedule']}"
                            f" != {want} (per shard K1, K2, K3, then one K5)")
        summary.pop("float_copies")
        manifest["variants"][name] = summary
    return manifest, problems


def diff_manifests(committed: dict, current: dict) -> "list[str]":
    """Drift between the committed manifest and a fresh one; empty when
    the torch versions differ (nothing comparable)."""
    if committed.get("torch") != current.get("torch"):
        return []
    out = []
    cv, nv = committed.get("variants", {}), current.get("variants", {})
    for name in sorted(set(cv) | set(nv)):
        if name not in nv:
            out.append(f"{name}: in the committed manifest, not traced now")
            continue
        if name not in cv:
            out.append(f"{name}: not in the committed manifest (regenerate "
                       f"with --ir-audit --write-manifest)")
            continue
        for field in ("ops", "dtypes", "schedule"):
            old, new = cv[name].get(field, []), nv[name].get(field, [])
            if old == new:
                continue
            if field == "schedule" and sorted(old) == sorted(new):
                out.append(f"{name}.schedule: ORDER changed {old} -> {new}")
                continue
            gone = [x for x in old if x not in new]
            added = [x for x in new if x not in old]
            out.append(f"{name}.{field}: drift"
                       + (f" +{added}" if added else "")
                       + (f" -{gone}" if gone else "")
                       + (f" {old} -> {new}" if field == "schedule" else ""))
    return out


def load_manifest(path: str = MANIFEST_PATH) -> "dict | None":
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def write_manifest(manifest: dict, path: str = MANIFEST_PATH) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


def main(write: bool = False, log=print) -> int:
    """Trace, check, and compare with (or write) the manifest: 0 clean, 1
    an invariant violation or drift."""
    manifest, problems = build_manifest()
    for p in problems:
        log(f"ir-audit: INVARIANT: {p}")
    if write:
        if problems:
            log("ir-audit: refusing to write a manifest that violates the "
                "audit invariants")
            return 1
        write_manifest(manifest)
        log(f"ir-audit: wrote {MANIFEST_PATH} "
            f"({len(manifest['variants'])} variants)")
        return 0
    committed = load_manifest()
    if committed is None:
        log("ir-audit: no committed manifest (run --ir-audit "
            "--write-manifest once)")
        return 1
    drift = diff_manifests(committed, manifest)
    if committed.get("torch") != manifest["torch"]:
        log(f"ir-audit: manifest traced under torch {committed.get('torch')}"
            f", this is {manifest['torch']}: invariant checks only")
    for d in drift:
        log(f"ir-audit: DRIFT: {d}")
    if problems or drift:
        return 1
    log(f"ir-audit: clean — {len(manifest['variants'])} variants traced, "
        f"manifest {'matched' if committed.get('torch') == manifest['torch'] else 'not comparable'}")
    return 0
