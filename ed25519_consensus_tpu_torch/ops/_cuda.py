"""Build, load and launch the hand-written Hopper kernels of `csrc/`.

Each `csrc/*.cu` source is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface, at first use, under the checkout's
`build/` directory (the kernel cache, which `.gitignore` lists).  A library's
file name carries a hash of its source, the shared headers and the flags, so
an edited source is rebuilt and a stale one is never loaded.  Sources
built together build in parallel, one `nvcc` each.  The libraries are loaded with ctypes:
pointers and the stream pass as `c_void_p`, and every C entry returns
`cudaGetLastError()` (or `cudaErrorInvalidValue` for arguments it refuses),
which `Kernel.launch` raises on as a `CudaError` carrying the code
(health.classify_device_error reads it: a sticky error has poisoned the
device's context).

`INSTANTIATIONS` lists every compiled kernel: its base name, its source and
its C argument types.  A base name's C entry is the name with "-" turned
into "_" plus "_launch" (`window_sums-r32` → `window_sums_r32_launch`), its
kernel the same plus "_kernel", which is what ptxas's report names
(`ptxas_usage`).  Several instantiations share a source (K2 and K2t live in
window_sums.cu, K3 and K5 in fold_partials.cu); a source builds once.
`VERDICT` names the instantiations a verdict path launches by default;
their sources build together at a verdict path's first call (`load_all`),
and every other source (the kernel lab's forms, the probes, the hybrid
body) builds only when one of its kernels is first launched, or when a lab
tool or `chip_smoke.py` calls `build_all()`.

`BLOCK_FORMS` says which of its two kernels a window-sum instantiation
holds: NAME_kernel (every window in one block, "all") and NAME_w_kernel
(any windows per block W, "w"); the rest hold both.  The sources emit
only these (the FORMS argument of csrc/window_sums.cuh's macros), so no
kernel is built that no path launches.  The default K2 and K2t
(window_sums_u32.cuh) hold only "all"; a verdict path that the
windows-per-block knob sends to fewer windows runs the 20-limb kernels, the
lab's `window_sums-l20` and `window_sums_tables-l20`, whose any-W kernels
are in a source of their own (`W_SOURCES`), out of the verdict sources.

Each `Kernel` counts its launches: `launches` is incremented where the
kernel is launched and nowhere else, so a run can show that a path went
through it (`chip_smoke.py` resets the counts before a path and reads them
after).  The window-sum kernels take their windows per block (W) as a
launch argument; `kernel(base, suffix)` keeps a separate `Kernel` and count
for each W a caller launches with (`window_sums-l20-w11` shares the entry
of `window_sums-l20`), so a run shows which form ran.

Nothing here runs at import time: the CPU tests import every module, and
this machine-independent module only touches `nvcc` when a CUDA tensor
reaches a wrapper.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int


class CudaError(RuntimeError):
    """A kernel launch that returned a `cudaError_t` other than success."""

    def __init__(self, name: str, code: int):
        super().__init__(f"CUDA kernel {name} failed to launch: error "
                         f"{code}")
        self.cuda_error = int(code)


class Kernel:
    """One CUDA kernel as a caller launches it: its source, its C entry
    point and its launch count."""

    def __init__(self, name: str, source: str, entry: str, argtypes):
        self.name = name
        self.source = source
        self.entry = entry
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def library_path(self) -> Path:
        return library_path(self.source)

    def function(self):
        """The loaded C entry point, building its source first if its
        library is not in the cache (with the other verdict sources, for a
        verdict source)."""
        if self._fn is None:
            with _BUILD_LOCK:
                if not self.library_path().exists():
                    build_all(build_group(self.source))
                lib = ctypes.CDLL(str(self.library_path()))
                fn = getattr(lib, self.entry)
                fn.argtypes = self.argtypes
                fn.restype = _I
                self._fn = fn
        return self._fn

    def launch(self, device, *args) -> None:
        """Calls the C entry with `args` and the current stream of
        `device`, with `device` made current: streams and kernel attributes
        are per device."""
        import torch

        fn = self.function()
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err:
            raise CudaError(self.name, err)
        self.launches += 1


# C argument lists (the stream is the last argument of every entry).
_POINTS = [_P, _P, _I, _I, _P]            # in, out, B, N, stream
_K2 = [_P, _I, _P, _P, _I, _I, _I, _P]    # digits, packed, points, out,
#                                           B, N, W, stream
_K2T = [_P, _I, _P, _I, _I, _P, _P, _I, _I, _I, _P]  # digits, packed, head,
#                    head_batched, n_head, r_tables, out, B, N, W, stream
_K5 = [ctypes.POINTER(_P), _I, _P, _I, _P]  # shard pointers, D, out, B,
#                                             stream

INSTANTIATIONS = {
    "expand_compressed": ("expand_compressed.cu", _POINTS),
    "window_sums": ("window_sums.cu", _K2),
    "fold_partials": ("fold_partials.cu", _POINTS),
    "window_sums_tables": ("window_sums.cu", _K2T),
    "build_tables": ("build_tables.cu", _POINTS),
    "fold_shards": ("fold_partials.cu", _K5),
    "expand_affine": ("expand_affine.cu", _POINTS),
    # the kernel lab's variants (window_sums.cuh templates): first the 20-limb
    # default K2 and K2t, timed beside window_sums_u32.cuh's
    "window_sums-l20": ("window_sums_lab.cu", _K2),
    "window_sums_tables-l20": ("window_sums_lab.cu", _K2T),
    "window_sums-i16fold": ("window_sums_lab.cu", _K2),
    "window_sums-i32tbl": ("window_sums_lab.cu", _K2),
    "window_sums-i32tbl-c32": ("window_sums_lab.cu", _K2),
    "window_select_only": ("window_sums_lab.cu", _K2T),
    "window_sums-r32": ("window_sums_r32.cu", _K2),
    "window_sums-r32-i32tbl-c32": ("window_sums_r32.cu", _K2),
    "window_sums_tables-r32": ("window_sums_r32.cu", _K2T),
    "window_sums-hybrid": ("window_sums_hybrid.cu", _K2),
    "fold_partials-i16fold": ("fold_partials.cu", _POINTS),
    "fold_partials-r32": ("fold_partials.cu", _POINTS),
    # the 20-limb K1, K3, K4, K5 and K6, timed beside the fe8 ones
    "expand_compressed-l20": ("expand_compressed.cu", _POINTS),
    "fold_partials-l20": ("fold_partials.cu", _POINTS),
    "build_tables-l20": ("build_tables.cu", _POINTS),
    "fold_shards-l20": ("fold_partials.cu", _POINTS),
    "expand_affine-l20": ("expand_affine.cu", _POINTS),
    "build_tables-r32": ("build_tables.cu", _POINTS),
    # the micro-probes (probes.cu)
    "probe_chain-add": ("probes.cu", _POINTS),
    "probe_chain-mul": ("probes.cu", _POINTS),
    "probe_chain-shift": ("probes.cu", _POINTS),
    "probe_chain-madd": ("probes.cu", _POINTS),
    "probe_fmul": ("probes.cu", _POINTS),
    # the self-test of the fe8 field arithmetic (fe25519_u32.cuh) and the
    # latency of one complete addition in a chain
    "probe_fe8": ("probes.cu", _POINTS),
    "probe_ge8": ("probes.cu", _POINTS),
}

# What a verdict path launches with no knob set.  The windows-per-block
# knob reaches the NAME_w_kernel of window_sums-l20 and
# window_sums_tables-l20 (W_SOURCES); the body knob's `hybrid` is loaded
# when it is set.
VERDICT = ("expand_compressed", "window_sums", "fold_partials",
           "window_sums_tables", "build_tables", "fold_shards",
           "expand_affine")
VERDICT_SOURCES = tuple(sorted({INSTANTIATIONS[b][0] for b in VERDICT}))

# The any-W kernels held by a source of their own (same C entry name, a
# library of their own): built when a W below the window count is first
# launched, or by load_all when ED25519_TPU_WIN_CHUNK is set.
W_SOURCES = {"window_sums-l20": "window_sums_w.cu",
             "window_sums_tables-l20": "window_sums_w.cu"}

# Window-sum instantiations that hold one kernel only (the others: both).
BLOCK_FORMS = {
    "window_sums": "all",
    "window_sums_tables": "all",
    "window_sums-i16fold": "w",
    "window_sums-i32tbl": "all",
    "window_sums-i32tbl-c32": "all",
    "window_select_only": "all",
    "window_sums-r32-i32tbl-c32": "all",
    "window_sums_tables-r32": "all",
}


def entry_of(base: str) -> str:
    return base.replace("-", "_") + "_launch"


def block_form_built(base: str, all_windows: bool) -> bool:
    """Whether window-sum instantiation `base` holds a kernel for every
    window in one block (`all_windows`) or for fewer: the "w" kernel
    takes any W, the number of windows included."""
    form = BLOCK_FORMS.get(base, "both")
    return form != "all" or all_windows


def kernel_symbol(base: str, suffix: str = "") -> str:
    """The kernel ptxas reports for an instantiation launched in the form
    `suffix` ("" or "-w<W>"): NAME_kernel for every window in one block,
    NAME_w_kernel for fewer or where the instantiation holds only that."""
    windowed = bool(suffix) or BLOCK_FORMS.get(base) == "w"
    return base.replace("-", "_") + ("_w_kernel" if windowed else "_kernel")


def base_of(name: str) -> str:
    """The instantiation a kernel name launches: the name without its
    windows-per-block suffix."""
    return re.sub(r"-w\d+$", "", name)


KERNELS = {base: Kernel(base, src, entry_of(base), argtypes)
           for base, (src, argtypes) in INSTANTIATIONS.items()}


def kernel(base: str, suffix: str = "") -> Kernel:
    """The Kernel of instantiation `base` launched in the form `suffix`
    ("" or "-w<W>"), created at first use with a count of its own."""
    name = base + suffix
    k = KERNELS.get(name)
    if k is None:
        src, argtypes = INSTANTIATIONS[base]
        if suffix:
            src = W_SOURCES.get(base, src)
        k = KERNELS.setdefault(name, Kernel(name, src, entry_of(base),
                                            argtypes))
    return k


_BUILD_LOCK = threading.RLock()


def sources() -> list:
    return sorted({src for src, _ in INSTANTIATIONS.values()}
                  | set(W_SOURCES.values()))


def build_group(source: str) -> list:
    """The sources built together with `source` when its library is
    missing: the verdict sources for one of them, else `source` alone."""
    return list(VERDICT_SOURCES) if source in VERDICT_SOURCES else [source]


def library_path(source: str) -> Path:
    h = hashlib.sha256()
    for f in [CSRC / source] + sorted(CSRC.glob("*.cuh")):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def build_all(srcs=None) -> dict:
    """Compile every source of `srcs` (None: every source) whose library
    is missing, all at once (one `nvcc` per source).  Returns {source: {"seconds", "log"}} for the
    sources built, the log being the compiler's `-Xptxas -v` report
    (registers, spills, shared memory).  Raises if any build fails, with
    the compiler's output."""
    with _BUILD_LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        t0 = time.perf_counter()
        procs = {}
        for src in sources() if srcs is None else srcs:
            out = library_path(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[src] = (out, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        report, failed = {}, []
        for src, (out, tmp, p) in procs.items():
            log, _ = p.communicate()
            report[src] = {"seconds": time.perf_counter() - t0, "log": log}
            if p.returncode != 0:
                failed.append(f"{src}:\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return report


def ptxas_usage(log: str) -> dict:
    """{kernel symbol: {"registers", "spill_stores", "spill_loads"}} from
    a `-Xptxas -v` report (bytes of spill stores and loads; a kernel's
    own frame, not the out-of-line field multiply's)."""
    usage, entry, props = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            usage.setdefault(entry, {})
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props in usage:
            usage[props].update(spill_stores=int(m.group(1)),
                                spill_loads=int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            usage[entry]["registers"] = int(m.group(1))
    return usage


def load_all() -> None:
    """Build what is missing and load the C entry point of every
    instantiation a verdict path launches — `VERDICT`, and the hybrid
    body when ED25519_TPU_PALLAS_BODY selects it now — so a build or load
    failure raises here, in the caller's thread, before any work is
    handed to a device lane; the any-W kernels are built too when
    ED25519_TPU_WIN_CHUNK is set now.  The lab's forms and the probes are
    not built here."""
    from .. import config as _config

    bases = list(VERDICT)
    if _config.get("ED25519_TPU_PALLAS_BODY") == "hybrid":
        bases.append("window_sums-hybrid")
    srcs = {INSTANTIATIONS[b][0] for b in bases}
    if _config.get("ED25519_TPU_WIN_CHUNK") is not None:
        srcs |= set(W_SOURCES.values())
    build_all(sorted(srcs))
    for base in bases:
        KERNELS[base].function()


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
