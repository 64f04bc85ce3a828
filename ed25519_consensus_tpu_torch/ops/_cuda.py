"""Build, load and launch the hand-written Hopper kernels of `csrc/`.

Each `csrc/*.cu` source is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface, at first use, under the checkout's
`build/` directory (the kernel cache, which `.gitignore` lists).  A library's
file name carries a hash of its source, the shared header and the flags, so
an edited source is rebuilt and a stale one is never loaded.  All sources
build in parallel, one `nvcc` each.  The libraries are loaded with ctypes:
pointers and the stream pass as `c_void_p`, and every C entry returns
`cudaGetLastError()`, which `Kernel.launch` raises on as a `CudaError`
carrying the code (health.classify_device_error reads it: a sticky error
has poisoned the device's context).  Two kernels may share a source (K2
and K2t live in window_sums.cu, K3 and K5 in fold_partials.cu); a source
builds once.

Each `Kernel` counts its launches: `launches` is incremented where the
kernel is launched and nowhere else, so a run can show that the main path
went through it (`chip_smoke.py` resets the counts before the main path and
reads them after).

Nothing here runs at import time: the CPU tests import every module, and
this machine-independent module only touches `nvcc` when a CUDA tensor
reaches a wrapper.
"""

import ctypes
import hashlib
import os
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
    """One CUDA kernel: its source, its C entry point and its launch
    count."""

    def __init__(self, name: str, source: str, entry: str, argtypes):
        self.name = name
        self.source = source
        self.entry = entry
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    @property
    def path(self) -> Path:
        return CSRC / self.source

    def library_path(self) -> Path:
        h = hashlib.sha256()
        for f in (self.path, CSRC / "fe25519.cuh"):
            h.update(f.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.path.stem}-{h.hexdigest()[:16]}.so"

    def function(self):
        """The loaded C entry point, building every kernel first if this
        one's library is not in the cache."""
        if self._fn is None:
            with _BUILD_LOCK:
                if not self.library_path().exists():
                    build_all()
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


KERNELS = {
    k.name: k for k in (
        Kernel("expand_compressed", "expand_compressed.cu",
               "expand_compressed_launch", [_P, _P, _I, _I, _P]),
        Kernel("window_sums", "window_sums.cu", "window_sums_launch",
               [_P, _I, _P, _P, _I, _I, _P]),
        Kernel("fold_partials", "fold_partials.cu", "fold_partials_launch",
               [_P, _P, _I, _I, _P]),
        Kernel("window_sums_tables", "window_sums.cu",
               "window_sums_tables_launch",
               [_P, _I, _P, _I, _I, _P, _P, _I, _I, _P]),
        Kernel("build_tables", "build_tables.cu", "build_tables_launch",
               [_P, _P, _I, _I, _P]),
        Kernel("fold_shards", "fold_partials.cu", "fold_shards_launch",
               [_P, _P, _I, _I, _P]),
        Kernel("expand_affine", "expand_affine.cu", "expand_affine_launch",
               [_P, _P, _I, _I, _P]),
    )
}

_BUILD_LOCK = threading.RLock()


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def build_all() -> dict:
    """Compile every source whose library is missing, all at once (one
    `nvcc` per source).  Returns {source: {"seconds", "log"}} for the
    sources built, the log being the compiler's `-Xptxas -v` report
    (registers, spills, shared memory).  Raises if any build fails, with
    the compiler's output."""
    with _BUILD_LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        t0 = time.perf_counter()
        procs = {}
        for k in KERNELS.values():
            out = k.library_path()
            if out.exists() or k.source in procs:
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[k.source] = (k, out, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(k.path)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        report, failed = {}, []
        for name, (k, out, tmp, p) in procs.items():
            log, _ = p.communicate()
            report[name] = {"seconds": time.perf_counter() - t0, "log": log}
            if p.returncode != 0:
                failed.append(f"{k.source}:\n{log}")
                continue
            os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return report


def load_all() -> None:
    """Build what is missing and load every kernel's C entry point, so a
    build or load failure raises here, in the caller's thread, before any
    work is handed to a device lane."""
    for k in KERNELS.values():
        k.function()


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
