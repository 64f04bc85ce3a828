"""What the compiler made of the kernels on the 8 x 32-bit arithmetic
(csrc/fe25519_u32.cuh) — K1 (expand_compressed.cu), K2 and K2t
(window_sums.cu), K3 and K5 (fold_partials.cu), K4 (build_tables.cu), K6
(expand_affine.cu) — on the card's toolkit.

    python -m ed25519_consensus_tpu_torch.tools.ptxas_report

* ptxas's registers and spills for window_sums_kernel and
  window_sums_tables_kernel as built (fe8_mul inlined) and with
  -DFE8_MUL_NOINLINE (fe8_mul out of line), each with the resident warps
  an SM they imply (`occupancy`): the report behind the choice of inlining.
* The same for expand_compressed_kernel (K1) built at each minimum of
  resident blocks in `K1_MIN_BLOCKS` (its __launch_bounds__ argument):
  the report behind the choice of its launch bounds; the same for
  build_tables_kernel (K4) at each `K4_MIN_BLOCKS`, with its time in each
  build on the card (`k4_times`, at the zcash10k and cometbft128 chunks'
  R lanes): the report behind its launch bounds; the same for
  expand_affine_kernel (K6) at each `K6_MIN_BLOCKS`, timed at the affine
  pass's single-lane and D = 2 shapes (`k6_times`); and for
  fold_partials_kernel (K3) and fold_shards_kernel (K5) as built.
* `cuobjdump -sass` of csrc/probes.cu: the instructions of each
  out-of-line operation of the self-test kernel probe_fe8 (st_fe8_add,
  st_fe8_mul, ...), all of them and the integer multiply-adds among them
  (`sass_counts`), beside the hand counts chip_smoke.py prices the bounds
  with.

Builds go to build/ptxas/ (the kernel cache's directory, which .gitignore
lists), not into the cache.  Without nvcc it prints a "skipped" line and
exits 0.
"""

import re
import shutil
import subprocess
import sys
from pathlib import Path

from ..ops import _cuda, msm

# An H100 SM: 65,536 registers in warp allocations of 256, 233,472 B of
# shared memory with 1,024 B reserved a block, 64 warps, 32 blocks.
SM_REGISTERS = 65_536
SM_SHARED = 233_472
BLOCK_RESERVED = 1_024
SM_WARPS = 64
SM_BLOCKS = 32

# Threads and shared memory a block of the kernels on the fe8 arithmetic
# (csrc/expand_compressed.cu K1_THREADS; csrc/fold_partials.cu: 128 staged
# rows of 336 bytes, and K5's K5_WARPS = 4 warps; csrc/build_tables.cu:
# K2's table threads, two a lane, and its u32 table; csrc/expand_affine.cu:
# 128 lanes, 40 int16 rows staged in and 60 out).
K1_THREADS = 128
FOLD_SHARED_BYTES = msm.FOLD_THREADS * 21 * 16
K4_THREADS = 2 * msm.CHUNK
K5_THREADS = 4 * 32
K6_LANES = 128
K6_SHARED_BYTES = (40 + 60) * K6_LANES * 2
FE8_BLOCKS = {
    "window_sums_kernel": (msm.U32_THREADS, msm.U32_SHARED_BYTES),
    "window_sums_tables_kernel": (msm.U32_THREADS, msm.U32_SHARED_BYTES),
    "expand_compressed_kernel": (K1_THREADS, 0),
    "fold_partials_kernel": (msm.FOLD_THREADS, FOLD_SHARED_BYTES),
    "build_tables_kernel": (K4_THREADS, msm.U32_TABLE_BYTES),
    "fold_shards_kernel": (K5_THREADS, 0),
    "expand_affine_kernel": (K6_LANES, K6_SHARED_BYTES),
}
K1_MIN_BLOCKS = (1, 2, 3, 4, 5, 6, 8)
# K4's table holds 3 blocks an SM whatever the registers.
K4_MIN_BLOCKS = (1, 2, 3)
# K6's two staging areas hold 8 blocks an SM.
K6_MIN_BLOCKS = (1, 2, 4, 5, 6, 8)


def occupancy(registers: int, threads: int = msm.U32_THREADS,
              smem: int = msm.U32_SHARED_BYTES) -> dict:
    """Blocks and warps an SM holds for a kernel of `registers` a thread,
    `threads` a block and `smem` bytes of dynamic shared memory a block,
    and which resource limits it."""
    warps = -(-threads // 32)
    regs_warp = -(-registers * 32 // 256) * 256
    limits = {"registers": SM_REGISTERS // (regs_warp * warps),
              "shared memory": SM_SHARED // (smem + BLOCK_RESERVED),
              "warps": SM_WARPS // warps, "blocks": SM_BLOCKS}
    blocks = min(limits.values())
    return {"blocks": blocks, "warps": blocks * warps,
            "limited_by": min(limits, key=limits.get)}


def usage_line(label: str, kernel: str, u: dict) -> str:
    """One kernel's registers, spills and resident warps an SM."""
    threads, smem = FE8_BLOCKS[kernel]
    occ = occupancy(u.get("registers", 255), threads, smem)
    return (f"{label} {kernel}: {u.get('registers')} registers x {threads} "
            f"threads, {smem} B shared a block, spill stores "
            f"{u.get('spill_stores')} B, loads {u.get('spill_loads')} B; "
            f"{occ['blocks']} blocks = {occ['warps']} warps an SM (limited "
            f"by {occ['limited_by']})")


def variant_path(source: str, defines=()) -> Path:
    """Where `ptxas_build` puts csrc/`source` built with `defines`."""
    tag = "-".join(d.lower() for d in defines) or "default"
    return _cuda.BUILD_DIR / "ptxas" / f"{Path(source).stem}-{tag}.so"


def ptxas_build(source: str, defines=()) -> dict:
    """Compiles csrc/`source` with the kernel cache's flags and the `-D`
    `defines` to `variant_path`; returns {kernel: {"registers",
    "spill_stores", "spill_loads"}} from ptxas's report."""
    out = variant_path(source, defines)
    out.parent.mkdir(parents=True, exist_ok=True)
    p = subprocess.run(
        [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, *[f"-D{d}" for d in defines],
         "-o", str(out), str(_cuda.CSRC / source)],
        capture_output=True, text=True, timeout=600)
    if p.returncode:
        raise RuntimeError(f"nvcc failed on {source} {defines}:\n"
                           f"{p.stdout}{p.stderr}")
    return _cuda.ptxas_usage(p.stdout + p.stderr)


def cuobjdump_path():
    """cuobjdump from the CUDA toolkit, or triton's copy, or None."""
    try:
        nvcc = Path(_cuda.nvcc_path())
    except RuntimeError:
        nvcc = None
    if nvcc is not None and (nvcc.parent / "cuobjdump").exists():
        return str(nvcc.parent / "cuobjdump")
    found = shutil.which("cuobjdump")
    if found:
        return found
    try:
        import triton

        cand = Path(triton.__file__).parent / "backends" / "nvidia" / \
            "bin" / "cuobjdump"
        return str(cand) if cand.exists() else None
    except ImportError:
        return None


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")

# The out-of-line operations probe_fe8_kernel calls, in the order of its
# call sites (csrc/probes.cu).
FE8_CALLS = ("st_fe8_add", "st_fe8_sub", "st_fe8_neg", "st_fe8_mul",
             "st_fe8_from_limbs20", "st_fe8_to_limbs20_canonical",
             "st_ge8_add", "st_fe8_sq")


def sass_counts(library: Path, kernel: str = "probe_fe8_kernel",
                calls=FE8_CALLS) -> dict:
    """{function: {"instructions", "imad"}} for the out-of-line functions
    `kernel` calls, from `cuobjdump -sass` of `library`.  The SASS lists a
    non-inlined device function as a subroutine inside its caller's
    listing: the n-th CALL.REL of the kernel (its call sites in source
    order) targets the body of calls[n], which runs to its first RET.
    Counted: every instruction of the body but the RET and NOPs, and the
    IMAD family among them.  None when no cuobjdump is found."""
    tool = cuobjdump_path()
    if tool is None:
        return None
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    insns, inside = [], False
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            inside = m.group(1) == kernel
            continue
        m = _INSN.search(line) if inside else None
        if m:
            insns.append((int(m.group(1), 16), m.group(2), m.group(3)))
    targets = []
    for _, op, args in insns:
        if op.startswith("CALL"):
            t = re.search(r"0x([0-9a-f]+)", args)
            if t:
                targets.append(int(t.group(1), 16))
    counts = {}
    for name, start in zip(calls, targets):
        n = imad = 0
        for off, op, _ in insns:
            if off < start or op.startswith("NOP"):
                continue
            if op.startswith("RET"):
                break
            n += 1
            imad += op.startswith("IMAD")
        counts[name] = {"instructions": n, "imad": imad}
    return counts


def bound_times(source: str, macro: str, values, pts, out_shape,
                launches: int = 20, reps: int = 5) -> dict:
    """{value: ms a launch} of the points kernel of csrc/`source` (C entry
    <stem>_launch(points, out, B, N, stream)) in each build of `values` of
    its launch-bound macro (`ptxas_build` with -D`macro`=value), on one
    card, on the points `pts` (B, ., 20, N) int16 into an int16 tensor of
    `out_shape`: CUDA events around `launches` launches, the median of
    `reps`, after a warm-up.  Every build's output equals the first's."""
    import ctypes
    import statistics

    import torch

    B, N = pts.shape[0], pts.shape[-1]
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    out, first = {}, None
    for m in values:
        tag = f"{Path(source).stem} {macro}={m}"
        fn = getattr(ctypes.CDLL(str(variant_path(
            source, (f"{macro}={m}",)))), Path(source).stem + "_launch")
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        res = torch.empty(out_shape, dtype=torch.int16, device=pts.device)

        def run():
            err = fn(pts.data_ptr(), res.data_ptr(), B, N, stream)
            if err:
                raise _cuda.CudaError(tag, err)

        run()
        torch.cuda.synchronize()
        if first is None:
            first = res.clone()
        elif not torch.equal(res, first):
            raise AssertionError(f"{tag} differs from {values[0]}")
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(launches):
                run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / launches)
        out[m] = statistics.median(times)
    return out


def _random_limbs(shape, lo: int, seed: int):
    import torch

    gen = torch.Generator().manual_seed(seed)
    return torch.randint(lo, -lo, shape, dtype=torch.int16,
                         generator=gen).to("cuda")


def k4_times(B: int = 8, N: int = 10_046) -> dict:
    """{K4_MIN_BLOCKS: ms a launch} of build_tables_kernel (`bound_times`)
    on random points (limbs in [-4096, 4095]; the kernel's work does not
    depend on the data), B x N lanes: by default the zcash10k chunk's R
    lanes; main also times the cometbft128 chunk's, B = 8, N = 190."""
    pts = _random_limbs((B, 4, 20, N), -4096, 4)
    return bound_times("build_tables.cu", "K4_MIN_BLOCKS", K4_MIN_BLOCKS,
                       pts, (B, msm.NTABLE, 4, 20, N))


def k6_times(B: int = 8, N: int = 10_176) -> dict:
    """{K6_MIN_BLOCKS: ms a launch} of expand_affine_kernel (`bound_times`)
    on a random affine wire (limbs in [-8191, 8190], the wire's bound),
    B x N lanes: by default the affine pass's single-lane chunk; main also
    times a D = 2 shard's, N = 5,088."""
    pts = _random_limbs((B, 2, 20, N), -8191, 6)
    return bound_times("expand_affine.cu", "K6_MIN_BLOCKS", K6_MIN_BLOCKS,
                       pts, (B, 4, 20, N))


def main(argv=None) -> int:
    try:
        _cuda.nvcc_path()
    except RuntimeError:
        print("# ptxas report: SKIPPED — no nvcc (the CUDA toolkit builds "
              "the kernels on the card's machine)")
        return 0
    from concurrent.futures import ThreadPoolExecutor

    builds = [("window_sums.cu", d) for d in ((), ("FE8_MUL_NOINLINE",))]
    builds += [("expand_compressed.cu", (f"K1_MIN_BLOCKS={m}",))
               for m in K1_MIN_BLOCKS]
    builds += [("build_tables.cu", (f"K4_MIN_BLOCKS={m}",))
               for m in K4_MIN_BLOCKS]
    builds += [("expand_affine.cu", (f"K6_MIN_BLOCKS={m}",))
               for m in K6_MIN_BLOCKS]
    builds.append(("fold_partials.cu", ()))
    with ThreadPoolExecutor(len(builds)) as pool:
        usages = list(pool.map(lambda b: ptxas_build(*b), builds))
    for (source, defines), usage in zip(builds, usages):
        for k in FE8_BLOCKS:
            if k in usage:
                print("ptxas " + usage_line(
                    f"{source} {' '.join(defines) or 'as built'}", k,
                    usage[k]))
    import torch

    if torch.cuda.is_available():
        for kernel, macro, fn, shapes in (
                ("build_tables_kernel", "K4_MIN_BLOCKS", k4_times,
                 (10_046, 190)),
                ("expand_affine_kernel", "K6_MIN_BLOCKS", k6_times,
                 (10_176, 5_088))):
            for N in shapes:
                for m, ms in fn(N=N).items():
                    print(f"time {kernel} {macro}={m}: {ms:.4f} ms a "
                          f"launch (B = 8, N = {N}; "
                          f"{torch.cuda.get_device_name(0)})")
    _cuda.build_all(["probes.cu"])
    counts = sass_counts(_cuda.library_path("probes.cu"))
    print(f"sass probes.cu: {counts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
