"""Native host runtime: the C++ ZIP215 decompression, scalar staging, host
MSM and fused host verify of `csrc/host/fe25519.cpp`, bound with ctypes.

The batch verifier stages n + m point decompressions per batch; each costs
~30 µs in exact Python (one big-int pow for the square root), which caps
end-to-end throughput long before the device MSM does.  This module builds
the C++ source with `g++ -O3 -march=native -shared -fPIC` at first use into
the checkout's `build/` directory (gitignored; the kernels' cache too).  The
library's file name carries a hash of the source, the flags and the host:
`-march=native` makes the binary machine-specific, so a checkout moved to
another machine rebuilds instead of loading a library that could die with
SIGILL.  Builds go to a temporary name and are renamed into place, so
concurrent first uses (test workers) never load a half-written file.

Exactness: the C++ path is plain integer arithmetic, bit-identical to the
exact-Python host field; `load()` runs a parity self-check against it and
returns None when the toolchain, the load or the check fails — callers then
take the exact-Python path.  `ED25519_TPU_DISABLE_NATIVE=1` selects that
path on purpose (re-checked on every `load()`)."""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from . import config as _config

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "host" / "fe25519.cpp"
BUILD_DIR = _PKG.parent / "build"
CXXFLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lib = None
_lib_failed = False
_load_lock = threading.Lock()


def library_path() -> Path:
    """Where the library for this source, these flags and this host
    lives (built or not)."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    u = os.uname()
    h.update(f"{u.machine}|{u.nodename}".encode())
    return BUILD_DIR / f"fe25519-host-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is already in `build/`; raises
    (CalledProcessError, with the compiler's output) on a failed build."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            subprocess.run(["g++", *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return out


def _disabled_by_request() -> bool:
    """ED25519_TPU_DISABLE_NATIVE, re-checked on every load(): a disable
    is its own state, not a latched failure — unsetting the knob
    mid-process re-enables the library, and `_lib_failed` keeps meaning
    exactly 'build/load/self-check failed'."""
    return _config.get("ED25519_TPU_DISABLE_NATIVE")


def load():
    """The ctypes library, building it if needed; None if unavailable (no
    toolchain, load failure, failed self-check, or disabled via
    ED25519_TPU_DISABLE_NATIVE=1 — every caller has an exact-Python
    path, so disabling trades speed for nothing)."""
    global _lib, _lib_failed
    if _disabled_by_request():
        return None
    if _lib is not None or _lib_failed:
        return _lib
    with _load_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
            _self_check(lib)
            _lib = lib
        except Exception:
            _lib_failed = True
            _lib = None
    return _lib


def _bind(lib) -> None:
    c, u64 = ctypes.c_char_p, ctypes.c_uint64
    sigs = {
        "zip215_decompress_batch": ([c, u64, c, c, c], None),
        "edwards_vartime_msm": ([c, c, u64, c], None),
        "zip215_check_prehashed": ([c] * 5, ctypes.c_int),
        "stage_scalars_gid": ([c, c, c, u64, c, u64, c, c], ctypes.c_int),
        "verify_host_gid": ([c, c, c, c, c, u64, c, u64, c, c, c],
                            ctypes.c_int),
        "msm_shift128_row": ([c, c], None),
        "msm_build_table": ([c, c], None),
        "bulk_challenges": ([c, c, c, u64, c], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def _self_check(lib):
    """Startup parity check against the exact Python path: decompression
    (a point, the identity encoding, a non-point), the MSM on short and
    full-width scalars with a torsion point, the cofactored equation on a
    real and a tampered signature, and the challenge hashes (the leading
    eight messages share a padded block count, so the 8-way SIMD SHA-512
    path of this machine's -march=native build runs here)."""
    from .ops import edwards, scalar
    from .signing_key import SigningKey

    cases = [edwards.BASEPOINT.compress(), (1).to_bytes(32, "little"),
             (2).to_bytes(32, "little")]
    for enc, pt in zip(cases, _decompress_batch_raw(lib, cases)):
        want = edwards.decompress(enc)
        if (pt is None) != (want is None) or (pt is not None
                                              and pt != want):
            raise RuntimeError("native decompress disagreement")
    B = edwards.BASEPOINT
    if _vartime_msm_raw(lib, [2, 3], [B, B]) != B.scalar_mul(5):
        raise RuntimeError("native msm disagreement")
    a = (1 << 252) + 0x123456789ABCDEF_FEDCBA987654321
    b = scalar.L - 2
    T8 = edwards.eight_torsion()[1]
    if _vartime_msm_raw(lib, [a, b], [B, T8]) != \
            B.scalar_mul(a).add(T8.scalar_mul(b)):
        raise RuntimeError("native msm disagreement (wide)")
    sk = SigningKey.from_bytes(bytes(range(32)))
    sig = sk.sign(b"native self check")
    vk = sk.verification_key()
    h = hashlib.sha512()
    h.update(sig.R_bytes)
    h.update(vk.A_bytes.to_bytes())
    h.update(b"native self check")
    k = scalar.from_hash(h)
    s = scalar.from_canonical_bytes(sig.s_bytes)
    R = edwards.decompress(sig.R_bytes)

    def check(kk):
        return bool(lib.zip215_check_prehashed(
            _point128(vk.minus_A), _point128(R), _point128(B),
            int(kk).to_bytes(32, "little"), int(s).to_bytes(32, "little")))

    if not check(k) or check(scalar.add(k, 1)):
        raise RuntimeError("native check_prehashed disagreement")
    msgs = [b"uniform-%03d" % i for i in range(8)]
    msgs += [b"", b"native self check", b"x" * 300]
    ra = b"".join(bytes([i]) * 32 + bytes([0x80 | i]) * 32
                  for i in range(len(msgs)))
    for i, got in enumerate(_bulk_challenges_raw(lib, ra, msgs)):
        h = hashlib.sha512()
        h.update(bytes([i]) * 32)
        h.update(bytes([0x80 | i]) * 32)
        h.update(msgs[i])
        if got != scalar.from_hash(h):
            raise RuntimeError("native bulk_challenges disagreement")


def point_from_raw(row):
    """One (128,) uint8 raw row → exact host Point."""
    from .ops.edwards import Point

    b = bytes(row)
    return Point(*(int.from_bytes(b[32 * i: 32 * i + 32], "little")
                   for i in range(4)))


def _point128(pt) -> bytes:
    from .ops.field import P

    return b"".join((c % P).to_bytes(32, "little")
                    for c in (pt.X, pt.Y, pt.Z, pt.T))


def _decompress_batch_raw(lib, encodings):
    n = len(encodings)
    out = ctypes.create_string_buffer(128 * n)
    ok = ctypes.create_string_buffer(n)
    lib.zip215_decompress_batch(b"".join(encodings), n, out, ok, None)
    buf, okb = out.raw, ok.raw
    return [point_from_raw(buf[128 * i: 128 * (i + 1)]) if okb[i] else None
            for i in range(n)]


def _vartime_msm_raw(lib, scalars, points):
    sblob = b"".join(int(s).to_bytes(32, "little") for s in scalars)
    pblob = b"".join(_point128(p) for p in points)
    out = ctypes.create_string_buffer(128)
    lib.edwards_vartime_msm(sblob, pblob, len(scalars), out)
    return point_from_raw(out.raw)


def _cbuf(b):
    """ctypes argument from any contiguous byte-like, zero-copy for
    writable buffers (bytearray, array.array)."""
    if isinstance(b, bytes):
        return b
    return (ctypes.c_char * (len(b) * getattr(b, "itemsize", 1))) \
        .from_buffer(b)


def decompress_batch_buffer(blob: bytes, n: int):
    """Batched ZIP215 decompression of n concatenated 32-byte encodings:
    (raw, ok, hints) numpy arrays — raw (n, 128) uint8 canonical X‖Y‖Z‖T
    rows, ok (n,) uint8, hints (n,) uint8 the device-wire flip/neg bits
    (ops/torch_decompress.py); rows of rejected encodings are zero.  None
    without the native library."""
    import numpy as np

    lib = load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(128 * n)
    ok = ctypes.create_string_buffer(n)
    hints = ctypes.create_string_buffer(n)
    lib.zip215_decompress_batch(blob, n, out, ok, hints)
    return (np.frombuffer(out, dtype=np.uint8,
                          count=128 * n).reshape(n, 128).copy(),
            np.frombuffer(ok, dtype=np.uint8, count=n).copy(),
            np.frombuffer(hints, dtype=np.uint8, count=n).copy())


def _accs(lib_fn, args, m: int):
    b_out = ctypes.create_string_buffer(56)
    a_out = ctypes.create_string_buffer(56 * m)
    if not lib_fn(*args, b_out, a_out):
        return None
    araw = a_out.raw  # one copy: .raw re-copies the buffer per access
    return (int.from_bytes(b_out.raw, "little"),
            [int.from_bytes(araw[56 * g: 56 * (g + 1)], "little")
             for g in range(m)])


def stage_scalars_gid(s_buf, k_buf, z_blob, n: int, gid_buf, m: int):
    """Queue-order native scalar staging: the per-signature buffers stay
    in arrival order and `gid_buf` (n int32 group ids) routes each Σz·k
    contribution to its key's accumulator: the ZIP215 `s < ℓ` checks and
    the unreduced sums Σz·s and per-key Σz·k.  (B_acc, [A_acc_g...])
    ints, None if some s ≥ ℓ, NotImplemented without the native
    library."""
    lib = load()
    if lib is None:
        return NotImplemented
    return _accs(lib.stage_scalars_gid,
                 (_cbuf(s_buf), _cbuf(k_buf), _cbuf(z_blob), n,
                  _cbuf(gid_buf), m), m)


def msm_shift128_row(row128: bytes):
    """[2^128]P as a raw projective row via 128 native doublings; None
    without the native library."""
    lib = load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(128)
    lib.msm_shift128_row(bytes(row128), out)
    return out.raw


def msm_build_table(row128: bytes):
    """One term's 1440-byte plane-major Niels table (the per-key
    coefficient table of the fused host verify); None without the native
    library."""
    lib = load()
    if lib is None:
        return None
    out = ctypes.create_string_buffer(1440)
    lib.msm_build_table(row128, out)
    return out.raw


def verify_host_batch(key_rows, r_buf, s_buf, k_buf, z_blob, n: int,
                      gid_buf, m: int, b_row: bytes, shift_rows=None,
                      prebuilt=None):
    """ONE native call for a whole host batch verification over the
    queue-order buffers: R decompression, s < ℓ, gid-routed coalescing,
    mod-ℓ reduction, the MSM and the cofactored identity check.  True /
    False for the batch verdict, None when staging rejects (bad R or
    s ≥ ℓ), NotImplemented without the native library."""
    lib = load()
    if lib is None:
        return NotImplemented
    res = lib.verify_host_gid(
        _cbuf(key_rows), _cbuf(r_buf), _cbuf(s_buf), _cbuf(k_buf),
        _cbuf(z_blob), n, _cbuf(gid_buf), m, b_row,
        None if shift_rows is None else _cbuf(shift_rows),
        None if prebuilt is None else _cbuf(prebuilt))
    return None if res < 0 else bool(res)


def _bulk_challenges_raw(lib, ra_blob: bytes, msgs, raw: bool = False):
    import numpy as np

    n = len(msgs)
    offs = np.zeros(n + 1, dtype=np.uint64)
    np.cumsum(np.fromiter(map(len, msgs), dtype=np.uint64, count=n),
              out=offs[1:])
    out = ctypes.create_string_buffer(32 * n)
    lib.bulk_challenges(ra_blob, b"".join(msgs),
                        offs.ctypes.data_as(ctypes.c_char_p), n, out)
    blob = out.raw
    if raw:
        return blob
    return [int.from_bytes(blob[32 * i: 32 * i + 32], "little")
            for i in range(n)]


def bulk_challenges(ra_blob: bytes, msgs, raw: bool = False):
    """k_i = SHA-512(R_i ‖ A_i ‖ msg_i) mod ℓ for a whole stream in one
    native call; `ra_blob` is n concatenated 64-byte R‖A rows.  list[int],
    or with `raw` the packed n×32-byte little-endian blob; NotImplemented
    without the native library."""
    lib = load()
    if lib is None:
        return NotImplemented
    return _bulk_challenges_raw(lib, ra_blob, msgs, raw=raw)


def vartime_msm_scblob(sblob: bytes, raw_points):
    """Σ[c_i]P_i with scalars as n × 32-byte little-endian and points as
    the (n, 128) uint8 raw rows — the host-backend MSM; None without the
    native library."""
    import numpy as np

    lib = load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(raw_points)
    out = ctypes.create_string_buffer(128)
    lib.edwards_vartime_msm(sblob, pts.ctypes.data_as(ctypes.c_char_p),
                            len(sblob) // 32, out)
    return point_from_raw(out.raw)
