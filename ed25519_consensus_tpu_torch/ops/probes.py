"""The micro-probes' kernels (csrc/probes.cu) and their plain versions.

Counterparts of the JAX package's tools/microbench_pallas.py probe_chain
(`:41-79`, the pl.pallas_call at `:64`) and probe_fmul (`:82-116`, at
`:101`): a chain of n dependent int32 operations, or of n field multiplies,
over a tile, timed at two chain lengths so that the slope gives the cost of
one step (tools/microbench.py).

* `chain(x, op, n_steps)`: x (S, L) int32; a = x, b = x + 1, then n_steps of
  (a, b) ← (b, f(a, b)) with f ∈ {a + b, a·b, (a + 4096) >> 13, 3a + b};
  returns b.  Additions and multiplies wrap modulo 2^32 as int32 does in
  JAX and torch; the shift is arithmetic.
* `fmul_chain(x, n_steps)`: x (20, S, L) int32 field limbs in the bound of
  torch_field; the same recurrence with f = torch_field.mul (the kernel's
  fe_mul, csrc/fe25519.cuh), equal to the JAX package's pallas_msm._fmul_a
  chain mod p (tests/test_torch_variants.py says whether limb for limb).

* `fe8_selftest(x)`: x (n, 100) int32 rows of operands (`fe8_operands`)
  through every operation of csrc/fe25519_u32.cuh, the field arithmetic of
  K1, K2, K2t and K3, once each → (n, 132) int32; the plain version runs
  ops/fe_u32.py, the exact-integer model of that header, so kernel and
  plain version agree word for word.
* `extreme_points(n)`: point operands at the limbs' bound, |limb| = 8191,
  for K4's limits (chip_smoke.py, tests/test_torch_fe_u32_kernels.py).
* `ge8_chain(x, n_steps)`: x (80, S, L) int32 point limbs in the bound of
  torch_field; the (a, b) recurrence from a = b = x with f = ge8_add (the
  complete addition of fe25519_u32.cuh), out = b's canonical limbs: one
  addition's latency in a chain (K3's serial step).  The plain version
  takes torch_edwards.point_add (the same residues) and canonical_limbs20.

Each wrapper runs its kernel on a CUDA tensor and its plain version on a
CPU tensor; any other device raises.
"""

import random

import numpy as np
import torch

from . import _cuda
from . import fe_u32 as M
from . import torch_edwards as E
from . import torch_field as F
from .field import P

CHAIN_OPS = ("add", "mul", "shift", "madd")


def _step(op: str, a, b):
    if op == "add":
        return a + b
    if op == "mul":
        return a * b
    if op == "shift":
        return (a + 4096) >> 13
    return a * 3 + b


def chain_plain(x, op: str, n_steps: int):
    """Plain PyTorch version of probe_chain_<op>: the chain on int32
    tensors (torch's int32 addition and multiplication wrap)."""
    a, b = x, x + 1
    for _ in range(n_steps):
        a, b = b, _step(op, a, b)
    return b


def fmul_chain_plain(x, n_steps: int):
    """Plain PyTorch version of probe_fmul: n_steps torch_field.mul."""
    a, b = x, x + 1
    for _ in range(n_steps):
        a, b = b, F.mul(a, b)
    return b


def _launch(name: str, x, n_steps: int):
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    n_elems = x[0].numel() if name in ("probe_fmul", "probe_ge8") \
        else x.numel()
    if n_elems:
        _cuda.kernel(name).launch(x.device, x.data_ptr(), out.data_ptr(),
                                  n_elems, int(n_steps))
    return out


def chain(x, op: str, n_steps: int):
    """probe_chain_<op> wrapper: x (S, L) int32."""
    if op not in CHAIN_OPS:
        raise ValueError(f"op must be one of {CHAIN_OPS}: {op!r}")
    if x.dtype != torch.int32 or x.ndim != 2:
        raise ValueError(f"x must be (S, L) int32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if x.device.type == "cpu":
        return chain_plain(x, op, n_steps)
    return _launch(f"probe_chain-{op}", x, n_steps)


def fmul_chain(x, n_steps: int):
    """probe_fmul wrapper: x (20, S, L) int32."""
    if x.dtype != torch.int32 or x.ndim != 3 or x.shape[0] != F.NLIMBS:
        raise ValueError(f"x must be ({F.NLIMBS}, S, L) int32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return fmul_chain_plain(x, n_steps)
    return _launch("probe_fmul", x, n_steps)


# -- the self-test of fe25519_u32.cuh --------------------------------------

FE8_IN, FE8_OUT = 100, 132
FE8_EDGES = ([0, 1, 2, 19, 38, P - 1, P, P + 1, P + 18, 2**255 - 1, 2**255,
              2**255 + 18, 2 * P - 1, 2**256 - 1, 2**256 - 38, 2**256 - 39]
             + [2**256 - 19 * k for k in range(1, 5)])


def _limb_edges(rng):
    """limbs20 vectors at the bound: all ±8191, alternating, one limb at
    ±8191, the top limb alone, small negatives (−0 of the x = 0 points:
    all zero), and random ones."""
    out = [[8191] * 20, [-8191] * 20, [0] * 20, [-1] + [0] * 19,
           [0] * 19 + [-8191], [0] * 19 + [8191], [-8191] + [0] * 19,
           [8191 if i % 2 else -8191 for i in range(20)],
           [-8191 if i % 2 else 8191 for i in range(20)]]
    out += [[rng.choice((-8191, 8191, 0, 1, -1)) for _ in range(20)]
            for _ in range(8)]
    return out


def fe8_operands(n_random: int = 64, seed: int = 0xFE8) -> np.ndarray:
    """(rows, 100) int32 operand rows for `fe8_selftest`: every pair of
    FE8_EDGES as (a, b), then `n_random` random rows; limbs20 vectors at
    the bound cycle through the rows; the points p and q are random words
    (their residues need not be on the curve: the formula is algebra)."""
    rng = random.Random(seed)
    limbs = _limb_edges(rng)
    pairs = [(a, b) for a in FE8_EDGES for b in FE8_EDGES]
    pairs += [(rng.getrandbits(256), rng.getrandbits(256))
              for _ in range(n_random)]
    rows = []
    for i, (a, b) in enumerate(pairs):
        lim = limbs[i % len(limbs)] if i % 3 else [
            rng.randint(-8191, 8191) for _ in range(20)]
        pts = [rng.choice(FE8_EDGES) if rng.random() < 0.2
               else rng.getrandbits(256) for _ in range(8)]
        words = M.to_words(a) + M.to_words(b) + list(lim)
        for v in pts:
            words += M.to_words(v)
        rows.append(words)
    arr = np.array(rows, dtype=np.int64)
    return (arr & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def extreme_points(n: int, seed: int = 0xE4) -> np.ndarray:
    """(4, NLIMBS, n) int16 extended points whose limbs reach the bound
    |limb| = 8191 that fe8_from_limbs20 and the 20-limb arithmetic accept:
    random basepoint multiples scaled by λ (X, Y, Z, T all times λ: the
    same projective point) so that one coordinate, in turn, is the field
    element whose limbs are all +8191 or all −8191, held with those limbs
    (the limits K4 is held to on the card and in the CPU tests)."""
    from . import edwards, limbs
    from .scalar import L

    rng = random.Random(seed)
    out = np.zeros((4, limbs.NLIMBS, n), dtype=np.int16)
    for j in range(n):
        pt = edwards.basepoint_mul(rng.randrange(1, L))
        coord, sign = j % 4, 1 if j % 8 < 4 else -1
        ext = [sign * 8191] * limbs.NLIMBS
        c = (pt.X, pt.Y, pt.Z, pt.T)[coord] % P
        lam = limbs.limbs_to_int(ext) % P * pow(c, P - 2, P) % P
        for k, v in enumerate((pt.X, pt.Y, pt.Z, pt.T)):
            out[k, :, j] = ext if k == coord else limbs.int_to_limbs(
                v * lam % P)
    return out


def _row_plain(x):
    w = [int(v) & 0xFFFFFFFF for v in x]
    a, b = w[0:8], w[8:16]
    lim = [int(v) for v in x[16:36]]
    p = [w[36 + 8 * k:44 + 8 * k] for k in range(4)]
    q = [w[68 + 8 * k:76 + 8 * k] for k in range(4)]
    out = (M.fe8_add(a, b) + M.fe8_sub(a, b) + M.fe8_neg(a)
           + M.fe8_mul(a, b) + M.fe8_from_limbs20(lim)
           + M.fe8_to_limbs20_canonical(a))
    for neg in (False, True):
        for c in M.ge8_add(p, q, neg):
            out += c
    return out + M.fe8_sq(a)


def fe8_selftest_plain(x):
    """Plain version of probe_fe8: each row through ops/fe_u32.py."""
    rows = [_row_plain(r) for r in x.tolist()]
    arr = np.array(rows, dtype=np.int64).reshape(-1, FE8_OUT)
    return torch.from_numpy((arr & 0xFFFFFFFF).astype(np.uint32)
                            .view(np.int32))


def fe8_selftest(x):
    """probe_fe8 wrapper: x (n, 100) int32 → (n, 124) int32."""
    if x.dtype != torch.int32 or x.ndim != 2 or x.shape[1] != FE8_IN:
        raise ValueError(f"x must be (n, {FE8_IN}) int32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return fe8_selftest_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x = x.contiguous()
    out = torch.empty((x.shape[0], FE8_OUT), dtype=torch.int32,
                      device=x.device)
    if x.shape[0]:
        _cuda.kernel("probe_fe8").launch(x.device, x.data_ptr(),
                                         out.data_ptr(), x.shape[0], 0)
    return out


def ge8_chain_plain(x, n_steps: int):
    """Plain PyTorch version of probe_ge8: n_steps torch_edwards.point_add
    from a = b = x, then the canonical limbs of b."""
    S, L = x.shape[1:]
    a = b = x.reshape(4, F.NLIMBS, S, L)
    for _ in range(n_steps):
        a, b = b, E.point_add(a, b)
    return F.canonical_limbs20(b.movedim(1, 0)).movedim(0, 1) \
        .reshape(4 * F.NLIMBS, S, L)


def ge8_chain(x, n_steps: int):
    """probe_ge8 wrapper: x (80, S, L) int32 (X, Y, Z, T limbs)."""
    if x.dtype != torch.int32 or x.ndim != 3 or x.shape[0] != 4 * F.NLIMBS:
        raise ValueError(f"x must be ({4 * F.NLIMBS}, S, L) int32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return ge8_chain_plain(x, n_steps)
    return _launch("probe_ge8", x, n_steps)
