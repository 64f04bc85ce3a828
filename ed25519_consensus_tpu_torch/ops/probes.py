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

Each wrapper runs its kernel on a CUDA tensor and its plain version on a
CPU tensor; any other device raises.
"""

import torch

from . import _cuda
from . import torch_field as F

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
    n_elems = x[0].numel() if name == "probe_fmul" else x.numel()
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
