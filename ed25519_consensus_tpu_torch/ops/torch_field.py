"""GF(2^255 - 19) arithmetic on int32 limb tensors, plain PyTorch.

The plain-version field of the port: every CUDA kernel's arithmetic
(csrc/fe25519.cuh) is this module's, op for op, and the CPU tests hold it
limb for limb against the JAX package's `ops/jnp_field.py`.

Elements are (NLIMBS, ...) int32 tensors of radix-2^13 limbs (limbs.py);
every op works on whole tensors over the trailing batch axes.

**Balanced signed limbs.**  The working representation allows any limb in
[-8191, 8191]; ops emit limbs in roughly [-4096, 4096+fold] (carrying uses
the BALANCED digit split c = (x + 4096) >> 13, r = x - c·2^13, so
|r| ≤ 4096).  Freshly packed host values (limbs in [0, 2^13)) satisfy the
same uniform bound

    U:  |limb_i| ≤ 8191,

and every op maps U inputs to U outputs (closure proofs below).  The int16
storage of points and tables is exact only inside U.

The split needs an ARITHMETIC right shift of negative int32: `>>` on a
torch int32 tensor is one (tests/test_torch_field.py pins it), as `>>` on a
CUDA `int` is.

**Parallel carries.**  Every limb emits a carry simultaneously; carries
shift up one limb; the top escape folds into limb 0 with weight
2^260 ≡ 608 mod p (valid for either sign since 2^260 - 608 = 32p).  The
step counts are part of the closure proofs — none may be dropped:

* add/sub: |x| ≤ 2·8191; one step → |r| ≤ 4096, carries ≤ 2, escape fold
  ≤ 2·608 ⇒ |out| ≤ 4096 + 2 + 1216 = 5314 ⊂ U.
* mul_small (k ≤ 4): |x| ≤ 4·8191; one step ⇒ |out| ≤ 4096 + 4 + 4·608 =
  6532 ⊂ U.
* mul: schoolbook columns |col_k| ≤ 20·8191² < 1.35e9 < 2^31 (int32 safe).
  Two wide steps bound the 41 columns to ≤ 4096 + 9.  Folding columns
  20..39 into 0..19 (weight 608·2^(13(k-20))) and the wide escape column
  40 (|·| ≤ ~20) into column 0 with weight 608² gives |low| < 1.0e7;
  five more relaxation steps shrink the limb-0 escape chain
  1.0e7 → 7.4e5 → 5.9e4 → 8.4e3 → 4.7e3 ⊂ U.

Values are CONGRUENT mod p, not canonical; canonicalization happens on the
host after unpacking (limbs.py), where all consensus decisions live.
"""

import torch

from .limbs import FOLD, LIMB_BITS, NLIMBS

_HALF = 1 << (LIMB_BITS - 1)  # 4096: balanced-digit rounding offset
_RADIX = 1 << LIMB_BITS


def _carry_step(x, fold_escape: bool):
    """One parallel carry relaxation step over the leading limb axis.
    Every limb splits into a balanced residue and a carry; carries shift up
    one limb; if `fold_escape`, the top carry folds into limb 0 (·608),
    otherwise the top carry is dropped (the caller's top limb is zero and
    stays small enough never to emit one)."""
    c = (x + _HALF) >> LIMB_BITS
    r = x - c * _RADIX
    if fold_escape:
        shifted = torch.cat([c[-1:] * FOLD, c[:-1]], dim=0)
    else:
        shifted = torch.cat([torch.zeros_like(c[:1]), c[:-1]], dim=0)
    return r + shifted


def carry(x, steps: int):
    """`steps` parallel carry steps with mod-p escape folding; see module
    docstring for per-op step counts and bounds."""
    for _ in range(steps):
        x = _carry_step(x, fold_escape=True)
    return x


def add(a, b):
    """a + b (mod p) in U.  One carry step."""
    return carry(a + b, steps=1)


def sub(a, b):
    """a - b (mod p) in U.  Balanced signed limbs make subtraction
    symmetric with addition — no borrow special-casing."""
    return carry(a - b, steps=1)


def mul(a, b):
    """a · b (mod p) in U.

    wide[k] = Σ_{i+j=k} a_i·b_j via one outer product and the skew trick:
    pad the j-axis of the (20, 20, ...) outer product to 40, flatten (i, j)
    and re-slice as (20, 39, ...) — row i lands shifted by i, so summing
    over rows yields the 39 anti-diagonal column sums."""
    trailing = a.shape[1:]
    outer = a[:, None] * b[None, :]  # (20, 20, ...)
    padded = torch.cat([outer, torch.zeros_like(outer)], dim=1)
    flat = padded.reshape((NLIMBS * 2 * NLIMBS,) + trailing)
    skew = flat[: NLIMBS * (2 * NLIMBS - 1)].reshape(
        (NLIMBS, 2 * NLIMBS - 1) + trailing)
    wide = skew.sum(dim=0, dtype=torch.int32)  # (39, ...)
    # two zero columns absorb the wide-phase carries (no fold needed yet)
    wide = torch.cat([wide, torch.zeros_like(wide[:2])], dim=0)  # (41, ...)
    wide = _carry_step(wide, fold_escape=False)
    wide = _carry_step(wide, fold_escape=False)
    # Fold columns 20..39 into 0..19 (weight 2^(13k) ≡ 608·2^(13(k-20)))
    # and column 40 — the wide-carry escape — into column 0 with weight
    # 2^520 ≡ 608² (mod p).
    low = wide[:NLIMBS] + wide[NLIMBS: 2 * NLIMBS] * FOLD
    low = torch.cat([low[:1] + wide[2 * NLIMBS:] * (FOLD * FOLD), low[1:]])
    return carry(low, steps=5)


def mul_small(a, k: int):
    """a · k for constant 2 ≤ k ≤ 4; one carry step."""
    if not 2 <= k <= 4:
        raise ValueError("mul_small supports 2 ≤ k ≤ 4")
    return carry(a * k, steps=1)


def select(mask, a, b):
    """Elementwise where over limb tensors; `mask` broadcasts against the
    batch axes (limb axis prepended automatically)."""
    return torch.where(mask[None, ...], a, b)


def const(value_limbs, shape, device):
    """A (NLIMBS, *shape) int32 tensor holding one constant element."""
    t = torch.tensor([int(v) for v in value_limbs], dtype=torch.int32,
                     device=device)
    return t.reshape((NLIMBS,) + (1,) * len(shape)).expand(
        (NLIMBS,) + tuple(shape))
