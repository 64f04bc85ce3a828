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


def canonical_limbs20(x):
    """The canonical residue of every element of x ((NLIMBS, ...) int32
    limbs in U) in [0, p), as NLIMBS balanced 13-bit limbs: limbs 0..18 in
    [-4096, 4095], limb 19 in [0, 256].  The representation is unique, so
    any two limb vectors of one residue give the same limbs: the plain
    versions of K2 and K2t (csrc/window_sums_u32.cuh), which write these
    limbs through fe8_to_limbs20_canonical, end with this.

    Exact in int64: floor carries bring limbs 0..18 into [0, 2^13); the
    bits from 255 up (limb 19 >> 8) fold back as 19 each (2^255 ≡ 19);
    three rounds of carry and fold take any value in U (|V| < 2^260) into
    [0, 2^255); then x ≥ p exactly when x + 19 reaches 2^255, and the
    balanced split c = (u + 4096) >> 13 runs serially from limb 0."""
    v = list(x.to(torch.int64).unbind(0))
    top = NLIMBS - 1

    def carry_floor(v):
        for i in range(top):
            c = v[i] >> LIMB_BITS
            v[i] = v[i] - c * _RADIX
            v[i + 1] = v[i + 1] + c
        return v

    for _ in range(3):
        v = carry_floor(v)
        q = v[top] >> 8
        v[top] = v[top] - q * 256
        v[0] = v[0] + 19 * q
    v = carry_floor(v)
    t = carry_floor([v[0] + 19] + v[1:])
    ge = t[top] >= 256
    t[top] = t[top] - 256
    v = [torch.where(ge, a, b) for a, b in zip(t, v)]
    for i in range(top):
        c = (v[i] + _HALF) >> LIMB_BITS
        v[i] = v[i] - c * _RADIX
        v[i + 1] = v[i + 1] + c
    return torch.stack(v).to(torch.int32)
