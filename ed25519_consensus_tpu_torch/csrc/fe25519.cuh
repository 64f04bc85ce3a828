// GF(2^255 - 19) and complete Edwards25519 addition on 20 x 13-bit balanced
// int32 limbs, as __device__ functions: the arithmetic of K5 (fold_shards),
// K6 (expand_affine.cu), the lab's window-sum forms and the 20-limb K1, K3
// and K4 the lab keeps as expand_compressed-l20, fold_partials-l20 and
// build_tables-l20 (with build_tables-r32).  K1, K2, K2t, K3 and K4 run on
// fe25519_u32.cuh.
//
// This is ops/torch_field.py and ops/torch_edwards.py op for op (which are
// in turn the JAX package's ops/jnp_field.py and ops/jnp_edwards.py), so a
// kernel built on it agrees with its plain PyTorch version limb for limb.
// The closure proofs in torch_field.py's docstring hold only for this carry
// schedule: 1 step for add / sub / mul_small; 2 wide steps, the 608 and 608^2
// folds and 5 low steps for mul.  Do not drop a step "because it looks
// redundant": the int16 stores of points and tables are exact only inside
// the bound |limb| <= 8191 that the schedule keeps.
//
// Integer-only: no float type appears on the device path.
//
// Where trouble is likely:
//  * The balanced carry (x + 4096) >> 13 needs an ARITHMETIC shift of
//    negative int32.  nvcc implements >> on a signed int as an arithmetic
//    shift (SHF.R.S32); torch does the same on int32 tensors, and a CPU test
//    pins the torch side.  The residue is x - c * 8192 (a multiply, not
//    c << 13: left-shifting a negative int is undefined before C++20).
//  * Schoolbook columns reach 20 * 8191^2 = 1.342e9 < 2^31: int32 is exact
//    only for inputs inside the bound above.
//  * Register pressure: an element is 20 int32, a product 41 columns, and a
//    complete addition keeps about 8 elements live.  fe_mul is out of line
//    so its 41 columns are live only inside it.  `-Xptxas -v` reports
//    218-253 registers a thread and no spills for sm_90a (PERF.md); a
//    change here that adds live state should be checked for spills there.
#pragma once
#include <stdint.h>

#define FE_NLIMBS 20
#define FE_WIDE 41

struct fe {
  int32_t v[FE_NLIMBS];
};

struct ge {
  fe X, Y, Z, T;
};

// int_to_limbs(2d mod p), int_to_limbs(d mod p), int_to_limbs(sqrt(-1) mod p)
__device__ __constant__ int32_t FE_D2[FE_NLIMBS] = {
    4441, 5527, 1289, 3383, 3773, 6315, 2574, 4944, 20,   7,
    5196, 7655, 3886, 1856, 7270, 8092, 5855, 3810, 438,  72};
__device__ __constant__ int32_t FE_D[FE_NLIMBS] = {
    6307, 6859, 4740, 5787, 5982, 3157, 1287, 2472, 4106, 3,
    6694, 3827, 1943, 928,  3635, 8142, 2927, 1905, 219,  164};
__device__ __constant__ int32_t FE_SQRTM1[FE_NLIMBS] = {
    176,  4213, 2514, 7222, 3150, 4668, 5311, 213,  792,  6522,
    5609, 7159, 2451, 1664, 3245, 7137, 4033, 1026, 201,  87};

// One parallel carry step over n limbs with the top carry folded into limb 0
// with weight 2^260 = 608 (mod p).
__device__ __forceinline__ void fe_carry_fold(int32_t* x) {
  int32_t c[FE_NLIMBS];
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) {
    c[i] = (x[i] + 4096) >> 13;
    x[i] -= c[i] * 8192;
  }
  x[0] += c[FE_NLIMBS - 1] * 608;
#pragma unroll
  for (int i = 1; i < FE_NLIMBS; ++i) x[i] += c[i - 1];
}

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) r.v[i] = a.v[i] + b.v[i];
  fe_carry_fold(r.v);
  return r;
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  fe r;
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) r.v[i] = a.v[i] - b.v[i];
  fe_carry_fold(r.v);
  return r;
}

__device__ __forceinline__ fe fe_mul_small(const fe& a, int32_t k) {
  fe r;
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) r.v[i] = a.v[i] * k;
  fe_carry_fold(r.v);
  return r;
}

__device__ __forceinline__ fe fe_neg(const fe& a) {
  fe r;
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) r.v[i] = -a.v[i];
  return r;
}

// The carry tail of fe_mul / fe_sq over the 41 product columns.
__device__ __forceinline__ fe fe_reduce_wide(int32_t* w) {
  // Two wide carry steps with no fold: the top carry of column 40 is
  // dropped, exactly as the plain version drops it.
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    int32_t c[FE_WIDE];
#pragma unroll
    for (int k = 0; k < FE_WIDE; ++k) {
      c[k] = (w[k] + 4096) >> 13;
      w[k] -= c[k] * 8192;
    }
#pragma unroll
    for (int k = FE_WIDE - 1; k > 0; --k) w[k] += c[k - 1];
  }
  fe r;
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) r.v[i] = w[i] + w[FE_NLIMBS + i] * 608;
  r.v[0] += w[2 * FE_NLIMBS] * (608 * 608);
#pragma unroll
  for (int s = 0; s < 5; ++s) fe_carry_fold(r.v);
  return r;
}

// Out of line: one copy of the 400-product body per kernel keeps the code
// inside the instruction cache; arguments pass by value.
__device__ __noinline__ fe fe_mul(fe a, fe b) {
  int32_t w[FE_WIDE];
#pragma unroll
  for (int k = 0; k < FE_WIDE; ++k) w[k] = 0;
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) {
#pragma unroll
    for (int j = 0; j < FE_NLIMBS; ++j) w[i + j] += a.v[i] * b.v[j];
  }
  return fe_reduce_wide(w);
}

// a * a in 210 products (20 squares, 190 doubled cross products) instead of
// 400.  The columns are the same integers as fe_mul(a, a)'s, and each
// partial sum is bounded by the same column bound, so the limbs are
// identical: the plain version's torch_field.mul(a, a) stays its twin.
__device__ __noinline__ fe fe_sq(fe a) {
  int32_t w[FE_WIDE];
  int32_t a2[FE_NLIMBS - 1];
#pragma unroll
  for (int k = 0; k < FE_WIDE; ++k) w[k] = 0;
#pragma unroll
  for (int i = 0; i < FE_NLIMBS - 1; ++i) a2[i] = a.v[i] + a.v[i];
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) {
    w[2 * i] += a.v[i] * a.v[i];
#pragma unroll
    for (int j = i + 1; j < FE_NLIMBS; ++j) w[i + j] += a2[i] * a.v[j];
  }
  return fe_reduce_wide(w);
}

__device__ __forceinline__ fe fe_const(const int32_t* c) {
  fe r;
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) r.v[i] = c[i];
  return r;
}

__device__ __forceinline__ fe fe_small(int32_t v0) {
  fe r;
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) r.v[i] = 0;
  r.v[0] = v0;
  return r;
}

__device__ __forceinline__ ge ge_identity() {
  ge r;
  r.X = fe_small(0);
  r.Y = fe_small(1);
  r.Z = fe_small(1);
  r.T = fe_small(0);
  return r;
}

// Complete unified addition (add-2008-hwcd-3, a = -1, k = 2d), the field-op
// sequence of torch_edwards.point_add.
__device__ __forceinline__ ge ge_add(const ge& p, const ge& q) {
  fe A = fe_mul(fe_sub(p.Y, p.X), fe_sub(q.Y, q.X));
  fe B = fe_mul(fe_add(p.Y, p.X), fe_add(q.Y, q.X));
  fe C = fe_mul(fe_mul(p.T, fe_const(FE_D2)), q.T);
  fe D = fe_mul_small(fe_mul(p.Z, q.Z), 2);
  fe E = fe_sub(B, A);
  fe F = fe_sub(D, C);
  fe G = fe_add(D, C);
  fe H = fe_add(B, A);
  ge r;
  r.X = fe_mul(E, F);
  r.Y = fe_mul(G, H);
  r.Z = fe_mul(F, G);
  r.T = fe_mul(E, H);
  return r;
}
