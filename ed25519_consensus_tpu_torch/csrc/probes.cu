// Micro-probe kernels: how long one int32 operation and one field multiply
// take on this card, from the slope between two chain lengths.
//
// Replaces: the JAX package's micro-probes in tools/microbench_pallas.py,
// probe_chain (the pl.pallas_call at microbench_pallas.py:64) and
// probe_fmul (:101, a chain of pallas_msm._fmul_a).
// Plain PyTorch versions: ops/probes.py chain_plain and fmul_chain_plain.
//
//  * probe_chain_OP (OP = add, mul, shift, madd): one thread per element of
//    an (S, L) int32 tile, a = x, b = x + 1, then n_steps of
//    (a, b) <- (b, f(a, b)) with f = a + b, a * b, (a + 4096) >> 13 or
//    3a + b; out = b.  Additions and multiplies run on uint32_t, so their
//    wraparound is defined and equals the two's-complement wraparound of
//    the int32 arithmetic of JAX and torch; the shift is arithmetic on the
//    signed value, as the field's carry needs.  Every step depends on the
//    one before, so the slope is the latency of the operation, not its
//    throughput; an empty asm keeps each step's value opaque, so the
//    compiler cannot fold the chain.
//  * probe_fmul: one thread per element of a (20, S, L) tile (limb-major),
//    a chain of n_steps fe_mul (fe25519.cuh, the field multiply of every
//    kernel of the port but K2 and K2t) with the same (a, b) <- (b, a * b)
//    recurrence.
//  * probe_fe8: the self-test of fe25519_u32.cuh, the field arithmetic of
//    K1, K2, K2t and K3: one thread per row of operands runs fe8_add,
//    fe8_sub, fe8_neg, fe8_mul, both conversions, ge8_add (plain and with
//    the sign flag) and fe8_sq once each, so that chip_smoke.py can hold every output
//    against ops/fe_u32.py, the exact-integer model, word for word.  Each
//    operation sits in an out-of-line function of its own (extern "C", so
//    `cuobjdump -sass` names it) whose instructions chip_smoke.py counts
//    against the hand count of its operations.  Plain version:
//    ops/probes.py fe8_selftest_plain.
//  * probe_ge8: one thread per element of an (80, n) tile of points (X, Y,
//    Z, T limbs), a = b = the point, then n_steps of (a, b) <- (b, a + b)
//    by ge8_add, out = b's canonical limbs: one complete addition's
//    latency in a dependent chain, K3's serial step (its latency floor,
//    chip_smoke.py).  Plain version: ops/probes.py ge8_chain_plain (the
//    20-limb point_add, then canonical_limbs20).
//
// Bound: the launch.  A step is one int32 operation per element (a field
// multiply ~1.3e3), and the tile moves 8 (160) bytes per element.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "fe25519_u32.cuh"

namespace {

constexpr int THREADS = 128;

template <int OP>
__device__ __forceinline__ uint32_t step(uint32_t a, uint32_t b) {
  if constexpr (OP == 0) return a + b;
  if constexpr (OP == 1) return a * b;
  if constexpr (OP == 2) return (uint32_t)((int32_t)(a + 4096u) >> 13);
  return a * 3u + b;
}

template <int OP>
__device__ __forceinline__ void chain_body(const int32_t* __restrict__ x,
                                           int32_t* __restrict__ out,
                                           int n_elems, int n_steps) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_elems) return;
  uint32_t a = (uint32_t)x[i];
  uint32_t b = a + 1u;
#pragma unroll 16
  for (int s = 0; s < n_steps; ++s) {
    const uint32_t nb = step<OP>(a, b);
    a = b;
    b = nb;
    // opaque to the optimiser: without it the compiler proves the shift
    // chain constant after three steps and drops the loop
    asm volatile("" : "+r"(a), "+r"(b));
  }
  out[i] = (int32_t)b;
}

}  // namespace

#define PROBE_CHAIN(NAME, OP)                                                 \
  extern "C" __global__ void __launch_bounds__(THREADS)                      \
      NAME##_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, \
                    int n_elems, int n_steps) {                               \
    chain_body<OP>(x, out, n_elems, n_steps);                                 \
  }                                                                           \
  extern "C" int NAME##_launch(const void* x, void* out, int n_elems,         \
                               int n_steps, void* stream) {                   \
    const int blocks = (n_elems + THREADS - 1) / THREADS;                     \
    NAME##_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(              \
        (const int32_t*)x, (int32_t*)out, n_elems, n_steps);                  \
    return (int)cudaGetLastError();                                           \
  }

PROBE_CHAIN(probe_chain_add, 0)
PROBE_CHAIN(probe_chain_mul, 1)
PROBE_CHAIN(probe_chain_shift, 2)
PROBE_CHAIN(probe_chain_madd, 3)

// x, out: (20, n_elems) int32, limb k of element i at k * n_elems + i.
extern "C" __global__ void __launch_bounds__(THREADS)
    probe_fmul_kernel(const int32_t* __restrict__ x,
                      int32_t* __restrict__ out, int n_elems, int n_steps) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_elems) return;
  fe a, b;
#pragma unroll
  for (int k = 0; k < FE_NLIMBS; ++k) {
    a.v[k] = x[(size_t)k * n_elems + i];
    b.v[k] = a.v[k] + 1;
  }
#pragma unroll 1
  for (int s = 0; s < n_steps; ++s) {
    const fe nb = fe_mul(a, b);
    a = b;
    b = nb;
  }
#pragma unroll
  for (int k = 0; k < FE_NLIMBS; ++k) out[(size_t)k * n_elems + i] = b.v[k];
}

extern "C" int probe_fmul_launch(const void* x, void* out, int n_elems,
                                 int n_steps, void* stream) {
  const int blocks = (n_elems + THREADS - 1) / THREADS;
  probe_fmul_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, n_elems, n_steps);
  return (int)cudaGetLastError();
}

// probe_fe8: in (n, FE8_IN) int32 rows: a, b (8 words each), 20 limbs, the
// points p and q (32 words each: X, Y, Z, T).  out (n, FE8_OUT): a + b,
// a - b, -a, a * b, from_limbs20(limbs), the canonical limbs of a (20),
// p + q and p + (-q) (32 each), a^2.
#define FE8_IN 100
#define FE8_OUT 132

extern "C" __device__ __noinline__ fe8 st_fe8_add(fe8 a, fe8 b) {
  return fe8_add(a, b);
}
extern "C" __device__ __noinline__ fe8 st_fe8_sub(fe8 a, fe8 b) {
  return fe8_sub(a, b);
}
extern "C" __device__ __noinline__ fe8 st_fe8_neg(fe8 a) { return fe8_neg(a); }
extern "C" __device__ __noinline__ fe8 st_fe8_mul(fe8 a, fe8 b) {
  return fe8_mul(a, b);
}
extern "C" __device__ __noinline__ fe8 st_fe8_from_limbs20(const int32_t* l) {
  return fe8_from_limbs20(l, (size_t)1);
}
extern "C" __device__ __noinline__ void st_fe8_to_limbs20_canonical(
    fe8 a, int32_t* out) {
  fe8_to_limbs20_canonical(a, out);
}
extern "C" __device__ __noinline__ ge8 st_ge8_add(ge8 p, ge8 q, bool neg) {
  return ge8_add(p, q, neg);
}
extern "C" __device__ __noinline__ fe8 st_fe8_sq(fe8 a) { return fe8_sq(a); }

__device__ __forceinline__ fe8 ld8(const int32_t* x) {
  fe8 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = (uint32_t)x[i];
  return r;
}

__device__ __forceinline__ void st8(int32_t* o, const fe8& x) {
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = (int32_t)x.v[i];
}

extern "C" __global__ void __launch_bounds__(THREADS)
    probe_fe8_kernel(const int32_t* __restrict__ in,
                     int32_t* __restrict__ out, int n, int unused) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int32_t* x = in + (size_t)i * FE8_IN;
  int32_t* o = out + (size_t)i * FE8_OUT;
  const fe8 a = ld8(x), b = ld8(x + 8);
  st8(o, st_fe8_add(a, b));
  st8(o + 8, st_fe8_sub(a, b));
  st8(o + 16, st_fe8_neg(a));
  st8(o + 24, st_fe8_mul(a, b));
  int32_t limbs[20];
#pragma unroll
  for (int k = 0; k < 20; ++k) limbs[k] = x[16 + k];
  st8(o + 32, st_fe8_from_limbs20(limbs));
  int32_t canon[20];
  st_fe8_to_limbs20_canonical(a, canon);
#pragma unroll
  for (int k = 0; k < 20; ++k) o[40 + k] = canon[k];
  ge8 p, q;
  p.X = ld8(x + 36);
  p.Y = ld8(x + 44);
  p.Z = ld8(x + 52);
  p.T = ld8(x + 60);
  q.X = ld8(x + 68);
  q.Y = ld8(x + 76);
  q.Z = ld8(x + 84);
  q.T = ld8(x + 92);
#pragma unroll 1
  for (int k = 0; k < 2; ++k) {
    const ge8 r = st_ge8_add(p, q, k == 1);
    int32_t* ok = o + 60 + 32 * k;
    st8(ok, r.X);
    st8(ok + 8, r.Y);
    st8(ok + 16, r.Z);
    st8(ok + 24, r.T);
  }
  st8(o + 124, st_fe8_sq(a));
}

extern "C" int probe_fe8_launch(const void* in, void* out, int n, int unused,
                                void* stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  probe_fe8_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)in, (int32_t*)out, n, unused);
  return (int)cudaGetLastError();
}

// probe_ge8: x, out (80, n_elems) int32, limb k of element i at
// k * n_elems + i.
extern "C" __global__ void __launch_bounds__(THREADS)
    probe_ge8_kernel(const int32_t* __restrict__ x,
                     int32_t* __restrict__ out, int n_elems, int n_steps) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_elems) return;
  const int32_t* xi = x + i;
  const size_t n = (size_t)n_elems;
  ge8 a;
  a.X = fe8_from_limbs20(xi, n);
  a.Y = fe8_from_limbs20(xi + 20 * n, n);
  a.Z = fe8_from_limbs20(xi + 40 * n, n);
  a.T = fe8_from_limbs20(xi + 60 * n, n);
  ge8 b = a;
#pragma unroll 1
  for (int s = 0; s < n_steps; ++s) {
    const ge8 nb = ge8_add(a, b);
    a = b;
    b = nb;
  }
  auto put = [&](int k, const fe8& c) {
    int32_t l[20];
    fe8_to_limbs20_canonical(c, l);
#pragma unroll
    for (int j = 0; j < 20; ++j) out[(size_t)(20 * k + j) * n + i] = l[j];
  };
  put(0, b.X);
  put(1, b.Y);
  put(2, b.Z);
  put(3, b.T);
}

extern "C" int probe_ge8_launch(const void* x, void* out, int n_elems,
                                int n_steps, void* stream) {
  const int blocks = (n_elems + THREADS - 1) / THREADS;
  probe_ge8_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x, (int32_t*)out, n_elems, n_steps);
  return (int)cudaGetLastError();
}
