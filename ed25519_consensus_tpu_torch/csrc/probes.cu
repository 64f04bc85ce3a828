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
//    a chain of n_steps fe_mul (fe25519.cuh, the field multiply every kernel
//    of the port uses) with the same (a, b) <- (b, a * b) recurrence.
//
// Bound: the launch.  A step is one int32 operation per element (a field
// multiply ~1.3e3), and the tile moves 8 (160) bytes per element.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"

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
