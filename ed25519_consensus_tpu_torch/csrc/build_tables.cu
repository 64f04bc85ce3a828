// K4 build_tables: the [0..8]P multiples tables of a batch of extended
// points.  points (B, 4, 20, N) int16 → tables (B, 9, 4, 20, N) int16 with
// entry 0 the identity and entry k = entry (k-1) + P by complete addition
// (so entry 1 is identity + P, limb for limb what the reference computes).
//
// Replaces: ed25519_consensus_tpu/ops/msm.py:table_scan (the XLA scan inside
// assemble_tables_operands, msm.py:626-647, which builds the R lanes' tables
// of the resident-tables dispatch) and _compiled_table_builder /
// build_multiples_tables (msm.py:597-623).  Plain PyTorch version: ops/msm.py
// build_tables_plain, the same additions in the same order, so kernel and
// plain version agree limb for limb — and both equal the reference's
// build_multiples_tables byte for byte (the field follows jnp_field's carry
// schedule step for step, and the reference's int32 carry between scan
// steps lies inside |limb| <= 8191, so its int16 cast is exact).
//
// Bound: int32 operations, 8 complete additions per lane (~9.4e3 int32
// operations each) against 160 bytes read and 1,440 written per lane.
//
// Design: one thread per lane, everything in registers (the point and the
// running entry, 160 int32), entries stored as they are produced.  Lanes
// are the fastest axis of every plane, so a warp's loads and stores are
// coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int NTBL = 9;
constexpr int COORDS = 4 * FE_NLIMBS;

__device__ __forceinline__ void store_point_i16(int16_t* dst, size_t stride,
                                                const ge& p) {
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) {
    dst[(0 * FE_NLIMBS + i) * stride] = (int16_t)p.X.v[i];
    dst[(1 * FE_NLIMBS + i) * stride] = (int16_t)p.Y.v[i];
    dst[(2 * FE_NLIMBS + i) * stride] = (int16_t)p.Z.v[i];
    dst[(3 * FE_NLIMBS + i) * stride] = (int16_t)p.T.v[i];
  }
}

__global__ void __launch_bounds__(THREADS)
build_tables_kernel(const int16_t* __restrict__ points,
                    int16_t* __restrict__ tables, int N) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (n >= N) return;
  const int16_t* src = points + (size_t)b * COORDS * N + n;
  ge P;
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) {
    P.X.v[i] = src[(size_t)(0 * FE_NLIMBS + i) * N];
    P.Y.v[i] = src[(size_t)(1 * FE_NLIMBS + i) * N];
    P.Z.v[i] = src[(size_t)(2 * FE_NLIMBS + i) * N];
    P.T.v[i] = src[(size_t)(3 * FE_NLIMBS + i) * N];
  }
  int16_t* dst = tables + (size_t)b * NTBL * COORDS * N + n;
  ge cur = ge_identity();
  store_point_i16(dst, (size_t)N, cur);
#pragma unroll 1
  for (int e = 1; e < NTBL; ++e) {
    cur = ge_add(cur, P);
    store_point_i16(dst + (size_t)e * COORDS * N, (size_t)N, cur);
  }
}

}  // namespace

extern "C" int build_tables_launch(const void* points, void* tables, int B,
                                   int N, void* stream) {
  dim3 grid((N + THREADS - 1) / THREADS, B);
  build_tables_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int16_t*)points, (int16_t*)tables, N);
  return (int)cudaGetLastError();
}
