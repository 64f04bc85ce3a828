// K3 fold_partials: folds K2's per-chunk window partials over the chunk
// axis with complete additions, (B, nchunk, NWIN, 4, 20) PT ->
// (B, 4, 20, NWIN) int32 window sums.  Instantiations (C entry, NWIN, PT):
// fold_partials (33, int32), the default; fold_partials_i16fold (33,
// int16), the int16-fold variant's partials; fold_partials_r32 (27,
// int32), the radix-32 variant's.  K5 fold_shards (second entry point,
// below): folds the sharded mesh's gathered per-shard window sums.
//
// Replaces: the XLA fold of the Pallas kernel's per-block partials,
// ed25519_consensus_tpu/ops/pallas_msm.py:_compiled_pipeline (the
// point_add trees at pallas_msm.py:424-451; the int16 and 27-window forms
// are the same fold over those variants' outputs).  Plain PyTorch version:
// ops/msm.py fold_partials_plain, which takes the same additions in the
// same order, so the two agree limb for limb.
//
// This is a group fold, never an elementwise limb add: atomics do not apply.
//
// Bound: int32 multiply-adds, ~9.4e3 int32 operations per addition and
// nchunk - 1 additions per (b, w), against 320 (160 for int16) bytes read
// per partial.
// Design: one 32-thread block per (w, b).  Thread t < nchunk starts from
// partial t and adds partials t + 32, t + 64, ... in order; the
// min(nchunk, 32) live accumulators then meet in a 5-level halving tree
// through shared memory (thread t < s adds accumulator t + s when that one
// holds partials).  No addition starts from the identity, so the fold takes
// exactly nchunk - 1 additions; with nchunk = 0 it writes the identity.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"

namespace {

constexpr int NWIN = 33;
constexpr int COORDS = 4 * FE_NLIMBS;
constexpr int THREADS = 32;

template <typename T>
__device__ __forceinline__ ge load_point(const T* src) {
  ge p;
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) {
    p.X.v[i] = src[0 * FE_NLIMBS + i];
    p.Y.v[i] = src[1 * FE_NLIMBS + i];
    p.Z.v[i] = src[2 * FE_NLIMBS + i];
    p.T.v[i] = src[3 * FE_NLIMBS + i];
  }
  return p;
}

__device__ __forceinline__ void store_point_i32(int32_t* dst, const ge& p) {
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) {
    dst[0 * FE_NLIMBS + i] = p.X.v[i];
    dst[1 * FE_NLIMBS + i] = p.Y.v[i];
    dst[2 * FE_NLIMBS + i] = p.Z.v[i];
    dst[3 * FE_NLIMBS + i] = p.T.v[i];
  }
}

template <int NW, typename PT>
__device__ __forceinline__ void fold_partials_body(
    const PT* __restrict__ partials, int32_t* __restrict__ out, int nchunk) {
  __shared__ int32_t sh[THREADS * COORDS];
  const int w = blockIdx.x;
  const int b = blockIdx.y;
  const int t = threadIdx.x;

  const PT* src = partials + ((size_t)b * nchunk * NW + w) * COORDS;
  const size_t step = (size_t)NW * COORDS;  // one chunk
  ge acc = t < nchunk ? load_point(src + t * step) : ge_identity();
#pragma unroll 1
  for (int c = t + THREADS; c < nchunk; c += THREADS)
    acc = ge_add(acc, load_point(src + c * step));
  store_point_i32(sh + t * COORDS, acc);
  __syncthreads();
  // live: accumulators 0 .. live - 1 hold partials.
  int live = nchunk < THREADS ? nchunk : THREADS;
#pragma unroll 1
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (t < s && t + s < live) {
      acc = ge_add(acc, load_point(sh + (t + s) * COORDS));
      store_point_i32(sh + t * COORDS, acc);
    }
    if (live > s) live = s;
    __syncthreads();
  }
  if (t == 0) {
    // (B, 4, 20, NW): coordinate-limb major, window minor.
    int32_t* o = out + (size_t)b * COORDS * NW + w;
#pragma unroll
    for (int i = 0; i < FE_NLIMBS; ++i) {
      o[(0 * FE_NLIMBS + i) * NW] = acc.X.v[i];
      o[(1 * FE_NLIMBS + i) * NW] = acc.Y.v[i];
      o[(2 * FE_NLIMBS + i) * NW] = acc.Z.v[i];
      o[(3 * FE_NLIMBS + i) * NW] = acc.T.v[i];
    }
  }
}

// K5 fold_shards: the cross-shard group fold of the sharded mesh, gathered
// per-shard window sums (D, B, 4, 20, 33) int32 -> (B, 4, 20, 33) int32.
//
// Replaces: the all_gather + lax.scan fold of point_add in
// ed25519_consensus_tpu/parallel/sharded_msm.py
// (_compiled_sharded_kernel_many and its audit and cached forms, :139-145).
// Plain PyTorch version: ops/msm.py fold_shards_plain, the same additions in
// the same order.  The JAX fold starts from the identity (D additions); this
// one starts from shard 0 (D - 1), so the two agree as points, not limbs.
//
// A group fold, never an elementwise limb add.  Bound: int32 multiply-adds,
// (D - 1) complete additions per (b, w), against D * 320 bytes read per
// (b, w): a few microseconds of work at the mesh's shapes, so the launch
// dominates.  Design: one thread per (b, w), reading the gathered layout in
// place (coordinate-limb stride 33, shard stride B * 4 * 20 * 33): no
// transpose copy; consecutive threads take consecutive windows.
__global__ void __launch_bounds__(64)
fold_shards_kernel(const int32_t* __restrict__ gathered,
                   int32_t* __restrict__ out, int D, int B) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * NWIN) return;
  const int b = idx / NWIN;
  const int w = idx % NWIN;
  const size_t shard = (size_t)B * COORDS * NWIN;
  const int32_t* src = gathered + (size_t)b * COORDS * NWIN + w;
  ge acc = ge_identity();
#pragma unroll 1
  for (int d = 0; d < D; ++d) {
    ge p;
    const int32_t* s = src + d * shard;
#pragma unroll
    for (int i = 0; i < FE_NLIMBS; ++i) {
      p.X.v[i] = s[(0 * FE_NLIMBS + i) * NWIN];
      p.Y.v[i] = s[(1 * FE_NLIMBS + i) * NWIN];
      p.Z.v[i] = s[(2 * FE_NLIMBS + i) * NWIN];
      p.T.v[i] = s[(3 * FE_NLIMBS + i) * NWIN];
    }
    acc = d == 0 ? p : ge_add(acc, p);
  }
  int32_t* o = out + (size_t)b * COORDS * NWIN + w;
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) {
    o[(0 * FE_NLIMBS + i) * NWIN] = acc.X.v[i];
    o[(1 * FE_NLIMBS + i) * NWIN] = acc.Y.v[i];
    o[(2 * FE_NLIMBS + i) * NWIN] = acc.Z.v[i];
    o[(3 * FE_NLIMBS + i) * NWIN] = acc.T.v[i];
  }
}

}  // namespace

// One instantiation of K3: the kernel NAME_kernel (unmangled, so ptxas's
// report names it) and its C entry NAME_launch(partials, out, B, nchunk,
// stream).
#define FOLD_PARTIALS(NAME, NW, PT)                                           \
  extern "C" __global__ void __launch_bounds__(THREADS)                      \
      NAME##_kernel(const PT* __restrict__ partials,                          \
                    int32_t* __restrict__ out, int nchunk) {                  \
    fold_partials_body<NW, PT>(partials, out, nchunk);                        \
  }                                                                           \
  extern "C" int NAME##_launch(const void* partials, void* out, int B,        \
                               int nchunk, void* stream) {                    \
    dim3 grid(NW, B);                                                         \
    NAME##_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(                \
        (const PT*)partials, (int32_t*)out, nchunk);                          \
    return (int)cudaGetLastError();                                           \
  }

FOLD_PARTIALS(fold_partials, 33, int32_t)
FOLD_PARTIALS(fold_partials_i16fold, 33, int16_t)
FOLD_PARTIALS(fold_partials_r32, 27, int32_t)

extern "C" int fold_shards_launch(const void* gathered, void* out, int D,
                                  int B, void* stream) {
  const int threads = 64;
  const int blocks = (B * NWIN + threads - 1) / threads;
  fold_shards_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)gathered, (int32_t*)out, D, B);
  return (int)cudaGetLastError();
}
