// K3 fold_partials: folds K2's per-chunk window partials over the chunk
// axis with complete additions, (B, nchunk, NWIN, 4, 20) PT ->
// (B, 4, 20, NWIN) int32 window sums with canonical limbs.  Instantiations
// (C entry, NWIN, PT): fold_partials (33, int32), the default;
// fold_partials_i16fold (33, int16), the int16-fold variant's partials;
// fold_partials_r32 (27, int32), the radix-32 variant's; all three on
// csrc/fe25519_u32.cuh.  fold_partials_l20 (33, int32) is K3's earlier
// 20-limb body (the lab's fold_partials-l20; no verdict path launches it).
// K5 fold_shards (below, on K3's warp tree) folds the sharded mesh's
// per-shard window sums; fold_shards_l20 is its earlier 20-limb body.
//
// Replaces: the XLA fold of the Pallas kernel's per-block partials,
// ed25519_consensus_tpu/ops/pallas_msm.py:_compiled_pipeline (the
// point_add trees at pallas_msm.py:424-451; the int16 and 27-window forms
// are the same fold over those variants' outputs).  Plain PyTorch version:
// ops/msm.py fold_partials_plain, which takes the same additions in the
// same order (ge8_add and the 20-limb point_add take the same field-op
// sequence, so the same residues) and ends with canonical_limbs20, so the
// two agree limb for limb; ops/fe_u32.py fold_lane models one (b, w).
//
// This is a group fold, never an elementwise limb add: atomics do not apply.
//
// Every partial of the three instantiations lies in fe8_from_limbs20's
// bound |limb| <= 8191: K2 and K2t write canonical limbs (|limb| <= 4096),
// and the lab's 20-limb forms, whose partials the i16fold and r32 entries
// fold, keep every limb in U = [-8191, 8191] (the closure proofs of
// ops/torch_field.py: an addition's coordinates are products, |limb| <=
// 4.7e3; a partial that is one selected entry is a K1 point or a table
// entry, inside U, negated or not).
//
// Bound: bytes, 320 (160 for int16) read a partial and 320 written a
// window sum; its latency floor is the serial additions on one thread's
// path (its partials, then log2 of the threads' tree) times one addition's
// latency (chip_smoke.py).  Design: one block of FOLD_THREADS = 128 per
// (w, b), so each thread holds one or two partials at the main path's
// nchunk (159 at N = 10,176, 192 at N = 12,288).  Rounds of 128 partial
// rows are staged through shared memory with 16-byte loads, consecutive
// threads on consecutive 16 bytes of a 320-byte row (rows padded by 16
// bytes, so a thread's 16-byte reads of its own row hit no bank twice in a
// quarter warp); thread t converts row t once (fe8_from_limbs20) and adds
// it to its accumulator: partials t, t + 128, ... in order.  The
// accumulators then meet in a halving tree in each warp (__shfl_down_sync
// of the 32 words; lane l < s adds lane l + s when that one holds
// partials), and the four warps' sums in one more in warp 0, through
// shared memory.  No addition starts from the identity, so the fold takes
// exactly nchunk - 1 additions; with nchunk = 0 it writes the identity.
//
// fold_partials_l20: one 32-thread block per (w, b); thread t < nchunk
// starts from partial t and adds t + 32, t + 64, ...; a 5-level halving
// tree through shared memory; the limbs as the additions leave them.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "fe25519_u32.cuh"

namespace {

constexpr int NWIN = 33;
constexpr int COORDS = 4 * FE_NLIMBS;

constexpr int FOLD_THREADS = 128;  // ops/msm.py FOLD_THREADS

// Word k of a 16-byte vector.
__device__ __forceinline__ uint32_t u4_word(const uint4& q, int k) {
  return k == 0 ? q.x : k == 1 ? q.y : k == 2 ? q.z : q.w;
}

// Coordinate k of a staged partial row (X, Y, Z, T limbs of type PT) in
// the 8 x 32-bit words: an int32 row's coordinate as five 16-byte reads.
template <typename PT>
__device__ __forceinline__ fe8 stage_coord(const uint4* row, int k) {
  if constexpr (sizeof(PT) == 4) {
    uint4 q[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) q[j] = row[5 * k + j];
    return fe8_from_limbs20_f(
        [&](int i) { return (int32_t)u4_word(q[i >> 2], i & 3); });
  } else {
    const int16_t* l = reinterpret_cast<const int16_t*>(row) + 20 * k;
    return fe8_from_limbs20_f([&](int i) { return (int32_t)l[i]; });
  }
}

template <typename PT>
__device__ __forceinline__ ge8 stage_point(const uint4* row) {
  ge8 p;
  p.X = stage_coord<PT>(row, 0);
  p.Y = stage_coord<PT>(row, 1);
  p.Z = stage_coord<PT>(row, 2);
  p.T = stage_coord<PT>(row, 3);
  return p;
}

// Coordinate a's canonical limbs into a window-sum column (stride NW).
template <int NW>
__device__ __forceinline__ void store_coord(int32_t* o, const fe8& a) {
  int32_t l[FE_NLIMBS];
  fe8_to_limbs20_canonical(a, l);
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) o[(size_t)i * NW] = l[i];
}

__device__ __forceinline__ ge8 shfl_down_ge8(const ge8& p, int s) {
  ge8 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    r.X.v[i] = __shfl_down_sync(0xffffffffu, p.X.v[i], s);
    r.Y.v[i] = __shfl_down_sync(0xffffffffu, p.Y.v[i], s);
    r.Z.v[i] = __shfl_down_sync(0xffffffffu, p.Z.v[i], s);
    r.T.v[i] = __shfl_down_sync(0xffffffffu, p.T.v[i], s);
  }
  return r;
}

// The halving tree of one warp, every lane calling: lanes 0 .. live - 1
// hold values; at s = 16, 8, 4, 2, 1 lane l < s adds lane l + s's value
// when l + s < live, then live = min(live, s).  The sum is lane 0's.
__device__ __forceinline__ ge8 warp_fold(ge8 acc, int lane, int live) {
#pragma unroll 1
  for (int s = 16; s > 0; s >>= 1) {
    const ge8 o = shfl_down_ge8(acc, s);
    if (lane < s && lane + s < live) acc = ge8_add(acc, o);
    if (live > s) live = s;
  }
  return acc;
}

template <int NW, typename PT>
__device__ __forceinline__ void fold_partials_body(
    const PT* __restrict__ partials, int32_t* __restrict__ out, int nchunk) {
  constexpr int VEC = 4 * FE_NLIMBS * (int)sizeof(PT) / 16;  // 20 or 10
  constexpr int STRIDE = VEC + 1;  // a staged row, padded by 16 bytes
  __shared__ uint4 stage[FOLD_THREADS * STRIDE];
  const int w = blockIdx.x;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  const uint4* src = reinterpret_cast<const uint4*>(
      partials + ((size_t)b * nchunk * NW + w) * COORDS);
  const size_t step = (size_t)NW * VEC;  // one chunk, in 16-byte vectors
  ge8 acc = ge8_identity();
#pragma unroll 1
  for (int c0 = 0; c0 < nchunk; c0 += FOLD_THREADS) {
    const int rows = min(FOLD_THREADS, nchunk - c0);
    if (c0) __syncthreads();  // the last round's rows are read
#pragma unroll 1
    for (int v = t; v < rows * VEC; v += FOLD_THREADS) {
      const int r = v / VEC;
      const int k = v - r * VEC;
      stage[r * STRIDE + k] = __ldg(src + (size_t)(c0 + r) * step + k);
    }
    __syncthreads();
    if (t < rows) {
      const ge8 p = stage_point<PT>(stage + t * STRIDE);
      acc = c0 ? ge8_add(acc, p) : p;
    }
  }
  const int held = min(nchunk, FOLD_THREADS);
  acc = warp_fold(acc, lane, min(max(held - 32 * warp, 0), 32));
  __syncthreads();  // the stage is free: it takes the warps' sums
  ge8* sums = reinterpret_cast<ge8*>(stage);
  if (lane == 0 && 32 * warp < held) sums[warp] = acc;
  __syncthreads();
  if (warp) return;
  const int live = (held + 31) / 32;
  acc = warp_fold(lane < live ? sums[lane] : ge8_identity(), lane, live);
  if (lane) return;
  // (B, 4, 20, NW): coordinate-limb major, window minor.
  int32_t* o = out + (size_t)b * COORDS * NW + w;
  store_coord<NW>(o, acc.X);
  store_coord<NW>(o + (size_t)FE_NLIMBS * NW, acc.Y);
  store_coord<NW>(o + (size_t)2 * FE_NLIMBS * NW, acc.Z);
  store_coord<NW>(o + (size_t)3 * FE_NLIMBS * NW, acc.T);
}

// -- the 20-limb K3 (the lab's fold_partials-l20) ---------------------------

constexpr int THREADS_L20 = 32;

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
__device__ __forceinline__ void fold_partials_l20_body(
    const PT* __restrict__ partials, int32_t* __restrict__ out, int nchunk) {
  constexpr int THREADS = THREADS_L20;
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

}  // namespace

// One instantiation of K3: the kernel NAME_kernel (unmangled, so ptxas's
// report names it) and its C entry NAME_launch(partials, out, B, nchunk,
// stream); BODY fold_partials_body (FOLD_THREADS a block) or
// fold_partials_l20_body (THREADS_L20).
#define FOLD_PARTIALS(NAME, NW, PT, BODY, NT)                                 \
  extern "C" __global__ void __launch_bounds__(NT)                           \
      NAME##_kernel(const PT* __restrict__ partials,                          \
                    int32_t* __restrict__ out, int nchunk) {                  \
    BODY<NW, PT>(partials, out, nchunk);                                      \
  }                                                                           \
  extern "C" int NAME##_launch(const void* partials, void* out, int B,        \
                               int nchunk, void* stream) {                    \
    dim3 grid(NW, B);                                                         \
    NAME##_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(                     \
        (const PT*)partials, (int32_t*)out, nchunk);                          \
    return (int)cudaGetLastError();                                           \
  }

FOLD_PARTIALS(fold_partials, 33, int32_t, fold_partials_body, FOLD_THREADS)
FOLD_PARTIALS(fold_partials_i16fold, 33, int16_t, fold_partials_body,
              FOLD_THREADS)
FOLD_PARTIALS(fold_partials_r32, 27, int32_t, fold_partials_body,
              FOLD_THREADS)
FOLD_PARTIALS(fold_partials_l20, 33, int32_t, fold_partials_l20_body,
              THREADS_L20)

// -- K5 fold_shards: the cross-shard group fold -----------------------------
//
// Folds the sharded mesh's D per-shard window sums, each (B, 4, 20, 33)
// int32 on the placement's first device, to (B, 4, 20, 33) int32 with
// canonical limbs.
//
// Replaces: the all_gather + lax.scan fold of point_add in
// ed25519_consensus_tpu/parallel/sharded_msm.py
// (_compiled_sharded_kernel_many and its audit and cached forms, :139-145).
// Plain PyTorch version: ops/msm.py fold_shards_plain, the same additions
// in the same order (msm._warp_tree over the D shards) ending with
// canonical_limbs20, so the two agree limb for limb; ops/fe_u32.py
// fold_lane(rows, 32) models one (b, w).  The JAX fold starts from the
// identity and takes the shards in order (D additions); this one takes
// D - 1, so the two agree as points, not limbs.
//
// Every shard's sums come from K3, whose limbs are canonical: inside
// fe8_from_limbs20's bound |limb| <= 8191.
//
// A group fold, never an elementwise limb add.  Bound: D * 320 bytes read
// and 320 written a (b, w), a few kilobytes at the mesh's shapes, and D - 1
// additions: its time is latency, the additions on the longest dependent
// path plus a conversion in and one out.  Design: one warp a (b, w),
// K5_WARPS a block; lane d < D reads shard d's point through a by-value
// table of shard pointers (no stacked copy of the shards), so the D loads
// run side by side, and K3's warp_fold takes ceil(log2 D) additions on
// its longest path (the 20-limb body: D - 1 in a row); lane 0 writes
// canonical limbs with K3's store_coord.  D <= MAX_SHARDS, one warp's
// lanes; the C entry refuses more.

namespace {

constexpr int MAX_SHARDS = 32;  // ops/msm.py MAX_SHARDS
constexpr int K5_WARPS = 4;     // (b, w) folds a block

struct ShardPtrs {
  const int32_t* p[MAX_SHARDS];
};

}  // namespace

extern "C" __global__ void __launch_bounds__(32 * K5_WARPS)
    fold_shards_kernel(const ShardPtrs shards, int32_t* __restrict__ out,
                       int D, int B) {
  const int lane = threadIdx.x & 31;
  const int fold = blockIdx.x * K5_WARPS + (threadIdx.x >> 5);
  if (fold >= B * NWIN) return;  // the whole warp: warp_fold shuffles
  const int b = fold / NWIN;
  const int w = fold - b * NWIN;
  // (B, 4, 20, NWIN): coordinate-limb major, window minor.
  const size_t at = (size_t)b * COORDS * NWIN + w;
  ge8 acc = ge8_identity();
  if (lane < D) {
    const int32_t* s = shards.p[lane] + at;
    acc.X = fe8_from_limbs20(s, NWIN);
    acc.Y = fe8_from_limbs20(s + (size_t)FE_NLIMBS * NWIN, NWIN);
    acc.Z = fe8_from_limbs20(s + (size_t)2 * FE_NLIMBS * NWIN, NWIN);
    acc.T = fe8_from_limbs20(s + (size_t)3 * FE_NLIMBS * NWIN, NWIN);
  }
  acc = warp_fold(acc, lane, D);
  if (lane) return;
  int32_t* o = out + at;
  store_coord<NWIN>(o, acc.X);
  store_coord<NWIN>(o + (size_t)FE_NLIMBS * NWIN, acc.Y);
  store_coord<NWIN>(o + (size_t)2 * FE_NLIMBS * NWIN, acc.Z);
  store_coord<NWIN>(o + (size_t)3 * FE_NLIMBS * NWIN, acc.T);
}

// shards: D pointers, one a shard's (B, 4, 20, 33) int32 sums.
extern "C" int fold_shards_launch(const void* const* shards, int D,
                                  void* out, int B, void* stream) {
  if (D < 0 || D > MAX_SHARDS || B < 0) return (int)cudaErrorInvalidValue;
  ShardPtrs p = {};
  for (int d = 0; d < D; ++d) p.p[d] = (const int32_t*)shards[d];
  const int blocks = (B * NWIN + K5_WARPS - 1) / K5_WARPS;
  fold_shards_kernel<<<blocks, 32 * K5_WARPS, 0, (cudaStream_t)stream>>>(
      p, (int32_t*)out, D, B);
  return (int)cudaGetLastError();
}

// fold_shards_l20 (the lab's fold_shards-l20): K5's earlier 20-limb body,
// the stacked shards (D, B, 4, 20, 33) int32 -> (B, 4, 20, 33) int32.  One
// thread a (b, w) starts from shard 0 and adds shards 1, 2, ... in order
// (D - 1 additions), reading the stacked layout in place (shard stride
// B * 4 * 20 * 33); the limbs as the additions leave them.  Plain version:
// ops/msm.py fold_shards_plain(arith="l20"), limb for limb.  No verdict
// path launches it.
extern "C" __global__ void __launch_bounds__(64)
    fold_shards_l20_kernel(const int32_t* __restrict__ gathered,
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

extern "C" int fold_shards_l20_launch(const void* gathered, void* out, int D,
                                      int B, void* stream) {
  const int threads = 64;
  const int blocks = (B * NWIN + threads - 1) / threads;
  fold_shards_l20_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)gathered, (int32_t*)out, D, B);
  return (int)cudaGetLastError();
}
