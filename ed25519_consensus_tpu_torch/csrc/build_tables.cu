// K4 build_tables, designed for Hopper: the [0..8]P multiples tables of the
// R lanes of a resident-tables dispatch.  points (B, 4, 20, N) int16, in any
// limbs fe8_from_limbs20 accepts (|limb| <= 8191; on the verdict path K1's
// canonical output) -> tables (B, 9, 4, 20, N) int16, lanes the fastest
// axis, as K2t's copy_tables reads them (window_sums_u32.cuh).  Entry 0 is
// the identity; entry 1 is P as canonical limbs (a conversion, not an
// addition); entries 2..8 are K2's table tree, built by K2's own code
// (window_sums_u32.cuh build_table): T2 = P + P; T3 = T2 + P, T4 = T2 +
// T2; T5 = T4 + P, T6 = T4 + T2, T7 = T4 + T3, T8 = T4 + T4, by ge8_add on
// the 8 x 32-bit arithmetic (fe25519_u32.cuh), every entry written as
// canonical limbs.  So every coordinate is the residue K2 computes for the
// same entry, and K2t on these tables gives K2's partials limb for limb.
//
// Replaces: ed25519_consensus_tpu/ops/msm.py:table_scan (msm.py:194-220, the
// XLA scan that builds the R lanes' tables of the resident-tables dispatch)
// and _compiled_table_builder / build_multiples_tables (msm.py:597-623).
// Plain version: ops/msm.py build_tables_plain(arith="u32"), the same tree
// (msm._u32_table_tree) in the 20-limb arithmetic, then
// torch_field.canonical_limbs20: the same residues, so the same limbs.
// ops/fe_u32.py tables_lane models one lane of this kernel.
//
// Bound: the integer operations.  A lane needs 7 complete additions (2,227
// operations each; the tree issues 8, both threads of a lane forming T2),
// 4 coordinates in (fe8_from_limbs20) and 32 out
// (fe8_to_limbs20_canonical), ~21e3 operations, against 160 bytes read and
// 1,440 written (chip_smoke.py counts both from the run's data).
//
// Design:
//  * K2's table phase itself (window_sums_u32.cuh `build_table`), not a
//    copy: a block is K2's chunk of 64 lanes and its 128 table threads, two
//    a lane, a chain of 4 additions (T2; T3 | T4; a barrier; T5, T7 |
//    T6, T8) into the u32 table in shared memory (64 KB: 3 blocks, 12
//    warps an SM).  The tree is written once for both kernels.
//  * Then a barrier, and the block writes the chunk's 9 entries out: item
//    (entry, coordinate, lane), lanes fastest, so a warp converts one
//    coordinate of 32 consecutive lanes (fe8_to_limbs20_canonical from the
//    table's XOR-spread slots: no bank conflict) and each of its 20 stores
//    covers 64 consecutive bytes of a row.  Entry 0 is the identity's
//    constant limbs.  (Staging the rows to store 16-byte vectors ran 1.3x
//    slower: rows of N int16 need not be 16-byte aligned, PERF.md.)
//  * `__launch_bounds__(128, K4_MIN_BLOCKS)`, the register budget chosen
//    from tools/ptxas_report.py's sweep on the card.
//  * No tensor cores: see fe25519_u32.cuh.
//
// build_tables_l20 (the lab's build_tables-l20, 9 entries) and
// build_tables_r32 (build_tables-r32, 17 entries, the radix-32 K2t's) are
// K4's earlier 20-limb kernel on csrc/fe25519.cuh: one thread a lane, entry
// k = entry (k - 1) + P by complete addition (entry 1 = identity + P), the
// limbs as the additions leave them, equal byte for byte to the JAX
// package's build_multiples_tables; their plain version is
// build_tables_plain(arith="l20") (window_bits=5: every arith).  No verdict
// path launches build_tables_l20.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "fe25519_u32.cuh"
#include "window_sums_u32.cuh"

// The fewest resident blocks of 128 threads an SM that ptxas must allow.
// Shared memory holds 3; at 3 ptxas takes 158 registers with no spill (12
// warps an SM) and it runs fastest; at 1 or 2, 194 registers, 8 warps
// (ptxas on an H100).
#ifndef K4_MIN_BLOCKS
#define K4_MIN_BLOCKS 3
#endif

namespace k4 {

constexpr int LANES = ws8::CHUNK;   // lanes a block
constexpr int THREADS = 2 * LANES;  // two a lane in the tree
constexpr int ROWS = ws8::COORDS;   // int16 limb rows of a point

}  // namespace k4

// K4.  points (B, 4, 20, N) int16, tables (B, 9, 4, 20, N) int16.  Grid
// (ceil(N / 64), B); block 128 threads, ws8::TABLE_BYTES of dynamic shared
// memory.
extern "C" __global__ void __launch_bounds__(k4::THREADS, K4_MIN_BLOCKS)
    build_tables_kernel(const int16_t* __restrict__ points,
                        int16_t* __restrict__ tables, int N) {
  using namespace k4;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* tbl = (uint4*)smem;
  const int lane0 = blockIdx.x * LANES;
  const int b = blockIdx.y;
  ws8::build_table(tbl, points, b, lane0, N);
  __syncthreads();
  const int nl = min(LANES, N - lane0);
  int16_t* out = tables + (size_t)b * ws8::NTBL * ROWS * N + lane0;
#pragma unroll 1
  for (int item = threadIdx.x; item < ws8::NTBL * 4 * LANES;
       item += THREADS) {
    const int lane = item & (LANES - 1);
    const int ec = item / LANES;  // entry * 4 + coordinate
    if (lane >= nl) continue;
    int16_t* o = out + (size_t)ec * 20 * N + lane;
    int32_t l[20];
    if (ec < 4) {
      // the identity (0 : 1 : 1 : 0)
#pragma unroll
      for (int i = 0; i < 20; ++i) l[i] = 0;
      l[0] = (ec == 1 || ec == 2) ? 1 : 0;
    } else {
      fe8_to_limbs20_canonical(
          ws8::get_fe(tbl, (ec >> 2) - 1, lane, 2 * (ec & 3)), l);
    }
#pragma unroll
    for (int i = 0; i < 20; ++i) o[(size_t)i * N] = (int16_t)l[i];
  }
}

extern "C" int build_tables_launch(const void* points, void* tables, int B,
                                   int N, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      build_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      ws8::TABLE_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(build_tables_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + k4::LANES - 1) / k4::LANES, B);
  build_tables_kernel<<<grid, k4::THREADS, ws8::TABLE_BYTES,
                        (cudaStream_t)stream>>>((const int16_t*)points,
                                                (int16_t*)tables, N);
  return (int)cudaGetLastError();
}

// -- the 20-limb kernels (the lab's build_tables-l20 and build_tables-r32) --

namespace {

constexpr int THREADS = 128;
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

template <int NTBL>
__device__ __forceinline__ void build_tables_body(
    const int16_t* __restrict__ points, int16_t* __restrict__ tables, int N) {
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

// One 20-limb instantiation: the kernel NAME_kernel and its C entry
// NAME_launch(points, tables, B, N, stream).
#define BUILD_TABLES(NAME, NTBL)                                              \
  extern "C" __global__ void __launch_bounds__(THREADS)                      \
      NAME##_kernel(const int16_t* __restrict__ points,                       \
                    int16_t* __restrict__ tables, int N) {                    \
    build_tables_body<NTBL>(points, tables, N);                               \
  }                                                                           \
  extern "C" int NAME##_launch(const void* points, void* tables, int B,       \
                               int N, void* stream) {                         \
    dim3 grid((N + THREADS - 1) / THREADS, B);                                \
    NAME##_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(                \
        (const int16_t*)points, (int16_t*)tables, N);                         \
    return (int)cudaGetLastError();                                           \
  }

BUILD_TABLES(build_tables_l20, 9)
BUILD_TABLES(build_tables_r32, 17)
