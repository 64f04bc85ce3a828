// K2 window_sums and K2t window_sums_tables: per-chunk MSM window sums.  For
// every batch b, lane chunk c (CHUNK = 64 lanes) and window w, the
// complete-addition sum over the chunk's lanes of sign(d) * T[|d|], T =
// [0..8]P the lane's multiples table.  Output: (B, nchunk, 33, 4, 20) int32
// partials, folded over chunks by K3 (fold_partials.cu).
//
// K2 replaces: ed25519_consensus_tpu/ops/pallas_msm.py:_compiled_pallas_kernel_rolled
// (the pl.pallas_call at pallas_msm.py:320, default tables_in=False), with
// the nibble unpack of ops/msm.py:expand_digits fused into the digit load.
// K2t replaces the same kernel's tables_in=True form, both tables_batched
// forms (pallas_msm.py:511-587): the tables arrive prebuilt — the resident
// head tables of a recurring keyset and the per-signature R tables K4
// (build_tables.cu) wrote — and the block only copies them.
// Plain PyTorch versions: ops/msm.py window_partials_plain and
// window_partials_tables_plain, which take the same additions in the same
// order, so kernel and plain version agree limb for limb.
//
// Bound: int32 multiply-adds.  Per chunk: K2 7 x 64 table additions and
// 33 x 63 window additions, ~9.4e3 int32 operations each; K2t only the
// window additions, against 8 x 80 x 64 int16 table reads (82 KB).
//
// Design (not a block-by-block copy of the Pallas kernel):
//  * The Pallas block keeps a 5.9 MB table per 4,096 lanes in VMEM; a
//    Hopper block gets at most 227 KB of shared memory.  One block owns one
//    64-lane chunk of one batch: its tables, entries 1..8 as int16 (exact:
//    limbs stay inside |limb| <= 8191), take 80 KB, so two blocks fit an SM.
//    Entry 0, the identity, is never stored and never read.
//  * Blocks run in parallel and in no order, so nothing carries between
//    them: each writes its own partials and K3 folds them.
//  * Phase 1, K2: thread t < 64 builds lane t's table, T1 = P,
//    Tk = T(k-1) + P.  Phase 1, K2t: a block of 128 threads copies entries
//    1..8 of the chunk's lanes into the same shared layout, lane index
//    fastest, so consecutive threads read consecutive addresses of one
//    source row; each thread issues a round of loads before its stores.
//    Lanes [0, n_head) read the head tables, lanes [n_head, N) the R
//    tables: the chunk that straddles n_head takes each lane from its own
//    source.  The head tables have a batch stride of 0 when TH = 1 (one
//    resident entry shared by every batch, never materialised B times).
//  * Phase 2 (shared by both, one device function): 66 threads, thread
//    j = 2w + h sums window w over chunk half h (32 lanes, sequentially,
//    starting from the first lane's selected entry); the two halves then
//    meet in one more addition.
//  * Digits are decoded in the load: packed row w >> 1, low nibble for even
//    w, high nibble for odd w, sign-extended as ((x & 0xF) ^ 8) - 8.  The
//    33rd plane rides alone in the low nibble of packed row 16.
//  * The ragged lane edge is masked: lanes >= N take the identity and
//    digit 0.
//  * The table's entry stride is padded by one 32-bit word: at one step a
//    warp reads up to 16 distinct words (8 entries x 2 chunk halves),
//    which then fall in distinct banks.
//  * Resident head tables hold canonical limbs in [0, 8191], K4's balanced
//    limbs in [-8191, 8191]; both are inside the bound the field code
//    assumes, and the int16 copy is exact.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"

namespace {

constexpr int CHUNK = 64;
constexpr int HALF = CHUNK / 2;
constexpr int NWIN = 33;
constexpr int PACKED_ROWS = 17;
constexpr int NENT = 8;                      // stored entries [1..8]P
constexpr int NTBL = NENT + 1;               // entries of a table tensor
constexpr int COORDS = 4 * FE_NLIMBS;        // 80 limbs per point
constexpr int ENT_STRIDE = COORDS * CHUNK + 2;  // int16 units, +1 word pad
constexpr int THREADS = 2 * NWIN;            // 66
// K2t's block: 128 threads for its table copy (two blocks of 128 x 255
// registers still fit an SM), of which the first 66 run the window phase;
// each copying thread keeps COPY_BATCH loads in flight.
constexpr int THREADS_T = 128;
constexpr int COPY_BATCH = 10;
constexpr size_t TABLE_BYTES = (size_t)NENT * ENT_STRIDE * sizeof(int16_t);
constexpr size_t DIGIT_BYTES = (size_t)NWIN * CHUNK;
constexpr size_t XCHG_BYTES = (size_t)NWIN * COORDS * sizeof(int32_t);
constexpr size_t SMEM_BYTES = TABLE_BYTES + DIGIT_BYTES + XCHG_BYTES;

__device__ __forceinline__ void store_entry(int16_t* tbl, int e, int lane,
                                            const ge& p) {
  int16_t* base = tbl + (size_t)(e - 1) * ENT_STRIDE + lane;
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) {
    base[(0 * FE_NLIMBS + i) * CHUNK] = (int16_t)p.X.v[i];
    base[(1 * FE_NLIMBS + i) * CHUNK] = (int16_t)p.Y.v[i];
    base[(2 * FE_NLIMBS + i) * CHUNK] = (int16_t)p.Z.v[i];
    base[(3 * FE_NLIMBS + i) * CHUNK] = (int16_t)p.T.v[i];
  }
}

// sign(d) * T[|d|] for one lane: the identity for d = 0, X and T negated for
// d < 0 (negation is free on balanced limbs).
__device__ __forceinline__ ge select_entry(const int16_t* tbl, int lane,
                                           int d) {
  const int m = d < 0 ? -d : d;
  if (m == 0) return ge_identity();
  const int16_t* base = tbl + (size_t)(m - 1) * ENT_STRIDE + lane;
  ge p;
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) {
    p.X.v[i] = base[(0 * FE_NLIMBS + i) * CHUNK];
    p.Y.v[i] = base[(1 * FE_NLIMBS + i) * CHUNK];
    p.Z.v[i] = base[(2 * FE_NLIMBS + i) * CHUNK];
    p.T.v[i] = base[(3 * FE_NLIMBS + i) * CHUNK];
  }
  if (d < 0) {
    p.X = fe_neg(p.X);
    p.T = fe_neg(p.T);
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

__device__ __forceinline__ ge load_point_i32(const int32_t* src) {
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

// The chunk's digits, decoded from either wire into shared memory by the
// block's NT threads.
template <int NT>
__device__ __forceinline__ void load_digits(const uint8_t* __restrict__ digits,
                                            int packed, int8_t* dig, int b,
                                            int lane0, int N) {
  for (int idx = threadIdx.x; idx < NWIN * CHUNK; idx += NT) {
    const int w = idx / CHUNK;
    const int l = idx % CHUNK;
    const int n = lane0 + l;
    int d = 0;
    if (n < N) {
      if (packed) {
        const int x = digits[((size_t)b * PACKED_ROWS + (w >> 1)) * N + n];
        const int nib = (w & 1) ? (x >> 4) & 0xF : x & 0xF;
        d = (nib ^ 8) - 8;
      } else {
        d = (int8_t)digits[((size_t)b * NWIN + w) * N + n];
      }
    }
    dig[w * CHUNK + l] = (int8_t)d;
  }
}

// Thread (w, h)'s half of window w: the sum over lanes [32h, 32h + 32),
// lane by lane from the first lane's selected entry.  The window loop both
// kernels share.
__device__ __forceinline__ ge half_window_sum(const int16_t* tbl,
                                              const int8_t* dig, int w,
                                              int h) {
  const int8_t* drow = dig + w * CHUNK + h * HALF;
  ge acc = select_entry(tbl, h * HALF, drow[0]);
#pragma unroll 1
  for (int l = 1; l < HALF; ++l)
    acc = ge_add(acc, select_entry(tbl, h * HALF + l, drow[l]));
  return acc;
}

// Phase 2: thread (w, h) sums its half of window w; thread (w, 0) adds the
// other half's sum and writes the partial.  NT is the block's width: K2's
// block is exactly the 66 window threads (`active` folds to true); in K2t's
// wider block the threads past them only meet the barrier.
template <int NT>
__device__ __forceinline__ void window_phase(const int16_t* tbl,
                                             const int8_t* dig,
                                             int32_t* xchg,
                                             int32_t* __restrict__ partials,
                                             int b, int chunk, int nchunk) {
  const int tid = threadIdx.x;
  const int w = tid >> 1;
  const int h = tid & 1;
  const size_t out = (((size_t)b * nchunk + chunk) * NWIN + w) * COORDS;
  const bool active = NT == THREADS || tid < THREADS;
  ge acc;
  if (active) {
    acc = half_window_sum(tbl, dig, w, h);
    if (h == 1) store_point_i32(xchg + w * COORDS, acc);
  }
  __syncthreads();
  if (active && h == 0) {
    acc = ge_add(acc, load_point_i32(xchg + w * COORDS));
    store_point_i32(partials + out, acc);
  }
}

// digits: (B, 17, N) uint8 nibble-packed when `packed`, else (B, 33, N) int8.
// points: (B, 4, 20, N) int16.  partials: (B, nchunk, 33, 4, 20) int32.
__global__ void __launch_bounds__(THREADS)
window_sums_kernel(const uint8_t* __restrict__ digits, int packed,
                   const int16_t* __restrict__ points,
                   int32_t* __restrict__ partials, int N, int nchunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* tbl = (int16_t*)smem;
  int8_t* dig = (int8_t*)(smem + TABLE_BYTES);
  int32_t* xchg = (int32_t*)(smem + TABLE_BYTES + DIGIT_BYTES);

  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane0 = chunk * CHUNK;

  load_digits<THREADS>(digits, packed, dig, b, lane0, N);

  // Phase 1: lane tid's multiples table.
  if (tid < CHUNK) {
    const int n = lane0 + tid;
    ge P;
    if (n < N) {
      const int16_t* src = points + (size_t)b * COORDS * N + n;
#pragma unroll
      for (int i = 0; i < FE_NLIMBS; ++i) {
        P.X.v[i] = src[(size_t)(0 * FE_NLIMBS + i) * N];
        P.Y.v[i] = src[(size_t)(1 * FE_NLIMBS + i) * N];
        P.Z.v[i] = src[(size_t)(2 * FE_NLIMBS + i) * N];
        P.T.v[i] = src[(size_t)(3 * FE_NLIMBS + i) * N];
      }
    } else {
      P = ge_identity();
    }
    store_entry(tbl, 1, tid, P);
    ge cur = P;
#pragma unroll 1
    for (int e = 2; e <= NENT; ++e) {
      cur = ge_add(cur, P);
      store_entry(tbl, e, tid, cur);
    }
  }
  __syncthreads();
  window_phase<THREADS>(tbl, dig, xchg, partials, b, chunk, nchunk);
}

// head_tables: (TH, 9, 4, 20, n_head) int16, batch stride head_bstride
// elements (0 when TH = 1).  r_tables: (B, 9, 4, 20, N - n_head) int16.
// Entry 0 of either is never read.
__global__ void __launch_bounds__(THREADS_T)
window_sums_tables_kernel(const uint8_t* __restrict__ digits, int packed,
                          const int16_t* __restrict__ head_tables,
                          long long head_bstride, int n_head,
                          const int16_t* __restrict__ r_tables,
                          int32_t* __restrict__ partials, int N,
                          int nchunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* tbl = (int16_t*)smem;
  int8_t* dig = (int8_t*)(smem + TABLE_BYTES);
  int32_t* xchg = (int32_t*)(smem + TABLE_BYTES + DIGIT_BYTES);

  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int lane0 = chunk * CHUNK;
  const int n_r = N - n_head;
  const int16_t* head = head_tables + (size_t)b * head_bstride;
  const int16_t* rtab = r_tables + (size_t)b * NTBL * COORDS * n_r;

  load_digits<THREADS_T>(digits, packed, dig, b, lane0, N);

  // Phase 1: copy entries 1..8 of every lane, lane index fastest, in
  // rounds of COPY_BATCH elements a thread: all of a round's loads are
  // issued before any of its shared-memory stores, so each thread keeps
  // COPY_BATCH independent loads in flight (one at a time, the copy is
  // bound by memory latency, not bandwidth).
  constexpr int TOTAL = NENT * COORDS * CHUNK;
  for (int base = threadIdx.x; base < TOTAL;
       base += COPY_BATCH * THREADS_T) {
    int16_t v[COPY_BATCH];
#pragma unroll
    for (int k = 0; k < COPY_BATCH; ++k) {
      const int idx = base + k * THREADS_T;
      const int l = idx % CHUNK;
      const int row = (idx / CHUNK) % COORDS;  // coordinate * 20 + limb
      const int e = idx / (CHUNK * COORDS) + 1;
      const int n = lane0 + l;
      if (idx >= TOTAL) {
        v[k] = 0;
      } else if (n < n_head) {
        v[k] = head[((size_t)e * COORDS + row) * n_head + n];
      } else if (n < N) {
        v[k] = rtab[((size_t)e * COORDS + row) * n_r + (n - n_head)];
      } else {
        // the identity (0 : 1 : 1 : 0): limb 0 of Y and Z is 1
        v[k] = (row == FE_NLIMBS || row == 2 * FE_NLIMBS) ? 1 : 0;
      }
    }
#pragma unroll
    for (int k = 0; k < COPY_BATCH; ++k) {
      const int idx = base + k * THREADS_T;
      if (idx < TOTAL) {
        const int l = idx % CHUNK;
        const int row = (idx / CHUNK) % COORDS;
        const int e = idx / (CHUNK * COORDS) + 1;
        tbl[(size_t)(e - 1) * ENT_STRIDE + row * CHUNK + l] = v[k];
      }
    }
  }
  __syncthreads();
  window_phase<THREADS_T>(tbl, dig, xchg, partials, b, chunk, nchunk);
}

}  // namespace

extern "C" int window_sums_launch(const void* digits, int packed,
                                  const void* points, void* partials, int B,
                                  int N, void* stream) {
  // Set on every launch: the attribute is per device, and the call is cheap.
  cudaError_t err = cudaFuncSetAttribute(
      window_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int nchunk = (N + CHUNK - 1) / CHUNK;
  dim3 grid(nchunk, B);
  window_sums_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const uint8_t*)digits, packed, (const int16_t*)points,
      (int32_t*)partials, N, nchunk);
  return (int)cudaGetLastError();
}

// head_batched: 1 when the head tables carry one table per batch (TH = B),
// 0 when one table is shared by every batch (TH = 1).
extern "C" int window_sums_tables_launch(const void* digits, int packed,
                                         const void* head_tables,
                                         int head_batched, int n_head,
                                         const void* r_tables, void* partials,
                                         int B, int N, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      window_sums_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int nchunk = (N + CHUNK - 1) / CHUNK;
  const long long bstride =
      head_batched ? (long long)NTBL * COORDS * n_head : 0;
  dim3 grid(nchunk, B);
  window_sums_tables_kernel<<<grid, THREADS_T, SMEM_BYTES,
                              (cudaStream_t)stream>>>(
      (const uint8_t*)digits, packed, (const int16_t*)head_tables, bstride,
      n_head, (const int16_t*)r_tables, (int32_t*)partials, N, nchunk);
  return (int)cudaGetLastError();
}
