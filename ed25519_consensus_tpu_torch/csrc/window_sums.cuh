// The first port of the window-sum kernel: K2, K2t and K2s window_select_only
// as templates over the variant axes of the Pallas kernel they replace, in
// the 20 x 13-bit limb arithmetic of fe25519.cuh.  The kernel lab's forms
// (the -l20 forms, which were the default K2 and K2t until
// window_sums_u32.cuh, and every variant) are instantiated here.  For
// every batch b, lane chunk c (CHUNK lanes) and window w, K2 and K2t write
// the complete-addition sum over the chunk's lanes of sign(d) * T[|d|], T =
// [0..2^(WB-1)]P the lane's multiples table.  Output: (B, nchunk, NWIN, 4,
// 20) partials of type PT, folded over chunks by K3 (fold_partials.cu).
//
// Replaces: ed25519_consensus_tpu/ops/pallas_msm.py:_compiled_pallas_kernel_rolled
// (the pl.pallas_call at pallas_msm.py:320) with its variant axes:
//   WB      window_bits (pallas_msm.py:185-188): 4 -> 33 windows, a 9-entry
//           table, digits in [-8, 7]; 5 -> 27 windows, a 17-entry table,
//           digits in [-16, 15] (plain int8 planes only);
//   TT      the table's storage, tbl_dtype (:162, :215): int16 or int32;
//   PT      the stored partials and the half-chunk exchange, fold_dtype
//           (:189-193): int32 or int16 (exact: every complete addition's
//           output limb has |limb| <= 8191, the closure bound of
//           fe25519.cuh's carry schedule);
//   UNROLL  the `hybrid` body (:178-184, :233-242): the lane loop of the
//           window phase and K2's table-build loop fully unrolled;
//   W       win_chunk (:164, :217-218, grid :322): windows per block, a
//           launch argument (any divisor of NWIN); the grid's third axis
//           runs NWIN / W window groups.  A C entry holds up to two
//           kernels (the FORMS argument of WS_K2 / WS_K2T): NAME_kernel
//           with W = NWIN fixed at compile time (its loops, offsets and
//           thread guards fold as in a kernel written for one W) and
//           NAME_w_kernel for any W;
//   CHUNK   tile (:162, :213): lanes per block, 64 or 32.
// K2t is the same kernel's tables_in=True form (both tables_batched forms,
// :275-290), K2s its select_only form (:200-204, :251-253).  Plain PyTorch
// versions: ops/msm.py window_partials_plain, window_partials_tables_plain
// (arith="l20", or any variant axis off the default) and select_only_plain,
// which take the same additions in the same order, so kernel and plain
// version agree limb for limb.
//
// Bound: int32 multiply-adds.  Per chunk and window group, K2 takes
// (2^(WB-1) - 1) x CHUNK table additions and W x (CHUNK - 1) window
// additions, ~9.4e3 int32 operations each; K2t only the window additions,
// against 2^(WB-1) x 80 x CHUNK table reads.
//
// Design (not a block-by-block copy of the Pallas kernel):
//  * The Pallas block keeps a 5.9 MB table per 4,096 lanes in VMEM; a
//    Hopper block gets at most 227 KB of shared memory.  One block owns one
//    CHUNK-lane chunk of one batch and W of its windows: the chunk's
//    entries 1..2^(WB-1) (entry 0, the identity, is never stored or read),
//    its digits and a half-chunk exchange.  Shared bytes: smem_bytes()
//    below; the wrapper (ops/msm.py k2_shared_bytes) refuses a combination
//    above 227 KB (radix-32 with int32 tables at 64 lanes, 328 KB) before
//    any launch.
//  * Blocks run in parallel and in no order, so nothing carries between
//    them: each writes its own partials and K3 folds them.  With W < NWIN
//    the NWIN / W blocks of one chunk cannot share shared memory, so each
//    builds (K2) or copies (K2t) the chunk's table again: table work grows
//    NWIN / W-fold.  That is the TPU grid step's meaning carried over; its
//    cost is in PERF.md.
//  * Phase 1, K2: thread t < CHUNK builds lane t's table, T1 = P,
//    Tk = T(k-1) + P.  Phase 1, K2t and K2s: a block of 128 threads copies
//    the stored entries of the chunk's lanes into the same shared layout,
//    lane index fastest, COPY_BATCH loads in flight a thread.  Lanes
//    [0, n_head) read the head tables, lanes [n_head, N) the R tables: the
//    chunk that straddles n_head takes each lane from its own source.  The
//    head tables have a batch stride of 0 when TH = 1.
//  * Phase 2 (one device function for K2 and K2t): 2W threads, thread
//    j = 2w + h sums window w over chunk half h (CHUNK / 2 lanes,
//    sequentially, starting from the first lane's selected entry); the two
//    halves then meet in one more addition through the exchange.
//  * K2s, phase 2: thread (w, h) XORs the 80 limbs of its CHUNK / 2
//    selected entries (identity for d = 0, X and T negated for d < 0) and
//    writes them: every select stays live, no complete addition runs.
//  * Digits are decoded in the load: packed row w >> 1, low nibble for even
//    w, high nibble for odd w, sign-extended as ((x & 0xF) ^ 8) - 8; the
//    33rd plane rides alone in the low nibble of packed row 16.  Radix-32
//    takes plain planes only.
//  * The ragged lane edge is masked: lanes >= N take the identity and
//    digit 0.
//  * The table's entry stride is padded by one 32-bit word: at one step a
//    warp reads up to 2^WB distinct words (the entries x 2 chunk halves),
//    which then fall in distinct banks.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"

namespace ws {

constexpr int COORDS = 4 * FE_NLIMBS;  // 80 limbs per point
constexpr int PACKED_ROWS = 17;
// K2's block: max(2W, CHUNK) threads, at most 66.
constexpr int K2_MAX_THREADS = 66;
// K2t's and K2s's block: 128 threads for the table copy (two blocks of
// 128 x 255 registers still fit an SM), of which the first 2W run the
// window phase; each copying thread keeps COPY_BATCH loads in flight.
constexpr int THREADS_T = 128;
constexpr int COPY_BATCH = 10;

__host__ __device__ constexpr int nwin_of(int wb) { return wb == 4 ? 33 : 27; }

// FW_: the windows per block fixed at compile time, or 0 for a launch
// argument.
template <int WB_, typename TT_, typename PT_, bool UNROLL_, int CHUNK_,
          int FW_ = 0>
struct Cfg {
  static constexpr int WB = WB_;
  static constexpr int FW = FW_;
  static constexpr bool UNROLL = UNROLL_;
  static constexpr int CHUNK = CHUNK_;
  static constexpr int HALF = CHUNK / 2;
  static constexpr int NWIN = nwin_of(WB);
  // K2's block, max(2W, CHUNK) threads, when W is fixed (else 0)
  static constexpr int K2_THREADS =
      FW == 0 ? 0 : (2 * FW > CHUNK ? 2 * FW : CHUNK);
  static constexpr int NENT = 1 << (WB - 1);  // stored entries [1..NENT]P
  static constexpr int NTBL = NENT + 1;       // entries of a table tensor
  // entry stride in TT units: COORDS x CHUNK plus one 32-bit word
  static constexpr int ENT_STRIDE = COORDS * CHUNK + 4 / (int)sizeof(TT_);
  static constexpr size_t TABLE_BYTES =
      (size_t)NENT * ENT_STRIDE * sizeof(TT_);
  using TT = TT_;
  using PT = PT_;
  static_assert(WB == 4 || WB == 5, "radix 16 or 32");
  static_assert(CHUNK == 32 || CHUNK == 64, "32 or 64 lanes per block");
  static_assert(TABLE_BYTES % 16 == 0, "digits follow the table aligned");

  static size_t smem_bytes(int W) {
    return TABLE_BYTES + (size_t)W * CHUNK +
           (size_t)W * COORDS * sizeof(PT_);
  }
};

template <class C>
__device__ __forceinline__ void store_entry(typename C::TT* tbl, int e,
                                            int lane, const ge& p) {
  typename C::TT* base = tbl + (size_t)(e - 1) * C::ENT_STRIDE + lane;
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) {
    base[(0 * FE_NLIMBS + i) * C::CHUNK] = (typename C::TT)p.X.v[i];
    base[(1 * FE_NLIMBS + i) * C::CHUNK] = (typename C::TT)p.Y.v[i];
    base[(2 * FE_NLIMBS + i) * C::CHUNK] = (typename C::TT)p.Z.v[i];
    base[(3 * FE_NLIMBS + i) * C::CHUNK] = (typename C::TT)p.T.v[i];
  }
}

// sign(d) * T[|d|] for one lane: the identity for d = 0, X and T negated for
// d < 0 (negation is free on balanced limbs).
template <class C>
__device__ __forceinline__ ge select_entry(const typename C::TT* tbl,
                                           int lane, int d) {
  const int m = d < 0 ? -d : d;
  if (m == 0) return ge_identity();
  const typename C::TT* base = tbl + (size_t)(m - 1) * C::ENT_STRIDE + lane;
  ge p;
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) {
    p.X.v[i] = base[(0 * FE_NLIMBS + i) * C::CHUNK];
    p.Y.v[i] = base[(1 * FE_NLIMBS + i) * C::CHUNK];
    p.Z.v[i] = base[(2 * FE_NLIMBS + i) * C::CHUNK];
    p.T.v[i] = base[(3 * FE_NLIMBS + i) * C::CHUNK];
  }
  if (d < 0) {
    p.X = fe_neg(p.X);
    p.T = fe_neg(p.T);
  }
  return p;
}

template <typename T>
__device__ __forceinline__ void store_point(T* dst, const ge& p) {
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) {
    dst[0 * FE_NLIMBS + i] = (T)p.X.v[i];
    dst[1 * FE_NLIMBS + i] = (T)p.Y.v[i];
    dst[2 * FE_NLIMBS + i] = (T)p.Z.v[i];
    dst[3 * FE_NLIMBS + i] = (T)p.T.v[i];
  }
}

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

// Windows [w0, w0 + W) of the chunk's digits, decoded from either wire into
// shared memory (dig[wi * CHUNK + l]) by the block's NT threads (NT = 0:
// blockDim.x).
template <class C, int NT>
__device__ __forceinline__ void load_digits(const uint8_t* __restrict__ digits,
                                            int packed, int8_t* dig, int b,
                                            int lane0, int N, int w0, int W) {
  const int nt = NT ? NT : (int)blockDim.x;
  for (int idx = threadIdx.x; idx < W * C::CHUNK; idx += nt) {
    const int wi = idx / C::CHUNK;
    const int l = idx % C::CHUNK;
    const int w = w0 + wi;
    const int n = lane0 + l;
    int d = 0;
    if (n < N) {
      if (packed) {
        const int x = digits[((size_t)b * PACKED_ROWS + (w >> 1)) * N + n];
        const int nib = (w & 1) ? (x >> 4) & 0xF : x & 0xF;
        d = (nib ^ 8) - 8;
      } else {
        d = (int8_t)digits[((size_t)b * C::NWIN + w) * N + n];
      }
    }
    dig[idx] = (int8_t)d;
  }
}

// Thread (w, h)'s half of window w: the sum over lanes [HALF h, HALF h +
// HALF), lane by lane from the first lane's selected entry.
template <class C>
__device__ __forceinline__ ge half_window_sum(const typename C::TT* tbl,
                                              const int8_t* dig, int wi,
                                              int h) {
  const int8_t* drow = dig + wi * C::CHUNK + h * C::HALF;
  ge acc = select_entry<C>(tbl, h * C::HALF, drow[0]);
  if constexpr (C::UNROLL) {
#pragma unroll
    for (int l = 1; l < C::HALF; ++l)
      acc = ge_add(acc, select_entry<C>(tbl, h * C::HALF + l, drow[l]));
  } else {
#pragma unroll 1
    for (int l = 1; l < C::HALF; ++l)
      acc = ge_add(acc, select_entry<C>(tbl, h * C::HALF + l, drow[l]));
  }
  return acc;
}

// Phase 2: thread (w, h) < 2W sums its half of window w0 + w; thread (w, 0)
// adds the other half's sum through the exchange and writes the partial.
// Threads past 2W only meet the barrier; ALL says at compile time that the
// block has exactly 2W threads.
template <class C, bool ALL>
__device__ __forceinline__ void window_phase(
    const typename C::TT* tbl, const int8_t* dig, typename C::PT* xchg,
    typename C::PT* __restrict__ partials, int b, int chunk, int nchunk,
    int w0, int W) {
  const int tid = threadIdx.x;
  const int wi = tid >> 1;
  const int h = tid & 1;
  const bool active = ALL || tid < 2 * W;
  const size_t out =
      (((size_t)b * nchunk + chunk) * C::NWIN + w0 + wi) * COORDS;
  ge acc;
  if (active) {
    acc = half_window_sum<C>(tbl, dig, wi, h);
    if (h == 1) store_point(xchg + wi * COORDS, acc);
  }
  __syncthreads();
  if (active && h == 0) {
    acc = ge_add(acc, load_point(xchg + wi * COORDS));
    store_point(partials + out, acc);
  }
}

// K2.  digits: (B, 17, N) uint8 nibble-packed when `packed`, else (B, NWIN,
// N) int8.  points: (B, 4, 20, N) int16.  partials: (B, nchunk, NWIN, 4, 20)
// PT.  Grid (nchunk, B, NWIN / W); block max(2W, CHUNK) threads.
template <class C>
__device__ __forceinline__ void k2_body(unsigned char* smem,
                                        const uint8_t* __restrict__ digits,
                                        int packed,
                                        const int16_t* __restrict__ points,
                                        typename C::PT* __restrict__ partials,
                                        int N, int nchunk, int W) {
  if constexpr (C::FW != 0) W = C::FW;
  typename C::TT* tbl = (typename C::TT*)smem;
  int8_t* dig = (int8_t*)(smem + C::TABLE_BYTES);
  typename C::PT* xchg =
      (typename C::PT*)(smem + C::TABLE_BYTES + (size_t)W * C::CHUNK);

  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int w0 = C::FW == C::NWIN ? 0 : blockIdx.z * W;
  const int lane0 = chunk * C::CHUNK;

  load_digits<C, C::K2_THREADS>(digits, packed, dig, b, lane0, N, w0, W);

  // Phase 1: lane l's multiples table (the block has max(2W, CHUNK)
  // threads, so thread l < CHUNK takes lane l).
  const int l = threadIdx.x;
  if (l < C::CHUNK) {
    const int n = lane0 + l;
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
    store_entry<C>(tbl, 1, l, P);
    ge cur = P;
    if constexpr (C::UNROLL) {
#pragma unroll
      for (int e = 2; e <= C::NENT; ++e) {
        cur = ge_add(cur, P);
        store_entry<C>(tbl, e, l, cur);
      }
    } else {
#pragma unroll 1
      for (int e = 2; e <= C::NENT; ++e) {
        cur = ge_add(cur, P);
        store_entry<C>(tbl, e, l, cur);
      }
    }
  }
  __syncthreads();
  window_phase<C, C::K2_THREADS != 0 && C::K2_THREADS == 2 * C::FW>(
      tbl, dig, xchg, partials, b, chunk, nchunk, w0, W);
}

// Phase 1 of K2t and K2s: copy entries 1..NENT of every lane of the chunk,
// lane index fastest, in rounds of COPY_BATCH elements a thread: all of a
// round's loads are issued before any of its shared-memory stores, so each
// thread keeps COPY_BATCH independent loads in flight (one at a time, the
// copy is bound by memory latency, not bandwidth).  head: (TH, NTBL, 4, 20,
// n_head) int16 from the batch's table; rtab: (B, NTBL, 4, 20, N - n_head)
// int16 likewise.  Entry 0 of either is never read.
template <class C>
__device__ __forceinline__ void copy_tables(typename C::TT* tbl,
                                            const int16_t* __restrict__ head,
                                            int n_head,
                                            const int16_t* __restrict__ rtab,
                                            int lane0, int N) {
  constexpr int TOTAL = C::NENT * COORDS * C::CHUNK;
  const int n_r = N - n_head;
  for (int base = threadIdx.x; base < TOTAL;
       base += COPY_BATCH * THREADS_T) {
    int16_t v[COPY_BATCH];
#pragma unroll
    for (int k = 0; k < COPY_BATCH; ++k) {
      const int idx = base + k * THREADS_T;
      const int l = idx % C::CHUNK;
      const int row = (idx / C::CHUNK) % COORDS;  // coordinate * 20 + limb
      const int e = idx / (C::CHUNK * COORDS) + 1;
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
        const int l = idx % C::CHUNK;
        const int row = (idx / C::CHUNK) % COORDS;
        const int e = idx / (C::CHUNK * COORDS) + 1;
        tbl[(size_t)(e - 1) * C::ENT_STRIDE + row * C::CHUNK + l] =
            (typename C::TT)v[k];
      }
    }
  }
}

// K2t.  head_tables: (TH, NTBL, 4, 20, n_head) int16, batch stride
// head_bstride elements (0 when TH = 1).  r_tables: (B, NTBL, 4, 20, N -
// n_head) int16.  Grid (nchunk, B, NWIN / W); block THREADS_T.
template <class C>
__device__ __forceinline__ void k2t_body(
    unsigned char* smem, const uint8_t* __restrict__ digits, int packed,
    const int16_t* __restrict__ head_tables, long long head_bstride,
    int n_head, const int16_t* __restrict__ r_tables,
    typename C::PT* __restrict__ partials, int N, int nchunk, int W) {
  if constexpr (C::FW != 0) W = C::FW;
  typename C::TT* tbl = (typename C::TT*)smem;
  int8_t* dig = (int8_t*)(smem + C::TABLE_BYTES);
  typename C::PT* xchg =
      (typename C::PT*)(smem + C::TABLE_BYTES + (size_t)W * C::CHUNK);

  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int w0 = C::FW == C::NWIN ? 0 : blockIdx.z * W;
  const int lane0 = chunk * C::CHUNK;

  load_digits<C, THREADS_T>(digits, packed, dig, b, lane0, N, w0, W);
  copy_tables<C>(tbl, head_tables + (size_t)b * head_bstride, n_head,
                 r_tables + (size_t)b * C::NTBL * COORDS * (N - n_head),
                 lane0, N);
  __syncthreads();
  window_phase<C, false>(tbl, dig, xchg, partials, b, chunk, nchunk, w0, W);
}

// K2s: K2t's digits and tables, then out (B, nchunk, NWIN, 2, 80) int32:
// for window w and half h, the limb-wise XOR over the half's lanes of
// sign(d) * T[|d|].
template <class C>
__device__ __forceinline__ void k2s_body(
    unsigned char* smem, const uint8_t* __restrict__ digits, int packed,
    const int16_t* __restrict__ head_tables, long long head_bstride,
    int n_head, const int16_t* __restrict__ r_tables,
    int32_t* __restrict__ out, int N, int nchunk, int W) {
  if constexpr (C::FW != 0) W = C::FW;
  typename C::TT* tbl = (typename C::TT*)smem;
  int8_t* dig = (int8_t*)(smem + C::TABLE_BYTES);

  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int w0 = C::FW == C::NWIN ? 0 : blockIdx.z * W;
  const int lane0 = chunk * C::CHUNK;

  load_digits<C, THREADS_T>(digits, packed, dig, b, lane0, N, w0, W);
  copy_tables<C>(tbl, head_tables + (size_t)b * head_bstride, n_head,
                 r_tables + (size_t)b * C::NTBL * COORDS * (N - n_head),
                 lane0, N);
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid >= 2 * W) return;
  const int wi = tid >> 1;
  const int h = tid & 1;
  const int8_t* drow = dig + wi * C::CHUNK + h * C::HALF;
  int32_t x[COORDS];
#pragma unroll
  for (int k = 0; k < COORDS; ++k) x[k] = 0;
#pragma unroll 1
  for (int l = 0; l < C::HALF; ++l) {
    const ge p = select_entry<C>(tbl, h * C::HALF + l, drow[l]);
#pragma unroll
    for (int i = 0; i < FE_NLIMBS; ++i) {
      x[0 * FE_NLIMBS + i] ^= p.X.v[i];
      x[1 * FE_NLIMBS + i] ^= p.Y.v[i];
      x[2 * FE_NLIMBS + i] ^= p.Z.v[i];
      x[3 * FE_NLIMBS + i] ^= p.T.v[i];
    }
  }
  int32_t* o =
      out + ((((size_t)b * nchunk + chunk) * C::NWIN + w0 + wi) * 2 + h) *
                COORDS;
#pragma unroll
  for (int k = 0; k < COORDS; ++k) o[k] = x[k];
}

// The host side of a launch: checks W, sets the block's shared-memory limit
// (per device, so on every launch; the call is cheap) and launches.  Returns
// a cudaError_t: cudaErrorInvalidValue for a W that does not divide NWIN or
// shared memory above the card's limit, else the launch's own error.
template <class C, typename K, typename... A>
int launch(K kern, int threads, int B, int N, int W, void* stream,
           A... args) {
  if (W <= 0 || C::NWIN % W) return (int)cudaErrorInvalidValue;
  const size_t smem = C::smem_bytes(W);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nchunk = (N + C::CHUNK - 1) / C::CHUNK;
  dim3 grid(nchunk, B, C::NWIN / W);
  kern<<<grid, threads, smem, (cudaStream_t)stream>>>(args..., N, nchunk, W);
  return (int)cudaGetLastError();
}

}  // namespace ws

// FORMS, the kernels an instantiation holds: ALL (NAME_kernel, every window
// in one block; its entry refuses any other W), W (NAME_w_kernel, W a launch
// argument, every W included) or BOTH (the first for W = NWIN, the second
// for fewer).  Only the forms a path launches are emitted (ops/_cuda.py
// BLOCK_FORMS mirrors them).
#define WS_IF_ALL_ALL(...) __VA_ARGS__
#define WS_IF_ALL_W(...)
#define WS_IF_ALL_BOTH(...) __VA_ARGS__
#define WS_IF_W_ALL(...)
#define WS_IF_W_W(...) __VA_ARGS__
#define WS_IF_W_BOTH(...) __VA_ARGS__
#define WS_PICK_ALL(NAME, all) NAME##_kernel
#define WS_PICK_W(NAME, all) NAME##_w_kernel
#define WS_PICK_BOTH(NAME, all) ((all) ? NAME##_kernel : NAME##_w_kernel)
#define WS_W_OK_ALL(all) (all)
#define WS_W_OK_W(all) true
#define WS_W_OK_BOTH(all) true

// One instantiation of K2: the kernels of FORMS, unmangled so that ptxas's
// report names them, and the C entry NAME_launch(digits, packed, points,
// partials, B, N, W, stream).
#define WS_K2_KERNEL(KNAME, WB, TT, PT, UNROLL, CHUNK, FW)                     \
  extern "C" __global__ void __launch_bounds__(ws::K2_MAX_THREADS)            \
      KNAME(const uint8_t* __restrict__ digits, int packed,                    \
            const int16_t* __restrict__ points, PT* __restrict__ partials,     \
            int N, int nchunk, int W) {                                        \
    extern __shared__ __align__(16) unsigned char smem[];                      \
    ws::k2_body<ws::Cfg<WB, TT, PT, UNROLL, CHUNK, FW>>(                       \
        smem, digits, packed, points, partials, N, nchunk, W);                 \
  }

#define WS_K2(NAME, FORMS, WB, TT, PT, UNROLL, CHUNK)                          \
  WS_IF_ALL_##FORMS(WS_K2_KERNEL(NAME##_kernel, WB, TT, PT, UNROLL, CHUNK,     \
                                 ws::nwin_of(WB)))                             \
  WS_IF_W_##FORMS(WS_K2_KERNEL(NAME##_w_kernel, WB, TT, PT, UNROLL, CHUNK, 0)) \
  extern "C" int NAME##_launch(const void* digits, int packed,                 \
                               const void* points, void* partials, int B,      \
                               int N, int W, void* stream) {                   \
    using C = ws::Cfg<WB, TT, PT, UNROLL, CHUNK>;                              \
    if (!WS_W_OK_##FORMS(W == C::NWIN)) return (int)cudaErrorInvalidValue;     \
    const int threads = 2 * W > CHUNK ? 2 * W : CHUNK;                         \
    return ws::launch<C>(WS_PICK_##FORMS(NAME, W == C::NWIN),                  \
                         threads, B, N, W, stream, (const uint8_t*)digits,     \
                         packed, (const int16_t*)points, (PT*)partials);       \
  }

// One instantiation of K2t (KIND k2t_body, OUT PT) or K2s (KIND k2s_body,
// OUT int32_t): the kernels of FORMS as above and NAME_launch(digits, packed, head_tables, head_batched, n_head, r_tables,
// out, B, N, W, stream).  head_batched: 1 when the head tables carry one
// table per batch (TH = B), 0 when one table is shared by every batch
// (TH = 1).
#define WS_K2T_KERNEL(KNAME, KIND, OUT, WB, TT, PT, CHUNK, FW)                 \
  extern "C" __global__ void __launch_bounds__(ws::THREADS_T)                 \
      KNAME(const uint8_t* __restrict__ digits, int packed,                    \
            const int16_t* __restrict__ head_tables, long long head_bstride,   \
            int n_head, const int16_t* __restrict__ r_tables,                  \
            OUT* __restrict__ out, int N, int nchunk, int W) {                 \
    extern __shared__ __align__(16) unsigned char smem[];                      \
    ws::KIND<ws::Cfg<WB, TT, PT, false, CHUNK, FW>>(                           \
        smem, digits, packed, head_tables, head_bstride, n_head, r_tables,     \
        out, N, nchunk, W);                                                    \
  }

#define WS_K2T(NAME, FORMS, KIND, OUT, WB, TT, PT, CHUNK)                      \
  WS_IF_ALL_##FORMS(WS_K2T_KERNEL(NAME##_kernel, KIND, OUT, WB, TT, PT, CHUNK, \
                                  ws::nwin_of(WB)))                            \
  WS_IF_W_##FORMS(WS_K2T_KERNEL(NAME##_w_kernel, KIND, OUT, WB, TT, PT, CHUNK, \
                                0))                                            \
  extern "C" int NAME##_launch(const void* digits, int packed,                 \
                               const void* head_tables, int head_batched,      \
                               int n_head, const void* r_tables, void* out,    \
                               int B, int N, int W, void* stream) {            \
    using C = ws::Cfg<WB, TT, PT, false, CHUNK>;                               \
    if (!WS_W_OK_##FORMS(W == C::NWIN)) return (int)cudaErrorInvalidValue;     \
    const long long bstride =                                                  \
        head_batched ? (long long)C::NTBL * ws::COORDS * n_head : 0;           \
    return ws::launch<C>(WS_PICK_##FORMS(NAME, W == C::NWIN),                  \
                         ws::THREADS_T, B, N, W, stream,                       \
                         (const uint8_t*)digits, packed,                       \
                         (const int16_t*)head_tables, bstride, n_head,         \
                         (const int16_t*)r_tables, (OUT*)out);                 \
  }
