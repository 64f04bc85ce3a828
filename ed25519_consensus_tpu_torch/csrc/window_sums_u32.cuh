// K2 window_sums and K2t window_sums_tables, designed for Hopper: the
// default window-sum kernels every verdict path runs (window_sums.cu).
// For every batch b, 64-lane chunk c and window w they write the complete-
// addition sum over the chunk's lanes of sign(d) * T[|d|], T = [0..8]P the
// lane's multiples table, as CANONICAL limbs: (B, nchunk, 33, 4, 20) int32,
// each coordinate the canonical residue in [0, p) split into 20 balanced
// 13-bit limbs (|limb| <= 4096), folded over chunks by K3.  The operands
// and the launch are those of the kernels they replace (nibble-packed or
// plain digits, int16 points (B, 4, 20, N), the resident int16 tables
// (TH | B, 9, 4, 20, n)), so K3, K5, the mesh and the host are untouched.
//
// Replaces: ed25519_consensus_tpu/ops/pallas_msm.py:_compiled_pallas_kernel_rolled
// (the pl.pallas_call at pallas_msm.py:320): K2 its default form, K2t its
// tables_in=True forms (both tables_batched forms, :275-290).  The 20-limb
// port of that kernel, a templated copy of its TPU design, stays as the
// lab's `window_sums-l20` / `window_sums_tables-l20` (window_sums.cuh).
// Plain versions: ops/msm.py window_partials_plain and
// window_partials_tables_plain on the same order of additions (the
// `split` argument of _partials_from_tables) in the 20-limb arithmetic,
// then torch_field.canonical_limbs20: every coordinate here is the same
// residue as there, so kernel and plain version agree limb for limb.
//
// Bound: the integer operations.  A complete addition is 9 field products
// of 227 operations each (74 of them multiplies, fe25519_u32.cuh) plus 9
// adds and subtracts, 2,227 in all, at the issue rate of 128 a clock an
// SM; its 676 multiplies would take less on the 64-a-clock multiply pipe
// (chip_smoke.py counts both bounds from the run's data).
//
// Design (what held the TPU design back on this card, and what this does):
//  * Arithmetic: fe25519_u32.cuh, 8 x 32-bit words with carry chains, ~7x
//    fewer operations a field product than the 20 x 13-bit limbs.  The
//    conversions are at the boundaries only: points (K2) and table entries
//    (K2t) on load, the partials on store.
//  * Occupancy: a point is 32 registers (80 before).  A block is one chunk
//    of one batch with all 33 windows: 160 threads (5 warps), 128
//    registers a thread at most (__launch_bounds__(160, 3)), 67,648 B of
//    shared memory, so 3 blocks (15 warps) fit an SM (65,536 registers,
//    228 KB).  1,536 blocks of the B = 8, N = 12,288 call are 3.9 waves
//    over 396 slots.
//  * Window phase: each window's 64 lanes are S = 4 sub-sums of 16, thread
//    (w, s) = w + 40 s (33 of every 40 threads work; 40 keeps every
//    quarter-warp inside one sub-sum): a chain of 15 additions from the
//    first lane's selected entry, then the fixed join (q0 + q1) + (q2 + q3)
//    through a shared exchange that aliases the table once every thread
//    has passed the barrier after its sub-sum.  The chain is 15 + 2
//    additions a thread, not 31 + 1.
//  * Table build (K2, and K4 in build_tables.cu: `build_table`): two
//    threads a lane (128 of the 160), T2 = P + P, then T3 = T2 + P | T4 =
//    T2 + T2, a barrier, then T5 = T4 + P, T7 = T4 + T3 | T6 = T4 + T2, T8
//    = T4 + T4: a chain of 4 additions, not 7.
//  * Table copy (K2t): 16-byte global loads.  A thread takes 4 lanes of one
//    coordinate of one entry: for each of its 20 limb rows it loads the
//    aligned 16 bytes holding the lanes (and the next 16 when they
//    straddle: rows of n_head or N - n_head int16 need not be 16-byte
//    aligned), shifts the lanes out in registers, and converts each lane's
//    20 limbs into 8 words.  A group of 4 lanes that straddles the head/R
//    boundary, or reaches past N, loads lane by lane.  No staging buffer:
//    two 10 KB cp.async buffers beside 66 KB would leave 2 blocks an SM.
//  * Shared layout: an entry of a lane is 8 16-byte chunks (X lo, X hi, Y
//    lo, ..., T hi); chunk c of entry e (e1 = e - 1) of lane l sits at
//    16-byte slot 8 (64 e1 + l) + ((c ^ e1 ^ l) & 7).  A select is 8
//    16-byte loads.  A quarter-warp of the window phase (8 threads, 8
//    windows of one sub-sum) reads one lane's entries: distinct entries
//    fall in distinct 16-byte bank groups (the XOR with e1), equal ones
//    are one address, so no conflict.  The table build's quarter-warps (8
//    lanes, one entry) and the copy's (8 entries of one lane; item = e1
//    fastest) store conflict-free by the same XOR.  Digits are
//    dig[lane * 33 + w]: a warp's 32 windows read consecutive bytes.
//  * Selection: identity for d = 0, -T[|d|] for d < 0 (the first lane of a
//    sub-sum negates X and T with fe8_neg; the chain's additions take the
//    sign into ge8_add, which swaps operands instead of negating: the same
//    residues).  Lanes >= N take the identity and digit 0.
//  * No tensor cores: see fe25519_u32.cuh.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519_u32.cuh"

namespace ws8 {

constexpr int CHUNK = 64;
constexpr int NWIN = 33;
constexpr int S = 4;              // sub-sums a window
constexpr int SUB = CHUNK / S;    // lanes a sub-sum
constexpr int WSTRIDE = 40;       // threads a sub-sum (33 windows work)
constexpr int THREADS = S * WSTRIDE;
constexpr int NENT = 8;           // stored entries [1..8]P
constexpr int NTBL = 9;           // entries of a table tensor
constexpr int COORDS = 80;        // int16 limb rows of a point
constexpr int PACKED_ROWS = 17;
constexpr int TABLE_BYTES = NENT * CHUNK * 128;
constexpr int DIG_BYTES = CHUNK * NWIN;
constexpr int SMEM_BYTES = TABLE_BYTES + DIG_BYTES;
static_assert(2 * NWIN * 128 <= TABLE_BYTES, "the exchange fits the table");
static_assert(THREADS >= 2 * CHUNK, "two threads a lane build the table");

__device__ __forceinline__ int slot(int e1, int lane, int c) {
  return ((e1 * CHUNK + lane) << 3) | ((c ^ e1 ^ lane) & 7);
}

__device__ __forceinline__ void put_fe(uint4* tbl, int e1, int lane, int c,
                                       const fe8& x) {
  tbl[slot(e1, lane, c)] = make_uint4(x.v[0], x.v[1], x.v[2], x.v[3]);
  tbl[slot(e1, lane, c + 1)] = make_uint4(x.v[4], x.v[5], x.v[6], x.v[7]);
}

__device__ __forceinline__ fe8 get_fe(const uint4* tbl, int e1, int lane,
                                      int c) {
  const uint4 lo = tbl[slot(e1, lane, c)];
  const uint4 hi = tbl[slot(e1, lane, c + 1)];
  fe8 x;
  x.v[0] = lo.x;
  x.v[1] = lo.y;
  x.v[2] = lo.z;
  x.v[3] = lo.w;
  x.v[4] = hi.x;
  x.v[5] = hi.y;
  x.v[6] = hi.z;
  x.v[7] = hi.w;
  return x;
}

__device__ __forceinline__ void put(uint4* tbl, int e1, int lane,
                                    const ge8& p) {
  put_fe(tbl, e1, lane, 0, p.X);
  put_fe(tbl, e1, lane, 2, p.Y);
  put_fe(tbl, e1, lane, 4, p.Z);
  put_fe(tbl, e1, lane, 6, p.T);
}

__device__ __forceinline__ ge8 get(const uint4* tbl, int e1, int lane) {
  ge8 p;
  p.X = get_fe(tbl, e1, lane, 0);
  p.Y = get_fe(tbl, e1, lane, 2);
  p.Z = get_fe(tbl, e1, lane, 4);
  p.T = get_fe(tbl, e1, lane, 6);
  return p;
}

// T[|d|] of `lane`, the identity for d = 0 (entry 0 is never stored: the
// load reads entry 1 and the select drops it).
__device__ __forceinline__ ge8 entry(const uint4* tbl, int lane, int d) {
  const int m = d < 0 ? -d : d;
  ge8 e = get(tbl, m ? m - 1 : 0, lane);
  if (m == 0) e = ge8_identity();
  return e;
}

// Windows 0..32 of the chunk's digits, decoded from either wire, into
// dig[lane * NWIN + w]; 0 past lane N.
__device__ __forceinline__ void load_digits(
    const uint8_t* __restrict__ digits, int packed, int8_t* dig, int b,
    int lane0, int N) {
  for (int idx = threadIdx.x; idx < NWIN * CHUNK; idx += THREADS) {
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
    dig[l * NWIN + w] = (int8_t)d;
  }
}

// The exchange of the join: point k of window w, 8 16-byte slots, XOR-
// spread by w so consecutive windows' stores do not conflict.
__device__ __forceinline__ int xslot(int w, int k, int c) {
  return ((w * 2 + k) << 3) | (c ^ (w & 7));
}

__device__ __forceinline__ void put_xfe(uint4* x, int w, int k, int c,
                                        const fe8& v) {
  x[xslot(w, k, c)] = make_uint4(v.v[0], v.v[1], v.v[2], v.v[3]);
  x[xslot(w, k, c + 1)] = make_uint4(v.v[4], v.v[5], v.v[6], v.v[7]);
}

__device__ __forceinline__ fe8 get_xfe(const uint4* x, int w, int k,
                                       int c) {
  const uint4 lo = x[xslot(w, k, c)];
  const uint4 hi = x[xslot(w, k, c + 1)];
  fe8 v;
  v.v[0] = lo.x;
  v.v[1] = lo.y;
  v.v[2] = lo.z;
  v.v[3] = lo.w;
  v.v[4] = hi.x;
  v.v[5] = hi.y;
  v.v[6] = hi.z;
  v.v[7] = hi.w;
  return v;
}

__device__ __forceinline__ void put_x(uint4* x, int w, int k, const ge8& p) {
  put_xfe(x, w, k, 0, p.X);
  put_xfe(x, w, k, 2, p.Y);
  put_xfe(x, w, k, 4, p.Z);
  put_xfe(x, w, k, 6, p.T);
}

__device__ __forceinline__ ge8 get_x(const uint4* x, int w, int k) {
  ge8 p;
  p.X = get_xfe(x, w, k, 0);
  p.Y = get_xfe(x, w, k, 2);
  p.Z = get_xfe(x, w, k, 4);
  p.T = get_xfe(x, w, k, 6);
  return p;
}

__device__ __forceinline__ void store_canonical(int32_t* o, const fe8& x) {
  int32_t l[20];
  fe8_to_limbs20_canonical(x, l);
  int4* o4 = reinterpret_cast<int4*>(o);
#pragma unroll
  for (int i = 0; i < 5; ++i)
    o4[i] = make_int4(l[4 * i], l[4 * i + 1], l[4 * i + 2], l[4 * i + 3]);
}

// The window phase of K2 and K2t on the chunk's table: thread (w, s) sums
// window w over lanes [16 s, 16 s + 16), then the join (q0 + q1) + (q2 +
// q3) in two levels through the exchange, and thread (w, 0) writes the
// canonical limbs.  Every thread of the block reaches every barrier.
__device__ __forceinline__ void window_phase(
    uint4* tbl, const int8_t* dig, int32_t* __restrict__ partials, int b,
    int chunk, int nchunk) {
  const int s = threadIdx.x / WSTRIDE;
  const int w = threadIdx.x - s * WSTRIDE;
  const bool active = w < NWIN;
  const int l0 = s * SUB;
  ge8 acc;
  if (active) {
    const int d0 = dig[l0 * NWIN + w];
    acc = entry(tbl, l0, d0);
    const fe8 nx = fe8_neg(acc.X);
    const fe8 nt = fe8_neg(acc.T);
    if (d0 < 0) {
      acc.X = nx;
      acc.T = nt;
    }
#pragma unroll 1
    for (int l = 1; l < SUB; ++l) {
      const int d = dig[(l0 + l) * NWIN + w];
      acc = ge8_add(acc, entry(tbl, l0 + l, d), d < 0);
    }
  }
  // every table read is done: the exchange may take the table's bytes
  __syncthreads();
  uint4* x = tbl;
#pragma unroll 1
  for (int lvl = 0; lvl < 2; ++lvl) {
    const int mask = (2 << lvl) - 1;  // level 0: pairs (0, 1), (2, 3);
    const int k = s >> (lvl + 1);     // level 1: (0, 2)
    if (active && (s & mask) == (1 << lvl)) put_x(x, w, k, acc);
    __syncthreads();
    if (active && (s & mask) == 0) acc = ge8_add(acc, get_x(x, w, k));
    __syncthreads();
  }
  if (active && s == 0) {
    int32_t* o = partials + (((size_t)b * nchunk + chunk) * NWIN + w) * COORDS;
    store_canonical(o, acc.X);
    store_canonical(o + 20, acc.Y);
    store_canonical(o + 40, acc.Z);
    store_canonical(o + 60, acc.T);
  }
}

// Entries 1..8 of the multiples tables of lanes [lane0, lane0 + CHUNK) of
// batch b into the u32 table, as K2 builds its chunk's and K4
// (build_tables.cu) every R lane's: thread (lane, h), h = 0 or 1, for the
// block's first 2 CHUNK threads.  Step 0: T2 = P + P (both); step 1: T3 =
// T2 + P (h = 0) or T4 = T2 + T2 (h = 1); a barrier; steps 2 and 3 add T4
// to P and T3 (h = 0: T5, T7) or to T2 and T4 (h = 1: T6, T8).  Only the
// running sum `a` lives in registers across steps; the other operand is
// read from the table (P and T2 at step 1 are the thread's own stores, so
// no barrier is needed before it).  points: (B, 4, 20, N) int16; lanes
// past N take the identity.  Every thread of the block calls it (the
// others only pass the barrier); the caller's barrier ends it.
__device__ __forceinline__ void build_table(uint4* tbl,
                                            const int16_t* __restrict__ points,
                                            int b, int lane0, int N) {
  const int tid = threadIdx.x;
  const bool table_thread = tid < 2 * CHUNK;
  const int lane = tid & (CHUNK - 1);
  const int h = (tid >> 6) & 1;
  ge8 a;
  if (table_thread) {
    const int n = lane0 + lane;
    if (n < N) {
      const int16_t* src = points + (size_t)b * COORDS * N + n;
      a.X = fe8_from_limbs20(src, (size_t)N);
      a.Y = fe8_from_limbs20(src + (size_t)20 * N, (size_t)N);
      a.Z = fe8_from_limbs20(src + (size_t)40 * N, (size_t)N);
      a.T = fe8_from_limbs20(src + (size_t)60 * N, (size_t)N);
    } else {
      a = ge8_identity();
    }
    if (!h) put(tbl, 0, lane, a);
  }
#pragma unroll 1
  for (int step = 0; step < 4; ++step) {
    if (step == 2) __syncthreads();
    if (table_thread) {
      if (step >= 2) a = get(tbl, 3, lane);
      const ge8 q = step == 0 ? a
                              : get(tbl, step == 1 ? h : 2 * step - 4 + h,
                                    lane);
      const ge8 r = ge8_add(a, q);
      if (step == 0) {
        if (h) put(tbl, 1, lane, r);
        a = r;
      } else {
        put(tbl, step == 1 ? 2 + h : 2 * step + h, lane, r);
      }
    }
  }
}

// K2.  digits: (B, 17, N) uint8 nibble-packed when `packed`, else (B, 33,
// N) int8.  points: (B, 4, 20, N) int16.  partials: (B, nchunk, 33, 4, 20)
// int32.  Grid (nchunk, B); block THREADS.
__device__ __forceinline__ void k2_body(unsigned char* smem,
                                        const uint8_t* __restrict__ digits,
                                        int packed,
                                        const int16_t* __restrict__ points,
                                        int32_t* __restrict__ partials,
                                        int N, int nchunk) {
  uint4* tbl = (uint4*)smem;
  int8_t* dig = (int8_t*)(smem + TABLE_BYTES);
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int lane0 = chunk * CHUNK;
  load_digits(digits, packed, dig, b, lane0, N);
  build_table(tbl, points, b, lane0, N);
  __syncthreads();
  window_phase(tbl, dig, partials, b, chunk, nchunk);
}

// Four int16 at `p` (any 2-byte alignment), as two words (lanes 0, 1 and
// 2, 3): the aligned 16 bytes holding the first, and the next 16 when the
// four straddle them, shifted into place in registers.
__device__ __forceinline__ void load4(const int16_t* p, uint32_t& o0,
                                      uint32_t& o1) {
  const uintptr_t addr = (uintptr_t)p;
  const uint4* al = (const uint4*)(addr & ~(uintptr_t)15);
  const int m = (int)((addr >> 1) & 7);
  const uint4 v0 = __ldg(al);
  const uint4 v1 = m > 4 ? __ldg(al + 1) : make_uint4(0u, 0u, 0u, 0u);
  const uint32_t w[6] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y};
  const int qw = m >> 1;
  uint32_t x[4], y[3];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = (qw & 2) ? w[i + 2] : w[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) y[i] = (qw & 1) ? x[i + 1] : x[i];
  const int bs = (m & 1) * 16;
  o0 = __funnelshift_r(y[0], y[1], bs);
  o1 = __funnelshift_r(y[1], y[2], bs);
}

// Phase 1 of K2t: entries 1..8 of every lane of the chunk into the u32
// table.  Item (e1, coordinate c, 4-lane group g), e1 fastest: 512 items.
// Lanes [0, n_head) read the head tables, [n_head, N) the R tables, lanes
// past N take the identity.  head: (TH, 9, 4, 20, n_head) int16 from the
// batch's table; rtab: (B, 9, 4, 20, N - n_head) likewise.  Entry 0 of
// either is never read.
__device__ __forceinline__ void copy_tables(uint4* tbl,
                                            const int16_t* __restrict__ head,
                                            int n_head,
                                            const int16_t* __restrict__ rtab,
                                            int lane0, int N) {
  const int n_r = N - n_head;
  for (int item = threadIdx.x; item < NENT * 4 * (CHUNK / 4);
       item += THREADS) {
    const int e1 = item & 7;
    const int c = (item >> 3) & 3;
    const int l0 = (item >> 5) * 4;
    const int n0 = lane0 + l0;
    const size_t row0 = (size_t)(e1 + 1) * COORDS + c * 20;
    const int16_t* src = nullptr;
    size_t stride = 0;
    if (n0 + 4 <= n_head) {
      src = head + row0 * n_head + n0;
      stride = (size_t)n_head;
    } else if (n0 >= n_head && n0 + 4 <= N) {
      src = rtab + row0 * n_r + (n0 - n_head);
      stride = (size_t)n_r;
    }
    if (src != nullptr) {
      uint32_t raw[20][2];
#pragma unroll
      for (int i = 0; i < 20; ++i)
        load4(src + (size_t)i * stride, raw[i][0], raw[i][1]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const fe8 v = fe8_from_limbs20_f([&](int i) {
          const uint32_t word = raw[i][j >> 1];
          return (int32_t)(int16_t)((j & 1) ? word >> 16 : word & 0xffffu);
        });
        put_fe(tbl, e1, l0 + j, 2 * c, v);
      }
    } else {
#pragma unroll 1
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + j;
        fe8 v;
        if (n < n_head) {
          v = fe8_from_limbs20(head + row0 * n_head + n, (size_t)n_head);
        } else if (n < N) {
          v = fe8_from_limbs20(rtab + row0 * n_r + (n - n_head),
                               (size_t)n_r);
        } else {
          // the identity (0 : 1 : 1 : 0)
#pragma unroll
          for (int i = 0; i < 8; ++i) v.v[i] = 0u;
          v.v[0] = (c == 1 || c == 2) ? 1u : 0u;
        }
        put_fe(tbl, e1, l0 + j, 2 * c, v);
      }
    }
  }
}

// K2t.  head_tables: (TH, 9, 4, 20, n_head) int16, batch stride
// head_bstride elements (0 when TH = 1).  r_tables: (B, 9, 4, 20, N -
// n_head) int16.  Grid (nchunk, B); block THREADS.
__device__ __forceinline__ void k2t_body(
    unsigned char* smem, const uint8_t* __restrict__ digits, int packed,
    const int16_t* __restrict__ head_tables, long long head_bstride,
    int n_head, const int16_t* __restrict__ r_tables,
    int32_t* __restrict__ partials, int N, int nchunk) {
  uint4* tbl = (uint4*)smem;
  int8_t* dig = (int8_t*)(smem + TABLE_BYTES);
  const int chunk = blockIdx.x;
  const int b = blockIdx.y;
  const int lane0 = chunk * CHUNK;
  load_digits(digits, packed, dig, b, lane0, N);
  copy_tables(tbl, head_tables + (size_t)b * head_bstride, n_head,
              r_tables + (size_t)b * NTBL * COORDS * (N - n_head), lane0, N);
  __syncthreads();
  window_phase(tbl, dig, partials, b, chunk, nchunk);
}

// The host side of a launch: W must be 33 (every window in one block),
// the block's shared-memory limit and carveout are set (per device, so
// on every launch; the calls are cheap), then the launch.  Returns a
// cudaError_t.
template <typename K, typename... A>
int launch(K kern, int B, int N, int W, void* stream, A... args) {
  if (W != NWIN) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int nchunk = (N + CHUNK - 1) / CHUNK;
  dim3 grid(nchunk, B);
  kern<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(args..., N,
                                                            nchunk);
  return (int)cudaGetLastError();
}

}  // namespace ws8

// One K2 (WS_K2_U32) or K2t (WS_K2T_U32) instantiation: the kernel
// NAME_kernel (every window in one block) and its C entry with the
// signature of window_sums.cuh's, so ops/_cuda.py binds it alike.
#define WS_K2_U32(NAME)                                                      \
  extern "C" __global__ void __launch_bounds__(ws8::THREADS, 3)              \
      NAME##_kernel(const uint8_t* __restrict__ digits, int packed,          \
                    const int16_t* __restrict__ points,                      \
                    int32_t* __restrict__ partials, int N, int nchunk) {     \
    extern __shared__ __align__(16) unsigned char smem[];                    \
    ws8::k2_body(smem, digits, packed, points, partials, N, nchunk);         \
  }                                                                          \
  extern "C" int NAME##_launch(const void* digits, int packed,               \
                               const void* points, void* partials, int B,    \
                               int N, int W, void* stream) {                 \
    return ws8::launch(NAME##_kernel, B, N, W, stream,                       \
                       (const uint8_t*)digits, packed,                       \
                       (const int16_t*)points, (int32_t*)partials);          \
  }

#define WS_K2T_U32(NAME)                                                     \
  extern "C" __global__ void __launch_bounds__(ws8::THREADS, 3)              \
      NAME##_kernel(const uint8_t* __restrict__ digits, int packed,          \
                    const int16_t* __restrict__ head_tables,                 \
                    long long head_bstride, int n_head,                      \
                    const int16_t* __restrict__ r_tables,                    \
                    int32_t* __restrict__ partials, int N, int nchunk) {     \
    extern __shared__ __align__(16) unsigned char smem[];                    \
    ws8::k2t_body(smem, digits, packed, head_tables, head_bstride, n_head,   \
                  r_tables, partials, N, nchunk);                            \
  }                                                                          \
  extern "C" int NAME##_launch(const void* digits, int packed,               \
                               const void* head_tables, int head_batched,    \
                               int n_head, const void* r_tables, void* out,  \
                               int B, int N, int W, void* stream) {          \
    const long long bstride =                                                \
        head_batched ? (long long)ws8::NTBL * ws8::COORDS * n_head : 0;      \
    return ws8::launch(NAME##_kernel, B, N, W, stream,                       \
                       (const uint8_t*)digits, packed,                       \
                       (const int16_t*)head_tables, bstride, n_head,         \
                       (const int16_t*)r_tables, (int32_t*)out);             \
  }
