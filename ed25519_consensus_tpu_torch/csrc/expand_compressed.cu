// K1 expand_compressed: on-device ZIP215 point expansion from the 33-byte
// compressed wire, (B, 33, N) uint8 -> (B, 4, 20, N) int16 extended
// coordinates with canonical limbs and Z = 1.
//
// Replaces: ed25519_consensus_tpu/ops/jnp_decompress.py:expand_compressed_points
// (XLA, with decompress_block / pow22523 / unpack_y_limbs).  Plain PyTorch
// version: ops/torch_decompress.py expand_compressed_points_plain, the JAX
// function's 20-limb chain in PyTorch ending with canonical_limbs20; the
// kernel equals it limb for limb, and ops/fe_u32.py expand_lane models this
// body for one lane.
//
// Wire: rows 0..31 are the little-endian y encoding bytes (bit 255 ignored;
// the sign is folded into the hint), row 32 the hint byte (bit0 = flip:
// multiply the candidate root by sqrt(-1); bit1 = neg: negate).  The host
// computed both bits in its own decompression; here they are data, applied
// as arithmetic, never accept/reject logic.  The 32 bytes are y's 8 words
// directly (bit 255 masked); a non-canonical y >= p is a weak value below
// 2^256 and works unchanged.  The x = 0 encodings with the sign bit set
// give fe8_neg(0) = 0: canonical 0 whichever neg bit the host sent.
//
// Bound: int32 operations.  272 field products a lane, 254 of them
// squarings (fe8_sq: 36 products and ~157 operations, against fe8_mul's
// 64 and ~227), against 33 bytes read and 160 written a lane.  Design: one
// thread a lane, the whole chain in registers (fe25519_u32.cuh), no shared
// memory and no synchronisation; consecutive threads read and write
// consecutive bytes of each wire row and limb plane, so every access is
// coalesced.  A lane's ~272 products are one dependent chain, so latency
// is hidden only across lanes: K1_MIN_BLOCKS holds ptxas to the registers
// that keep the stacked grid (B = 8, N = 12,288: 3,072 warps) resident in
// about one wave (tools/ptxas_report.py prints the registers, spills and
// resident warps; PERF.md).  At verify_gpu's B = 1 (318 warps, ~2.4 an
// SM) one lane's chain sets the time.
//
// expand_compressed_l20 (the lab's expand_compressed-l20) is K1's earlier
// 20-limb kernel on csrc/fe25519.cuh: fe_sq for the squarings (210
// products instead of 400), the limbs as the JAX function leaves them; its
// plain version is expand_compressed_points_plain(arith="l20"), limb for
// limb.  No verdict path launches it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "fe25519_u32.cuh"

#ifndef K1_THREADS
#define K1_THREADS 128
#endif
// The fewest resident blocks of K1_THREADS an SM that ptxas must allow:
// 6 holds it to 80 registers, no spill, 24 warps an SM, 3,168 on the card,
// so the stacked grid's 3,072 warps run in one wave (at 1 to 5: 94
// registers, 20 warps; at 8: 64 registers and 48 B of spills; ptxas on an
// H100, PERF.md).
#ifndef K1_MIN_BLOCKS
#define K1_MIN_BLOCKS 6
#endif

namespace {

// d and sqrt(-1) mod p, least significant word first (ops/fe_u32.py
// D_WORDS, SQRTM1_WORDS).
__device__ __constant__ uint32_t FE8_D[8] = {
    0x135978a3u, 0x75eb4dcau, 0x4141d8abu, 0x00700a4du,
    0x7779e898u, 0x8cc74079u, 0x2b6ffe73u, 0x52036ceeu};
__device__ __constant__ uint32_t FE8_SQRTM1[8] = {
    0x4a0ea0b0u, 0xc4ee1b27u, 0xad2fe478u, 0x2f431806u,
    0x3dfbd7a7u, 0x2b4d0099u, 0x4fc1df0bu, 0x2b832480u};

__device__ fe8 fe8_sqn(fe8 x, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = fe8_sq(x);
  return x;
}

// z^((p-5)/8) = z^(2^252 - 3): the 2^k - 1 ladder of
// jnp_decompress.pow22523 (fe_u32.fe8_pow22523).
__device__ fe8 fe8_pow22523(const fe8& z) {
  fe8 t0 = fe8_sq(z);            // z^2
  fe8 t1 = fe8_sqn(t0, 2);       // z^8
  t1 = fe8_mul(t1, z);           // z^9
  t0 = fe8_mul(t0, t1);          // z^11
  t0 = fe8_sq(t0);               // z^22
  t0 = fe8_mul(t1, t0);          // z^(2^5-1)
  t1 = fe8_sqn(t0, 5);
  t0 = fe8_mul(t1, t0);          // z^(2^10-1)
  t1 = fe8_sqn(t0, 10);
  t1 = fe8_mul(t1, t0);          // z^(2^20-1)
  fe8 t2 = fe8_sqn(t1, 20);
  t1 = fe8_mul(t2, t1);          // z^(2^40-1)
  t1 = fe8_sqn(t1, 10);
  t0 = fe8_mul(t1, t0);          // z^(2^50-1)
  t1 = fe8_sqn(t0, 50);
  t1 = fe8_mul(t1, t0);          // z^(2^100-1)
  t2 = fe8_sqn(t1, 100);
  t1 = fe8_mul(t2, t1);          // z^(2^200-1)
  t1 = fe8_sqn(t1, 50);
  t0 = fe8_mul(t1, t0);          // z^(2^250-1)
  t0 = fe8_sqn(t0, 2);           // z^(2^252-4)
  return fe8_mul(t0, z);         // z^(2^252-3)
}

// One coordinate's canonical limbs as an int16 limb plane of N lanes.
__device__ __forceinline__ void store_canonical(int16_t* o, const fe8& a,
                                                int N) {
  int32_t l[20];
  fe8_to_limbs20_canonical(a, l);
#pragma unroll
  for (int i = 0; i < 20; ++i) o[(size_t)i * N] = (int16_t)l[i];
}

}  // namespace

extern "C" __global__ void __launch_bounds__(K1_THREADS, K1_MIN_BLOCKS)
    expand_compressed_kernel(const uint8_t* __restrict__ wire,
                             int16_t* __restrict__ out, int B, int N) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (long long)B * N) return;
  const int b = (int)(lane / N);
  const int n = (int)(lane % N);
  const uint8_t* w = wire + (size_t)b * 33 * N + n;

  fe8 y;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    y.v[k] = (uint32_t)w[(size_t)(4 * k) * N]
             | (uint32_t)w[(size_t)(4 * k + 1) * N] << 8
             | (uint32_t)w[(size_t)(4 * k + 2) * N] << 16
             | (uint32_t)w[(size_t)(4 * k + 3) * N] << 24;
  y.v[7] &= 0x7fffffffu;  // bit 255 is the sign slot, not y
  const uint32_t hint = w[(size_t)32 * N];

  fe8 one, d, m;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    one.v[i] = i == 0;
    d.v[i] = FE8_D[i];
    m.v[i] = (hint & 1u) ? FE8_SQRTM1[i] : one.v[i];
  }
  const fe8 yy = fe8_sq(y);
  const fe8 u = fe8_sub(yy, one);
  const fe8 v = fe8_add(fe8_mul(yy, d), one);
  const fe8 v3 = fe8_mul(fe8_sq(v), v);
  const fe8 v7 = fe8_mul(fe8_sq(v3), v);
  const fe8 uv3 = fe8_mul(u, v3);
  fe8 r = fe8_mul(uv3, fe8_pow22523(fe8_mul(u, v7)));  // candidate root
  r = fe8_mul(r, m);                                    // flip: sqrt(-1)
  const fe8 nr = fe8_neg(r);
  fe8 x;
#pragma unroll
  for (int i = 0; i < 8; ++i) x.v[i] = (hint & 2u) ? nr.v[i] : r.v[i];
  const fe8 t = fe8_mul(x, y);

  int16_t* o = out + (size_t)b * 80 * N + n;
  store_canonical(o, x, N);
  store_canonical(o + (size_t)20 * N, y, N);
#pragma unroll
  for (int i = 0; i < 20; ++i) o[(size_t)(40 + i) * N] = i == 0;
  store_canonical(o + (size_t)60 * N, t, N);
}

// -- the 20-limb kernel (the lab's expand_compressed-l20) --------------------

namespace {

__device__ fe fe_sqn(fe x, int n) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) x = fe_sq(x);
  return x;
}

// z^((p-5)/8) = z^(2^252 - 3): the 2^k - 1 ladder of jnp_decompress.pow22523.
__device__ fe fe_pow22523(const fe& z) {
  fe t0 = fe_sq(z);            // z^2
  fe t1 = fe_sqn(t0, 2);       // z^8
  t1 = fe_mul(t1, z);          // z^9
  t0 = fe_mul(t0, t1);         // z^11
  t0 = fe_sq(t0);              // z^22
  t0 = fe_mul(t1, t0);         // z^(2^5-1)
  t1 = fe_sqn(t0, 5);
  t0 = fe_mul(t1, t0);         // z^(2^10-1)
  t1 = fe_sqn(t0, 10);
  t1 = fe_mul(t1, t0);         // z^(2^20-1)
  fe t2 = fe_sqn(t1, 20);
  t1 = fe_mul(t2, t1);         // z^(2^40-1)
  t1 = fe_sqn(t1, 10);
  t0 = fe_mul(t1, t0);         // z^(2^50-1)
  t1 = fe_sqn(t0, 50);
  t1 = fe_mul(t1, t0);         // z^(2^100-1)
  t2 = fe_sqn(t1, 100);
  t1 = fe_mul(t2, t1);         // z^(2^200-1)
  t1 = fe_sqn(t1, 50);
  t0 = fe_mul(t1, t0);         // z^(2^250-1)
  t0 = fe_sqn(t0, 2);          // z^(2^252-4)
  return fe_mul(t0, z);        // z^(2^252-3)
}

}  // namespace

extern "C" __global__ void expand_compressed_l20_kernel(
    const uint8_t* __restrict__ wire, int16_t* __restrict__ out, int B,
    int N) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (long long)B * N) return;
  const int b = (int)(lane / N);
  const int n = (int)(lane % N);
  const uint8_t* w = wire + (size_t)b * 33 * N + n;

  uint32_t by[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) by[k] = w[(size_t)k * N];
  by[31] &= 0x7F;  // bit 255 is the sign slot, not y
  fe y;
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) {
    const int bit0 = 13 * i;
    const int k = bit0 >> 3;
    uint32_t v = by[k];
    if (k + 1 < 32) v |= by[k + 1] << 8;
    if (k + 2 < 32) v |= by[k + 2] << 16;
    y.v[i] = (int32_t)((v >> (bit0 & 7)) & 0x1FFF);
  }
  const int hint = w[(size_t)32 * N];

  const fe one = fe_small(1);
  const fe yy = fe_sq(y);
  const fe u = fe_sub(yy, one);
  const fe v = fe_add(fe_mul(yy, fe_const(FE_D)), one);
  const fe v3 = fe_mul(fe_sq(v), v);
  const fe v7 = fe_mul(fe_sq(v3), v);
  const fe t1 = fe_pow22523(fe_mul(u, v7));
  fe r = fe_mul(fe_mul(u, v3), t1);  // candidate root
  if (hint & 1) r = fe_mul(r, fe_const(FE_SQRTM1));
  const fe x = (hint & 2) ? fe_sub(fe_small(0), r) : r;
  const fe t = fe_mul(x, y);

  int16_t* o = out + (size_t)b * 4 * FE_NLIMBS * N + n;
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) {
    o[(size_t)(0 * FE_NLIMBS + i) * N] = (int16_t)x.v[i];
    o[(size_t)(1 * FE_NLIMBS + i) * N] = (int16_t)y.v[i];
    o[(size_t)(2 * FE_NLIMBS + i) * N] = (int16_t)one.v[i];
    o[(size_t)(3 * FE_NLIMBS + i) * N] = (int16_t)t.v[i];
  }
}

extern "C" int expand_compressed_launch(const void* wire, void* out, int B,
                                        int N, void* stream) {
  const long long lanes = (long long)B * N;
  const unsigned blocks = (unsigned)((lanes + K1_THREADS - 1) / K1_THREADS);
  expand_compressed_kernel<<<blocks, K1_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)wire, (int16_t*)out, B, N);
  return (int)cudaGetLastError();
}

extern "C" int expand_compressed_l20_launch(const void* wire, void* out,
                                            int B, int N, void* stream) {
  const int threads = 128;
  const long long lanes = (long long)B * N;
  const unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
  expand_compressed_l20_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)wire, (int16_t*)out, B, N);
  return (int)cudaGetLastError();
}
