// K1 expand_compressed: on-device ZIP215 point expansion from the 33-byte
// compressed wire, (B, 33, N) uint8 -> (B, 4, 20, N) int16 extended
// coordinates.
//
// Replaces: ed25519_consensus_tpu/ops/jnp_decompress.py:expand_compressed_points
// (XLA, with decompress_block / pow22523 / unpack_y_limbs).  Plain PyTorch
// version: ops/torch_decompress.py expand_compressed_points_plain; the two
// agree limb for limb, and that one agrees limb for limb with the JAX
// function.
//
// Wire: rows 0..31 are the little-endian y encoding bytes (bit 255 ignored;
// the sign is folded into the hint), row 32 the hint byte (bit0 = flip:
// multiply the candidate root by sqrt(-1); bit1 = neg: negate).  The host
// computed both bits in its own decompression; here they are data, applied
// as arithmetic, never accept/reject logic.  Non-canonical y >= p works
// unchanged: balanced-limb math is congruent mod p.
//
// Bound: int32 multiply-adds.  272 field products per point, 254 of them
// squarings (fe_sq: 210 products instead of 400; 251 in the pow22523
// ladder), about 1e3 int32 operations each with the carries, against 33
// bytes read and 160 bytes written per point.  Design: one thread per
// lane, the whole chain in registers with no shared memory and no
// synchronisation; consecutive threads read and write consecutive bytes of
// each wire row and limb plane, so every access is coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"

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

__global__ void expand_compressed_kernel(const uint8_t* __restrict__ wire,
                                         int16_t* __restrict__ out, int B,
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

}  // namespace

extern "C" int expand_compressed_launch(const void* wire, void* out, int B,
                                        int N, void* stream) {
  const int threads = 128;
  const long long lanes = (long long)B * N;
  const unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
  expand_compressed_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)wire, (int16_t*)out, B, N);
  return (int)cudaGetLastError();
}
