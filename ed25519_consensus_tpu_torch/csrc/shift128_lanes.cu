// K7 shift128_lanes: [2^128]P, in place, for every lane of K1's output
// whose compressed-wire hint byte has bit 2 set, (B, 33, N) uint8 wire +
// (B, 4, 20, N) int16 extended points -> the same points tensor, flagged
// lanes replaced by [2^128]P in canonical limbs (projective: Z as the
// doublings leave it), the others untouched.
//
// Replaces no TPU kernel.  It moves onto the card the host's [2^128]A a
// fresh verification key needs for the device MSM's 128-bit scalar split
// (batch.py `_shift128_for_key`, as in the JAX package: 128 doublings,
// then an inversion and a compression with its hint, per key).  The
// host now sends the key's own encoding in the split-high lane with
// hint bit 2 set; K1 expands it like any lane (it reads bits 0 and 1
// only), and this kernel doubles it 128 times right after K1, on the same
// stream.  K2 and K4 take the general ge8_add, so a projective point
// needs no inversion.  Plain PyTorch version: ops/torch_decompress.py
// shift128_lanes_plain (torch_edwards.point_double, the same formula, so
// the same residues, then canonical limbs); ops/fe_u32.py shift128_lane
// models this body for one lane, instruction for instruction.
//
// Exact for every input K1 accepts: the doubling (dbl-2008-hwcd, a = -1)
// is complete on Edwards25519, so non-canonical y, the small-order points
// and the identity double like any other point; no data-dependent branch
// beyond the flag.
//
// Bound: int32 operations.  128 doublings a flagged lane, each 4 fe8_sq
// and 4 fe8_mul (the T product is kept on every step, so a step is the
// same work as the next) and 7 additions, plus the conversions (3 in, 4
// out); 80 + 1 bytes read and 160 written a flagged lane, 1 byte an
// unflagged one.  A lane's doublings are one dependent chain: one thread a
// lane, the chain in registers (fe25519_u32.cuh), no shared memory.  The
// flagged lanes sit together (the split-high lanes of batch 0 of a
// dispatch), so small blocks spread them over the most SMs; unflagged
// lanes return after one byte.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519_u32.cuh"

#ifndef K7_THREADS
#define K7_THREADS 64
#endif

namespace {

// The flag in the wire's hint byte (row 32): bits 0 and 1 are K1's.
constexpr uint32_t SHIFT128_FLAG = 4u;
constexpr int SHIFT128_DOUBLINGS = 128;

__device__ __forceinline__ void store_canonical(int16_t* o, const fe8& a,
                                                int N) {
  int32_t l[20];
  fe8_to_limbs20_canonical(a, l);
#pragma unroll
  for (int i = 0; i < 20; ++i) o[(size_t)i * N] = (int16_t)l[i];
}

}  // namespace

extern "C" __global__ void __launch_bounds__(K7_THREADS)
    shift128_lanes_kernel(const uint8_t* __restrict__ wire,
                          int16_t* __restrict__ pts, int B, int N) {
  // 32-bit lane arithmetic (the launch refuses 2^31 lanes or more), as
  // K1's: a 64-bit division would compile to a float reciprocal estimate.
  const unsigned lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (unsigned)B * (unsigned)N) return;
  const int b = (int)(lane / (unsigned)N);
  const int n = (int)(lane - (unsigned)b * (unsigned)N);
  if (!(wire[((size_t)b * 33 + 32) * N + n] & SHIFT128_FLAG)) return;

  int16_t* o = pts + (size_t)b * 80 * N + n;
  ge8 p;
  p.X = fe8_from_limbs20(o, N);
  p.Y = fe8_from_limbs20(o + (size_t)20 * N, N);
  p.Z = fe8_from_limbs20(o + (size_t)40 * N, N);
#pragma unroll
  for (int i = 0; i < 8; ++i) p.T.v[i] = 0u;  // not read by ge8_dbl
#pragma unroll 1
  for (int i = 0; i < SHIFT128_DOUBLINGS; ++i) p = ge8_dbl(p);
  store_canonical(o, p.X, N);
  store_canonical(o + (size_t)20 * N, p.Y, N);
  store_canonical(o + (size_t)40 * N, p.Z, N);
  store_canonical(o + (size_t)60 * N, p.T, N);
}

extern "C" int shift128_lanes_launch(const void* wire, void* pts, int B,
                                     int N, void* stream) {
  const long long lanes = (long long)B * N;
  if (lanes >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((lanes + K7_THREADS - 1) / K7_THREADS);
  shift128_lanes_kernel<<<blocks, K7_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)wire, (int16_t*)pts, B, N);
  return (int)cudaGetLastError();
}
