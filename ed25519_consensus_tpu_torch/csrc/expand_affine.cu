// K6 expand_affine: on-device expansion of the affine point wire,
// (B, 2, 20, N) int16 X||Y limbs -> (B, 4, 20, N) int16 extended coordinates
// with Z = 1 and T = X * Y.
//
// Replaces: ed25519_consensus_tpu/ops/msm.py:expand_affine_points (and its
// unbatched form expand_affine_points_single), the XLA expansion the
// affine wire (ED25519_TPU_WIRE=affine) runs inside every dispatch.  Plain
// PyTorch version: ops/msm.py expand_affine_points_plain, one
// torch_field.mul, so the two agree limb for limb.
//
// The int16 store of T is exact: fe_mul maps limbs inside |limb| <= 8191 to
// limbs inside the same bound (the closure proofs of ops/torch_field.py,
// which the JAX package's jnp_field carries too), and a CPU test pins the
// product at the limb extremes.
//
// Bound: one field multiply per lane (~1.4e3 int32 operations) against 80
// bytes read and 160 written: the bytes bound it on this card.  Design: one
// thread per lane, consecutive threads on consecutive lanes of each limb
// plane, so every load and store is coalesced; no shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"

namespace {

__global__ void expand_affine_kernel(const int16_t* __restrict__ pts,
                                     int16_t* __restrict__ out, int B,
                                     int N) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (long long)B * N) return;
  const int b = (int)(lane / N);
  const int n = (int)(lane % N);
  const int16_t* p = pts + (size_t)b * 2 * FE_NLIMBS * N + n;
  fe x, y;
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) {
    x.v[i] = p[(size_t)i * N];
    y.v[i] = p[(size_t)(FE_NLIMBS + i) * N];
  }
  const fe t = fe_mul(x, y);
  int16_t* o = out + (size_t)b * 4 * FE_NLIMBS * N + n;
#pragma unroll
  for (int i = 0; i < FE_NLIMBS; ++i) {
    o[(size_t)(0 * FE_NLIMBS + i) * N] = (int16_t)x.v[i];
    o[(size_t)(1 * FE_NLIMBS + i) * N] = (int16_t)y.v[i];
    o[(size_t)(2 * FE_NLIMBS + i) * N] = (int16_t)(i == 0 ? 1 : 0);
    o[(size_t)(3 * FE_NLIMBS + i) * N] = (int16_t)t.v[i];
  }
}

}  // namespace

extern "C" int expand_affine_launch(const void* pts, void* out, int B, int N,
                                    void* stream) {
  const int threads = 128;
  const long long lanes = (long long)B * N;
  const unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
  expand_affine_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)pts, (int16_t*)out, B, N);
  return (int)cudaGetLastError();
}
