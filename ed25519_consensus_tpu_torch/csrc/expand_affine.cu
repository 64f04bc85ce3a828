// K6 expand_affine: on-device expansion of the affine point wire,
// (B, 2, 20, N) int16 X||Y limbs -> (B, 4, 20, N) int16 extended coordinates
// with canonical limbs: X, Y, Z = 1 and T = X * Y.
//
// Replaces: ed25519_consensus_tpu/ops/msm.py:expand_affine_points (and its
// unbatched form expand_affine_points_single), the XLA expansion the
// affine wire (ED25519_TPU_WIRE=affine) runs inside every dispatch.  Plain
// PyTorch version: ops/msm.py expand_affine_points_plain, one
// torch_field.mul ending with canonical_limbs20, so the two agree limb for
// limb; against the JAX function they agree as field elements (its limbs
// are canonical_limbs20 of the JAX output's).
//
// Input limbs lie inside fe8_from_limbs20's bound |limb| <= 8191 (the
// wire's contract; a CPU test pins the limb extremes); canonical limbs out
// lie inside [-4096, 4096], so the int16 stores are exact.
//
// Bound: bytes.  80 bytes read and 160 written a lane (240), against one
// fe8_mul, two conversions in and three out (~920 int32 operations): at
// the affine pass's B = 8, N = 10,176, 19.5 MB, 5.8 us at 3.35 TB/s,
// against ~2.2 us of operations.  Design: a block takes 128 lanes of one
// batch row.  It stages the 40 input limb rows of its lanes in shared
// memory with 16-byte loads (16 threads a 256-byte row segment, 8 rows a
// step), one thread a lane converts, multiplies and writes its canonical
// X, Y and T limbs to a second staging area, and the block writes the 80
// output rows with 16-byte stores (Z's rows are constants).  16-byte
// accesses need every row to start 16-byte aligned: N a multiple of 8 and
// both tensors aligned (the main path's N is a multiple of 64); otherwise
// (`vec16` false) the same stages move one int16 a thread, still
// coalesced.  A ragged last tile (N % 128) masks its lanes.
//
// expand_affine_l20 (the lab's expand_affine-l20) is K6's earlier 20-limb
// kernel on csrc/fe25519.cuh: one thread a lane, one fe_mul, X and Y
// written back as they came, T as the product leaves it; its plain version
// is expand_affine_points_plain(arith="l20"), limb for limb with the JAX
// function.  No verdict path launches it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "fe25519_u32.cuh"

// The fewest resident blocks of 128 threads an SM that ptxas must allow
// (tools/ptxas_report.py builds and times each; PERF.md).
#ifndef K6_MIN_BLOCKS
#define K6_MIN_BLOCKS 5
#endif

namespace k6 {

constexpr int LANES = 128;               // lanes a block, one a thread
constexpr int IN_ROWS = 2 * FE_NLIMBS;   // X, Y
constexpr int OUT_ROWS = 4 * FE_NLIMBS;  // X, Y, Z, T
constexpr int STAGED = 3 * FE_NLIMBS;    // X, Y, T: Z is a constant
constexpr int VECS = LANES / 8;          // 16-byte vectors a staged row
constexpr int ROW_STEP = LANES / VECS;   // rows a block moves a step

}  // namespace k6

// K6.  Grid (ceil(N / 128), B); block 128 threads.
extern "C" __global__ void __launch_bounds__(k6::LANES, K6_MIN_BLOCKS)
    expand_affine_kernel(const int16_t* __restrict__ pts,
                         int16_t* __restrict__ out, int N, bool vec16) {
  using namespace k6;
  __shared__ __align__(16) int16_t s_in[IN_ROWS * LANES];
  __shared__ __align__(16) int16_t s_out[STAGED * LANES];
  const int t = threadIdx.x;
  const int lane0 = blockIdx.x * LANES;
  const int b = blockIdx.y;
  const int nl = min(LANES, N - lane0);
  const int16_t* src = pts + (size_t)b * IN_ROWS * N + lane0;
  int16_t* dst = out + (size_t)b * OUT_ROWS * N + lane0;
  const int k = t % VECS;  // this thread's vector of a row

  if (vec16) {
    if (8 * k < nl) {
#pragma unroll 1
      for (int r = t / VECS; r < IN_ROWS; r += ROW_STEP)
        reinterpret_cast<uint4*>(s_in + r * LANES)[k] =
            __ldg(reinterpret_cast<const uint4*>(src + (size_t)r * N) + k);
    }
  } else if (t < nl) {
#pragma unroll 1
    for (int r = 0; r < IN_ROWS; ++r)
      s_in[r * LANES + t] = src[(size_t)r * N + t];
  }
  __syncthreads();

  if (t < nl) {
    const fe8 x = fe8_from_limbs20_f(
        [&](int i) { return (int32_t)s_in[i * LANES + t]; });
    const fe8 y = fe8_from_limbs20_f(
        [&](int i) { return (int32_t)s_in[(FE_NLIMBS + i) * LANES + t]; });
    int32_t l[FE_NLIMBS];
    fe8_to_limbs20_canonical(x, l);
#pragma unroll
    for (int i = 0; i < FE_NLIMBS; ++i) s_out[i * LANES + t] = (int16_t)l[i];
    fe8_to_limbs20_canonical(y, l);
#pragma unroll
    for (int i = 0; i < FE_NLIMBS; ++i)
      s_out[(FE_NLIMBS + i) * LANES + t] = (int16_t)l[i];
    fe8_to_limbs20_canonical(fe8_mul(x, y), l);
#pragma unroll
    for (int i = 0; i < FE_NLIMBS; ++i)
      s_out[(2 * FE_NLIMBS + i) * LANES + t] = (int16_t)l[i];
  }
  __syncthreads();

  // Output row r: X, Y (staged rows 0..39), Z = (1, 0, ..., 0), T (staged
  // rows 40..59).
  if (vec16) {
    if (8 * k < nl) {
#pragma unroll 1
      for (int r = t / VECS; r < OUT_ROWS; r += ROW_STEP) {
        uint4 q;
        if (r < 2 * FE_NLIMBS || r >= 3 * FE_NLIMBS) {
          const int s = r < 2 * FE_NLIMBS ? r : r - FE_NLIMBS;
          q = reinterpret_cast<const uint4*>(s_out + s * LANES)[k];
        } else {
          const uint32_t z = r == 2 * FE_NLIMBS ? 0x00010001u : 0u;
          q = make_uint4(z, z, z, z);
        }
        reinterpret_cast<uint4*>(dst + (size_t)r * N)[k] = q;
      }
    }
  } else if (t < nl) {
#pragma unroll 1
    for (int r = 0; r < OUT_ROWS; ++r) {
      int16_t v;
      if (r < 2 * FE_NLIMBS || r >= 3 * FE_NLIMBS)
        v = s_out[(r < 2 * FE_NLIMBS ? r : r - FE_NLIMBS) * LANES + t];
      else
        v = r == 2 * FE_NLIMBS ? 1 : 0;
      dst[(size_t)r * N + t] = v;
    }
  }
}

extern "C" int expand_affine_launch(const void* pts, void* out, int B, int N,
                                    void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      expand_affine_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const bool vec16 = N % 8 == 0 && (uintptr_t)pts % 16 == 0 &&
                     (uintptr_t)out % 16 == 0;
  dim3 grid((N + k6::LANES - 1) / k6::LANES, B);
  expand_affine_kernel<<<grid, k6::LANES, 0, (cudaStream_t)stream>>>(
      (const int16_t*)pts, (int16_t*)out, N, vec16);
  return (int)cudaGetLastError();
}

// -- the 20-limb K6 (the lab's expand_affine-l20) ----------------------------
//
// One thread per lane, consecutive threads on consecutive lanes of each
// limb plane; T = fe_mul(X, Y) stays inside |limb| <= 8191 (the closure
// proofs of ops/torch_field.py), so its int16 store is exact.

extern "C" __global__ void __launch_bounds__(128)
    expand_affine_l20_kernel(const int16_t* __restrict__ pts,
                             int16_t* __restrict__ out, int B, int N) {
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

extern "C" int expand_affine_l20_launch(const void* pts, void* out, int B,
                                        int N, void* stream) {
  const int threads = 128;
  const long long lanes = (long long)B * N;
  const unsigned blocks = (unsigned)((lanes + threads - 1) / threads);
  expand_affine_l20_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int16_t*)pts, (int16_t*)out, B, N);
  return (int)cudaGetLastError();
}
