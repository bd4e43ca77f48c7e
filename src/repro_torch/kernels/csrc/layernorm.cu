// Row LayerNorm for Hopper: fp32 two-pass statistics, then the affine step.
//
// Replaces the TPU kernel `norm_pallas(kind="layernorm")`
// (src/repro/kernels/layernorm.py).  One block per row (D <= a few
// thousand): the row is read from device memory once into shared memory,
// the mean and then the mean of squared deviations are reduced with warp
// shuffles plus a shared-memory pass (the same two-pass statistics as the
// TPU kernel), and the normalised, scaled and shifted row is written once.
#include <cuda_runtime.h>
#include "smem.cuh"

namespace {

constexpr int LN_THREADS = 256;

// Sum of v over the block; every thread gets the result.  `red` holds
// one partial per warp plus the broadcast slot.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    v = lane < nwarps ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const float out = red[32];
  __syncthreads();                 // `red` is reused by the next call
  return out;
}

__global__ void __launch_bounds__(LN_THREADS)
layernorm_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int D, float eps) {
  extern __shared__ float xs[];    // the row
  __shared__ float red[33];
  const size_t base = (size_t)blockIdx.x * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = x[base + i];
    xs[i] = v;
    s += v;
  }
  const float mu = block_sum(s, red) / (float)D;
  float q = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float d = xs[i] - mu;
    q = fmaf(d, d, q);
  }
  const float var = block_sum(q, red) / (float)D;
  const float inv = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    out[base + i] = (xs[i] - mu) * inv * scale[i] + bias[i];
}

}  // namespace

extern "C" int layernorm_launch(const void* x, const void* scale,
                                const void* bias, void* out, int R, int D,
                                float eps, void* stream) {
  if (R <= 0) return 0;
  const size_t smem = (size_t)D * sizeof(float);
  static size_t allowed = 0;           // dynamic smem opted in so far
  const cudaError_t e = allow_smem(layernorm_kernel, smem, &allowed);
  if (e != cudaSuccess) return (int)e;
  layernorm_kernel<<<R, LN_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)scale, (const float*)bias, (float*)out,
      D, eps);
  return (int)cudaGetLastError();
}
