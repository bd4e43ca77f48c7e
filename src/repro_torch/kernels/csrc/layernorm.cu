// Row LayerNorm and RMSNorm for Hopper, fp32 statistics.
//
// Replaces the TPU kernel `norm_pallas` (src/repro/kernels/layernorm.py),
// both kinds.  One block per row (D <= a few thousand): the row is read
// from device memory once into shared memory as fp32, the statistics are
// reduced with warp shuffles plus a shared-memory pass, and the
// normalised row is written once.
//   * layernorm (fp32 rows): the mean, then the mean of squared
//     deviations (the same two-pass statistics as the TPU kernel), then
//     (x - mu) * rsqrt(var + eps) * scale + bias.
//   * rmsnorm (fp32 or bf16 rows, fp32 scale): var = mean(x^2), then
//     (x * rsqrt(var + eps)) * scale, cast to the row's type last, the
//     order of `apply_norm` in src/repro/models/layers.py.
// Both are bound by bytes: each row is read once and written once.
#include <cuda_bf16.h>
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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int D, float eps) {
  extern __shared__ float xs[];    // the row, as fp32
  __shared__ float red[33];
  const size_t base = (size_t)blockIdx.x * D;
  float q = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = to_float(x[base + i]);
    xs[i] = v;
    q = fmaf(v, v, q);
  }
  const float var = block_sum(q, red) / (float)D;
  const float inv = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    store(out + base + i, (xs[i] * inv) * scale[i]);
}

template <typename T>
int rmsnorm_go(const void* x, const void* scale, void* out, int R, int D,
               float eps, cudaStream_t stream) {
  const size_t smem = (size_t)D * sizeof(float);
  static size_t allowed = 0;           // dynamic smem opted in so far
  const cudaError_t e = allow_smem(rmsnorm_kernel<T>, smem, &allowed);
  if (e != cudaSuccess) return (int)e;
  rmsnorm_kernel<T><<<R, LN_THREADS, smem, stream>>>(
      (const T*)x, (const float*)scale, (T*)out, D, eps);
  return (int)cudaGetLastError();
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

// bf16: x and out are bf16, else fp32; scale is fp32 either way.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int R, int D, float eps, int bf16,
                              void* stream) {
  if (R <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) return rmsnorm_go<__nv_bfloat16>(x, scale, out, R, D, eps, s);
  return rmsnorm_go<float>(x, scale, out, R, D, eps, s);
}
