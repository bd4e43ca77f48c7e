// Fused MFCC tail for Hopper: out = log(max(P @ fb, 1e-10)) @ dct.
//
// Replaces the TPU kernel `logmel_pallas` (src/repro/kernels/logmel.py).
// One block per power row: the row is staged in shared memory; the mel
// sums are split over the block (each of the M mel columns takes
// blockDim/M threads, each summing a slice of the F bins, with coalesced
// reads of fb across the mel columns), the slices are added in a fixed
// order, and the log-clamped mel row stays in shared memory for the DCT,
// split the same way.  Only the (R, C) result reaches device memory.
// fb (257 x 80) and dct (80 x 80) are read through L1/L2, where every
// block finds them.
#include <cuda_runtime.h>
#include "smem.cuh"

namespace {

constexpr int LM_THREADS = 256;

__global__ void __launch_bounds__(LM_THREADS)
logmel_kernel(const float* __restrict__ P, const float* __restrict__ fb,
              const float* __restrict__ dct, float* __restrict__ out,
              int F, int M, int C) {
  extern __shared__ float smem[];
  float* p_s = smem;                    // F: the power row
  float* lg_s = p_s + F;                // M: the log-mel row
  float* part = lg_s + M;               // LM_THREADS partial sums
  const int r = blockIdx.x;
  const int i = threadIdx.x;
  for (int f = i; f < F; f += blockDim.x) p_s[f] = P[(size_t)r * F + f];
  __syncthreads();

  const int sm = blockDim.x / M;        // threads per mel column (M <= blockDim)
  if (i < M * sm) {
    const int m = i % M, q = i / M;
    const int f0 = q * F / sm, f1 = (q + 1) * F / sm;
    float acc = 0.f;
    for (int f = f0; f < f1; ++f) acc = fmaf(p_s[f], __ldg(fb + f * M + m), acc);
    part[i] = acc;
  }
  __syncthreads();
  if (i < M) {
    float mel = part[i];
    for (int q = 1; q < sm; ++q) mel += part[q * M + i];
    lg_s[i] = logf(fmaxf(mel, 1e-10f));
  }
  __syncthreads();

  const int sc = blockDim.x / C;        // threads per output column
  if (i < C * sc) {
    const int c = i % C, q = i / C;
    const int m0 = q * M / sc, m1 = (q + 1) * M / sc;
    float acc = 0.f;
    for (int m = m0; m < m1; ++m) acc = fmaf(lg_s[m], __ldg(dct + m * C + c), acc);
    part[i] = acc;
  }
  __syncthreads();
  if (i < C) {
    float y = part[i];
    for (int q = 1; q < sc; ++q) y += part[q * C + i];
    out[(size_t)r * C + i] = y;
  }
}

}  // namespace

extern "C" int logmel_launch(const void* P, const void* fb, const void* dct,
                             void* out, int R, int F, int M, int C,
                             void* stream) {
  if (R <= 0) return 0;
  if (M < 1 || M > LM_THREADS || C < 1 || C > LM_THREADS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(F + M + LM_THREADS) * sizeof(float);
  static size_t allowed = 0;           // dynamic smem opted in so far
  const cudaError_t e = allow_smem(logmel_kernel, smem, &allowed);
  if (e != cudaSuccess) return (int)e;
  logmel_kernel<<<R, LM_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)P, (const float*)fb, (const float*)dct, (float*)out,
      F, M, C);
  return (int)cudaGetLastError();
}
