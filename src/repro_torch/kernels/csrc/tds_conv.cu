// Causal strided TDS time convolution with the fused epilogue, for Hopper.
//
// Replaces the TPU kernel `tds_conv_pallas` (src/repro/kernels/tds_conv.py).
// out[b, t, w, co] = relu?(sum_{j<k, c<Cin} x[b, t*stride + j, w, c] *
//                          wt[j, c, co] + bias[co]) (+ res[b, t, w, co])
// in the TDS order: bias, then ReLU, then the residual.
//
// One thread per output element (grid-stride), fp32 FMA accumulation.
// Channel counts are at most 23, far below any tensor-core tile, so the
// k*Cin*Cout weight (at most ~21 KB) sits in shared memory and each
// thread runs a plain k x Cin FMA loop.  Neighbouring threads differ in
// co and read the same x element (a broadcast), so x is read from device
// memory about once per block.  (Measured alternatives, both slower on
// the main path's shapes: weights read through L1 instead of shared
// memory, and four independent FMA chains per thread.)
#include <cuda_runtime.h>
#include "smem.cuh"

namespace {

constexpr int TC_THREADS = 256;

__global__ void __launch_bounds__(TC_THREADS)
tds_conv_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                const float* __restrict__ bias, const float* __restrict__ res,
                float* __restrict__ out, int B, int Tp, int W, int Cin,
                int Cout, int k, int stride, int t_out, int relu) {
  extern __shared__ float smem[];
  float* w_s = smem;                         // k x Cin x Cout
  float* b_s = smem + k * Cin * Cout;        // Cout
  const int nw = k * Cin * Cout;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) w_s[i] = wt[i];
  for (int i = threadIdx.x; i < Cout; i += blockDim.x) b_s[i] = bias[i];
  __syncthreads();

  const size_t total = (size_t)B * t_out * W * Cout;
  const size_t row = (size_t)W * Cin;        // one time step of x
  for (size_t o = (size_t)blockIdx.x * blockDim.x + threadIdx.x; o < total;
       o += (size_t)gridDim.x * blockDim.x) {
    const int co = (int)(o % Cout);
    size_t r = o / Cout;
    const int wc = (int)(r % W);
    r /= W;
    const int t = (int)(r % t_out);
    const int b = (int)(r / t_out);
    const float* xb = x + ((size_t)b * Tp + (size_t)t * stride) * row
                        + (size_t)wc * Cin;
    float acc = 0.f;
    for (int j = 0; j < k; ++j) {
      const float* xj = xb + (size_t)j * row;
      const float* wj = w_s + j * Cin * Cout + co;
      for (int c = 0; c < Cin; ++c) acc = fmaf(__ldg(xj + c), wj[c * Cout], acc);
    }
    float y = acc + b_s[co];
    if (relu) y = fmaxf(y, 0.f);
    if (res != nullptr) y += res[o];
    out[o] = y;
  }
}

}  // namespace

extern "C" int tds_conv_launch(const void* x, const void* wt, const void* bias,
                               const void* res, void* out, int B, int Tp, int W,
                               int Cin, int Cout, int k, int stride, int t_out,
                               int relu, void* stream) {
  const size_t total = (size_t)B * t_out * W * Cout;
  if (total == 0) return 0;
  const size_t smem = ((size_t)k * Cin * Cout + Cout) * sizeof(float);
  static size_t allowed = 0;           // dynamic smem opted in so far
  const cudaError_t e = allow_smem(tds_conv_kernel, smem, &allowed);
  if (e != cudaSuccess) return (int)e;
  size_t blocks = (total + TC_THREADS - 1) / TC_THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;   // grid-stride beyond 16 per SM
  tds_conv_kernel<<<(int)blocks, TC_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)wt, (const float*)bias,
      (const float*)res, (float*)out, B, Tp, W, Cin, Cout, k, stride, t_out,
      relu);
  return (int)cudaGetLastError();
}
