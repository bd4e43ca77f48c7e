// The MFCC for Hopper, in one launch.
//
// Replaces the TPU kernel `logmel_pallas` (src/repro/kernels/logmel.py),
// which computes the MFCC's tail, out = log(max(P @ fb, 1e-10)) @ dct, on
// power rows that plain code made.  `mfcc_kernel` also computes those
// rows, one block per frame:
//   * it stages with cp.async, all in flight at once, the frame's samples
//     (and the one before them), the window and the FFT twiddles (the
//     front end's group), then the mel band table, the band weights and
//     the DCT (the tail's group, which lands while the FFT runs);
//   * pre-emphasizes (y[t] = x[t] - a*x[t-1], the row's first sample kept
//     as is, each product and difference rounded as the plain version
//     rounds them) and windows the frame, and packs it as the n_fft/2
//     complex points z[n] = v[2n] + i*v[2n+1] of the zero-padded frame,
//     in bit-reversed order in shared memory;
//   * runs an in-place radix-2 FFT over them (log2(n_fft/2) stages, one
//     barrier each), with twiddles made in fp64 on the host;
//   * splits the complex spectrum into the n_fft/2 + 1 bins of the real
//     one and keeps their power in shared memory;
//   * runs the tail (`logmel_tail`), each mel sum over its filter's
//     nonzero band only; only the frame's C coefficients reach device
//     memory.
// `logmel_kernel` runs the same tail on given power rows with every bin
// and the dense filterbank, read through L1/L2.
//
// What bounds it: latency.  One decoding step is R = b*w*8 <= 128
// frames (b slots, w windows), one wave of blocks on the 132 SMs, ~0.25
// MB and ~4 MFLOP: under 0.1 us of either.  The plain pipeline takes
// 13-16 launches; this takes one, and each block waits on device memory
// once (every load is issued up front), then runs from shared memory.
#include <cuda_runtime.h>
#include <stdint.h>
#include "smem.cuh"

namespace {

constexpr int LM_THREADS = 256;

__host__ __device__ __forceinline__ int up4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}

// Copy n floats into shared memory without waiting: 16 bytes a thread
// where both ends are 16-byte aligned, else 4.
__device__ void stage_async(float* dst, const float* src, int n) {
  int i0 = 0;
  if (((uintptr_t)dst | (uintptr_t)src) % 16 == 0) {
    i0 = n & ~3;
    for (int i = 4 * threadIdx.x; i < i0; i += 4 * blockDim.x)
      cp_async16(dst + i, src + i);
  }
  for (int i = i0 + threadIdx.x; i < n; i += blockDim.x)
    cp_async4(dst + i, src + i);
}

// A table entry: from shared memory (STAGED), or read-only through L1/L2.
template <bool STAGED>
__device__ __forceinline__ float table(const float* p) {
  if constexpr (STAGED) return *p;
  else return __ldg(p);
}

// out = log(max(p @ W, 1e-10)) @ dct for the row p (F floats, shared
// memory).  The weight of mel column m at bin f is w[m * wm + (f - lo) *
// wf] for f in its band [lo, hi) = band[m] (null: [0, F)): the packed
// band weights (wm = W, wf = 1) or the dense filterbank (wm = 1, wf = M).
// w and dct lie in shared memory if STAGED, else in device memory.
// Each of the M columns takes blockDim/M threads, each summing a slice
// of the band; the slices are added in a fixed order, and the log-mel row
// stays in shared memory for the DCT, split the same way.  lg_s: M
// floats, part: blockDim floats of shared memory.
template <bool STAGED>
__device__ void logmel_tail(const float* p_s, const int2* band, const float* w,
                            int wm, int wf, const float* dct, float* lg_s,
                            float* part, float* __restrict__ out, int F, int M,
                            int C) {
  const int i = threadIdx.x;
  const int sm = blockDim.x / M;        // threads per mel column (M <= blockDim)
  if (i < M * sm) {
    const int m = i % M, q = i / M;
    int lo = 0, hi = F;
    if (band != nullptr) {
      lo = band[m].x;
      hi = band[m].y;
    }
    const int f0 = lo + q * (hi - lo) / sm, f1 = lo + (q + 1) * (hi - lo) / sm;
    float acc = 0.f;
    for (int f = f0; f < f1; ++f)
      acc = fmaf(p_s[f], table<STAGED>(w + m * wm + (f - lo) * wf), acc);
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
    for (int m = m0; m < m1; ++m)
      acc = fmaf(lg_s[m], table<STAGED>(dct + m * C + c), acc);
    part[i] = acc;
  }
  __syncthreads();
  if (i < C) {
    float y = part[i];
    for (int q = 1; q < sc; ++q) y += part[q * C + i];
    out[i] = y;
  }
}

__global__ void __launch_bounds__(LM_THREADS)
logmel_kernel(const float* __restrict__ P, const float* __restrict__ fb,
              const float* __restrict__ dct, float* __restrict__ out,
              int F, int M, int C) {
  extern __shared__ float smem[];
  float* p_s = smem;                    // F: the power row
  float* lg_s = p_s + F;                // M: the log-mel row
  float* part = lg_s + M;               // LM_THREADS partial sums
  const int r = blockIdx.x;
  for (int f = threadIdx.x; f < F; f += blockDim.x)
    p_s[f] = P[(size_t)r * F + f];
  __syncthreads();
  logmel_tail<false>(p_s, nullptr, fb, 1, M, dct, lg_s, part,
                     out + (size_t)r * C, F, M, C);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Shared memory of `mfcc_kernel`, in floats, each region a multiple of 4
// (16-byte aligned); the host sizes the launch with the same struct.
struct MfccSmem {
  int dct, bw, tw, win, band, x, z, p, lg, part, total;
  __host__ __device__ MfccSmem(int H, int L, int M, int W, int C) {
    dct = 0;                         // M x C DCT
    bw = dct + up4(M * C);           // M x W band weights
    tw = bw + up4(M * W);            // H twiddles (float2)
    win = tw + 2 * H;                // L window
    band = win + up4(L);             // M bands (int2)
    x = band + up4(2 * M);           // 4 + L: [3] the sample before the frame
    z = x + up4(4 + L);              // H complex points (float2)
    p = z + 2 * H;                   // H + 1 power bins
    lg = p + up4(H + 1);             // M log-mel
    part = lg + up4(M);              // LM_THREADS partial sums
    total = part + LM_THREADS;
  }
};

// x: (rows, S) samples; frame f of a row starts at sample f*shift of it.
// tw: the n_fft/2 twiddles exp(-2*pi*i*k/n_fft) as (cos, -sin); band, bw:
// the mel bands and their packed weights (M x W); out: (rows * n_frames,
// C).  H = n_fft/2 = 1 << log2h.
__global__ void __launch_bounds__(LM_THREADS)
mfcc_kernel(const float* __restrict__ x, const float* __restrict__ win,
            const float* __restrict__ tw, const int* __restrict__ band,
            const float* __restrict__ bw, const float* __restrict__ dct,
            float* __restrict__ out, int S, int n_frames, int L, int shift,
            int log2h, int M, int W, int C, float pre) {
  extern __shared__ __align__(16) float smem[];
  const int H = 1 << log2h, F = H + 1;
  const MfccSmem at(H, L, M, W, C);
  const float* x_s = smem + at.x;
  const float* win_s = smem + at.win;
  const float2* tw_s = reinterpret_cast<const float2*>(smem + at.tw);
  float2* z = reinterpret_cast<float2*>(smem + at.z);
  float* p_s = smem + at.p;
  const int frame = blockIdx.x;
  const float* xr = x + (size_t)(frame / n_frames) * S;
  const int s0 = (frame % n_frames) * shift;

  // the front end's group, then the tail's
  stage_async(smem + at.x + 4, xr + s0, L);
  if (s0 > 0 && threadIdx.x == 0) cp_async4(smem + at.x + 3, xr + s0 - 1);
  stage_async(smem + at.win, win, L);
  stage_async(smem + at.tw, tw, 2 * H);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  stage_async(smem + at.band, reinterpret_cast<const float*>(band), 2 * M);
  stage_async(smem + at.bw, bw, M * W);
  stage_async(smem + at.dct, dct, M * C);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  for (int n = threadIdx.x; n < H; n += blockDim.x) {
    float v[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = 2 * n + e;
      float y = 0.f;                    // zero padding past the frame
      if (j < L) {
        y = x_s[4 + j];
        if (s0 + j > 0) y = __fsub_rn(y, __fmul_rn(pre, x_s[3 + j]));
        y = __fmul_rn(y, win_s[j]);
      }
      v[e] = y;
    }
    z[__brev(n) >> (32 - log2h)] = make_float2(v[0], v[1]);
  }
  __syncthreads();

  // radix-2 decimation in time: stage s joins pairs 2^(s-1) apart with
  // the twiddles W_{2^s}^j = W_{n_fft}^{j * H >> (s-1)}
  for (int s = 1; s <= log2h; ++s) {
    const int half = 1 << (s - 1);
    for (int b = threadIdx.x; b < H / 2; b += blockDim.x) {
      const int j = b & (half - 1);
      const int i0 = ((b >> (s - 1)) << s) + j, i1 = i0 + half;
      const float2 t = cmul(z[i1], tw_s[j * (H >> (s - 1))]);
      const float2 u = z[i0];
      z[i0] = make_float2(u.x + t.x, u.y + t.y);
      z[i1] = make_float2(u.x - t.x, u.y - t.y);
    }
    __syncthreads();
  }

  // the real spectrum: X[k] = E[k] + W_{n_fft}^k O[k], with the even- and
  // odd-sample spectra E = (Z[k] + conj Z[H-k]) / 2, O = -i (Z[k] -
  // conj Z[H-k]) / 2 (indices mod H; W^H = -1)
  for (int k = threadIdx.x; k <= H; k += blockDim.x) {
    const float2 a = z[k & (H - 1)], b = z[(H - k) & (H - 1)];
    const float er = 0.5f * (a.x + b.x), ei = 0.5f * (a.y - b.y);
    const float2 o = make_float2(0.5f * (a.y + b.y), -0.5f * (a.x - b.x));
    const float2 ow = cmul(o, k < H ? tw_s[k] : make_float2(-1.f, 0.f));
    const float re = er + ow.x, im = ei + ow.y;
    p_s[k] = re * re + im * im;
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  logmel_tail<true>(p_s, reinterpret_cast<const int2*>(smem + at.band),
              smem + at.bw, W, 1, smem + at.dct, smem + at.lg,
              smem + at.part, out + (size_t)frame * C, F, M, C);
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

// x: (rows, S) f32 samples -> out: (rows, n_frames, C) f32.  n_fft a power
// of two in [4, 4096] and >= L; the caller checks that the tables fit
// them.  Tables beyond the 227 KB of shared memory a block may have (a
// DCT of more than ~200 x 200) are refused by the opt-in.
extern "C" int mfcc_launch(const void* x, const void* win, const void* tw,
                           const void* band, const void* bw, const void* dct,
                           void* out, int rows, int S, int n_frames, int L,
                           int shift, int n_fft, int M, int W, int C,
                           float pre, void* stream) {
  if (rows <= 0) return 0;
  if (n_fft < 4 || n_fft > 4096 || (n_fft & (n_fft - 1)) || L > n_fft ||
      n_frames < 1 || (long long)(n_frames - 1) * shift + L > S ||
      (long long)rows * n_frames > 0x7fffffffLL || M < 1 || M > LM_THREADS ||
      C < 1 || C > LM_THREADS || W < 1)
    return (int)cudaErrorInvalidValue;
  int log2h = 0;
  while ((2 << log2h) < n_fft) ++log2h;
  const size_t smem =
      (size_t)MfccSmem(n_fft / 2, L, M, W, C).total * sizeof(float);
  static size_t allowed = 0;           // dynamic smem opted in so far
  const cudaError_t e = allow_smem(mfcc_kernel, smem, &allowed);
  if (e != cudaSuccess) return (int)e;
  mfcc_kernel<<<rows * n_frames, LM_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)win, (const float*)tw, (const int*)band,
      (const float*)bw, (const float*)dct, (float*)out, S, n_frames, L, shift,
      log2h, M, W, C, pre);
  return (int)cudaGetLastError();
}
