// Row LayerNorm (with an optional bias + residual prologue) and RMSNorm
// for Hopper, fp32 statistics.
//
// Replaces the TPU kernel `norm_pallas` (src/repro/kernels/layernorm.py),
// both kinds.  Both are bound by bytes: each row is read once and
// written once, with a handful of operations per element.
//
//   * layernorm (fp32 rows: the TDS acoustic model, D <= 1840; bf16 rows
//     with fp32 scale and bias: the LM's LayerNorms, musicgen-medium's D =
//     1536): x = (y + add_bias) + res, each addend optional and added in
//     fp32 in that order (fp32 rows only: the TDS FC block's bias and
//     residual, so the LayerNorm's input is bit for bit the plain path's),
//     then the mean, then the mean of squared deviations (the TPU kernel's
//     two-pass statistics), all in fp32, then (x - mu) * rsqrt(var + eps) *
//     scale + bias, rounded once to the row's type (the order of
//     `apply_norm` in src/repro/models/layers.py).  One template over the
//     element type: the row is kept in registers and moved 16 bytes a lane
//     (4 fp32 or 8 bf16 values, one vector a thread up to D = 2048 fp32 /
//     4096 bf16): one block of up to 512 threads per row, so that the
//     16-64 rows of a decoding step still put many warps in flight.  Each
//     warp reduces its count, sum and squared deviations from its own mean
//     with shuffles; one barrier, then every warp combines the warps'
//     triples exactly (Chan et al.) into the row's mean and population
//     variance, lane w taking warp w's.  A row that is not 16-byte aligned,
//     whose D is no multiple of the vector, or that is longer than 8192
//     values takes a scalar block-per-row kernel with the row staged in
//     shared memory as fp32.
//   * rmsnorm (fp32 or bf16 rows, fp32 scale; every norm of the LM,
//     D = 2560): var = mean(x^2) in fp32, then (x * rsqrt(var + eps)) *
//     scale, rounded once to the row's type, the order of `apply_norm`
//     in src/repro/models/layers.py.  The row is kept in registers, not
//     in shared memory, and moved 16 bytes a lane (8 bf16 or 4 fp32;
//     `scale` as float4, which stays in L1/L2): one block of 256
//     threads per row (D = 2560 bf16: 320 vectors, one or two a
//     thread), warp-shuffle sums and one barrier.  A warp per row (4 rows
//     a block, no barrier at all) measured slower on the H100 at every
//     row count from 256 to 6144.  A row that is not 16-byte aligned (D
//     = 7, 129, ...) or longer than 8192 bf16 / 4096 fp32 values takes a
//     scalar block-per-row kernel that reads the row twice (the second
//     read from L1/L2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes <-> VE floats (8 bf16 or 4 fp32)
__device__ __forceinline__ void unpack16(const uint4 w, float* f, float) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack16(const uint4 w, float* f,
                                         __nv_bfloat16) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {      // element 0 is the low half of a word
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack16(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack16(const float* f, __nv_bfloat16) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// x[i] = (y[i] + add_bias[i]) + res[i], the addends optional (fp32 rows)
template <typename T>
__device__ __forceinline__ float ln_input(const T* __restrict__ y,
                                          const float* __restrict__ add_bias,
                                          const float* __restrict__ res,
                                          size_t base, int i) {
  float v = to_float(y[base + i]);
  if (add_bias != nullptr) v = v + __ldg(add_bias + i);
  if (res != nullptr) v = v + res[base + i];
  return v;
}

// Any D and alignment: one block per row, the row staged in shared memory
// as fp32.
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
layernorm_kernel(const T* __restrict__ y,
                 const float* __restrict__ add_bias,
                 const float* __restrict__ res,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ out,
                 int D, float eps) {
  extern __shared__ float xs[];    // the row
  __shared__ float red[33];
  const size_t base = (size_t)blockIdx.x * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = ln_input(y, add_bias, res, base, i);
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
    store(out + base + i, (xs[i] - mu) * inv * scale[i] + bias[i]);
}

constexpr int LV_MAX = 512;        // threads per row, vector kernel

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pairwise sum of a vector's VE values: (f0 + f1) + (f2 + f3) at VE = 4.
template <int VE>
__device__ __forceinline__ float vec_sum(const float* f) {
  if constexpr (VE == 2) {
    return f[0] + f[1];
  } else {
    return vec_sum<VE / 2>(f) + vec_sum<VE / 2>(f + VE / 2);
  }
}

// One block per row, NV 16-byte vectors (4 fp32 or 8 bf16 values) a
// thread, held in registers from the load to the store.  The bias +
// residual prologue exists for fp32 rows only.
template <typename T, int NV>
__global__ void __launch_bounds__(LV_MAX)
layernorm_row_kernel(const T* __restrict__ y,
                     const float* __restrict__ add_bias,
                     const float* __restrict__ res,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ out,
                     int D, float eps) {
  constexpr int VE = 16 / sizeof(T);
  __shared__ float red[3][LV_MAX / 32];
  const int nvec = D / VE;
  const size_t base = (size_t)blockIdx.x * nvec;
  const uint4* yr = reinterpret_cast<const uint4*>(y) + base;
  const float4* sc4 = reinterpret_cast<const float4*>(scale);
  const float4* bi4 = reinterpret_cast<const float4*>(bias);
  float v[NV][VE], sc[NV][VE], bi[NV][VE];
  float n = 0.f, s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = threadIdx.x + blockDim.x * i;
#pragma unroll
    for (int e = 0; e < VE; ++e) v[i][e] = 0.f;
    if (vi < nvec) {
#pragma unroll
      for (int c = 0; c < VE / 4; ++c) {
        const float4 a = __ldg(sc4 + vi * (VE / 4) + c);
        const float4 b = __ldg(bi4 + vi * (VE / 4) + c);
        sc[i][4 * c] = a.x; sc[i][4 * c + 1] = a.y;
        sc[i][4 * c + 2] = a.z; sc[i][4 * c + 3] = a.w;
        bi[i][4 * c] = b.x; bi[i][4 * c + 1] = b.y;
        bi[i][4 * c + 2] = b.z; bi[i][4 * c + 3] = b.w;
      }
      unpack16(yr[vi], v[i], T());
      if constexpr (VE == 4) {
        if (add_bias != nullptr) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(add_bias) +
                                 vi);
          v[i][0] = v[i][0] + a.x; v[i][1] = v[i][1] + a.y;
          v[i][2] = v[i][2] + a.z; v[i][3] = v[i][3] + a.w;
        }
        if (res != nullptr) {
          const float4 r = reinterpret_cast<const float4*>(res)[base + vi];
          v[i][0] = v[i][0] + r.x; v[i][1] = v[i][1] + r.y;
          v[i][2] = v[i][2] + r.z; v[i][3] = v[i][3] + r.w;
        }
      }
      s += vec_sum<VE>(v[i]);
      n += (float)VE;
    }
  }
  // each warp's count, sum and squared deviations from its own mean, then
  // one barrier and the exact combination (Chan et al.) of the two-pass
  // statistics: mu = sum / D, var = sum of (M2 + count * (mean - mu)^2) / D
  const float wn = warp_sum(n), wsum = warp_sum(s);
  const float wmu = wn > 0.f ? wsum / wn : 0.f;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (threadIdx.x + blockDim.x * i < nvec) {
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        const float d = v[i][e] - wmu;
        q = fmaf(d, d, q);
      }
    }
  }
  q = warp_sum(q);
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = wn;
    red[1][warp] = wsum;
    red[2][warp] = q;
  }
  __syncthreads();
  // lane w of every warp takes warp w's triple (at most 16 warps)
  const int lane = threadIdx.x & 31;
  const float cn = lane < nwarps ? red[0][lane] : 0.f;
  const float cs = lane < nwarps ? red[1][lane] : 0.f;
  const float mu = warp_sum(cs) / (float)D;
  float t = 0.f;
  if (cn > 0.f) {
    const float d = cs / cn - mu;
    t = red[2][lane] + cn * d * d;
  }
  const float inv = rsqrtf(warp_sum(t) / (float)D + eps);
  uint4* orow = reinterpret_cast<uint4*>(out) + base;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = threadIdx.x + blockDim.x * i;
    if (vi < nvec) {
      float o[VE];
#pragma unroll
      for (int e = 0; e < VE; ++e)
        o[e] = (v[i][e] - mu) * inv * sc[i][e] + bi[i][e];
      orow[vi] = pack16(o, T());
    }
  }
}

template <typename T, int NV>
int ln_row(const T* y, const float* ab, const float* res, const float* scale,
           const float* bias, T* out, int R, int D, float eps,
           cudaStream_t s) {
  constexpr int VE = 16 / sizeof(T);
  const int per = (D / VE + NV - 1) / NV;            // threads with work
  const int threads = ((per + 31) / 32) * 32;
  layernorm_row_kernel<T, NV><<<R, threads, 0, s>>>(y, ab, res, scale, bias,
                                                    out, D, eps);
  return (int)cudaGetLastError();
}

// LayerNorm of R rows of T (fp32 with the optional addends, or bf16
// without them): up to 8192 values of an aligned row with D a multiple of
// the vector take the row-in-registers kernel, every other row the
// scalar one.
template <typename T>
int layernorm_go(const T* y, const float* ab, const float* res,
                 const float* sc, const float* bi, T* out, int R, int D,
                 float eps, cudaStream_t s) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int MAX_NV = 8192 / VE / LV_MAX;         // 4 fp32, 2 bf16
  const bool vec = ((uintptr_t)y | (uintptr_t)ab | (uintptr_t)res |
                    (uintptr_t)sc | (uintptr_t)bi | (uintptr_t)out) %
                       16 == 0 && D % VE == 0;
  const int nvec = D / VE;
  if (vec && nvec <= MAX_NV * LV_MAX) {
    if (nvec <= LV_MAX) return ln_row<T, 1>(y, ab, res, sc, bi, out, R, D,
                                            eps, s);
    if (nvec <= 2 * LV_MAX)
      return ln_row<T, 2>(y, ab, res, sc, bi, out, R, D, eps, s);
    if constexpr (MAX_NV == 4)
      return ln_row<T, 4>(y, ab, res, sc, bi, out, R, D, eps, s);
  }
  const size_t smem = (size_t)D * sizeof(float);
  static size_t allowed = 0;           // dynamic smem opted in so far
  const cudaError_t e = allow_smem(layernorm_kernel<T>, smem, &allowed,
                                   33 * sizeof(float));   // + `red`
  if (e != cudaSuccess) return (int)e;
  layernorm_kernel<T><<<R, LN_THREADS, smem, s>>>(y, ab, res, sc, bi, out, D,
                                                  eps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// rmsnorm
// ---------------------------------------------------------------------------
constexpr int RN_BLOCK = 256;      // threads per row

// y = (x · inv) · scale for the VE values of vector `vi`, rounded once.
template <typename T>
__device__ __forceinline__ uint4 rms_apply(const float* f, float inv,
                                           const float* __restrict__ scale,
                                           int vi) {
  constexpr int VE = 16 / sizeof(T);
  float y[VE];
#pragma unroll
  for (int c = 0; c < VE / 4; ++c) {
    const float4 sc = __ldg(reinterpret_cast<const float4*>(scale) +
                            vi * (VE / 4) + c);
    y[4 * c + 0] = (f[4 * c + 0] * inv) * sc.x;
    y[4 * c + 1] = (f[4 * c + 1] * inv) * sc.y;
    y[4 * c + 2] = (f[4 * c + 2] * inv) * sc.z;
    y[4 * c + 3] = (f[4 * c + 3] * inv) * sc.w;
  }
  return pack16(y, T());
}

// Sum of v over a block of RN_BLOCK threads with one barrier; `red` holds
// one partial per warp.
__device__ __forceinline__ float block_sum_once(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < RN_BLOCK / 32; ++w) t += red[w];
  return t;
}

// One block per row, NV vectors (16 bytes each) per thread, held in
// registers between the reduction and the output.
template <typename T, int NV>
__global__ void __launch_bounds__(RN_BLOCK)
rmsnorm_row_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ out, int D, float eps) {
  constexpr int VE = 16 / sizeof(T);
  __shared__ float red[RN_BLOCK / 32];
  const int nvec = D / VE;
  const uint4* xr =
      reinterpret_cast<const uint4*>(x + (size_t)blockIdx.x * D);
  uint4* orow = reinterpret_cast<uint4*>(out + (size_t)blockIdx.x * D);
  float f[NV][VE];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = threadIdx.x + RN_BLOCK * i;
    if (vi < nvec) {
      unpack16(xr[vi], f[i], T());
#pragma unroll
      for (int e = 0; e < VE; ++e) ss = fmaf(f[i][e], f[i][e], ss);
    }
  }
  const float inv = rsqrtf(block_sum_once(ss, red) / (float)D + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = threadIdx.x + RN_BLOCK * i;
    if (vi < nvec) orow[vi] = rms_apply<T>(f[i], inv, scale, vi);
  }
}

// Any D and alignment: one block per row, scalar loads, the row read
// twice (the second read hits L1/L2), no shared-memory copy of the row.
template <typename T>
__global__ void __launch_bounds__(RN_BLOCK)
rmsnorm_scalar_kernel(const T* __restrict__ x,
                      const float* __restrict__ scale, T* __restrict__ out,
                      int D, float eps) {
  __shared__ float red[RN_BLOCK / 32];
  const size_t base = (size_t)blockIdx.x * D;
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += RN_BLOCK) {
    const float v = to_float(x[base + i]);
    ss = fmaf(v, v, ss);
  }
  const float inv = rsqrtf(block_sum_once(ss, red) / (float)D + eps);
  for (int i = threadIdx.x; i < D; i += RN_BLOCK)
    store(out + base + i, (to_float(x[base + i]) * inv) * scale[i]);
}

template <typename T, int NV>
int rms_row(const void* x, const void* scale, void* out, int R, int D,
            float eps, cudaStream_t s) {
  rmsnorm_row_kernel<T, NV><<<R, RN_BLOCK, 0, s>>>(
      (const T*)x, (const float*)scale, (T*)out, D, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int rmsnorm_go(const void* x, const void* scale, void* out, int R, int D,
               float eps, cudaStream_t s) {
  constexpr int VE = 16 / sizeof(T);
  const bool vec = ((uintptr_t)x | (uintptr_t)scale | (uintptr_t)out) % 16 ==
                       0 && D % VE == 0;
  const int per_thread = (D / VE + RN_BLOCK - 1) / RN_BLOCK;
  if (vec && per_thread <= 4) {
    if (per_thread <= 1) return rms_row<T, 1>(x, scale, out, R, D, eps, s);
    if (per_thread <= 2) return rms_row<T, 2>(x, scale, out, R, D, eps, s);
    return rms_row<T, 4>(x, scale, out, R, D, eps, s);
  }
  rmsnorm_scalar_kernel<T><<<R, RN_BLOCK, 0, s>>>(
      (const T*)x, (const float*)scale, (T*)out, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// add_bias (D,) and res (R, D) may be null.  bf16: y and out are bf16 and
// both addends null; else fp32.  scale and bias are fp32 either way.
extern "C" int layernorm_launch(const void* y, const void* add_bias,
                                const void* res, const void* scale,
                                const void* bias, void* out, int R, int D,
                                float eps, int bf16, void* stream) {
  if (R <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const float *ab = (const float*)add_bias, *rp = (const float*)res,
              *sc = (const float*)scale, *bi = (const float*)bias;
  if (bf16) {
    if (ab != nullptr || rp != nullptr) return (int)cudaErrorInvalidValue;
    return layernorm_go<__nv_bfloat16>((const __nv_bfloat16*)y, nullptr,
                                       nullptr, sc, bi, (__nv_bfloat16*)out,
                                       R, D, eps, s);
  }
  return layernorm_go<float>((const float*)y, ab, rp, sc, bi, (float*)out, R,
                             D, eps, s);
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
