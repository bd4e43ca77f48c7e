// Forward flash attention for Hopper: online softmax in fp32, causal and
// sliding-window masks, fully masked kv tiles skipped, GQA native.
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py).  q (B, H, Sq, D), k and v
// (B, K, Skv, D) with K | H, all contiguous, bf16 or fp32; query head h
// reads kv head h / (H / K).  q positions are right-aligned to the end
// of kv (q_offset = Skv - Sq).  Per (q, kv) pair: s = (q . k) * scale in
// fp32, masked to -1e30 outside the causal / window band (or past Skv),
// then the running max m, denominator l and accumulator acc are updated
// with masked probabilities zeroed, exactly as the TPU kernel does;
// the output is acc / max(l, 1e-30), cast to q's type.
//
// What bounds it on the H100: operations.  A prefill of S tokens does
// 4·D flops per unmasked (q, k) pair and head against O(S·D) bytes.  This
// first design runs them as fp32 FMAs on the CUDA cores (67 TFLOP/s peak
// against 989 for bf16 on the tensor cores): one block of 256 threads
// per (b, h, 64-row q tile) walks the kv tiles of 64 rows that its band
// touches, so masked tiles cost nothing.  Q and each K tile are staged in
// shared memory transposed and converted to fp32, so that the score loop
// reads one float4 of Q and one of K per d for 16 FMAs; a thread owns a
// 4 x 4 block of scores, a row's 64 scores live in 16 adjacent lanes
// (shuffle reductions), and the probabilities go through shared memory
// for the P·V product, where a thread owns 4 rows x ceil(D/16) columns.
// Tensor-core `mma`/`wgmma` with TMA-fed tiles is later work.
//
// Global loads are 16 bytes (8 bf16 or 4 fp32), so D must be a multiple
// of 8 and at most 128, and the base pointers 16-byte aligned: the
// wrapper checks all of it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include "smem.cuh"

namespace {

constexpr int FA_BQ = 64;          // q rows per block
constexpr int FA_BK = 64;          // kv rows per tile
constexpr int FA_THREADS = 256;    // 16 x 16: ty owns rows, tx columns
constexpr float FA_MASK = -1e30f;

__device__ __forceinline__ void unpack(const uint4 w, float* f, float) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}

// bf16 is the top half of an fp32; element 0 is the low half of a word
__device__ __forceinline__ void unpack(const uint4 w, float* f,
                                       __nv_bfloat16) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Rows [r0, r0 + rows) of a row-major (S, D) matrix into shared memory
// as fp32, zero past S.  transposed: dst[d * rows + r]; else
// dst[r * ld + d].  16-byte global loads; in the transposed layout
// consecutive threads take consecutive rows (conflict-free stores), in
// the row-major one consecutive chunks of a row (coalesced loads).
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0,
                                          int S, int D, int rows, float* dst,
                                          int ld, bool transposed) {
  constexpr int VEC = 16 / sizeof(T);
  const int nchunk = D / VEC;
  for (int i = threadIdx.x; i < rows * nchunk; i += blockDim.x) {
    const int r = transposed ? i % rows : i / nchunk;
    const int c = transposed ? i / rows : i % nchunk;
    float f[VEC];
    if (r0 + r < S) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(
          src + (size_t)(r0 + r) * D + c * VEC));
      unpack(w, f, T());
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int d = c * VEC + e;
      dst[transposed ? d * rows + r : r * ld + d] = f[e];
    }
  }
}

// NC = ceil(D / 16): output columns per thread (tx + 16 c).
template <typename T, int NC>
__global__ void __launch_bounds__(FA_THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int K, int Sq, int Skv, int D, int causal, int window,
                       float scale) {
  constexpr int DP = NC * 16;                 // padded row of Vs
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);    // [D][BQ]
  float* Kt = Qt + DP * FA_BQ;                    // [D][BK]
  float* Vs = Kt + DP * FA_BK;                    // [BK][DP]
  float* Pt = Vs + FA_BK * DP;                    // [BK][BQ]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / K);
  const int q0 = blockIdx.x * FA_BQ;
  const int q_offset = Skv - Sq;
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)(b * K + kvh) * Skv * D;
  const T* vb = v + (size_t)(b * K + kvh) * Skv * D;

  // the kv band this q tile can see: [kv_lo, kv_hi)
  const int qlo = q0 + q_offset;
  const int qhi = min(q0 + FA_BQ, Sq) - 1 + q_offset;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = min(Skv, qhi + 1);
  if (window > 0) kv_lo = max(0, qlo - window + 1);
  const int t_lo = kv_lo / FA_BK;
  const int t_hi = kv_hi > kv_lo ? (kv_hi + FA_BK - 1) / FA_BK : t_lo;

  load_tile(qb, q0, Sq, D, FA_BQ, Qt, 0, true);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * FA_BK;
    __syncthreads();                 // the last tile's readers are done
    load_tile(kb, k0, Skv, D, FA_BK, Kt, 0, true);
    load_tile(vb, k0, Skv, D, FA_BK, Vs, DP, false);
    __syncthreads();

    // scores of rows ty*4+i against columns tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * FA_BQ + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(Kt + d * FA_BK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i + q_offset;
      bool ok[4];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        ok[j] = kpos < Skv && (!causal || kpos <= qpos) &&
                (window <= 0 || qpos - kpos < window);
        s[i][j] = ok[j] ? s[i][j] * scale : FA_MASK;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * FA_BQ + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

    // acc[rows ty*4+i][cols tx+16c] += P[row][kk] * V[kk][col]
#pragma unroll 4
    for (int kk = 0; kk < FA_BK; ++kk) {
      const float4 pp = *reinterpret_cast<const float4*>(Pt + kk * FA_BQ + ty * 4);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = Vs[kk * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* ob = out + (size_t)bh * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) store(ob + (size_t)row * D + col, acc[i][c] / den);
    }
  }
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int K, int Sq, int Skv, int D, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr int DP = NC * 16;
  const size_t smem =
      sizeof(float) * ((size_t)DP * FA_BQ + (size_t)DP * FA_BK +
                       (size_t)FA_BK * DP + (size_t)FA_BK * FA_BQ);
  static size_t allowed = 0;             // dynamic smem opted in so far
  const cudaError_t e =
      allow_smem(flash_attention_kernel<T, NC>, smem, &allowed);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + FA_BQ - 1) / FA_BQ, B * H);
  flash_attention_kernel<T, NC><<<grid, FA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, K, Sq, Skv, D,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B,
             int H, int K, int Sq, int Skv, int D, int causal, int window,
             float scale, cudaStream_t s) {
  switch ((D + 15) / 16) {
    case 1: return launch<T, 1>(q, k, v, out, B, H, K, Sq, Skv, D, causal, window, scale, s);
    case 2: return launch<T, 2>(q, k, v, out, B, H, K, Sq, Skv, D, causal, window, scale, s);
    case 3: return launch<T, 3>(q, k, v, out, B, H, K, Sq, Skv, D, causal, window, scale, s);
    case 4: return launch<T, 4>(q, k, v, out, B, H, K, Sq, Skv, D, causal, window, scale, s);
    case 5: return launch<T, 5>(q, k, v, out, B, H, K, Sq, Skv, D, causal, window, scale, s);
    case 6: return launch<T, 6>(q, k, v, out, B, H, K, Sq, Skv, D, causal, window, scale, s);
    case 7: return launch<T, 7>(q, k, v, out, B, H, K, Sq, Skv, D, causal, window, scale, s);
    case 8: return launch<T, 8>(q, k, v, out, B, H, K, Sq, Skv, D, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// window <= 0: no sliding window.  bf16: the four tensors are bf16, else
// fp32.  The wrapper has checked shapes, D % 8 == 0, D <= 128, K | H and
// 16-byte alignment.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int K, int Sq, int Skv, int D,
                                      int causal, int window, int bf16,
                                      float scale, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, H, K, Sq, Skv, D, causal,
                                   window, scale, s);
  return dispatch<float>(q, k, v, out, B, H, K, Sq, Skv, D, causal, window,
                         scale, s);
}
