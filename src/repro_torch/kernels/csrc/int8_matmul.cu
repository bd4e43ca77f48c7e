// int8 x int8 -> int32 GEMM with the per-row / per-column fp32 rescale on
// Hopper's tensor cores, optionally with the per-row activation
// quantization fused in.
//
// Replaces the TPU kernel `int8_matmul_pallas`
// (src/repro/kernels/int8_matmul.py) and, in its fused form, the
// activation half of `ops.int8_matmul_prepared` (src/repro/kernels/ops.py):
//   s[m]  = max_k |x[m, k]| / 127                  (fp32, correctly rounded)
//   xq    = clamp(rint(x / max(s, 1e-12)), -127, 127)   (half to even)
//   out   = (float(acc) * s[m]) * ws[n],  acc = sum_k xq[m, k] * wq[k, n]
// exactly as `ops.quantize_rows` and `ref.int8_matmul` compute them, so the
// output is bitwise the plain path's.  The unfused form takes xq and xs.
//
// What bounds it: bytes.  On the main path M = b*T is 1-64 rows and the
// weight (1.4-16.6 MB) is read once per call; the work is ~M MACs per
// weight byte, far below the tensor cores' 1,979 TOP/s.  So the design is
// about bytes in flight and filling the 132 SMs:
//  * mma.sync m16n8k32 s8.  A thread's 16-byte load of a weight row and
//    the matching 16 bytes of two activation rows feed two mmas directly:
//    the products' K order is permuted the same way in A and B, which an
//    exact integer sum cannot see.  So the weight goes global -> registers
//    with no shared-memory staging, through a ring of 16 / NT chunks per
//    thread (256 bytes in flight per thread, 64 KB per block of 8 warps).
//  * A block is 8 warps on 16 rows.  K is split over a thread block
//    cluster of S <= 8 blocks, planned on the host (`int8_matmul.plan`) so
//    that the grid fills the card with up to two blocks a SM: each block
//    owns a K slice for one tile of BN output columns, the int32 partial
//    sums meet in distributed shared memory, and each block of the cluster
//    finishes 1/S of the tile.  int32 sums are exact in any order.
//  * Fused quantization: each block copies its K slice of its rows' fp32
//    values into shared memory (cp.async, all in flight at once), the
//    cluster exchanges the per-row partial maxima (a max is order-free, so
//    every block gets the same scale), and each block quantizes its slice
//    there.  The division by the scale is a product with its reciprocal,
//    redone as a correctly rounded division within 2^-14 of a tie (see
//    `quant1`).  The weight ring is issued before this prologue, so the
//    prologue overlaps the weight's first bytes.  One launch replaces the
//    ~8 elementwise launches of `quantize_rows` plus the product.
// Any M, N and K: rows, columns and K beyond the edges are masked here.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "smem.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CHUNK = 64;         // K bytes per chunk (two k32 mmas)
constexpr int WARPS = 8;          // a block: 8 warps on 16 rows
constexpr int MAX_SPLIT = 8;      // portable cluster size
constexpr int MAX_SMEM = 200 * 1024;
constexpr int HEADER = 1024;      // per-row scales, divisors, maxima

struct Args {
  const void* a;                  // x (M, K) f32, or xq (M, K) i8
  const int8_t* wqt;              // (N, K) i8, K-contiguous
  const float* xs;                // (M,) f32 (unfused form)
  const float* ws;                // (N,) f32
  float* out;                     // (M, N) f32
  int M, N, K;
  int split, cps;                 // cluster size, K chunks per block
  int vec_a, vec_w;               // 16-byte loads of a / wqt are legal
};

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// 16 bytes p[k, k+16), zero beyond K (byte i -> bits 8*(i%4) of word i/4,
// the little-endian order of the vector load).
__device__ __forceinline__ int4 load16(const int8_t* __restrict__ p, int k,
                                       int K, bool vec) {
  if (vec && k + 16 <= K) return __ldg(reinterpret_cast<const int4*>(p + k));
  int w[4] = {0, 0, 0, 0};
  if (k >= K) return make_int4(0, 0, 0, 0);
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (k + i < K) w[i >> 2] |= (int)(uint8_t)p[k + i] << (8 * (i & 3));
  return make_int4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2,
                                       int a3, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// max that propagates NaN, as torch.amax does
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// The row's scale from its |max|: `quantize_rows`' `amax / 127.0`.
__device__ __forceinline__ float row_scale(float amax) {
  return __fdiv_rn(amax, 127.0f);
}

// q = clamp(rint(v / d), -127, 127) as one byte, `d` > 0 or NaN and
// rcp = 1 / d.  v * rcp is within 2^-16 of v / d (|v / d| <= 127), so
// away from a half-integer it rounds to the same integer as the correctly
// rounded quotient; within 2^-14 of one the quotient is computed exactly.
__device__ __forceinline__ uint32_t quant1(float v, float d, float rcp) {
  float t = __fmul_rn(v, rcp);
  if (fabsf(t - floorf(t) - 0.5f) < 6.103515625e-05f) t = __fdiv_rn(v, d);
  const float c = fminf(fmaxf(rintf(t), -127.f), 127.f);
  return (uint32_t)(uint8_t)(int8_t)(int)c;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

// Shared memory: the header (per-row scales, divisors, reciprocals and
// partial maxima), the block's quantized activation slice (16 rows of
// `astride` bytes) and, in the fused form, its fp32 rows as loaded (16
// rows of kspan floats); the split-K exchange then reuses that space for
// the block's int32 partial tile, which the cluster's blocks read.
template <int NT, bool QUANT>
__global__ void __launch_bounds__(WARPS * 32)
int8_mma_kernel(const Args g) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);       // the rows' scales
  float* dv = sc + 64;                              // max(scale, 1e-12)
  float* rc = sc + 128;                             // 1 / dv
  float* pmax = sc + 192;                           // partial row maxima
  int8_t* at = reinterpret_cast<int8_t*>(smem + HEADER);
  int* red = reinterpret_cast<int*>(smem + HEADER);
  constexpr int ROWS = 16;          // one m16 tile of rows a block
  constexpr int D = 16 / NT;        // weight chunks in flight per thread

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int rank = blockIdx.x % g.split;
  constexpr int bn = 8 * NT * WARPS;
  const int n0 = (blockIdx.x / g.split) * bn;
  const int m0 = blockIdx.y * ROWS;
  const int kspan = g.cps * CHUNK;
  const int astride = kspan + ((g.cps & 1) ? 0 : CHUNK);   // 64 mod 128
  const int k_lo = rank * kspan;
  const int k_hi = min(g.K, k_lo + kspan);
  const int nck = k_hi > k_lo ? (k_hi - k_lo + CHUNK - 1) / CHUNK : 0;
  const bool vec_a = g.vec_a != 0, vec_w = g.vec_w != 0;

  // the weight rows this thread loads: column gid of each of its n8 tiles
  const int8_t* wrow[NT];
  bool wlive[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + warp * 8 * NT + j * 8 + gid;
    wlive[j] = n < g.N;
    wrow[j] = g.wqt + (size_t)(wlive[j] ? n : 0) * g.K;
  }
  int4 buf[D][NT];
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      buf[d][j] = (d < nck && wlive[j])
          ? load16(wrow[j], k_lo + d * CHUNK + 16 * tig, k_hi, vec_w)
          : make_int4(0, 0, 0, 0);

  // ---- the activation slice [k_lo, k_lo + kspan) of rows m0.. -------------
  const int mrows = min(ROWS, g.M - m0);          // this block's live rows
  if (QUANT) {
    // the fp32 slice of the live rows, all of it in flight at once (zeros
    // beyond K); the A tile's other rows are zero
    const float* x = static_cast<const float*>(g.a);
    float* xst = reinterpret_cast<float*>(at + ROWS * astride);
    const int segs = kspan / 4;
    for (int i = threadIdx.x; i < mrows * segs; i += blockDim.x) {
      const int r = i / segs, kk = 4 * (i - r * segs);
      const int k = k_lo + kk;
      const int live = min(4, max(0, g.K - k));
      const float* src = x + (size_t)(m0 + r) * g.K + k;
      if (vec_a) {
        cp_async16(xst + r * kspan + kk, live ? src : x, 4 * live);
      } else {
        for (int e = 0; e < 4; ++e)
          xst[r * kspan + kk + e] = e < live ? src[e] : 0.f;
      }
    }
    for (int i = threadIdx.x; i < (ROWS - mrows) * astride / 16;
         i += blockDim.x)
      reinterpret_cast<int4*>(at + mrows * astride)[i] = make_int4(0, 0, 0, 0);
    cp_async_wait_all();
    __syncthreads();
    for (int r = warp; r < mrows; r += WARPS) {
      float v = 0.f;
      for (int k = lane; k < kspan; k += 32)
        v = nanmax(v, fabsf(xst[r * kspan + k]));
      for (int o = 16; o > 0; o >>= 1)
        v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (lane == 0) pmax[r] = v;
    }
    if (g.split > 1) cluster_sync(); else __syncthreads();
    for (int r = threadIdx.x; r < mrows; r += blockDim.x) {
      float v = pmax[r];
      if (g.split > 1) {
        cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
        for (int q = 0; q < MAX_SPLIT; ++q)    // all loads in flight at once
          if (q < g.split)
            v = nanmax(v, cluster.map_shared_rank(pmax, q)[r]);
      }
      const float s = row_scale(v);
      const float d = s != s ? s : fmaxf(s, 1e-12f);
      sc[r] = s;
      dv[r] = d;
      rc[r] = __frcp_rn(d);
    }
    __syncthreads();
    // four K values a thread: one 16-byte shared load, one 4-byte store
    for (int i = threadIdx.x; i < mrows * segs; i += blockDim.x) {
      const int r = i / segs, kk = 4 * (i - r * segs);
      const float d = dv[r], rcp = rc[r];
      const float4 f = *reinterpret_cast<const float4*>(xst + r * kspan + kk);
      *reinterpret_cast<uint32_t*>(at + r * astride + kk) =
          quant1(f.x, d, rcp) | quant1(f.y, d, rcp) << 8
          | quant1(f.z, d, rcp) << 16 | quant1(f.w, d, rcp) << 24;
    }
  } else {
    const int8_t* xq = static_cast<const int8_t*>(g.a);
    for (int r = threadIdx.x; r < ROWS; r += blockDim.x)
      sc[r] = m0 + r < g.M ? g.xs[m0 + r] : 0.f;
    const int segs = kspan / 16;
    for (int i = threadIdx.x; i < ROWS * segs; i += blockDim.x) {
      const int r = i / segs, kk = 16 * (i - r * segs);
      const int m = m0 + r;
      *reinterpret_cast<int4*>(at + r * astride + kk) =
          m < g.M ? load16(xq + (size_t)m * g.K, k_lo + kk, k_hi, vec_a)
                  : make_int4(0, 0, 0, 0);
    }
  }
  __syncthreads();

  // ---- the product: per chunk, two k32 mmas per (m16, n8) tile ------------
  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  for (int c0 = 0; c0 < nck; c0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int c = c0 + d;
      if (c < nck) {
        const int8_t* ap = at + gid * astride + c * CHUNK + 16 * tig;
        const int4 lo = *reinterpret_cast<const int4*>(ap);
        const int4 hi = *reinterpret_cast<const int4*>(ap + 8 * astride);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          mma_s8(acc[j], lo.x, hi.x, lo.y, hi.y, buf[d][j].x, buf[d][j].y);
          mma_s8(acc[j], lo.z, hi.z, lo.w, hi.w, buf[d][j].z, buf[d][j].w);
        }
        if (c + D < nck) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
            buf[d][j] = wlive[j]
                ? load16(wrow[j], k_lo + (c + D) * CHUNK + 16 * tig, k_hi,
                         vec_w)
                : make_int4(0, 0, 0, 0);
        }
      }
    }
  }

  // ---- epilogue: (float(acc) * xs) * ws ----------------------------------
  if (g.split == 1) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = gid + (e >> 1) * 8;
        const int m = m0 + r;
        const int n = n0 + warp * 8 * NT + j * 8 + 2 * tig + (e & 1);
        if (m < g.M && n < g.N)
          g.out[(size_t)m * g.N + n] = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[j][e]), sc[r]), g.ws[n]);
      }
    return;
  }
  // split K: the partial tiles meet in distributed shared memory; block
  // `rank` of the cluster finishes every split-th value of the tile
  __syncthreads();                         // every warp is done with `at`
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(gid + (e >> 1) * 8) * bn + warp * 8 * NT + j * 8 + 2 * tig
          + (e & 1)] = acc[j][e];
  cluster_sync();
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = rank * blockDim.x + threadIdx.x; i < mrows * bn;
       i += g.split * blockDim.x) {
    const int r = i / bn, n = n0 + i - r * bn;
    if (n >= g.N) continue;
    int total = 0;
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q)       // all loads in flight at once
      if (q < g.split) total += cluster.map_shared_rank(red, q)[i];
    g.out[(size_t)(m0 + r) * g.N + n] =
        __fmul_rn(__fmul_rn(__int2float_rn(total), sc[r]), g.ws[n]);
  }
  cluster_sync();                          // no block leaves while read
}

size_t smem_bytes(int nt, int split, int cps) {
  const size_t kspan = (size_t)cps * CHUNK;
  const size_t astride = kspan + ((cps & 1) ? 0 : CHUNK);
  const size_t body = 16 * (astride + 4 * kspan);
  const size_t red = split > 1 ? (size_t)4 * 16 * 8 * nt * WARPS : 0;
  return HEADER + (body > red ? body : red);
}

template <int NT, bool QUANT>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(NT, a.split, a.cps);
  static size_t allowed = 0;             // dynamic smem opted in so far
  cudaError_t e = allow_smem(int8_mma_kernel<NT, QUANT>, smem, &allowed);
  if (e != cudaSuccess) return (int)e;
  const int bn = 8 * NT * WARPS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((a.N + bn - 1) / bn) * a.split),
                     (unsigned)((a.M + 15) / 16));
  cfg.blockDim = dim3(32 * WARPS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (a.split > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  // cudaLaunchKernelEx reports its own launch's status
  return (int)cudaLaunchKernelEx(&cfg, int8_mma_kernel<NT, QUANT>, a);
}

}  // namespace

// quant = 1: `a` is x (M, K) f32 and the kernel quantizes it (xs unused);
// quant = 0: `a` is xq (M, K) i8 with scales xs (M,).  The plan (nt n8
// tiles a warp, split blocks a cluster over K, cps 64-byte K chunks a
// block) comes from `int8_matmul.plan` and is checked here.
// vec_a / vec_w: rows of a / wqt may be read 16 bytes at a time (aligned,
// K a multiple of 4 / 16 bytes).
extern "C" int int8_matmul_launch(const void* a, const void* wqt,
                                  const void* xs, const void* ws, void* out,
                                  int M, int N, int K, int quant, int nt,
                                  int split, int cps, int vec_a, int vec_w,
                                  void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int nch = (K + CHUNK - 1) / CHUNK;
  if (K < 0 || (nt != 2 && nt != 4) || split < 1 || split > MAX_SPLIT ||
      cps < 0 || (long long)split * cps < nch ||
      (split > 1 && (long long)(split - 1) * cps >= nch) ||
      (M + 15) / 16 > 65535 || smem_bytes(nt, split, cps) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  Args g = {a, (const int8_t*)wqt, (const float*)xs, (const float*)ws,
            (float*)out, M, N, K, split, cps, vec_a, vec_w};
  cudaStream_t s = (cudaStream_t)stream;
  if (nt == 2) return quant ? launch<2, true>(g, s) : launch<2, false>(g, s);
  return quant ? launch<4, true>(g, s) : launch<4, false>(g, s);
}
