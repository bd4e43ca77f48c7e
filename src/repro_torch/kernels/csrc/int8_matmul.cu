// int8 x int8 -> int32 GEMM with the per-row / per-column fp32 rescale,
// for Hopper.
//
// Replaces the TPU kernel `int8_matmul_pallas`
// (src/repro/kernels/int8_matmul.py): out = (float(acc) * xs[m]) * ws[n]
// with acc = sum_k xq[m, k] * wq[k, n] in int32, the rescale applied once
// after the last K step, as the TPU kernel does.  The weight comes as
// its K-contiguous copy wqt (N, K), made once when the weights are
// prepared, so that the four K values one `__dp4a` takes are adjacent
// bytes.  Any M, N and K: ragged edges are masked here, not padded by
// the caller.
//
// What bounds it: on the main path M = b*T is small (16-64 rows) and
// the weight (1.4-16.6 MB) is read once per call, so it is a
// weight-streaming skinny GEMM bound by bytes.  The design: each warp
// owns 4 output columns and its lanes split K into 16-byte stripes (one
// 128-bit load per column per stripe, adjacent lanes on adjacent
// stripes); a block of 8 warps stages a 16-row tile of xq in shared
// memory, which every warp reads as a conflict-free 128-bit load per
// row and stripe.  Each lane keeps 4 x 16 int32 partial sums; a warp
// reduce-scatter (31 shuffles per 32 sums) leaves lane l holding one
// whole sum, which it rescales and writes.  Integer sums are exact, so
// the summation order cannot change the result: the output is bitwise
// the plain version's.  Tensor-core `mma` with s8 operands and TMA
// loads are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int I8_WARPS = 8;                    // warps per block
constexpr int I8_COLS = 4;                     // output columns per warp
constexpr int I8_BN = I8_WARPS * I8_COLS;      // columns per block
constexpr int I8_BM = 16;                      // rows per block
constexpr int I8_KC = 2048;                    // K bytes staged per pass

// 16 bytes p[k, k+16), zero beyond K.  `vec`: K % 16 == 0 and p is
// 16-byte aligned, so one 128-bit load is in bounds.  Byte i goes to
// bits 8*(i%4) of word i/4, the little-endian order of the vector load.
__device__ __forceinline__ int4 load16(const int8_t* __restrict__ p, int k,
                                       int K, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const int4*>(p + k));
  int w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (k + i < K) w[i >> 2] |= (int)(uint8_t)p[k + i] << (8 * (i & 3));
  return make_int4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ int dp16(const int4 a, const int4 b, int c) {
  c = __dp4a(a.x, b.x, c);
  c = __dp4a(a.y, b.y, c);
  c = __dp4a(a.z, b.z, c);
  return __dp4a(a.w, b.w, c);
}

// One halving step of `reduce_scatter32`: the lane keeps the half of
// v[0, 2H) its bit H selects, sends the other half to the lane across
// that bit, and adds what comes back.  H is a template argument so that
// every index into v is a constant and v stays in registers.
template <int H>
__device__ __forceinline__ void halve(int (&v)[32], bool upper) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const int send = upper ? v[i] : v[i + H];
    const int keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

// v[0..31] on every lane of the warp -> sum over the lanes of v[lane]
// (31 shuffles, against 160 for 32 butterfly all-reduces).
__device__ __forceinline__ int reduce_scatter32(int (&v)[32], int lane) {
  halve<16>(v, lane & 16);
  halve<8>(v, lane & 8);
  halve<4>(v, lane & 4);
  halve<2>(v, lane & 2);
  halve<1>(v, lane & 1);
  return v[0];
}

__global__ void __launch_bounds__(I8_WARPS * 32)
int8_matmul_kernel(const int8_t* __restrict__ xq,
                   const int8_t* __restrict__ wqt,
                   const float* __restrict__ xs, const float* __restrict__ ws,
                   float* __restrict__ out, int M, int N, int K, int vec) {
  __shared__ int4 xtile[I8_BM][I8_KC / 16];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.y * I8_BM;
  const int n0 = blockIdx.x * I8_BN + warp * I8_COLS;
  // acc[g][i]: column n0 + 2g + i/16, row m0 + i%16
  int acc[2][32];
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[g][i] = 0;
  const int8_t* wrow[I8_COLS];
  bool live[I8_COLS];
#pragma unroll
  for (int c = 0; c < I8_COLS; ++c) {
    live[c] = n0 + c < N;
    wrow[c] = wqt + (size_t)(live[c] ? n0 + c : 0) * K;
  }

  for (int kc = 0; kc < K; kc += I8_KC) {
    const int kw = (min(I8_KC, K - kc) + 15) / 16;    // stripes this pass
    __syncthreads();                // the previous pass's reads are done
    for (int i = threadIdx.x; i < I8_BM * kw; i += blockDim.x) {
      const int r = i / kw, j = i - r * kw;
      xtile[r][j] = m0 + r < M
          ? load16(xq + (size_t)(m0 + r) * K, kc + 16 * j, K, vec)
          : make_int4(0, 0, 0, 0);
    }
    __syncthreads();
    for (int j = lane; j < kw; j += 32) {
      const int k = kc + 16 * j;
      int4 w[I8_COLS];
#pragma unroll
      for (int c = 0; c < I8_COLS; ++c)
        w[c] = live[c] ? load16(wrow[c], k, K, vec) : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int r = 0; r < I8_BM; ++r) {
        const int4 x = xtile[r][j];
#pragma unroll
        for (int c = 0; c < I8_COLS; ++c)
          acc[c >> 1][(c & 1) * 16 + r] = dp16(x, w[c],
                                               acc[c >> 1][(c & 1) * 16 + r]);
      }
    }
  }

  const int m = m0 + (lane & 15);
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int total = reduce_scatter32(acc[g], lane);
    const int n = n0 + 2 * g + (lane >> 4);
    if (m < M && n < N)
      out[(size_t)m * N + n] =
          __fmul_rn(__fmul_rn(__int2float_rn(total), xs[m]), ws[n]);
  }
}

}  // namespace

extern "C" int int8_matmul_launch(const void* xq, const void* wqt,
                                  const void* xs, const void* ws, void* out,
                                  int M, int N, int K, int vec,
                                  void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid((N + I8_BN - 1) / I8_BN, (M + I8_BM - 1) / I8_BM);
  if (grid.y > 65535 || K < 0) return (int)cudaErrorInvalidValue;
  int8_matmul_kernel<<<grid, I8_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const int8_t*)xq, (const int8_t*)wqt, (const float*)xs,
      (const float*)ws, (float*)out, M, N, K, vec);
  return (int)cudaGetLastError();
}
