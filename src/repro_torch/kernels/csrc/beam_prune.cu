// Beam-threshold prune for Hopper: out[i] = s[i] >= max(s) - beam ? s[i]
// : -1e30, over one (N,) fp32 score vector.
//
// Replaces the TPU kernel `beam_prune_pallas` (src/repro/kernels/
// beam_prune.py), whose grid walks the vector twice in order on one core,
// carrying the running max from step to step in SMEM scratch.  Blocks on
// this card run in no order, so the max cannot be carried: a reduction
// across blocks needs a second launch (or a grid-wide barrier).
//
// What bounds it: bytes (8 N: each score read once, each output written
// once; the comparisons are nothing beside them).  At the reference
// benchmark's N = 8448 that is 68 KB, about 20 ns at 3.35 TB/s, so the
// launch itself sets the time.  The design follows from that:
//   * N <= BP_SMALL: one block of BP_SMALL_THREADS does both passes in
//     one launch (the second pass re-reads the row from L1/L2);
//   * larger N: `bp_partial` writes one max per block into the caller's
//     (n_partials,) scratch, then `bp_mask` has every block reduce those
//     few partials itself (a fixed-size read from L2) and mask its part
//     of the row.  Two launches, no atomics, no readback to the host.
//
// The result is bitwise the plain version's (`ref.beam_prune`):
//   * the max propagates NaN, as `torch.amax`/`jnp.max` do (`fmaxf`
//     drops it); a NaN max gives a NaN threshold, which masks every entry;
//   * the threshold is `best - beam` in fp32 and an entry is kept when
//     `s >= thr` (the reference's weak-typed Python float; not rewritten
//     as `s - best >= -beam`, and built without fast math);
//   * a max is exact whatever the order of the reduction, so the result
//     does not depend on the grid or the schedule.
// All -inf gives an -inf threshold: every entry is kept as -inf.  A +inf
// entry gives a +inf threshold: only the +inf entries are kept.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float BP_MASK = -1e30f;
constexpr int BP_SMALL = 1 << 16;        // N handled by one block
constexpr int BP_SMALL_THREADS = 1024;
constexpr int BP_THREADS = 256;          // threads of the two-pass kernels
constexpr int BP_PER_BLOCK = 4096;       // scores per block (at least)

// max that propagates NaN: NaN if either operand is NaN
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Max over the block; every thread gets it.  blockDim.x % 32 == 0.
__device__ float block_nanmax(float v) {
  __shared__ float red[32];
  for (int o = 16; o > 0; o >>= 1)
    v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : -CUDART_INF_F;
  for (int o = 16; o > 0; o >>= 1)
    v = nanmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void mask_range(const float* __restrict__ s,
                                           float* __restrict__ out,
                                           long long i, long long n,
                                           long long step, float thr) {
  for (; i < n; i += step) {
    const float v = s[i];
    out[i] = v >= thr ? v : BP_MASK;
  }
}

__global__ void __launch_bounds__(BP_SMALL_THREADS)
bp_single(const float* __restrict__ s, float* __restrict__ out, int n,
          float beam) {
  float m = -CUDART_INF_F;
  for (int i = threadIdx.x; i < n; i += blockDim.x) m = nanmax(m, s[i]);
  const float thr = block_nanmax(m) - beam;
  mask_range(s, out, threadIdx.x, n, blockDim.x, thr);
}

__global__ void __launch_bounds__(BP_THREADS)
bp_partial(const float* __restrict__ s, float* __restrict__ partial, int n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  float m = -CUDART_INF_F;
#pragma unroll 4
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step)
    m = nanmax(m, s[i]);
  m = block_nanmax(m);
  if (threadIdx.x == 0) partial[blockIdx.x] = m;
}

__global__ void __launch_bounds__(BP_THREADS)
bp_mask(const float* __restrict__ s, const float* __restrict__ partial,
        float* __restrict__ out, int n, int g, float beam) {
  float m = -CUDART_INF_F;
  for (int j = threadIdx.x; j < g; j += blockDim.x) m = nanmax(m, partial[j]);
  const float thr = block_nanmax(m) - beam;
  mask_range(s, out, (long long)blockIdx.x * blockDim.x + threadIdx.x, n,
             (long long)gridDim.x * blockDim.x, thr);
}

}  // namespace

// s, out: (n,) f32 device pointers; partial: (n_partials,) f32 scratch,
// used only when n > BP_SMALL.
extern "C" int beam_prune_launch(const void* s, void* out, void* partial,
                                 int n, int n_partials, float beam,
                                 void* stream) {
  if (n < 1 || n_partials < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (n <= BP_SMALL) {
    bp_single<<<1, BP_SMALL_THREADS, 0, st>>>((const float*)s, (float*)out,
                                               n, beam);
    return (int)cudaGetLastError();
  }
  int g = (n + BP_PER_BLOCK - 1) / BP_PER_BLOCK;
  if (g > n_partials) g = n_partials;
  bp_partial<<<g, BP_THREADS, 0, st>>>((const float*)s, (float*)partial, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bp_mask<<<g, BP_THREADS, 0, st>>>((const float*)s, (const float*)partial,
                                     (float*)out, n, g, beam);
  return (int)cudaGetLastError();
}
