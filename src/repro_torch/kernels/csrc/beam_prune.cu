// Beam-threshold prune for Hopper: out[i] = s[i] >= max(s) - beam ? s[i]
// : -1e30, over one (N,) fp32 score vector, in one launch at every N.
//
// Replaces the TPU kernel `beam_prune_pallas` (src/repro/kernels/
// beam_prune.py), whose grid walks the vector twice in order on one core,
// carrying the running max from step to step in SMEM scratch.  Blocks on
// this card run in no order, so the max cannot be carried; here every
// block keeps its part of the vector on chip while the max is found, and
// each score is read from device memory once.
//
// What bounds it: bytes (8 N: each score read once, each output written
// once; the comparisons are nothing beside them).  At the reference
// benchmark's N = 8448 that is 68 KB, about 20 ns at 3.35 TB/s, so the
// launch and one load's latency set the time; at N = 4,194,307 it is
// 33.6 MB, 10 us.  The design:
//   * N <= BP_SMALL (32768): one block of 1024 threads holds the vector
//     in registers (up to 8 16-byte loads a thread, all issued before the
//     first is used), reduces the max once and masks from registers;
//   * larger N: one cooperative launch of at most one block per SM.  Each
//     block stages its slice in shared memory (up to ~227 KB a block, some
//     7.6 M scores over 132 SMs) while it reduces the slice's max,
//     publishes that max through an order-preserving integer atomicMax
//     (NaN on top), meets the others at one grid barrier (acquire/release
//     atomics, no full fences) and masks from shared memory.  A slice
//     longer than shared memory re-reads its tail from L2.  The barrier's
//     scratch words (`BpWord`) are left as they were found, so no call
//     needs a fill before it.
// 16-byte loads and stores need both pointers 16-byte aligned and cover
// N rounded down to a multiple of 4 (the last N % 4 scores are scalars);
// an unaligned vector takes the scalar variant of the same kernels.
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
#include <stdint.h>
#include "smem.cuh"

namespace {

constexpr float BP_MASK = -1e30f;
constexpr int BP_THREADS = 1024;
constexpr int BP_VMAX = 8;                          // 16-byte loads a thread
constexpr int BP_SMALL = BP_VMAX * 4 * BP_THREADS;  // N held by one block
constexpr int BP_MIN_PER_BLOCK = 8192;   // scores per block of the grid path
constexpr int BP_BATCH = 8;              // its 16-byte loads in flight a thread
// scratch words of the grid barrier, zero before the first call
enum BpWord { BP_MAX = 0, BP_COUNT = 1, BP_GEN = 2, BP_RESULT = 3 };
constexpr long long BP_SPIN_LIMIT = 1LL << 24;   // ~2 s: trap, never hang

// max that propagates NaN: NaN if either operand is NaN
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float nanmax4(float4 q) {
  return nanmax(nanmax(q.x, q.y), nanmax(q.z, q.w));
}

__device__ __forceinline__ float keep(float v, float thr) {
  return v >= thr ? v : BP_MASK;
}

__device__ __forceinline__ float4 keep4(float4 q, float thr) {
  return make_float4(keep(q.x, thr), keep(q.y, thr), keep(q.z, thr),
                     keep(q.w, thr));
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

template <int V, bool VEC>
__global__ void __launch_bounds__(BP_THREADS)
bp_small(const float* __restrict__ s, float* __restrict__ out, int n,
         float beam) {
  // thread t holds the 16-byte units t, t + 1024, ... (VEC), or the
  // scores t, t + 1024, ... (4 V of them); -inf past the end
  float v[4 * V];
  float m = -CUDART_INF_F, tail = -CUDART_INF_F;
  const int t = threadIdx.x;
  const int n4 = VEC ? n >> 2 : 0, tail_i = 4 * n4 + t;
  if constexpr (VEC) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int u = t + k * BP_THREADS;
      const float4 q = u < n4 ? __ldg(s4 + u)
                              : make_float4(-CUDART_INF_F, -CUDART_INF_F,
                                            -CUDART_INF_F, -CUDART_INF_F);
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
    if (tail_i < n && t < 4) tail = __ldg(s + tail_i);
  } else {
#pragma unroll
    for (int j = 0; j < 4 * V; ++j) {
      const int i = t + j * BP_THREADS;
      v[j] = i < n ? __ldg(s + i) : -CUDART_INF_F;
    }
  }
#pragma unroll
  for (int j = 0; j < 4 * V; ++j) m = nanmax(m, v[j]);
  const float thr = block_nanmax(nanmax(m, tail)) - beam;
  if constexpr (VEC) {
    float4* o4 = reinterpret_cast<float4*>(out);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int u = t + k * BP_THREADS;
      if (u < n4)
        o4[u] = keep4(make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                                  v[4 * k + 3]), thr);
    }
    if (tail_i < n && t < 4) out[tail_i] = keep(tail, thr);
  } else {
#pragma unroll
    for (int j = 0; j < 4 * V; ++j) {
      const int i = t + j * BP_THREADS;
      if (i < n) out[i] = keep(v[j], thr);
    }
  }
}

// fp32 -> uint32 in the same order, every NaN above +inf; 0 is below every
// key (the identity of the atomicMax)
__device__ __forceinline__ unsigned order_key(float f) {
  if (f != f) return 0xffffffffu;
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  if (k == 0xffffffffu) return CUDART_NAN_F;
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The grid's max, to every thread of every block: each block publishes
// its max `m` (known to all its threads) and waits at one grid barrier.
// The last block to arrive takes the max and resets BP_MAX and BP_COUNT
// for the next call, stores the max in BP_RESULT and bumps BP_GEN, which
// releases the others.  Acquire/release atomics order it (no full
// fences): a block's atomicMax is published by its release on BP_COUNT,
// which the last block acquires; BP_RESULT by the release on BP_GEN,
// which the waiting blocks acquire.  The grid must be co-resident (a
// cooperative launch).  The next call on the stream overwrites BP_RESULT
// only after this grid has ended, so every block reads this call's.
__device__ float grid_nanmax(unsigned* w, float m) {
  __shared__ float result;
  if (threadIdx.x == 0) {
    unsigned gen0, arrived, k;
    asm volatile("ld.relaxed.gpu.u32 %0, [%1];"
                 : "=r"(gen0) : "l"(w + BP_GEN) : "memory");
    atomicMax(w + BP_MAX, order_key(m));
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
                 : "=r"(arrived) : "l"(w + BP_COUNT) : "memory");
    if (arrived == gridDim.x - 1) {
      k = atomicExch(w + BP_MAX, 0u);
      w[BP_RESULT] = k;
      atomicExch(w + BP_COUNT, 0u);
      asm volatile("red.release.gpu.add.u32 [%0], 1;"
                   :: "l"(w + BP_GEN) : "memory");
    } else {
      for (long long spins = 0;; ++spins) {
        unsigned gen;
        asm volatile("ld.acquire.gpu.u32 %0, [%1];"
                     : "=r"(gen) : "l"(w + BP_GEN) : "memory");
        if (gen != gen0) break;
        if (spins > BP_SPIN_LIMIT) __trap();
        __nanosleep(32);
      }
      k = *reinterpret_cast<volatile unsigned*>(w + BP_RESULT);
    }
    result = key_value(k);
  }
  __syncthreads();
  return result;
}

// Block b owns the scores [b * per_block, min(n, (b + 1) * per_block));
// per_block is a multiple of 4, and the first `staged` scores of the
// slice are kept in shared memory (a multiple of 4).  VEC: the grid's
// last n % 4 scores are the last block's scalar tail.
template <bool VEC>
__global__ void __launch_bounds__(BP_THREADS)
bp_grid(const float* __restrict__ s, float* __restrict__ out, unsigned* w,
        int n, int per_block, int staged, float beam) {
  extern __shared__ float4 stage[];
  const long long lo = (long long)blockIdx.x * per_block;
  const long long hi = min((long long)n, lo + per_block);
  const int t = threadIdx.x;
  float m = -CUDART_INF_F;
  if constexpr (VEC) {
    const float4* s4 = reinterpret_cast<const float4*>(s) + (lo >> 2);
    const int nu = (int)((hi >> 2) - (lo >> 2)), su = staged >> 2;
    // 8 loads in flight a thread before the first is used
    for (int base = t; base < nu; base += BP_BATCH * BP_THREADS) {
      float4 q[BP_BATCH];
#pragma unroll
      for (int k = 0; k < BP_BATCH; ++k) {
        const int u = base + k * BP_THREADS;
        q[k] = u < nu ? __ldg(s4 + u)
                      : make_float4(-CUDART_INF_F, -CUDART_INF_F,
                                    -CUDART_INF_F, -CUDART_INF_F);
      }
#pragma unroll
      for (int k = 0; k < BP_BATCH; ++k) {
        const int u = base + k * BP_THREADS;
        if (u < nu && u < su) stage[u] = q[k];
        m = nanmax(m, nanmax4(q[k]));
      }
    }
  } else {
    float* st = reinterpret_cast<float*>(stage);
    const int nl = (int)(hi - lo);
#pragma unroll 4
    for (int i = t; i < nl; i += BP_THREADS) {
      const float v = __ldg(s + lo + i);
      if (i < staged) st[i] = v;
      m = nanmax(m, v);
    }
  }
  const int tail_i = (n & ~3) + t;
  const bool has_tail = VEC && blockIdx.x == gridDim.x - 1 && tail_i < n &&
                        t < 4;
  float tail = -CUDART_INF_F;
  if (has_tail) {
    tail = __ldg(s + tail_i);
    m = nanmax(m, tail);
  }
  const float thr = grid_nanmax(w, block_nanmax(m)) - beam;
  if constexpr (VEC) {
    const float4* s4 = reinterpret_cast<const float4*>(s) + (lo >> 2);
    float4* o4 = reinterpret_cast<float4*>(out) + (lo >> 2);
    const int nu = (int)((hi >> 2) - (lo >> 2)), su = staged >> 2;
#pragma unroll 4
    for (int u = t; u < nu; u += BP_THREADS)
      o4[u] = keep4(u < su ? stage[u] : __ldg(s4 + u), thr);
  } else {
    const float* st = reinterpret_cast<const float*>(stage);
    const int nl = (int)(hi - lo);
#pragma unroll 4
    for (int i = t; i < nl; i += BP_THREADS)
      out[lo + i] = keep(i < staged ? st[i] : __ldg(s + lo + i), thr);
  }
  if (has_tail) out[tail_i] = keep(tail, thr);
}

// The SMs and the scores a block can stage, per device (queried once).
struct BpDevice {
  int sms = 0, cap = 0;
};

cudaError_t bp_device(BpDevice* d) {
  static BpDevice cache[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cache[dev].sms == 0) {
    int sms = 0, optin = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    // leave room for the kernels' static shared memory (red, result)
    cache[dev].cap = ((optin - 256) / (int)sizeof(float)) & ~3;
    cache[dev].sms = sms;
  }
  *d = cache[dev];
  return cudaSuccess;
}

template <int V>
cudaError_t launch_small(const float* s, float* out, int n, float beam,
                         bool vec, cudaStream_t st) {
  if (vec)
    bp_small<V, true><<<1, BP_THREADS, 0, st>>>(s, out, n, beam);
  else
    bp_small<V, false><<<1, BP_THREADS, 0, st>>>(s, out, n, beam);
  return cudaGetLastError();
}

}  // namespace

// Scores the grid path keeps in shared memory at most, on the current
// device: N above it re-reads part of each slice from L2.  < 0: an error.
extern "C" int beam_prune_capacity(void) {
  BpDevice d;
  const cudaError_t e = bp_device(&d);
  if (e != cudaSuccess) return -(int)e;
  return d.sms * d.cap;
}

// s, out: (n,) f32 device pointers; scratch: 4 words, zero before the
// stream's first call with n > BP_SMALL and left so by every call.
extern "C" int beam_prune_launch(const void* s, void* out, void* scratch,
                                 int n, float beam, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* sp = (const float*)s;
  float* op = (float*)out;
  const bool vec = ((uintptr_t)s % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (n <= BP_SMALL) {
    // V = the 16-byte loads a thread needs: a kernel sized to N beat one
    // V = 8 kernel with its loads past N predicated off, below N = 32768
    switch ((n + 4 * BP_THREADS - 1) / (4 * BP_THREADS)) {
      case 1: return (int)launch_small<1>(sp, op, n, beam, vec, st);
      case 2: return (int)launch_small<2>(sp, op, n, beam, vec, st);
      case 3: return (int)launch_small<3>(sp, op, n, beam, vec, st);
      case 4: return (int)launch_small<4>(sp, op, n, beam, vec, st);
      case 5: return (int)launch_small<5>(sp, op, n, beam, vec, st);
      case 6: return (int)launch_small<6>(sp, op, n, beam, vec, st);
      case 7: return (int)launch_small<7>(sp, op, n, beam, vec, st);
      default: return (int)launch_small<8>(sp, op, n, beam, vec, st);
    }
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  BpDevice d;
  cudaError_t e = bp_device(&d);
  if (e != cudaSuccess) return (int)e;
  const int g = min(d.sms, (n + BP_MIN_PER_BLOCK - 1) / BP_MIN_PER_BLOCK);
  int per_block = (int)(((long long)n + g - 1) / g);
  per_block = (per_block + 3) & ~3;
  const int grid = (int)(((long long)n + per_block - 1) / per_block);
  int staged = min(per_block, d.cap);
  const size_t smem = (size_t)staged * sizeof(float);
  void* kernel = vec ? (void*)bp_grid<true> : (void*)bp_grid<false>;
  static size_t allowed[2] = {0, 0};   // dynamic smem opted in so far
  e = vec ? allow_smem(bp_grid<true>, smem, &allowed[1], 256)
          : allow_smem(bp_grid<false>, smem, &allowed[0], 256);
  if (e != cudaSuccess) return (int)e;
  unsigned* w = (unsigned*)scratch;
  void* args[] = {(void*)&sp, (void*)&op, (void*)&w, (void*)&n,
                  (void*)&per_block, (void*)&staged, (void*)&beam};
  e = cudaLaunchCooperativeKernel(kernel, grid, BP_THREADS, args, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
