// Fused hypothesis unit for Hopper: hash merge + beam threshold + top-K.
//
// Replaces the TPU kernel `hypothesis_unit_pallas`
// (src/repro/kernels/hypothesis_unit.py) together with the argsort that
// its wrapper `ops._hypothesis_unit` (src/repro/kernels/ops.py) runs
// outside it.  One block per slot row does the whole unit in shared
// memory; the row (N = K*(2C+1) candidates, 8320 at K=128, C=32) is read
// once and only the K winners are written.
//
//  1. Live candidates (logaddexp(pb, pnb) > NEG_INF/2) are compacted, in
//     original order, into 64-bit keys (hash << 16 | original index);
//     dead candidates never enter the sort (they can never merge with a
//     live hash, as the reference's out-of-range sentinel key ensures).
//  2. Bitonic sort of the L live keys padded to the next power of two:
//     (hash, original index) ascending, so each hash's segment lists its
//     candidates in original order.
//  3. The head of each segment (its first occurrence) computes the
//     segment's logsumexp of pb and of pnb -- max, then a sum of exp in
//     original index order, the order the plain version sums in -- and
//     tot = logaddexp(pb_m, pnb_m).  Merged channels go to a per-row
//     scratch array, indexed by sorted position.
//  4. The H heads are compacted and sorted again on (tot descending,
//     original index ascending): the first K are the top-K with ties to
//     the lowest original index, as `lax.top_k` breaks them.
//  5. valid = tot >= best - beam; slots beyond H or below the threshold
//     get index 0 and NEG_INF channels.
//
// What bounds it: not bytes (about 100 KB per row) but the two sorts'
// shared-memory passes (m(m+1)/2 passes with a barrier each for 2^m
// keys) on one block per row, so only B of the card's 132 SMs work.
// Compacting the live candidates and then the heads keeps both sorts as
// short as the data allows: in decoding most of the K*2C extension
// candidates are dead (trie nodes have few children).
#include <cuda_runtime.h>
#include <stdint.h>
#include "smem.cuh"

namespace {

constexpr int HU_THREADS = 1024;
constexpr int HU_MAX_NP = 16384;
constexpr int HU_MAX_ITEMS = HU_MAX_NP / HU_THREADS;
constexpr float NEG_INF = -1e30f;

// torch.logaddexp / jnp.logaddexp: max + log1p(exp(-|a - b|)).
__device__ __forceinline__ float logaddexp_f(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// Order-preserving map of a float onto uint32 (ascending floats give
// ascending integers).
__device__ __forceinline__ uint32_t ord_f(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unord_f(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

// Ascending bitonic sort of np (a power of two) keys in shared memory.
__device__ void bitonic_sort(uint64_t* s, int np) {
  for (int k = 2; k <= np; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < np; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t a = s[i], b = s[ixj];
          const bool up = (i & k) == 0;
          if ((a > b) == up) {
            s[i] = b;
            s[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ uint32_t key_of(uint64_t e) {
  return (uint32_t)(e >> 16);
}

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32,
// at most 1024); *total gets the block's sum.  Called by every thread.
__device__ int block_exclusive_scan(int v, int* ws, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;              // warp totals
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    const int own = lane < nw ? ws[lane] : 0;
    int y = own;
    for (int o = 1; o < 32; o <<= 1) {
      const int z = __shfl_up_sync(0xffffffffu, y, o);
      if (lane >= o) y += z;
    }
    if (lane < nw) ws[lane] = y - own;       // exclusive warp offsets
    if (lane == 31) ws[32] = y;
  }
  __syncthreads();
  const int out = ws[warp] + x - v;
  *total = ws[32];
  __syncthreads();                           // `ws` is reused
  return out;
}

__device__ __forceinline__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__global__ void __launch_bounds__(HU_THREADS)
hypothesis_unit_kernel(const int32_t* __restrict__ hashes,
                       const float* __restrict__ pb,
                       const float* __restrict__ pnb,
                       int32_t* __restrict__ out_idx,
                       float* __restrict__ out_pb,
                       float* __restrict__ out_pnb,
                       uint8_t* __restrict__ out_valid,
                       float2* __restrict__ scratch,
                       int N, int np, int K, float beam) {
  extern __shared__ uint64_t s[];            // up to np packed keys
  __shared__ int ws[33];
  const int row = blockIdx.x;
  const int32_t* h = hashes + (size_t)row * N;
  const float* b_ = pb + (size_t)row * N;
  const float* nb = pnb + (size_t)row * N;
  float2* merged = scratch + (size_t)row * np;

  // 1. compact the live candidates, in original order (each thread owns
  //    a contiguous run of at most HU_MAX_ITEMS candidates)
  const int ipt = (N + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * ipt, hi = min(lo + ipt, N);
  uint32_t live = 0;
  int cnt = 0;
  for (int i = lo; i < hi; ++i) {
    if (logaddexp_f(b_[i], nb[i]) > NEG_INF / 2) {
      live |= 1u << (i - lo);
      ++cnt;
    }
  }
  int L;
  int off = block_exclusive_scan(cnt, ws, &L);
  for (int i = lo; i < hi; ++i)
    if ((live >> (i - lo)) & 1u)
      s[off++] = ((uint64_t)(uint32_t)h[i] << 16) | (uint64_t)i;
  const int np1 = next_pow2(L);
  for (int i = L + threadIdx.x; i < np1; i += blockDim.x) s[i] = ~0ull;
  __syncthreads();

  // 2. (hash, original index) ascending
  bitonic_sort(s, np1);

  // 3. segment heads: merged channels and the selection key
  uint64_t sel[HU_MAX_ITEMS];
  int nh = 0;
  const int ipt2 = (np1 + blockDim.x - 1) / blockDim.x;
  const int lo2 = threadIdx.x * ipt2, hi2 = min(lo2 + ipt2, L);
  for (int p = lo2; p < hi2; ++p) {
    const uint64_t e = s[p];
    const uint32_t key = key_of(e);
    if (p > 0 && key_of(s[p - 1]) == key) continue;
    int end = p + 1;
    while (end < L && key_of(s[end]) == key) ++end;
    const uint32_t orig = (uint32_t)(e & 0xFFFFu);
    float mb = b_[orig], mnb = nb[orig];
    for (int q = p + 1; q < end; ++q) {
      const int o = (int)(s[q] & 0xFFFFu);
      mb = fmaxf(mb, b_[o]);
      mnb = fmaxf(mnb, nb[o]);
    }
    float sb = 0.f, snb = 0.f;
    for (int q = p; q < end; ++q) {          // original index order
      const int o = (int)(s[q] & 0xFFFFu);
      sb += expf(b_[o] - mb);
      snb += expf(nb[o] - mnb);
    }
    float pbm = mb + logf(sb);
    float pnbm = mnb + logf(snb);
    pbm = pbm > NEG_INF / 2 ? pbm : NEG_INF;
    pnbm = pnbm > NEG_INF / 2 ? pnbm : NEG_INF;
    merged[p] = make_float2(pbm, pnbm);
    const float tot = logaddexp_f(pbm, pnbm) + 0.0f;   // -0.0 keys as +0.0
    // ascending order of this key = tot descending, then original index
    sel[nh++] = ((uint64_t)(~ord_f(tot)) << 32) | ((uint64_t)orig << 16)
                | (uint64_t)p;
  }
  int H;
  const int off2 = block_exclusive_scan(nh, ws, &H);  // every scan is done
  for (int j = 0; j < nh; ++j) s[off2 + j] = sel[j];
  const int np2 = next_pow2(H);
  for (int i = H + threadIdx.x; i < np2; i += blockDim.x) s[i] = ~0ull;
  __syncthreads();

  // 4. top-K of the heads
  bitonic_sort(s, np2);

  // 5. threshold + outputs
  const float best = H > 0 ? unord_f(~(uint32_t)(s[0] >> 32)) : NEG_INF;
  const float floor_ = best - beam;
  for (int r = threadIdx.x; r < K; r += blockDim.x) {
    bool v = false;
    int orig = 0;
    float2 m = make_float2(NEG_INF, NEG_INF);
    if (r < H) {
      const uint64_t e = s[r];
      const float t = unord_f(~(uint32_t)(e >> 32));
      v = (t > NEG_INF / 2) && (t >= floor_);
      if (v) {
        orig = (int)((e >> 16) & 0xFFFFu);
        m = merged[e & 0xFFFFu];
      }
    }
    const size_t o = (size_t)row * K + r;
    out_idx[o] = orig;
    out_pb[o] = m.x;
    out_pnb[o] = m.y;
    out_valid[o] = v ? 1 : 0;
  }
}

}  // namespace

extern "C" int hypothesis_unit_launch(const void* hashes, const void* pb,
                                      const void* pnb, void* idx, void* opb,
                                      void* opnb, void* ovalid, void* scratch,
                                      int B, int N, int np, int K, float beam,
                                      void* stream) {
  if (B <= 0) return 0;
  if (np < N || np > HU_MAX_NP || (np & (np - 1)) != 0 || K > N || K < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)np * sizeof(uint64_t);
  static size_t allowed = 0;           // dynamic smem opted in so far
  const cudaError_t e = allow_smem(hypothesis_unit_kernel, smem, &allowed);
  if (e != cudaSuccess) return (int)e;
  hypothesis_unit_kernel<<<B, HU_THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)hashes, (const float*)pb, (const float*)pnb,
      (int32_t*)idx, (float*)opb, (float*)opnb, (uint8_t*)ovalid,
      (float2*)scratch, N, np, K, beam);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
