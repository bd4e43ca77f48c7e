// Fused hypothesis unit for Hopper: hash merge + beam threshold + top-K.
//
// Replaces the TPU kernel `hypothesis_unit_pallas`
// (src/repro/kernels/hypothesis_unit.py) together with the argsort that
// its wrapper `ops._hypothesis_unit` (src/repro/kernels/ops.py) runs
// outside it.  One block of 1024 threads per slot row does the whole unit
// in shared memory; the row (N = K*(2C+1) candidates, 8320 at K=128,
// C=32) is read once and only the K winners are written.  No step sorts
// the row, and no step pays a barrier per sort pass (about 14 barriers in
// all where the bitonic sorts it replaces paid 100 or more):
//
//  A. Coalesced loads (warp w owns a contiguous run of the row, its lanes
//     on neighbouring candidates).  live = neither channel NaN and
//     max(pb, pnb) > NEG_INF/2, the same set as the plain version's
//     logaddexp(pb, pnb) > NEG_INF/2 (logaddexp lies in [max, max + ln 2],
//     and ln 2 is below half an ulp at 5e29) without an exp or a log.
//     Live candidates are compacted in original order (__ballot_sync,
//     __popc, one block scan) together with their hash, index and both
//     channels, so no later step reads global memory.
//  B. Grouping by hash without sorting: each live candidate goes to one of
//     ~L/2 buckets by a multiplicative hash of its hash (equal hashes share
//     a bucket), the buckets are laid out by one block scan, and each
//     candidate ranks itself within its bucket by original index, so every
//     bucket lists its candidates in original order.
//  C. A candidate is a segment head if no earlier candidate of its bucket
//     has its hash: the first occurrence, the plain version's
//     representative.  The head computes its segment's logsumexp of pb and
//     pnb -- the max, then a sum of exp in original index order, the order
//     the plain version sums in -- and tot = logaddexp(pb_m, pnb_m).
//  D. best = max tot (an order-preserving key, one atomicMax a warp).
//     Every head with tot >= best - beam sorts before every other head, so
//     the beam filter runs first.  Where more than max(K, HU_DIRECT) heads
//     survive, a radix select over the 48-bit key (tot, then the lower
//     original index) keeps the K largest.
//  E. The candidates left rank themselves by pairwise comparison of their
//     unique keys (eight lanes each); ranks below K are written, so ties in
//     tot go to the lowest original index, as `lax.top_k` breaks them.
//     Slots beyond get index 0, NEG_INF channels and valid = 0.
//  Lists are appended with one shared atomic a warp (ballot + popc).
//
// What bounds it: not bytes (about 100 KB a row, 0.03 us at 3.35 TB/s)
// but one SM per row: on the decoder's rows (N = 8320, a few hundred
// live) step A takes the largest share, and its load pass slows down in
// proportion to the loads each thread issues, so a cluster of blocks per
// row is the next step.  Rows up to
// HU_CARRY_N candidates keep their channels in shared memory; longer ones
// (up to 16384) keep them in a global scratch the wrapper allocates.
#include <cuda_runtime.h>
#include <stdint.h>
#include "smem.cuh"

namespace {

constexpr int HU_THREADS = 1024;
constexpr int HU_WARPS = HU_THREADS / 32;
constexpr int HU_MAX_N = 16384;
constexpr int HU_MAX_ROUNDS = HU_MAX_N / HU_THREADS;   // 32-candidate rounds
constexpr int HU_CARRY_N = 10240;   // rows up to this carry pb/pnb in smem
constexpr int HU_MAX_BUCKETS = 8192;
constexpr int HU_DIRECT = 256;   // up to this many survivors rank directly
constexpr size_t HU_STATIC_SMEM = 2048;      // at least the static arrays
constexpr size_t HU_MAX_SMEM = 227 * 1024;   // a block's shared memory
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

__device__ __forceinline__ uint32_t bucket_of(uint32_t h, int bits) {
  return bits ? (h * 2654435761u) >> (32 - bits) : 0u;
}

// Exclusive prefix sum of v over the block; *total gets the block's sum.
// Called by every thread.
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

// A segment's merged channel from its max m and its sum of exp: the
// logsumexp, NEG_INF where nothing survives (an all-dead or +inf channel).
__device__ __forceinline__ float merged(float m, float sum) {
  const float v = m + logf(sum);
  return v > NEG_INF / 2 ? v : NEG_INF;
}

// The segment whose head (first occurrence) is candidate p = perm[q0]
// with hash key: its members are the candidates perm[q], q in [q0, q1),
// with that hash, in original order.  Writes the merged channels (the
// max, then a sum of exp in original index order) into p's own slot,
// which no other segment reads.
__device__ __forceinline__ void merge_segment(int p, uint32_t key, int q0,
                                              int q1, const uint16_t* perm,
                                              const uint32_t* keyv,
                                              float* vpb, float* vpnb) {
  float mb = vpb[p], mnb = vpnb[p];
  for (int q = q0 + 1; q < q1; ++q) {
    const int o = perm[q];
    if (keyv[o] == key) {
      mb = fmaxf(mb, vpb[o]);
      mnb = fmaxf(mnb, vpnb[o]);
    }
  }
  float sb = 0.f, snb = 0.f;
  for (int q = q0; q < q1; ++q) {
    const int o = perm[q];
    if (keyv[o] == key) {
      sb += expf(vpb[o] - mb);
      snb += expf(vpnb[o] - mnb);
    }
  }
  vpb[p] = merged(mb, sb);
  vpnb[p] = merged(mnb, snb);
}

// The selection key of head p: tot's order, then the lower original index.
__device__ __forceinline__ uint64_t sel_key(const uint32_t* keyv,
                                            const uint16_t* orig, int p) {
  return ((uint64_t)keyv[p] << 16) | (uint64_t)(0xFFFFu - orig[p]);
}

__host__ __device__ inline int bucket_cap(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  p >>= 1;
  return p < 1 ? 1 : p > HU_MAX_BUCKETS ? HU_MAX_BUCKETS : p;
}

// keyv, vpb/vpnb (rows up to HU_CARRY_N), cnt, orig, tmp, perm, and the
// 64-bit keys of the candidates ranked in step E (at most
// max(K, HU_DIRECT), at most N)
size_t smem_bytes(int n, int k) {
  const size_t carry = n <= HU_CARRY_N ? 8 : 0;
  const int ranked = n < (k > HU_DIRECT ? k : HU_DIRECT)
                     ? n : (k > HU_DIRECT ? k : HU_DIRECT);
  return (size_t)n * (4 + carry + 6) + 4 * (bucket_cap(n) + 1) + 8
         + 8 * (size_t)ranked;
}

__global__ void __launch_bounds__(HU_THREADS, 1)
hypothesis_unit_kernel(const int32_t* __restrict__ hashes,
                       const float* __restrict__ pb,
                       const float* __restrict__ pnb,
                       int32_t* __restrict__ out_idx,
                       float* __restrict__ out_pb,
                       float* __restrict__ out_pnb,
                       uint8_t* __restrict__ out_valid,
                       float* __restrict__ scratch,
                       int N, int K, float beam) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ws[33];
  __shared__ int hist[256];
  __shared__ int counters[3];        // heads, survivors, selected
  __shared__ uint32_t best_ord;
  __shared__ uint64_t sel_prefix, sel_mask;
  __shared__ int sel_remaining;

  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool carry = N <= HU_CARRY_N;
  const int cap = (int)bucket_cap(N);
  uint32_t* keyv = reinterpret_cast<uint32_t*>(smem);      // hash, then tot
  float* vpb = carry ? reinterpret_cast<float*>(keyv + N)
                     : scratch + (size_t)row * 2 * N;
  float* vpnb = vpb + N;
  uint32_t* cnt = keyv + N + (carry ? 2 * N : 0);          // cap + 1
  uint16_t* orig = reinterpret_cast<uint16_t*>(cnt + cap + 1);
  uint16_t* tmp = orig + N;
  uint16_t* perm = tmp + N;
  const int32_t* h = hashes + (size_t)row * N;
  const float* b_ = pb + (size_t)row * N;
  const float* nb = pnb + (size_t)row * N;

  // A. liveness (coalesced, all loads of the row issued at once), then
  //    the live candidates compacted in original order
  const int cw = ((N + HU_WARPS - 1) / HU_WARPS + 31) & ~31;
  const int rounds = cw / 32;
  uint32_t livebits = 0;             // bit r: this lane's round-r candidate
#pragma unroll
  for (int r = 0; r < HU_MAX_ROUNDS; ++r) {
    const int i = warp * cw + r * 32 + lane;
    if (r < rounds && i < N) {
      const float a = b_[i], c = nb[i];
      if (!isnan(a) && !isnan(c) && fmaxf(a, c) > NEG_INF / 2)
        livebits |= 1u << r;
    }
  }
  uint32_t mask[HU_MAX_ROUNDS];
  int nlive = 0;
#pragma unroll
  for (int r = 0; r < HU_MAX_ROUNDS; ++r) {
    mask[r] = __ballot_sync(0xffffffffu, (livebits >> r) & 1u);
    nlive += __popc(mask[r]);
  }
  if (threadIdx.x < 3) counters[threadIdx.x] = 0;
  if (threadIdx.x == 0) best_ord = 0;
  if (lane == 0) ws[warp] = nlive;
  __syncthreads();
  if (warp == 0) {
    const int own = ws[lane];
    int y = own;
    for (int o = 1; o < 32; o <<= 1) {
      const int z = __shfl_up_sync(0xffffffffu, y, o);
      if (lane >= o) y += z;
    }
    ws[lane] = y - own;
    if (lane == 31) ws[32] = y;
  }
  __syncthreads();
  const int L = ws[32];
  int bits = 0;                      // ~L/2 buckets (B), zeroed here
  while ((1 << (bits + 1)) < L && (1 << (bits + 1)) <= cap) ++bits;
  const int nbk = 1 << bits;
  for (int i = threadIdx.x; i <= nbk; i += blockDim.x) cnt[i] = 0;
  int run = ws[warp];
  const uint32_t below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < HU_MAX_ROUNDS; ++r) {
    if ((mask[r] >> lane) & 1u) {
      const int i = warp * cw + r * 32 + lane;
      const int p = run + __popc(mask[r] & below);
      keyv[p] = (uint32_t)h[i];
      orig[p] = (uint16_t)i;
      vpb[p] = b_[i];
      vpnb[p] = nb[i];
    }
    run += __popc(mask[r]);
  }
  __syncthreads();

  // B. equal hashes grouped without sorting: buckets of about two live
  //    candidates, laid out by one block scan, each listing its
  //    candidates in original order.
  // C. segment heads (the first occurrence of each live hash in its
  //    bucket) and their merged channels; the heads are appended to
  //    `tmp`, one atomic a warp.
  const uint32_t full = 0xffffffffu;
  for (int p = threadIdx.x; p < L; p += blockDim.x)
    perm[p] = (uint16_t)atomicAdd(&cnt[bucket_of(keyv[p], bits)], 1u);
  __syncthreads();
  {
    const int per = (nbk + blockDim.x - 1) / blockDim.x;
    const int lo = threadIdx.x * per, hi = min(lo + per, nbk);
    int sum = 0;
    for (int i = lo; i < hi; ++i) sum += (int)cnt[i];
    int total;
    int off = block_exclusive_scan(sum, ws, &total);
    for (int i = lo; i < hi; ++i) {
      const int c = (int)cnt[i];
      cnt[i] = (uint32_t)off;
      off += c;
    }
    if (threadIdx.x == 0) cnt[nbk] = (uint32_t)L;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < L; p += blockDim.x)
    tmp[cnt[bucket_of(keyv[p], bits)] + perm[p]] = (uint16_t)p;
  __syncthreads();
  for (int j = threadIdx.x; j < L; j += blockDim.x) {
    const int p = tmp[j];
    const uint32_t bk = bucket_of(keyv[p], bits);
    const int s0 = (int)cnt[bk], s1 = (int)cnt[bk + 1];
    int rank = 0;
    for (int q = s0; q < s1; ++q) rank += tmp[q] < p;
    perm[s0 + rank] = (uint16_t)p;
  }
  __syncthreads();
  for (int j0 = 0; j0 < L; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    int p = 0;
    bool head = false;
    if (j < L) {
      p = perm[j];
      const uint32_t key = keyv[p];
      const uint32_t bk = bucket_of(key, bits);
      const int s0 = (int)cnt[bk], s1 = (int)cnt[bk + 1];
      head = true;
      for (int q = j - 1; q >= s0; --q)
        if (keyv[perm[q]] == key) {
          head = false;
          break;
        }
      if (head) merge_segment(p, key, j, s1, perm, keyv, vpb, vpnb);
    }
    const uint32_t hm = __ballot_sync(full, head);
    int base = 0;
    if (lane == 0 && hm) base = atomicAdd(&counters[0], __popc(hm));
    base = __shfl_sync(full, base, 0);
    if (head) tmp[base + __popc(hm & below)] = (uint16_t)p;
  }
  __syncthreads();
  const int H = counters[0];
  for (int i0 = 0; i0 < H; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    uint32_t o = 0;
    if (i < H) {
      const int p = tmp[i];
      o = ord_f(logaddexp_f(vpb[p], vpnb[p]) + 0.0f);   // -0 keys as +0
      keyv[p] = o;
    }
    o = __reduce_max_sync(full, o);
    if (lane == 0) atomicMax(&best_ord, o);
  }
  __syncthreads();

  // D. the beam filter: survivors into `perm`
  const float best = H > 0 ? unord_f(best_ord) : NEG_INF;
  const float floor_ = best - beam;
  for (int i0 = 0; i0 < H; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    int p = 0;
    bool keep = false;
    if (i < H) {
      p = tmp[i];
      const float t = unord_f(keyv[p]);
      keep = t > NEG_INF / 2 && t >= floor_;
    }
    const uint32_t km = __ballot_sync(full, keep);
    int base = 0;
    if (lane == 0 && km) base = atomicAdd(&counters[1], __popc(km));
    base = __shfl_sync(full, base, 0);
    if (keep) perm[base + __popc(km & below)] = (uint16_t)p;
  }
  __syncthreads();
  const int S = counters[1];
  const uint16_t* sel = perm;
  int C = S;
  if (S > K && S > HU_DIRECT) {
    // radix select of the K-th largest 48-bit key, 8 bits a pass
    // (histogram counts aggregated per warp over equal digits)
    if (threadIdx.x == 0) {
      sel_prefix = 0;
      sel_mask = 0;
      sel_remaining = K;
    }
    for (int shift = 40; shift >= 0; shift -= 8) {
      if (threadIdx.x < 256) hist[threadIdx.x] = 0;
      __syncthreads();
      const uint64_t pre = sel_prefix, pm = sel_mask;
      for (int i0 = 0; i0 < S; i0 += blockDim.x) {
        const int i = i0 + threadIdx.x;
        uint64_t u = 0;
        const bool act = i < S && ((u = sel_key(keyv, orig, perm[i])) & pm)
                                      == pre;
        const uint32_t am = __ballot_sync(full, act);
        if (act) {
          const int digit = (int)((u >> shift) & 255);
          const uint32_t peers = __match_any_sync(am, digit);
          if (lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
        }
      }
      __syncthreads();
      if (warp == 0) {                 // lane l: digits 255-8l .. 248-8l
        int part = 0;
        for (int d = 0; d < 8; ++d) part += hist[255 - 8 * lane - d];
        int incl = part;
        for (int o = 1; o < 32; o <<= 1) {
          const int z = __shfl_up_sync(full, incl, o);
          if (lane >= o) incl += z;
        }
        const int rem = sel_remaining;
        const uint32_t hit = __ballot_sync(full, incl >= rem);
        if (lane == __ffs(hit) - 1) {
          int cum = incl - part;
          for (int d = 0; d < 8; ++d) {
            const int digit = 255 - 8 * lane - d;
            if (cum + hist[digit] >= rem) {
              sel_prefix = pre | ((uint64_t)digit << shift);
              sel_mask = pm | ((uint64_t)255 << shift);
              sel_remaining = rem - cum;
              break;
            }
            cum += hist[digit];
          }
        }
      }
      __syncthreads();
    }
    const uint64_t kth = sel_prefix;     // the K-th largest key (unique)
    for (int i0 = 0; i0 < S; i0 += blockDim.x) {
      const int i = i0 + threadIdx.x;
      int p = 0;
      bool in = false;
      if (i < S) {
        p = perm[i];
        in = sel_key(keyv, orig, p) >= kth;
      }
      const uint32_t im = __ballot_sync(full, in);
      int base = 0;
      if (lane == 0 && im) base = atomicAdd(&counters[2], __popc(im));
      base = __shfl_sync(full, base, 0);
      if (in) tmp[base + __popc(im & below)] = (uint16_t)p;
    }
    __syncthreads();
    sel = tmp;
    C = K;
  }

  // E. each candidate's rank among the C left (eight lanes a candidate,
  //    each comparing with an eighth of them); ranks below K are written
  const size_t o0 = (size_t)row * K;
  uint64_t* ukey = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(perm + N) + 7) & ~(uintptr_t)7);
  for (int i = threadIdx.x; i < C; i += blockDim.x)
    ukey[i] = sel_key(keyv, orig, sel[i]);
  __syncthreads();
  for (int base = 0; base < C; base += blockDim.x / 8) {
    const int i = base + (threadIdx.x >> 3), part = threadIdx.x & 7;
    int r = 0;
    if (i < C) {
      const uint64_t u = ukey[i];
#pragma unroll 4
      for (int j = part; j < C; j += 8) r += ukey[j] > u;
    }
    r += __shfl_xor_sync(full, r, 1);
    r += __shfl_xor_sync(full, r, 2);
    r += __shfl_xor_sync(full, r, 4);
    if (i < C && part == 0 && r < K) {
      const int p = sel[i];
      out_idx[o0 + r] = orig[p];
      out_pb[o0 + r] = vpb[p];
      out_pnb[o0 + r] = vpnb[p];
      out_valid[o0 + r] = 1;
    }
  }
  for (int r = min(C, K) + threadIdx.x; r < K; r += blockDim.x) {
    out_idx[o0 + r] = 0;
    out_pb[o0 + r] = NEG_INF;
    out_pnb[o0 + r] = NEG_INF;
    out_valid[o0 + r] = 0;
  }
}

}  // namespace

// scratch: (B, 2, N) f32 for rows longer than HU_CARRY_N, else unused.
extern "C" int hypothesis_unit_launch(const void* hashes, const void* pb,
                                      const void* pnb, void* idx, void* opb,
                                      void* opnb, void* ovalid, void* scratch,
                                      int B, int N, int K, float beam,
                                      void* stream) {
  if (B <= 0) return 0;
  if (N < 1 || N > HU_MAX_N || K > N || K < 1 ||
      (N > HU_CARRY_N && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(N, K);
  if (smem + HU_STATIC_SMEM > HU_MAX_SMEM) return (int)cudaErrorInvalidValue;
  static size_t allowed = 0;           // dynamic smem opted in so far
  const cudaError_t e = allow_smem(hypothesis_unit_kernel, smem, &allowed,
                                   HU_STATIC_SMEM);
  if (e != cudaSuccess) return (int)e;
  hypothesis_unit_kernel<<<B, HU_THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)hashes, (const float*)pb, (const float*)pnb,
      (int32_t*)idx, (float*)opb, (float*)opnb, (uint8_t*)ovalid,
      (float*)scratch, N, K, beam);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
