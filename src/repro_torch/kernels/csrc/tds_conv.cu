// Causal strided TDS time convolution with the fused epilogue and an
// optional LayerNorm over each output row, for Hopper.
//
// Replaces the TPU kernel `tds_conv_pallas` (src/repro/kernels/tds_conv.py)
// and, where a LayerNorm follows the conv in the TDS model, the
// `norm_pallas` launch after it (src/repro/kernels/layernorm.py):
//   y[b, t, w, co] = relu?(sum_{j<k, c<Cin} x[b, t*stride + j, w, c] *
//                          wt[j, c, co] + bias[co]) (+ res[b, t, w, co])
// in the TDS order (bias, then ReLU, then the residual), and with the
// LayerNorm on, out[b, t] = layernorm(y[b, t] as one row of D = W*Cout
// values): the mean, then the mean of squared deviations (population
// variance), then (y - mu) * rsqrt(var + eps) * scale + shift.  The
// pre-LayerNorm activation never reaches device memory.
//
// What bounds it on the H100: neither roof.  At the main path's shapes a
// launch moves a few hundred KB and does at most ~10 M FMAs (0.1-0.3 us
// at the HBM rate or the fp32 peak); latency sets the time: the global
// loads, the barriers and the launch itself.  Channel counts are at most
// 23, which fill no wgmma tile, and TF32 mma.sync would break the 1e-5
// tolerances, so the products are fp32 FMAs on the CUDA cores.
//
// The design (each choice measured on the H100 against the alternatives
// that PERF.md names):
//   * a LayerNorm row (b, t) is the unit of the grid.  `split` blocks
//     share a row, each taking ceil(W / split) of its W positions: about
//     96 blocks over the step's rows, at most 6 a row.  With the
//     LayerNorm the row's blocks form a thread block cluster.  split = 1
//     is the block-per-row variant (no cluster), kept for the comparison;
//     it is slower at every main-path shape, one SM doing a row's FMAs.
//   * each block stages its slice of the row's k input frames (16-byte
//     cp.async; 4-byte where a frame is not 16-byte aligned) and the
//     whole k x Cin x Cout weight (16-byte cp.async) in shared memory.
//   * a thread owns 2 positions, 8 output channels and a group of taps,
//     with its 16 accumulators in registers: each broadcast weight read
//     feeds 2 FMAs and each x read 8.  The tap groups' partial sums meet
//     in shared memory and are added in order.
//   * the epilogue holds the row's values in registers (1, 2 or 4 a
//     thread, the fewest that fit) from the bias to the normalised output,
//     which is written once.  The statistics: each warp reduces its count,
//     sum and squared deviations from its own mean with shuffles and
//     pushes them into every block of the cluster (distributed shared
//     memory); after one cluster barrier every warp combines them in one
//     fixed order (Chan et al.: the two-pass mean and population variance,
//     the same bits in every block).  Two cluster-wide reductions, one
//     for the mean and one for the variance, measured slower.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "smem.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CPT = 8;          // output channels a thread accumulates
constexpr int PPT = 2;          // positions a thread accumulates
constexpr int MAX_THREADS = 512;
constexpr int MAX_SPLIT = 8;    // portable cluster size
constexpr int NUM_SMS = 132;
constexpr int ROW_BLOCKS = 96;  // blocks the LayerNorm rows aim to fill
constexpr int AUTO_SPLIT = 6;   // at most this many blocks a row, by default
constexpr size_t MAX_SMEM = 227 * 1024;

// the statistics' exchange: 3 values a warp of every block of a row
constexpr int RED_FLOATS = 3 * MAX_SPLIT * (MAX_THREADS / 32);
constexpr size_t STATIC_SMEM = RED_FLOATS * sizeof(float);

struct ConvArgs {
  const float* x;          // (B, Tp, W, Cin)
  const float* wt;         // (k, Cin, Cout)
  const float* bias;       // (Cout,)
  const float* res;        // (B, t_out, W, Cout) or null
  const float* ln_scale;   // (W*Cout,), with ln_shift; null: no LayerNorm
  const float* ln_shift;
  float* out;              // (B, t_out, W, Cout)
  int Tp, W, Cin, Cout, k, stride, t_out, relu;
  int split;               // blocks per row
  int npos;                // positions per block, ceil(W / split)
  int groups, taps;        // tap groups per position, taps per group
  int fs;                  // floats per staged frame (multiple of 4)
  int threads;             // threads per block
  int ept;                 // LayerNorm values a thread holds
  float eps;
};

// the staged weight with its 8 zeros, rounded to 16 bytes
__host__ __device__ __forceinline__ int weight_floats(const ConvArgs& a) {
  return (a.k * a.Cin * a.Cout + 8 + 3) & ~3;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The row's mean and variance from every warp's (count, sum, M2), M2 the
// sum of squared deviations from the warp's own mean: mu = sum / D and
// var = sum over warps of (M2 + count * (warp mean - mu)^2) / D, the
// two-pass statistics combined exactly (Chan et al.).  Lane r of each
// warp pushes its triple into block r of the cluster (distributed shared
// memory), so one cluster barrier suffices and no block reads another's
// shared memory afterwards; every warp of every block then sums the same
// values in the same order and gets the same bits.  `red` holds
// RED_FLOATS floats.
__device__ __forceinline__ void row_stats(float n, float s, float m2,
                                          float* red, int split, int rank,
                                          float d_row, float& mu,
                                          float& var) {
  constexpr int S = MAX_SPLIT * (MAX_THREADS / 32);
  const int nwarps = blockDim.x >> 5, lane = threadIdx.x & 31;
  const int slot = rank * nwarps + (threadIdx.x >> 5);
  if (split == 1) {
    if (lane == 0) {
      red[slot] = n;
      red[S + slot] = s;
      red[2 * S + slot] = m2;
    }
    __syncthreads();
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    cluster_wait();             // the kernel's first phase: all blocks run
    if (lane < split) {
      float* dst = cluster.map_shared_rank(red, lane);
      dst[slot] = n;
      dst[S + slot] = s;
      dst[2 * S + slot] = m2;
    }
    cluster_arrive();
    cluster_wait();
  }
  const int total = nwarps * split;
  float t = 0.f;
  for (int i = lane; i < total; i += 32) t += red[S + i];
  mu = warp_sum(t) / d_row;
  t = 0.f;
  for (int i = lane; i < total; i += 32) {
    const float ni = red[i];
    if (ni > 0.f) {
      const float d = red[S + i] / ni - mu;
      t += red[2 * S + i] + ni * d * d;
    }
  }
  var = warp_sum(t) / d_row;
}

// EPT: the LayerNorm values a thread holds, 1, 2 or 4 (the fewest that
// fit one block: the fewer, the faster); 1 without the LayerNorm.
template <int COP, bool LN, int EPT>
__global__ void __launch_bounds__(MAX_THREADS)
tds_conv_kernel(const ConvArgs a) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);        // k x Cin x Cout + 8
  float* part = ws + weight_floats(a);                // groups x npos x COP
  float* xs = part + a.groups * a.npos * COP;         // k x fs
  float* bs = xs + a.k * a.fs;                        // COP
  __shared__ float red[RED_FLOATS];
  // with a cluster, the first barrier phase tells each block that all
  // of them run (and may be written to); it is waited on just before the
  // statistics are exchanged
  if (LN && a.split > 1) cluster_arrive_relaxed();

  const int nthr = blockDim.x;
  const int row = blockIdx.x / a.split;               // (b, t)
  const int rank = blockIdx.x - row * a.split;        // block rank in the row
  const int w0 = rank * a.npos;
  const int nw = max(0, min(a.npos, a.W - w0));       // this block's positions
  const int b = row / a.t_out, t = row - b * a.t_out;
  const int rowx = a.W * a.Cin;                       // floats per frame of x

  // 1. stage the slice [w0, w0 + nw) x Cin of the k frames, the weight
  // and the bias, all asynchronously.  The weight is followed by 8 zeros:
  // the last channel group of the last (j, c) reads up to COP - Cout < 8
  // values past it.
  const float* xb = a.x + ((size_t)b * a.Tp + (size_t)t * a.stride) * rowx;
  const int lo = w0 * a.Cin, hi = (w0 + nw) * a.Cin;
  int xoff = 0;
  if (nw > 0) {
    if (rowx % 4 == 0 && ((uintptr_t)a.x & 15) == 0) {
      const int alo = lo & ~3, nv = (((hi + 3) & ~3) - alo) >> 2;
      xoff = lo - alo;
      for (int i = threadIdx.x; i < a.k * nv; i += nthr) {
        const int j = i / nv, v = i - j * nv;
        cp_async16(xs + j * a.fs + 4 * v, xb + (size_t)j * rowx + alo + 4 * v);
      }
    } else {
      const int n = hi - lo;
      for (int i = threadIdx.x; i < a.k * n; i += nthr) {
        const int j = i / n, v = i - j * n;
        cp_async4(xs + j * a.fs + v, xb + (size_t)j * rowx + lo + v);
      }
    }
  }
  const int nwt = a.k * a.Cin * a.Cout;
  const int nwt4 = ((uintptr_t)a.wt & 15) == 0 ? nwt / 4 : 0;
  for (int i = threadIdx.x; i < nwt4; i += nthr)
    cp_async16(ws + 4 * i, a.wt + 4 * i);
  for (int i = 4 * nwt4 + threadIdx.x; i < nwt; i += nthr)
    cp_async4(ws + i, a.wt + i);
  for (int i = nwt + threadIdx.x; i < nwt + 8; i += nthr) ws[i] = 0.f;
  for (int i = threadIdx.x; i < COP; i += nthr) {
    if (i < a.Cout) cp_async4(bs + i, a.bias + i);
    else bs[i] = 0.f;
  }
  // element e of the block's output slice is (w0 + e / Cout, e % Cout), at
  // obase + e in the output, the residual and (less the row) the
  // LayerNorm's scale and shift.  The LayerNorm path loads its residual
  // values now, under the copies and the conv.
  const int nel = nw * a.Cout;
  const size_t obase = (size_t)row * a.W * a.Cout + (size_t)w0 * a.Cout;
  float r[EPT];
  if constexpr (LN) {
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int e = threadIdx.x + i * nthr;
      r[i] = (a.res != nullptr && e < nel) ? __ldg(a.res + obase + e) : 0.f;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. the conv.  Unit (g, cg, wl): taps [g*taps, (g+1)*taps) of output
  // channels [cg*CPT, (cg+1)*CPT) at the PPT positions wl + m*nq; wl varies
  // fastest, so the lanes of a warp read the same weights (a broadcast)
  // and distinct x (Cin apart: no bank conflict for odd Cin).
  constexpr int NCG = COP / CPT;
  const int nq = (nw + PPT - 1) / PPT;
  const int per_g = NCG * nq;
  for (int u = threadIdx.x; u < a.groups * per_g; u += nthr) {
    const int g = u / per_g, cw = u - g * per_g;
    const int cg = cw / nq, wl = cw - cg * nq;
    float acc[PPT][CPT];
#pragma unroll
    for (int m = 0; m < PPT; ++m)
#pragma unroll
      for (int q = 0; q < CPT; ++q) acc[m][q] = 0.f;
    const int j1 = min(a.k, (g + 1) * a.taps);
    for (int j = g * a.taps; j < j1; ++j) {
      const float* xr = xs + j * a.fs + xoff + wl * a.Cin;
      const float* wr = ws + j * a.Cin * a.Cout + cg * CPT;
#pragma unroll 2
      for (int c = 0; c < a.Cin; ++c) {
        float xv[PPT];
#pragma unroll
        for (int m = 0; m < PPT; ++m)
          xv[m] = wl + m * nq < nw ? xr[m * nq * a.Cin + c] : 0.f;
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          const float wv = wr[c * a.Cout + q];
#pragma unroll
          for (int m = 0; m < PPT; ++m) acc[m][q] = fmaf(xv[m], wv, acc[m][q]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < PPT; ++m) {
      if (wl + m * nq < nw) {
        float4* pr = reinterpret_cast<float4*>(
            part + (g * a.npos + wl + m * nq) * COP + cg * CPT);
#pragma unroll
        for (int q = 0; q < CPT / 4; ++q)
          pr[q] = make_float4(acc[m][4 * q], acc[m][4 * q + 1],
                              acc[m][4 * q + 2], acc[m][4 * q + 3]);
      }
    }
  }
  __syncthreads();

  // 3. the epilogue: bias -> ReLU -> residual, then the store or the
  // LayerNorm over the row
  auto conv = [&](int e) {
    const int wl = e / a.Cout, co = e - wl * a.Cout;
    float y = 0.f;
    for (int g = 0; g < a.groups; ++g) y += part[(g * a.npos + wl) * COP + co];
    y += bs[co];
    return a.relu ? fmaxf(y, 0.f) : y;
  };
  if constexpr (!LN) {
    for (int e = threadIdx.x; e < nel; e += nthr) {
      float y = conv(e);
      if (a.res != nullptr) y += __ldg(a.res + obase + e);
      a.out[obase + e] = y;
    }
  } else {
    const float* sc = a.ln_scale + (size_t)w0 * a.Cout;
    const float* sh = a.ln_shift + (size_t)w0 * a.Cout;
    float v[EPT], scale[EPT], shift[EPT];
    int nv = 0;                                 // this thread's values
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int e = threadIdx.x + i * nthr;
      v[i] = scale[i] = shift[i] = 0.f;
      if (e < nel) {
        scale[i] = __ldg(sc + e);       // used after the statistics
        shift[i] = __ldg(sh + e);
        v[i] = conv(e) + r[i];
        sum += v[i];
        ++nv;
      }
    }
    const float wn = warp_sum((float)nv), wsum = warp_sum(sum);
    const float wmu = wn > 0.f ? wsum / wn : 0.f;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      if (i < nv) {
        const float d = v[i] - wmu;
        q = fmaf(d, d, q);
      }
    }
    float mu, var;
    row_stats(wn, wsum, warp_sum(q), red, a.split, rank,
              (float)(a.W * a.Cout), mu, var);
    const float inv = rsqrtf(var + a.eps);
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int e = threadIdx.x + i * nthr;
      if (e < nel) a.out[obase + e] = (v[i] - mu) * inv * scale[i] + shift[i];
    }
  }
}

int cop_of(int cout) { return cout <= 8 ? 8 : cout <= 16 ? 16 : 24; }

size_t smem_bytes(const ConvArgs& a) {
  const int cop = cop_of(a.Cout);
  return sizeof(float) * ((size_t)weight_floats(a) +
                          (size_t)a.groups * a.npos * cop +
                          (size_t)a.k * a.fs + cop);
}

// Positions per block, tap groups, threads and the staged frame width for
// `split` blocks per row.  The fewest taps a group whose units (groups x
// channel groups x positions) fit one block; with the LayerNorm, at least
// enough threads to hold the block's values, `ept` a thread (the fewest
// of 1, 2 and 4 that fits).
void plan(ConvArgs& a, int split, bool ln) {
  a.split = split;
  a.npos = (a.W + split - 1) / split;
  const int per_g = cop_of(a.Cout) / CPT * ((a.npos + PPT - 1) / PPT);
  a.taps = a.k;
  for (int taps = 1; taps <= a.k; ++taps)
    if ((a.k + taps - 1) / taps * per_g <= MAX_THREADS) {
      a.taps = taps;
      break;
    }
  a.groups = (a.k + a.taps - 1) / a.taps;
  int threads = a.groups * per_g;
  const int nel = a.npos * a.Cout;
  a.ept = 1;
  if (ln) {
    while (a.ept < 4 && nel > a.ept * MAX_THREADS) a.ept *= 2;
    threads = max(threads, (nel + a.ept - 1) / a.ept);
  }
  threads = (threads + 31) / 32 * 32;
  a.threads = threads < 32 ? 32 : threads > MAX_THREADS ? MAX_THREADS : threads;
  a.fs = (a.npos * a.Cin + 6 + 3) & ~3;   // + the 16-byte alignment slack
}

bool fits(const ConvArgs& a, bool ln) {
  return smem_bytes(a) <= MAX_SMEM &&
         (!ln || a.npos * a.Cout <= a.ept * a.threads);
}

template <int COP, bool LN, int EPT>
int launch(const ConvArgs& a, int rows, cudaStream_t stream) {
  const size_t smem = smem_bytes(a);
  static size_t allowed = 0;              // dynamic smem opted in so far
  cudaError_t e = allow_smem(tds_conv_kernel<COP, LN, EPT>, smem, &allowed,
                             STATIC_SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * a.split));
  cfg.blockDim = dim3(a.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (LN && a.split > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = a.split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  // cudaLaunchKernelEx reports its own launch's status
  return (int)cudaLaunchKernelEx(&cfg, tds_conv_kernel<COP, LN, EPT>, a);
}

template <int COP>
int launch_ept(const ConvArgs& a, int rows, cudaStream_t s) {
  if (a.ln_scale == nullptr) return launch<COP, false, 1>(a, rows, s);
  if (a.ept == 1) return launch<COP, true, 1>(a, rows, s);
  if (a.ept == 2) return launch<COP, true, 2>(a, rows, s);
  return launch<COP, true, 4>(a, rows, s);
}

int launch_cop(const ConvArgs& a, int rows, cudaStream_t s) {
  if (a.Cout <= 8) return launch_ept<8>(a, rows, s);
  if (a.Cout <= 16) return launch_ept<16>(a, rows, s);
  return launch_ept<24>(a, rows, s);
}

}  // namespace

// ln_scale/ln_shift null: the conv alone (`tds_conv`); else the conv with
// the LayerNorm epilogue (`tds_conv_ln`).  split: blocks per row, 0 to
// choose, 1 for the block-per-row variant (up to 8 with the LayerNorm).
extern "C" int tds_conv_launch(const void* x, const void* wt, const void* bias,
                               const void* res, const void* ln_scale,
                               const void* ln_shift, void* out, int B, int Tp,
                               int W, int Cin, int Cout, int k, int stride,
                               int t_out, int relu, int split, float eps,
                               void* stream) {
  const int rows = B * t_out;
  if (rows == 0 || W == 0) return 0;
  if (Cout > 24 || Cout < 1 || Cin < 1 || k < 1 || split < 0)
    return (int)cudaErrorInvalidValue;
  const bool ln = ln_scale != nullptr;
  ConvArgs a = {(const float*)x, (const float*)wt, (const float*)bias,
                (const float*)res, (const float*)ln_scale,
                (const float*)ln_shift, (float*)out, Tp, W, Cin, Cout, k,
                stride, t_out, relu, 1, W, 1, k, 0, 32, 1, eps};
  const int most = ln ? (MAX_SPLIT < W ? MAX_SPLIT : W) : W;
  // with the LayerNorm, about 96 blocks over the rows and at most 6 a row,
  // the fastest on the main path's shapes (fewer blocks a row spend more
  // time in the conv, more in the cluster's exchange); without it, a
  // block per SM.  Grown where a row's share does not fit one block.
  int sp = split ? split
           : ln ? (ROW_BLOCKS + rows / 2) / rows : NUM_SMS / rows;
  if (ln && !split && sp > AUTO_SPLIT) sp = AUTO_SPLIT;
  sp = sp < 1 ? 1 : sp > most ? most : sp;
  plan(a, sp, ln);
  while (!split && !fits(a, ln) && a.split < most) plan(a, a.split + 1, ln);
  if (!fits(a, ln)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return launch_cop(a, rows, s);
}
