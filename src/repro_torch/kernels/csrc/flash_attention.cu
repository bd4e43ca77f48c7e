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
// with masked probabilities zeroed, exactly as the TPU kernel does (a
// fully masked row outputs 0); the output is acc / max(l, 1e-30), cast
// once to q's type.
//
// What bounds it on the H100: operations.  A prefill of S tokens does
// 4·D flops per unmasked (q, k) pair and head against O(S·D) bytes, far
// above the card's 295 flops per byte, so only the tensor cores (989
// TFLOP/s in bf16, against 67 TFLOP/s of fp32 FMAs on the CUDA cores)
// can reach the bound.  Beside the products, every pair costs one MUFU
// exp2 and a few fp32 operations on the CUDA cores (the softmax), which
// the tensor cores do not wait for only if the two overlap: at D = 64 a
// 128 x 128 tile's two products take about as many SM cycles as its
// 16,384 exp2 at 16 a cycle, so there the softmax is the other bound.
//
// Three designs; `flash_attention_design` says which one a launch runs.
//
// bf16 at D = 64, 80 and 128 (`fa_tma_kernel`, design 2): both products
// on the tensor cores, as FlashAttention-3 arranges them.
//   * A persistent grid, one block an SM: the q tiles of 128 rows are
//     ranked heaviest first across all (b, h) (the latest rows see the
//     longest causal band) and dealt out in a snake (block b takes ranks
//     b, 2G-1-b, 2G+b, ...), so a block's heavy and light tiles even
//     out.  A block is two consumer warpgroups of 64 q rows each and one
//     producer warpgroup, which gives its registers away (`setmaxnreg.dec`
//     to 24) to the consumers (`setmaxnreg.inc` to 240): a thread's 64
//     fp32 scores, D/2 fp32 outputs and 32 packed bf16 probabilities fit
//     at D = 128 (40 outputs at D = 80).
//   * Copies: one producer thread issues TMA loads (`cp.async.bulk.tensor
//     .3d`) of each tile's Q and of its K and V tiles of 128 rows into two
//     rings of two stages, each stage with a full and an empty mbarrier
//     (each consumer warpgroup frees a stage with one arrival); K and V
//     have rings of their own, so a K stage is free as soon as its scores
//     are done, and Q has its own pair, freed by the tile's last S.  The
//     rings run on across a block's tiles: the next tile's Q and first
//     K/V load while this one ends.  The tensor maps are encoded on the
//     host for each call (`cuTensorMapEncodeTiled`, reached through
//     `cudaGetDriverEntryPoint`: nothing links the driver library) over
//     (D, S, B·heads), so rows past S belong to no head and TMA fills them
//     with zeros (or, storing, skips them).  A call whose maps cannot be
//     encoded returns the error; nothing falls back to another design.
//   * Layout: TMA's 128-byte swizzle, one 64-column atom (a 128-byte row)
//     at D = 64 and two at D = 128, read by `wgmma` through descriptors in
//     the same swizzle mode: Q and K K-major, V MN-major (transpose bit).
//     D = 80 (h2o-danube) is one such atom plus a tail atom of the last 16
//     columns (32-byte rows) in the 32-byte swizzle, loaded through a
//     second tensor map an operand (boxes of 16 columns): S takes 4 k16
//     steps in the atom and 1 in the tail, P·V an m64n64k16 on the atom
//     and an m64n16k16 on the tail each kv step.  Every product then
//     reads a whole number of its swizzle's patterns, the layouts `wgmma`
//     defines (an MN-major 128-byte pattern is 64 columns wide, so one
//     m64n80k16 over 80 columns in that swizzle would read a partial
//     one), and the tiles hold D = 80's bytes: 20 KB a Q, K or V tile,
//     123,984 bytes of shared memory in all.  The other way, D = 128's
//     two 128-byte boxes over an 80-column map (TMA zero-filling columns
//     80-127), would keep D = 128's 197,712 bytes, move 60% more through
//     shared memory, and still need a partial pattern or a split product.
//   * The softmax under the products: each iteration issues S(it) =
//     Q·K(it)ᵀ and then O += P(it-1)·V(it-1), waits only for S(it), and
//     runs the softmax of tile it on the CUDA cores while P·V still runs
//     on the tensor cores; then it waits for P·V, rescales O and packs
//     P(it).  P(it-1) in bf16 registers and S(it) in fp32 live side by
//     side.  The two consumer warpgroups take turns at issuing their
//     products (named barriers, FlashAttention-3's ping-pong), so one's
//     softmax runs under the other's products.
//   * Epilogue: O / max(l, 1e-30) (the IEEE quotient, computed with one
//     reciprocal a row and an FMA correction, see `tm_store`) rounded to
//     bf16 into a staging tile in Q's layout, stored with TMA (one store
//     an atom and warpgroup).
//   On the H100 the turns were faster at both widths, and a 192-row q
//   tile of three consumer warpgroups at D = 64 was not (PERF.md).
//
// bf16 at the other widths (`fa_wgmma_kernel`, design 1: 16-48, 72 and
// 88-120, which no configuration of the port uses): a producer warp
// moves Q and each K/V tile with 16-byte `cp.async` into a three-stage
// ring in an unswizzled core-matrix layout (chunk (r, c) at ((r/8)·DP/8 +
// c)·128 + (r%8)·16, depth padded with zeros to DP, a multiple of 16),
// which needs no tensor map.  Two consumer warpgroups wait for S, run the
// softmax, then issue P·V and the next tile's S back to back.
// `-Xptxas -v` reports no spill up to DP = 112 (168 registers a thread in
// a 288-thread block).
//
// Shared by both bf16 designs: S = Q·Kᵀ is `wgmma` m64n128k16 from shared
// memory; O += P·V packs P to bf16 straight from the S accumulators into
// A fragments in registers (the m64nNk16 accumulator layout is the
// register A layout) for m64nDk16.  Only tiles that straddle the causal
// diagonal, the window's lower edge or the end of kv evaluate the
// per-element mask; interior tiles compute p = 2^(s·scale·log2(e) - max)
// in one FMA and one MUFU ex2.  The one numeric departure from the fp32
// reference: P is rounded to bf16 before P·V (as SDPA's flash backend and
// FlashAttention-2/3 do); the relative error per probability is at most
// 2^-9, so the output moves by at most 2^-9·max|v| before its own
// rounding.  l sums the unrounded fp32 probabilities.
//
// fp32 (`flash_attention_kernel`, design 0): the port's fp32 contract is
// "no TF32", and the tensor cores take fp32 only as TF32, so fp32 keeps
// the CUDA-core design: one block of 256 threads per (b, h, 64-row q
// tile) walks the kv tiles of 64 rows that its band touches.  Q and each
// K tile are staged in shared memory transposed, so that the score loop
// reads one float4 of Q and one of K per d for 16 FMAs; a thread owns a
// 4 x 4 block of scores, a row's 64 scores live in 16 adjacent lanes
// (shuffle reductions), and the probabilities go through shared memory
// for the P·V product, where a thread owns 4 rows x ceil(D/16) columns.
//
// Global loads are 16 bytes (8 bf16 or 4 fp32), so D must be a multiple
// of 8 and at most 128, and the base pointers 16-byte aligned: the
// wrapper checks all of it.
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include "smem.cuh"

namespace {

// The design of the kernel the last call launched (see
// flash_attention_design), -1 if it launched none.
int ran_design = -1;

// ---------------------------------------------------------------------------
// bf16: wgmma with cp.async-fed tiles
// ---------------------------------------------------------------------------
constexpr int FW_QW = 64;          // q rows per consumer warpgroup
constexpr int FW_BK = 128;         // kv rows per tile
constexpr int FW_STAGES = 3;       // K/V tiles in the ring
constexpr int FW_NWG = 2;          // consumer warpgroups per block
constexpr int FW_BQ = FW_QW * FW_NWG;
constexpr int FW_THREADS = 128 * FW_NWG + 32;
constexpr float FW_MASK = -1e30f;
constexpr float FW_LOG2E = 1.4426950408889634f;

#define FA_ACC8(d, i)                                                  \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, no swizzle: start address, leading
// (lbo) and stride (sbo) byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving accesses of wgmma accumulators across the
// asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// S (64 x 128) = A (64 x 16) . B (16 x 128)ᵀ, A and B K-major in shared
// memory; acc = 0 overwrites S.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_ACC8(d, 0), FA_ACC8(d, 8), FA_ACC8(d, 16), FA_ACC8(d, 24),
        FA_ACC8(d, 32), FA_ACC8(d, 40), FA_ACC8(d, 48), FA_ACC8(d, 56)
      : "l"(da), "l"(db), "r"(acc));
}

// O (64 x N) += A (64 x 16, bf16 in registers) . B (16 x N), B MN-major
// in shared memory (transpose bit set).
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : FA_ACC8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : FA_ACC8(d, 0), FA_ACC8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<48>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : FA_ACC8(d, 0), FA_ACC8(d, 8), FA_ACC8(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31},  "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_ACC8(d, 0), FA_ACC8(d, 8), FA_ACC8(d, 16), FA_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<80>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31,  "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : FA_ACC8(d, 0), FA_ACC8(d, 8), FA_ACC8(d, 16), FA_ACC8(d, 24),
        FA_ACC8(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<96>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31,  "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47},  "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : FA_ACC8(d, 0), FA_ACC8(d, 8), FA_ACC8(d, 16), FA_ACC8(d, 24),
        FA_ACC8(d, 32), FA_ACC8(d, 40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<112>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31,  "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47,  "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : FA_ACC8(d, 0), FA_ACC8(d, 8), FA_ACC8(d, 16), FA_ACC8(d, 24),
        FA_ACC8(d, 32), FA_ACC8(d, 40), FA_ACC8(d, 48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31,  "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47,  "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63},  "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_ACC8(d, 0), FA_ACC8(d, 8), FA_ACC8(d, 16), FA_ACC8(d, 24),
        FA_ACC8(d, 32), FA_ACC8(d, 40), FA_ACC8(d, 48), FA_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// Arrive on `bar` once all of this thread's earlier cp.async have landed
// (the arrival counts against the barrier's initial count).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// The producer warp's copy of 8·groups rows from r0 of a row-major
// (S, D) bf16 matrix into the core-matrix layout at `dst`: 16-byte
// chunks, zero past S and in the depth padding.  Lane l owns row l % 8 of
// every group of 8 rows and chunk l / 8 of every 4 adjacent chunks, so a
// warp's copy writes 4 whole core matrices (512 contiguous bytes, no bank
// conflict) and reads 8 rows x 64 contiguous bytes; all offsets but the
// row stride are compile-time constants.
template <int DP>
__device__ __forceinline__ void fw_copy(uint32_t dst,
                                        const __nv_bfloat16* __restrict__ src,
                                        int r0, int S, int D, int groups,
                                        int lane) {
  constexpr int NC8 = DP / 8;
  const int r8 = lane & 7, cq = lane >> 3, nc = D / 8;
  const __nv_bfloat16* row = src + (size_t)(r0 + r8) * D + cq * 8;
  const uint32_t a = dst + cq * 128 + r8 * 16;
  for (int g = 0; g < groups; ++g, row += 8 * (size_t)D) {
    const bool row_ok = r0 + 8 * g + r8 < S;
#pragma unroll
    for (int cb = 0; cb < NC8; cb += 4) {
      if (cb + 4 > NC8 && cb + cq >= NC8) continue;
      const bool ok = row_ok && cb + cq < nc;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       a + (uint32_t)((g * NC8 + cb) * 128)),
                   "l"(ok ? row + cb * 8 : src), "r"(ok ? 16 : 0)
                   : "memory");
    }
  }
}

// 2^x (MUFU; +0 for -inf and for -1e30)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Max over the 4 lanes that hold a row's accumulators.
__device__ __forceinline__ void fw_row_max(float& a, float& b) {
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The online softmax of one 64 x 128 tile of scores in the m64n128
// accumulator layout (accumulator j: row row0 + 8·((j>>1)&1), column
// 8·(j>>2) + 2·(lane&3) + (j&1)), in place: s becomes p, (m, l) the new
// running max and this thread's partial sum (reduced over the row's 4
// lanes at the end); a0 and a1 rescale the earlier accumulators.
// masked: the tile straddles the diagonal, the window's edge or the end
// of kv, so each pair is tested; else the max of the raw scores (scale >
// 0), then p = 2^(s·scale·log2(e) - max) in one FMA and one MUFU op.
__device__ __forceinline__ void fw_softmax(float (&s)[64], float& m0,
                                           float& m1, float& l0, float& l1,
                                           float& a0, float& a1, bool masked,
                                           int k0, int qpos0, int qpos1,
                                           int lane, int Skv, int causal,
                                           int window, float sl2) {
  float n0, n1, sum0 = 0.f, sum1 = 0.f;
  if (masked) {
    // kpos = base + c with c = 8·(j>>2) + (j&1) a constant: a row keeps
    // kpos < Skv, kpos <= qpos (causal) and qpos - kpos < window, i.e.
    // the c in [lo, hi]
    const int base = k0 + 2 * (lane & 3);
    const int hi0 = (causal ? min(qpos0, Skv - 1) : Skv - 1) - base;
    const int hi1 = (causal ? min(qpos1, Skv - 1) : Skv - 1) - base;
    const int lo0 = window > 0 ? qpos0 - window + 1 - base : INT_MIN;
    const int lo1 = window > 0 ? qpos1 - window + 1 - base : INT_MIN;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const int c = 8 * (j >> 2) + (j & 1);
      const bool ok = (j & 2) ? c <= hi1 && c >= lo1 : c <= hi0 && c >= lo0;
      s[j] = ok ? s[j] * sl2 : FW_MASK;
      if (j & 2) mx1 = fmaxf(mx1, s[j]); else mx0 = fmaxf(mx0, s[j]);
    }
    fw_row_max(mx0, mx1);
    n0 = fmaxf(m0, mx0);
    n1 = fmaxf(m1, mx1);
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const int c = 8 * (j >> 2) + (j & 1);
      const bool ok = (j & 2) ? c <= hi1 && c >= lo1 : c <= hi0 && c >= lo0;
      const float p = ok ? fast_exp2(s[j] - ((j & 2) ? n1 : n0)) : 0.f;
      s[j] = p;
      if (j & 2) sum1 += p; else sum0 += p;
    }
  } else {
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      if (j & 2) mx1 = fmaxf(mx1, s[j]); else mx0 = fmaxf(mx0, s[j]);
    }
    fw_row_max(mx0, mx1);
    n0 = fmaxf(m0, mx0 * sl2);
    n1 = fmaxf(m1, mx1 * sl2);
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const float p = fast_exp2(fmaf(s[j], sl2, (j & 2) ? -n1 : -n0));
      s[j] = p;
      if (j & 2) sum1 += p; else sum0 += p;
    }
  }
  a0 = fast_exp2(m0 - n0);
  a1 = fast_exp2(m1 - n1);
  m0 = n0;
  m1 = n1;
  l0 = l0 * a0 + sum0;
  l1 = l1 * a1 + sum1;
}

// P rounded to bf16 and packed into the A fragments of the 8 m64nNk16
// steps over a tile's 128 kv rows.
__device__ __forceinline__ void fw_pack_p(const float (&s)[64],
                                          uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// S = Q·Kᵀ of tile `it` over the padded depth, issued once its K/V stage
// is full; committed, not waited for.
template <int DP>
__device__ __forceinline__ void fw_issue_s(float* s, uint32_t qwg,
                                           uint32_t tiles, uint32_t full0,
                                           int it) {
  constexpr int GROUP = DP / 8 * 128;
  constexpr int TILE = FW_BK / 8 * GROUP;
  const int st = it % FW_STAGES;
  mbar_wait(full0 + 8 * st, (it / FW_STAGES) & 1);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const uint32_t kt = tiles + 2 * st * TILE;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss_n128(s, gmma_desc(qwg + kk * 256, 128, GROUP),
                  gmma_desc(kt + kk * 256, 128, GROUP), kk > 0);
  wgmma_commit();
}

// DP: the depth padded to a multiple of 16.  Warpgroups 0 and 1 consume,
// the last warp produces.
template <int DP>
__global__ void __launch_bounds__(FW_THREADS, 1)
fa_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, int H, int K, int Sq,
                int Skv, int D, int causal, int window, float scale) {
  constexpr int NC8 = DP / 8;
  constexpr int GROUP = NC8 * 128;            // bytes of 8 rows
  constexpr int TILE = FW_BK / 8 * GROUP;     // bytes of one K or V tile
  constexpr int NS = 64;                      // S registers per thread
  constexpr int NO = DP / 2;                  // O registers per thread
  extern __shared__ __align__(128) unsigned char fw_smem[];
  const uint32_t sq_base = smem_addr(fw_smem);
  const uint32_t tiles = sq_base + FW_BQ / 8 * GROUP;      // [stage][K, V]
  const uint32_t bars = tiles + 2 * FW_STAGES * TILE;  // 7 mbarriers
  const uint32_t full0 = bars, empty0 = bars + 8 * FW_STAGES;
  const uint32_t qfull = bars + 16 * FW_STAGES;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / K);
  // heaviest (last) q tiles first: the causal band grows with the tile
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FW_BQ;
  const int q_offset = Skv - Sq;
  const __nv_bfloat16* qb = q + (size_t)bh * Sq * D;
  const __nv_bfloat16* kb = k + (size_t)(b * K + kvh) * Skv * D;
  const __nv_bfloat16* vb = v + (size_t)(b * K + kvh) * Skv * D;

  // the kv band this q tile can see: [kv_lo, kv_hi)
  const int qlo = q0 + q_offset;
  const int qhi = min(q0 + FW_BQ, Sq) - 1 + q_offset;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = min(Skv, qhi + 1);
  if (window > 0) kv_lo = max(0, qlo - window + 1);
  const int t_lo = kv_lo / FW_BK;
  const int ntiles = kv_hi > kv_lo ? (kv_hi + FW_BK - 1) / FW_BK - t_lo : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 32);
      mbar_init(empty0 + 8 * s, 128 * FW_NWG);
    }
    mbar_init(qfull, 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  if (warp == 4 * FW_NWG) {
    // ---- producer warp ----
    fw_copy<DP>(sq_base, qb, q0, Sq, D, FW_BQ / 8, lane);
    cp_async_arrive(qfull);
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % FW_STAGES;
      if (it >= FW_STAGES)
        mbar_wait(empty0 + 8 * s, (it / FW_STAGES - 1) & 1);
      const int k0 = (t_lo + it) * FW_BK;
      const uint32_t kt = tiles + 2 * s * TILE;
      fw_copy<DP>(kt, kb, k0, Skv, D, FW_BK / 8, lane);
      fw_copy<DP>(kt + TILE, vb, k0, Skv, D, FW_BK / 8, lane);
      cp_async_arrive(full0 + 8 * s);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = warp / 4, wl = warp & 3;
  const int row0 = 16 * wl + (lane >> 2);     // and row0 + 8
  const int qpos0 = q0 + wg * FW_QW + row0 + q_offset;
  const int qpos1 = qpos0 + 8;
  // this warpgroup's rows, for the choice of masked tiles
  const int wlo = q0 + wg * FW_QW + q_offset;
  const int whi = min(q0 + wg * FW_QW + FW_QW, Sq) - 1 + q_offset;
  const float sl2 = scale * FW_LOG2E;
  const uint32_t qwg = sq_base + wg * (FW_QW / 8) * GROUP;

  float o[NO], s[NS];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  mbar_wait(qfull, 0);
  if (ntiles > 0) fw_issue_s<DP>(s, qwg, tiles, full0, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % FW_STAGES;
    const int k0 = (t_lo + it) * FW_BK;
    const uint32_t vt = tiles + 2 * st * TILE + TILE;
    wgmma_wait_all();              // S of tile it (and P·V of tile it-1)
    fence_regs<NS>(s);

    const bool masked = k0 + FW_BK > Skv || (causal && k0 + FW_BK - 1 > wlo) ||
                        (window > 0 && whi - k0 >= window);
    float a0, a1;
    fw_softmax(s, m0, m1, l0, l1, a0, a1, masked, k0, qpos0, qpos1, lane, Skv,
               causal, window, sl2);
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j] *= (j & 2) ? a1 : a0;

    // P (bf16, registers) · V
    uint32_t pa[FW_BK / 16][4];
    fw_pack_p(s, pa);
    fence_regs<NO>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FW_BK / 16; ++kk)
      wgmma_rs<DP>(o, pa[kk], gmma_desc(vt + kk * 2 * GROUP, GROUP, 128));
    wgmma_commit();
    // the next tile's S runs on the tensor cores right behind this P·V
    if (it + 1 < ntiles) fw_issue_s<DP>(s, qwg, tiles, full0, it + 1);
    if (it + 1 < ntiles)
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    else
      wgmma_wait_all();
    fence_regs<NO>(o);
    // the A fragments are read asynchronously: keep them live until here
#pragma unroll
    for (int kk = 0; kk < FW_BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(pa[kk][i])::"memory");
    mbar_arrive(empty0 + 8 * st);
  }

#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int r0 = q0 + wg * FW_QW + row0;
  __nv_bfloat16* ob = out + (size_t)bh * Sq * D;
#pragma unroll
  for (int j = 0; j < NO; j += 2) {
    const int row = (j & 2) ? r0 + 8 : r0;
    const int col = 8 * (j >> 2) + 2 * (lane & 3);
    const float den = (j & 2) ? d1 : d0;
    if (row < Sq && col < D)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * D + col) =
          __floats2bfloat162_rn(o[j] / den, o[j + 1] / den);
  }
}

template <int DP>
int fw_launch(const void* q, const void* k, const void* v, void* out, int B,
              int H, int K, int Sq, int Skv, int D, int causal, int window,
              float scale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(FW_BQ + 2 * FW_STAGES * FW_BK) * DP * 2 + 64;
  static size_t allowed = 0;             // dynamic smem opted in so far
  const cudaError_t e = allow_smem(fa_wgmma_kernel<DP>, smem, &allowed);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + FW_BQ - 1) / FW_BQ, B * H);
  fa_wgmma_kernel<DP><<<grid, FW_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, H, K, Sq, Skv, D, causal,
      window, scale);
  ran_design = 1;
  return (int)cudaGetLastError();
}

int fw_dispatch(const void* q, const void* k, const void* v, void* out,
                int B, int H, int K, int Sq, int Skv, int D, int causal,
                int window, float scale, cudaStream_t s) {
  switch ((D + 15) / 16) {
    case 1: return fw_launch<16>(q, k, v, out, B, H, K, Sq, Skv, D, causal, window, scale, s);
    case 2: return fw_launch<32>(q, k, v, out, B, H, K, Sq, Skv, D, causal, window, scale, s);
    case 3: return fw_launch<48>(q, k, v, out, B, H, K, Sq, Skv, D, causal, window, scale, s);
    case 4: return fw_launch<64>(q, k, v, out, B, H, K, Sq, Skv, D, causal, window, scale, s);
    case 5: return fw_launch<80>(q, k, v, out, B, H, K, Sq, Skv, D, causal, window, scale, s);
    case 6: return fw_launch<96>(q, k, v, out, B, H, K, Sq, Skv, D, causal, window, scale, s);
    case 7: return fw_launch<112>(q, k, v, out, B, H, K, Sq, Skv, D, causal, window, scale, s);
    case 8: return fw_launch<128>(q, k, v, out, B, H, K, Sq, Skv, D, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 at D = 64, 80 and 128: TMA tiles, a producer warpgroup, the softmax
// under the products
// ---------------------------------------------------------------------------
constexpr int TM_BK = 128;     // kv rows per tile
constexpr int TM_STAGES = 2;   // stages of the K ring, and of the V ring
constexpr int TM_NWG = 2;      // consumer warpgroups a block
constexpr int TM_BQ = 64 * TM_NWG;              // q rows a tile
constexpr int TM_THREADS = 128 * (TM_NWG + 1);  // + the producer

// A tile's columns: D / 64 atoms of 64 columns (128-byte rows) in TMA's
// 128-byte swizzle, then, at D = 80, a tail atom of the last 16 columns
// (32-byte rows) in the 32-byte swizzle.
template <int D>
struct Tm {
  static constexpr int ATOMS = D / 64;             // 128-byte atoms a row
  static constexpr int TAIL = D % 64;              // columns of the tail
  static_assert(TAIL == 0 || TAIL == 16, "a tail atom is 16 columns");
  static constexpr int Q_ATOM = TM_BQ * 128;       // bytes of a Q atom
  static constexpr int T_ATOM = TM_BK * 128;       // ... of a K or V atom
  static constexpr int Q_TAIL = ATOMS * Q_ATOM;    // offset of Q's tail
  static constexpr int T_TAIL = ATOMS * T_ATOM;    // ... of a K/V tile's
  static constexpr int Q_BYTES = TM_BQ * D * 2;    // Q, and O's staging
  static constexpr int T_BYTES = TM_BK * D * 2;    // one K or V tile
  static_assert(Q_TAIL + TM_BQ * TAIL * 2 == Q_BYTES &&
                    T_TAIL + TM_BK * TAIL * 2 == T_BYTES,
                "the tail atom ends the tile");
  static_assert(Q_BYTES % 1024 == 0 && T_BYTES % 1024 == 0,
                "every tile starts on a 1024-byte swizzle boundary");
  static constexpr int K_OFF = 2 * Q_BYTES;        // [stage] K tiles
  static constexpr int V_OFF = K_OFF + TM_STAGES * T_BYTES;
  static constexpr int BARS = V_OFF + TM_STAGES * T_BYTES;
  // 1024 bytes to align the swizzled tiles; 2 + 4·stages mbarriers
  static constexpr int SMEM = 1024 + BARS + 8 * (2 + 4 * TM_STAGES);
  static_assert(SMEM <= 232448, "more shared memory than a block has");
};
// FlashAttention-3's split of the 64 K registers, 24 + 2·240 for each of
// 128 threads
constexpr int TM_PRODUCER_REGS = 24;
constexpr int TM_CONSUMER_REGS = 240;

// One q tile of the grid's walk.  Tiles are ranked heaviest first across
// every (b, h) (the latest q rows see the longest causal band), and the
// G persistent blocks deal the ranks out in a snake: block b takes ranks
// b, 2G-1-b, 2G+b, 4G-1-b, ..., so that a block's heavy and light tiles
// even out.  Ranks grow with the round: a block stops at its first rank
// past the last.
struct TmTile {
  int q0, bh, zkv, t_lo, nt;   // first q row, plane of q, of k/v; kv tiles
};

__device__ __forceinline__ bool tm_tile(int round, int nq, int BH, int H,
                                        int K, int Sq, int Skv, int causal,
                                        int window, TmTile& t) {
  const int G = gridDim.x, b = blockIdx.x;
  const int rank = round * G + ((round & 1) ? G - 1 - b : b);
  if (rank >= nq * BH) return false;
  t.bh = rank % BH;
  t.q0 = (nq - 1 - rank / BH) * TM_BQ;
  t.zkv = t.bh / H * K + t.bh % H / (H / K);
  // the kv band this q tile can see: [kv_lo, kv_hi)
  const int q_offset = Skv - Sq;
  const int qlo = t.q0 + q_offset, qhi = min(t.q0 + TM_BQ, Sq) - 1 + q_offset;
  int kv_lo = 0, kv_hi = Skv;
  if (causal) kv_hi = min(Skv, qhi + 1);
  if (window > 0) kv_lo = max(0, qlo - window + 1);
  t.t_lo = kv_lo / TM_BK;
  t.nt = kv_hi > kv_lo ? (kv_hi + TM_BK - 1) / TM_BK - t.t_lo : 0;
  return true;
}

// wgmma descriptor of a tile in TMA's 128-byte swizzle: 8 rows of 128
// bytes an atom (SBO 1024); lbo, the stride between 64-column atoms, is
// read only for MN-major operands.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// ... and in the 32-byte swizzle (the tail atom): 8 rows of 32 bytes an
// atom (SBO 256), one atom across (a K-major step spans its 32-byte row;
// an MN-major product reads its 16 columns), so lbo is not read.
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(256 >> 4) << 32) | (3ull << 62);
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// One TMA box (64 or 16 columns x rows x 1 plane, as `map` says) to
// `dst`; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int plane) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(plane)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the A fragments live until the product that reads them is done.
__device__ __forceinline__ void hold_frags(uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(pa[kk][i])::"memory");
}

// S = Q·K(tile)ᵀ over D: D/16 steps of m64n128k16, K-major: 4 in each
// 128-byte atom (a step advances 32 bytes inside it), then at D = 80 one
// over the tail atom.  qwg / qtail: this warpgroup's rows of Q's atoms
// and of its tail.
template <int D>
__device__ __forceinline__ void tm_issue_s(float* s, uint32_t qwg,
                                           uint32_t qtail, uint32_t kt) {
  using C = Tm<D>;
#pragma unroll
  for (int kk = 0; kk < 4 * C::ATOMS; ++kk)
    wgmma_ss_n128(s,
                  sw128_desc(qwg + (kk >> 2) * C::Q_ATOM + (kk & 3) * 32, 16),
                  sw128_desc(kt + (kk >> 2) * C::T_ATOM + (kk & 3) * 32, 16),
                  kk > 0);
  if constexpr (C::TAIL != 0)
    wgmma_ss_n128(s, sw32_desc(qtail), sw32_desc(kt + C::T_TAIL), 1);
}

// O += P·V(tile): 8 steps over the tile's kv rows, V MN-major: m64nNk16
// over the 128-byte atoms (16 rows = 2048 bytes a step; the two atoms of
// D = 128 T_ATOM apart), and at D = 80 m64n16k16 over the tail atom (16
// rows = 512 bytes a step) into O's last 8 registers, which hold its
// columns 64-79 in the accumulator layout.
template <int D>
__device__ __forceinline__ void tm_issue_pv(float* o, uint32_t (&pa)[8][4],
                                            uint32_t vt) {
  using C = Tm<D>;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma_rs<64 * C::ATOMS>(o, pa[kk], sw128_desc(vt + kk * 2048, C::T_ATOM));
    if constexpr (C::TAIL != 0)
      wgmma_rs<16>(o + 32 * C::ATOMS, pa[kk],
                   sw32_desc(vt + C::T_TAIL + kk * 512));
  }
}

// The epilogue: l summed over a row's 4 lanes, O / max(l, 1e-30) rounded
// once to bf16 into this warpgroup's 64 rows of the staging tile `so`, in
// Q's layout (in the 128-byte swizzle 8 rows of a warp's store land in 8
// distinct 16-byte chunks, in the 32-byte tail 8 rows in 8 distinct
// quarters of the banks: no bank conflict), then one thread stores them
// with TMA at (row, plane) of the output's maps, which skip rows past Sq.
// The store is waited for (its reads of `so`) only before the next tile's
// epilogue writes there, and at the end.
//
// The quotient is the IEEE division's, without a division a value: y =
// 1/den once, q = o·y, then q + (o - q·den)·y with FMAs, which is the
// correctly rounded o/den when y is the correctly rounded 1/den and
// nothing under- or overflows (Markstein's theorem).  den is 1e-30 with o
// = 0, or at least ~1 (the row's max contributes 2^0) and at most Skv; a
// thread holding any o outside [2^-64, 2^64] (0 aside: inf, NaN, a value
// near underflow) divides instead.
template <int D>
__device__ __forceinline__ void tm_store(float (&o)[D / 2], float l0,
                                         float l1, uint32_t so, int row0,
                                         int lane, int wg,
                                         const CUtensorMap* to,
                                         const CUtensorMap* to16, int row,
                                         int plane) {
  using C = Tm<D>;
  if ((threadIdx.x & 127) == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
#pragma unroll
  for (int o_ = 1; o_ < 4; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  // the range test on the bits of |o|, in 2 independent chains: NaN and
  // inf are above 2^64's bits, and 0 - 1 wraps above everything
  uint32_t hi[2] = {0, 0}, lo[2] = {~0u, ~0u};
#pragma unroll
  for (int j = 0; j < D / 2; ++j) {
    const uint32_t u = __float_as_uint(o[j]) & 0x7fffffffu;
    hi[j & 1] = max(hi[j & 1], u);
    lo[j & 1] = min(lo[j & 1], u - 1u);
  }
  const bool fast = max(hi[0], hi[1]) <= 0x5f800000u &&
                    min(lo[0], lo[1]) >= 0x1f7fffffu;
  if (fast) {
    const float y0 = 1.f / d0, y1 = 1.f / d1;
#pragma unroll
    for (int j = 0; j < D / 2; ++j) {
      const float den = (j & 2) ? d1 : d0, y = (j & 2) ? y1 : y0;
      const float q = o[j] * y;
      o[j] = fmaf(fmaf(-q, den, o[j]), y, q);
    }
  } else {
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] /= (j & 2) ? d1 : d0;
  }
  // r: the row in the q tile (this warpgroup's rows start at 64·wg, a
  // multiple of 8, so the swizzles' row bits are those of row0); ch: the
  // 16-byte chunk of the row, 8 an atom, then the tail's 2
#pragma unroll
  for (int j = 0; j < D / 2; j += 2) {
    const int r = 64 * wg + ((j & 2) ? row0 + 8 : row0);
    const int ch = j >> 2, in = 4 * (lane & 3);
    const uint32_t at =
        ch < 8 * C::ATOMS
            ? so + (ch / 8) * C::Q_ATOM + r * 128 +
                  (((ch % 8) ^ (r & 7)) << 4) + in
            : so + C::Q_TAIL + r * 32 +
                  ((((ch - 8 * C::ATOMS) ^ (r >> 2)) & 1) << 4) + in;
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                 "r"(pack_bf16(o[j], o[j + 1]))
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
  if ((threadIdx.x & 127) == 0) {
    const auto store = [&](const CUtensorMap* map, uint32_t src, int col) {
      asm volatile(
          "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
          " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
          "r"(src), "r"(col), "r"(row), "r"(plane)
          : "memory");
    };
#pragma unroll
    for (int a = 0; a < C::ATOMS; ++a)
      store(to, so + a * C::Q_ATOM + wg * 64 * 128, 64 * a);
    if constexpr (C::TAIL != 0)
      store(to16, so + C::Q_TAIL + wg * 64 * 32, 64 * C::ATOMS);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// Warpgroups 0 and 1 consume, warpgroup 2 produces; the block walks its
// q tiles (`tm_tile`) and the K/V rings run on across them, so the next
// tile's Q and first K/V tiles load while this one ends.  The two
// consumer warpgroups take turns at issuing their products (named
// barriers 1 and 2; 3 and 4 order each warpgroup's epilogue).  tq ... to
// map the 128-byte atoms' boxes, tq16 ... to16 the tail's (read at D =
// 80 only).
template <int D>
__global__ void __launch_bounds__(TM_THREADS, 1)
fa_tma_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap to,
              const __grid_constant__ CUtensorMap tq16,
              const __grid_constant__ CUtensorMap tk16,
              const __grid_constant__ CUtensorMap tv16,
              const __grid_constant__ CUtensorMap to16, int BH, int H, int K,
              int Sq, int Skv, int causal, int window, float scale) {
  using C = Tm<D>;
  extern __shared__ unsigned char tm_smem[];
  const uint32_t sq = (smem_addr(tm_smem) + 1023) & ~1023u;
  const uint32_t so = sq + C::Q_BYTES;
  const uint32_t sk = sq + C::K_OFF, sv = sq + C::V_OFF;
  const uint32_t qfull = sq + C::BARS, qempty = qfull + 8;
  const uint32_t kfull = qempty + 8, kempty = kfull + 8 * TM_STAGES;
  const uint32_t vfull = kempty + 8 * TM_STAGES;
  const uint32_t vempty = vfull + 8 * TM_STAGES;
  const int nq = (Sq + TM_BQ - 1) / TM_BQ;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    mbar_init(qempty, TM_NWG);
    for (int st = 0; st < TM_STAGES; ++st) {
      mbar_init(kfull + 8 * st, 1);
      mbar_init(kempty + 8 * st, TM_NWG);
      mbar_init(vfull + 8 * st, 1);
      mbar_init(vempty + 8 * st, TM_NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == TM_NWG) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        TM_PRODUCER_REGS));
    if (threadIdx.x == 128 * TM_NWG) {
      TmTile t;
      int g = 0;                       // kv tiles loaded so far
      for (int round = 0;
           tm_tile(round, nq, BH, H, K, Sq, Skv, causal, window, t);
           ++round) {
        if (round > 0) mbar_wait(qempty, (round - 1) & 1);
        mbar_expect_tx(qfull, C::Q_BYTES);
#pragma unroll
        for (int a = 0; a < C::ATOMS; ++a)
          tma_load(sq + a * C::Q_ATOM, &tq, qfull, 64 * a, t.q0, t.bh);
        if constexpr (C::TAIL != 0)
          tma_load(sq + C::Q_TAIL, &tq16, qfull, 64 * C::ATOMS, t.q0, t.bh);
        for (int it = 0; it < t.nt; ++it, ++g) {
          const int st = g % TM_STAGES;
          const uint32_t freed = ((g / TM_STAGES) & 1) ^ 1;
          const int k0 = (t.t_lo + it) * TM_BK;
          if (g >= TM_STAGES) mbar_wait(kempty + 8 * st, freed);
          mbar_expect_tx(kfull + 8 * st, C::T_BYTES);
#pragma unroll
          for (int a = 0; a < C::ATOMS; ++a)
            tma_load(sk + st * C::T_BYTES + a * C::T_ATOM, &tk,
                     kfull + 8 * st, 64 * a, k0, t.zkv);
          if constexpr (C::TAIL != 0)
            tma_load(sk + st * C::T_BYTES + C::T_TAIL, &tk16, kfull + 8 * st,
                     64 * C::ATOMS, k0, t.zkv);
          if (g >= TM_STAGES) mbar_wait(vempty + 8 * st, freed);
          mbar_expect_tx(vfull + 8 * st, C::T_BYTES);
#pragma unroll
          for (int a = 0; a < C::ATOMS; ++a)
            tma_load(sv + st * C::T_BYTES + a * C::T_ATOM, &tv,
                     vfull + 8 * st, 64 * a, k0, t.zkv);
          if constexpr (C::TAIL != 0)
            tma_load(sv + st * C::T_BYTES + C::T_TAIL, &tv16, vfull + 8 * st,
                     64 * C::ATOMS, k0, t.zkv);
        }
      }
    }
  } else {
    // ---- consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        TM_CONSUMER_REGS));
    const int lane = threadIdx.x & 31;
    const int row0 = 16 * ((threadIdx.x / 32) & 3) + (lane >> 2);
    const float sl2 = scale * FW_LOG2E;
    const uint32_t qwg = sq + wg * 64 * 128;
    const uint32_t qtail = sq + C::Q_TAIL + wg * 64 * 32;
    // one arrival a warpgroup frees a stage: a warpgroup's product is one
    // operation of its four warps, read the stage once one thread has
    // waited for it (the arrival count of TMA pipelines on Hopper)
    const auto release = [&](uint32_t bar) {
      if ((threadIdx.x & 127) == 0) mbar_arrive(bar);
    };
    // a turn: issuing one batch of products; warpgroup w waits on barrier
    // 1 + w and hands the turn on through the other's.  In each tile
    // warpgroup 1 opens by handing the first turn to 0 and skips its last
    // hand-on, so every arrival meets its wait.
    const auto turn = [&]() {
      asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg));
    };
    const auto hand_on = [&](bool last) {
      if (!(last && wg == 1))
        asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg));
    };

    float o[D / 2], s[64];
    uint32_t pa[8][4];
    TmTile t;
    int g = 0;                         // kv tiles consumed so far
    for (int round = 0;
         tm_tile(round, nq, BH, H, K, Sq, Skv, causal, window, t);
         ++round) {
      const int q_offset = Skv - Sq;
      const int qpos0 = t.q0 + wg * 64 + row0 + q_offset, qpos1 = qpos0 + 8;
      // this warpgroup's rows, for the choice of masked tiles
      const int wlo = t.q0 + wg * 64 + q_offset;
      const int whi = min(t.q0 + wg * 64 + 64, Sq) - 1 + q_offset;
      const int nt = t.nt, t_lo = t.t_lo;
      // tile it straddles a mask edge for this warpgroup's rows
      const auto masked = [=](int it) {
        const int k0 = (t_lo + it) * TM_BK;
        return k0 + TM_BK > Skv || (causal && k0 + TM_BK - 1 > wlo) ||
               (window > 0 && whi - k0 >= window);
      };
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

      mbar_wait(qfull, round & 1);
      if (nt == 0) release(qempty);
      if (nt > 0) {
        if (wg == 1) asm volatile("bar.arrive 1, 256;\n");
        float a0, a1;
        // kv tile 0: S, its softmax, P packed
        turn();
        mbar_wait(kfull + 8 * (g % TM_STAGES), (g / TM_STAGES) & 1);
        wgmma_fence();
        tm_issue_s<D>(s, qwg, qtail, sk + (g % TM_STAGES) * C::T_BYTES);
        wgmma_commit();
        hand_on(false);
        wgmma_wait<0>();
        fence_regs<64>(s);
        release(kempty + 8 * (g % TM_STAGES));
        if (nt == 1) release(qempty);
        fw_softmax(s, m0, m1, l0, l1, a0, a1, masked(0), t_lo * TM_BK, qpos0,
                   qpos1, lane, Skv, causal, window, sl2);
        fw_pack_p(s, pa);
        for (int it = 1; it < nt; ++it) {
          const int gi = g + it;
          const int st = gi % TM_STAGES, pst = (gi - 1) % TM_STAGES;
          // S(it) first, then P(it-1)·V(it-1) behind it
          turn();
          mbar_wait(kfull + 8 * st, (gi / TM_STAGES) & 1);
          fence_regs<D / 2>(o);
          wgmma_fence();
          tm_issue_s<D>(s, qwg, qtail, sk + st * C::T_BYTES);
          wgmma_commit();
          mbar_wait(vfull + 8 * pst, ((gi - 1) / TM_STAGES) & 1);
          tm_issue_pv<D>(o, pa, sv + pst * C::T_BYTES);
          wgmma_commit();
          hand_on(false);
          // the softmax of tile it while P·V runs
          wgmma_wait<1>();
          fence_regs<64>(s);
          release(kempty + 8 * st);
          if (it == nt - 1) release(qempty);   // the tile's last S is done
          fw_softmax(s, m0, m1, l0, l1, a0, a1, masked(it),
                     (t_lo + it) * TM_BK, qpos0, qpos1, lane, Skv, causal,
                     window, sl2);
          wgmma_wait<0>();
          fence_regs<D / 2>(o);
          hold_frags(pa);
          release(vempty + 8 * pst);
#pragma unroll
          for (int j = 0; j < D / 2; ++j) o[j] *= (j & 2) ? a1 : a0;
          fw_pack_p(s, pa);
        }
        // the last kv tile's P·V
        const int gl = g + nt - 1, lst = gl % TM_STAGES;
        turn();
        mbar_wait(vfull + 8 * lst, (gl / TM_STAGES) & 1);
        fence_regs<D / 2>(o);
        wgmma_fence();
        tm_issue_pv<D>(o, pa, sv + lst * C::T_BYTES);
        wgmma_commit();
        hand_on(true);
        wgmma_wait<0>();
        fence_regs<D / 2>(o);
        hold_frags(pa);
        release(vempty + 8 * lst);
        g += nt;
      }
      tm_store<D>(o, l0, l1, so, row0, lane, wg, &to, &to16, t.q0 + wg * 64,
                  t.bh);
    }
    if ((threadIdx.x & 127) == 0)
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// cuTensorMapEncodeTiled, from the driver the runtime has loaded (the
// library links no -lcuda); null if the driver has none.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of a contiguous (planes, rows, D) bf16 tensor as (D, rows,
// planes), boxes of box_cols x box_rows x 1: 64 columns in the 128-byte
// swizzle, or 16 (the tail) in the 32-byte swizzle; out-of-range rows
// read as zeros.
CUresult encode_rows(EncodeTiled fn, CUtensorMap* map, const void* base,
                     int D, int rows, int planes, int box_cols,
                     int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)D * 2 * rows};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int tm_launch(const void* q, const void* k, const void* v, void* out, int B,
              int H, int K, int Sq, int Skv, int causal, int window,
              float scale, cudaStream_t stream) {
  using C = Tm<D>;
  if (Skv == 0)      // no key: every row is 0, and there is nothing to map
    return (int)cudaMemsetAsync(out, 0, (size_t)B * H * Sq * D * 2, stream);
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  // [0] the 128-byte atoms' maps, [1] the tail's (a copy of [0] without
  // a tail, never read)
  CUtensorMap tq[2], tk[2], tv[2], to[2];
  for (int i = 0; i < (C::TAIL ? 2 : 1); ++i) {
    const int cols = i == 0 ? 64 : C::TAIL;
    if (encode_rows(fn, &tq[i], q, D, Sq, B * H, cols, TM_BQ) ||
        encode_rows(fn, &tk[i], k, D, Skv, B * K, cols, TM_BK) ||
        encode_rows(fn, &tv[i], v, D, Skv, B * K, cols, TM_BK) ||
        encode_rows(fn, &to[i], out, D, Sq, B * H, cols, 64))
      return (int)cudaErrorInvalidValue;   // any CUresult but CUDA_SUCCESS
  }
  if (!C::TAIL) tq[1] = tq[0], tk[1] = tk[0], tv[1] = tv[0], to[1] = to[0];
  static size_t allowed = 0;             // dynamic smem opted in so far
  cudaError_t e = allow_smem(fa_tma_kernel<D>, C::SMEM, &allowed);
  if (e != cudaSuccess) return (int)e;
  // one persistent block an SM (the device's count, asked once a device)
  static int sms[64] = {0};
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if (dev < 64 && sms[dev] == 0 &&
      (e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  const int n_sm = dev < 64 ? sms[dev] : 132;
  const int tiles = (Sq + TM_BQ - 1) / TM_BQ * B * H;
  fa_tma_kernel<D>
      <<<tiles < n_sm ? tiles : n_sm, TM_THREADS, C::SMEM, stream>>>(
          tq[0], tk[0], tv[0], to[0], tq[1], tk[1], tv[1], to[1], B * H, H,
          K, Sq, Skv, causal, window, scale);
  ran_design = 2;
  return (int)cudaGetLastError();
}

int tm_dispatch(const void* q, const void* k, const void* v, void* out,
                int B, int H, int K, int Sq, int Skv, int D, int causal,
                int window, float scale, cudaStream_t s) {
  if (D == 64)
    return tm_launch<64>(q, k, v, out, B, H, K, Sq, Skv, causal, window,
                         scale, s);
  if (D == 80)
    return tm_launch<80>(q, k, v, out, B, H, K, Sq, Skv, causal, window,
                         scale, s);
  return tm_launch<128>(q, k, v, out, B, H, K, Sq, Skv, causal, window,
                        scale, s);
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs
// ---------------------------------------------------------------------------
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

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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
  ran_design = 0;
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


// The design a launch at head width D runs: 0 the fp32 CUDA-core kernel,
// 1 the bf16 cp.async-fed wgmma kernel, 2 the bf16 TMA kernel.
extern "C" int flash_attention_design(int D, int bf16) {
  if (!bf16) return 0;
  return D == 64 || D == 80 || D == 128 ? 2 : 1;
}

// The design of the kernel that the last flash_attention_launch launched,
// recorded where it launched it; -1 if it launched none (no q row, no key
// in the TMA design, or an error before the launch).
extern "C" int flash_attention_ran(void) { return ran_design; }

// window <= 0: no sliding window.  bf16: the four tensors are bf16, else
// fp32.  The wrapper has checked shapes, D % 8 == 0, D <= 128, K | H and
// 16-byte alignment.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int K, int Sq, int Skv, int D,
                                      int causal, int window, int bf16,
                                      float scale, void* stream) {
  ran_design = -1;
  if (B <= 0 || Sq <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (flash_attention_design(D, bf16)) {
    case 2:
      return tm_dispatch(q, k, v, out, B, H, K, Sq, Skv, D, causal, window,
                         scale, s);
    case 1:
      return fw_dispatch(q, k, v, out, B, H, K, Sq, Skv, D, causal, window,
                         scale, s);
    default:
      return dispatch<float>(q, k, v, out, B, H, K, Sq, Skv, D, causal,
                             window, scale, s);
  }
}
