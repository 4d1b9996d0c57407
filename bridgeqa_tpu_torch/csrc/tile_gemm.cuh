// The Hopper helpers of the port's matrix and attention kernels: the
// cp.async, ldmatrix, mma.sync and ex2 helpers of the attention kernels, and
// the 3xTF32 helpers and main loops of the f32 products, the f32 vocabulary
// pass and the f32 attentions (scoring_gemm.cu, vocab_loss.cu,
// attention_f32.cuh).
//
// 3xTF32: an f32 operand x is split into hi = tf32(x) (10 mantissa bits,
// rounded to nearest, ties away from zero: cvt.rna) and lo = tf32(x - hi);
// a product a * b is taken as lo_a * hi_b + hi_a * lo_b + hi_a * hi_b on the
// tensor cores (.tf32 operands), each partial product exact. What is
// dropped, lo_a * lo_b and the at most two bits of x - hi that lo cannot
// hold, is ~2^-22 of |a * b|: f32's accuracy, not TF32's (one pass,
// hi_a * hi_b alone, keeps ~2^-11). The tensor cores read only the 19 high
// bits of a .tf32 operand (the 13 low ones are truncated, not rounded), so hi
// is rounded here, explicitly. They add into their f32 accumulator with
// truncation, an error of up to an ulp of the accumulator an instruction and
// all of one sign; so every caller runs one 8-deep step's passes into a fresh
// accumulator and adds that to the running sum in f32, rounded to nearest,
// so the truncation does not build up over K. The card tests hold every
// caller within 1e-5 of the largest output against an f64 reference
// (tests/test_torch_cuda.py, *_keeps_f32_accuracy);
// tests/test_torch_f32_split.py emulates the split and the loops' order on
// the CPU.
//
// The f32 products and vocabulary pass run one of two main loops, chosen by
// the shape and the pointers:
// - tf32_mainloop (K % 4 == 0, X and W 16-byte aligned: every main-path
//   shape), on wgmma. Bound: the tensor cores, 3 x 2mnk FLOP at TF32's 495
//   TFLOP/s (the three passes; a third of the peak counts the products' own
//   FLOP). TMA loads 128 x 32 f32 tiles of X and W (one 128-byte swizzled
//   row a tile row) into a 4-stage ring with wgmma_gemm.cuh's setup() and
//   produce(). W's tile is split once a stage, in shared memory, by the three
//   spare warps of the producer warpgroup: hi over the tile in place and lo
//   beside it, in the same swizzled layout (the split is elementwise), so
//   every consumer warp reads both halves through wgmma descriptors instead
//   of re-splitting fragments it shares with three others. Each consumer
//   reads its own A fragments (16 floats a thread a stage) and splits them
//   in registers: wgmma takes A from registers, and an A split in shared
//   memory would cost twice the shared-memory traffic of the registers'
//   loads. The splitters are otherwise idle (setmaxnreg leaves them 40
//   registers). Two consumer warpgroups share each 128 x 128 tile (rows 0-63
//   and 64-127) on a persistent grid of one block per SM: each 8-deep step
//   runs three wgmma.m64n128k8 .tf32 into a fresh 64 x 128 accumulator,
//   and a consumer adds the previous step's to its 64 x 128 sum while they
//   run (two step accumulators that alternate, 192 of its 232 registers;
//   1-3 points of the ceiling faster than one accumulator waited for at
//   each step). The adds, one f32 add per 24 multiply-adds of the tensor
//   cores, bound the loop on the H100: without them it ran at 72-94% of the
//   3xTF32 ceiling, with them at 46-54%, and with 64 FMAs that read no
//   accumulator in their place at 62-69% (the consumers' issue slots and
//   register reads beside the running products; f32 variants, PERF.md).
//   A 128 x 128 tile a consumer, which ping-pong needs to overlap one
//   tile's epilogue with the other's products, would hold 128 registers of
//   sum; the epilogue runs while the producer and splitters fill the next
//   tile's stages instead.
// - f32_mainloop (any other K or alignment), on mma.sync m16n8k8, 4-byte
//   cp.async copies, each warp splitting its own fragments.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma_gemm.cuh"

namespace tile {

using bf16 = __nv_bfloat16;

// ------------------------------------------------- the attentions' helpers

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 16 : 0;  // 0: zero-fill, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// from a shared-memory address, or from a pointer into shared memory
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned s) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  ldmatrix_x4(r, static_cast<unsigned>(__cvta_generic_to_shared(p)));
}

// ldmatrix with .trans: for a row-major (k, n) operand in shared memory
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned s) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  ldmatrix_x4_trans(r, static_cast<unsigned>(__cvta_generic_to_shared(p)));
}

// 2^x (ex2.approx): the attentions' softmax in the log2 domain
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 4-byte cp.async; pred false: zero-fill, nothing is read
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------------ 3xTF32

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), as the bits of an mma.sync .tf32 operand: half the weight of
// the 13 dropped bits added to the magnitude, then those bits cleared. Two
// integer instructions; on sm_90 the cvt is a longer sequence. (A NaN whose
// payload lies only in the dropped bits would come out as an infinity.)
__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x ~ hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// x = hi + lo + lo2 exactly: lo2 = x - hi - lo is exact in f32 and holds at
// most two significant bits, so it is a TF32 value as it stands
__device__ __forceinline__ void split3_tf32(float x, unsigned& hi, unsigned& lo, unsigned& lo2) {
  hi = to_tf32(x);
  const float r = x - __uint_as_float(hi);
  lo = to_tf32(r);
  lo2 = __float_as_uint(r - __uint_as_float(lo));
}

// c += a * b on a 16 x 8 x 8 TF32 tile: a (16 x 8, row) a[0] (g, t), a[1]
// (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4); b (8 x 8, col) b0 (t, g),
// b1 (t + 4, g); c c[0..1] row g, columns 2t and 2t + 1, c[2..3] row g + 8;
// g = lane / 4, t = lane % 4
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------- the 3xTF32 main loop on wgmma

// tf32_mainloop's ring (wgmma_gemm.cuh's RingOf): a stage holds X's tile,
// W's tile (split in place into its hi half) and W's lo half, each 128 rows
// of 32 floats under the 128-byte swizzle; TMA fills the first two.
// split[s] (the ring's extra barriers) counts the splitter warps' arrivals.
struct TF32Config {
  static constexpr int BM = 128, BN = 128, BK = 32;
  static constexpr int THREADS = 384;       // producer warpgroup + two consumers
  static constexpr int CONSUMER_WARPS = 8;  // both consumers read every stage
  static constexpr int A_BYTES = BM * BK * 4;
  static constexpr int B_BYTES = BN * BK * 4;
  static constexpr int LOAD_BYTES = A_BYTES + B_BYTES;
  static constexpr int STAGE_BYTES = LOAD_BYTES + B_BYTES;
  static constexpr int STAGES = 4;
  static constexpr int OUT_BYTES = 0;
  static constexpr int SPLIT_WARPS = 3;  // warps 1-3 of the producer warpgroup
  static constexpr int EXTRA_BARS = STAGES, EXTRA_COUNT = SPLIT_WARPS;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + (2 * STAGES + EXTRA_BARS) * 8;
  static_assert(SMEM_BYTES <= 232448, "shared memory of a block");
};
using TF32Ring = wg::RingOf<TF32Config>;

// D (64 x 128, f32, registers) += A (64 x 8, TF32, registers: a[0] row g,
// K t; a[1] row g + 8, K t; a[2] row g, K t + 4; a[3] row g + 8, K t + 4 of
// the warp's 16 rows, g = lane / 4, t = lane % 4) * B (128 x 8, TF32, shared
// memory through a descriptor)^T; D is zero first where scale_d is 0.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const unsigned (&a)[4],
                                                     uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// keeps the compiler from reusing an A fragment's registers while a wgmma
// that reads them may still run
__device__ __forceinline__ void fence_fragment(unsigned (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// The splitters, warps 1-3 of the producer warpgroup (after produce() has
// lowered its registers): for each of the block's `steps` stages in ring
// order, once TMA has filled it, W's tile becomes its hi half in place and
// its lo half beside it, 16 bytes at a time; then split[s] is armed. The
// fence hands the generic-proxy stores to the tensor cores' reads.
__device__ __forceinline__ void tf32_split(const TF32Ring& ring, int steps) {
  using C = TF32Config;
  constexpr int kThreads = C::SPLIT_WARPS * 32;
  const int tid = threadIdx.x - 32;
  for (int step = 0; step < steps; ++step) {
    const int s = step % C::STAGES;
    wg::mbar_wait(ring.full(s), (step / C::STAGES) & 1);
    const uint32_t b = ring.stage(s) + C::A_BYTES;
#pragma unroll 4
    for (int i = tid; i < C::B_BYTES / 16; i += kThreads) {
      const uint32_t at = b + 16u * i;
      float v[4];
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                   : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                   : "r"(at)
                   : "memory");
      unsigned hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(v[e], hi[e], lo[e]);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at), "r"(hi[0]), "r"(hi[1]),
                   "r"(hi[2]), "r"(hi[3])
                   : "memory");
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(at + C::B_BYTES), "r"(lo[0]),
                   "r"(lo[1]), "r"(lo[2]), "r"(lo[3])
                   : "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (threadIdx.x % 32 == 0) wg::mbar_arrive(ring.extra(s));
  }
}

// sum = the rows me * 64 + [0, 64) of the block's j-th tile of X * W^T, over
// `ktiles` stages, in 3xTF32, in consumer warpgroup `me` (both consumers run
// every tile). sum[4c + q] is row warp * 16 + g + 8 (q / 2), column
// 8c + 2t + q % 2 of those (warp = the consumer's warp, g = lane / 4,
// t = lane % 4), the layout of wgmma's accumulator. The k-th stage of tile j
// is the ring's step j * ktiles + k. Each 8-deep step runs lo_a * hi_b,
// hi_a * lo_b, hi_a * hi_b into a fresh accumulator (two that alternate, so
// that the f32 add of one step overlaps the next step's products); a stage
// is freed once the products that read it are done.
__device__ __forceinline__ void tf32_mainloop(const TF32Ring& ring, int j, int ktiles, int me,
                                              float (&sum)[64]) {
  using C = TF32Config;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // this thread's A rows, g and g + 8 of the warp's 16: both rows % 8 == g,
  // so the swizzle moves 16-byte chunk c of either to chunk c ^ g
  const uint32_t row = (me * 64 + warp * 16 + g) * 128u + t * 4u;
  float acc[2][64];
  unsigned a[2][2][4];  // [step accumulator][hi, lo][fragment]
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    sum[i] = 0.0f;
    acc[1][i] = 0.0f;  // the first step adds it as the previous step's
  }
  int held = -1;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int step = j * ktiles + kt;
    const int stage = step % C::STAGES, parity = (step / C::STAGES) & 1;
    wg::mbar_wait(ring.full(stage), parity);
    wg::mbar_wait(ring.extra(stage), parity);  // W's halves are split
    const uint32_t x = ring.stage(stage) + row;
    const uint32_t hi_b = ring.stage(stage) + C::A_BYTES, lo_b = hi_b + C::B_BYTES;
#pragma unroll
    for (int ks = 0; ks < C::BK / 8; ++ks) {
      const int cur = ks % 2;  // BK / 8 is even: the parity runs on across stages
      float v[4];
      const uint32_t c0 = ((2 * ks) ^ g) * 16u, c1 = ((2 * ks + 1) ^ g) * 16u;
      asm volatile(
          "ld.shared.f32 %0, [%4];\nld.shared.f32 %1, [%5];\n"
          "ld.shared.f32 %2, [%6];\nld.shared.f32 %3, [%7];\n"
          : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
          : "r"(x + c0), "r"(x + 8 * 128 + c0), "r"(x + c1), "r"(x + 8 * 128 + c1)
          : "memory");
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(v[e], a[cur][0][e], a[cur][1][e]);
      wg::fence_operands(acc[cur]);
      wg::wgmma_fence();
      wgmma_m64n128k8_tf32(acc[cur], a[cur][1], wg::desc_sw128(hi_b + ks * 32), 0);
      wgmma_m64n128k8_tf32(acc[cur], a[cur][0], wg::desc_sw128(lo_b + ks * 32), 1);
      wgmma_m64n128k8_tf32(acc[cur], a[cur][0], wg::desc_sw128(hi_b + ks * 32), 1);
      wg::wgmma_commit();
      wg::fence_operands(acc[cur]);
      // the previous step's products are done: add them, and free their
      // stage where that step was its last
      wg::wgmma_wait<1>();
      wg::fence_operands(acc[1 - cur]);
      fence_fragment(a[1 - cur][0]);
      fence_fragment(a[1 - cur][1]);
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] += acc[1 - cur][i];
      if (ks == 0 && held >= 0) {
        __syncwarp();
        if (lane == 0) wg::mbar_arrive(ring.empty(held));
      }
    }
    held = stage;
  }
  wg::wgmma_wait<0>();
  wg::fence_operands(acc[1]);
#pragma unroll
  for (int i = 0; i < 64; ++i) sum[i] += acc[1][i];
  if (held >= 0) {
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(ring.empty(held));
  }
}

// ------------------------------------------- the 3xTF32 main loop on mma.sync

// Y = X * W^T on a 128 x 128 block tile, X (m, k) and W (n, k) row-major, K
// contiguous in both, for any K and alignment: 8 warps of 64 x 32 (2 rows of
// warps by 4 columns), K 16 a stage through a 4-stage ring of 4-byte
// cp.async copies (rows and K past the edges zero-filled). Each warp reads
// its fragments as float2 (a thread's fragment K positions t and t + 4 of
// each 8 come from K positions 2t and 2t + 1, in X and W alike, so the
// product is unchanged; a 24-float row pitch keeps the reads free of bank
// conflicts), splits them into hi and lo in registers and runs the three
// products, small ones first, into a fresh accumulator that joins the sum by
// an f32 add. The f32 products (scoring_gemm.cu) and the f32 vocabulary pass
// (vocab_loss.cu) run it where tf32_mainloop's TMA cannot load their
// operands, each with its own epilogue.
constexpr int kF32BM = 128;
constexpr int kF32BN = 128;
constexpr int kF32BK = 16;
constexpr int kF32Stages = 4;
constexpr int kF32Pitch = kF32BK + 8;  // floats a row of a stage
constexpr int kF32Threads = 256;
constexpr int kF32StageFloats = (kF32BM + kF32BN) * kF32Pitch;
constexpr int kF32SmemBytes = kF32Stages * kF32StageFloats * static_cast<int>(sizeof(float));
static_assert(kF32BM == kF32BN, "f32_load_tile serves both operands");

// rows [r0, r0 + 128) and K [k0, k0 + 16) of src (`rows` rows of k floats)
// into dst [128][kF32Pitch]; what lies past either edge is zero-filled
__device__ __forceinline__ void f32_load_tile(float* dst, const float* __restrict__ src, int rows,
                                              int k, int r0, int k0) {
#pragma unroll
  for (int i = 0; i < kF32BM * kF32BK / kF32Threads; ++i) {
    const int c = threadIdx.x + i * kF32Threads;
    const int r = c / kF32BK, kc = c % kF32BK;
    const bool ok = r0 + r < rows && k0 + kc < k;
    const float* from = ok ? src + static_cast<size_t>(r0 + r) * k + k0 + kc : src;
    cp_async4(dst + r * kF32Pitch + kc, from, ok);
  }
}

// acc = X[row0, +128) * W[col0, +128)^T over all of K, in 3xTF32. smem:
// kF32SmemBytes, which the block may reuse once this returns (it waits for
// every warp before its first load). acc[i][j][2h + e] is row wm * 64 + i *
// 16 + g + 8h, column wn * 32 + j * 8 + 2t + e of the tile (warp = 4 wm +
// wn, g = lane / 4, t = lane % 4).
__device__ __forceinline__ void f32_mainloop(const float* __restrict__ x,
                                             const float* __restrict__ w, int m, int n, int k,
                                             int row0, int col0, float* smem,
                                             float (&acc)[4][4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int tiles = (k + kF32BK - 1) / kF32BK;
  auto load = [&](int slot, int kt) {
    float* stage = smem + slot * kF32StageFloats;
    f32_load_tile(stage, x, m, k, row0, kt * kF32BK);
    f32_load_tile(stage + kF32BM * kF32Pitch, w, n, k, col0, kt * kF32BK);
  };
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

  __syncthreads();  // every warp is done with what the block kept in smem before
#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) {
    if (s < tiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < tiles; ++kt) {
    cp_async_wait<kF32Stages - 2>();
    __syncthreads();  // tile kt has landed, and every warp is done with the slot refilled next
    if (kt + kF32Stages - 1 < tiles) load((kt + kF32Stages - 1) % kF32Stages, kt + kF32Stages - 1);
    cp_async_commit();
    const float* stage = smem + (kt % kF32Stages) * kF32StageFloats;
    const float* a = stage + (wm * 64 + g) * kF32Pitch + 2 * t;
    const float* b = stage + (kF32BM + wn * 32 + g) * kF32Pitch + 2 * t;
#pragma unroll
    for (int ks = 0; ks < kF32BK / 8; ++ks) {
      unsigned bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(b + j * 8 * kF32Pitch + ks * 8);
        split_tf32(v.x, bh[j][0], bl[j][0]);
        split_tf32(v.y, bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 top = *reinterpret_cast<const float2*>(a + i * 16 * kF32Pitch + ks * 8);
        const float2 low = *reinterpret_cast<const float2*>(a + (i * 16 + 8) * kF32Pitch + ks * 8);
        unsigned ah[4], al[4];
        split_tf32(top.x, ah[0], al[0]);
        split_tf32(low.x, ah[1], al[1]);
        split_tf32(top.y, ah[2], al[2]);
        split_tf32(low.y, ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float step[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_tf32(step, al, bh[j][0], bh[j][1]);
          mma_tf32(step, ah, bl[j][0], bl[j][1]);
          mma_tf32(step, ah, bh[j][0], bh[j][1]);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] += step[c];
        }
      }
    }
  }
}

}  // namespace tile
