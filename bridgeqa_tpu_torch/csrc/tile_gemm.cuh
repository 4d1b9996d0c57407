// The Hopper helpers of the port's matrix and attention kernels: the
// cp.async, ldmatrix, mma.sync and ex2 helpers of the attention kernels, and
// the 3xTF32 helpers and main loop of the f32 products, the f32 vocabulary
// pass and the f32 attentions (scoring_gemm.cu, vocab_loss.cu,
// attention_f32.cuh).
//
// 3xTF32: an f32 operand x is split into hi = tf32(x) (10 mantissa bits,
// rounded to nearest, ties away from zero: cvt.rna) and lo = tf32(x - hi);
// a product a * b is taken as lo_a * hi_b + hi_a * lo_b + hi_a * hi_b on the
// tensor cores (mma.sync m16n8k8 .tf32), each partial product exact. What is
// dropped, lo_a * lo_b and the at most two bits of x - hi that lo cannot
// hold, is ~2^-22 of |a * b|: f32's accuracy, not TF32's (one pass,
// hi_a * hi_b alone, keeps ~2^-11). The tensor cores add into their f32
// accumulator with truncation, an error of up to an ulp of the accumulator
// an instruction and all of one sign; so the callers run one 8-deep step's
// passes into a fresh accumulator and add that to the running sum in f32,
// rounded to nearest, so the truncation does not build up over K. The card
// tests hold every caller within 1e-5 of the largest output against an f64
// reference (tests/test_torch_cuda.py, *_keeps_f32_accuracy);
// tests/test_torch_f32_split.py emulates the split on the CPU.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// ------------------------------------------------------ the 3xTF32 main loop

// Y = X * W^T on a 128 x 128 block tile, X (m, k) and W (n, k) row-major, K
// contiguous in both: 8 warps of 64 x 32 (2 rows of warps by 4 columns), K
// 16 a stage through a 4-stage cp.async ring (16-byte copies where K % 4 ==
// 0 and both pointers are 16-byte aligned, else 4-byte ones; rows and K past
// the edges zero-filled). Each warp reads its fragments as float2 (a
// thread's fragment K positions t and t + 4 of each 8 come from K positions
// 2t and 2t + 1, in X and W alike, so the product is unchanged; a 24-float
// row pitch keeps the reads free of bank conflicts), splits them into hi and
// lo in registers and runs the three products, small ones first, into a
// fresh accumulator that joins the sum by an f32 add. The f32 products
// (scoring_gemm.cu) and the f32 vocabulary pass (vocab_loss.cu) run it, each
// with its own epilogue.
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
template <bool kVec>
__device__ __forceinline__ void f32_load_tile(float* dst, const float* __restrict__ src, int rows,
                                              int k, int r0, int k0) {
  constexpr int kPer = kVec ? 4 : 1;  // floats a copy
  constexpr int kRowCopies = kF32BK / kPer;
#pragma unroll
  for (int i = 0; i < kF32BM * kRowCopies / kF32Threads; ++i) {
    const int c = threadIdx.x + i * kF32Threads;
    const int r = c / kRowCopies, kc = (c % kRowCopies) * kPer;
    const bool ok = r0 + r < rows && k0 + kc < k;  // K % 4 == 0 where kVec: all 4 or none
    const float* from = ok ? src + static_cast<size_t>(r0 + r) * k + k0 + kc : src;
    if constexpr (kVec) cp_async16(dst + r * kF32Pitch + kc, from, ok);
    else cp_async4(dst + r * kF32Pitch + kc, from, ok);
  }
}

// acc = X[row0, +128) * W[col0, +128)^T over all of K, in 3xTF32. smem:
// kF32SmemBytes, which the block may reuse once this returns (it waits for
// every warp before its first load). acc[i][j][2h + e] is row wm * 64 + i *
// 16 + g + 8h, column wn * 32 + j * 8 + 2t + e of the tile (warp = 4 wm +
// wn, g = lane / 4, t = lane % 4).
template <bool kVec>
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
    f32_load_tile<kVec>(stage, x, m, k, row0, kt * kF32BK);
    f32_load_tile<kVec>(stage + kF32BM * kF32Pitch, w, n, k, col0, kt * kF32BK);
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
