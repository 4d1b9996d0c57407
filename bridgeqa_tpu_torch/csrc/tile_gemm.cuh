// The f32 matrix-product tile of the streaming vocabulary loss
// (vocab_loss.cu; its bf16 kernel runs on wgmma_gemm.cuh), the cp.async,
// ldmatrix, mma.sync and ex2 helpers of the attention kernels, and the 3xTF32
// helpers of the f32 products and the f32 ViT attention (scoring_gemm.cu,
// vit_attention.cu).
//
// The tile is 64 x 64 of Y = X * W^T, X (M, K) and W (N, K) row-major, K
// contiguous in both (W is the tied word table), on the CUDA cores: 256
// threads of 4 x 4 outputs each, K advancing 16 at a time through shared
// memory. The accumulator stays in registers; the caller's epilogue reads it
// through simt_row and simt_col. It exists so that a float32 model runs the
// same path; any K.
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
// tests hold both callers within 1e-5 of the largest output against an f64
// product at K 3072 (tests/test_torch_cuda.py, *_keeps_f32_accuracy);
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

// ----------------------------------------------------------------- f32 tile

constexpr int kSimtBM = 64;
constexpr int kSimtBN = 64;
constexpr int kSimtBK = 16;
constexpr int kSimtThreads = 256;
constexpr int kSimtSmemFloats = kSimtBK * (kSimtBM + 1) + kSimtBK * (kSimtBN + 1);
constexpr int kSimtColGroups = 16;

// Accumulator layout of the f32 tile: acc[i][j] holds row simt_row(i),
// column simt_col(j) of the 64 x 64 tile.
__device__ __forceinline__ int simt_row(int i) { return (threadIdx.x >> 4) + 16 * i; }
__device__ __forceinline__ int simt_col(int j) { return (threadIdx.x & 15) + 16 * j; }
__device__ __forceinline__ int simt_col_group() { return threadIdx.x & 15; }

__device__ __forceinline__ void simt_tile(const float* __restrict__ x, const float* __restrict__ w,
                                          int m, int n, int k, int row0, int col0, float* smem,
                                          float (&acc)[4][4]) {
  float* sa = smem;                             // [BK][BM + 1]
  float* sb = smem + kSimtBK * (kSimtBM + 1);   // [BK][BN + 1]
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < k; k0 += kSimtBK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + q * kSimtThreads;
      const int r = e >> 4, kc = e & 15;
      const int gk = k0 + kc;
      const int gr = row0 + r, gc = col0 + r;
      sa[kc * (kSimtBM + 1) + r] = gr < m && gk < k ? x[static_cast<size_t>(gr) * k + gk] : 0.0f;
      sb[kc * (kSimtBN + 1) + r] = gc < n && gk < k ? w[static_cast<size_t>(gc) * k + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < kSimtBK; ++kc) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sa[kc * (kSimtBM + 1) + simt_row(i)];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sb[kc * (kSimtBN + 1) + simt_col(j)];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }
}

}  // namespace tile
