// Matrix-product tiles of the streaming vocabulary loss (vocab_loss.cu, bf16
// and f32) and of the scoring GEMM's f32 instantiation (scoring_gemm.cu; its
// bf16 kernel runs on wgmma_gemm.cuh). The attention kernels use the
// cp.async, ldmatrix and mma.sync helpers.
//
// Both compute a tile of Y = X * W^T: X (M, K) and W (N, K) row-major, K
// contiguous in both (W is an nn.Linear weight, or the tied word table), so
// each tile's inner loop reads two K-contiguous panels. The accumulator stays
// in registers; the caller's epilogue reads it through the row/column maps
// of the tile's configuration.
//
// - bf16: a BM x BN tile on the tensor cores, mma.sync m16n8k16 (bf16 in,
//   f32 accumulate), WARPS_M x WARPS_N warps, each owning a
//   (BM / WARPS_M) x (BN / WARPS_N) piece. K advances BK at a time through a
//   STAGES-deep cp.async ring in shared memory; rows are padded by 8
//   elements so that ldmatrix reads are free of bank conflicts. Needs
//   K % 8 == 0 (16-byte rows); ragged M, N and K are zero-filled by
//   cp.async.
// - f32: a 64 x 64 tile on the CUDA cores, 256 threads of 4 x 4 outputs each,
//   K advancing 16 at a time through shared memory. It exists so that a
//   float32 model runs the same path (the card-vs-CPU reference); any K.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tile {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- bf16 tile

template <int BM_, int BN_, int BK_, int STAGES_, int WARPS_M_, int WARPS_N_>
struct MmaConfig {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
  static constexpr int MT = BM / WARPS_M / 16;  // m16 tiles of a warp
  static constexpr int NT = BN / WARPS_N / 8;   // n8 tiles of a warp
  static constexpr int LDS = BK + 8;            // padded shared-memory row, elements
  static constexpr int SMEM_BYTES = STAGES * (BM + BN) * LDS * 2;
  // threads that share a row of the tile: 4 lanes in each of WARPS_N warps
  static constexpr int COL_GROUPS = WARPS_N * 4;
  static_assert(BM % (WARPS_M * 16) == 0 && BN % (WARPS_N * 16) == 0 && BK % 16 == 0, "shape");

  // Accumulator layout: acc[mt][nt][h * 2 + e] holds row row(mt, h),
  // column col(nt, e) of the tile.
  __device__ static int row(int mt, int h) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return (warp / WARPS_N) * (BM / WARPS_M) + mt * 16 + (lane >> 2) + h * 8;
  }
  __device__ static int col(int nt, int e) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    return (warp % WARPS_N) * (BN / WARPS_N) + nt * 8 + (lane & 3) * 2 + e;
  }
  __device__ static int col_group() {
    return ((threadIdx.x >> 5) % WARPS_N) * 4 + (threadIdx.x & 3);
  }
};

// The vocabulary loss's tile: 128 x 128 outputs, K 64 at a time, 3 stages
// (110.6 KB of shared memory, two blocks to an SM), 8 warps of 64 x 32. On
// the H100 at the decoder's shapes it beat K 32 at a time and the other
// mma.sync tiles tried (block shape, stages, warps); PERF.md has its times.
using ScoringTile = MmaConfig<128, 128, 64, 3, 2, 4>;

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

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// ldmatrix with .trans: for a row-major (k, n) operand in shared memory
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc = X[row0:row0+BM, :K] * W[col0:col0+BN, :K]^T. `smem` holds
// C::SMEM_BYTES; it is free again when this returns.
template <class C>
__device__ __forceinline__ void mma_tile(const bf16* __restrict__ x, const bf16* __restrict__ w,
                                         int m, int n, int k, int row0, int col0, bf16* smem,
                                         float (&acc)[C::MT][C::NT][4]) {
  bf16* sa = smem;
  bf16* sb = smem + C::STAGES * C::BM * C::LDS;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int ktiles = (k + C::BK - 1) / C::BK;
  constexpr int kChunks = C::BK / 8;  // 16-byte chunks of a row

#pragma unroll
  for (int a = 0; a < C::MT; ++a)
#pragma unroll
    for (int b = 0; b < C::NT; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.0f;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * C::BK;
#pragma unroll
    for (int i = 0; i < C::BM * kChunks / C::THREADS; ++i) {
      const int chunk = tid + i * C::THREADS;
      const int r = chunk / kChunks, kc = (chunk % kChunks) * 8;
      const bool ok = row0 + r < m && k0 + kc < k;
      cp_async16(sa + (stage * C::BM + r) * C::LDS + kc,
                 ok ? x + static_cast<size_t>(row0 + r) * k + k0 + kc : x, ok);
    }
#pragma unroll
    for (int i = 0; i < C::BN * kChunks / C::THREADS; ++i) {
      const int chunk = tid + i * C::THREADS;
      const int r = chunk / kChunks, kc = (chunk % kChunks) * 8;
      const bool ok = col0 + r < n && k0 + kc < k;
      cp_async16(sb + (stage * C::BN + r) * C::LDS + kc,
                 ok ? w + static_cast<size_t>(col0 + r) * k + k0 + kc : w, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1
    const int next = kt + C::STAGES - 1;
    if (next < ktiles) load(next % C::STAGES, next);
    cp_async_commit();

    const bf16* ta = sa + (kt % C::STAGES) * C::BM * C::LDS + (wm * C::MT * 16) * C::LDS;
    const bf16* tb = sb + (kt % C::STAGES) * C::BN * C::LDS + (wn * C::NT * 8) * C::LDS;
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      unsigned af[C::MT][4];
      unsigned bfr[C::NT][2];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
        ldmatrix_x4(af[mt], ta + (mt * 16 + (lane & 15)) * C::LDS + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < C::NT / 2; ++np) {
        unsigned r[4];
        ldmatrix_x4(r, tb + (np * 16 + (lane & 7) + (lane >> 4) * 8) * C::LDS + kk +
                           ((lane >> 3) & 1) * 8);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
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
