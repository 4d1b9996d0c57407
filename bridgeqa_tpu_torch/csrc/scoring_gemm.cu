// The matrix products of the fused scoring decoder layer and of the fused ViT
// block, for Hopper (sm_90a).
//
// Replaces the six products inside the Pallas kernel
// bridgeqa_tpu/ops/scoring_layer.py::_layer_kernel (the fused QKV, the
// self-attention output, the cross query, the cross output, and the FFN's
// two products) and the four inside bridgeqa_tpu/ops/vit_block.py::
// _block_kernel (QKV, attention output, MLP in and out). Each is
// Y = epilogue(X * W^T + b) with the kernels' numerics: inputs in the
// working type, an f32 accumulator, an f32 bias added to it, the epilogue
// (none, or exact erf-GELU) on the f32 value, and one rounding to the
// working type. With a residual R (the ViT's MLP out), Y = round(R + that
// rounded value), the block's `x1 + mlp` in the working type.
//
// What bounds it on this card: the tensor cores. At the main-path shapes
// (24576 rows, K 768 or 3072, N 768 to 3072) each product does 377-600 FLOP
// per byte it must move (inputs read once, output written once), above the
// ~295 at which bf16 work on the H100 turns from memory- to compute-bound.
//
// What the design does about it: 128 x 128 output tiles on mma.sync with a
// 3-stage cp.async ring, K 64 at a time (tile_gemm.cuh): each element loaded
// into shared memory feeds 128 multiply-adds, and the ring keeps two loads
// in flight behind the tensor cores. wgmma and TMA, which reach the card's
// full rate, are left for a later change. The residual add and LayerNorm
// that follow three of the decoder's products need whole rows and run in
// scoring_layernorm.cu; the ViT's last residual is this epilogue's.

#include "tile_gemm.cuh"

namespace {

using tile::bf16;

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865475f));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

using Tile = tile::ScoringTile;

__global__ void __launch_bounds__(Tile::THREADS, 2)
gemm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                 const float* __restrict__ bias, const bf16* __restrict__ res,
                 bf16* __restrict__ y, int m, int n, int k, int gelu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int row0 = blockIdx.y * Tile::BM, col0 = blockIdx.x * Tile::BN;
  float acc[Tile::MT][Tile::NT][4];
  tile::mma_tile<Tile>(x, w, m, n, k, row0, col0, reinterpret_cast<bf16*>(smem_raw), acc);
#pragma unroll
  for (int nt = 0; nt < Tile::NT; ++nt) {
    const int col = col0 + Tile::col(nt, 0);  // even; n is a multiple of 8
    if (col >= n) continue;
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int mt = 0; mt < Tile::MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + Tile::row(mt, h);
        if (row >= m) continue;
        float v0 = acc[mt][nt][2 * h] + b0, v1 = acc[mt][nt][2 * h + 1] + b1;
        if (gelu) {
          v0 = gelu_exact(v0);
          v1 = gelu_exact(v1);
        }
        const size_t at = static_cast<size_t>(row) * n + col;
        if (res) {
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + at));
          v0 = r.x + round_bf16(v0);
          v1 = r.y + round_bf16(v1);
        }
        *reinterpret_cast<__nv_bfloat162*>(y + at) = __floats2bfloat162_rn(v0, v1);
      }
  }
}

__global__ void __launch_bounds__(tile::kSimtThreads)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ res,
                float* __restrict__ y, int m, int n, int k, int gelu) {
  __shared__ float smem[tile::kSimtSmemFloats];
  const int row0 = blockIdx.y * tile::kSimtBM, col0 = blockIdx.x * tile::kSimtBN;
  float acc[4][4];
  tile::simt_tile(x, w, m, n, k, row0, col0, smem, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + tile::simt_row(i);
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tile::simt_col(j);
      if (col >= n) continue;
      const size_t at = static_cast<size_t>(row) * n + col;
      float v = acc[i][j] + bias[col];
      if (gelu) v = gelu_exact(v);
      if (res) v = res[at] + v;
      y[at] = v;
    }
  }
}

}  // namespace

// y (m, n) = epilogue(x (m, k) * w (n, k)^T + bias (n,)); gelu 0 or 1; then,
// where res (m, n) is not null, y = res + y, each rounded. dtype 1: bf16 x, w,
// res, y (needs k % 8 == 0 and n % 8 == 0); dtype 0: f32. bias is f32 either
// way. Returns cudaGetLastError() after the launch.
extern "C" int bq_scoring_gemm(const void* x, const void* w, const float* bias, const void* res,
                               void* y, int m, int n, int k, int gelu, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (k % 8 || n % 8) return static_cast<int>(cudaErrorInvalidValue);
    // the attribute is per device: set it before every launch
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + Tile::BN - 1) / Tile::BN, (m + Tile::BM - 1) / Tile::BM);
    gemm_bf16_kernel<<<grid, Tile::THREADS, Tile::SMEM_BYTES, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias,
        static_cast<const bf16*>(res), static_cast<bf16*>(y), m, n, k, gelu);
  } else {
    const dim3 grid((n + tile::kSimtBN - 1) / tile::kSimtBN,
                    (m + tile::kSimtBM - 1) / tile::kSimtBM);
    gemm_f32_kernel<<<grid, tile::kSimtThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bias,
        static_cast<const float*>(res), static_cast<float*>(y), m, n, k, gelu);
  }
  return static_cast<int>(cudaGetLastError());
}
