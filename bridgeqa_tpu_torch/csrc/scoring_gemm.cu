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
// (24576 or 7208 rows, K 768 or 3072, N 768 to 3072) each product does
// 377-600 FLOP per byte it must move (inputs read once, output written
// once), above the ~295 at which bf16 work on the H100 turns from memory- to
// compute-bound.
//
// What the design does about it (bf16): the Hopper main loop of
// wgmma_gemm.cuh, TMA loads into a 5-stage ring, one producer thread and two
// consumer warpgroups on wgmma in ping-pong (each owns whole 128 x 128 tiles,
// one's epilogue overlapping the other's products), a persistent grid of
// one block per SM, and the epilogue (bias, GELU through a branch-free erf,
// residual, one rounding) on the accumulator registers, the residual coming
// in and the rounded tile going out through shared memory by TMA.
// The residual add and LayerNorm that follow three of the decoder's products
// need whole rows and run in scoring_layernorm.cu; the ViT's last residual is
// this epilogue's. The f32 instantiation (the card-vs-CPU reference) is a
// SIMT tile from tile_gemm.cuh.

#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using wg::gelu_exact;

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
// res, y (needs k % 8 == 0, n % 8 == 0 and 16-byte aligned x, w, res and y); dtype 0:
// f32. bias is f32 either way. Returns cudaGetLastError() after the launch.
extern "C" int bq_scoring_gemm(const void* x, const void* w, const float* bias, const void* res,
                               void* y, int m, int n, int k, int gelu, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (k % 8 || n % 8 || m <= 0 ||
        (reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(w) | reinterpret_cast<size_t>(res) |
         reinterpret_cast<size_t>(y)) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(wg::launch(x, w, bias, res, y, m, n, k, gelu != 0, s));
  }
  const dim3 grid((n + tile::kSimtBN - 1) / tile::kSimtBN, (m + tile::kSimtBM - 1) / tile::kSimtBM);
  gemm_f32_kernel<<<grid, tile::kSimtThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), bias,
      static_cast<const float*>(res), static_cast<float*>(y), m, n, k, gelu);
  return static_cast<int>(cudaGetLastError());
}
