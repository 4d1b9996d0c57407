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
// this epilogue's.
//
// The f32 instantiation (BLIP-ITM's tower and the drivers' default f32
// predict and eval run it; its numerics in tile_gemm.cuh): 3xTF32 on the
// tensor cores, mma.sync m16n8k8. At BLIP-ITM's shape (36928 rows, the ViT's
// four products) an encode does 6.27e12 FLOP: 94 ms at the CUDA cores' 67
// TFLOP/s, 38 ms for the three passes at TF32's 495. The design: the main
// loop of tile_gemm.cuh (128 x 128 block tiles, 8 warps of 64 x 32, a
// 4-stage cp.async ring, float2 fragment reads, the three products into a
// fresh accumulator a step), two blocks an SM, and the bf16 kernel's
// epilogue on the f32 accumulator: bias, exact erf-GELU, residual, in that
// order.

#include "smem_attribute.cuh"
#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using wg::gelu_exact;

using tile::kF32BM;
using tile::kF32BN;
using tile::kF32SmemBytes;
using tile::kF32Threads;

template <bool kVec>
__global__ void __launch_bounds__(kF32Threads, 2)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ res,
                float* __restrict__ y, int m, int n, int k, int gelu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int row0 = blockIdx.y * kF32BM, col0 = blockIdx.x * kF32BN;
  float acc[4][4][4];  // [m16 tile][n8 tile][fragment]
  tile::f32_mainloop<kVec>(x, w, m, n, k, row0, col0, reinterpret_cast<float*>(smem_raw), acc);

  // epilogue: acc[i][j][2h + e] is row wm * 64 + i * 16 + g + 8h, column
  // wn * 32 + j * 8 + 2t + e of the tile
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wm * 64 + i * 16 + g + 8 * h;
      if (row >= m) continue;
      const size_t at = static_cast<size_t>(row) * n;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + wn * 32 + j * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e >= n) continue;
          float v = acc[i][j][2 * h + e] + bias[col + e];
          if (gelu) v = gelu_exact(v);
          y[at + col + e] = res ? res[at + col + e] + v : v;
        }
      }
    }
}

}  // namespace

// y (m, n) = epilogue(x (m, k) * w (n, k)^T + bias (n,)); gelu 0 or 1; then,
// where res (m, n) is not null, y = res + y, each rounded. dtype 1: bf16 x, w,
// res, y (needs k % 8 == 0, n % 8 == 0 and 16-byte aligned x, w, res and y); dtype 0:
// f32, any k, n and alignment of 4-byte floats. bias is f32 either way. Returns
// cudaGetLastError() after the launch.
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
  const dim3 grid((n + kF32BN - 1) / kF32BN, (m + kF32BM - 1) / kF32BM);
  if (m <= 0 || n <= 0 || k < 0 || grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = k % 4 == 0 && (reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(w)) % 16 == 0;
  const auto kernel = vec ? gemm_f32_kernel<true> : gemm_f32_kernel<false>;
  const cudaError_t err = set_smem_once(reinterpret_cast<const void*>(kernel), kF32SmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kF32Threads, kF32SmemBytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), bias,
      static_cast<const float*>(res), static_cast<float*>(y), m, n, k, gelu);
  return static_cast<int>(cudaGetLastError());
}
