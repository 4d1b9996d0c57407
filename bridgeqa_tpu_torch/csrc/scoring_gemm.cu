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
// TFLOP/s, 38 ms for the three passes at TF32's 495. The design: 128 x 128
// block tiles, 8 warps of 64 x 32, K 16 a stage through a 4-stage cp.async
// ring (16-byte copies where K % 4 == 0, else 4-byte ones; rows and K past
// the edges zero-filled), two blocks an SM. Each warp reads its fragments as
// float2 (a thread's two K positions of a fragment are adjacent in shared
// memory: the same K permutation on both operands, so the product is
// unchanged; a 24-float row pitch keeps the reads free of bank conflicts),
// splits them into hi and lo in registers and runs the three products, small
// ones first, into a fresh accumulator that joins the sum by an f32 add. The
// epilogue is the bf16 kernel's on the f32 accumulator: bias,
// exact erf-GELU, residual, in that order.

#include "smem_attribute.cuh"
#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using wg::gelu_exact;

constexpr int kF32BM = 128, kF32BN = 128, kF32BK = 16;
constexpr int kF32Stages = 4;
constexpr int kF32Pitch = kF32BK + 8;  // floats a row of a stage
constexpr int kF32Threads = 256;       // 8 warps: 2 (rows) x 4 (columns), 64 x 32 each
constexpr int kF32StageFloats = (kF32BM + kF32BN) * kF32Pitch;
constexpr int kF32SmemBytes = kF32Stages * kF32StageFloats * static_cast<int>(sizeof(float));
static_assert(kF32BM == kF32BN, "load_tile serves both operands");

// rows [r0, r0 + 128) and K [k0, k0 + 16) of src (`rows` rows of k floats)
// into dst [128][kF32Pitch]; what lies past either edge is zero-filled
template <bool kVec>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int rows,
                                          int k, int r0, int k0) {
  constexpr int kPer = kVec ? 4 : 1;  // floats a copy
  constexpr int kRowCopies = kF32BK / kPer;
#pragma unroll
  for (int i = 0; i < kF32BM * kRowCopies / kF32Threads; ++i) {
    const int c = threadIdx.x + i * kF32Threads;
    const int r = c / kRowCopies, kc = (c % kRowCopies) * kPer;
    const bool ok = r0 + r < rows && k0 + kc < k;  // K % 4 == 0 where kVec: all 4 or none
    const float* from = ok ? src + static_cast<size_t>(r0 + r) * k + k0 + kc : src;
    if constexpr (kVec) tile::cp_async16(dst + r * kF32Pitch + kc, from, ok);
    else tile::cp_async4(dst + r * kF32Pitch + kc, from, ok);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kF32Threads, 2)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, const float* __restrict__ res,
                float* __restrict__ y, int m, int n, int k, int gelu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);  // [stage][A 128 rows | W 128 rows][pitch]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int row0 = blockIdx.y * kF32BM, col0 = blockIdx.x * kF32BN;
  const int tiles = (k + kF32BK - 1) / kF32BK;
  auto load = [&](int slot, int kt) {
    float* stage = smem + slot * kF32StageFloats;
    load_tile<kVec>(stage, x, m, k, row0, kt * kF32BK);
    load_tile<kVec>(stage + kF32BM * kF32Pitch, w, n, k, col0, kt * kF32BK);
  };

  float acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) {
    if (s < tiles) load(s, s);
    tile::cp_async_commit();
  }
  for (int kt = 0; kt < tiles; ++kt) {
    tile::cp_async_wait<kF32Stages - 2>();
    __syncthreads();  // tile kt has landed, and every warp is done with the slot refilled next
    if (kt + kF32Stages - 1 < tiles) load((kt + kF32Stages - 1) % kF32Stages, kt + kF32Stages - 1);
    tile::cp_async_commit();
    const float* stage = smem + (kt % kF32Stages) * kF32StageFloats;
    // a thread's fragment K positions t and t + 4 of each 8 are read from
    // K positions 2t and 2t + 1, in A and W alike
    const float* a = stage + (wm * 64 + g) * kF32Pitch + 2 * t;
    const float* b = stage + (kF32BM + wn * 32 + g) * kF32Pitch + 2 * t;
#pragma unroll
    for (int ks = 0; ks < kF32BK / 8; ++ks) {
      unsigned bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 v = *reinterpret_cast<const float2*>(b + j * 8 * kF32Pitch + ks * 8);
        tile::split_tf32(v.x, bh[j][0], bl[j][0]);
        tile::split_tf32(v.y, bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 top = *reinterpret_cast<const float2*>(a + i * 16 * kF32Pitch + ks * 8);
        const float2 low = *reinterpret_cast<const float2*>(a + (i * 16 + 8) * kF32Pitch + ks * 8);
        unsigned ah[4], al[4];
        tile::split_tf32(top.x, ah[0], al[0]);
        tile::split_tf32(low.x, ah[1], al[1]);
        tile::split_tf32(top.y, ah[2], al[2]);
        tile::split_tf32(low.y, ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float step[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          tile::mma_tf32(step, al, bh[j][0], bh[j][1]);
          tile::mma_tf32(step, ah, bl[j][0], bl[j][1]);
          tile::mma_tf32(step, ah, bh[j][0], bh[j][1]);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] += step[c];
        }
      }
    }
  }

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
