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
// The f32 kernels (BLIP-ITM's tower and the drivers' default f32 predict
// and eval run them; their numerics in tile_gemm.cuh): 3xTF32 on the tensor
// cores. At BLIP-ITM's shape (36928 rows, the ViT's four products) an encode
// does 6.27e12 FLOP: 94 ms at the CUDA cores' 67 TFLOP/s, 38 ms for the three
// passes at TF32's 495 (the bound: 3 x FLOP / 495 TFLOP/s). Where K % 4 == 0
// and X and W are 16-byte aligned (every main-path shape: K 768 or 3072),
// gemm_f32_kernel_wgmma: tile_gemm.cuh's tf32_mainloop (TMA into a 4-stage
// ring, W split once a stage in shared memory by the producer warpgroup's
// spare warps, two consumer warpgroups on wgmma.m64n128k8 .tf32 sharing each
// 128 x 128 tile, a persistent grid of one block per SM walking the tiles as
// the bf16 kernel does). Elsewhere gemm_f32_kernel: tile_gemm.cuh's
// f32_mainloop on mma.sync m16n8k8 with 4-byte cp.async copies, two blocks
// an SM. Both end in the bf16 kernel's epilogue on the f32 sum: bias, exact
// erf-GELU, residual, in that order, stored straight from the accumulator's
// layout (the TMA route in 8-byte pairs where N is even and Y and the
// residual 8-byte aligned, which measured 3% of the products' time faster
// than single floats; the epilogue does not overlap the products there).

#include "smem_attribute.cuh"
#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using wg::gelu_exact;

using tile::kF32BM;
using tile::kF32BN;
using tile::kF32SmemBytes;
using tile::kF32Threads;
using tile::TF32Config;

// y[row, col] = epilogue(v + bias[col]) where (row, col) lies inside (m, n)
__device__ __forceinline__ void store_f32(float* __restrict__ y, const float* __restrict__ bias,
                                          const float* __restrict__ res, int m, int n, int gelu,
                                          int row, int col, float v) {
  if (row >= m || col >= n) return;
  v += bias[col];
  if (gelu) v = gelu_exact(v);
  const size_t at = static_cast<size_t>(row) * n + col;
  y[at] = res ? res[at] + v : v;
}

// store_f32 of (row, col) and (row, col + 1) as one 8-byte access where
// `pairs` (n even, y and res 8-byte aligned, col even) and both lie inside
__device__ __forceinline__ void store_f32_pair(float* __restrict__ y, const float* __restrict__ bias,
                                               const float* __restrict__ res, int m, int n,
                                               int gelu, bool pairs, int row, int col, float v0,
                                               float v1) {
  if (!pairs || col + 1 >= n) {
    store_f32(y, bias, res, m, n, gelu, row, col, v0);
    store_f32(y, bias, res, m, n, gelu, row, col + 1, v1);
    return;
  }
  if (row >= m) return;
  v0 += bias[col];
  v1 += bias[col + 1];
  if (gelu) {
    v0 = gelu_exact(v0);
    v1 = gelu_exact(v1);
  }
  const size_t at = static_cast<size_t>(row) * n + col;
  if (res) {
    const float2 r = *reinterpret_cast<const float2*>(res + at);
    v0 = r.x + v0;
    v1 = r.y + v1;
  }
  *reinterpret_cast<float2*>(y + at) = make_float2(v0, v1);
}

// the TMA route: x (m, k) and w (n, k) through their tensor maps
__global__ void __launch_bounds__(TF32Config::THREADS, 1)
gemm_f32_kernel_wgmma(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w, const float* __restrict__ bias,
                      const float* __restrict__ res, float* __restrict__ y, int m, int n, int k,
                      int gelu) {
  using C = TF32Config;
  extern __shared__ unsigned char smem_raw[];
  const tile::TF32Ring ring = wg::setup<C>(smem_raw);
  const int ntiles = (n + C::BN - 1) / C::BN;
  const int tiles = (m + C::BM - 1) / C::BM * ntiles;
  const int ktiles = (k + C::BK - 1) / C::BK;
  const int grid = gridDim.x, mine = (tiles - blockIdx.x + grid - 1) / grid;  // the block's tiles
  // the block's j-th tile walks the output tiles row-major (N fastest)
  auto tile_at = [&](int j) {
    const int tile = blockIdx.x + j * grid;
    return make_int2(tile / ntiles * C::BM, tile % ntiles * C::BN);
  };

  if (threadIdx.x / 128 == 0) {
    wg::produce(ring, &map_x, &map_w, mine, ktiles, tile_at);
    if (threadIdx.x >= 32) tile::tf32_split(ring, mine * ktiles);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int me = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    // pairs of columns go out as 8-byte stores where every pair is aligned
    const bool pairs =
        n % 2 == 0 && (reinterpret_cast<size_t>(y) | reinterpret_cast<size_t>(res)) % 8 == 0;
    float sum[64];
    for (int j = 0; j < mine; ++j) {
      const int2 tile = tile_at(j);
      tile::tf32_mainloop(ring, j, ktiles, me, sum);
      // sum[4c + 2h + e] is row r + 8h, column 8c + 2 (lane % 4) + e of the tile
      const int row = tile.x + me * 64 + warp * 16 + lane / 4;
#pragma unroll
      for (int c = 0; c < C::BN / 8; ++c) {
        const int col = tile.y + c * 8 + (lane % 4) * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          store_f32_pair(y, bias, res, m, n, gelu, pairs, row + 8 * h, col, sum[4 * c + 2 * h],
                         sum[4 * c + 2 * h + 1]);
      }
    }
  }
}

// the mma.sync route, any k and alignment
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
  tile::f32_mainloop(x, w, m, n, k, row0, col0, reinterpret_cast<float*>(smem_raw), acc);

  // acc[i][j][2h + e] is row wm * 64 + i * 16 + g + 8h, column wn * 32 +
  // j * 8 + 2t + e of the tile
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          store_f32(y, bias, res, m, n, gelu, row0 + wm * 64 + i * 16 + g + 8 * h,
                    col0 + wn * 32 + j * 8 + 2 * t + e, acc[i][j][2 * h + e]);
}

// the f32 route of bq_scoring_gemm: the TMA route where k % 4 == 0 and x
// and w are 16-byte aligned (ops/cuda_lib.py::f32_tma_route mirrors this),
// the mma.sync route elsewhere
cudaError_t launch_f32(const float* x, const float* w, const float* bias, const float* res,
                       float* y, int m, int n, int k, int gelu, cudaStream_t s) {
  if (k > 0 && k % 4 == 0 && (reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(w)) % 16 == 0) {
    using C = TF32Config;
    cudaError_t err = set_smem_once(reinterpret_cast<const void*>(gemm_f32_kernel_wgmma), C::SMEM_BYTES);
    int dev = 0, sms = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    CUtensorMap map_x, map_w;
    if (err == cudaSuccess) err = wg::make_map(&map_x, x, m, k, C::BM, true);
    if (err == cudaSuccess) err = wg::make_map(&map_w, w, n, k, C::BN, true);
    if (err != cudaSuccess) return err;
    const int tiles = (m + C::BM - 1) / C::BM * ((n + C::BN - 1) / C::BN);
    gemm_f32_kernel_wgmma<<<tiles < sms ? tiles : sms, C::THREADS, C::SMEM_BYTES, s>>>(
        map_x, map_w, bias, res, y, m, n, k, gelu);
    return cudaGetLastError();
  }
  const dim3 grid((n + kF32BN - 1) / kF32BN, (m + kF32BM - 1) / kF32BM);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = set_smem_once(reinterpret_cast<const void*>(gemm_f32_kernel), kF32SmemBytes);
  if (err != cudaSuccess) return err;
  gemm_f32_kernel<<<grid, kF32Threads, kF32SmemBytes, s>>>(x, w, bias, res, y, m, n, k, gelu);
  return cudaGetLastError();
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
  if (m <= 0 || n <= 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_f32(static_cast<const float*>(x), static_cast<const float*>(w), bias,
                                     static_cast<const float*>(res), static_cast<float*>(y), m, n, k,
                                     gelu, s));
}
