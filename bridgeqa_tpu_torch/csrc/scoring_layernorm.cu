// Residual add and LayerNorm of the fused scoring decoder layer and of the
// fused ViT block, for Hopper (sm_90a).
//
// Replaces the three `ln(y + x)` steps inside the Pallas kernel
// bridgeqa_tpu/ops/scoring_layer.py::_layer_kernel and the two `ln(.)` steps
// inside bridgeqa_tpu/ops/vit_block.py::_block_kernel, with their numerics:
// the residual sum is taken in the working type (rounded once), then cast to
// f32; mu = mean(y), var = mean(y * y) - mu * mu (one pass, as the TPU
// kernels), out = (y - mu) * rsqrt(var + eps) * scale + bias, rounded once.
// Three modes: LayerNorm(a + r) (the decoder), LayerNorm(a) with no residual
// (the ViT's LN1 and its final norm), and LayerNorm(a + r) that also writes
// the rounded sum (the ViT's x1 = x + attn, both LN2's input and the block's
// residual).
//
// What bounds it on this card: memory. At the main-path shapes it reads two
// (24576, 768) bf16 blocks and writes one (113 MB, 34 us at 3.35 TB/s) and
// does ~10 operations per element.
//
// What the design does about it: one warp per row. Each lane reads pairs of
// elements (4-byte loads, neighbouring lanes on neighbouring addresses),
// keeps the f32 sums in registers and reduces them by warp shuffles; the
// second pass re-reads the row from L1, so the sum never goes to device
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 round2(float2 v, const float*) { return v; }
__device__ __forceinline__ float2 round2(float2 v, const bf16*) {
  return __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// a + r in the working type, or a where r is null
template <typename T>
__device__ __forceinline__ float2 residual(const T* a, const T* r, int i) {
  const float2 x = load2(a + i);
  if (!r) return x;
  const float2 y = load2(r + i);
  return round2(make_float2(x.x + y.x, x.y + y.y), a);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
add_layernorm_kernel(const T* __restrict__ a, const T* __restrict__ r,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     T* __restrict__ out, T* __restrict__ sum_out, int rows, int cols,
                     float eps) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform over the warp
  const size_t base = static_cast<size_t>(row) * cols;
  const T* rrow = r ? r + base : nullptr;
  float sum = 0.0f, sq = 0.0f;
  for (int i = 2 * lane; i < cols; i += 64) {
    const float2 y = residual(a + base, rrow, i);
    if (sum_out) store2(sum_out + base + i, y.x, y.y);  // exact: y is already rounded
    sum += y.x + y.y;
    sq += y.x * y.x + y.y * y.y;
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  const float mu = sum / cols;
  const float inv = rsqrtf(sq / cols - mu * mu + eps);
  for (int i = 2 * lane; i < cols; i += 64) {
    const float2 y = residual(a + base, rrow, i);
    const float2 s = load2(scale + i), b = load2(bias + i);
    store2(out + base + i, (y.x - mu) * inv * s.x + b.x, (y.y - mu) * inv * s.y + b.y);
  }
}

}  // namespace

// out (rows, cols) = LayerNorm(a + r) with f32 scale and bias (cols,), or
// LayerNorm(a) where r is null; where sum_out is not null it receives a + r.
// cols even. dtype 1: bf16 a, r, out, sum_out; 0: f32. Returns
// cudaGetLastError() after the launch.
extern "C" int bq_scoring_layernorm(const void* a, const void* r, const float* scale,
                                    const float* bias, void* out, void* sum_out, int rows,
                                    int cols, float eps, int dtype, void* stream) {
  if (cols % 2) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kWarps - 1) / kWarps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    add_layernorm_kernel<bf16><<<blocks, kWarps * 32, 0, s>>>(
        static_cast<const bf16*>(a), static_cast<const bf16*>(r), scale, bias,
        static_cast<bf16*>(out), static_cast<bf16*>(sum_out), rows, cols, eps);
  else
    add_layernorm_kernel<float><<<blocks, kWarps * 32, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(r), scale, bias,
        static_cast<float*>(out), static_cast<float*>(sum_out), rows, cols, eps);
  return static_cast<int>(cudaGetLastError());
}
