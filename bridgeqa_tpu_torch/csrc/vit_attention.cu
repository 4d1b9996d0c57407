// Bidirectional softmax attention of the fused ViT block, for Hopper (sm_90a).
//
// Replaces the per-head attention inside the Pallas kernel
// bridgeqa_tpu/ops/vit_block.py::_block_kernel, with its numerics: for each
// image and head, s = (q k^T) * scale in f32 over the N tokens, m = max(s),
// e = exp(s - m), p = e / sum(e) rounded to the working type, and the
// context p v accumulated in f32 and rounded once. The normalisation comes
// before the product with V, as in the TPU kernel (scoring_attention.cu
// defers it, as the scoring kernel does). The TPU kernel pads N to a multiple
// of 16 and gives the padded keys a bias of -1e9, so they weigh exactly 0;
// here N is not padded and the tail of the last key tile is masked.
//
// Input: the (B, N, 3H) output of the QKV product, [q heads | k heads |
// v heads] along each row, head h at columns h * 64. Output: (B, N, H), head h
// at columns h * 64. Head width 64 (ViT-B/16 and ViT-L/16 both).
//
// What bounds it on this card: the tensor cores, barely. At the main path
// (8 images, 12 heads, N = 901) one call does 4 * 901^2 * 64 * 96 = 20 GFLOP
// (20 us at 989 TFLOP/s) and must read the 33 MB QKV block and write the
// 11 MB context (13 us at 3.35 TB/s).
//
// What the design does about it (bf16): one block of 8 warps per (128 query
// rows, image, head), each warp 16 rows, on mma.sync m16n8k16. The 901 f32
// scores of 128 rows (461 KB) do not fit in shared memory, and p must be
// normalised before the product with V, so the keys are swept twice in tiles
// of 64 through a 2-stage cp.async ring: the first sweep computes S = Q K^T
// and keeps each row's running max and sum of exp (the sum rescaled by
// exp(m_old - m_new) as the max grows, which differs from the TPU kernel's
// sum after the max by a few f32 ulps); the second recomputes S, forms
// p = exp(s - m) * (1 / sum), rounds it to bf16 as the A operand of P V (the
// accumulator layout of S is the A layout of P) and accumulates the context.
// The second QK^T costs a third more operations and keeps the scores out of
// device memory. Per score the two sweeps otherwise spend only a few
// instructions: exp on the hardware's fast path (__expf, a few f32 ulps) and
// a product with the reciprocal of the sum for the division (an ulp), both
// far below the bf16 rounding of p that follows.
//
// The f32 instantiation (the card-vs-CPU reference) runs on the CUDA cores:
// one warp per query row, a lane per pair of head dimensions, the dot
// products reduced by warp shuffles, the same two sweeps with expf and the
// division.

#include <cmath>

#include "tile_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHd = 64;
constexpr int kLd = kHd + 8;  // padded shared-memory row: ldmatrix free of bank conflicts
constexpr int kWarps = 8;
constexpr int kRows = 16 * kWarps;  // query rows of a block
constexpr int kKeys = 64;           // keys of a tile
constexpr int kSmemBytes = (kRows + 4 * kKeys) * kLd * static_cast<int>(sizeof(bf16));

__global__ void __launch_bounds__(kWarps * 32)
vit_attention_bf16_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int n, int heads,
                          float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [kRows][kLd]
  bf16* sk = sq + kRows * kLd;                   // [2][kKeys][kLd]
  bf16* sv = sk + 2 * kKeys * kLd;               // [2][kKeys][kLd]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int image = blockIdx.y / heads, head = blockIdx.y % heads;
  const int hh = heads * kHd;
  const size_t stride = 3 * static_cast<size_t>(hh);
  const bf16* base = qkv + static_cast<size_t>(image) * n * stride + head * kHd;
  const int r0 = blockIdx.x * kRows;
  const int tiles = (n + kKeys - 1) / kKeys;

  for (int c = threadIdx.x; c < kRows * 8; c += kWarps * 32) {
    const int r = c >> 3, d = (c & 7) * 8;
    const bool ok = r0 + r < n;
    tile::cp_async16(sq + r * kLd + d, ok ? base + (r0 + r) * stride + d : base, ok);
  }
  // keys (and values) [kt * kKeys, +kKeys) into ring slot `slot`; rows past n
  // are zero-filled
  auto load = [&](int slot, int kt, bool values) {
    for (int c = threadIdx.x; c < kKeys * 8; c += kWarps * 32) {
      const int r = c >> 3, d = (c & 7) * 8;
      const int key = kt * kKeys + r;
      const bool ok = key < n;
      const bf16* src = base + static_cast<size_t>(ok ? key : 0) * stride + d;
      tile::cp_async16(sk + (slot * kKeys + r) * kLd + d, src + hh, ok);
      if (values) tile::cp_async16(sv + (slot * kKeys + r) * kLd + d, src + 2 * hh, ok);
    }
  };

  unsigned qa[kHd / 16][4];  // this warp's 16 query rows as A operands
  // S = Q K^T for the tile in `slot`, scaled, keys past n at -inf
  auto scores = [&](int slot, int kt, float (&s)[kKeys / 8][4]) {
    const bf16* tk = sk + slot * kKeys * kLd;
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk)
#pragma unroll
      for (int np = 0; np < kKeys / 16; ++np) {
        unsigned b[4];
        tile::ldmatrix_x4(b, tk + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kLd + kk * 16 +
                                 ((lane >> 3) & 1) * 8);
        tile::mma_bf16(s[2 * np], qa[kk], b[0], b[1]);
        tile::mma_bf16(s[2 * np + 1], qa[kk], b[2], b[3]);
      }
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = kt * kKeys + j * 8 + 2 * t + (c & 1);
        s[j][c] = key < n ? __fmul_rn(s[j][c], scale) : -INFINITY;
      }
  };

  // sweep 1: each row's max m and sum l of exp(s - m); c >> 1 picks the
  // thread's row (lane / 4, or lane / 4 + 8)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  load(0, 0, false);
  tile::cp_async_commit();
  for (int kt = 0; kt < tiles; ++kt) {
    if (kt + 1 < tiles) load((kt + 1) & 1, kt + 1, false);
    tile::cp_async_commit();
    tile::cp_async_wait<1>();
    __syncthreads();  // tile kt (and at kt 0 the queries) has landed
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk)
        tile::ldmatrix_x4(qa[kk],
                          sq + (warp * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
    }
    float s[kKeys / 8][4];
    scores(kt & 1, kt, s);
    float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) tm[c >> 1] = fmaxf(tm[c >> 1], s[j][c]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tm[h] = fmaxf(tm[h], __shfl_xor_sync(0xffffffffu, tm[h], 1));
      tm[h] = fmaxf(tm[h], __shfl_xor_sync(0xffffffffu, tm[h], 2));
      const float mn = fmaxf(m[h], tm[h]);  // finite: key 0 lies in tile 0
      l[h] *= __expf(m[h] - mn);
      m[h] = mn;
    }
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) l[c >> 1] += __expf(s[j][c] - m[c >> 1]);
    __syncthreads();  // every warp is done with slot kt & 1 before it is refilled
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  // sweep 2: p = exp(s - m) / l rounded to bf16, O = P V
  const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
  float o[kHd / 8][4];
#pragma unroll
  for (int j = 0; j < kHd / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.0f;
  load(0, 0, true);
  tile::cp_async_commit();
  for (int kt = 0; kt < tiles; ++kt) {
    if (kt + 1 < tiles) load((kt + 1) & 1, kt + 1, true);
    tile::cp_async_commit();
    tile::cp_async_wait<1>();
    __syncthreads();
    float s[kKeys / 8][4];
    scores(kt & 1, kt, s);
    unsigned p[kKeys / 16][4];
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      float e[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) e[c] = __expf(s[j][c] - m[c >> 1]) * inv[c >> 1];
      const __nv_bfloat162 lo = __floats2bfloat162_rn(e[0], e[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(e[2], e[3]);
      p[j >> 1][(j & 1) * 2] = *reinterpret_cast<const unsigned*>(&lo);
      p[j >> 1][(j & 1) * 2 + 1] = *reinterpret_cast<const unsigned*>(&hi);
    }
    const bf16* tv = sv + (kt & 1) * kKeys * kLd;
#pragma unroll
    for (int c = 0; c < kKeys / 16; ++c)
#pragma unroll
      for (int dp = 0; dp < kHd / 16; ++dp) {
        unsigned b[4];
        tile::ldmatrix_x4_trans(b, tv + (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                       dp * 16 + (lane >> 4) * 8);
        tile::mma_bf16(o[2 * dp], p[c], b[0], b[1]);
        tile::mma_bf16(o[2 * dp + 1], p[c], b[2], b[3]);
      }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + (lane >> 2) + 8 * h;
    if (row >= n) continue;
    bf16* orow = out + (static_cast<size_t>(image) * n + row) * hh + head * kHd + 2 * t;
#pragma unroll
    for (int j = 0; j < kHd / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(o[j][2 * h], o[j][2 * h + 1]);
  }
}

constexpr int kF32Warps = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;  // the same value in every lane: each step adds the same two operands
}

__global__ void __launch_bounds__(kF32Warps * 32)
vit_attention_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int n,
                         int heads, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kF32Warps + warp;
  if (row >= n) return;  // uniform over the warp
  const int image = blockIdx.y / heads, head = blockIdx.y % heads;
  const int hh = heads * kHd;
  const size_t stride = 3 * static_cast<size_t>(hh);
  const float* base = qkv + static_cast<size_t>(image) * n * stride + head * kHd + 2 * lane;
  const float2 q = *reinterpret_cast<const float2*>(base + row * stride);
  auto score = [&](int key) {
    const float2 k = *reinterpret_cast<const float2*>(base + key * stride + hh);
    return __fmul_rn(warp_sum(q.x * k.x + q.y * k.y), scale);
  };
  float m = -INFINITY, l = 0.0f;
  for (int key = 0; key < n; ++key) {
    const float s = score(key);
    const float mn = fmaxf(m, s);
    l = l * expf(m - mn) + expf(s - mn);
    m = mn;
  }
  float a0 = 0.0f, a1 = 0.0f;
  for (int key = 0; key < n; ++key) {
    const float p = expf(score(key) - m) / l;
    const float2 v = *reinterpret_cast<const float2*>(base + key * stride + 2 * hh);
    a0 += p * v.x;
    a1 += p * v.y;
  }
  *reinterpret_cast<float2*>(out + (static_cast<size_t>(image) * n + row) * hh + head * kHd +
                             2 * lane) = make_float2(a0, a1);
}

}  // namespace

// qkv (batch, n, 3 * heads * 64) -> out (batch, n, heads * 64); hd must be 64.
// dtype 1: bf16 (qkv 16-byte aligned), 0: f32 (8-byte aligned). Returns
// cudaGetLastError() after the launch.
extern "C" int bq_vit_attention(const void* qkv, void* out, int batch, int n, int heads, int hd,
                                float scale, int dtype, void* stream) {
  if (hd != kHd || batch <= 0 || n <= 0 || heads <= 0 || batch * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (reinterpret_cast<size_t>(qkv) % 16 || reinterpret_cast<size_t>(out) % 4)
      return static_cast<int>(cudaErrorMisalignedAddress);
    // the attribute is per device: set it before every launch
    const cudaError_t err = cudaFuncSetAttribute(
        vit_attention_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + kRows - 1) / kRows, batch * heads);
    vit_attention_bf16_kernel<<<grid, kWarps * 32, kSmemBytes, s>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(out), n, heads, scale);
  } else {
    if ((reinterpret_cast<size_t>(qkv) | reinterpret_cast<size_t>(out)) % 8)
      return static_cast<int>(cudaErrorMisalignedAddress);
    const dim3 grid((n + kF32Warps - 1) / kF32Warps, batch * heads);
    vit_attention_f32_kernel<<<grid, kF32Warps * 32, 0, s>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), n, heads, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
