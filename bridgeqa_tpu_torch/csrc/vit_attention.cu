// Bidirectional softmax attention of the fused ViT block, for Hopper (sm_90a).
//
// Replaces the per-head attention inside the Pallas kernel
// bridgeqa_tpu/ops/vit_block.py::_block_kernel: for each image and head,
// s = (q k^T) * scale in f32 over the N tokens, m = max(s), e = exp(s - m),
// the context (e v) / sum(e) with the product accumulated in f32 and one
// rounding at the end. The normalisation is deferred past the product with
// V, as in the scoring kernel (scoring_attention.cu, ops/scoring_layer.py::
// _attend_plain): e is rounded to the working type as the A operand of P V
// and the f32 context is divided by the f32 sum of the unrounded e. The TPU
// kernel normalises first (p = e / sum(e), rounded, then p v) only because
// the deferred form's live buffers did not fit Mosaic's scoped VMEM
// (bridgeqa_tpu/ops/vit_block.py:71-75); the rounding point moves from p to
// e, which both lie in [0, 1] and round with the same relative error. The
// TPU kernel pads N to a multiple of 16 and gives the padded keys a bias of
// -1e9, so they weigh exactly 0; here N is not padded and the tail of the
// last key tile is masked to -inf.
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
// What the design does about it (bf16): one sweep over the keys with an
// online softmax. One block of 4 warps per (128 query rows, image, head),
// each warp 32 rows (two m16 tiles, so every K and V fragment read from
// shared memory feeds two products), on mma.sync m16n8k16, three blocks on
// an SM. Keys and values come in tiles of 64 through a 2-stage cp.async
// ring. For each tile S = Q K^T is computed once, in f32, and only the last
// tile masks. When a row's max m grows, its running sum and context are
// rescaled; then e = exp(s * scale - m * scale), one FFMA into ex2 with
// scale * log2(e) (a few f32 ulps from the plain exp), joins the sum and,
// rounded to bf16 (the accumulator layout of S is the A layout of P), the
// product with V. Warps whose rows all lie past N only load. On the H100, 2 or 3 stages, 16 or 32
// rows a warp, 64 or 128 keys a tile, the queries in registers or in shared
// memory, and skipping the last tile's 16-key chunks past N all measured
// within 15% of this layout, none faster; wgmma is left for a later change.
//
// The f32 instantiation (BLIP-ITM's tower and the drivers' default f32
// predict and eval run it) is the same one sweep on the tensor cores in
// 3xTF32, through attention_f32.cuh's body (its numerics there): one block
// of 8 warps per (128 query rows, image, head), each warp 16 rows, two blocks
// an SM; the queries and a 2-stage cp.async ring of 64-key K and V tiles in
// shared memory (106 KB), so each tile crosses L2 once a block, not once a
// query row. Only the last tile masks (keys past N at -inf). Bound at the
// ITM shape (64 frames of 577 tokens): 7.9e11 FLOP a 12-block encode, 11.7 ms
// at the CUDA cores' 67 TFLOP/s, 4.8 ms for three TF32 passes at 495.

#include <cmath>
#include <type_traits>

#include "attention_f32.cuh"
#include "smem_attribute.cuh"
#include "tile_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kHd = 64;
constexpr int kLd = kHd + 8;  // padded shared-memory row: ldmatrix free of bank conflicts
constexpr int kWarps = 4;
constexpr int kWarpRows = 32;                // query rows of a warp
constexpr int kMt = kWarpRows / 16;          // its m16 tiles
constexpr int kRows = kWarpRows * kWarps;    // query rows of a block
constexpr int kKeys = 64;                    // keys of a tile: 4 chunks of 16
constexpr int kSmemBytes = (kRows + 4 * kKeys) * kLd * static_cast<int>(sizeof(bf16));

__global__ void __launch_bounds__(kWarps * 32, 3)
vit_attention_bf16_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int n, int heads,
                          float scale_log2) {
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
  const bool active = r0 + warp * kWarpRows < n;  // uniform over the warp

  for (int c = threadIdx.x; c < kRows * 8; c += kWarps * 32) {
    const int r = c >> 3, d = (c & 7) * 8;
    const bool ok = r0 + r < n;
    tile::cp_async16(sq + r * kLd + d, ok ? base + (r0 + r) * stride + d : base, ok);
  }
  // keys and values [kt * kKeys, +kKeys) into ring slot `slot`; rows past n
  // are zero-filled
  auto load = [&](int slot, int kt) {
    for (int c = threadIdx.x; c < kKeys * 8; c += kWarps * 32) {
      const int r = c >> 3, d = (c & 7) * 8;
      const int key = kt * kKeys + r;
      const bool ok = key < n;
      const bf16* src = base + static_cast<size_t>(ok ? key : 0) * stride + d;
      tile::cp_async16(sk + (slot * kKeys + r) * kLd + d, src + hh, ok);
      tile::cp_async16(sv + (slot * kKeys + r) * kLd + d, src + 2 * hh, ok);
    }
  };

  // per m16 tile mt and half h (row lane / 4 + 8 h): the running max of the
  // unscaled scores, that max in log2 units, and this thread's part of the
  // running sum
  float m[kMt][2], ms[kMt][2], l[kMt][2];
  float o[kMt][kHd / 8][4];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[mt][h] = ms[mt][h] = -INFINITY;
      l[mt][h] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kHd / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[mt][j][c] = 0.0f;
  }

  load(0, 0);
  tile::cp_async_commit();
  for (int kt = 0; kt < tiles; ++kt) {
    if (kt + 1 < tiles) load((kt + 1) & 1, kt + 1);
    tile::cp_async_commit();
    tile::cp_async_wait<1>();
    __syncthreads();  // tile kt (and at kt 0 the queries) has landed
    // one tile of `chunks` 16-key chunks (the last tile has only as many as
    // hold keys below n; a constant, so no branch enters the unrolled loops)
    auto step = [&](auto chunks) {
      constexpr int kC = decltype(chunks)::value;
      // S = Q K^T; the queries' A operands come from shared memory, which
      // leaves the registers for three blocks on an SM
      const bf16* tk = sk + (kt & 1) * kKeys * kLd;
      float s[kMt][kKeys / 8][4];
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int j = 0; j < 2 * kC; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[mt][j][c] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk) {
        unsigned qa[kMt][4];
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
          tile::ldmatrix_x4(
              qa[mt], sq + (warp * kWarpRows + mt * 16 + (lane & 15)) * kLd + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < kC; ++np) {
          unsigned b[4];
          tile::ldmatrix_x4(b, tk + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kLd + kk * 16 +
                                   ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < kMt; ++mt) {
            tile::mma_bf16(s[mt][2 * np], qa[mt], b[0], b[1]);
            tile::mma_bf16(s[mt][2 * np + 1], qa[mt], b[2], b[3]);
          }
        }
      }
      if ((kt + 1) * kKeys > n) {  // the last tile: keys past n at -inf
#pragma unroll
        for (int j = 0; j < 2 * kC; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (kt * kKeys + j * 8 + 2 * t + (c & 1) >= n)
#pragma unroll
              for (int mt = 0; mt < kMt; ++mt) s[mt][j][c] = -INFINITY;
      }
      // the rows' new maxima (of the unscaled scores: the scale is positive);
      // rescale the sums and contexts where they grew
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float tm = -INFINITY;
#pragma unroll
          for (int j = 0; j < 2 * kC; ++j)
            tm = fmaxf(tm, fmaxf(s[mt][j][2 * h], s[mt][j][2 * h + 1]));
          tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
          tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
          const float mn = fmaxf(m[mt][h], tm);  // finite: key 0 lies in tile 0
          const float alpha = tile::ex2((m[mt][h] - mn) * scale_log2);  // 0 at the first tile
          m[mt][h] = mn;
          ms[mt][h] = mn * scale_log2;
          l[mt][h] *= alpha;
#pragma unroll
          for (int j = 0; j < kHd / 8; ++j) {
            o[mt][j][2 * h] *= alpha;
            o[mt][j][2 * h + 1] *= alpha;
          }
        }
      // e = 2^(s - m) into the sums and, rounded to bf16, O += E V, 16 keys
      // at a time
      const bf16* tv = sv + (kt & 1) * kKeys * kLd;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        unsigned pa[kMt][4];
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            float e[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              e[q] = tile::ex2(fmaf(s[mt][2 * c + jj][q], scale_log2, -ms[mt][q >> 1]));
              l[mt][q >> 1] += e[q];
            }
            const __nv_bfloat162 lo = __floats2bfloat162_rn(e[0], e[1]);
            const __nv_bfloat162 hi = __floats2bfloat162_rn(e[2], e[3]);
            pa[mt][jj * 2] = *reinterpret_cast<const unsigned*>(&lo);
            pa[mt][jj * 2 + 1] = *reinterpret_cast<const unsigned*>(&hi);
          }
#pragma unroll
        for (int dp = 0; dp < kHd / 16; ++dp) {
          unsigned b[4];
          tile::ldmatrix_x4_trans(b, tv + (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                         dp * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < kMt; ++mt) {
            tile::mma_bf16(o[mt][2 * dp], pa[mt], b[0], b[1]);
            tile::mma_bf16(o[mt][2 * dp + 1], pa[mt], b[2], b[3]);
          }
        }
      }
    };
    if (active) {
      static_assert(kKeys == 64, "4 chunks of 16 keys");
      const int chunks = (min(n - kt * kKeys, kKeys) + 15) / 16;
      if (chunks == 4) step(std::integral_constant<int, 4>{});
      else if (chunks == 3) step(std::integral_constant<int, 3>{});
      else if (chunks == 2) step(std::integral_constant<int, 2>{});
      else step(std::integral_constant<int, 1>{});
    }
    __syncthreads();  // every warp is done with slot kt & 1 before it is refilled
  }

  // O / l in f32, rounded once
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[mt][h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int row = r0 + warp * kWarpRows + mt * 16 + (lane >> 2) + 8 * h;
      if (row >= n) continue;
      bf16* orow = out + (static_cast<size_t>(image) * n + row) * hh + head * kHd + 2 * t;
#pragma unroll
      for (int j = 0; j < kHd / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
            __floats2bfloat162_rn(o[mt][j][2 * h] / sum, o[mt][j][2 * h + 1] / sum);
    }
}

using attn32::kQPitch;
using attn32::kVPitch;

constexpr int kF32Warps = 8;                  // 16 query rows each
constexpr int kF32Rows = 16 * kF32Warps;      // query rows of a block
constexpr int kF32Keys = attn32::kTileKeys;   // keys of a tile: 8 chunks of 8
constexpr int kF32SmemBytes =
    (kF32Rows * kQPitch + 2 * kF32Keys * (kQPitch + kVPitch)) * static_cast<int>(sizeof(float));

__global__ void __launch_bounds__(kF32Warps * 32, 2)
vit_attention_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int n,
                         int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sq = reinterpret_cast<float*>(smem_raw);  // [kF32Rows][kQPitch]
  float* sk = sq + kF32Rows * kQPitch;             // [2][kF32Keys][kQPitch]
  float* sv = sk + 2 * kF32Keys * kQPitch;         // [2][kF32Keys][kVPitch]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int image = blockIdx.y / heads, head = blockIdx.y % heads;
  const int hh = heads * kHd;
  const size_t stride = 3 * static_cast<size_t>(hh);
  const float* base = qkv + static_cast<size_t>(image) * n * stride + head * kHd;
  const int r0 = blockIdx.x * kF32Rows;
  const int tiles = (n + kF32Keys - 1) / kF32Keys;
  const bool active = r0 + warp * 16 < n;  // uniform over the warp

  for (int c = threadIdx.x; c < kF32Rows * 16; c += kF32Warps * 32) {
    const int r = c >> 4, d = (c & 15) * 4;
    const bool ok = r0 + r < n;
    tile::cp_async16(sq + r * kQPitch + d, ok ? base + (r0 + r) * stride + d : base, ok);
  }
  // keys and values [kt * kF32Keys, +kF32Keys) into ring slot `slot`; rows
  // past n are zero-filled
  auto load = [&](int slot, int kt) {
    for (int c = threadIdx.x; c < kF32Keys * 16; c += kF32Warps * 32) {
      const int r = c >> 4, d = (c & 15) * 4;
      const int key = kt * kF32Keys + r;
      const bool ok = key < n;
      const float* src = base + static_cast<size_t>(ok ? key : 0) * stride + d;
      tile::cp_async16(sk + (slot * kF32Keys + r) * kQPitch + d, src + hh, ok);
      tile::cp_async16(sv + (slot * kF32Keys + r) * kVPitch + d, src + 2 * hh, ok);
    }
  };

  attn32::Rows st;
  attn32::init(st);
  load(0, 0);
  tile::cp_async_commit();
  for (int kt = 0; kt < tiles; ++kt) {
    if (kt + 1 < tiles) load((kt + 1) & 1, kt + 1);
    tile::cp_async_commit();
    tile::cp_async_wait<1>();
    __syncthreads();  // tile kt (and at kt 0 the queries) has landed
    if (active) {
      // the last tile has only as many chunks as hold keys below n, its
      // keys past n masked
      const int key0 = kt * kF32Keys;
      const bool last = key0 + kF32Keys > n;
      attn32::attend_chunks((min(n - key0, kF32Keys) + 7) / 8, st,
                            sq + (warp * 16 + g) * kQPitch + 2 * t,
                            sk + (kt & 1) * kF32Keys * kQPitch, sv + (kt & 1) * kF32Keys * kVPitch,
                            scale, [&](float s, int key, int) {
                              return last && key0 + key >= n ? -INFINITY : s;
                            });
    }
    __syncthreads();  // every warp is done with slot kt & 1 before it is refilled
  }

  const int row = r0 + warp * 16 + g;
  float* orow = out + (static_cast<size_t>(image) * n + row) * hh + head * kHd;
  attn32::store(st, orow, orow + 8 * static_cast<size_t>(hh), row < n, row + 8 < n);
}

}  // namespace

// qkv (batch, n, 3 * heads * 64) -> out (batch, n, heads * 64); hd must be 64.
// dtype 1: bf16 (out 4-byte aligned), 0: f32 (out 8-byte aligned); qkv 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int bq_vit_attention(const void* qkv, void* out, int batch, int n, int heads, int hd,
                                float scale, int dtype, void* stream) {
  if (hd != kHd || batch <= 0 || n <= 0 || heads <= 0 || batch * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (reinterpret_cast<size_t>(qkv) % 16 || reinterpret_cast<size_t>(out) % 4)
      return static_cast<int>(cudaErrorMisalignedAddress);
    const cudaError_t err =
        set_smem_once(reinterpret_cast<const void*>(vit_attention_bf16_kernel), kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + kRows - 1) / kRows, batch * heads);
    vit_attention_bf16_kernel<<<grid, kWarps * 32, kSmemBytes, s>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(out), n, heads,
        scale * 1.4426950408889634f);
  } else {
    if (reinterpret_cast<size_t>(qkv) % 16 || reinterpret_cast<size_t>(out) % 8)
      return static_cast<int>(cudaErrorMisalignedAddress);
    const cudaError_t err =
        set_smem_once(reinterpret_cast<const void*>(vit_attention_f32_kernel), kF32SmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + kF32Rows - 1) / kF32Rows, batch * heads);
    vit_attention_f32_kernel<<<grid, kF32Warps * 32, kF32SmemBytes, s>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), n, heads, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
