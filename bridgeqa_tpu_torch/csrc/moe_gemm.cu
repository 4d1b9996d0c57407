// The grouped expert product of a mixture-of-experts layer, for Hopper
// (sm_90a): Y = epilogue(X_e * W_e^T) for every expert e in one launch, where
// X_e is the run of rows of X that routing sent to expert e (X's rows are
// sorted by expert, offsets[e] to offsets[e + 1]) and W_e is expert e's
// (N, K) block of one (E * N, K) weight. The row counts vary by expert and
// live on the card: the host never reads them.
//
// Two epilogues:
// - SWIGLU (the experts' gate and up products in one): W_e holds the gate
//   and up rows interleaved in blocks of 64 (rows 128 j .. 128 j + 63 are
//   gate rows 64 j .., the next 64 the matching up rows), so one 128-column
//   output tile holds the gate and up values of the same 64 features in one
//   thread's registers; Y (rows, N / 2) = silu(g) * u, rounded to bf16 where
//   the model rounds (the gate and up products, silu, the product).
// - DOWN: Y (rows, N) = round(w_row * round(acc)), the routing weight of each
//   row (f32, sorted as X) applied to the expert's rounded output.
//
// What bounds it: decoding a batch of 256 sends about 24 rows to each of 64
// experts, and each expert's whole weight must be read (bytes: 0.77 GB a
// layer at 3.35 TB/s); prefill sends about 1400 rows an expert (compute).
// One design serves both: the main loop of wgmma_gemm.cuh (TMA into the
// 5-stage ring, one producer thread, two consumer warpgroups in ping-pong,
// setup(), produce() and mainloop() as the scoring GEMM uses them) over a
// persistent grid of work items (expert, row tile, column tile), column tile
// fastest. Each block builds the tile schedule itself from offsets: the
// prefix sums of the experts' row tiles, one warp's scan into shared memory
// at the block's start. An expert with no rows has no tiles. X's map covers
// all rows, so a tile that runs past an expert's rows loads the next
// expert's rows (or TMA's zeros past the last), computes them, and stores
// none of them; W's map is one (E * N, K) tensor. The epilogue stages the
// rounded tile in the consumer's shared-memory buffer and copies the
// expert's own rows out with 16-byte stores (a TMA store would clip only at
// the tensor's edge, not at the expert's last row).
//
// Needs K % 8 == 0, N % 8 == 0 (N % 128 == 0 for SWIGLU), 16-byte aligned
// X, W and Y, and at most kMaxExperts experts.

#include "smem_attribute.cuh"
#include "wgmma_gemm.cuh"

namespace {

using wg::bf16;
using wg::Config;
using wg::Ring;
using wg::round_bf16;

constexpr int kMaxExperts = 128;

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

template <bool SWIGLU>
__global__ void __launch_bounds__(Config::THREADS, 1)
moe_gemm_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
                const int* __restrict__ offsets, const float* __restrict__ row_weight,
                bf16* __restrict__ y, int experts, int n, int k) {
  using C = Config;
  // tile_start[e]: the row tiles of experts before e; row_start[e] = offsets[e]
  __shared__ int tile_start[kMaxExperts + 1], row_start[kMaxExperts + 1];
  extern __shared__ unsigned char smem_raw[];
  const int lane = threadIdx.x % 32;
  if (threadIdx.x < 32) {
    int carry = 0;
    for (int base = 0; base < experts; base += 32) {
      const int e = base + lane;
      int t = 0;
      if (e < experts) {
        const int r0 = offsets[e];
        row_start[e] = r0;
        t = (offsets[e + 1] - r0 + C::BM - 1) / C::BM;
      }
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, t, d);
        if (lane >= d) t += v;
      }
      if (e < experts) tile_start[e + 1] = carry + t;
      carry += __shfl_sync(0xffffffffu, t, 31);
    }
    if (lane == 0) {
      tile_start[0] = 0;
      row_start[experts] = offsets[experts];
    }
  }
  const Ring ring = wg::setup(smem_raw);  // ends on a block barrier

  const int ntiles = (n + C::BN - 1) / C::BN;
  const int items = tile_start[experts] * ntiles;
  const int ktiles = (k + C::BK - 1) / C::BK;
  const int grid = gridDim.x, mine = (items - static_cast<int>(blockIdx.x) + grid - 1) / grid;
  // the block's j-th item: (expert, first row of X, first column within the
  // expert's N), found by a binary search of tile_start
  auto item_at = [&](int j) {
    const int item = blockIdx.x + j * grid;
    const int t = item / ntiles;
    int lo = 0, hi = experts;  // the last expert whose tiles start at or before t
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (tile_start[mid] <= t) lo = mid;
      else hi = mid;
    }
    return make_int3(lo, row_start[lo] + (t - tile_start[lo]) * C::BM, item % ntiles * C::BN);
  };
  auto load_at = [&](int j) {
    const int3 it = item_at(j);
    return make_int2(it.y, it.x * n + it.z);
  };

  if (threadIdx.x / 128 == 0) {
    wg::produce(ring, &map_x, &map_w, mine, ktiles, load_at);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int me = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4;
  float lo[64], hi[64];  // rows 0-63 and 64-127 of the tile
  const uint32_t out = ring.out + me * C::OUT_BYTES;
  // the output's row width and the 16-byte chunks of a tile's row
  const int n_out = SWIGLU ? n / 2 : n;
  constexpr int CH = SWIGLU ? 8 : 16;
  for (int j = me; j < mine; j += 2) {
    const int3 it = item_at(j);
    const int row0 = it.y, valid = min(C::BM, row_start[it.x + 1] - row0);
    const int col0 = SWIGLU ? it.z / 2 : it.z;  // the tile's first output column
    wg::mainloop(ring, j, mine, ktiles, me, lo, hi);

    wg::warpgroup_sync(3 + me);  // the buffer's last copy-out has read it
    // into this consumer's output tile in shared memory, as 128 x 64 boxes
    // under the 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8)).
    // Thread columns 8 c + 2 (lane % 4), + 1; rows r, r + 8, r + 64, r + 72.
    const int r = warp * 16 + lane / 4;
    auto put = [&](uint32_t at, float v0, float v1) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at), "r"(*reinterpret_cast<const uint32_t*>(&pair))
                   : "memory");
    };
    if (SWIGLU) {
      auto act = [](float g, float u) { return round_bf16(round_bf16(silu(round_bf16(g))) * round_bf16(u)); };
#pragma unroll
      for (int c = 0; c < 8; ++c) {  // gate in columns 0-63, up in 64-127
        const uint32_t at = out + r * 128 + ((c % 8) ^ (lane / 4)) * 16 + (lane % 4) * 4;
        put(at, act(lo[4 * c], lo[4 * c + 32]), act(lo[4 * c + 1], lo[4 * c + 33]));
        put(at + 8 * 128, act(lo[4 * c + 2], lo[4 * c + 34]), act(lo[4 * c + 3], lo[4 * c + 35]));
        put(at + 64 * 128, act(hi[4 * c], hi[4 * c + 32]), act(hi[4 * c + 1], hi[4 * c + 33]));
        put(at + 72 * 128, act(hi[4 * c + 2], hi[4 * c + 34]), act(hi[4 * c + 3], hi[4 * c + 35]));
      }
    } else {
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = r + (i % 2) * 8 + (i / 2) * 64;
        w[i] = rr < valid ? (row_weight ? row_weight[row0 + rr] : 1.0f) : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < C::BN / 8; ++c) {
        const uint32_t at = out + (c / 8) * (C::BM * 128) + r * 128 + ((c % 8) ^ (lane / 4)) * 16 + (lane % 4) * 4;
        put(at, w[0] * round_bf16(lo[4 * c]), w[0] * round_bf16(lo[4 * c + 1]));
        put(at + 8 * 128, w[1] * round_bf16(lo[4 * c + 2]), w[1] * round_bf16(lo[4 * c + 3]));
        put(at + 64 * 128, w[2] * round_bf16(hi[4 * c]), w[2] * round_bf16(hi[4 * c + 1]));
        put(at + 72 * 128, w[3] * round_bf16(hi[4 * c + 2]), w[3] * round_bf16(hi[4 * c + 3]));
      }
    }
    wg::warpgroup_sync(3 + me);
    // the expert's own rows out, a 16-byte chunk a thread, a row's chunks
    // by consecutive threads
    for (int i = threadIdx.x % 128; i < C::BM * CH; i += 128) {
      const int rr = i / CH, c = i % CH;
      if (rr >= valid) break;
      const int col = col0 + c * 8;
      if (col >= n_out) continue;
      uint4 v;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(out + (c / 8) * (C::BM * 128) + rr * 128 + ((c % 8) ^ (rr % 8)) * 16)
                   : "memory");
      *reinterpret_cast<uint4*>(y + static_cast<size_t>(row0 + rr) * n_out + col) = v;
    }
  }
}

}  // namespace

// y = the grouped product of x (m, k) and w (experts * n, k), bf16, rows of
// x sorted by expert (offsets (experts + 1,) int32 on the card, offsets[0]
// == 0, offsets[experts] == m). swiglu 1: y (m, n / 2) = silu(gate) * up of
// the interleaved gate/up weight; swiglu 0: y (m, n) = row_weight[row] *
// the product (row_weight f32 (m,), or null for 1). The launch reads no
// count on the host: a persistent grid of at most one block per SM. Returns
// cudaGetLastError() after the launch.
extern "C" int bq_moe_gemm(const void* x, const void* w, const int* offsets, const float* row_weight,
                           void* y, int m, int experts, int n, int k, int swiglu, void* stream) {
  using C = Config;
  if (m <= 0 || experts <= 0 || experts > kMaxExperts || k % 8 || n % 8 || (swiglu && n % 128) ||
      (reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(w) | reinterpret_cast<size_t>(y)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = swiglu ? moe_gemm_kernel<true> : moe_gemm_kernel<false>;
  cudaError_t err = set_smem_once(reinterpret_cast<const void*>(kernel), C::SMEM_BYTES);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  CUtensorMap map_x, map_w;
  if (err == cudaSuccess) err = wg::make_map(&map_x, x, m, k, C::BM);
  if (err == cudaSuccess) err = wg::make_map(&map_w, w, experts * n, k, C::BN);
  if (err != cudaSuccess) return static_cast<int>(err);
  // at most floor(m / BM) + experts row tiles, whatever the counts
  const long long items = (static_cast<long long>(m) / C::BM + experts) * ((n + C::BN - 1) / C::BN);
  const int grid = items < sms ? static_cast<int>(items) : sms;
  kernel<<<grid, C::THREADS, C::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      map_x, map_w, offsets, row_weight, static_cast<bf16*>(y), experts, n, k);
  return static_cast<int>(cudaGetLastError());
}
