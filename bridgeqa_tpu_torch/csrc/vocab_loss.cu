// Streaming vocabulary reductions of the answer-scoring loss, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel bridgeqa_tpu/ops/vocab_loss.py::_kernel. Per
// row of h it returns (lse, sum_logits, target_logit) of
// logits = h * table^T + bias, accumulated in f32 and never rounded; columns
// at or past `vocab` take no part. The logits never reach device memory.
//
// What bounds it on this card: the tensor cores. One pass at the main-path
// shapes (22528 rows, 30524 words, width 768) is 1.06 TFLOP against ~82 MB
// that must move: 1.07 ms at 989 TFLOP/s.
//
// What the design does about it (bf16): the product runs on the Hopper main
// loop of wgmma_gemm.cuh (TMA loads under the 128-byte swizzle into a
// 5-stage mbarrier ring, one producer thread, two consumer warpgroups on
// wgmma.m64n128k16 in ping-pong, a persistent grid of one block per SM), and
// the epilogue folds each 128 x 128 tile of logits, still in the
// accumulator registers, into a running (max, sum of exp, sum of logits,
// target logit) per row: the f32 bias added, the columns at or past `vocab`
// masked (TMA zero-fills the table's rows past it, so they would count), the
// flash-attention rescaling applied to logsumexp. A thread owns 4 rows (r,
// r + 8, r + 64, r + 72 of the tile) and 32 columns of each. The work unit
// is (128-row panel, run of `per_run` vocabulary tiles, an even number): its
// tiles alternate between the two consumers, each keeps its rows' stats in
// registers across its half of the run, and at the run's end merges the four
// threads of a quad (which share rows) by shuffles and writes one float4
// partial per row. Units are numbered run-major, so the blocks in flight
// share one run of the table in L2 and each keeps its own row panel there.
// The number of runs is chosen so the units fill the card's blocks in whole
// waves. A second, O(rows) kernel merges the partials and takes the log.
//
// The f32 kernels (the drivers' default f32 predict and eval run them):
// 2.11e12 FLOP a forward (two passes), 31.5 ms at the CUDA cores' 67 TFLOP/s
// and 12.8 ms for three TF32 passes at 495. Where the width is a multiple of
// 4 and h and the table are 16-byte aligned (the main path's 768),
// vocab_f32_kernel_wgmma: the product on tile_gemm.cuh's tf32_mainloop (the
// f32 products' own: TMA, W split once a stage in shared memory, two
// consumer warpgroups on wgmma .tf32 sharing each 128 x 128 tile; numerics
// there), a persistent grid of one block per SM walking the units run-major
// as the bf16 kernel does, each block all tiles of a unit. The epilogue folds
// each tile's logits, still in the step sums, into (max, sum of exp, sum of
// logits, target logit) per row with the bf16 kernel's fold_row: a thread
// holds 2 rows and 32 columns of each tile, and at the run's end the quad's
// four threads merge by shuffles and one float4 partial per row goes out.
// Elsewhere vocab_f32_kernel, one block a unit on tile_gemm.cuh's mma.sync
// loop (a thread holds 8 rows and 8 columns of a tile; the four column warps
// merge through shared memory at the run's end).

#include "smem_attribute.cuh"
#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

constexpr float kNeg = -1e30f;

struct Stat {
  float m, s, sum, tgt;
};

__device__ __forceinline__ Stat stat_init() { return Stat{kNeg, 0.0f, 0.0f, 0.0f}; }

__device__ __forceinline__ void merge(Stat& a, const Stat& b) {
  const float m = fmaxf(a.m, b.m);
  a.s = a.s * expf(a.m - m) + b.s * expf(b.m - m);
  a.m = m;
  a.sum += b.sum;
  a.tgt += b.tgt;
}

// Fold `n` logits of one row (valid ones only) into its running stat.
template <int N>
__device__ __forceinline__ void fold(Stat& a, const float (&v)[N], const int (&col)[N],
                                     int vocab, int label) {
  float tmax = kNeg;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (col[i] < vocab) tmax = fmaxf(tmax, v[i]);
  const float m = fmaxf(a.m, tmax);
  float s = a.s * expf(a.m - m);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (col[i] < vocab) {
      s += expf(v[i] - m);
      a.sum += v[i];
      if (col[i] == label) a.tgt += v[i];
    }
  a.s = s;
  a.m = m;
}

// Fold the 32 logits of one row that a consumer thread holds in a wgmma
// accumulator, d[4 c + OFF + q] at column cb + 8 c + q (c < 16, q < 2; OFF 0
// for the row r, 2 for r + 8), into its stat; MASK: some columns may be at
// or past `vocab`.
template <int OFF, bool MASK>
__device__ __forceinline__ void fold_row(Stat& a, const float (&d)[64], int cb, int vocab,
                                         int label) {
  float tmax = kNeg;
#pragma unroll
  for (int c = 0; c < 16; ++c)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (!MASK || cb + 8 * c + q < vocab) tmax = fmaxf(tmax, d[4 * c + OFF + q]);
  const float m = fmaxf(a.m, tmax);
  float s = a.s * expf(a.m - m), sum = 0.0f;
#pragma unroll
  for (int c = 0; c < 16; ++c)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (!MASK || cb + 8 * c + q < vocab) {
        s += expf(d[4 * c + OFF + q] - m);
        sum += d[4 * c + OFF + q];
      }
  // the label's column, counted from this thread's first: 8 c + q when
  // this thread holds it
  const int t = label - cb;
  if (t >= 0 && t < 128 && (t & 6) == 0) {
#pragma unroll
    for (int c = 0; c < 16; ++c)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        if (t == 8 * c + q) a.tgt += d[4 * c + OFF + q];
  }
  a.m = m;
  a.s = s;
  a.sum += sum;
}

// h (rows, hdim) and the table (vocab, hdim) through their TMA maps; the
// vocabulary cut into runs of per_run tiles (even); partial (2 runs, rows)
// float4: consumer c's stats of run u at [2 u + c].
__global__ void __launch_bounds__(wg::Config::THREADS, 1)
vocab_wgmma_kernel(const __grid_constant__ CUtensorMap map_h,
                   const __grid_constant__ CUtensorMap map_t, const float* __restrict__ bias,
                   const int* __restrict__ labels, float4* __restrict__ partial, int rows,
                   int vocab, int hdim, int runs, int per_run) {
  using C = wg::Config;
  extern __shared__ unsigned char smem_raw[];
  const wg::Ring ring = wg::setup(smem_raw);
  const int panels = (rows + C::BM - 1) / C::BM;
  const int grid = gridDim.x;
  const int count = (panels * runs - blockIdx.x + grid - 1) / grid * per_run;  // the block's tiles
  const int ktiles = (hdim + C::BK - 1) / C::BK;
  // the block's j-th tile: tile j % per_run of its unit blockIdx.x + (j /
  // per_run) grid, unit u being (run u / panels, panel u % panels)
  auto unit_of = [&](int j) { return blockIdx.x + j / per_run * grid; };
  auto tile_at = [&](int j) {
    const int u = unit_of(j);
    return make_int2(u % panels * C::BM, (u / panels * per_run + j % per_run) * C::BN);
  };

  if (threadIdx.x / 128 == 0) {
    wg::produce(ring, &map_h, &map_t, count, ktiles, tile_at);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int me = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int r = warp * 16 + lane / 4;  // this thread's rows: r, r + 8, r + 64, r + 72
  float lo[64], hi[64];                // rows 0-63 and 64-127 of the tile
  Stat st[4];
  int lab[4];
  for (int j = me; j < count; j += 2) {
    const int2 tile = tile_at(j);
    const int row0 = tile.x, col0 = tile.y, t = j % per_run;
    if (t < 2) {  // this consumer's first tile of the unit
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = row0 + r + (i % 2) * 8 + (i / 2) * 64;
        lab[i] = row < rows ? labels[row] : -1;
        st[i] = stat_init();
      }
    }
    wg::mainloop(ring, j, count, ktiles, me, lo, hi);
    if (col0 < vocab) {  // else the tile lies wholly past the vocabulary
      const int cb = col0 + (lane % 4) * 2;  // this thread's columns: cb + 8 c + q
#pragma unroll
      for (int c = 0; c < C::BN / 8; ++c) {
        const int col = cb + 8 * c;
        const float b0 = col < vocab ? __ldg(bias + col) : 0.0f;
        const float b1 = col + 1 < vocab ? __ldg(bias + col + 1) : 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          lo[4 * c + q] += q % 2 ? b1 : b0;
          hi[4 * c + q] += q % 2 ? b1 : b0;
        }
      }
      if (col0 + C::BN <= vocab) {
        fold_row<0, false>(st[0], lo, cb, vocab, lab[0]);
        fold_row<2, false>(st[1], lo, cb, vocab, lab[1]);
        fold_row<0, false>(st[2], hi, cb, vocab, lab[2]);
        fold_row<2, false>(st[3], hi, cb, vocab, lab[3]);
      } else {
        fold_row<0, true>(st[0], lo, cb, vocab, lab[0]);
        fold_row<2, true>(st[1], lo, cb, vocab, lab[1]);
        fold_row<0, true>(st[2], hi, cb, vocab, lab[2]);
        fold_row<2, true>(st[3], hi, cb, vocab, lab[3]);
      }
    }
    if (t + 2 >= per_run) {  // this consumer's last tile of the unit
      const int run = unit_of(j) / panels;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {  // the quad shares the row
          const Stat o{__shfl_xor_sync(0xffffffffu, st[i].m, off),
                       __shfl_xor_sync(0xffffffffu, st[i].s, off),
                       __shfl_xor_sync(0xffffffffu, st[i].sum, off),
                       __shfl_xor_sync(0xffffffffu, st[i].tgt, off)};
          merge(st[i], o);
        }
        const int row = row0 + r + (i % 2) * 8 + (i / 2) * 64;
        if (lane % 4 == 0 && row < rows)
          partial[static_cast<size_t>(2 * run + me) * rows + row] =
              make_float4(st[i].m, st[i].s, st[i].sum, st[i].tgt);
      }
    }
  }
}

// h (rows, hdim) and the table (vocab, hdim), f32, through their TMA maps;
// the vocabulary cut into runs of per_run 128-word tiles; unit u is run
// u / panels, panel u % panels; partial (runs, rows) float4.
__global__ void __launch_bounds__(tile::TF32Config::THREADS, 1)
vocab_f32_kernel_wgmma(const __grid_constant__ CUtensorMap map_h,
                       const __grid_constant__ CUtensorMap map_t, const float* __restrict__ bias,
                       const int* __restrict__ labels, float4* __restrict__ partial, int rows,
                       int vocab, int hdim, int runs, int per_run) {
  using C = tile::TF32Config;
  extern __shared__ unsigned char smem_raw[];
  const tile::TF32Ring ring = wg::setup<C>(smem_raw);
  const int panels = (rows + C::BM - 1) / C::BM;
  const int grid = gridDim.x;
  const int count = (panels * runs - blockIdx.x + grid - 1) / grid * per_run;  // the block's tiles
  const int ktiles = (hdim + C::BK - 1) / C::BK;
  // the block's j-th tile: tile j % per_run of its unit blockIdx.x + (j /
  // per_run) grid
  auto unit_of = [&](int j) { return blockIdx.x + j / per_run * grid; };
  auto tile_at = [&](int j) {
    const int u = unit_of(j);
    return make_int2(u % panels * C::BM, (u / panels * per_run + j % per_run) * C::BN);
  };

  if (threadIdx.x / 128 == 0) {
    wg::produce(ring, &map_h, &map_t, count, ktiles, tile_at);
    if (threadIdx.x >= 32) tile::tf32_split(ring, count * ktiles);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int me = threadIdx.x / 128 - 1;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int r = me * 64 + warp * 16 + lane / 4;  // this thread's rows: r, r + 8
  float sum[64];
  Stat st[2];
  int lab[2];
  for (int j = 0; j < count; ++j) {
    const int2 tile = tile_at(j);
    const int row0 = tile.x, col0 = tile.y, t = j % per_run;
    if (t == 0) {  // the unit's first tile
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + r + 8 * i;
        lab[i] = row < rows ? labels[row] : -1;
        st[i] = stat_init();
      }
    }
    tile::tf32_mainloop(ring, j, ktiles, me, sum);
    if (col0 < vocab) {  // else the tile lies wholly past the vocabulary
      const int cb = col0 + (lane % 4) * 2;  // this thread's columns: cb + 8 c + q
#pragma unroll
      for (int c = 0; c < C::BN / 8; ++c) {
        const int col = cb + 8 * c;
        const float b0 = col < vocab ? __ldg(bias + col) : 0.0f;
        const float b1 = col + 1 < vocab ? __ldg(bias + col + 1) : 0.0f;
#pragma unroll
        for (int q = 0; q < 4; ++q) sum[4 * c + q] += q % 2 ? b1 : b0;
      }
      if (col0 + C::BN <= vocab) {
        fold_row<0, false>(st[0], sum, cb, vocab, lab[0]);
        fold_row<2, false>(st[1], sum, cb, vocab, lab[1]);
      } else {
        fold_row<0, true>(st[0], sum, cb, vocab, lab[0]);
        fold_row<2, true>(st[1], sum, cb, vocab, lab[1]);
      }
    }
    if (t + 1 == per_run) {  // the unit's last tile
      const int run = unit_of(j) / panels;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {  // the quad shares the row
          const Stat o{__shfl_xor_sync(0xffffffffu, st[i].m, off),
                       __shfl_xor_sync(0xffffffffu, st[i].s, off),
                       __shfl_xor_sync(0xffffffffu, st[i].sum, off),
                       __shfl_xor_sync(0xffffffffu, st[i].tgt, off)};
          merge(st[i], o);
        }
        const int row = row0 + r + 8 * i;
        if (lane % 4 == 0 && row < rows)
          partial[static_cast<size_t>(run) * rows + row] =
              make_float4(st[i].m, st[i].s, st[i].sum, st[i].tgt);
      }
    }
  }
}

// The mma.sync route, any width and alignment: block u is unit u (run
// u / panels, panel u % panels); partial (runs, rows) float4.
__global__ void __launch_bounds__(tile::kF32Threads, 1)
vocab_f32_kernel(const float* __restrict__ h, const float* __restrict__ table,
                 const float* __restrict__ bias, const int* __restrict__ labels,
                 float4* __restrict__ partial, int rows, int vocab, int hdim, int per_run) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int panels = (rows + tile::kF32BM - 1) / tile::kF32BM;
  const int run = blockIdx.x / panels, row0 = (blockIdx.x % panels) * tile::kF32BM;
  const int vt0 = run * per_run;
  const int vt1 = min(vt0 + per_run, (vocab + tile::kF32BN - 1) / tile::kF32BN);
  // this thread's rows: row(i, hh) = row0 + wm * 64 + i * 16 + g + 8 hh
  Stat st[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) st[i][hh] = stat_init();
  for (int vt = vt0; vt < vt1; ++vt) {  // none where the run lies wholly past the vocabulary
    const int col0 = vt * tile::kF32BN;
    float acc[4][4][4];
    tile::f32_mainloop(h, table, rows, vocab, hdim, row0, col0, smem, acc);
    // this thread's 8 columns, acc[.][j][2 hh + e] at column 8 j + e, and
    // their bias
    int col[8];
    float b[8];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        col[2 * j + e] = col0 + wn * 32 + j * 8 + 2 * t + e;
        b[2 * j + e] = col[2 * j + e] < vocab ? __ldg(bias + col[2 * j + e]) : 0.0f;
      }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + wm * 64 + i * 16 + g + 8 * hh;
        float v[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) v[c] = acc[i][c / 2][2 * hh + c % 2] + b[c];
        fold(st[i][hh], v, col, vocab, row < rows ? __ldg(labels + row) : -1);
      }
  }
  // the run's end: the quad shares its rows (shuffles), then the four
  // column warps share theirs through shared memory, the stages' room
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const Stat o{__shfl_xor_sync(0xffffffffu, st[i][hh].m, off),
                     __shfl_xor_sync(0xffffffffu, st[i][hh].s, off),
                     __shfl_xor_sync(0xffffffffu, st[i][hh].sum, off),
                     __shfl_xor_sync(0xffffffffu, st[i][hh].tgt, off)};
        merge(st[i][hh], o);
      }
  Stat* red = reinterpret_cast<Stat*>(smem);  // [4 column warps][128 rows]
  __syncthreads();  // every warp is done with the main loop's stages
  if (t == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        red[wn * tile::kF32BM + wm * 64 + i * 16 + g + 8 * hh] = st[i][hh];
  __syncthreads();
  const int r = threadIdx.x;
  if (r < tile::kF32BM && row0 + r < rows) {
    Stat a = red[r];
    for (int c = 1; c < 4; ++c) merge(a, red[c * tile::kF32BM + r]);
    partial[static_cast<size_t>(run) * rows + row0 + r] = make_float4(a.m, a.s, a.sum, a.tgt);
  }
}

__global__ void vocab_merge_kernel(const float4* __restrict__ partial, float* __restrict__ lse,
                                   float* __restrict__ sumlog, float* __restrict__ tgt, int rows,
                                   int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  float4 p = partial[row];
  Stat a{p.x, p.y, p.z, p.w};
  for (int sp = 1; sp < splits; ++sp) {
    p = partial[static_cast<size_t>(sp) * rows + row];
    merge(a, Stat{p.x, p.y, p.z, p.w});
  }
  lse[row] = a.m + logf(a.s);
  sumlog[row] = a.sum;
  tgt[row] = a.tgt;
}

}  // namespace

// h (rows, hdim), table (vocab, hdim): bf16 (dtype 1: hdim % 8 == 0, h and
// table 16-byte aligned) or f32 (dtype 0); bias (vocab,) f32; labels (rows,)
// i32; lse, sumlog, tgt (rows,) f32. The vocabulary tiles of 128 words are
// cut into `splits` runs of `tiles_per_split` (even for bf16); partial is f32
// scratch of (parts, rows, 4), parts = 2 splits for bf16 (one per run and
// consumer) and splits for f32 (one per run). f32 takes the TMA route where
// hdim % 4 == 0 and h and the table are 16-byte aligned
// (ops/cuda_lib.py::f32_tma_route mirrors this), the mma.sync route
// elsewhere. Returns cudaGetLastError() after the two launches.
extern "C" int bq_vocab_reductions(const void* h, const void* table, const float* bias,
                                   const int* labels, float* partial, float* lse, float* sumlog,
                                   float* tgt, int rows, int vocab, int hdim, int splits,
                                   int tiles_per_split, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* part = reinterpret_cast<float4*>(partial);
  int parts = splits;
  if (dtype == 1) {
    using C = wg::Config;
    if (hdim % 8 || tiles_per_split % 2 ||
        (reinterpret_cast<size_t>(h) | reinterpret_cast<size_t>(table)) % 16)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = set_smem_once(reinterpret_cast<const void*>(vocab_wgmma_kernel),
                                    C::SMEM_BYTES);
    int dev = 0, sms = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    CUtensorMap map_h, map_t;
    if (err == cudaSuccess) err = wg::make_map(&map_h, h, rows, hdim, C::BM);
    if (err == cudaSuccess) err = wg::make_map(&map_t, table, vocab, hdim, C::BN);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int units = (rows + C::BM - 1) / C::BM * splits;
    vocab_wgmma_kernel<<<units < sms ? units : sms, C::THREADS, C::SMEM_BYTES, s>>>(
        map_h, map_t, bias, labels, part, rows, vocab, hdim, splits, tiles_per_split);
    parts = 2 * splits;
  } else if (hdim > 0 && hdim % 4 == 0 &&
             (reinterpret_cast<size_t>(h) | reinterpret_cast<size_t>(table)) % 16 == 0) {
    using C = tile::TF32Config;
    cudaError_t err = set_smem_once(reinterpret_cast<const void*>(vocab_f32_kernel_wgmma),
                                    C::SMEM_BYTES);
    int dev = 0, sms = 0;
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    CUtensorMap map_h, map_t;
    if (err == cudaSuccess) err = wg::make_map(&map_h, h, rows, hdim, C::BM, true);
    if (err == cudaSuccess) err = wg::make_map(&map_t, table, vocab, hdim, C::BN, true);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int units = (rows + C::BM - 1) / C::BM * splits;
    vocab_f32_kernel_wgmma<<<units < sms ? units : sms, C::THREADS, C::SMEM_BYTES, s>>>(
        map_h, map_t, bias, labels, part, rows, vocab, hdim, splits, tiles_per_split);
  } else {
    const int units = (rows + tile::kF32BM - 1) / tile::kF32BM * splits;
    const cudaError_t err =
        set_smem_once(reinterpret_cast<const void*>(vocab_f32_kernel), tile::kF32SmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    vocab_f32_kernel<<<units, tile::kF32Threads, tile::kF32SmemBytes, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(table), bias, labels, part, rows,
        vocab, hdim, tiles_per_split);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  vocab_merge_kernel<<<(rows + 255) / 256, 256, 0, s>>>(part, lse, sumlog, tgt, rows, parts);
  return static_cast<int>(cudaGetLastError());
}
