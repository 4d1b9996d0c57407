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
// What the design does about it: a block owns 128 rows and walks a run of
// 128-word vocabulary tiles; each tile's logits come from the scoring GEMM's
// main loop (tile_gemm.cuh: mma.sync, cp.async ring) and stay in registers,
// where every thread folds its 8 columns of each of its 8 rows into a running
// (max, sum of exp, sum of logits, target logit), the flash-attention
// rescaling applied to logsumexp. At the end the 16 threads that share a row
// merge through shared memory. The vocabulary is cut into `splits` runs so
// that 176 row blocks still fill 132 SMs; a second, O(rows) kernel merges
// the runs and takes the log.

#include "tile_gemm.cuh"

namespace {

using tile::bf16;

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

using Tile = tile::ScoringTile;

__global__ void __launch_bounds__(Tile::THREADS)
vocab_bf16_kernel(const bf16* __restrict__ h, const bf16* __restrict__ table,
                  const float* __restrict__ bias, const int* __restrict__ labels,
                  float4* __restrict__ partial, int rows, int vocab, int hdim,
                  int tiles_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kRows = Tile::MT * 2, kCols = Tile::NT * 2;  // a thread's rows and columns
  const int row0 = blockIdx.x * Tile::BM;
  const int vtiles = (vocab + Tile::BN - 1) / Tile::BN;
  const int vt0 = blockIdx.y * tiles_per_split;
  const int vt1 = min(vt0 + tiles_per_split, vtiles);
  Stat st[kRows];
  int lab[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = row0 + Tile::row(i / 2, i % 2);
    st[i] = stat_init();
    lab[i] = row < rows ? labels[row] : -1;
  }
  for (int vt = vt0; vt < vt1; ++vt) {
    const int col0 = vt * Tile::BN;
    float acc[Tile::MT][Tile::NT][4];
    tile::mma_tile<Tile>(h, table, rows, vocab, hdim, row0, col0,
                         reinterpret_cast<bf16*>(smem_raw), acc);
    int col[kCols];
    float b[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      col[j] = col0 + Tile::col(j / 2, j % 2);
      b[j] = col[j] < vocab ? bias[col[j]] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float v[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) v[j] = acc[i / 2][j / 2][2 * (i % 2) + j % 2] + b[j];
      fold(st[i], v, col, vocab, lab[i]);
    }
  }
  // the tile loop ended on a barrier: shared memory is free for the merge
  Stat* red = reinterpret_cast<Stat*>(smem_raw);  // [BM][column groups]
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    red[Tile::row(i / 2, i % 2) * Tile::COL_GROUPS + Tile::col_group()] = st[i];
  __syncthreads();
  if (threadIdx.x < Tile::BM && row0 + static_cast<int>(threadIdx.x) < rows) {
    Stat a = red[threadIdx.x * Tile::COL_GROUPS];
    for (int g = 1; g < Tile::COL_GROUPS; ++g) merge(a, red[threadIdx.x * Tile::COL_GROUPS + g]);
    partial[static_cast<size_t>(blockIdx.y) * rows + row0 + threadIdx.x] =
        make_float4(a.m, a.s, a.sum, a.tgt);
  }
}

__global__ void __launch_bounds__(tile::kSimtThreads)
vocab_f32_kernel(const float* __restrict__ h, const float* __restrict__ table,
                 const float* __restrict__ bias, const int* __restrict__ labels,
                 float4* __restrict__ partial, int rows, int vocab, int hdim,
                 int tiles_per_split) {
  __shared__ float smem[tile::kSimtSmemFloats];
  __shared__ Stat red[tile::kSimtBM * tile::kSimtColGroups];
  const int row0 = blockIdx.x * tile::kSimtBM;
  const int vtiles = (vocab + tile::kSimtBN - 1) / tile::kSimtBN;
  const int vt0 = blockIdx.y * tiles_per_split;
  const int vt1 = min(vt0 + tiles_per_split, vtiles);
  Stat st[4];
  int lab[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + tile::simt_row(i);
    st[i] = stat_init();
    lab[i] = row < rows ? labels[row] : -1;
  }
  for (int vt = vt0; vt < vt1; ++vt) {
    const int col0 = vt * tile::kSimtBN;
    float acc[4][4];
    tile::simt_tile(h, table, rows, vocab, hdim, row0, col0, smem, acc);
    int col[4];
    float b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      col[j] = col0 + tile::simt_col(j);
      b[j] = col[j] < vocab ? bias[col[j]] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = acc[i][j] + b[j];
      fold(st[i], v, col, vocab, lab[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    red[tile::simt_row(i) * tile::kSimtColGroups + tile::simt_col_group()] = st[i];
  __syncthreads();
  if (threadIdx.x < tile::kSimtBM && row0 + static_cast<int>(threadIdx.x) < rows) {
    Stat a = red[threadIdx.x * tile::kSimtColGroups];
    for (int g = 1; g < tile::kSimtColGroups; ++g)
      merge(a, red[threadIdx.x * tile::kSimtColGroups + g]);
    partial[static_cast<size_t>(blockIdx.y) * rows + row0 + threadIdx.x] =
        make_float4(a.m, a.s, a.sum, a.tgt);
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

// h (rows, hdim), table (vocab, hdim): bf16 (dtype 1, hdim % 8 == 0) or f32
// (dtype 0); bias (vocab,) f32; labels (rows,) i32; partial (splits, rows, 4)
// f32 scratch; lse, sumlog, tgt (rows,) f32. The vocabulary tiles (128 words
// for bf16, 64 for f32) are cut into `splits` runs of `tiles_per_split`.
// Returns cudaGetLastError() after the two launches.
extern "C" int bq_vocab_reductions(const void* h, const void* table, const float* bias,
                                   const int* labels, float* partial, float* lse, float* sumlog,
                                   float* tgt, int rows, int vocab, int hdim, int splits,
                                   int tiles_per_split, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* part = reinterpret_cast<float4*>(partial);
  if (dtype == 1) {
    if (hdim % 8) return static_cast<int>(cudaErrorInvalidValue);
    // the attribute is per device: set it before every launch
    const cudaError_t err = cudaFuncSetAttribute(
        vocab_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((rows + Tile::BM - 1) / Tile::BM, splits);
    vocab_bf16_kernel<<<grid, Tile::THREADS, Tile::SMEM_BYTES, s>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(table), bias, labels, part, rows,
        vocab, hdim, tiles_per_split);
  } else {
    const dim3 grid((rows + tile::kSimtBM - 1) / tile::kSimtBM, splits);
    vocab_f32_kernel<<<grid, tile::kSimtThreads, 0, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(table), bias, labels, part, rows,
        vocab, hdim, tiles_per_split);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  vocab_merge_kernel<<<(rows + 255) / 256, 256, 0, s>>>(part, lse, sumlog, tgt, rows, splits);
  return static_cast<int>(cudaGetLastError());
}
