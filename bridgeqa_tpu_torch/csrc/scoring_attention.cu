// The two attentions of the fused scoring decoder layer, for Hopper (sm_90a).
//
// Replaces the attention inside the Pallas kernel
// bridgeqa_tpu/ops/scoring_layer.py::_layer_kernel, in two modes:
//   - self (mode 0): causal attention inside each answer sequence of `la`
//     rows. The TPU kernel computes a whole (R, R) block of scores under a
//     block-diagonal causal bias of -1e9; the masked scores contribute
//     exactly 0 to the max and the sums, so only each row's own prefix is
//     computed here.
//   - grouped cross (mode 1): every row of question q attends to q's
//     pre-projected keys and values (lk rows) with q's additive f32 bias
//     (0, or -1e9 at question padding).
// Numerics as the TPU kernel's `attend`: f32 scores of working-type inputs,
// s * scale + bias, e = exp(s - max), e rounded to the working type before
// the product with V, the f32 context divided by the f32 sum of the
// unrounded e, one rounding at the end.
//
// What bounds it on this card: memory. At the main-path shapes (24576
// rows, 12 heads of 64) one self pass reads the (24576, 2304) bf16 QKV
// block and writes the (24576, 768) context: 151 MB, 45 us at 3.35 TB/s, for
// 0.9 GFLOP. One cross pass reads (24576, 768) queries and writes a context
// of the same size, plus 2 MB of keys and values: 23 us, for 6 GFLOP. Both
// are far below the tensor cores' rate; what counts is that every byte
// comes from DRAM once, in long runs, with loads in flight all the time.
//
// What the design does about it (bf16, head width 64, a key window of at
// most 128: the main path's answers of 12 tokens and questions of 80):
//   - a persistent grid of as many blocks as the card holds at once (the
//     occupancy query; built for two an SM where two stages fit in half of
//     its shared memory and the window is at most 80 keys, as in both
//     main-path modes, else one) walks units of (segment of row tiles,
//     head), head fastest, so the blocks in flight hold every head of a few
//     segments and read each row's 12 slices close together in time (the
//     schedule below). The C entry reports the launch it made;
//   - one producer warp keeps a ring of 2-4 stages full through TMA
//     (cp.async.bulk.tensor under the 128-byte swizzle, mbarrier
//     completion): a self stage is one tile's Q, K and V for one head, a
//     cross stage one 128-row tile of Q. The next tiles' loads are in
//     flight while eight consumer warps compute;
//   - cross: a unit's question's keys and values for its head come in once,
//     into one of two buffers of their own (the next unit's load overlaps),
//     and the unit's row tiles stream past them;
//   - each consumer warp takes 16 rows of the tile on mma.sync: the products
//     are small (the accumulator layout of S is mma.sync's A layout of P,
//     so P stays in registers), and at 16 rows a warp the window's keys
//     need no cross-warp exchange. It writes its rounded context back into
//     its own Q rows of the stage and stores them as one TMA box (whole
//     128-byte rows; a tile's ragged last rows go out 16 bytes a lane).
//   - scores are taken in the log2 domain (one FFMA with scale * log2 e,
//     and the bias times log2 e) and e = ex2.approx(x - max), 1 / sum once
//     a row: a few f32 ulps from expf and a division, as the ViT attention.
// The consumers' math, not the memory, sets the pace at the main path's
// shapes (clock stamps of a block's warps: they seldom wait on a stage);
// PERF.md has the times against the bound.
// f32 at head width 64 (the drivers' default f32 predict and eval), both
// modes, runs on the tensor cores in 3xTF32 (scoring_attention_f32_kernel
// below; its body and numerics in attention_f32.cuh, the f32 ViT
// attention's too): a persistent grid over the pipeline's units of (segment
// of row tiles, head), 8 warps of 16 rows, two blocks an SM, cp.async loads.
// Cross (at most 128 question keys): a unit's question's keys, values and
// bias for its head come in once, whole; then each warp loads its own 16
// query rows a tile, so no block barrier falls between a unit's tiles and
// the other warps' products cover a warp's load. Self (any answer of at most
// 128 rows): the block loads a tile's Q, K and V for its head, and each warp
// attends over its window (the start of its first row's answer to its last
// row, at most la + 15 keys) in 64-key steps; keys outside a row's answer or
// after the row weigh exactly 0. At the main path's shapes self is bound by
// bytes (the 226 MB QKV block read once, 75 MB written: 0.09 ms a call) and
// cross by its products (6.0 GFLOP a call, ~21 GFLOP in TF32 passes); with
// two blocks an SM one block's loads are in flight while the other computes.
// Other head widths, bf16 windows past 128 keys and f32 questions past 128
// keys run on the CUDA cores (attention_kernel below): rows padded by two
// elements so that a lane per key reads without bank conflicts, one warp per
// query row, a lane per key for the scores, the max and the sum by warp
// shuffles, then a lane per pair of head dimensions for the product with V,
// one block per (tile, head).

#include "attention_f32.cuh"
#include "smem_attribute.cuh"
#include "tile_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kTileRows = 128;

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
  __device__ static float2 load(const float* p) { return *reinterpret_cast<const float2*>(p); }
  __device__ static float lo(float2 v) { return v.x; }
  __device__ static float hi(float2 v) { return v.y; }
  __device__ static void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  __device__ static float round(float v) { return v; }
};
template <>
struct Pair<bf16> {
  using type = __nv_bfloat162;
  __device__ static __nv_bfloat162 load(const bf16* p) {
    return *reinterpret_cast<const __nv_bfloat162*>(p);
  }
  __device__ static float lo(__nv_bfloat162 v) { return __low2float(v); }
  __device__ static float hi(__nv_bfloat162 v) { return __high2float(v); }
  __device__ static void store(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  __device__ static float round(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q rows have stride q_stride, k/v rows kv_stride, out rows out_stride (in
// elements); head h's slice starts at h * hd in each. Self mode: k and v are
// the rows of q's own block (QKV columns H and 2H); cross mode: k, v are
// (nq, lk, *) and bias (nq, lk).
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, T* __restrict__ out, int rows, int hd,
                 int q_stride, int kv_stride, int out_stride, int la, int rows_per_q, int lk,
                 int mode, int tiles_per_q, float scale) {
  using P = Pair<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = hd + 2;  // padded key/value row, elements
  const int max_keys = mode == 0 ? kTileRows : lk;
  T* sk = reinterpret_cast<T*>(smem_raw);
  T* sv = sk + max_keys * ld;
  float* scratch = reinterpret_cast<float*>(sv + max_keys * ld);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* sq = scratch + warp * (hd + max_keys);  // this warp's query row, f32
  float* sp = sq + hd;                           // this warp's scores, then rounded e
  const int head = blockIdx.y;

  int r0, nrows, key0, nkeys;
  const float* kbias = nullptr;
  if (mode == 0) {
    const int tile_rows = (kTileRows / la) * la;
    r0 = blockIdx.x * tile_rows;
    nrows = min(tile_rows, rows - r0);
    key0 = r0;
    nkeys = nrows;
  } else {
    const int question = blockIdx.x / tiles_per_q;
    const int t = blockIdx.x % tiles_per_q;
    r0 = question * rows_per_q + t * kTileRows;
    nrows = min(kTileRows, rows_per_q - t * kTileRows);
    key0 = question * lk;
    nkeys = lk;
    kbias = bias + static_cast<size_t>(question) * lk;
  }
  if (nrows <= 0) return;

  const int half = hd / 2;
  for (int e = threadIdx.x; e < nkeys * half; e += kWarps * 32) {
    const int j = e / half, d = 2 * (e % half);
    const size_t g = static_cast<size_t>(key0 + j) * kv_stride + head * hd + d;
    *reinterpret_cast<typename P::type*>(sk + j * ld + d) = P::load(k + g);
    *reinterpret_cast<typename P::type*>(sv + j * ld + d) = P::load(v + g);
  }
  __syncthreads();

  for (int r = warp; r < nrows; r += kWarps) {
    const int row = r0 + r;
    const T* qrow = q + static_cast<size_t>(row) * q_stride + head * hd;
    for (int d = 2 * lane; d < hd; d += 64) {
      const typename P::type pair = P::load(qrow + d);
      sq[d] = P::lo(pair);
      sq[d + 1] = P::hi(pair);
    }
    __syncwarp();
    // keys [lo, hi) of the shared-memory block
    const int lo = mode == 0 ? (row / la) * la - r0 : 0;
    const int hi = mode == 0 ? r + 1 : nkeys;

    float mx = -3.0e38f;  // below any score, masked ones included
    for (int j = lo + lane; j < hi; j += 32) {
      const T* kr = sk + j * ld;
      float s = 0.0f;
      for (int d = 0; d < hd; d += 2) {
        const typename P::type pair = P::load(kr + d);
        s += sq[d] * P::lo(pair);
        s += sq[d + 1] * P::hi(pair);
      }
      s = s * scale + (kbias ? kbias[j] : 0.0f);
      sp[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float denom = 0.0f;
    for (int j = lo + lane; j < hi; j += 32) {
      const float e = expf(sp[j] - mx);
      denom += e;
      sp[j] = P::round(e);
    }
    denom = warp_sum(denom);
    __syncwarp();

    T* orow = out + static_cast<size_t>(row) * out_stride + head * hd;
    for (int d = 2 * lane; d < hd; d += 64) {
      float a0 = 0.0f, a1 = 0.0f;
      for (int j = lo; j < hi; ++j) {
        const typename P::type pair = P::load(sv + j * ld + d);
        a0 += sp[j] * P::lo(pair);
        a1 += sp[j] * P::hi(pair);
      }
      P::store(orow + d, a0 / denom, a1 / denom);
    }
    __syncwarp();  // sq and sp are rewritten for the next row
  }
}

// ------------------------------------------------- the tensor-core pipeline
//
// Both attentions in bf16 at head width 64 (the main path's): a persistent,
// warp-specialised kernel fed by TMA. See the note at the top of the file.
constexpr int kHd = 64;
constexpr int kRow = kHd * 2;     // bytes of one row of one head: a 128-byte swizzled row
constexpr int kConsumers = 8;     // consumer warps, 16 rows of a 128-row tile each
constexpr int kPipeThreads = (kConsumers + 1) * 32;  // and one producer warp

constexpr int clamp_int(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }
constexpr int kHalfSmem = 110 * 1024;  // a block's share where two share an SM

// Shared memory of one block, for KCH chunks of 16 keys. A self stage holds
// a tile's Q, K and V for one head (K and V with the slack the last warp's
// window needs: it starts at most 16 rows before that warp's first row); a
// cross stage holds Q, and the question's K, V and bias (times log2 e,
// padded to the window with -3e38) sit in two buffers of their own, filled
// once per unit. A block takes two blocks' share of an SM (96 registers a
// thread) where two stages fit and the window is at most 80 keys: the main
// path's answers of 12 and questions of 80.
template <int KCH, bool SELF>
struct Pipe {
  static constexpr int KEY_ROWS = SELF ? kTileRows - 16 + 16 * KCH : 16 * KCH;
  static constexpr int Q_BYTES = kTileRows * kRow;
  static constexpr int KV_BYTES = KEY_ROWS * kRow;  // K or V
  static constexpr int STAGE_BYTES = SELF ? Q_BYTES + 2 * KV_BYTES : Q_BYTES;
  static constexpr int FIXED = SELF ? 0 : 2 * (2 * KV_BYTES + 4 * KEY_ROWS);
  // 1024 bytes of slack to align the stages (the swizzle's period), and the
  // barriers: full and empty for each of up to 4 stages, full and empty
  // for each K/V buffer
  static constexpr int EXTRA = 1024 + 8 * (2 * 4 + 4);
  static constexpr int MIN_BLOCKS = KCH <= 5 && EXTRA + 2 * STAGE_BYTES + FIXED <= kHalfSmem ? 2 : 1;
  static constexpr int BUDGET = MIN_BLOCKS == 2 ? kHalfSmem : 220 * 1024;
  static constexpr int STAGES = clamp_int((BUDGET - EXTRA - FIXED) / STAGE_BYTES, 2, 4);
  static constexpr int SMEM = EXTRA + STAGES * STAGE_BYTES + FIXED;
  static_assert(SMEM <= 232448, "shared memory of a block");
  static_assert(MIN_BLOCKS == 1 || 2 * (SMEM + 1024) <= 233472, "two blocks an SM");
};

// The schedule. Rows are cut into tiles (self: whole answers, at most 128
// rows; cross: 128 rows inside one question), a question's tiles into
// segments of `seg` tiles, and a unit is (segment, head), head fastest: unit
// u is head u % heads of segment u / heads. Block b of the persistent grid
// takes units b, b + grid, ...: the blocks in flight hold every head of a
// few segments and walk their rows in step. Self mode is one "question" of
// all rows.
struct Sched {
  const float* bias;
  bf16* out;
  int heads, tile_rows, rows_per_q, tiles_per_q, seg, segs_per_q, units, grid;
  int la, lk, koff, voff, out_stride;
  float scale_log2;  // scale * log2 e
};

struct Span {
  int head, question, t0, t1;  // tiles [t0, t1) of the question
};

__host__ __device__ __forceinline__ Span unit_span(const Sched& sc, int u) {
  const int s = u / sc.heads;
  Span r;
  r.head = u % sc.heads;
  r.question = s / sc.segs_per_q;
  r.t0 = (s % sc.segs_per_q) * sc.seg;
  r.t1 = r.t0 + sc.seg < sc.tiles_per_q ? r.t0 + sc.seg : sc.tiles_per_q;
  return r;
}

// Fill the schedule's shape fields for `cap` co-resident blocks: the
// segment length that gives the busiest block the fewest tiles, the longer
// one on a tie (fewer units: a cross unit loads its question's K and V).
inline void schedule(Sched& sc, bool self, int rows, int heads, int la, int rows_per_q, int cap) {
  sc.heads = heads;
  sc.tile_rows = self ? (kTileRows / la) * la : kTileRows;
  sc.rows_per_q = self ? rows : rows_per_q;
  const int nq = rows / sc.rows_per_q;
  sc.tiles_per_q = (sc.rows_per_q + sc.tile_rows - 1) / sc.tile_rows;
  long long best = -1;
  for (int seg = 1; seg <= sc.tiles_per_q; ++seg) {
    const int segs = (sc.tiles_per_q + seg - 1) / seg;
    const long long units = static_cast<long long>(nq) * segs * heads;
    const long long grid = units < cap ? units : cap;
    const long long cost = (units + grid - 1) / grid * seg;
    if (best < 0 || cost <= best) {
      best = cost;
      sc.seg = seg;
      sc.segs_per_q = segs;
      sc.units = static_cast<int>(units);
      sc.grid = static_cast<int>(grid);
    }
  }
}

// the address of 16-byte chunk `chunk` of row `row` in a region of 128-byte
// rows under TMA's 128-byte swizzle (the region 1024-aligned)
__device__ __forceinline__ uint32_t swz(uint32_t region, int row, int chunk) {
  return region + row * kRow + ((chunk ^ (row & 7)) << 4);
}

// One warp's 16 rows of one tile and head, on mma.sync. sq, sk, sv: the
// stage's Q rows and the K and V rows (shared-memory row 0 = the tile's
// first row in self mode, the question's first key in cross mode); sb: the
// question's bias times log2 e, padded (cross). Scores are taken in the
// log2 domain, x = s * scale * log2 e + bias * log2 e in one FFMA, and
// e = 2^(x - max) (ex2.approx): a few f32 ulps from exp(s * scale + bias -
// max), as in the ViT attention. The context goes back into the warp's own
// Q rows (which only this warp reads), then out as whole 128-byte rows.
template <int KCH, bool SELF>
__device__ __forceinline__ void attend_rows(const Sched& sc, uint32_t sq, uint32_t sk, uint32_t sv,
                                            uint32_t sb, int r0, int nrows, int head,
                                            const CUtensorMap* map_o) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int la = sc.la;
  // the window: key rows [ks, ks + 16 * KCH)
  const int ks = SELF ? ((r0 + warp * 16) / la) * la - r0 : 0;

  // S = Q K^T: (16 rows) x (16 * KCH keys), 2 * KCH n8 tiles
  float s[2 * KCH][4];
#pragma unroll
  for (int j = 0; j < 2 * KCH; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kHd / 8; kk += 2) {
    unsigned a[4];
    tile::ldmatrix_x4(a, swz(sq, warp * 16 + (lane & 15), kk + (lane >> 4)));
#pragma unroll
    for (int np = 0; np < KCH; ++np) {
      unsigned b[4];
      tile::ldmatrix_x4(b,
                        swz(sk, ks + np * 16 + (lane & 7) + (lane >> 4) * 8, kk + ((lane >> 3) & 1)));
      tile::mma_bf16(s[2 * np], a, b[0], b[1]);
      tile::mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }

  // scale and bias, or the causal mask; the max and the sum of each of this
  // thread's two rows
  int row[2], first[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = warp * 16 + g + 8 * h;                          // in the tile
    first[h] = SELF ? ((r0 + row[h]) / la) * la - r0 : 0;    // its answer's first key
  }
  float mx[2] = {-3.0e38f, -3.0e38f};
#pragma unroll
  for (int j = 0; j < 2 * KCH; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = ks + j * 8 + 2 * t + e;  // shared-memory key row
      float kbv = 0.0f;
      if (!SELF) asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(kbv) : "r"(sb + 4 * key));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& x = s[j][2 * h + e];
        if (SELF)  // keys outside the row's answer prefix take no part
          x = key >= first[h] && key <= row[h] ? x * sc.scale_log2 : -3.0e38f;
        else  // padding keys carry -3e38, which leaves x at -3e38
          x = fmaf(x, sc.scale_log2, kbv);
        mx[h] = fmaxf(mx[h], x);
      }
    }
  float denom[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
  unsigned p[KCH][4];
#pragma unroll
  for (int j = 0; j < 2 * KCH; ++j) {
    float e[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      e[c] = tile::ex2(s[j][c] - mx[c >> 1]);
      denom[c >> 1] += e[c];
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(e[0], e[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(e[2], e[3]);
    p[j >> 1][(j & 1) * 2] = *reinterpret_cast<const unsigned*>(&lo);
    p[j >> 1][(j & 1) * 2 + 1] = *reinterpret_cast<const unsigned*>(&hi);
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    denom[h] += __shfl_xor_sync(0xffffffffu, denom[h], 1);
    denom[h] += __shfl_xor_sync(0xffffffffu, denom[h], 2);
    inv[h] = 1.0f / denom[h];
  }

  // O = P V: (16 rows) x (64 dims) in two halves of 32 (4 n8 tiles each,
  // fewer live registers), each rounded into the warp's own Q rows as it
  // is done (row r's dims 8 j + 2 t, + 1 go to chunk j of the row:
  // conflict-free, the 8 rows of a column hit 8 chunks)
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float o[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[j][c] = 0.0f;
#pragma unroll
    for (int c = 0; c < KCH; ++c)
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        unsigned b[4];
        tile::ldmatrix_x4_trans(b, swz(sv, ks + c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                             half * 4 + dp * 2 + (lane >> 4)));
        tile::mma_bf16(o[2 * dp], p[c], b[0], b[1]);
        tile::mma_bf16(o[2 * dp + 1], p[c], b[2], b[3]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 v2 = __floats2bfloat162_rn(o[j][2 * h] * inv[h], o[j][2 * h + 1] * inv[h]);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(swz(sq, row[h], half * 4 + j) + 4 * t),
                     "r"(*reinterpret_cast<const unsigned*>(&v2))
                     : "memory");
      }
  }
  __syncwarp();
  // ... and out: the warp's 16 rows as one TMA box where all of them are
  // the tile's, else as whole rows, 8 lanes a row, 16 bytes each
  if (warp * 16 + 16 <= nrows) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the TMA unit
    __syncwarp();
    if (lane == 0) {
      wg::tma_store_2d(map_o, sq + warp * 16 * kRow, head * kHd, r0 + warp * 16);
      wg::bulk_commit();
      wg::bulk_wait_read();  // the stage is reloaded once the store has read it
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = warp * 16 + i * 4 + (lane >> 3), c = lane & 7;
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(swz(sq, r, c))
                 : "memory");
    if (r < nrows)
      *reinterpret_cast<uint4*>(sc.out + static_cast<size_t>(r0 + r) * sc.out_stride +
                                head * kHd + c * 8) = v;
  }
}

template <int KCH, bool SELF>
__global__ void __launch_bounds__(kPipeThreads, Pipe<KCH, SELF>::MIN_BLOCKS)
attention_pipe_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_o, const Sched sc) {
  using P = Pipe<KCH, SELF>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (wg::smem_u32(smem_raw) + 1023u) & ~1023u;
  // cross: K and V of buffer b at kv(b), its bias at bias(b)
  const uint32_t kv0 = base + P::STAGES * P::STAGE_BYTES;
  auto kv = [&](int b) { return kv0 + b * 2 * P::KV_BYTES; };
  auto bias = [&](int b) { return kv0 + 4 * P::KV_BYTES + b * 4 * P::KEY_ROWS; };
  const uint32_t bars = kv0 + P::FIXED;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (P::STAGES + s); };
  auto kv_full = [&](int b) { return bars + 8u * (2 * P::STAGES + b); };
  auto kv_empty = [&](int b) { return bars + 8u * (2 * P::STAGES + 2 + b); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // zero the stages and buffers once: the rows no TMA box writes (past a
  // self tile's answers, past the question's keys, a window's slack) must
  // hold finite values, since a masked key's weight is 0 and 0 * NaN is not
  for (uint32_t i = threadIdx.x; i < (P::STAGES * P::STAGE_BYTES + P::FIXED) / 16u;
       i += kPipeThreads)
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(base + 16u * i), "r"(0)
                 : "memory");
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      wg::mbar_init(full(s), 1);
      wg::mbar_init(empty(s), kConsumers);
    }
    for (int b = 0; b < 2; ++b) {
      wg::mbar_init(kv_full(b), 1);
      wg::mbar_init(kv_empty(b), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the zeros, before any TMA write
  __syncthreads();

  if (warp == kConsumers) {  // the producer warp: lane 0 issues every load
    if (lane == 0) {
      wg::tma_prefetch(&map_q);
      if (!SELF) {
        wg::tma_prefetch(&map_k);
        wg::tma_prefetch(&map_v);
      }
    }
    int stage = 0, phase = 0, n = 0;
    for (int u = blockIdx.x; u < sc.units; u += gridDim.x, ++n) {
      const Span us = unit_span(sc, u);
      const int col = us.head * kHd;
      if (!SELF) {  // the question's K and V by TMA, its bias by the warp's lanes
        const int b = n & 1;
        wg::mbar_wait(kv_empty(b), ((n >> 1) & 1) ^ 1);
        const float* qb = sc.bias + static_cast<size_t>(us.question) * sc.lk;
        for (int j = lane; j < P::KEY_ROWS; j += 32) {
          const float v = j < sc.lk ? __ldg(qb + j) * 1.4426950408889634f : -3.0e38f;
          asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(bias(b) + 4 * j), "f"(v) : "memory");
        }
        __syncwarp();  // lane 0's arrive below releases the lanes' stores
        if (lane == 0) {
          wg::mbar_expect_tx(kv_full(b), 2 * sc.lk * kRow);
          wg::tma_load_2d(kv(b), &map_k, kv_full(b), col, us.question * sc.lk);
          wg::tma_load_2d(kv(b) + P::KV_BYTES, &map_v, kv_full(b), col, us.question * sc.lk);
        }
      }
      for (int t = us.t0; t < us.t1; ++t) {
        if (lane == 0) {
          const int r0 = us.question * sc.rows_per_q + t * sc.tile_rows;
          wg::mbar_wait(empty(stage), phase ^ 1);
          const uint32_t s = base + stage * P::STAGE_BYTES;
          if (SELF) {
            wg::mbar_expect_tx(full(stage), 3 * sc.tile_rows * kRow);
            wg::tma_load_2d(s, &map_q, full(stage), col, r0);
            wg::tma_load_2d(s + P::Q_BYTES, &map_q, full(stage), sc.koff + col, r0);
            wg::tma_load_2d(s + P::Q_BYTES + P::KV_BYTES, &map_q, full(stage), sc.voff + col, r0);
          } else {
            wg::mbar_expect_tx(full(stage), P::Q_BYTES);
            wg::tma_load_2d(s, &map_q, full(stage), col, r0);
          }
        }
        if (++stage == P::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  int stage = 0, phase = 0, n = 0;
  for (int u = blockIdx.x; u < sc.units; u += gridDim.x, ++n) {
    const Span us = unit_span(sc, u);
    uint32_t sk = 0, sv = 0;
    if (!SELF) {
      wg::mbar_wait(kv_full(n & 1), (n >> 1) & 1);
      sk = kv(n & 1);
      sv = sk + P::KV_BYTES;
    }
    for (int t = us.t0; t < us.t1; ++t) {
      const int r0 = us.question * sc.rows_per_q + t * sc.tile_rows;
      const int nrows = min(sc.tile_rows, sc.rows_per_q - t * sc.tile_rows);
      wg::mbar_wait(full(stage), phase);
      const uint32_t sq = base + stage * P::STAGE_BYTES;
      if (SELF) {
        sk = sq + P::Q_BYTES;
        sv = sk + P::KV_BYTES;
      }
      if (warp * 16 < nrows)
        attend_rows<KCH, SELF>(sc, sq, sk, sv, bias(n & 1), r0, nrows, us.head, &map_o);
      // the context was written through the generic proxy; the next TMA
      // load into this stage must come after it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(empty(stage));
      if (++stage == P::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (!SELF) {
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(kv_empty(n & 1));
    }
  }
  if (lane == 0) wg::bulk_wait();  // the context's last TMA stores are done
}

// ------------------------------------------------- the f32 tensor-core kernel
//
// Both attentions in f32 at head width 64 (the drivers' default f32 predict
// and eval): 3xTF32 on mma.sync through attention_f32.cuh's body. See the
// note at the top of the file.
using attn32::kQPitch;
using attn32::kVPitch;
constexpr int kF32Threads = kConsumers * 32;  // 8 warps of 16 rows of a 128-row tile
// key rows of a block's K and V: self, a tile's rows and the slack of its
// last window's last chunk; cross, a question's lk <= 128 keys rounded up to
// a chunk
constexpr int kF32SelfKeys = kTileRows + 8;
constexpr int kF32CrossKeys = kTileRows;
static_assert(kHd == attn32::kHd && kConsumers * 16 == kTileRows, "8 warps of 16 rows of 64");

// dynamic shared memory of a block with `keys` key rows: Q, K, V and (cross)
// the keys' bias
__host__ __device__ constexpr int f32_smem(bool self, int keys) {
  return (kTileRows * kQPitch + keys * (kQPitch + kVPitch) + (self ? 0 : keys)) * 4;
}

struct F32Args {
  const float *q, *k, *v;
  float* out;
  int q_stride, kv_stride;
  float scale;
};

template <bool SELF>
__global__ void __launch_bounds__(kF32Threads, 2)
scoring_attention_f32_kernel(const F32Args a, const Sched sc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int keys = SELF ? kF32SelfKeys : (sc.lk + 7) / 8 * 8;
  float* sq = reinterpret_cast<float*>(smem_raw);  // [kTileRows][kQPitch]: warp w's rows 16w, +16
  float* sk = sq + kTileRows * kQPitch;            // [keys][kQPitch]
  float* sv = sk + keys * kQPitch;                 // [keys][kVPitch]
  float* sb = sv + keys * kVPitch;                 // cross: [keys], -inf past lk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = warp * 16;

  // zero the rows once: rows no load writes (past a self tile's answers,
  // past the question's keys, a ragged tile's last queries) must hold finite
  // values, since a masked key's weight is 0 and 0 * NaN is not
  for (int i = threadIdx.x; i < kTileRows * kQPitch + keys * (kQPitch + kVPitch);
       i += kF32Threads)
    sq[i] = 0.0f;
  // rows [0, n) of src (stride floats a row, the head's first column) into
  // dst at `pitch`, by the threads [first, first + count) of the block
  auto load_rows = [&](float* dst, int pitch, const float* src, int stride, int n, int first,
                       int count) {
    for (int c = static_cast<int>(threadIdx.x) - first; c >= 0 && c < n * 16; c += count) {
      const int r = c >> 4, d = (c & 15) * 4;
      tile::cp_async16(dst + r * pitch + d, src + static_cast<size_t>(r) * stride + d, true);
    }
  };

  for (int u = blockIdx.x; u < sc.units; u += gridDim.x) {
    const Span us = unit_span(sc, u);
    const int col = us.head * kHd;
    __syncthreads();  // the zeros are stored, and every warp is done with the last unit's rows
    if (!SELF) {  // the question's keys, values and bias for this head, once a unit
      const size_t kv0 = static_cast<size_t>(us.question) * sc.lk;
      load_rows(sk, kQPitch, a.k + kv0 * a.kv_stride + col, a.kv_stride, sc.lk, 0, kF32Threads);
      load_rows(sv, kVPitch, a.v + kv0 * a.kv_stride + col, a.kv_stride, sc.lk, 0, kF32Threads);
      for (int j = threadIdx.x; j < keys; j += kF32Threads)
        sb[j] = j < sc.lk ? __ldg(sc.bias + kv0 + j) : -INFINITY;
    }
    for (int tl = us.t0; tl < us.t1; ++tl) {
      const int r0 = us.question * sc.rows_per_q + tl * sc.tile_rows;
      const int nrows = min(sc.tile_rows, sc.rows_per_q - tl * sc.tile_rows);
      const size_t q0 = static_cast<size_t>(r0) * a.q_stride + col;
      if (SELF) {  // the tile's Q, K and V rows, by the whole block
        if (tl > us.t0) __syncthreads();  // every warp is done with the last tile's rows
        const size_t k0 = static_cast<size_t>(r0) * a.kv_stride + col;
        load_rows(sq, kQPitch, a.q + q0, a.q_stride, nrows, 0, kF32Threads);
        load_rows(sk, kQPitch, a.k + k0, a.kv_stride, nrows, 0, kF32Threads);
        load_rows(sv, kVPitch, a.v + k0, a.kv_stride, nrows, 0, kF32Threads);
        tile::cp_async_commit();
        tile::cp_async_wait<0>();
        __syncthreads();
      } else {  // each warp its own 16 query rows; no other warp reads them
        __syncwarp();  // every lane is done with the warp's last rows
        load_rows(sq + w0 * kQPitch, kQPitch, a.q + q0 + static_cast<size_t>(w0) * a.q_stride,
                  a.q_stride, max(0, min(16, nrows - w0)), w0 * 2, 32);
        tile::cp_async_commit();
        tile::cp_async_wait<0>();
        if (tl == us.t0) __syncthreads();  // and the unit's keys, values and bias are in
        else __syncwarp();
      }
      if (w0 >= nrows) continue;
      attn32::Rows st;
      attn32::init(st);
      const float* q = sq + (w0 + g) * kQPitch + 2 * t;
      if (SELF) {
        // rows (in the tile) of this thread, their answers' first keys; the
        // warp's window runs from its first row's answer to its last row
        int row[2], first[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          row[h] = w0 + g + 8 * h;
          first[h] = ((r0 + row[h]) / sc.la) * sc.la - r0;
        }
        const int end = min(w0 + 16, nrows);
        for (int k0 = ((r0 + w0) / sc.la) * sc.la - r0; k0 < end; k0 += attn32::kTileKeys)
          attn32::attend_chunks((min(end - k0, attn32::kTileKeys) + 7) / 8, st, q,
                                sk + k0 * kQPitch, sv + k0 * kVPitch, a.scale,
                                [&](float s, int key, int h) {
                                  return k0 + key >= first[h] && k0 + key <= row[h] ? s : -INFINITY;
                                });
      } else {
        for (int k0 = 0; k0 < sc.lk; k0 += attn32::kTileKeys)
          attn32::attend_chunks((min(sc.lk - k0, attn32::kTileKeys) + 7) / 8, st, q,
                                sk + k0 * kQPitch, sv + k0 * kVPitch, a.scale,
                                [&](float s, int key, int) { return s + sb[k0 + key]; });
      }
      float* orow = a.out + static_cast<size_t>(r0 + w0 + g) * sc.out_stride + col;
      attn32::store(st, orow, orow + 8 * static_cast<size_t>(sc.out_stride), w0 + g < nrows,
                    w0 + g + 8 < nrows);
    }
  }
}

// What a call launched, for the caller's record (the C entry's `launch`), in
// this order: the kernel, 1 for the bf16 tensor-core pipeline, 2 for the
// f32 tensor-core kernel, 0 for the CUDA-core kernel; blocks; threads a
// block; dynamic shared memory of a block, bytes; blocks of the kernel an SM
// holds (the occupancy query) and SMs of the card (the tensor-core kernels';
// 0 otherwise); the TMA ring's depth (the pipeline's; 0 otherwise); the units
// of (segment, head) the grid walks and the row tiles a unit (the
// tensor-core kernels'; 0 otherwise); rows a tile.
constexpr int kLaunchFields = 10;

template <int KCH, bool SELF>
int launch_pipe(const void* q, const void* k, const void* v, const float* bias, void* out,
                int rows, int heads, int in_stride, int out_stride, int la, int rows_per_q, int lk,
                float scale, int* launch, cudaStream_t stream) {
  using P = Pipe<KCH, SELF>;
  auto kernel = attention_pipe_kernel<KCH, SELF>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  cudaError_t err = set_smem_once(fn, P::SMEM);
  int dev = 0, sms = 0, resident = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = blocks_per_sm_once(fn, kPipeThreads, P::SMEM, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  Sched sc{};
  // the persistent grid: as many blocks as the card holds at once
  schedule(sc, SELF, rows, heads, la, rows_per_q, sms * resident);
  sc.bias = bias;
  sc.out = static_cast<bf16*>(out);
  sc.la = la;
  sc.lk = lk;
  sc.out_stride = out_stride;
  sc.scale_log2 = scale * 1.4426950408889634f;
  const bf16* qb = static_cast<const bf16*>(q);
  CUtensorMap map_q, map_k, map_v, map_o;
  if (SELF) {  // one map over the QKV block; K and V are columns of it
    sc.koff = static_cast<int>(static_cast<const bf16*>(k) - qb);
    sc.voff = static_cast<int>(static_cast<const bf16*>(v) - qb);
    err = wg::make_map(&map_q, q, rows, in_stride, sc.tile_rows);
    map_k = map_v = map_q;
  } else {
    const int keys = rows / rows_per_q * lk;
    err = wg::make_map(&map_q, q, rows, in_stride, kTileRows);
    if (err == cudaSuccess) err = wg::make_map(&map_k, k, keys, in_stride, lk);
    if (err == cudaSuccess) err = wg::make_map(&map_v, v, keys, in_stride, lk);
  }
  if (err == cudaSuccess) err = wg::make_map(&map_o, out, rows, out_stride, 16);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<sc.grid, kPipeThreads, P::SMEM, stream>>>(map_q, map_k, map_v, map_o, sc);
  const int record[kLaunchFields] = {1, sc.grid, kPipeThreads, P::SMEM, resident, sms,
                                     P::STAGES, sc.units, sc.seg, sc.tile_rows};
  for (int i = 0; i < kLaunchFields; ++i) launch[i] = record[i];
  return static_cast<int>(cudaGetLastError());
}

// Key chunks a mode needs on the tensor cores (0: not taken there): a self
// window covers la + 15 keys, a cross window lk; at most 8 chunks.
int mma_chunks(int mode, int la, int lk) {
  const int keys = mode == 0 ? la + 15 : lk;
  return keys <= 8 * 16 ? (keys + 15) / 16 : 0;
}

template <bool SELF>
int dispatch_pipe(int chunks, const void* q, const void* k, const void* v, const float* bias,
                  void* out, int rows, int heads, int in_stride, int out_stride, int la,
                  int rows_per_q, int lk, float scale, int* launch, cudaStream_t s) {
  switch (chunks) {
#define BQ_CASE(N)                                                                          \
  case N:                                                                                   \
    return launch_pipe<N, SELF>(q, k, v, bias, out, rows, heads, in_stride, out_stride, la, \
                                rows_per_q, lk, scale, launch, s);
    BQ_CASE(1) BQ_CASE(2) BQ_CASE(3) BQ_CASE(4) BQ_CASE(5) BQ_CASE(6) BQ_CASE(7) BQ_CASE(8)
#undef BQ_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool SELF>
int launch_f32(const void* q, const void* k, const void* v, const float* bias, void* out, int rows,
               int heads, int q_stride, int kv_stride, int out_stride, int la, int rows_per_q,
               int lk, float scale, int* launch, cudaStream_t stream) {
  auto kernel = scoring_attention_f32_kernel<SELF>;
  const void* fn = reinterpret_cast<const void*>(kernel);
  const int smem = f32_smem(SELF, SELF ? kF32SelfKeys : (lk + 7) / 8 * 8);
  // the limit once, at the most any call takes, so every call fits it
  cudaError_t err = set_smem_once(fn, f32_smem(SELF, SELF ? kF32SelfKeys : kF32CrossKeys));
  int dev = 0, sms = 0, resident = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = blocks_per_sm_once(fn, kF32Threads, smem, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (resident < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  Sched sc{};
  // a persistent grid: as many blocks as the card holds at once
  schedule(sc, SELF, rows, heads, la, rows_per_q, sms * resident);
  sc.bias = bias;
  sc.la = la;
  sc.lk = lk;
  sc.out_stride = out_stride;
  const F32Args args{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<float*>(out), q_stride, kv_stride,
                     scale};
  kernel<<<sc.grid, kF32Threads, smem, stream>>>(args, sc);
  const int record[kLaunchFields] = {2, sc.grid, kF32Threads, smem, resident, sms,
                                     0, sc.units, sc.seg, sc.tile_rows};
  for (int i = 0; i < kLaunchFields; ++i) launch[i] = record[i];
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_simt(const void* q, const void* k, const void* v, const float* bias, void* out,
                int rows, int heads, int hd, int q_stride, int kv_stride, int out_stride, int la,
                int rows_per_q, int lk, int mode, float scale, int* launch, cudaStream_t stream) {
  const int max_keys = mode == 0 ? kTileRows : lk;
  const size_t smem = 2 * static_cast<size_t>(max_keys) * (hd + 2) * sizeof(T) +
                      static_cast<size_t>(kWarps) * (hd + max_keys) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int blocks, tiles_per_q = 1, tile_rows = kTileRows;
  if (mode == 0) {
    tile_rows = (kTileRows / la) * la;
    blocks = (rows + tile_rows - 1) / tile_rows;
  } else {
    tiles_per_q = (rows_per_q + kTileRows - 1) / kTileRows;
    blocks = (rows / rows_per_q) * tiles_per_q;
  }
  attention_kernel<T><<<dim3(blocks, heads), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), rows, hd, q_stride, kv_stride, out_stride, la, rows_per_q, lk, mode,
      tiles_per_q, scale);
  // one block a (tile, head); the occupancy and SM fields are left at 0
  const int record[kLaunchFields] = {0, blocks * heads, kWarps * 32, static_cast<int>(smem), 0,
                                     0, 0, 0, 0, tile_rows};
  for (int i = 0; i < kLaunchFields; ++i) launch[i] = record[i];
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode 0 (self): q, k, v point at head 0 of the Q, K and V columns of one
// (rows, 3H) block, q_stride = kv_stride = 3H; rows is a multiple of la and
// la <= 128. mode 1 (cross): q (rows, H), k and v (rows / rows_per_q, lk, H),
// bias (rows / rows_per_q, lk) f32. out (rows, H). hd even. dtype 1: bf16,
// 0: f32. `launch` (kLaunchFields ints) receives what was launched: kernel,
// grid, threads, shared memory, resident blocks an SM, SMs, ring depth,
// units, tiles a unit, rows a tile. Returns cudaGetLastError() after the
// launch.
extern "C" int bq_scoring_attention(const void* q, const void* k, const void* v,
                                    const float* bias, void* out, int rows, int heads, int hd,
                                    int q_stride, int kv_stride, int out_stride, int la,
                                    int rows_per_q, int lk, int mode, float scale, int dtype,
                                    int* launch, void* stream) {
  if (hd % 2 || (mode == 0 && (la > kTileRows || rows % la)) ||
      (mode == 1 && (rows_per_q <= 0 || rows % rows_per_q || lk <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the tensor-core kernels: bf16 (the pipeline) with a window of at most
  // 128 keys, or f32 with any answer and at most 128 question keys, each at
  // head width 64 and with 16-byte rows; the CUDA-core kernel takes
  // everything else
  const bool aligned = ((reinterpret_cast<size_t>(q) | reinterpret_cast<size_t>(k) |
                         reinterpret_cast<size_t>(v) | reinterpret_cast<size_t>(out)) % 16) == 0;
  const int chunks = mma_chunks(mode, la, lk);
  if (dtype == 1 && hd == kHd && aligned && chunks && q_stride == kv_stride &&
      q_stride % 8 == 0 && out_stride % 8 == 0) {
    if (mode == 0)
      return dispatch_pipe<true>(chunks, q, k, v, bias, out, rows, heads, q_stride, out_stride,
                                la, rows_per_q, lk, scale, launch, s);
    return dispatch_pipe<false>(chunks, q, k, v, bias, out, rows, heads, q_stride, out_stride, la,
                               rows_per_q, lk, scale, launch, s);
  }
  if (dtype == 0 && hd == kHd && aligned && (mode == 0 || lk <= kF32CrossKeys) &&
      q_stride % 4 == 0 && kv_stride % 4 == 0 && out_stride % 2 == 0) {
    if (mode == 0)
      return launch_f32<true>(q, k, v, bias, out, rows, heads, q_stride, kv_stride, out_stride,
                              la, rows_per_q, lk, scale, launch, s);
    return launch_f32<false>(q, k, v, bias, out, rows, heads, q_stride, kv_stride, out_stride, la,
                             rows_per_q, lk, scale, launch, s);
  }
  if (dtype == 1)
    return launch_simt<bf16>(q, k, v, bias, out, rows, heads, hd, q_stride, kv_stride, out_stride,
                             la, rows_per_q, lk, mode, scale, launch, s);
  return launch_simt<float>(q, k, v, bias, out, rows, heads, hd, q_stride, kv_stride, out_stride,
                            la, rows_per_q, lk, mode, scale, launch, s);
}
