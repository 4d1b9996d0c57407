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
// What bounds it on this card: memory. At the main-path shapes one self
// pass reads the (24576, 2304) bf16 QKV block and writes the (24576, 768)
// context (~150 MB, 45 us at 3.35 TB/s) for 0.9 GFLOP; the cross pass does
// 6 GFLOP against 80 keys. On the CUDA cores the dot products alone are
// bound by instruction issue several times over that (PERF.md).
//
// What the design does about it: one block per (tile of rows, head), the
// tile's keys and values for that head in shared memory. In bf16 at head
// width 64, both modes run on the tensor cores (attention_mma_kernel below)
// when a warp's key window holds at most 128 keys: the main path's answers
// of 12 tokens and questions of 80. Everything else (f32, other widths,
// longer answers or questions) runs on the CUDA cores:
// rows padded by two elements so that a lane per key reads without bank
// conflicts, one warp per query row, a lane per key for the scores, the max
// and the sum by warp shuffles, then a lane per pair of head dimensions for
// the product with V. A self tile is whole sequences; a cross tile lies
// inside one question, so its keys are loaded once for up to 128 rows.

#include "tile_gemm.cuh"

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

// Both attentions on the tensor cores: bf16, head width 64. A block holds a
// tile of up to 128 query rows and their keys and values for one head in
// shared memory; each warp owns 16 rows and a window of 16 * KCH keys:
// S = Q K^T on mma.sync, keys outside the row's mask (or past the window's
// real keys) left out of the max and the sums, the row max and the sum of
// exp across the four lanes of a row, e rounded to bf16 as the A operand of
// P V (the accumulator layout of S is the A layout of P), and the f32
// context divided by the f32 sum.
//   - SELF: the tile is whole answers of `la` rows from the (rows, 3H) QKV
//     block; a warp's window starts at the answer of its first row, and a
//     key counts when it lies in the row's answer at or before the row.
//   - cross: the tile lies inside one question; the window is that
//     question's lk keys (zero-padded to a multiple of 16), with its bias.
constexpr int kHd = 64;
constexpr int kLd = kHd + 8;  // padded row: ldmatrix reads free of bank conflicts

template <int KCH, bool SELF>
__host__ __device__ constexpr int mma_key_rows() {
  return SELF ? kTileRows + 16 * KCH : 16 * KCH;
}

template <int KCH, bool SELF>
__global__ void __launch_bounds__(kWarps * 32)
attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ bias,
                     bf16* __restrict__ out, int in_stride, int out_stride, int rows, int la,
                     int rows_per_q, int lk, int tiles_per_q, float scale) {
  constexpr int kKeyRows = mma_key_rows<KCH, SELF>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [kTileRows][kLd]
  bf16* sk = sq + kTileRows * kLd;               // [kKeyRows][kLd]
  bf16* sv = sk + kKeyRows * kLd;                // [kKeyRows][kLd]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int head = blockIdx.y;
  int r0, nrows, key0, nkeys;
  const float* kb = nullptr;
  if (SELF) {
    const int tile_rows = (kTileRows / la) * la;
    r0 = blockIdx.x * tile_rows;
    nrows = min(tile_rows, rows - r0);
    key0 = r0;
    nkeys = nrows;
  } else {
    const int question = blockIdx.x / tiles_per_q;
    const int tile_idx = blockIdx.x % tiles_per_q;
    r0 = question * rows_per_q + tile_idx * kTileRows;
    nrows = min(kTileRows, rows_per_q - tile_idx * kTileRows);
    key0 = question * lk;
    nkeys = lk;
    kb = bias + static_cast<size_t>(question) * lk;
  }

  for (int c = threadIdx.x; c < kTileRows * 8; c += kWarps * 32) {
    const int r = c >> 3, d = (c & 7) * 8;
    const bool ok = r < nrows;
    tile::cp_async16(sq + r * kLd + d,
                     ok ? q + static_cast<size_t>(r0 + r) * in_stride + head * kHd + d : q, ok);
  }
  for (int c = threadIdx.x; c < kKeyRows * 8; c += kWarps * 32) {
    const int r = c >> 3, d = (c & 7) * 8;
    const bool ok = r < nkeys;
    const size_t gi = static_cast<size_t>(key0 + r) * in_stride + head * kHd + d;
    tile::cp_async16(sk + r * kLd + d, ok ? k + gi : k, ok);
    tile::cp_async16(sv + r * kLd + d, ok ? v + gi : v, ok);
  }
  tile::cp_async_commit();
  tile::cp_async_wait<0>();
  __syncthreads();
  if (warp * 16 >= nrows) return;  // uniform over the warp; no barrier follows

  // the window: shared-memory key rows [ks, ks + 16 * KCH)
  const int ks = SELF ? ((r0 + warp * 16) / la) * la - r0 : 0;
  const bf16* wk = sk + ks * kLd;
  const bf16* wv = sv + ks * kLd;

  // S = Q K^T: (16 rows) x (16 * KCH keys), 2 * KCH n8 tiles
  float s[2 * KCH][4];
#pragma unroll
  for (int j = 0; j < 2 * KCH; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kHd; kk += 16) {
    unsigned a[4];
    tile::ldmatrix_x4(a, sq + (warp * 16 + (lane & 15)) * kLd + kk + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < KCH; ++np) {
      unsigned b[4];
      tile::ldmatrix_x4(b, wk + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kLd + kk +
                               ((lane >> 3) & 1) * 8);
      tile::mma_bf16(s[2 * np], a, b[0], b[1]);
      tile::mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }

  // scale, mask and bias, the max and the sum of each of this thread's two rows
  int row[2], first[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = warp * 16 + g + 8 * h;                             // in the tile
    first[h] = SELF ? ((r0 + row[h]) / la) * la - r0 : 0;       // its answer's first key
  }
  float mx[2] = {-3.0e38f, -3.0e38f};
#pragma unroll
  for (int j = 0; j < 2 * KCH; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int key = ks + j * 8 + 2 * t + e;  // shared-memory key row
      const float kbv = !SELF && key < lk ? kb[key] : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool valid = SELF ? key >= first[h] && key <= row[h] : key < lk;
        float& x = s[j][2 * h + e];
        x = valid ? x * scale + kbv : -3.0e38f;  // masked keys take no part
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
      e[c] = expf(s[j][c] - mx[c >> 1]);
      denom[c >> 1] += e[c];
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(e[0], e[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(e[2], e[3]);
    p[j >> 1][(j & 1) * 2] = *reinterpret_cast<const unsigned*>(&lo);
    p[j >> 1][(j & 1) * 2 + 1] = *reinterpret_cast<const unsigned*>(&hi);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    denom[h] += __shfl_xor_sync(0xffffffffu, denom[h], 1);
    denom[h] += __shfl_xor_sync(0xffffffffu, denom[h], 2);
  }

  // O = P V: (16 rows) x (64 dims), 8 n8 tiles
  float o[kHd / 8][4];
#pragma unroll
  for (int j = 0; j < kHd / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.0f;
#pragma unroll
  for (int c = 0; c < KCH; ++c)
#pragma unroll
    for (int dp = 0; dp < kHd / 16; ++dp) {
      unsigned b[4];
      tile::ldmatrix_x4_trans(b, wv + (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                     dp * 16 + (lane >> 4) * 8);
      tile::mma_bf16(o[2 * dp], p[c], b[0], b[1]);
      tile::mma_bf16(o[2 * dp + 1], p[c], b[2], b[3]);
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= nrows) continue;
    bf16* orow = out + static_cast<size_t>(r0 + row[h]) * out_stride + head * kHd + 2 * t;
#pragma unroll
    for (int j = 0; j < kHd / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(o[j][2 * h] / denom[h], o[j][2 * h + 1] / denom[h]);
  }
}

template <int KCH, bool SELF>
int launch_mma(const void* q, const void* k, const void* v, const float* bias, void* out,
               int rows, int heads, int in_stride, int out_stride, int la, int rows_per_q, int lk,
               float scale, cudaStream_t stream) {
  int blocks, tiles_per_q = 1;
  if (SELF) {
    const int tile_rows = (kTileRows / la) * la;
    blocks = (rows + tile_rows - 1) / tile_rows;
  } else {
    tiles_per_q = (rows_per_q + kTileRows - 1) / kTileRows;
    blocks = (rows / rows_per_q) * tiles_per_q;
  }
  const int smem =
      (kTileRows + 2 * mma_key_rows<KCH, SELF>()) * kLd * static_cast<int>(sizeof(bf16));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_mma_kernel<KCH, SELF>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  attention_mma_kernel<KCH, SELF><<<dim3(blocks, heads), kWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), bias,
      static_cast<bf16*>(out), in_stride, out_stride, rows, la, rows_per_q, lk, tiles_per_q,
      scale);
  return static_cast<int>(cudaGetLastError());
}

// Key chunks a mode needs on the tensor cores (0: not taken there): a self
// window covers la + 15 keys, a cross window lk; at most 8 chunks.
int mma_chunks(int mode, int la, int lk) {
  const int keys = mode == 0 ? la + 15 : lk;
  return keys <= 8 * 16 ? (keys + 15) / 16 : 0;
}

template <bool SELF>
int dispatch_mma(int chunks, const void* q, const void* k, const void* v, const float* bias,
                 void* out, int rows, int heads, int in_stride, int out_stride, int la,
                 int rows_per_q, int lk, float scale, cudaStream_t s) {
  switch (chunks) {
#define BQ_CASE(N)                                                                         \
  case N:                                                                                  \
    return launch_mma<N, SELF>(q, k, v, bias, out, rows, heads, in_stride, out_stride, la, \
                               rows_per_q, lk, scale, s);
    BQ_CASE(1) BQ_CASE(2) BQ_CASE(3) BQ_CASE(4) BQ_CASE(5) BQ_CASE(6) BQ_CASE(7) BQ_CASE(8)
#undef BQ_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias, void* out, int rows,
           int heads, int hd, int q_stride, int kv_stride, int out_stride, int la, int rows_per_q,
           int lk, int mode, float scale, cudaStream_t stream) {
  const int max_keys = mode == 0 ? kTileRows : lk;
  const size_t smem = 2 * static_cast<size_t>(max_keys) * (hd + 2) * sizeof(T) +
                      static_cast<size_t>(kWarps) * (hd + max_keys) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int blocks, tiles_per_q = 1;
  if (mode == 0) {
    const int tile_rows = (kTileRows / la) * la;
    blocks = (rows + tile_rows - 1) / tile_rows;
  } else {
    tiles_per_q = (rows_per_q + kTileRows - 1) / kTileRows;
    blocks = (rows / rows_per_q) * tiles_per_q;
  }
  attention_kernel<T><<<dim3(blocks, heads), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), rows, hd, q_stride, kv_stride, out_stride, la, rows_per_q, lk, mode,
      tiles_per_q, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode 0 (self): q, k, v point at head 0 of the Q, K and V columns of one
// (rows, 3H) block, q_stride = kv_stride = 3H; rows is a multiple of la and
// la <= 128. mode 1 (cross): q (rows, H), k and v (rows / rows_per_q, lk, H),
// bias (rows / rows_per_q, lk) f32. out (rows, H). hd even. dtype 1: bf16,
// 0: f32. Returns cudaGetLastError() after the launch.
extern "C" int bq_scoring_attention(const void* q, const void* k, const void* v,
                                    const float* bias, void* out, int rows, int heads, int hd,
                                    int q_stride, int kv_stride, int out_stride, int la,
                                    int rows_per_q, int lk, int mode, float scale, int dtype,
                                    void* stream) {
  if (hd % 2 || (mode == 0 && (la > kTileRows || rows % la)) ||
      (mode == 1 && (rows_per_q <= 0 || rows % rows_per_q || lk <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the tensor-core kernel: bf16, head width 64, 16-byte rows, a window
  // of at most 128 keys; the CUDA-core kernel takes everything else
  const bool aligned = ((reinterpret_cast<size_t>(q) | reinterpret_cast<size_t>(k) |
                         reinterpret_cast<size_t>(v) | reinterpret_cast<size_t>(out)) % 16) == 0;
  const int chunks = mma_chunks(mode, la, lk);
  if (dtype == 1 && hd == kHd && aligned && chunks && q_stride == kv_stride &&
      q_stride % 8 == 0 && out_stride % 8 == 0) {
    if (mode == 0)
      return dispatch_mma<true>(chunks, q, k, v, bias, out, rows, heads, q_stride, out_stride,
                                la, rows_per_q, lk, scale, s);
    return dispatch_mma<false>(chunks, q, k, v, bias, out, rows, heads, q_stride, out_stride, la,
                               rows_per_q, lk, scale, s);
  }
  if (dtype == 1)
    return launch<bf16>(q, k, v, bias, out, rows, heads, hd, q_stride, kv_stride, out_stride, la,
                        rows_per_q, lk, mode, scale, s);
  return launch<float>(q, k, v, bias, out, rows, heads, hd, q_stride, kv_stride, out_stride, la,
                       rows_per_q, lk, mode, scale, s);
}
