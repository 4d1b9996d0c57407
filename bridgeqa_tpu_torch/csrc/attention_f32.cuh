// The f32 attention body of the port's tensor-core attentions: one warp's 16
// query rows against one tile of up to 64 keys, in 3xTF32 on mma.sync
// m16n8k8 (tile_gemm.cuh), with an online softmax across tiles. The f32 ViT
// attention (vit_attention.cu) and both f32 scoring attentions
// (scoring_attention.cu) run it; each kernel loads its own rows and keys and
// says which keys a row sees (`score` below).
//
// In shared memory, query and key rows of kHd floats lie at a pitch of
// kQPitch (float2 reads of a row's two dims) and value rows at kVPitch (reads
// of two keys' rows at one dim), both free of bank conflicts.
//
// Numerics, the plain versions' (ops/scoring_layer.py::_attend_plain,
// ops/vit_block.py::vit_attention_plain): s = (q . k) * scale, rounded, plus
// the caller's f32 bias where it has one; a masked key's score is -inf. S =
// Q K^T takes hi and lo of Q and K, three products. A row's running max m
// and its sum and context rescale by exp(m_old - m_new) when m grows, and e =
// exp(s - m) (expf, not ex2: e is exactly 1 at a row's max, as the plain
// version's). P V takes e from the S accumulators as they stand (a thread's
// keys 2t and 2t + 1 serve as the fragment's K positions t and t + 4, and V's
// rows are read in the same order) and V split three ways, hi + lo + lo2 = v
// exactly: lo2 * e_hi, e_lo * v_hi, lo * e_hi, hi * e_hi, each 8 keys' four
// products into a fresh accumulator that joins the context by an f32 add, so
// where e is a TF32 value (a single key: e = 1, the others 0) the context is
// exactly the value. A row all of whose keys so far are masked keeps m =
// -inf, and its weights and rescale are 0, not NaN. The division by the f32
// sum comes at the end (store).

#pragma once

#include <cmath>

#include "tile_gemm.cuh"

namespace attn32 {

constexpr int kHd = 64;              // head width
constexpr int kQPitch = kHd + 8;     // floats a row of Q and of K
constexpr int kVPitch = kHd + 4;     // floats a row of V
constexpr int kTileKeys = 64;        // keys of a tile: 8 chunks of 8

// One thread's part of a warp's 16 rows, for its rows g and g + 8 (h = 0,
// 1): the running max of the scores, its part of the running sum, and the
// context's 8 tiles of 8 dims in the accumulator layout.
struct Rows {
  float m[2], l[2];
  float o[kHd / 8][4];
};

__device__ __forceinline__ void init(Rows& r) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r.m[h] = -INFINITY;
    r.l[h] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kHd / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) r.o[j][c] = 0.0f;
}

// One tile of KC 8-key chunks. q: the warp's row g at dim 2t (row g + 8
// lies 8 rows further); k, v: the tile's first key and value rows.
// score(s, key, h): the score of key `key` (< 8 KC) of the tile for row
// g + 8h, given s = (q . k) * scale rounded; -INFINITY masks the key.
template <int KC, typename Score>
__device__ __forceinline__ void attend_tile(Rows& st, const float* q, const float* k,
                                            const float* v, float scale, Score score) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // S = Q K^T: a thread's fragment dims t and t + 4 of each 8 are read from
  // dims 2t and 2t + 1, in Q and K alike
  float s[KC][4];
#pragma unroll
  for (int j = 0; j < KC; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kHd / 8; ++kk) {
    const float2 top = *reinterpret_cast<const float2*>(q + kk * 8);
    const float2 low = *reinterpret_cast<const float2*>(q + 8 * kQPitch + kk * 8);
    unsigned ah[4], al[4];
    tile::split_tf32(top.x, ah[0], al[0]);
    tile::split_tf32(low.x, ah[1], al[1]);
    tile::split_tf32(top.y, ah[2], al[2]);
    tile::split_tf32(low.y, ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const float2 kv =
          *reinterpret_cast<const float2*>(k + (j * 8 + g) * kQPitch + kk * 8 + 2 * t);
      unsigned bh0, bl0, bh1, bl1;
      tile::split_tf32(kv.x, bh0, bl0);
      tile::split_tf32(kv.y, bh1, bl1);
      tile::mma_tf32(s[j], al, bh0, bh1);
      tile::mma_tf32(s[j], ah, bl0, bl1);
      tile::mma_tf32(s[j], ah, bh0, bh1);
    }
  }
  // the scaled scores, rounded as the plain version's, then the caller's
  // bias or mask
#pragma unroll
  for (int j = 0; j < KC; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s[j][c] = score(__fmul_rn(s[j][c], scale), j * 8 + 2 * t + (c & 1), c >> 1);
  // the rows' new maxima; rescale the sums and contexts where they grew. mu:
  // the max the weights are taken against, 0 while every key is masked
  float mu[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float tm = -INFINITY;
#pragma unroll
    for (int j = 0; j < KC; ++j) tm = fmaxf(tm, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 1));
    tm = fmaxf(tm, __shfl_xor_sync(0xffffffffu, tm, 2));
    const float mn = fmaxf(st.m[h], tm);
    mu[h] = mn == -INFINITY ? 0.0f : mn;
    const float alpha = expf(st.m[h] - mu[h]);  // 0 while m was -inf
    st.m[h] = mn;
    st.l[h] *= alpha;
#pragma unroll
    for (int j = 0; j < kHd / 8; ++j) {
      st.o[j][2 * h] *= alpha;
      st.o[j][2 * h + 1] *= alpha;
    }
  }
  // e = exp(s - m) into the sums and O += E V, 8 keys at a time
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    float e[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      e[c] = expf(s[kk][c] - mu[c >> 1]);
      st.l[c >> 1] += e[c];
    }
    // A: K position t is key 2t (e[0] row g, e[2] row g + 8), t + 4 is
    // key 2t + 1 (e[1], e[3])
    unsigned ph[4], pl[4];
    tile::split_tf32(e[0], ph[0], pl[0]);
    tile::split_tf32(e[2], ph[1], pl[1]);
    tile::split_tf32(e[1], ph[2], pl[2]);
    tile::split_tf32(e[3], ph[3], pl[3]);
    const float* vrow = v + (kk * 8 + 2 * t) * kVPitch + g;
#pragma unroll
    for (int j = 0; j < kHd / 8; ++j) {
      unsigned vh0, vl0, vr0, vh1, vl1, vr1;
      tile::split3_tf32(vrow[j * 8], vh0, vl0, vr0);
      tile::split3_tf32(vrow[kVPitch + j * 8], vh1, vl1, vr1);
      float step[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      tile::mma_tf32(step, ph, vr0, vr1);
      tile::mma_tf32(step, pl, vh0, vh1);
      tile::mma_tf32(step, ph, vl0, vl1);
      tile::mma_tf32(step, ph, vh0, vh1);
#pragma unroll
      for (int c = 0; c < 4; ++c) st.o[j][c] += step[c];
    }
  }
}

// attend_tile over `chunks` (1-8) 8-key chunks: a constant in each branch,
// so no branch enters the unrolled loops
template <typename Score>
__device__ __forceinline__ void attend_chunks(int chunks, Rows& st, const float* q, const float* k,
                                              const float* v, float scale, Score score) {
  switch (chunks) {
    case 8: attend_tile<8>(st, q, k, v, scale, score); break;
    case 7: attend_tile<7>(st, q, k, v, scale, score); break;
    case 6: attend_tile<6>(st, q, k, v, scale, score); break;
    case 5: attend_tile<5>(st, q, k, v, scale, score); break;
    case 4: attend_tile<4>(st, q, k, v, scale, score); break;
    case 3: attend_tile<3>(st, q, k, v, scale, score); break;
    case 2: attend_tile<2>(st, q, k, v, scale, score); break;
    default: attend_tile<1>(st, q, k, v, scale, score); break;
  }
}

// O / l in f32 to out_h, the head's first dim of row g + 8h, where ok_h;
// every lane of the warp calls it (the sums are shuffled)
__device__ __forceinline__ void store(const Rows& st, float* out0, float* out1, bool ok0, bool ok1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = st.l[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (!(h ? ok1 : ok0)) continue;
    float* orow = (h ? out1 : out0) + 2 * t;
#pragma unroll
    for (int j = 0; j < kHd / 8; ++j)
      *reinterpret_cast<float2*>(orow + j * 8) =
          make_float2(st.o[j][2 * h] / sum, st.o[j][2 * h + 1] / sum);
  }
}

}  // namespace attn32
