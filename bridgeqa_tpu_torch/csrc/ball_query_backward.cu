// Backward of the stripe ball query for Hopper (sm_90a).
//
// The forward (ball_query_stripes.cu) gives, for each centre c of cloud b and
// slot s, idx[b, c, s], rel[b, c, s] = xyz[b, idx] - centre[b, c] and, with
// features, grouped[b, c, s, :] = feats[b, idx, :]. Its cotangents are:
//   g_xyz[b, idx[b, c, s]]   += g_rel[b, c, s]        (a scatter)
//   g_feats[b, idx[b, c, s]] += g_grouped[b, c, s]    (a scatter)
//   g_center[b, c]            = -sum_s g_rel[b, c, s] (a reduction)
// the indices take none. This is the VJP the JAX package puts around its
// Pallas kernel (bridgeqa_tpu/ops/grouping.py, _ball_query_stripes_bwd and
// _ball_query_stripes_feats_bwd), which XLA computes there; it has no TPU
// kernel of its own. A slot of an all-empty ball holds index 0 and rel 0,
// and its cotangent still goes to point 0 and to the centre, as in that VJP.
//
// What bounds it on this card: memory, and the atomics' contention where
// many slots pick one point. It reads the indices and the cotangents once and
// writes g_xyz, g_feats and g_center once; the arithmetic is one add a value.
//
// What the design does about it: one warp a centre, its lanes on consecutive
// slots, so the index and cotangent loads of a warp are contiguous; the
// centre's sum reduced across the warp by shuffles and written once, with no
// atomics. A slot whose stripe held no qualifier repeats the ball's first
// one, so a warp often holds the same point in many lanes: lanes that hold
// the same point (__match_any_sync) add their cotangents by shuffles and the
// lowest of them makes one f32 atomicAdd into g_xyz and g_feats (which the
// wrapper zeroes first); a warp with no repeated point adds directly. The
// sums' order varies from run to run, so the results are not bitwise
// repeatable.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxFeats = 4;  // the forward kernel's feature channels at most

__global__ void __launch_bounds__(kWarps * 32)
ball_query_backward_kernel(const int* __restrict__ idx, const float* __restrict__ g_rel,
                           const float* __restrict__ g_grouped, float* __restrict__ g_xyz,
                           float* __restrict__ g_center, float* __restrict__ g_feats,
                           long long centres, int n, int m, int nsample, int nf) {
  const long long c = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (c >= centres) return;  // the whole warp: c is the same for its lanes
  const int lane = threadIdx.x & 31;
  const long long base = (c / m) * n;  // the first point of this centre's cloud
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int s0 = 0; s0 < nsample; s0 += 32) {
    const int s = s0 + lane;
    const bool live = s < nsample;
    const long long slot = c * nsample + s;
    // an idle lane holds a point of its own, -1 - lane, that no slot picks
    const int point = live ? idx[slot] : -1 - lane;
    // the slot's cotangents: rel's 3, then the feature channels' (0 past nf)
    float v[3 + kMaxFeats];
#pragma unroll
    for (int k = 0; k < 3 + kMaxFeats; ++k) {
      const bool has = live && (k < 3 || k - 3 < nf);
      v[k] = !has ? 0.0f : k < 3 ? g_rel[slot * 3 + k] : g_grouped[slot * nf + k - 3];
    }
    sx += v[0];
    sy += v[1];
    sz += v[2];
    const unsigned peers = __match_any_sync(0xffffffffu, point);
    if (!__all_sync(0xffffffffu, peers == (1u << lane))) {
      // some point repeats: every lane takes part in the shuffles (the
      // branch is the same for the whole warp) and sums its peers' values
      float sum[3 + kMaxFeats] = {};
      const int lanes = min(32, nsample - s0);  // idle lanes are nobody's peers
      for (int j = 0; j < lanes; ++j) {
        const bool peer = (peers >> j) & 1u;
#pragma unroll
        for (int k = 0; k < 3 + kMaxFeats; ++k) {
          if (k < 3 + nf) {  // nf is the same for the whole warp
            const float w = __shfl_sync(0xffffffffu, v[k], j);
            if (peer) sum[k] += w;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 3 + kMaxFeats; ++k) v[k] = sum[k];
    }
    if (live && lane == __ffs(peers) - 1) {  // the lowest lane of its point's peers
      const long long p = base + point;
#pragma unroll
      for (int k = 0; k < 3 + kMaxFeats; ++k) {
        if (k < 3) {
          atomicAdd(g_xyz + p * 3 + k, v[k]);
        } else if (k - 3 < nf) {
          atomicAdd(g_feats + p * nf + k - 3, v[k]);
        }
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    sx += __shfl_xor_sync(0xffffffffu, sx, o);
    sy += __shfl_xor_sync(0xffffffffu, sy, o);
    sz += __shfl_xor_sync(0xffffffffu, sz, o);
  }
  if (lane == 0) {
    g_center[c * 3] = -sx;
    g_center[c * 3 + 1] = -sy;
    g_center[c * 3 + 2] = -sz;
  }
}

}  // namespace

// idx (B, M, S) int32 with 0 <= idx < n (the forward's, unchecked); g_rel
// (B, M, S, 3) and, when nf > 0, g_grouped (B, M, S, nf) with nf <= 4, f32
// contiguous.
// g_xyz (B, N, 3) and g_feats (B, N, nf) must be zero on entry; g_center
// (B, M, 3) is written whole. Returns the launch's CUDA error code.
extern "C" int bq_ball_query_backward(const int* idx, const float* g_rel, const float* g_grouped,
                                      float* g_xyz, float* g_center, float* g_feats, int batch,
                                      int n, int m, int nsample, int nf, void* stream) {
  if (nsample <= 0 || nf < 0 || nf > kMaxFeats ||
      (nf > 0 && (g_grouped == nullptr || g_feats == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long centres = static_cast<long long>(batch) * m;
  if (centres == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (centres + kWarps - 1) / kWarps;
  ball_query_backward_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      idx, g_rel, g_grouped, g_xyz, g_center, g_feats, centres, n, m, nsample, nf);
  return static_cast<int>(cudaGetLastError());
}
