// Stripe ball query for Hopper (sm_90a).
//
// Replaces the Pallas kernel bridgeqa_tpu/ops/grouping.py::
// _ball_query_stripe_kernel (reached through _ball_query_stripes_impl,
// _ball_query_stripes and _ball_query_stripes_feats). Same selection rule
// and outputs:
//   - the padded cloud of np points is cut into `stripes` stripes of
//     `width` points; points at or past n are padding and never qualify;
//   - a point qualifies when d2 < r2, d2 = dx*dx + dy*dy + dz*dz with
//     dx = p - c, rounded after every operation (no FMA contraction);
//   - picks == 1: slot s takes the first qualifier of stripe s;
//     picks == 2: slots 2s and 2s+1 take the first and the last;
//   - a slot whose stripe is empty takes the first qualifier of the whole
//     ball; a ball with no qualifier takes index 0;
//   - rel[..., 0:3] is p[idx] - c, and 0 for a ball with no qualifier;
//     fout[..., j] is feats[idx, j] (point 0's features for a ball with no
//     qualifier), for up to 4 feature channels.
// The Pallas kernel emits one plane per channel (the TPU's lane layout);
// here rel and the features come out channel-last, (b, m, nsample, 3) and
// (b, m, nsample, nf), the layout the shared MLP reads.
//
// What bounds it on this card: the scan. Most balls hold a few points, so
// most stripes are empty and are read to their end: at SA1 shapes
// (40k points, 2048 centers, batch 8) that is ~6.7e8 distance tests and
// ~8 GB of coordinate reads, served from L1/L2 because one batch's cloud
// (480 KB) is reused by all of its centers.
//
// What the design does about it: one warp per (batch, center). The warp
// walks a stripe 32 points at a time; __ballot_sync marks the qualifiers of
// a chunk, __ffs gives the first and stops the forward walk, and for
// picks == 2 a backward walk stops at the last (__clz). The per-slot
// results stay in shared memory, and each lane then writes its slots'
// index, offsets and features, so nothing (b, m, n)-sized is ever stored.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxSlots = 64;
constexpr int kBig = 1 << 30;

__device__ __forceinline__ bool qualifies(const float* __restrict__ p, int i, float cx, float cy,
                                          float cz, float r2) {
  const float dx = __fsub_rn(p[3 * i], cx);
  const float dy = __fsub_rn(p[3 * i + 1], cy);
  const float dz = __fsub_rn(p[3 * i + 2], cz);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  return d2 < r2;
}

__global__ void __launch_bounds__(kWarps * 32)
ball_query_stripes_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                          const float* __restrict__ feats, int* __restrict__ idx_out,
                          float* __restrict__ rel, float* __restrict__ fout, int batch, int n,
                          int m, int nsample,
                          int stripes, int width, int picks, int nf, float r2) {
  __shared__ int slots[kWarps][kMaxSlots];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long task = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (task >= static_cast<long long>(batch) * m) return;  // uniform over the warp
  const int b = static_cast<int>(task / m);
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  const float cx = centers[3 * task], cy = centers[3 * task + 1], cz = centers[3 * task + 2];

  int first_all = kBig;
  for (int s = 0; s < stripes; ++s) {
    const int base = s * width;
    const int end = min(base + width, n);
    int fst = kBig, lst = kBig;
    for (int c = base; c < end; c += 32) {
      const int i = c + lane;
      const unsigned hit = __ballot_sync(0xffffffffu, i < end && qualifies(p, i, cx, cy, cz, r2));
      if (hit) {
        fst = c + __ffs(hit) - 1;
        break;
      }
    }
    if (picks == 2 && fst != kBig) {
      for (int c = base + ((end - 1 - base) / 32) * 32; c >= base; c -= 32) {
        const int i = c + lane;
        const unsigned hit = __ballot_sync(0xffffffffu, i < end && qualifies(p, i, cx, cy, cz, r2));
        if (hit) {
          lst = c + 31 - __clz(hit);
          break;
        }
      }
    }
    if (lane == 0) {
      if (picks == 2) {
        slots[warp][2 * s] = fst;
        slots[warp][2 * s + 1] = lst;
      } else {
        slots[warp][s] = fst;
      }
    }
    first_all = min(first_all, fst);
  }
  __syncwarp();

  const bool found_any = first_all < kBig;
  const int fill = found_any ? first_all : 0;
  const float* f = nf ? feats + static_cast<size_t>(b) * n * nf : nullptr;
  for (int t = lane; t < nsample; t += 32) {
    const int sel = slots[warp][t];
    const bool missing = sel >= kBig;
    const int id = missing ? fill : sel;
    const size_t slot = static_cast<size_t>(task) * nsample + t;
    idx_out[slot] = id;
    float* g = rel + slot * 3;
    if (missing && !found_any) {
      g[0] = 0.0f;
      g[1] = 0.0f;
      g[2] = 0.0f;
    } else {
      g[0] = __fsub_rn(p[3 * id], cx);
      g[1] = __fsub_rn(p[3 * id + 1], cy);
      g[2] = __fsub_rn(p[3 * id + 2], cz);
    }
    for (int j = 0; j < nf; ++j) fout[slot * nf + j] = f[static_cast<size_t>(id) * nf + j];
  }
}

}  // namespace

// xyz (b, n, 3) f32; centers (b, m, 3) f32; feats (b, n, nf) f32 or null
// when nf == 0; idx_out (b, m, nsample) i32; rel (b, m, nsample, 3) f32;
// fout (b, m, nsample, nf) f32 or null when nf == 0. stripes * width is the
// padded point count. Returns cudaGetLastError() after the launch.
extern "C" int bq_ball_query_stripes(const float* xyz, const float* centers, const float* feats,
                                     int* idx_out, float* rel, float* fout, int batch, int n,
                                     int m,
                                     int nsample, int stripes, int width, int picks, int nf,
                                     float r2, void* stream) {
  if (nsample > kMaxSlots || stripes * picks != nsample) return static_cast<int>(cudaErrorInvalidValue);
  const long long tasks = static_cast<long long>(batch) * m;
  const int blocks = static_cast<int>((tasks + kWarps - 1) / kWarps);
  ball_query_stripes_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, centers, feats, idx_out, rel, fout, batch, n, m, nsample, stripes, width, picks, nf, r2);
  return static_cast<int>(cudaGetLastError());
}
