// Exact scan-order ball query for Hopper (sm_90a).
//
// Replaces bridgeqa_tpu/ops/grouping.py::_ball_query_exact (XLA in the JAX
// package: a chunked scan of counts, not a Pallas kernel), whose rule is the
// reference's query_ball_point_kernel (lib/pointnet2/_ext_src/src/
// ball_query_gpu.cu):
//   - a point qualifies when d2 < r2, d2 = dx*dx + dy*dy + dz*dz with
//     dx = c - p, rounded after every operation (no FMA contraction: the
//     source builds with -fmad=false), the sum taken in that order;
//   - slot s takes the (s + 1)-th qualifier in ascending point order;
//   - when fewer than nsample qualify, the remaining slots take the first
//     qualifier; when none does, every slot is 0.
//
// What bounds it on this card: the scan, by operations. The reference's
// scan stops at the nsample-th qualifier, and most balls hold fewer: at SA1
// (40k points, 2048 centres, batch 8, about 6 points in a ball of 0.2 m)
// nearly every centre tests every point, ~6.6e8 tests of 9 f32 operations
// (3 sub, 3 mul, 2 add, a compare). The bytes (the clouds once, the indices
// once) are a few MB.
//
// What the design does about it (right first, not yet fast):
//   - the reference runs a thread per centre, each scanning the cloud alone:
//     at SA1 that is 16384 threads, about 4 warps an SM, each lane on its own
//     point. Here a warp serves one centre and its 32 lanes test 32
//     consecutive points at once: 16384 warps at SA1;
//   - the 8 warps of a block serve 8 centres of one cloud and share the
//     cloud's points, staged kTile at a time into shared memory (12 KB);
//     lane i reads words 3i, 3i + 1, 3i + 2, and 3 is odd, so the 32 lanes of
//     a read hit 32 banks;
//   - __ballot_sync gives the 32 points' in-radius mask, and a lane's slot is
//     the count so far plus the qualifiers on the lanes below it
//     (__popc(mask & lanemask_lt)): the slots come out in point order;
//   - a warp stops at its nsample-th qualifier, and the block stops staging
//     once all its warps have (__syncthreads_and);
//   - then the fill: the slots from the count on take the first qualifier
//     (0 when there was none).
// The output is an index, so there is no backward: the callers group with a
// gather that autograd differentiates.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;    // centres a block, a warp each
constexpr int kTile = 1024;  // points a block stages at a time

__device__ __forceinline__ bool qualifies(float px, float py, float pz, float cx, float cy,
                                          float cz, float r2) {
  const float dx = __fsub_rn(cx, px);
  const float dy = __fsub_rn(cy, py);
  const float dz = __fsub_rn(cz, pz);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  return d2 < r2;
}

__global__ void __launch_bounds__(kWarps * 32)
ball_query_exact_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                        int* __restrict__ idx_out, int n, int m, int nsample, float r2) {
  __shared__ float pts[kTile * 3];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (m + kWarps - 1) / kWarps;
  const int b = blockIdx.x / groups;
  const int c = (blockIdx.x % groups) * kWarps + warp;
  const bool live = c < m;  // a warp past m stages with the block and tests nothing
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  const size_t task = static_cast<size_t>(b) * m + (live ? c : 0);
  int* out = idx_out + task * nsample;
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  if (live) {
    cx = centers[3 * task];
    cy = centers[3 * task + 1];
    cz = centers[3 * task + 2];
  }
  const unsigned below = (1u << lane) - 1u;  // the lanes under this one
  int count = 0, first = 0;
  bool done = !live;
  for (int base = 0; base < n; base += kTile) {
    // every warp has finished the tile before (the buffer is free); stop
    // when every warp has its nsample qualifiers
    if (__syncthreads_and(done)) break;
    const int len = min(kTile, n - base);
    const float* src = p + 3 * static_cast<size_t>(base);
    for (int e = threadIdx.x; e < 3 * len; e += kWarps * 32) pts[e] = src[e];
    __syncthreads();
    for (int j = 0; j < len && !done; j += 32) {
      const int at = j + lane;
      const bool q = at < len && qualifies(pts[3 * at], pts[3 * at + 1], pts[3 * at + 2], cx, cy,
                                           cz, r2);
      const unsigned hit = __ballot_sync(0xffffffffu, q);
      if (hit) {  // uniform over the warp
        if (count == 0) first = base + j + __ffs(hit) - 1;
        const int slot = count + __popc(hit & below);
        if (q && slot < nsample) out[slot] = base + at;
        count += __popc(hit);
        done = count >= nsample;
      }
    }
  }
  if (!live) return;
  const int fill = count > 0 ? first : 0;
  for (int t = count + lane; t < nsample; t += 32) out[t] = fill;
}

}  // namespace

// xyz (batch, n, 3) f32; centers (batch, m, 3) f32; idx_out (batch, m,
// nsample) i32. `launch` (3 ints) receives what was launched: blocks,
// warps a block (a centre each) and the points a block stages at a time.
// Returns cudaGetLastError() after the launch.
extern "C" int bq_ball_query_exact(const float* xyz, const float* centers, int* idx_out, int batch,
                                   int n, int m, int nsample, float r2, int* launch, void* stream) {
  if (nsample < 1 || batch < 0 || n < 0 || m < 0) return static_cast<int>(cudaErrorInvalidValue);
  launch[0] = launch[1] = launch[2] = 0;
  if (static_cast<long long>(batch) * m == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = static_cast<long long>(batch) * ((m + kWarps - 1) / kWarps);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ball_query_exact_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(xyz, centers, idx_out, n, m,
                                                                 nsample, r2);
  launch[0] = static_cast<int>(blocks);
  launch[1] = kWarps;
  launch[2] = kTile;
  return static_cast<int>(cudaGetLastError());
}
