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
// What bounds it on this card: memory. It reads the indices and the
// cotangents once and writes g_xyz, g_feats and g_center once; the
// arithmetic is one add a value. At the train step's shape (the vote
// aggregation: 16 clouds of 1024 points, 256 centres of 16 slots) that is
// 1.3 MB, under half a microsecond: there the time is the launch, and was two
// launches (a zero-fill, then the scatter). What else stands in the way is
// contention: a slot whose stripe held no qualifier repeats its ball's first
// one, so most of a centre's slots pick one point (at SA1's shape 57 of 64 on
// average).
//
// What the design does about it:
//   - One launch. A cloud takes a thread-block cluster of k blocks (k = 1: a
//     lone block), k the largest of 8, 4, 2 that leaves a block at least a
//     slot a thread (the train step's shape: 4, SA1's: 8; PERF.md has the
//     readings of each k at both shapes): block r zeroes
//     its share of the cloud's g_xyz, g_feats and g_center, and serves its
//     share of the cloud's centres with their slots. A cluster barrier
//     (release, acquire) between the zeroing and the adds orders them, so
//     the wrapper allocates the outputs with torch.empty and nothing fills
//     them first.
//   - Threads run over the block's slots, 32 consecutive ones a warp, two
//     chunks at a time: the loads of both are issued before the first add.
//   - A warp merges its repeated points before it adds. A centre's slots are
//     consecutive, so a warp's 32 slots are pieces of a few centres; per
//     piece, segmented scans by shuffles give the smallest point index (the
//     ball's first qualifier, which every repeat of the fill holds), the sum
//     of the cotangents of the lanes holding it, and the sum of the rel
//     cotangents (the centre's share). The piece's last lane adds both sums;
//     the other lanes add their own slots. Whatever idx holds, every
//     cotangent is added once: this only cuts the adds that collide.
//   - The adds are f32 reductions in global memory (red.global.add.f32),
//     which L2 performs without a reply. Sums in shared memory measured slower
//     (PERF.md): this card has no f32 add on shared memory (atomicAdd
//     there is a compare-and-swap loop, ATOMS.CAST.SPIN; on distributed
//     shared memory a generic atom with compare-and-swap fallbacks), and the
//     SM spends tens of cycles on each such instruction, and on each access
//     to another block's shared memory, whatever number of its lanes take
//     part.
// The sums' order varies from run to run, so the results are not bitwise
// repeatable.
// The launch plan (blocks a cloud, which is the cluster size, and the
// points and centres a block zeroes and serves) is computed by the caller
// (grouping.backward_plan) and checked here.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kChunks = 2;       // 32-slot chunks a warp loads before it adds
constexpr int kMaxFeats = 4;     // the forward kernel's feature channels at most

template <int NF, bool CLUSTER>
__global__ void __launch_bounds__(kThreads)
ball_query_backward_kernel(const int* __restrict__ idx, const float* __restrict__ g_rel,
                           const float* __restrict__ g_grouped, float* __restrict__ g_xyz,
                           float* __restrict__ g_center, float* __restrict__ g_feats, int n, int m,
                           int nsample, int k_blocks, int points, int centres) {
  constexpr int V = 3 + NF;  // values a slot: rel's 3, then the feature channels'
  const int rank = CLUSTER ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int b = blockIdx.x / k_blocks;
  const int lane = threadIdx.x & 31;
  const int p_lo = rank * points, p_n = max(0, min(points, n - p_lo));
  const int c_lo = rank * centres, c_n = max(0, min(centres, m - c_lo));
  float* cloud_xyz = g_xyz + static_cast<size_t>(b) * n * 3;
  float* cloud_feats = NF > 0 ? g_feats + static_cast<size_t>(b) * n * NF : nullptr;
  float* cloud_centre = g_center + static_cast<size_t>(b) * m * 3;

  for (int e = threadIdx.x; e < 3 * p_n; e += kThreads) cloud_xyz[3 * p_lo + e] = 0.0f;
  for (int e = threadIdx.x; e < NF * p_n; e += kThreads) cloud_feats[NF * p_lo + e] = 0.0f;
  for (int e = threadIdx.x; e < 3 * c_n; e += kThreads) cloud_centre[3 * c_lo + e] = 0.0f;
  // every block's zeros are in memory before any block adds onto them
  if (CLUSTER) {
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
  } else {
    __threadfence();
    __syncthreads();
  }

  // the block's slots: those of its centres, consecutive in idx and g_rel
  const long long s_lo = (static_cast<long long>(b) * m + c_lo) * nsample;
  const long long s_n = static_cast<long long>(c_n) * nsample;
  for (long long s0 = 0; s0 < s_n; s0 += static_cast<long long>(kThreads) * kChunks) {
    unsigned pt[kChunks];
    int key[kChunks];
    float v[kChunks][V];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const long long s = s0 + u * kThreads + threadIdx.x;  // 32 consecutive slots a warp
      const bool live = s < s_n;
      const long long slot = s_lo + (live ? s : 0);
      // a point out of range (a lane past the slots included) adds nowhere
      pt[u] = live ? static_cast<unsigned>(idx[slot]) : 0xffffffffu;
      // the slot's centre, within the block; a lane past the slots is a centre of its own
      key[u] = live ? static_cast<int>(s / nsample) : -1 - lane;
#pragma unroll
      for (int k = 0; k < 3; ++k) v[u][k] = live ? g_rel[slot * 3 + k] : 0.0f;
#pragma unroll
      for (int k = 0; k < NF; ++k) v[u][3 + k] = live ? g_grouped[slot * NF + k] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      // each lane's piece (the lanes of its centre in this chunk) ends at lane `last`
      const int next_key = __shfl_down_sync(0xffffffffu, key[u], 1);
      const unsigned ends = __ballot_sync(0xffffffffu, lane == 31 || next_key != key[u]);
      const int last = lane + __ffs(ends >> lane) - 1;
      // the piece's smallest point: a segmented min-scan, read at the piece's end
      unsigned lo = pt[u];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int k_up = __shfl_up_sync(0xffffffffu, key[u], o);
        const unsigned p_up = __shfl_up_sync(0xffffffffu, lo, o);
        if (lane >= o && k_up == key[u]) lo = min(lo, p_up);
      }
      lo = __shfl_sync(0xffffffffu, lo, last);
      const bool merged = pt[u] == lo;
      // segmented sum-scans: the cotangents of the lanes on the piece's
      // smallest point, and the piece's rel cotangents (its centre's share)
      float grp[V], ctr[3];
#pragma unroll
      for (int k = 0; k < V; ++k) grp[k] = merged ? v[u][k] : 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) ctr[k] = v[u][k];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int k_up = __shfl_up_sync(0xffffffffu, key[u], o);
        const bool same = lane >= o && k_up == key[u];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float up = __shfl_up_sync(0xffffffffu, grp[k], o);
          if (same) grp[k] += up;
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float up = __shfl_up_sync(0xffffffffu, ctr[k], o);
          if (same) ctr[k] += up;
        }
      }
      // the adds: this lane's own slot unless merged, and at the piece's end
      // the merged sum and the centre's share
      auto add_point = [&](unsigned p, const float* val) {
#pragma unroll
        for (int k = 0; k < 3; ++k) atomicAdd(cloud_xyz + 3 * p + k, val[k]);
#pragma unroll
        for (int k = 0; k < NF; ++k) atomicAdd(cloud_feats + NF * p + k, val[3 + k]);
      };
      if (!merged && pt[u] < static_cast<unsigned>(n)) add_point(pt[u], v[u]);
      if (lane == last) {
        if (lo < static_cast<unsigned>(n)) add_point(lo, grp);
        if (key[u] >= 0) {
#pragma unroll
          for (int k = 0; k < 3; ++k) atomicAdd(cloud_centre + 3 * (c_lo + key[u]) + k, -ctr[k]);
        }
      }
    }
  }
}

using Kernel = void (*)(const int*, const float*, const float*, float*, float*, float*, int, int,
                        int, int, int, int);

template <bool CLUSTER>
Kernel kernel_for(int nf) {
  switch (nf) {
    case 0: return ball_query_backward_kernel<0, CLUSTER>;
    case 1: return ball_query_backward_kernel<1, CLUSTER>;
    case 2: return ball_query_backward_kernel<2, CLUSTER>;
    case 3: return ball_query_backward_kernel<3, CLUSTER>;
    default: return ball_query_backward_kernel<4, CLUSTER>;
  }
}

}  // namespace

// idx (B, M, S) int32 with 0 <= idx < n (the forward's; an index out of range
// adds nowhere); g_rel (B, M, S, 3) and, when nf > 0, g_grouped (B, M, S,
// nf) with nf <= 4, f32 contiguous. g_xyz (B, N, 3), g_feats (B, N, nf) and
// g_center (B, M, 3) are written whole; nothing need be zero on entry.
// The plan: blocks a cloud (1, 2, 4 or 8; above 1 they form a cluster),
// the points and the centres each block zeroes and serves (ceil(n / blocks)
// and ceil(m / blocks)); a plan that does not cover the cloud is refused.
// `launch` (3 ints) receives what was launched: blocks, blocks a cluster (1:
// no cluster) and threads a block. Returns the launch's CUDA error code.
extern "C" int bq_ball_query_backward(const int* idx, const float* g_rel, const float* g_grouped,
                                      float* g_xyz, float* g_center, float* g_feats, int batch,
                                      int n, int m, int nsample, int nf, int k_blocks, int points,
                                      int centres, int* launch, void* stream) {
  for (int k = 0; k < 3; ++k) launch[k] = 0;
  if (nsample <= 0 || nf < 0 || nf > kMaxFeats || batch < 0 || n < 0 || m < 0 ||
      (nf > 0 && (g_grouped == nullptr || g_feats == nullptr)) ||
      (k_blocks != 1 && k_blocks != 2 && k_blocks != 4 && k_blocks != 8) ||
      points != (n + k_blocks - 1) / k_blocks || centres != (m + k_blocks - 1) / k_blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(batch) * k_blocks;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0 || static_cast<long long>(n) + m == 0) return static_cast<int>(cudaSuccess);
  const bool cluster = k_blocks > 1;
  const Kernel kernel = cluster ? kernel_for<true>(nf) : kernel_for<false>(nf);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = k_blocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = cluster ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, idx, g_rel, g_grouped, g_xyz, g_center,
                                             g_feats, n, m, nsample, k_blocks, points, centres);
  if (err != cudaSuccess) return static_cast<int>(err);
  launch[0] = static_cast<int>(blocks);
  launch[1] = k_blocks;
  launch[2] = kThreads;
  return static_cast<int>(cudaGetLastError());
}
