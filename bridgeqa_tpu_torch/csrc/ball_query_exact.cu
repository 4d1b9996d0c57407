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
// (3 sub, 3 mul, 2 add, a compare), each its own instruction. The bytes (the
// clouds once, the indices once) are a few MB.
//
// What the design does about it:
//   - a warp serves C centres (the launch plan's centres_per_warp: 8, 4, 2
//     or 1), their coordinates in registers, and its 32 lanes test 32
//     consecutive points at once. A lane loads its point once, as one
//     16-byte shared load, and tests it against all C centres: a shared load
//     goes with 9 C operations, not 9;
//   - the 8 warps of a block serve 8 C centres of one cloud and share its
//     points, staged kTile at a time into shared memory, padded to a float4
//     a point, by cp.async into two buffers: tile t + 1 loads while tile t is
//     tested. A block streams its cloud from L2 once for 8 C centres;
//   - the C compares of a chunk fold into one predicate (FSETP takes an OR
//     with the one before), and one __any_sync tells the warp whether any
//     lane holds a qualifier for any centre: most chunks hold none, and
//     their branch is not taken. Only then a __ballot_sync a centre gives the
//     32 points' in-radius mask, and a lane's slot is the centre's count so
//     far plus the qualifiers on the lanes below it (__popc(mask &
//     lanemask_lt)): the slots come out in point order;
//   - a centre stops at its nsample-th qualifier: its coordinates become
//     +inf, so no point qualifies for it again (inf - p is inf or NaN, and
//     neither compares below r2). A warp skips the rest of a tile once all
//     its C centres have stopped, and the block stops staging once all its
//     warps have (__syncthreads_or);
//   - then the fill: the slots from the count on take the first qualifier
//     (0 when there was none).
// The launch plan (C, and the blocks for a batch of clouds) is computed by
// the caller (grouping.exact_plan) and checked here. The output is an index,
// so there is no backward: the callers group with a gather that autograd
// differentiates.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;    // warps a block
constexpr int kTile = 1024;  // points a stage holds
constexpr int kStages = 2;   // stages in flight: the tile under test and the next

__device__ __forceinline__ float dist2(float4 p, float cx, float cy, float cz) {
  const float dx = __fsub_rn(cx, p.x);
  const float dy = __fsub_rn(cy, p.y);
  const float dz = __fsub_rn(cz, p.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

template <int C>
__global__ void __launch_bounds__(kWarps * 32)
ball_query_exact_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                        int* __restrict__ idx_out, int n, int m, int nsample, float r2,
                        int groups) {
  __shared__ float4 pts[kStages][kTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / groups;
  const int c0 = (blockIdx.x % groups) * kWarps * C + warp * C;  // the warp's first centre
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  const float inf = __int_as_float(0x7f800000);

  float cx[C], cy[C], cz[C];
  int count[C], first[C];
  unsigned live = 0;  // the centres still scanning, a bit each (the same on every lane)
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const bool ok = c0 + i < m;  // a centre past m tests nothing and writes nothing
    const float* c = centers + (static_cast<size_t>(b) * m + (ok ? c0 + i : 0)) * 3;
    cx[i] = ok ? c[0] : inf;
    cy[i] = ok ? c[1] : inf;
    cz[i] = ok ? c[2] : inf;
    count[i] = first[i] = 0;
    if (ok) live |= 1u << i;
  }
  const unsigned below = (1u << lane) - 1u;  // the lanes under this one

  // copy tile t's points into its buffer as x, y, z of a float4, one
  // cp.async group; the points from the cloud's end to the tile's next
  // multiple of 32 get a NaN x, which never qualifies, so a chunk needs no
  // bounds check
  auto stage = [&](int t) {
    float* dst = reinterpret_cast<float*>(pts[t % kStages]);
    const int base = t * kTile, len = min(kTile, n - base);
    const float* src = p + 3 * static_cast<size_t>(base);
    for (int e = threadIdx.x; e < 3 * len; e += kWarps * 32) {
      const int q = e / 3;
      cp_async4(dst + 4 * q + (e - 3 * q), src + e);
    }
    const int pad = len + static_cast<int>(threadIdx.x);
    if (pad < ((len + 31) & ~31)) dst[4 * pad] = __int_as_float(0x7fffffff);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int tiles = (n + kTile - 1) / kTile;
  if (tiles > 0) stage(0);
  for (int t = 0; t < tiles; ++t) {
    // tile t + 1 goes to the buffer that tile t - 1 left (every warp passed
    // the barrier at the end of the last iteration)
    if (t + 1 < tiles) {
      stage(t + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // tile t has landed, from every thread's copies
    const int base = t * kTile, len = min(kTile, n - base);
    const float4* tile = pts[t % kStages];
    for (int j = 0; j < len && live; j += 32) {
      const int at = j + lane;
      const float4 q = tile[at];  // past the cloud: a NaN x
      float d2[C];
      bool any = false;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        d2[i] = dist2(q, cx[i], cy[i], cz[i]);
        any |= d2[i] < r2;
      }
      if (__any_sync(0xffffffffu, any)) {  // uniform over the warp, and rare
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const unsigned hit = __ballot_sync(0xffffffffu, d2[i] < r2);
          if (hit) {
            if (count[i] == 0) first[i] = base + j + __ffs(hit) - 1;
            const int slot = count[i] + __popc(hit & below);
            if (((hit >> lane) & 1u) && slot < nsample)
              idx_out[(static_cast<size_t>(b) * m + c0 + i) * nsample + slot] = base + at;
            count[i] += __popc(hit);
            if (count[i] >= nsample) {  // done: nothing qualifies for it again
              cx[i] = cy[i] = cz[i] = inf;
              live &= ~(1u << i);
            }
          }
        }
      }
    }
    // every warp has finished tile t (its buffer is free for tile t + 2);
    // stop when every warp has all its centres' nsample qualifiers
    if (!__syncthreads_or(live != 0)) break;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");  // no copy outlives the block

#pragma unroll
  for (int i = 0; i < C; ++i) {
    if (c0 + i >= m) break;
    int* out = idx_out + (static_cast<size_t>(b) * m + c0 + i) * nsample;
    const int fill = count[i] > 0 ? first[i] : 0;
    for (int s = count[i] + lane; s < nsample; s += 32) out[s] = fill;
  }
}

using Kernel = void (*)(const float*, const float*, int*, int, int, int, float, int);

Kernel kernel_for(int c) {
  return c == 8   ? ball_query_exact_kernel<8>
         : c == 4 ? ball_query_exact_kernel<4>
         : c == 2 ? ball_query_exact_kernel<2>
                  : ball_query_exact_kernel<1>;
}

}  // namespace

// xyz (batch, n, 3) f32; centers (batch, m, 3) f32; idx_out (batch, m,
// nsample) i32. The plan: centres_per_warp (1, 2, 4 or 8) and groups, the
// blocks a cloud (ceil(m / (8 centres_per_warp))); a plan that does not
// cover m exactly is refused. `launch` (5 ints) receives what was launched:
// blocks, warps a block, centres a warp, the points a stage holds and the
// stages. Returns cudaGetLastError() after the launch.
extern "C" int bq_ball_query_exact(const float* xyz, const float* centers, int* idx_out, int batch,
                                   int n, int m, int nsample, float r2, int centres_per_warp,
                                   int groups, int* launch, void* stream) {
  for (int k = 0; k < 5; ++k) launch[k] = 0;
  const int c = centres_per_warp;
  if (nsample < 1 || batch < 0 || n < 0 || m < 0 || (c != 1 && c != 2 && c != 4 && c != 8) ||
      groups != (m + kWarps * c - 1) / (kWarps * c))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * m == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = static_cast<long long>(batch) * groups;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel_for(c)<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(xyz, centers, idx_out, n, m, nsample, r2,
                                                       groups);
  launch[0] = static_cast<int>(blocks);
  launch[1] = kWarps;
  launch[2] = c;
  launch[3] = kTile;
  launch[4] = kStages;
  return static_cast<int>(cudaGetLastError());
}
