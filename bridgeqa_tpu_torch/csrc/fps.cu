// Farthest-point sampling for Hopper (sm_90a): one thread-block cluster per
// cloud.
//
// Replaces the Pallas kernel bridgeqa_tpu/ops/sampling.py::_fps_kernel
// (reached through _fps_pallas_impl and furthest_point_sample(_with_xyz)).
// It keeps that kernel's semantics bit for bit:
//   - the first index is 0;
//   - NaN coordinates are scrubbed to 0 once;
//   - a point with |p|^2 <= 1e-3 (computed before the scrub) is padding:
//     it is never selected and never updates the distance buffer;
//   - the distance buffer starts at 1e10;
//   - ties go to the lowest index;
//   - the output coordinates are the scrubbed coordinates of each pick.
// Distances are (x-lx)^2 + (y-ly)^2 + (z-lz)^2 rounded after every
// operation (no FMA contraction; the library is also built with
// -fmad=false), so the argmax sees the same floats as the plain version.
//
// What bounds it on this card: the npoint selections form a sequential
// recurrence, so the operations bound (about 0.1 ms per forward) is out of
// reach; what sets the pace is the latency of one selection: the distance
// updates of a slice of the cloud, an argmax over it, and the exchange that
// makes the winner known everywhere.
//
// What the design does about it: a cloud is spread over a cluster of
// `size` blocks, so B clouds use up to 16 B SMs instead of B. The size is
// the largest of 16, 8, 4 and 2 that leaves each block at least one point
// per thread (a larger cluster only adds to the barrier: at 2048 points and
// fewer, clusters of 16 took longer per selection than smaller ones) and of
// which the card holds at least B at once, else the largest such that it
// holds at all, the clusters then running in waves. Each block owns a contiguous 1/size
// slice of the cloud and loads it once: the scrubbed coordinates as
// structure-of-arrays and the distance buffer (-1 for padding) in shared
// memory, so nothing streams from L2 inside the loop (above what shared
// memory holds, the same kernel keeps the slice in a global scratch
// buffer). Each selection:
//   - every thread updates the distances of its points and keeps its best
//     (value, -index);
//   - a warp-shuffle argmax, then one block barrier and warp 0's argmax over
//     the warp winners;
//   - lane p of warp 0 writes the block's winner record (value, index, x, y,
//     z) into slot [j & 1][rank] of block p's shared memory (distributed
//     shared memory);
//   - one cluster barrier (arrive.release / wait.acquire): every record of
//     step j is then visible in every block;
//   - every warp merges the `size` records itself, so the next reference
//     point (its coordinates travel in the record) is known to every thread
//     without another barrier.
// The slots are double-buffered, so one cluster barrier per step is enough:
// a block writes slot j & 1 again only at step j + 2, after every peer has
// passed the barrier of step j + 1 and so has finished reading step j. The
// merge is a total order on (value, -index), so ties go to the lowest global
// index however the cloud is cut.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr float kPaddingNormSq = 1e-3f;
constexpr float kInitDist = 1e10f;
// dynamic shared memory a block may take on sm_90 (227 KB), less the static
// slots and warp winners
constexpr int kMaxDynSmem = 232448 - 2048;
// shared memory per point of a block's slice: x, y, z and the distance
constexpr int kBytesPerPoint = 16;

struct __align__(16) Record {
  float v;
  int i;
  float x, y, z;
  int pad[3];
};

__device__ __forceinline__ float scrub(float v) { return isnan(v) ? 0.0f : v; }

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// (v, i) beats (bv, bi) when it is larger, or equal with a lower index
__device__ __forceinline__ void arg_max_merge(float& bv, int& bi, float v, int i) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

// argmax over the lanes of a warp whose xor distance is below `width`; every
// lane ends with the winner of its group
__device__ __forceinline__ void warp_arg_max(float& v, int& i, int width) {
  for (int off = width / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    arg_max_merge(v, i, ov, oi);
  }
}

// every thread of the cluster: the writes before it (distributed shared
// memory included) are visible to every thread after it
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// xyz (B, n, 3); scratch (B, 4, n) f32, used only where the slices do not
// fit shared memory (in_smem 0); chunk: points per block's slice.
__global__ void __launch_bounds__(kThreads)
fps_cluster_kernel(const float* __restrict__ xyz, float* __restrict__ scratch,
                   int* __restrict__ idx, float* __restrict__ out_xyz, int n, int npoint,
                   int chunk, int in_smem) {
  extern __shared__ float smem_dyn[];
  __shared__ Record slots[2][kMaxCluster];
  __shared__ float warp_val[kWarps];
  __shared__ int warp_idx[kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int size = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / size;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = min(n, rank * chunk), cnt = min(n, lo + chunk) - lo;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  float *xs, *ys, *zs, *ds;
  if (in_smem) {
    xs = smem_dyn;
    ys = xs + chunk;
    zs = ys + chunk;
    ds = zs + chunk;
  } else {
    xs = scratch + static_cast<size_t>(b) * 4 * n + lo;
    ys = xs + n;
    zs = ys + n;
    ds = zs + n;
  }
  int* out_idx = idx + static_cast<size_t>(b) * npoint;
  float* out_p = out_xyz + static_cast<size_t>(b) * npoint * 3;

  for (int i = tid; i < cnt; i += kThreads) {
    const float x = p[3 * (lo + i)], y = p[3 * (lo + i) + 1], z = p[3 * (lo + i) + 2];
    const float mag = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
    ds[i] = mag > kPaddingNormSq ? kInitDist : -1.0f;  // NaN magnitude -> padding
    xs[i] = scrub(x);
    ys[i] = scrub(y);
    zs[i] = scrub(z);
  }
  float lx = scrub(p[0]), ly = scrub(p[1]), lz = scrub(p[2]);
  if (rank == 0 && tid == 0) {
    out_idx[0] = 0;
    out_p[0] = lx;
    out_p[1] = ly;
    out_p[2] = lz;
  }
  // every block of the cluster has started (its shared memory may be
  // written) and this block's slice is loaded
  cluster_barrier();

  for (int j = 1; j < npoint; ++j) {
    float best_v = -INFINITY;
    int best_i = n;
    for (int i = tid; i < cnt; i += kThreads) {
      float t = ds[i];
      if (t >= 0.0f) {  // padding stays at -1: min(-1, d) == -1
        t = fminf(t, sq_dist(xs[i], ys[i], zs[i], lx, ly, lz));
        ds[i] = t;
      }
      if (t > best_v) {  // i grows within a thread: strict > keeps the first
        best_v = t;
        best_i = lo + i;
      }
    }
    warp_arg_max(best_v, best_i, 32);
    if (lane == 0) {
      warp_val[warp] = best_v;
      warp_idx[warp] = best_i;
    }
    __syncthreads();
    Record* slot = &slots[j & 1][0];
    if (warp == 0) {
      float v = lane < kWarps ? warp_val[lane] : -INFINITY;
      int i = lane < kWarps ? warp_idx[lane] : n;
      warp_arg_max(v, i, 32);
      if (lane < size) {
        Record r;
        r.v = v;
        r.i = i;
        const bool mine = i < n;  // else this slice holds no point
        r.x = mine ? xs[i - lo] : 0.0f;
        r.y = mine ? ys[i - lo] : 0.0f;
        r.z = mine ? zs[i - lo] : 0.0f;
        *cluster.map_shared_rank(slot + rank, lane) = r;
      }
    }
    // the records of step j are in every block; this block's warp winners
    // were read before it arrived
    cluster_barrier();
    float v = -INFINITY;
    int i = n;
    if (lane < size) {
      v = slot[lane].v;
      i = slot[lane].i;
    }
    warp_arg_max(v, i, size);
    const unsigned at = __ffs(__ballot_sync(0xffffffffu, lane < size && slot[lane].i == i)) - 1;
    lx = slot[at].x;
    ly = slot[at].y;
    lz = slot[at].z;
    if (rank == 0 && tid == 0) {
      out_idx[j] = i;
      out_p[3 * j] = lx;
      out_p[3 * j + 1] = ly;
      out_p[3 * j + 2] = lz;
    }
  }
}

// `iters` bare cluster barriers: the latency floor of one selection step
__global__ void __launch_bounds__(kThreads) cluster_barrier_kernel(int iters) {
  for (int j = 0; j < iters; ++j) cluster_barrier();
}

cudaLaunchConfig_t launch_config(int clusters, int size, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * size);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = size;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Allow clusters of 16 and the largest dynamic shared memory for `kernel`
// on the current device, once per device.
cudaError_t set_attributes_once(const void* kernel) {
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> done;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  for (const auto& d : done)
    if (d.first == kernel && d.second == device) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
  if (err == cudaSuccess) done.emplace_back(kernel, device);
  return err;
}

// Clusters of `size` blocks with `smem` bytes each that the current device
// holds at once (cudaOccupancyMaxActiveClusters), remembered per device.
cudaError_t coresident(int size, size_t smem, int* count) {
  struct Entry {
    int device, size;
    size_t smem;
    int count;
  };
  static std::mutex mu;
  static std::vector<Entry> known;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  {
    const std::lock_guard<std::mutex> lock(mu);
    for (const Entry& e : known)
      if (e.device == device && e.size == size && e.smem == smem) {
        *count = e.count;
        return cudaSuccess;
      }
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, size, smem, nullptr, &attr);
  err = cudaOccupancyMaxActiveClusters(count, fps_cluster_kernel, &cfg);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  known.push_back({device, size, smem, *count});
  return cudaSuccess;
}

size_t slice_smem(int n, int size) {
  const size_t chunk = (static_cast<size_t>(n) + size - 1) / size;
  const size_t bytes = chunk * kBytesPerPoint;
  return bytes <= static_cast<size_t>(kMaxDynSmem) ? bytes : 0;  // 0: the global-memory slices
}

}  // namespace

// xyz (b, n, 3) f32; scratch (b, 4, n) f32, used only where a block's slice
// of the cloud does not fit shared memory; idx (b, npoint) i32; out_xyz
// (b, npoint, 3) f32. One cluster launch, of clusters of `size_in` blocks
// (2, 4, 8 or 16), or of the size picked from n and the card's occupancy
// where size_in is 0; the size launched and the clusters of that size the card holds at
// once go to *size_out and *coresident_out. Returns the launch's error (a
// refused launch included).
extern "C" int bq_fps(const float* xyz, float* scratch, int* idx, float* out_xyz, int b, int n,
                      int npoint, int size_in, int* size_out, int* coresident_out, void* stream) {
  const void* kernel = reinterpret_cast<const void*>(fps_cluster_kernel);
  cudaError_t err = set_attributes_once(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (size_in != 0 && (size_in < 2 || size_in > kMaxCluster || (size_in & (size_in - 1))))
    return static_cast<int>(cudaErrorInvalidValue);
  int size = 0, count = 0;
  for (int s = kMaxCluster; s >= 2; s /= 2) {
    if (size_in != 0 ? s != size_in : s > 2 && n < s * kThreads) continue;
    int c = 0;
    err = coresident(s, slice_smem(n, s), &c);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (c >= b) {  // the largest size of which all b clusters run at once
      size = s;
      count = c;
      break;
    }
    if (size == 0 && c > 0) {  // else the largest that runs at all, in waves
      size = s;
      count = c;
    }
  }
  *size_out = size;
  *coresident_out = count;
  if (size == 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const size_t smem = slice_smem(n, size);
  const int chunk = (n + size - 1) / size;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(b, size, smem, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel, xyz, scratch, idx, out_xyz, n, npoint, chunk,
                           smem > 0 ? 1 : 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// `clusters` clusters of `size` blocks (the FPS kernel's threads), each
// passing `iters` bare cluster barriers: what one FPS selection step cannot
// go below. Returns the launch's error.
extern "C" int bq_cluster_barrier_loop(int clusters, int size, int iters, void* stream) {
  const void* kernel = reinterpret_cast<const void*>(cluster_barrier_kernel);
  cudaError_t err = set_attributes_once(kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(clusters, size, 0, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, cluster_barrier_kernel, iters);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
