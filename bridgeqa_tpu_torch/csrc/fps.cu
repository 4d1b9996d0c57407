// Farthest-point sampling for Hopper (sm_90a).
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
// What bounds it on this card: the npoint selections are sequential, and
// each one reads the whole cloud (12 B of coordinates and 4 B of distance
// per point; 640 KB per step for a 40k-point cloud) and ends in a
// block-wide argmax. One block owns one cloud, so only B of the 132 SMs
// work (8 at batch 8) and each step is bound by one SM's L2 bandwidth plus
// two block barriers.
//
// What the design does about it: the running distance buffer lives in
// shared memory whenever it fits (40k points = 160 KB of the 227 KB a block
// may take), so only the coordinates stream from L2 (the cloud is 480 KB,
// more than shared memory holds). Padding points carry -1 in the buffer and
// are skipped without a distance computation. The argmax is a warp-shuffle
// reduction on (value, -index) pairs followed by one pass over the 32 warp
// winners. Spreading a cloud over a thread-block cluster, to use more SMs
// at small batch, is left for a later change.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr float kPaddingNormSq = 1e-3f;
constexpr float kInitDist = 1e10f;
// dynamic shared memory a block may take on sm_90 (227 KB)
constexpr int kMaxSmemBytes = 232448;

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

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, float* __restrict__ temp_global,
           int* __restrict__ idx, float* __restrict__ out_xyz, int n, int npoint,
           int temp_in_smem) {
  extern __shared__ float temp_smem[];
  __shared__ float warp_val[kThreads / 32];
  __shared__ int warp_idx[kThreads / 32];
  __shared__ float ref[3];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  float* temp = temp_in_smem ? temp_smem : temp_global + static_cast<size_t>(b) * n;
  int* out_idx = idx + static_cast<size_t>(b) * npoint;
  float* out_p = out_xyz + static_cast<size_t>(b) * npoint * 3;

  for (int i = tid; i < n; i += blockDim.x) {
    const float x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
    const float mag = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
    temp[i] = mag > kPaddingNormSq ? kInitDist : -1.0f;  // NaN magnitude -> padding
  }
  if (tid == 0) {
    const float x = scrub(p[0]), y = scrub(p[1]), z = scrub(p[2]);
    out_idx[0] = 0;
    out_p[0] = x;
    out_p[1] = y;
    out_p[2] = z;
    ref[0] = x;
    ref[1] = y;
    ref[2] = z;
  }
  __syncthreads();

  for (int j = 1; j < npoint; ++j) {
    const float lx = ref[0], ly = ref[1], lz = ref[2];
    float best_v = -INFINITY;
    int best_i = n;
    for (int i = tid; i < n; i += blockDim.x) {
      float t = temp[i];
      if (t >= 0.0f) {  // padding stays at -1: min(-1, d) == -1
        const float d = sq_dist(scrub(p[3 * i]), scrub(p[3 * i + 1]), scrub(p[3 * i + 2]),
                                lx, ly, lz);
        t = fminf(t, d);
        temp[i] = t;
      }
      if (t > best_v) {  // i grows within a thread: strict > keeps the first
        best_v = t;
        best_i = i;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_down_sync(0xffffffffu, best_v, off);
      const int i = __shfl_down_sync(0xffffffffu, best_i, off);
      arg_max_merge(best_v, best_i, v, i);
    }
    if (lane == 0) {
      warp_val[warp] = best_v;
      warp_idx[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best_v = lane < nwarps ? warp_val[lane] : -INFINITY;
      best_i = lane < nwarps ? warp_idx[lane] : n;
      for (int off = 16; off > 0; off >>= 1) {
        const float v = __shfl_down_sync(0xffffffffu, best_v, off);
        const int i = __shfl_down_sync(0xffffffffu, best_i, off);
        arg_max_merge(best_v, best_i, v, i);
      }
      if (lane == 0) {
        const float x = scrub(p[3 * best_i]), y = scrub(p[3 * best_i + 1]),
                    z = scrub(p[3 * best_i + 2]);
        out_idx[j] = best_i;
        out_p[3 * j] = x;
        out_p[3 * j + 1] = y;
        out_p[3 * j + 2] = z;
        ref[0] = x;
        ref[1] = y;
        ref[2] = z;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// xyz (b, n, 3) f32; temp (b, n) f32 scratch, used only when the distance
// buffer does not fit in shared memory; idx (b, npoint) i32; out_xyz
// (b, npoint, 3) f32. Returns cudaGetLastError() after the launch.
extern "C" int bq_fps(const float* xyz, float* temp, int* idx, float* out_xyz, int b, int n,
                      int npoint, void* stream) {
  const size_t smem = static_cast<size_t>(n) * sizeof(float);
  const int in_smem = smem <= static_cast<size_t>(kMaxSmemBytes) - 1024;
  if (in_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fps_kernel<<<b, kThreads, in_smem ? smem : 0, static_cast<cudaStream_t>(stream)>>>(
      xyz, temp, idx, out_xyz, n, npoint, in_smem);
  return static_cast<int>(cudaGetLastError());
}
