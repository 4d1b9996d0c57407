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
// (40k points, 2048 centres, batch 8) that is ~6.6e8 distance tests, 9
// instructions each without FMA contraction (3 sub, 3 mul, 2 add, a
// compare): ~0.17 ms on the 132 SMs' f32 lanes (33.5e12 instructions/s).
// The coordinates (480 KB a cloud) come from L2; what must not happen is
// that every centre pays for its own loads.
//
// What the design does about it:
//   - a block of 8 warps serves 8 C centres of one cloud, C a warp
//     (coordinates in registers), C the largest of 8, 4, 2, 1 that still
//     gives every SM a block (centres_per_warp): 8 at SA1. It walks the
//     stripes and stages each stripe, up to kChunk points at a time, into
//     shared memory with cp.async, double-buffered: the next piece loads
//     while the warps test this one. A cloud of at most 2 kChunk points is
//     staged whole, once, and walked with no further barrier. The points
//     stay in their x, y, z order (12 bytes); lane i reads words 3i,
//     3i + 1, 3i + 2, and 3 is odd, so the 32 lanes of a load hit 32 banks;
//   - a lane tests its point against the warp's C centres, one
//     __ballot_sync each, all C before any branch (a lane past the piece
//     reads a NaN, which never qualifies): the loads are shared by C centres
//     and the staging by 8 C. Only a chunk with a hit branches. __ffs gives
//     a stripe's first qualifier, and the forward walk ends once all C
//     centres have theirs; for picks == 2 a walk back from the stripe's end
//     (__clz) then stops at each centre's last. Both walks read shared
//     memory, so the backward one costs no second read of the cloud, and
//     it tests fewer points than a forward walk to the end would. (A
//     stripe of several pieces is walked forward to its end, keeping the
//     last qualifier seen.);
//   - clouds of at most kWarpPoints points take one warp per centre with
//     no staging (ball_query_warp_kernel, below), which measured faster
//     there (PERF.md);
//   - the C entry reports the kernel, grid and C it launched; a test may
//     set C, which also takes the staged kernel for a small cloud;
//   - the per-slot results stay in shared memory, and each lane then writes
//     its slots' index, offsets and features, so nothing (b, m, n)-sized is
//     ever stored.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kChunk = 1024;  // points a staged piece holds at most
// clouds of at most this many points take one warp per centre (below)
constexpr int kWarpPoints = 512;
constexpr int kMaxSlots = 64;
constexpr int kBig = 1 << 30;

__device__ __forceinline__ bool qualifies(float px, float py, float pz, float cx, float cy,
                                          float cz, float r2) {
  const float dx = __fsub_rn(px, cx);
  const float dy = __fsub_rn(py, cy);
  const float dz = __fsub_rn(pz, cz);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  return d2 < r2;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// The block's pieces: stripe s is cut into `per_stripe` pieces of kChunk
// points from its start; piece k covers points [begin, end) (empty past n).
struct Piece {
  int stripe, begin, end;
};

__device__ __forceinline__ Piece piece_at(int k, int per_stripe, int width, int n) {
  Piece pc;
  pc.stripe = k / per_stripe;
  const int base = pc.stripe * width;
  pc.begin = base + (k % per_stripe) * kChunk;
  pc.end = min(min(pc.begin + kChunk, base + width), n);
  return pc;
}

// Write one centre's slots from its per-stripe picks (kBig: none): a slot
// whose stripe is empty takes the ball's first qualifier, a ball with none
// index 0 with rel 0 (and point 0's features); a lane per slot.
__device__ __forceinline__ void write_slots(const int* picked, int first_all,
                                            const float* __restrict__ p,
                                            const float* __restrict__ f, int* __restrict__ idx_out,
                                            float* __restrict__ rel, float* __restrict__ fout,
                                            size_t task, int nsample, int nf, float cx, float cy,
                                            float cz, int lane) {
  const bool found_any = first_all < kBig;
  const int fill = found_any ? first_all : 0;
  for (int t = lane; t < nsample; t += 32) {
    const int sel = picked[t];
    const bool missing = sel >= kBig;
    const int id = missing ? fill : sel;
    const size_t slot = task * nsample + t;
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

template <int PICKS, int C>
__global__ void __launch_bounds__(kWarps * 32)
ball_query_stripes_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                          const float* __restrict__ feats, int* __restrict__ idx_out,
                          float* __restrict__ rel, float* __restrict__ fout, int n, int m,
                          int nsample, int stripes, int width, int nf, float r2) {
  __shared__ float pts[2 * kChunk * 3];  // two pieces, or a whole cloud of up to 2 kChunk points
  __shared__ int slots[kWarps][C][kMaxSlots];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (m + kWarps * C - 1) / (kWarps * C);
  const int b = blockIdx.x / groups;
  const int c0 = (blockIdx.x % groups) * kWarps * C + warp * C;  // the warp's first centre
  const float* p = xyz + static_cast<size_t>(b) * n * 3;

  float cx[C], cy[C], cz[C];
  int fst[C], lst[C], first_all[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    // a centre past m sits where no point qualifies (its results are not written)
    const bool ok = c0 + i < m;
    const float* c = centers + (static_cast<size_t>(b) * m + (ok ? c0 + i : 0)) * 3;
    cx[i] = ok ? c[0] : 3.0e38f;
    cy[i] = ok ? c[1] : 3.0e38f;
    cz[i] = ok ? c[2] : 3.0e38f;
    fst[i] = lst[i] = first_all[i] = kBig;
  }

  const int per_stripe = (width + kChunk - 1) / kChunk;
  const int pieces = stripes * per_stripe;
  // copy points [begin, end) to `dst`, as one cp.async group
  auto stage = [&](float* dst, int begin, int end) {
    const float* src = p + 3 * static_cast<size_t>(begin);
    for (int e = threadIdx.x; e < 3 * (end - begin); e += kWarps * 32) cp_async4(dst + e, src + e);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  const bool whole = n <= 2 * kChunk;  // the cloud fits both buffers: staged once
  if (whole) {
    stage(pts, 0, n);
  } else {
    const Piece pc = piece_at(0, per_stripe, width, n);
    stage(pts, pc.begin, pc.end);
  }
  for (int k = 0; k < pieces; ++k) {
    const Piece pc = piece_at(k, per_stripe, width, n);
    if (!whole || k == 0) {
      if (!whole && k + 1 < pieces) {
        const Piece next = piece_at(k + 1, per_stripe, width, n);
        stage(pts + ((k + 1) & 1) * kChunk * 3, next.begin, next.end);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
      __syncthreads();
    }
    const float* buf = whole ? pts + 3 * pc.begin : pts + (k & 1) * kChunk * 3;
    const int len = pc.end - pc.begin;
    // the ballots of the C centres over the 32 points at j (a point past the
    // piece reads x as NaN, so it never qualifies: no branch); returns their or
    auto chunk_hits = [&](int j, unsigned (&hit)[C]) {
      const int at = j + lane;
      const int a = at < len ? 3 * at : 0;
      const float px = at < len ? buf[a] : __int_as_float(0x7fffffff);
      const float py = buf[a + 1], pz = buf[a + 2];
      unsigned any = 0;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        hit[i] = __ballot_sync(0xffffffffu, qualifies(px, py, pz, cx[i], cy[i], cz[i], r2));
        any |= hit[i];
      }
      return any;
    };
    auto all_first = [&]() {
      bool all = true;
#pragma unroll
      for (int i = 0; i < C; ++i) all = all && fst[i] < kBig;
      return all;
    };
    // forward: each centre's first qualifier and, with two picks, the last
    // one seen. The walk ends once all C have their first, except with two
    // picks on a stripe of several pieces (its last qualifier may lie in a
    // later piece)
    const bool early = PICKS == 1 || per_stripe == 1;
    bool done = early && all_first();
    int j = 0;
    for (; j < len && !done; j += 32) {
      unsigned hit[C];
      if (chunk_hits(j, hit)) {  // uniform over the warp, and rare: most balls hold a few points
#pragma unroll
        for (int i = 0; i < C; ++i) {
          if (hit[i] && fst[i] == kBig) fst[i] = pc.begin + j + __ffs(hit[i]) - 1;
          if (PICKS == 2 && hit[i]) lst[i] = pc.begin + j + 31 - __clz(hit[i]);
        }
        done = early && all_first();
      }
    }
    if (PICKS == 2 && j < len) {
      // the forward walk stopped early: walk back from the stripe's end to
      // where it stopped; the first qualifier each centre meets is its last
      int back[C];
#pragma unroll
      for (int i = 0; i < C; ++i) back[i] = kBig;
      bool all_back = false;
      for (int jb = (len - 1) / 32 * 32; jb >= j && !all_back; jb -= 32) {
        unsigned hit[C];
        if (chunk_hits(jb, hit)) {
          all_back = true;
#pragma unroll
          for (int i = 0; i < C; ++i) {
            if (hit[i] && back[i] == kBig) back[i] = pc.begin + jb + 31 - __clz(hit[i]);
            all_back = all_back && back[i] < kBig;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < C; ++i)
        if (back[i] < kBig) lst[i] = back[i];
    }
    if (k % per_stripe == per_stripe - 1) {  // the stripe is walked
      const int s = pc.stripe;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        if (lane == 0) {
          if (PICKS == 2) {
            slots[warp][i][2 * s] = fst[i];
            slots[warp][i][2 * s + 1] = fst[i] < kBig ? lst[i] : kBig;
          } else {
            slots[warp][i][s] = fst[i];
          }
        }
        first_all[i] = min(first_all[i], fst[i]);
        fst[i] = lst[i] = kBig;
      }
    }
    if (!whole) __syncthreads();  // the buffer is free for piece k + 2
  }
  __syncwarp();

  const float* f = nf ? feats + static_cast<size_t>(b) * n * nf : nullptr;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    if (c0 + i >= m) break;
    write_slots(slots[warp][i], first_all[i], p, f, idx_out, rel, fout,
                static_cast<size_t>(b) * m + c0 + i, nsample, nf, cx[i], cy[i], cz[i], lane);
  }
}

// Clouds of at most kWarpPoints points: one warp per (cloud, centre),
// reading the cloud through L1 (the kernel of the first port). At those
// sizes the staged kernel's copy of the cloud into shared memory takes
// longer than the few chunks a warp reads to its stripes' first and last
// qualifiers where balls are dense (SA4: 512 points, radius 1.2). The warp
// walks a stripe 32 points at a time: __ffs gives the first qualifier and
// stops the forward walk; for picks == 2 a backward walk stops at the last
// (__clz).
__global__ void __launch_bounds__(kWarps * 32)
ball_query_warp_kernel(const float* __restrict__ xyz, const float* __restrict__ centers,
                       const float* __restrict__ feats, int* __restrict__ idx_out,
                       float* __restrict__ rel, float* __restrict__ fout, int batch, int n, int m,
                       int nsample, int stripes, int width, int picks, int nf, float r2) {
  __shared__ int slots[kWarps][kMaxSlots];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long task = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (task >= static_cast<long long>(batch) * m) return;  // uniform over the warp
  const int b = static_cast<int>(task / m);
  const float* p = xyz + static_cast<size_t>(b) * n * 3;
  const float cx = centers[3 * task], cy = centers[3 * task + 1], cz = centers[3 * task + 2];
  auto hits = [&](int c, int end) {
    const int i = c + lane;
    return __ballot_sync(0xffffffffu,
                         i < end && qualifies(p[3 * i], p[3 * i + 1], p[3 * i + 2], cx, cy, cz, r2));
  };

  int first_all = kBig;
  for (int s = 0; s < stripes; ++s) {
    const int base = s * width;
    const int end = min(base + width, n);
    int fst = kBig, lst = kBig;
    for (int c = base; c < end; c += 32) {
      const unsigned hit = hits(c, end);
      if (hit) {
        fst = c + __ffs(hit) - 1;
        break;
      }
    }
    if (picks == 2 && fst != kBig) {
      for (int c = base + ((end - 1 - base) / 32) * 32; c >= base; c -= 32) {
        const unsigned hit = hits(c, end);
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
  write_slots(slots[warp], first_all, p, feats ? feats + static_cast<size_t>(b) * n * nf : nullptr,
              idx_out, rel, fout, task, nsample, nf, cx, cy, cz, lane);
}

// Centres a warp takes: the largest of 8, 4, 2, 1 that still makes a
// block for each of the card's `sms` SMs (1 where none does).
int centres_per_warp(long long centres, int sms) {
  for (int c = 8; c > 1; c /= 2)
    if ((centres + kWarps * c - 1) / (kWarps * c) >= sms) return c;
  return 1;
}

using Kernel = void (*)(const float*, const float*, const float*, int*, float*, float*, int, int,
                        int, int, int, int, float);

template <int PICKS>
Kernel kernel_for(int c) {
  return c == 8   ? ball_query_stripes_kernel<PICKS, 8>
         : c == 4 ? ball_query_stripes_kernel<PICKS, 4>
         : c == 2 ? ball_query_stripes_kernel<PICKS, 2>
                  : ball_query_stripes_kernel<PICKS, 1>;
}

}  // namespace

// xyz (b, n, 3) f32; centers (b, m, 3) f32; feats (b, n, nf) f32 or null
// when nf == 0; idx_out (b, m, nsample) i32; rel (b, m, nsample, 3) f32;
// fout (b, m, nsample, nf) f32 or null when nf == 0. stripes * width is the
// padded point count. centres_in: 0 lets the call choose its kernel and
// centres a warp; 1, 2, 4 or 8 takes the staged kernel with that many, at
// any cloud size (for tests). `launch` (4 ints) receives what was launched:
// 1 for the staged kernel or 0 for a warp per centre, blocks, centres a
// warp, and 1 where the cloud was staged whole. Returns cudaGetLastError()
// after the launch.
extern "C" int bq_ball_query_stripes(const float* xyz, const float* centers, const float* feats,
                                     int* idx_out, float* rel, float* fout, int batch, int n,
                                     int m, int nsample, int stripes, int width, int picks, int nf,
                                     float r2, int centres_in, int* launch, void* stream) {
  if (nsample > kMaxSlots || stripes * picks != nsample || (picks != 1 && picks != 2) ||
      (centres_in != 0 && centres_in != 1 && centres_in != 2 && centres_in != 4 &&
       centres_in != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  launch[0] = launch[1] = launch[2] = launch[3] = 0;
  if (static_cast<long long>(batch) * m == 0) return static_cast<int>(cudaSuccess);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kWarpPoints && centres_in == 0) {
    const long long blocks = (static_cast<long long>(batch) * m + kWarps - 1) / kWarps;
    ball_query_warp_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
        xyz, centers, feats, idx_out, rel, fout, batch, n, m, nsample, stripes, width, picks, nf, r2);
    launch[1] = static_cast<int>(blocks);
    launch[2] = 1;
    return static_cast<int>(cudaGetLastError());
  }
  const int c = centres_in ? centres_in : centres_per_warp(static_cast<long long>(batch) * m, sms);
  const long long blocks = static_cast<long long>(batch) * ((m + kWarps * c - 1) / (kWarps * c));
  const Kernel kernel = picks == 2 ? kernel_for<2>(c) : kernel_for<1>(c);
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
      xyz, centers, feats, idx_out, rel, fout, n, m, nsample, stripes, width, nf, r2);
  launch[0] = 1;
  launch[1] = static_cast<int>(blocks);
  launch[2] = c;
  launch[3] = n <= 2 * kChunk;
  return static_cast<int>(cudaGetLastError());
}
