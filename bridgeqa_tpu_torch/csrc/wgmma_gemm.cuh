// A Hopper GEMM main loop: Y = epilogue(X * W^T), X (M, K) and W (N, K)
// bf16, row-major, K contiguous in both (W is an nn.Linear weight), f32
// accumulators in registers. The scoring GEMM (scoring_gemm.cu, the kernel
// below) runs on it, and so does the vocabulary pass (vocab_loss.cu), which
// shares setup(), produce() and mainloop() and has its own epilogue. The f32
// products and vocabulary pass (tile_gemm.cuh's 3xTF32 loop on wgmma) share
// the ring, setup(), produce() and the tensor maps, under a config of their
// own.
//
// Shape of the kernel (sm_90a only: wgmma and setmaxnreg need the "a"):
// - TMA loads. One CUtensorMap each for X and W (cuTensorMapEncodeTiled,
//   fetched once through cudaGetDriverEntryPoint, so nothing links libcuda),
//   boxes of 64 K elements (128 bytes) by 128 rows, 128-byte swizzle, passed
//   as __grid_constant__ parameters. TMA zero-fills what lies past M, N or
//   K, so ragged edges need no code in the main loop.
// - A ring of 5 stages (a 128 x 64 tile of X and one of W, 32 KB) in shared
//   memory with a full and an empty mbarrier per stage. One producer thread
//   (warpgroup 0, which gives up its registers with setmaxnreg.dec) waits for
//   a free stage, arms its full barrier with the stage's bytes and issues
//   the two TMA loads, tile after tile.
// - Two consumer warpgroups (setmaxnreg.inc) in ping-pong: each owns whole
//   128 x 128 output tiles, alternately (the block's tiles 0, 2, 4, ... and
//   1, 3, 5, ...), so that one runs its epilogue while the other's products
//   keep the tensor cores busy. A consumer issues wgmma.mma_async.m64n128k16
//   bf16 -> f32 for the two 64-row halves straight from the swizzled stage,
//   keeps one group of products in flight, and frees a stage (one arrive per
//   warp) once the products that read it are done. Two named barriers hand
//   the main loop from one consumer to the other, so that a consumer never
//   waits on a stage more than one round ahead of the ring (a barrier's
//   parity cannot tell rounds two apart).
// - A persistent grid: one block per SM walks the output tiles row-major (N
//   fastest), so the blocks in flight share a few X row panels and all of W
//   in L2, and the producer runs ahead into the next tile.
// - The epilogue: Y = round(act(acc + bias)), act none or exact erf-GELU,
//   or with a residual R, Y = round(R + round(act(acc + bias))), the bias
//   f32 and R and Y bf16 (GELU and the residual are template parameters, so
//   each instantiation is straight-line code). With a residual, a consumer
//   has TMA load R's tile into its output buffer in shared memory during
//   its main loop. The epilogue adds the bias and applies the activation to
//   the accumulators in place, then reads R and writes the rounded tile into
//   that buffer, and two TMA stores write it out, clipping what lies past M
//   and N, while the other consumer's products run. Global memory is touched
//   only by TMA and the bias reads. (Storing 4-byte pairs straight from the
//   accumulator layout, with a bias read per pair, measured slower than the
//   products themselves.) With GELU the epilogue outlasts the other
//   consumer's main loop: ptxas issues the 128 erf chains of a thread one
//   after another, each waiting on its own latencies, however the source or
//   the PTX interleaves them (an f32 stash of half the tile in shared memory
//   did not change that either).
// Needs K % 8 == 0, N % 8 == 0 and 16-byte aligned X, W, R and Y (TMA's
// 16-byte strides and base addresses).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "smem_attribute.cuh"

namespace wg {

using bf16 = __nv_bfloat16;

// The ring's shape (a config of the f32 loop, tile_gemm.cuh's TF32Config,
// has the same members): BK elements of K a stage (128 bytes), LOAD_BYTES of
// TMA loads into each STAGE_BYTES stage (X's tile, then W's at A_BYTES),
// CONSUMER_WARPS arrivals to free a stage, and EXTRA_BARS more barriers of
// EXTRA_COUNT arrivals each after the full and empty ones.
struct Config {
  static constexpr int BM = 128, BN = 128, BK = 64;
  static constexpr int THREADS = 384;        // producer warpgroup + two consumers
  static constexpr int CONSUMER_WARPS = 4;   // arrivals that free a stage: one warpgroup's
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int LOAD_BYTES = STAGE_BYTES;
  static constexpr int STAGES = 5;
  static constexpr int OUT_BYTES = BM * BN * 2;  // a consumer's staged output tile
  static constexpr int EXTRA_BARS = 2, EXTRA_COUNT = 1;  // each consumer's residual tile
  // the tiles start 1024-aligned (the swizzle's period); 1024 bytes of slack
  static constexpr int SMEM_BYTES =
      STAGES * STAGE_BYTES + 2 * OUT_BYTES + 1024 + (2 * STAGES + EXTRA_BARS) * 8;
  static_assert(SMEM_BYTES <= 232448, "shared memory of a block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------------ mbarrier

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed. A wait that never
// ends (a fault in the pipeline) traps after ~2^24 polls, each of which may
// suspend the thread for a while, instead of hanging the card: the launch
// then fails at the next synchronisation.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

// ----------------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// wait until this thread's bulk stores have read their shared memory
// (reads), or have completed
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// --------------------------------------------------------------------- wgmma

// shared-memory matrix descriptor of a K-major tile whose rows are 128 bytes
// (64 bf16) under the 128-byte swizzle: 8-row groups 1024 bytes apart (SBO);
// the leading offset is unused for a swizzled K-major operand. A step of 16
// K elements inside the row adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128, f32, registers) += A (64 x 16) * B (128 x 16)^T, both from
// shared memory through descriptors; D is zero first where scale_d is 0.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// named barrier `id` over both consumer warpgroups (256 threads) or over
// one (128): sync waits, arrive does not
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void consumers_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// 2^x; volatile, so that the compiler computes it and the polynomial before
// it for every value instead of moving them into a branch on the value
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Exact (erf) GELU, 0.5 v (1 + erf(v / sqrt 2)), with an erf that has no
// branch: erff branches on |x|, and a warp whose lanes straddle the branch
// runs both sides. Both pieces are computed and one is selected: x + x q(x^2)
// up to |x| = 0.921875, 1 - 2^p(|x|) above, p a fit of log2 erfc with |x|
// clamped at 3.92 (erf rounds to 1 in f32 there); q and p are weighted
// minimax fits. tests/test_torch_cuda.py holds the result within two f32
// ulp of the erf GELU for |v| up to 6 (erff's own bound: 2 ulp).
__device__ __forceinline__ float gelu_exact(float v) {
  const float x = v * 0.7071067811865475f, s = x * x, u = fminf(fabsf(x), 3.92f);
  float a = fmaf(-5.991816870e-04f, s, 4.993371665e-03f);
  a = fmaf(a, s, -2.676674724e-02f);
  a = fmaf(a, s, 1.128181964e-01f);
  a = fmaf(a, s, -3.761249483e-01f);
  a = fmaf(a, s, 1.283791512e-01f);
  a = fmaf(a, x, x);
  float p = fmaf(2.808980935e-04f, u, -4.373227712e-03f);
  p = fmaf(p, u, 3.199917078e-02f);
  p = fmaf(p, u, -1.498040259e-01f);
  p = fmaf(p, u, -9.194134474e-01f);
  p = fmaf(p, u, -1.626802564e+00f);
  p = fmaf(p, u, -3.034945112e-04f);
  const float b = copysignf(1.0f - ex2_approx(p), x);
  return 0.5f * v * (1.0f + (fabsf(x) > 0.921875f ? b : a));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ----------------------------------------------------------------- main loop
//
// What every kernel on this main loop shares: the ring in shared memory, the
// producer, and each consumer's products of one output tile. A kernel calls
// setup() with all its threads, then produce() in warpgroup 0 and, in each
// consumer warpgroup, mainloop() for each of its tiles before its own
// epilogue.

// The dynamic shared memory: the ring's stages (1024-aligned, the swizzle's
// period), each consumer's output tile, then the barriers: full[s],
// empty[s] and the config's extra ones (bf16: one per consumer for a
// residual tile; f32: split[s]).
template <class C>
struct RingOf {
  uint32_t tiles, out, bars;
  __device__ __forceinline__ uint32_t stage(int s) const { return tiles + s * C::STAGE_BYTES; }
  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8u * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8u * (C::STAGES + s); }
  __device__ __forceinline__ uint32_t extra(int i) const { return bars + 8u * (2 * C::STAGES + i); }
  __device__ __forceinline__ uint32_t residual(int c) const { return extra(c); }
};
using Ring = RingOf<Config>;

// Lay out the ring in `smem_raw` and initialise its barriers; every thread
// of the block calls it (it ends on a block barrier).
template <class C = Config>
__device__ __forceinline__ RingOf<C> setup(unsigned char* smem_raw) {
  RingOf<C> ring;
  ring.tiles = (smem_u32(smem_raw) + 1023u) & ~1023u;
  ring.out = ring.tiles + C::STAGES * C::STAGE_BYTES;
  ring.bars = ring.out + 2 * C::OUT_BYTES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), C::CONSUMER_WARPS);
    }
    for (int i = 0; i < C::EXTRA_BARS; ++i) mbar_init(ring.extra(i), C::EXTRA_COUNT);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return ring;
}

// The producer, warpgroup 0, which gives up its registers: one thread issues
// every load, for the block's `count` tiles in the order the consumers take
// them, the j-th tile's X rows and W rows starting at at(j) = (row0, col0),
// `ktiles` steps of BK each.
template <class C, class At>
__device__ __forceinline__ void produce(const RingOf<C>& ring, const CUtensorMap* map_x,
                                        const CUtensorMap* map_w, int count, int ktiles, At at) {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
  if (threadIdx.x != 0) return;
  tma_prefetch(map_x);
  tma_prefetch(map_w);
  int stage = 0, phase = 0;
  for (int j = 0; j < count; ++j) {
    const int2 tile = at(j);
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(ring.empty(stage), phase ^ 1);
      mbar_expect_tx(ring.full(stage), C::LOAD_BYTES);
      const uint32_t a = ring.stage(stage);
      tma_load_2d(a, map_x, ring.full(stage), kt * C::BK, tile.x);
      tma_load_2d(a + C::A_BYTES, map_w, ring.full(stage), kt * C::BK, tile.y);
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// The products of the block's j-th tile (of `count`) in consumer `me`:
// consumer 0 (warpgroup 1) takes the block's tiles 0, 2, 4, ..., consumer 1
// tiles 1, 3, 5, .... Returns lo, hi = rows 0-63 and 64-127 of the tile's
// X * W^T. The k-th step of tile j sits in stage (j * ktiles + k) % STAGES,
// in that stage's round (j * ktiles + k) / STAGES. Barrier 1 passes the main
// loop from consumer 0 to 1, barrier 2 back, so a consumer never waits on a
// stage more than one round ahead of the ring (a barrier's parity cannot
// tell rounds two apart); the other consumer's main loop starts as soon as
// this one's products are issued, and runs during this one's epilogue.
__device__ __forceinline__ void mainloop(const Ring& ring, int j, int count, int ktiles, int me,
                                         float (&lo)[64], float (&hi)[64]) {
  using C = Config;
  const int lane = threadIdx.x % 32;
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty(s));
  };
  if (j > 0) consumers_sync(me == 0 ? 2 : 1);  // the other's main loop is issued
  int held = 0;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int step = j * ktiles + kt;
    const int stage = step % C::STAGES;
    mbar_wait(ring.full(stage), (step / C::STAGES) & 1);
    const uint32_t a = ring.stage(stage);
    const uint32_t b = a + C::A_BYTES;
    fence_operands(lo);
    fence_operands(hi);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk) {
      const uint64_t db = desc_sw128(b + kk * 32);
      wgmma_m64n128k16(lo, desc_sw128(a + kk * 32), db, kt > 0 || kk > 0);
      wgmma_m64n128k16(hi, desc_sw128(a + 64 * 128 + kk * 32), db, kt > 0 || kk > 0);
    }
    wgmma_commit();
    fence_operands(lo);
    fence_operands(hi);
    if (kt > 0) {  // the products of step kt - 1 are done: free their stage
      wgmma_wait<1>();
      fence_operands(lo);
      fence_operands(hi);
      release(held);
    }
    held = stage;
  }
  if (j + 1 < count) consumers_arrive(me == 0 ? 1 : 2);  // the other may start
  wgmma_wait<0>();
  fence_operands(lo);
  fence_operands(hi);
  release(held);
}

// -------------------------------------------------------------------- kernel

template <bool GELU, bool RESIDUAL>
__global__ void __launch_bounds__(Config::THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
            const __grid_constant__ CUtensorMap map_r, const __grid_constant__ CUtensorMap map_y,
            const float* __restrict__ bias, int m, int n, int k) {
  using C = Config;
  extern __shared__ unsigned char smem_raw[];
  const Ring ring = setup(smem_raw);
  const int ntiles = (n + C::BN - 1) / C::BN;
  const int tiles = (m + C::BM - 1) / C::BM * ntiles;
  const int ktiles = (k + C::BK - 1) / C::BK;
  const int grid = gridDim.x, mine = (tiles - blockIdx.x + grid - 1) / grid;  // the block's tiles
  // the block's j-th tile walks the output tiles row-major (N fastest)
  auto tile_at = [&](int j) {
    const int tile = blockIdx.x + j * grid;
    return make_int2(tile / ntiles * C::BM, tile % ntiles * C::BN);
  };

  if (threadIdx.x / 128 == 0) {
    produce(ring, &map_x, &map_w, mine, ktiles, tile_at);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int me = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    float lo[64], hi[64];  // rows 0-63 and 64-127 of the tile
    const uint32_t out = ring.out + me * C::OUT_BYTES;
    for (int j = me; j < mine; j += 2) {
      const int2 tile = tile_at(j);
      const int row0 = tile.x, col0 = tile.y;
      const bool lead = threadIdx.x % 128 == 0;
      const bool right = col0 + 64 < n;  // the tile's second 64 columns hold some of N
      if (lead) {
        bulk_wait_read();  // this consumer's last stores have read its buffer
        if (RESIDUAL) {
          mbar_expect_tx(ring.residual(me), right ? C::OUT_BYTES : C::OUT_BYTES / 2);
          tma_load_2d(out, &map_r, ring.residual(me), col0, row0);
          if (right) tma_load_2d(out + C::BM * 128, &map_r, ring.residual(me), col0 + 64, row0);
        }
      }
      mainloop(ring, j, mine, ktiles, me, lo, hi);

      // the epilogue, first in place on the accumulators: the bias (thread
      // column pairs col0 + 8 c + 2 (lane % 4), + 1), then the activation
#pragma unroll
      for (int c = 0; c < C::BN / 8; ++c) {
        const int col = col0 + c * 8 + (lane % 4) * 2;
        const float b0 = col < n ? __ldg(bias + col) : 0.f, b1 = col < n ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          lo[4 * c + q] += q % 2 ? b1 : b0;
          hi[4 * c + q] += q % 2 ? b1 : b0;
          if (GELU) {
            lo[4 * c + q] = gelu_exact(lo[4 * c + q]);
            hi[4 * c + q] = gelu_exact(hi[4 * c + q]);
          }
        }
      }
      // then into this consumer's output tile in shared memory, laid out as
      // two 128 x 64 boxes under the 128-byte swizzle (16-byte chunk c of
      // row r at chunk c ^ (r % 8): each warp's 4-byte accesses of 8 rows
      // hit 8 different chunks). Rows and columns past M and N compute
      // values that the TMA stores clip.
      warpgroup_sync(3 + me);  // the buffer is free
      if (RESIDUAL) mbar_wait(ring.residual(me), (j / 2) & 1);
      const int r = warp * 16 + lane / 4;  // r % 8 == lane / 4, for r + 8, + 64, + 72 too
#pragma unroll
      for (int c = 0; c < C::BN / 8; ++c) {
        const uint32_t at =
            out + (c / 8) * (C::BM * 128) + r * 128 + ((c % 8) ^ (lane / 4)) * 16 + (lane % 4) * 4;
        auto put = [&](int dr, float v0, float v1) {
          if (RESIDUAL) {
            uint32_t rv;
            asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(rv) : "r"(at + dr * 128) : "memory");
            const float2 rf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&rv));
            v0 = rf.x + round_bf16(v0);
            v1 = rf.y + round_bf16(v1);
          }
          const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + dr * 128),
                       "r"(*reinterpret_cast<const uint32_t*>(&pair))
                       : "memory");
        };
        put(0, lo[4 * c], lo[4 * c + 1]);
        put(8, lo[4 * c + 2], lo[4 * c + 3]);
        put(64, hi[4 * c], hi[4 * c + 1]);
        put(72, hi[4 * c + 2], hi[4 * c + 3]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the TMA unit
      warpgroup_sync(3 + me);
      if (lead) {
        tma_store_2d(&map_y, out, col0, row0);
        if (right) tma_store_2d(&map_y, out + C::BM * 128, col0 + 64, row0);
        bulk_commit();
      }
    }
    if (threadIdx.x % 128 == 0) bulk_wait();
  }
}

// ---------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded; null
// where the driver has none
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                     : nullptr;
  }();
  return fn;
}

// the map of a row-major (rows, k) bf16 matrix, or f32 where `f32`, in
// boxes of box_rows x 128 bytes (64 bf16 or 32 f32) under the 128-byte
// swizzle. A map depends on nothing but these arguments,
// so the last ones encoded are kept, direct-mapped by their hash: weights,
// and activations that PyTorch's allocator hands out at the same address
// again, cost a lookup instead of a driver call. The C entry is called
// through ctypes, which releases the GIL, so a mutex guards the cache.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int rows, int k, int box_rows,
                            bool f32 = false) {
  struct Entry {
    const void* ptr;
    int rows, k, box_rows;
    bool f32;
    CUtensorMap map;
  };
  constexpr int kEntries = 256;
  static std::mutex mu;
  static Entry cache[kEntries] = {};
  const size_t h = (reinterpret_cast<size_t>(ptr) >> 8) * 0x9E3779B97F4A7C15ull ^
                   static_cast<size_t>(rows) * 31 ^ static_cast<size_t>(k) * 131 ^ box_rows;
  Entry& e = cache[(h >> 32) % kEntries];
  {
    const std::lock_guard<std::mutex> lock(mu);
    if (e.ptr == ptr && e.rows == rows && e.k == k && e.box_rows == box_rows && e.f32 == f32) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  // the encode, a driver call, needs the device's context current on this
  // thread, which no runtime call before it makes so on a thread that has
  // not launched anything yet; cudaSetDevice does
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const int bytes = f32 ? 4 : 2;  // an element's
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k) * bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / bytes), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            2, const_cast<void*>(ptr), dims,
                            strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const std::lock_guard<std::mutex> lock(mu);
  e = Entry{ptr, rows, k, box_rows, f32, *map};
  return cudaSuccess;
}

// Launch gemm_kernel on x (m, k), w (n, k), bias (n,) and the residual
// res (m, n) or null into y (m, n), over a persistent grid of one block per
// SM of the current device at most; x, w, res and y 16-byte aligned.
// Returns cudaGetLastError().
inline cudaError_t launch(const void* x, const void* w, const float* bias, const void* res,
                          void* y, int m, int n, int k, bool gelu, cudaStream_t stream) {
  using C = Config;
  auto kernel = gelu ? (res ? gemm_kernel<true, true> : gemm_kernel<true, false>)
                     : (res ? gemm_kernel<false, true> : gemm_kernel<false, false>);
  cudaError_t err = set_smem_once(reinterpret_cast<const void*>(kernel), C::SMEM_BYTES);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  CUtensorMap map_x, map_w, map_r, map_y;
  if (err == cudaSuccess) err = make_map(&map_x, x, m, k, C::BM);
  if (err == cudaSuccess) err = make_map(&map_w, w, n, k, C::BN);
  if (err == cudaSuccess) err = make_map(&map_y, y, m, n, C::BM);
  if (err == cudaSuccess) err = make_map(&map_r, res ? res : y, m, n, C::BM);
  if (err != cudaSuccess) return err;
  const int tiles = (m + C::BM - 1) / C::BM * ((n + C::BN - 1) / C::BN);
  kernel<<<tiles < sms ? tiles : sms, C::THREADS, C::SMEM_BYTES, stream>>>(map_x, map_w, map_r, map_y,
                                                                         bias, m, n, k);
  return cudaGetLastError();
}

}  // namespace wg
