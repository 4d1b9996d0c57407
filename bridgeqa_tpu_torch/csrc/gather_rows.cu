// Batched row gather for Hopper (sm_90a): out[b, r, :] = table[b, idx[b, r], :],
// copied bit for bit.
//
// Replaces both row gathers of bridgeqa_tpu/ops/gather.py:
//   - _gather_kernel (_gather_rows_one): the table resident in VMEM and
//     rows copied with dynamic sublane loads;
//   - _onehot_gather_kernel (_gather_rows_onehot): the same gather as
//     one-hot products on the MXU, exact in bf16 and a hi + lo bf16 split of
//     about 17 bits in f32. That is a workaround for the TPU's gather; here
//     the exact copy serves both.
// The caller validates the indices (0 <= idx < n).
//
// What bounds it on this card: memory. It reads the indices and the rows
// they pick and writes the output; there is no arithmetic beyond addresses.
//
// What the design does about it (the launch is the plan of
// ops/gather.py::gather_plan, which this entry checks):
//   - a grid of at most 8 blocks an SM whose warps walk the work units
//     (table, block of 32 rows) by the grid's stride; a warp loads the
//     block's 32 indices with one coalesced load and
//     hands each to the lanes that copy its row by a shuffle, so no lane
//     divides per element or loads an index twice;
//   - a row of at most 64 bytes goes to a group of lanes (a power of two, up
//     to 32), one unit a lane in the widest unit (16, 8, 4 or 2 bytes) that
//     divides the row and both base addresses, so every row of the table and
//     of the output is aligned to it; 32 / lanes rows move at once;
//   - a longer row goes to 16 lanes (under 272 bytes: two rows side by side
//     in a warp) or a whole warp and leaves in 16-byte stores aligned in the
//     output: its head (up to the output's next 16-byte boundary) and tail
//     (the last bytes short of 16) move an element a lane; the body reads
//     the aligned 16-byte blocks of the table row, a block a lane, takes the
//     next block from the next lane by a shuffle and realigns the pair
//     through registers (selects and a funnel shift, no branch) to the
//     output's alignment. So a 524-byte f32 row or a 262-byte bf16 row
//     (C = 131) moves in 16-byte units wherever the table row and the output
//     row start. Rows of under 528 bytes (one block a lane) go 4 a group at
//     once, their loads before their stores; longer ones a row at a time,
//     in passes of 32 blocks. A row costs its lanes some hundred
//     instructions of addresses, shuffles and selects whatever its width, so
//     the narrower rows take fewer lanes.
// An aligned 16-byte load never crosses a page: the blocks that hold a
// row's first and last bytes are loaded whole, and their bytes outside the
// row are dropped.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;         // a block
constexpr int kRowsPerUnit = 32;  // rows of a work unit: an index a lane
constexpr int kGroupMaxBytes = 64;
constexpr int kRowsAtOnce = 4;    // rows a group of lanes of the row kernel copies at once
// a row shorter than this has at most 32 aligned 16-byte blocks past its
// head: one block a lane, in one pass of the warp
constexpr int kOnePassBytes = 32 * 16 + 16;
// a row shorter than this has at most 16 such blocks: half a warp a row
constexpr int kHalfWarpBytes = 16 * 16 + 16;
constexpr unsigned kFull = 0xffffffffu;

// the work unit's 32 indices, lane l the row r0 + l's (0 past the rows)
__device__ __forceinline__ int unit_indices(const int* __restrict__ ib, int r0, int rows, int lane) {
  return r0 + lane < rows ? __ldg(ib + r0 + lane) : 0;
}

// rows of at most kGroupMaxBytes: `lanes` lanes a row (at least its units),
// a U a lane, a work unit at a time
template <typename U>
__global__ void __launch_bounds__(kWarps * 32)
gather_groups_kernel(const unsigned char* __restrict__ table, const int* __restrict__ idx,
                     unsigned char* __restrict__ out, int n, int rows, int row_bytes, int lanes,
                     int row_blocks, int work) {
  const int lane = threadIdx.x & 31;
  const int units = row_bytes / static_cast<int>(sizeof(U));
  const int per_step = kRowsPerUnit / lanes;  // rows a warp copies at once
  const int sub = lane & (lanes - 1);         // the lane's unit of its row
  const int slot = lane / lanes;              // the lane's row of a step
  for (int w = blockIdx.x * kWarps + (threadIdx.x >> 5); w < work; w += gridDim.x * kWarps) {
    const int b = w / row_blocks;
    const int r0 = (w - b * row_blocks) * kRowsPerUnit;
    const int mine = unit_indices(idx + static_cast<size_t>(b) * rows, r0, rows, lane);
    const unsigned char* tb = table + static_cast<size_t>(b) * n * row_bytes;
    unsigned char* ob = out + (static_cast<size_t>(b) * rows + r0) * row_bytes;
    for (int s = 0; s < lanes; ++s) {
      const int j = s * per_step + slot;
      const int row = __shfl_sync(kFull, mine, j);
      if (r0 + j < rows) {
        const U* src = reinterpret_cast<const U*>(tb + static_cast<size_t>(row) * row_bytes);
        U* dst = reinterpret_cast<U*>(ob + static_cast<size_t>(j) * row_bytes);
        for (int u = sub; u < units; u += lanes) dst[u] = __ldg(src + u);
      }
    }
  }
}

__device__ __forceinline__ unsigned load_element(const unsigned char* p, int es) {
  return es == 4 ? __ldg(reinterpret_cast<const unsigned*>(p))
                 : __ldg(reinterpret_cast<const unsigned short*>(p));
}

__device__ __forceinline__ void store_element(unsigned char* p, int es, unsigned v) {
  if (es == 4)
    *reinterpret_cast<unsigned*>(p) = v;
  else
    *reinterpret_cast<unsigned short*>(p) = static_cast<unsigned short>(v);
}

// bytes [delta, delta + 16) of the 32 bytes lo ++ hi (delta in 1..15, a
// multiple of the element size), by selects and funnel shifts, no branch
// (the rows side by side in a warp may differ in delta)
__device__ __forceinline__ uint4 realign(uint4 lo, uint4 hi, int delta) {
  const bool two = delta & 8, one = delta & 4;  // whole words to skip: 2, then 1
  const unsigned a0 = two ? lo.z : lo.x, a1 = two ? lo.w : lo.y, a2 = two ? hi.x : lo.z,
                 a3 = two ? hi.y : lo.w, a4 = two ? hi.z : hi.x, a5 = two ? hi.w : hi.y;
  const unsigned v0 = one ? a1 : a0, v1 = one ? a2 : a1, v2 = one ? a3 : a2, v3 = one ? a4 : a3,
                 v4 = one ? a5 : a4;
  const unsigned bits = (delta & 3) * 8;
  return make_uint4(__funnelshift_r(v0, v1, bits), __funnelshift_r(v1, v2, bits),
                    __funnelshift_r(v2, v3, bits), __funnelshift_r(v3, v4, bits));
}

// how a row of more than kGroupMaxBytes is cut: its head (up to the
// output's next 16-byte boundary), its body of 16-byte blocks aligned in
// the output, its tail; and the body's start in the table past an aligned
// address (delta)
struct RowCut {
  int head, body, delta;
};

__device__ __forceinline__ RowCut row_cut(const unsigned char* src, const unsigned char* dst,
                                          int row_bytes) {
  RowCut r;
  r.head = min(static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15), row_bytes);
  r.body = (row_bytes - r.head) >> 4;
  r.delta = static_cast<int>(reinterpret_cast<uintptr_t>(src + r.head) & 15);
  return r;
}

// the element of the head (places 0-7) or of the tail (places 8-15) that
// the lane at place g of its row's lanes copies: its byte offset in the row,
// or -1 (each holds at most 7 elements: es >= 2 and fewer than 16 bytes)
__device__ __forceinline__ int edge_offset(const RowCut& r, int row_bytes, int es, int g) {
  if (g < 8) return g * es < r.head ? g * es : -1;
  if (g < 16) {
    const int at = r.head + (r.body << 4) + (g - 8) * es;
    return at < row_bytes ? at : -1;
  }
  return -1;
}

// rows of kGroupMaxBytes to kOnePassBytes: G lanes a row (16 under
// kHalfWarpBytes, two rows side by side in a warp; else 32), one body block
// a lane, kRowsAtOnce rows a group at once, their loads issued before their
// stores. With delta, the lane at place g loads the aligned block g of the
// table row, takes block g + 1 from the next lane by a shuffle (the last
// lane of a group loads its own) and stores their realigned 16 bytes.
template <int G>
__global__ void __launch_bounds__(kWarps * 32)
gather_rows_kernel(const unsigned char* __restrict__ table, const int* __restrict__ idx,
                   unsigned char* __restrict__ out, int n, int rows, int row_bytes, int es,
                   int row_blocks, int work) {
  constexpr int kSide = 32 / G;  // rows side by side in a warp
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1), slot = lane / G;
  for (int w = blockIdx.x * kWarps + (threadIdx.x >> 5); w < work; w += gridDim.x * kWarps) {
    const int b = w / row_blocks;
    const int r0 = (w - b * row_blocks) * kRowsPerUnit;
    const int mine = unit_indices(idx + static_cast<size_t>(b) * rows, r0, rows, lane);
    const unsigned char* tb = table + static_cast<size_t>(b) * n * row_bytes;
    unsigned char* ob = out + (static_cast<size_t>(b) * rows + r0) * row_bytes;
    const int count = min(kRowsPerUnit, rows - r0);  // the same on every lane
    for (int j0 = 0; j0 < count; j0 += kRowsAtOnce * kSide) {
      const unsigned char* src[kRowsAtOnce];
      uint4 lo[kRowsAtOnce], hi[kRowsAtOnce];
      unsigned edge[kRowsAtOnce];
#pragma unroll
      for (int k = 0; k < kRowsAtOnce; ++k) {
        const int j = j0 + k * kSide + slot;
        src[k] = tb + __shfl_sync(kFull, mine, j & 31) * row_bytes;
        lo[k] = hi[k] = make_uint4(0, 0, 0, 0);
        edge[k] = 0;
        if (j < count) {
          const RowCut r = row_cut(src[k], ob + j * row_bytes, row_bytes);
          const int e = edge_offset(r, row_bytes, es, g);
          if (e >= 0) edge[k] = load_element(src[k] + e, es);
          const uint4* a = reinterpret_cast<const uint4*>(src[k] + r.head - r.delta);
          if (g < r.body || (r.delta && g == r.body)) lo[k] = __ldg(a + g);
          if (r.delta && g == G - 1 && r.body == G) hi[k] = __ldg(a + G);
        }
      }
#pragma unroll
      for (int k = 0; k < kRowsAtOnce; ++k) {
        const int j = j0 + k * kSide + slot;
        uint4 h;  // every lane shuffles: the rows side by side may differ
        h.x = __shfl_down_sync(kFull, lo[k].x, 1, G);
        h.y = __shfl_down_sync(kFull, lo[k].y, 1, G);
        h.z = __shfl_down_sync(kFull, lo[k].z, 1, G);
        h.w = __shfl_down_sync(kFull, lo[k].w, 1, G);
        if (g == G - 1) h = hi[k];
        if (j >= count) continue;
        unsigned char* dst = ob + j * row_bytes;
        const RowCut r = row_cut(src[k], dst, row_bytes);
        const int e = edge_offset(r, row_bytes, es, g);
        if (e >= 0) store_element(dst + e, es, edge[k]);
        if (g < r.body)
          reinterpret_cast<uint4*>(dst + r.head)[g] = r.delta ? realign(lo[k], h, r.delta) : lo[k];
      }
    }
  }
}

// rows of kOnePassBytes or more: a warp a row, a row at a time, the body
// in passes of 32 blocks
__global__ void __launch_bounds__(kWarps * 32)
gather_long_rows_kernel(const unsigned char* __restrict__ table, const int* __restrict__ idx,
                        unsigned char* __restrict__ out, int n, int rows, int row_bytes, int es,
                        int row_blocks, int work) {
  const int lane = threadIdx.x & 31;
  for (int w = blockIdx.x * kWarps + (threadIdx.x >> 5); w < work; w += gridDim.x * kWarps) {
    const int b = w / row_blocks;
    const int r0 = (w - b * row_blocks) * kRowsPerUnit;
    const int mine = unit_indices(idx + static_cast<size_t>(b) * rows, r0, rows, lane);
    const unsigned char* tb = table + static_cast<size_t>(b) * n * row_bytes;
    unsigned char* ob = out + (static_cast<size_t>(b) * rows + r0) * row_bytes;
    const int count = min(kRowsPerUnit, rows - r0);  // the same on every lane
    for (int j = 0; j < count; ++j) {
      const unsigned char* src = tb + static_cast<size_t>(__shfl_sync(kFull, mine, j)) * row_bytes;
      unsigned char* dst = ob + static_cast<size_t>(j) * row_bytes;
      const RowCut r = row_cut(src, dst, row_bytes);
      const int e = edge_offset(r, row_bytes, es, lane);
      if (e >= 0) store_element(dst + e, es, load_element(src + e, es));
      uint4* d = reinterpret_cast<uint4*>(dst + r.head);
      if (r.delta == 0) {
        const uint4* s = reinterpret_cast<const uint4*>(src + r.head);
        for (int c = lane; c < r.body; c += 32) d[c] = __ldg(s + c);
        continue;
      }
      const uint4* a = reinterpret_cast<const uint4*>(src + r.head - r.delta);
      for (int c0 = 0; c0 < r.body; c0 += 32) {  // the same trip count on every lane
        const int c = c0 + lane;
        uint4 lo = make_uint4(0, 0, 0, 0);
        if (c <= r.body) lo = __ldg(a + c);
        uint4 hi;
        hi.x = __shfl_down_sync(kFull, lo.x, 1);
        hi.y = __shfl_down_sync(kFull, lo.y, 1);
        hi.z = __shfl_down_sync(kFull, lo.z, 1);
        hi.w = __shfl_down_sync(kFull, lo.w, 1);
        if (lane == 31 && c + 1 <= r.body) hi = __ldg(a + c + 1);
        if (c < r.body) d[c] = realign(lo, hi, r.delta);
      }
    }
  }
}

template <typename U>
int launch_groups(const void* table, const int* idx, void* out, int n, int rows, int row_bytes,
                  int lanes, int row_blocks, int work, int blocks, cudaStream_t stream) {
  gather_groups_kernel<U><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const unsigned char*>(table), idx, static_cast<unsigned char*>(out), n, rows,
      row_bytes, lanes, row_blocks, work);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (batch, n, c), idx (batch, rows) int32 in [0, n), out (batch, rows, c);
// elements of elem_bytes (2 or 4) bytes. The launch (ops/gather.py::gather_plan):
// unit_bytes and lanes a row (a row of at most 64 bytes: the unit divides the
// row and both addresses, lanes a power of two up to 32; a longer row: 16 and
// 32, a warp a row) and blocks of 8 warps, whose warps walk the work units
// of 32 rows of a table by the grid's stride. Returns cudaGetLastError() after the launch.
extern "C" int bq_gather_rows(const void* table, const int* idx, void* out, int batch, int n,
                              int rows, int c, int elem_bytes, int unit_bytes, int lanes,
                              int blocks, void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || rows < 0 || c <= 0 ||
      (elem_bytes != 2 && elem_bytes != 4) ||
      static_cast<long long>(rows) * c * elem_bytes >= (1LL << 31) ||
      static_cast<long long>(n) * c * elem_bytes >= (1LL << 31) || blocks <= 0 || lanes <= 0 ||
      lanes > 32 || (lanes & (lanes - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_bytes = c * elem_bytes;
  const uintptr_t align = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out);
  if (align % elem_bytes != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_blocks = (rows + kRowsPerUnit - 1) / kRowsPerUnit;
  // the warps' walk over the work units stays inside 31 bits
  if (static_cast<long long>(batch) * row_blocks + 2LL * blocks * kWarps >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int work = batch * row_blocks;
  if (row_bytes > kGroupMaxBytes) {
    if (unit_bytes != 16 || lanes != (row_bytes < kHalfWarpBytes ? 16 : 32))
      return static_cast<int>(cudaErrorInvalidValue);
    const auto kernel = row_bytes < kHalfWarpBytes ? gather_rows_kernel<16>
                        : row_bytes < kOnePassBytes ? gather_rows_kernel<32>
                                                    : gather_long_rows_kernel;
    kernel<<<blocks, kWarps * 32, 0, s>>>(static_cast<const unsigned char*>(table), idx,
                                          static_cast<unsigned char*>(out), n, rows, row_bytes,
                                          elem_bytes, row_blocks, work);
    return static_cast<int>(cudaGetLastError());
  }
  if ((unit_bytes != 2 && unit_bytes != 4 && unit_bytes != 8 && unit_bytes != 16) ||
      unit_bytes < elem_bytes || (align | static_cast<uintptr_t>(row_bytes)) % unit_bytes != 0 ||
      lanes < row_bytes / unit_bytes || (lanes > 1 && lanes / 2 >= row_bytes / unit_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (unit_bytes) {
    case 16: return launch_groups<uint4>(table, idx, out, n, rows, row_bytes, lanes, row_blocks, work, blocks, s);
    case 8: return launch_groups<uint2>(table, idx, out, n, rows, row_bytes, lanes, row_blocks, work, blocks, s);
    case 4: return launch_groups<unsigned>(table, idx, out, n, rows, row_bytes, lanes, row_blocks, work, blocks, s);
    default: return launch_groups<unsigned short>(table, idx, out, n, rows, row_bytes, lanes, row_blocks, work, blocks, s);
  }
}
