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
// What the design does about it: the widest unit (16, 8, 4 or 2 bytes) that
// divides a row and the pointers' alignment, and one thread per unit of the
// output, so neighbouring threads write neighbouring units and read
// neighbouring units of a row. Rows are reused from L2 when indices repeat.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;  // per table; the loop strides over the rest

// one table's output units, and its rows times units, fit 31 bits (checked
// by the entry), so the index arithmetic inside a table is 32-bit
template <typename U>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const U* __restrict__ table, const int* __restrict__ idx, U* __restrict__ out,
                   int n, int rows, int units) {
  const int b = blockIdx.y;
  const int total = rows * units;
  const U* tb = table + static_cast<size_t>(b) * n * units;
  const int* ib = idx + static_cast<size_t>(b) * rows;
  U* ob = out + static_cast<size_t>(b) * total;
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < total; e += gridDim.x * kThreads) {
    const int r = e / units;
    ob[e] = tb[ib[r] * units + (e - r * units)];
  }
}

template <typename U>
int launch(const void* table, const int* idx, void* out, int batch, int n, int rows,
           int row_bytes, cudaStream_t stream) {
  const int units = row_bytes / static_cast<int>(sizeof(U));
  const int total = rows * units;
  const int blocks = total / kThreads + 1 < kMaxBlocks ? total / kThreads + 1 : kMaxBlocks;
  gather_rows_kernel<U><<<dim3(blocks, batch), kThreads, 0, stream>>>(
      static_cast<const U*>(table), idx, static_cast<U*>(out), n, rows, units);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table (batch, n, c), idx (batch, rows) int32 in [0, n), out (batch, rows, c);
// elements of elem_bytes (2 or 4) bytes. Returns cudaGetLastError() after the
// launch.
extern "C" int bq_gather_rows(const void* table, const int* idx, void* out, int batch, int n,
                              int rows, int c, int elem_bytes, void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || rows < 0 || c <= 0 ||
      (elem_bytes != 2 && elem_bytes != 4) ||
      static_cast<long long>(rows) * c * elem_bytes >= (1LL << 31) ||
      static_cast<long long>(n) * c * elem_bytes >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_bytes = c * elem_bytes;
  // the widest unit that divides a row and both pointers' alignment
  const size_t align = reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out) |
                       static_cast<size_t>(row_bytes);
  if (align % 16 == 0) return launch<uint4>(table, idx, out, batch, n, rows, row_bytes, s);
  if (align % 8 == 0) return launch<uint2>(table, idx, out, batch, n, rows, row_bytes, s);
  if (align % 4 == 0) return launch<unsigned>(table, idx, out, batch, n, rows, row_bytes, s);
  if (align % 2 == 0) return launch<unsigned short>(table, idx, out, batch, n, rows, row_bytes, s);
  return static_cast<int>(cudaErrorMisalignedAddress);
}
