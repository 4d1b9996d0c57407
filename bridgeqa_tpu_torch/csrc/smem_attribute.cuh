// A kernel's dynamic shared-memory limit, set once per device, and the
// blocks of it an SM holds, asked once per device.
//
// cudaFuncSetAttribute holds per device and costs a driver call, and the
// forward is host-bound, so a wrapper sets it at its first launch on a device
// and reuses the result after; the same goes for the occupancy query. The C
// entries are called through ctypes, which releases the GIL for the call, so
// the records are guarded by a mutex.

#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <vector>

// Set `kernel`'s dynamic shared-memory limit to `bytes` on the current device
// the first time that is asked for there; later calls return that first
// call's result.
inline cudaError_t set_smem_once(const void* kernel, int bytes) {
  struct Done {
    const void* kernel;
    int device, bytes;
    cudaError_t err;
  };
  static std::mutex mu;
  static std::vector<Done> done;
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  for (const Done& d : done)
    if (d.kernel == kernel && d.device == device && d.bytes == bytes) return d.err;
  const cudaError_t set = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done.push_back({kernel, device, bytes, set});
  return set;
}

// Blocks of `kernel` (`threads` threads, `bytes` of dynamic shared memory)
// that one SM of the current device holds at once, into `*blocks`; asked of
// the runtime the first time for each kernel and device.
inline cudaError_t blocks_per_sm_once(const void* kernel, int threads, int bytes, int* blocks) {
  struct Done {
    const void* kernel;
    int device, threads, bytes, blocks;
    cudaError_t err;
  };
  static std::mutex mu;
  static std::vector<Done> done;
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> lock(mu);
  for (const Done& d : done)
    if (d.kernel == kernel && d.device == device && d.threads == threads && d.bytes == bytes) {
      *blocks = d.blocks;
      return d.err;
    }
  int n = 0;
  const cudaError_t got = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, bytes);
  done.push_back({kernel, device, threads, bytes, n, got});
  *blocks = n;
  return got;
}
