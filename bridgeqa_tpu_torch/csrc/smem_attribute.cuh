// A kernel's dynamic shared-memory limit, set once per device.
//
// cudaFuncSetAttribute holds per device and costs a driver call, and the
// forward is host-bound, so a wrapper sets it at its first launch on a device
// and reuses the result after. The C entries are called through ctypes, which
// releases the GIL for the call, so the record is guarded by a mutex.

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
