// One-time setup per device.  A kernel's function attributes
// (cudaFuncSetAttribute: dynamic shared memory past 48 KB, non-portable
// cluster sizes) belong to the device that is current when they are set,
// so a process that launches on several cards (a stream mesh over them)
// sets them once on each card, not once per process.
#pragma once

#include <mutex>

#include <cuda_runtime.h>

namespace repro {

constexpr int kMaxDevices = 64;

// set() on the current device the first time this call site runs there
// (each lambda is a call site of its own); its result is kept and returned
// on every later call on that device.
template <typename Set>
auto once_per_device(Set set) -> decltype(set()) {
  using Result = decltype(set());
  static std::once_flag flags[kMaxDevices];
  static Result results[kMaxDevices];
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<Result>(e);
  if (dev < 0 || dev >= kMaxDevices) {
    return static_cast<Result>(cudaErrorInvalidDevice);
  }
  std::call_once(flags[dev], [&] { results[dev] = set(); });
  return results[dev];
}

}  // namespace repro
