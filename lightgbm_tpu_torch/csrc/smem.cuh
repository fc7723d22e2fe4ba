// The dynamic shared-memory limit of a kernel, raised once.
//
// The limit (cudaFuncAttributeMaxDynamicSharedMemorySize) is one value per
// kernel for the whole process, shared by every thread. An entry point
// raises it to the most a block of the kernel may take (the card's opt-in
// size less the kernel's static shared memory): the same value from any
// thread, never one launch's size, which a smaller launch on another
// thread could otherwise lower under this one's next, larger launch.
#pragma once

#include <cuda_runtime.h>

namespace lgbt_smem {

constexpr int kMaxDevices = 64;

// Raise the limit of each of the n kernels in fns on the current device,
// once per device and calling thread. raised is the caller's thread_local
// record, one int a device: 0 before, then the least of the kernels'
// limits. *room, where not null, gets that least limit: the most dynamic
// shared memory a launch of any of the kernels may ask for.
inline cudaError_t raise_once(const void* const* fns, int n, int* raised,
                              int* room = nullptr) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (raised[dev] == 0) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e != cudaSuccess) return e;
    int least = optin;
    for (int i = 0; i < n; ++i) {
      cudaFuncAttributes fa;
      e = cudaFuncGetAttributes(&fa, fns[i]);
      if (e != cudaSuccess) return e;
      const int most = optin - static_cast<int>(fa.sharedSizeBytes);
      e = cudaFuncSetAttribute(fns[i],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
      if (e != cudaSuccess) return e;
      least = most < least ? most : least;
    }
    raised[dev] = least;
  }
  if (room != nullptr) *room = raised[dev];
  return cudaSuccess;
}

// One kernel: raise_once over {fn}.
inline cudaError_t raise_once(const void* fn, int* raised) {
  return raise_once(&fn, 1, raised);
}

}  // namespace lgbt_smem
