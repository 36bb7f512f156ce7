// Dynamic shared memory above 48 KB for the attention kernels' launchers.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace repro {

constexpr int kMaxDevices = 64;

// The current device, read once per C entry call and handed to every
// allow_smem of that call.
inline cudaError_t current_device(int* dev) {
  const cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  return *dev < kMaxDevices ? cudaSuccess : cudaErrorInvalidDevice;
}

// One kernel's opt-in state: bit d of `done` is set once the kernel may use
// device d's whole opt-in dynamic shared memory, `optin[d]` is that size.
struct SmemOptin {
  std::atomic<unsigned long long> done{0};
  std::atomic<int> optin[kMaxDevices] = {};
};

// Allow `kern` device `dev`'s whole opt-in dynamic shared memory (227 KB
// on Hopper) on its first launch there, then check that the `need` bytes
// of this launch fit. A launch on a device where that is done makes no
// runtime call.
template <typename Kern>
inline cudaError_t allow_smem(Kern kern, int dev, size_t need,
                              SmemOptin& state) {
  const unsigned long long bit = 1ull << dev;
  if (!(state.done.load(std::memory_order_acquire) & bit)) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    state.optin[dev].store(optin, std::memory_order_relaxed);
    state.done.fetch_or(bit, std::memory_order_release);
  }
  return need > (size_t)state.optin[dev].load(std::memory_order_relaxed)
             ? cudaErrorInvalidValue
             : cudaSuccess;
}

}  // namespace repro
