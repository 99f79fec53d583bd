// The host side of a lean launch, shared by every kernel's C entry point
// (replay_gather.cu, fused_td.cu, rmsnorm.cu, flash_attention.cu).
//
// The Python wrapper passes the operands' device index and the raw handle
// of that device's current stream; the entry point makes the device
// current only when it is not already (one cudaGetDevice, a thread-local
// read, on the common path), launches, restores the caller's device and
// returns cudaGetLastError().  This takes the place of a
// `with torch.cuda.device(...)` around the call on the Python side.
// Nothing here synchronises or allocates, so the launches can be captured
// in a CUDA graph.

#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceGuard() {
    if (switched_) cudaSetDevice(prev_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  // cudaSuccess unless reading or setting the device failed.
  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool switched_ = false;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace repro_torch
