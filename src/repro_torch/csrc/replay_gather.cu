// replay_gather: out[i, :] = buffer[idx[i], :] * w[i]
//
// Replaces the TPU kernel src/repro/kernels/replay_gather/kernel.py
// (replay_gather), which routed one row DMA per grid step through
// scalar-prefetched indices.  Hopper has no scalar prefetch: each block
// reads its own index and weight and copies one row.
//
// Bound: bytes.  The call moves 2 * B * F * 4 bytes (each selected row
// read once, each output row written once).  At the fleet's shapes
// (F = 2 * 8^3 + 9 = 1033, B = N * 32 rows) that is about a megabyte, a
// fraction of a microsecond at 3.35 TB/s, so the launch itself bounds
// the call.  The design keeps the copy coalesced: consecutive threads
// load and store consecutive 4-byte words of the row, with the tail
// masked by the loop bound.  A row stride of 1033 floats is not 16-byte
// aligned, so float4 loads or TMA would need a padded pool stride.
//
// Index range is the caller's contract (the fleet engine checks it on
// the host before the transfer); the kernel does not clamp.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void replay_gather_kernel(const float* __restrict__ buffer,
                                     const int32_t* __restrict__ idx,
                                     const float* __restrict__ w,
                                     float* __restrict__ out, int feat) {
  const int i = blockIdx.x;
  const float* src = buffer + static_cast<int64_t>(__ldg(idx + i)) * feat;
  float* dst = out + static_cast<int64_t>(i) * feat;
  const float wi = __ldg(w + i);
  for (int j = threadIdx.x; j < feat; j += kThreads) {
    dst[j] = __ldg(src + j) * wi;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int replay_gather_f32(const float* buffer, const int32_t* idx,
                                 const float* w, float* out, int batch,
                                 int feat, void* stream) {
  if (batch > 0 && feat > 0) {
    replay_gather_kernel<<<batch, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(buffer, idx, w,
                                                                out, feat);
  }
  return static_cast<int>(cudaGetLastError());
}
