// replay_gather: out[i, :] = buffer[idx[i], :] * w[i]
//
// Replaces the TPU kernel src/repro/kernels/replay_gather/kernel.py
// (replay_gather), which routed one row DMA per grid step through
// scalar-prefetched indices.  Hopper has no scalar prefetch: each warp
// reads its own index and weight and copies one row.
//
// Bound: bytes.  The call moves 2 * B * F * 4 bytes (each selected row
// read once, each output row written once).  At the fleet's shapes
// (F = 2 * 8^3 + 9 = 1033, B = N * 32 rows) that is about a megabyte, a
// fraction of a microsecond at 3.35 TB/s, so the device time is the
// latency of one round of loads and stores, and the host's launch path
// (kernels/replay_gather.py, launch.cuh) bounds the call.
//
// Design: a warp per row, kWarps rows per CTA.  A row of 1033 floats is
// 4132 bytes, 4 mod 16, so rows start at every 4-byte phase of a 16-byte
// vector: the source row's phase is idx mod 4, the destination's i mod 4
// (for 16-byte aligned bases; the kernel reads both phases from the
// pointers, so any base works).  Each lane loads its share of the row as
// 16-byte vectors aligned on the source, after a scalar head of up to 3
// elements and before a scalar tail of up to 3 (both masked, one element
// a lane), and holds up to kUnroll vectors in registers: every load of a
// lane is issued before its first store.  The stores are 16-byte vectors
// where the destination has the source's phase, else four 4-byte stores
// of each vector (still 16 consecutive bytes a lane; L2 merges them).
// kUnroll * 32 * 4 = 1152 floats hold the fleet's row in one round; a
// longer row takes more rounds.
//
// Index range is the caller's contract (the fleet engine checks it on
// the host before the transfer); the kernel does not clamp.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int kWarps = 4;   // rows per CTA
constexpr int kUnroll = 9;  // 16-byte vectors a lane holds before storing

__global__ void __launch_bounds__(kWarps * 32)
    replay_gather_kernel(const float* __restrict__ buffer,
                         const int32_t* __restrict__ idx,
                         const float* __restrict__ w, float* __restrict__ out,
                         int batch, int feat) {
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarps + threadIdx.x / 32;
  if (i >= batch) return;
  const float* src = buffer + static_cast<int64_t>(__ldg(idx + i)) * feat;
  float* dst = out + static_cast<int64_t>(i) * feat;
  const float wi = __ldg(w + i);

  const int src_phase = (reinterpret_cast<uintptr_t>(src) / 4) % 4;
  const int dst_phase = (reinterpret_cast<uintptr_t>(dst) / 4) % 4;
  const int head = min((4 - src_phase) % 4, feat);  // scalars before the body
  const int nvec = (feat - head) / 4;                // 16-byte body vectors
  const int tail = head + 4 * nvec;                  // first tail element
  const bool vec_store = src_phase == dst_phase;
  const float4* sv = reinterpret_cast<const float4*>(src + head);

  // the head on lanes 0-2, the tail on lanes 4-6
  int edge = -1;
  if (lane < head) {
    edge = lane;
  } else if (lane >= 4 && lane - 4 < feat - tail) {
    edge = tail + lane - 4;
  }
  const float e = edge >= 0 ? __ldg(src + edge) : 0.f;

  for (int base = 0; base < nvec; base += 32 * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = base + u * 32 + lane;
      v[u] = k < nvec ? __ldg(sv + k) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = base + u * 32 + lane;
      if (k >= nvec) continue;
      const float4 y = make_float4(v[u].x * wi, v[u].y * wi, v[u].z * wi,
                                   v[u].w * wi);
      float* d = dst + head + 4 * k;
      if (vec_store) {
        *reinterpret_cast<float4*>(d) = y;
      } else {
        d[0] = y.x;
        d[1] = y.y;
        d[2] = y.z;
        d[3] = y.w;
      }
    }
  }
  if (edge >= 0) dst[edge] = e * wi;
}

}  // namespace

// The arguments of one launch, packed by the Python wrapper into one
// buffer (kernels/lib.py::REPLAY_GATHER_ARGS mirrors this layout field by
// field): one ctypes argument instead of eight.
struct ReplayGatherArgs {
  const float* buffer;  // [cap, feat]
  const int32_t* idx;   // [batch]
  const float* w;       // [batch]
  float* out;           // [batch, feat]
  void* stream;         // a raw cudaStream_t of `device`
  int32_t device;
  int32_t batch;
  int32_t feat;
};

// sizeof(ReplayGatherArgs), which the wrapper checks its layout against.
extern "C" int replay_gather_args_size() {
  return static_cast<int>(sizeof(ReplayGatherArgs));
}

// Makes `device` current if it is not, launches on `stream` and returns
// cudaGetLastError() (0 on success).  All tensors contiguous.
extern "C" int replay_gather_f32(const ReplayGatherArgs* a) {
  const repro_torch::DeviceGuard guard(a->device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (a->batch > 0 && a->feat > 0) {
    const int grid = (a->batch + kWarps - 1) / kWarps;
    replay_gather_kernel<<<grid, kWarps * 32, 0,
                           static_cast<cudaStream_t>(a->stream)>>>(
        a->buffer, a->idx, a->w, a->out, a->batch, a->feat);
  }
  return static_cast<int>(cudaGetLastError());
}
