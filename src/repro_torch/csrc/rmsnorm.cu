// rmsnorm: y = x * rsqrt(mean(x^2) + eps) * scale, in float32, cast back
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py (rmsnorm),
// which kept a block of rows and the whole feature dim resident in VMEM
// and needed the row count to divide by its block.  Here any row count
// works, and the row stays in registers instead of VMEM.
//
// Bound: bytes.  The call reads x and writes y once (2 * N * d * elem
// bytes, plus d * 4 of scale); it does ~4 flops a byte, far under the
// ~295 a byte at which an H100 turns compute-bound.  At the prefill shape
// of h2o-danube-3-4b ([4000, 3840] bf16) that is 61 MB, about 18 us at
// 3.35 TB/s; at the decode shape ([4, 3840]) 61 KB, under the cost of
// one launch.
//
// Two routes; kernels/rmsnorm.py::launch_plan picks one and its launch
// shape, and this file checks that the shape fits the route:
//
//   cta     a CTA of `threads` threads per row (warp shuffles, then one
//           shared-memory exchange across the warps), one pass over the
//           row: every row of 16 KB or less whose length is a multiple of
//           16 bytes, with x, scale and out 16-byte aligned.  The grid
//           has a CTA per row, so it spreads four decode rows over four
//           SMs and 4000 prefill rows over all of them.
//   masked  a warp per row that reads the row twice, with 16-byte or
//           element accesses and the tail masked by the loop bound: rows
//           over 16 KB, rows whose length is no multiple of 16 bytes, and
//           operands that are not 16-byte aligned.
//
// The cta route takes one pass over device memory: each thread loads its
// 16-byte vectors of the row into registers (all its loads issued before
// the reduction), sums their squares in float32, and scales the same
// registers once the row's sum is known.  16 KB rows (the reference's
// stated d <= 8192 in bf16) take 4 vectors a thread on 256 threads.  The
// scale is read as float32 whatever x's type, as in the reference, in
// 16-byte vectors: two for each vector of eight bf16 values of x, one for
// four float32 values.  x is loaded with the streaming hint
// (ld.global.cs, evict-first): an SM holds many rows in flight, and with
// the default policy their lines push the scale out of L1, so that every
// row reads it again from L2.  The masked route reads its row twice and
// keeps the default policy, so that the second pass finds the row in L1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowBytes = 16 * 1024;  // the longest row held in registers
constexpr int kCtaVecs = 4;           // 16-byte vectors a thread, cta route
constexpr int kMaxCtaThreads = 256;
enum Route { kCtaRoute = 0, kMaskedRoute = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch casts
}

// 16 bytes of x: 4 float32 or 8 bf16 values.
template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);

  __device__ __forceinline__ static float sumsq(const uint4& u) {
    const T* e = reinterpret_cast<const T*>(&u);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float f = to_f32(e[j]);
      s += f * f;
    }
    return s;
  }

  // x * r * scale for the kN values of `u`; `s` points at their kN
  // scales, 16-byte aligned.
  __device__ __forceinline__ static uint4 scaled(const uint4& u, float r,
                                                 const float* s) {
    float sc[kN];
    const float4* sv = reinterpret_cast<const float4*>(s);
#pragma unroll
    for (int j = 0; j < kN / 4; ++j) {
      const float4 f = __ldg(sv + j);
      sc[4 * j] = f.x;
      sc[4 * j + 1] = f.y;
      sc[4 * j + 2] = f.z;
      sc[4 * j + 3] = f.w;
    }
    const T* e = reinterpret_cast<const T*>(&u);
    uint4 y;
    T* o = reinterpret_cast<T*>(&y);
#pragma unroll
    for (int j = 0; j < kN; ++j) o[j] = from_f32<T>(to_f32(e[j]) * r * sc[j]);
    return y;
  }
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

__device__ __forceinline__ float inv_rms(float ss, int d, float eps) {
  return 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
}

// cta route: one row a CTA; thread t holds vectors t, t + blockDim.x, ...
template <typename T>
__global__ void __launch_bounds__(kMaxCtaThreads)
    rmsnorm_cta(const T* __restrict__ x, const float* __restrict__ scale,
                T* __restrict__ out, int d, float eps) {
  using V = Vec<T>;
  __shared__ float part[kMaxCtaThreads / 32];
  const int64_t row = blockIdx.x;
  const int nvec = d / V::kN;
  const uint4* xv = reinterpret_cast<const uint4*>(x + row * d);
  uint4* yv = reinterpret_cast<uint4*>(out + row * d);

  uint4 v[kCtaVecs];
#pragma unroll
  for (int u = 0; u < kCtaVecs; ++u) {
    const int k = u * blockDim.x + threadIdx.x;
    v[u] = k < nvec ? __ldcs(xv + k) : make_uint4(0, 0, 0, 0);
  }
  float ss = 0.f;
#pragma unroll
  for (int u = 0; u < kCtaVecs; ++u) ss += V::sumsq(v[u]);
  ss = warp_sum(ss);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  ss = 0.f;  // every thread sums the warps' parts in the same order
  for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w) ss += part[w];
  const float r = inv_rms(ss, d, eps);
#pragma unroll
  for (int u = 0; u < kCtaVecs; ++u) {
    const int k = u * blockDim.x + threadIdx.x;
    if (k < nvec) yv[k] = V::scaled(v[u], r, scale + k * V::kN);
  }
}

// masked route: a warp per row, two passes (the second from L1/L2).
template <typename T, bool kVec>
__global__ void rmsnorm_masked(const T* __restrict__ x,
                               const float* __restrict__ scale,
                               T* __restrict__ out, int n, int d, float eps) {
  using V = Vec<T>;
  const int lane = threadIdx.x % 32;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= n) return;
  const T* xr = x + row * d;
  T* yr = out + row * d;

  float ss = 0.f;
  if constexpr (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = lane; i < d / V::kN; i += 32) ss += V::sumsq(__ldg(xv + i));
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
  const float r = inv_rms(warp_sum(ss), d, eps);

  if constexpr (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = lane; i < d / V::kN; i += 32) {
      yv[i] = V::scaled(__ldg(xv + i), r, scale + i * V::kN);
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      yr[i] = from_f32<T>(to_f32(xr[i]) * r * __ldg(scale + i));
    }
  }
}

template <typename T>
cudaError_t launch(const T* x, const float* scale, T* out, int n, int d,
                   float eps, int route, int threads, int rows_per_cta,
                   int vec, cudaStream_t s) {
  const int row_bytes = d * static_cast<int>(sizeof(T));
  const bool fits = vec && row_bytes % 16 == 0 && row_bytes <= kRowBytes;
  const int nvec = row_bytes / 16;
  if (route == kCtaRoute && fits && rows_per_cta == 1 && threads % 32 == 0 &&
      threads <= kMaxCtaThreads && nvec <= kCtaVecs * threads) {
    rmsnorm_cta<T><<<n, threads, 0, s>>>(x, scale, out, d, eps);
  } else if (route == kMaskedRoute && threads == 32 && rows_per_cta >= 1 &&
             rows_per_cta <= 32 && (!vec || row_bytes % 16 == 0)) {
    const dim3 grid((n + rows_per_cta - 1) / rows_per_cta);
    const int block = 32 * rows_per_cta;
    if (vec) {
      rmsnorm_masked<T, true><<<grid, block, 0, s>>>(x, scale, out, n, d, eps);
    } else {
      rmsnorm_masked<T, false><<<grid, block, 0, s>>>(x, scale, out, n, d, eps);
    }
  } else {
    return cudaErrorInvalidValue;  // a plan that does not fit its route
  }
  return cudaGetLastError();
}

}  // namespace

// The arguments of one launch, packed by the Python wrapper into one
// buffer (kernels/lib.py::RMSNORM_ARGS mirrors this layout field by
// field): one ctypes argument instead of twelve.  x [n, d], scale [d]
// float32, out [n, d] like x; all contiguous.  The plan (route, threads a
// row, rows a CTA, 16-byte accesses) comes from
// kernels/rmsnorm.py::launch_plan; `vec` promises d * elem % 16 == 0 and
// 16-byte aligned x, scale and out.
struct RmsnormArgs {
  const void* x;
  const float* scale;
  void* out;
  void* stream;  // a raw cudaStream_t of `device`
  int32_t device;
  int32_t n;
  int32_t d;
  int32_t route;
  int32_t threads;
  int32_t rows_per_cta;
  int32_t vec;
  float eps;
};

namespace {

template <typename T>
int entry(const RmsnormArgs* a) {
  const repro_torch::DeviceGuard guard(a->device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (a->n <= 0 || a->d <= 0) return static_cast<int>(cudaGetLastError());
  return static_cast<int>(launch(
      static_cast<const T*>(a->x), a->scale, static_cast<T*>(a->out), a->n,
      a->d, a->eps, a->route, a->threads, a->rows_per_cta, a->vec,
      static_cast<cudaStream_t>(a->stream)));
}

}  // namespace

// sizeof(RmsnormArgs), which the wrapper checks its layout against.
extern "C" int rmsnorm_args_size() {
  return static_cast<int>(sizeof(RmsnormArgs));
}

// Make `device` current if it is not, launch on `stream` and return
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a plan
// that does not fit its route.
extern "C" int rmsnorm_f32(const RmsnormArgs* a) { return entry<float>(a); }

extern "C" int rmsnorm_bf16(const RmsnormArgs* a) {
  return entry<__nv_bfloat16>(a);
}
