// rmsnorm: y = x * rsqrt(mean(x^2) + eps) * scale, in float32, cast back
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py (rmsnorm),
// which kept a block of rows and the whole feature dim resident in VMEM
// and needed the row count to divide by its block.  Here one warp owns
// one row and any row count works: rows are spread over CTAs of 8 warps,
// and a warp past the last row returns.
//
// Bound: bytes.  The call reads x and writes y once (2 * N * d * elem
// bytes, plus d * 4 of scale); it does ~4 flops a byte, far under the
// ~295 a byte at which an H100 turns compute-bound.  At the prefill shape
// of h2o-danube-3-4b ([4000, 3840] bf16) that is 61 MB, about 18 us at
// 3.35 TB/s.  The design is a streaming pass: 16-byte vector loads and
// stores when d * elem is a multiple of 16 (and the rows are 16-byte
// aligned; the wrapper checks), else 2- or 4-byte accesses with the tail
// masked by the loop bound.  The sum of squares is kept in float32 per
// lane and reduced with warp shuffles; the second pass reads the row
// again (it is 7.5 KB at d = 3840, so from L1/L2, not device memory).
// The scale is read as float32 whatever x's type, as in the reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // rows per CTA
constexpr unsigned kFull = 0xffffffffu;

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

template <typename T, bool kVec>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const float* __restrict__ scale,
                               T* __restrict__ out, int n, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  if (row >= n) return;
  const T* xr = x + row * d;
  T* yr = out + row * d;
  constexpr int kPer = 16 / sizeof(T);  // elements in one 16-byte vector

  float ss = 0.f;
  if constexpr (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = lane; i < d / kPer; i += 32) {
      const uint4 u = xv[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float f = to_f32(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      const float f = to_f32(xr[i]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(kFull, ss, o);
  const float r = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);

  if constexpr (kVec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = lane; i < d / kPer; i += 32) {
      const uint4 u = xv[i];
      const T* e = reinterpret_cast<const T*>(&u);
      uint4 w;
      T* f = reinterpret_cast<T*>(&w);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        f[j] = from_f32<T>(to_f32(e[j]) * r * __ldg(scale + i * kPer + j));
      }
      yv[i] = w;
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      yr[i] = from_f32<T>(to_f32(xr[i]) * r * __ldg(scale + i));
    }
  }
}

template <typename T>
int launch(const T* x, const float* scale, T* out, int n, int d, float eps,
           int vec, void* stream) {
  if (n > 0 && d > 0) {
    const dim3 grid((n + kWarps - 1) / kWarps);
    const auto s = static_cast<cudaStream_t>(stream);
    if (vec) {
      rmsnorm_kernel<T, true><<<grid, kWarps * 32, 0, s>>>(x, scale, out, n, d, eps);
    } else {
      rmsnorm_kernel<T, false><<<grid, kWarps * 32, 0, s>>>(x, scale, out, n, d, eps);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [n, d], scale [d] float32, out [n, d] like x; all contiguous.  `vec`
// asks for 16-byte accesses: the caller guarantees d * elem % 16 == 0 and
// 16-byte aligned x and out.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int rmsnorm_f32(const float* x, const float* scale, float* out,
                           int n, int d, float eps, int vec, void* stream) {
  return launch(x, scale, out, n, d, eps, vec, stream);
}

extern "C" int rmsnorm_bf16(const void* x, const float* scale, void* out,
                            int n, int d, float eps, int vec, void* stream) {
  return launch(static_cast<const __nv_bfloat16*>(x), scale,
                static_cast<__nv_bfloat16*>(out), n, d, eps, vec, stream);
}
