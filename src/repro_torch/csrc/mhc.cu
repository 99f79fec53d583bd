// mhc: kernel G, one site of the manifold-constrained hyper-connection
// residual (mHC, models/hyper.py) in two launches.
//
// Per token, with the stream X of n = 4 rows of C, the site's projection
// phi [n C, 24], group scales alpha [3], bias b [24] and norm scale w [n C]
// (all float32):
//
//   h     = alpha (.) (RMSNorm_{nC}(vec X) phi) + b     (alpha by group)
//   H_pre = sigmoid(h[0:n]),  H_post = 2 sigmoid(h[n:2n])
//   H_res = Sinkhorn(exp(clamp(h[2n:], lo, hi)))         (n x n)
//   u     = H_pre X                                       mhc_pre_kernel
//   X'    = H_res X + H_post^T y                          mhc_post_kernel
//
// Sinkhorn: kIters alternations of M <- M / (row sums + kEps), then
// M <- M / (column sums + kEps); (lo, hi) is (kClampLo, kClampHi).  These
// are Xing4.0's published hc_sinkhorn_iters, hc_eps and
// mhc_h_res_clamp_*, fixed here as in kernels/mhc.py.  Everything in
// float32; X, u, y and X' in the stream's dtype.
//
// New in the port: the TPU kernels of the repo have no hyper-connection.
// Without it a site is ~50 library kernels (the Sinkhorn's 20 alternations
// alone 40), ~4,000 launches a decode step of a 40-layer model.
//
// Bound.  mhc_pre: the 24-column projection is a [T, n C] x [n C, 24]
// product in float32 FFMA (the card's 67 TFLOP/s outside the tensor
// cores): at a prefill's T in the hundred thousands it is bound by
// operations (2 x 24 flops an element of X against 2 bytes), at decode's
// T 128 by the latency of reading phi (1.4 MB) and X (3.7 MB).  mhc_post:
// bytes (X and y read, X' written).
//
// mhc_pre_kernel: a CTA of 8 warps takes 8 x RW rows (RW 1 or 4: warp w
// rows w RW .. w RW + RW - 1) and a slice of the n C columns of X, tile
// by tile: 256 rows of phi (scaled by nothing: w is applied to X) staged
// in shared memory at a stride of 28 floats (conflict-free 16-byte reads
// by 8 lanes), lane l taking the columns l, l + 32, ... of the tile, each
// thread summing RW x 24 products and RW squares in registers.  Warp sums
// give each row's 25 values.  Where the slices are many (splits > 1, a
// decode's few rows spread over the card), each CTA writes its partial
// sums, and the last CTA of a row block to finish (an atomic counter a
// row block, left at zero again) adds them up.  That CTA, a warp a row,
// forms h in lanes 0..7 (H_pre, H_post) and 16..31 (H_res, row-major:
// row sums by xor-shuffles 1 and 2, column sums by 4 and 8), runs the
// Sinkhorn in registers, writes H_post and H_res, and then computes u
// for its rows from X again, 16 bytes a thread.
//
// mhc_post_kernel: a CTA a token; its H_res and H_post in shared memory,
// each thread 16 bytes of each of the n rows of X and of y at a time,
// X' written with the streaming hint.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int kN = 4;                    // the stream's rows
constexpr int kCols = 2 * kN + kN * kN;  // h: 24 values a token
constexpr int kVals = kCols + 1;         // and the sum of squares
constexpr int kResLane = 16;             // H_res's first lane in a warp
constexpr int kSsLane = 8;               // the lane that carries the squares
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 256;  // rows of phi a shared-memory tile
constexpr int kLd = 28;     // a tile row's stride in floats
constexpr int kPostThreads = 128;
constexpr int kIters = 20;         // Sinkhorn alternations
constexpr float kEps = 1e-6f;      // added to each Sinkhorn sum
constexpr float kClampLo = -30.f;  // h_res clamped before its exp
constexpr float kClampHi = 30.f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kN * kN == 32 - kResLane, "H_res fills lanes 16..31");
static_assert(kCols % 4 == 0, "phi's rows are whole 16-byte vectors");

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

// 16 bytes of the stream: 4 float32 or 8 bf16 values.
template <typename T>
struct Vec {
  static constexpr int kLen = 16 / sizeof(T);

  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int i = 0; i < kLen; ++i) f[i] = to_f32(e[i]);
  }

  __device__ __forceinline__ static uint4 pack(const float* f) {
    uint4 v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int i = 0; i < kLen; ++i) e[i] = from_f32<T>(f[i]);
    return v;
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// x [t, n, c] (k = n c), phi [k, 24], alpha [3], bias [24], w [k] float32;
// u [t, c] like x, h_post [t, n], h_res [t, n, n] float32.  partial
// [splits, t, 25] and counters [row blocks] only when gridDim.y > 1.
template <typename T, int RW>
__global__ void __launch_bounds__(kThreads, RW == 1 ? 2 : 1)
    mhc_pre_kernel(const T* __restrict__ x, const float* __restrict__ phi,
                   const float* __restrict__ alpha, const float* __restrict__ bias,
                   const float* __restrict__ w, T* __restrict__ u,
                   float* __restrict__ h_post, float* __restrict__ h_res,
                   float* __restrict__ partial, int* __restrict__ counters, int t,
                   int c, int tiles_per_split, float norm_eps) {
  constexpr int kRows = kWarps * RW;
  __shared__ __align__(16) float sphi[kTile * kLd];
  __shared__ float sw[kTile];
  __shared__ float spre[kRows][kN];
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = kN * c;
  const int row0 = blockIdx.x * kRows;
  const int k0 = blockIdx.y * tiles_per_split * kTile;
  const int k1 = min(k, k0 + tiles_per_split * kTile);

  float acc[RW][kCols], ss[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    ss[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;
  }

  for (int kt = k0; kt < k1; kt += kTile) {
    __syncthreads();  // the last tile's readers are done
    for (int i = tid; i < kTile * (kCols / 4); i += kThreads) {
      const int r = i / (kCols / 4), q = i - r * (kCols / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kt + r < k1) {
        v = __ldg(reinterpret_cast<const float4*>(phi + static_cast<size_t>(kt + r) * kCols) + q);
      }
      *reinterpret_cast<float4*>(sphi + r * kLd + 4 * q) = v;
    }
    for (int i = tid; i < kTile; i += kThreads) sw[i] = kt + i < k1 ? __ldg(w + kt + i) : 0.f;
    __syncthreads();
#pragma unroll 2
    for (int i = 0; i < kTile / 32; ++i) {
      const int kk = lane + 32 * i;
      if (kt + kk < k1) {
        float p[kCols];
#pragma unroll
        for (int q = 0; q < kCols / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(sphi + kk * kLd + 4 * q);
          p[4 * q] = v.x;
          p[4 * q + 1] = v.y;
          p[4 * q + 2] = v.z;
          p[4 * q + 3] = v.w;
        }
        const float wk = sw[kk];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const int row = row0 + warp * RW + r;
          const float xv = row < t ? to_f32(x[static_cast<size_t>(row) * k + kt + kk]) : 0.f;
          ss[r] = fmaf(xv, xv, ss[r]);
          const float xs = xv * wk;
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(xs, p[j], acc[r][j]);
        }
      }
    }
  }

  // each row's 25 sums in every lane of its warp
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    ss[r] = warp_sum(ss[r]);
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = warp_sum(acc[r][j]);
  }
  // lane -> its coefficient: 0..7 H_pre and H_post, 16..31 H_res; -1 none
  const int col = lane < 2 * kN ? lane : (lane >= kResLane ? 2 * kN + lane - kResLane : -1);
  float mine[RW], sumsq[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) v = j == col ? acc[r][j] : v;
    mine[r] = v;
    sumsq[r] = ss[r];
  }

  if (gridDim.y > 1) {
    // this slice's sums out; the row block's last CTA adds them up
    const int slot = col >= 0 ? col : kCols;
    const bool writes = col >= 0 || lane == kSsLane;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int row = row0 + warp * RW + r;
      if (row < t && writes) {
        partial[(static_cast<size_t>(blockIdx.y) * t + row) * kVals + slot] =
            col >= 0 ? mine[r] : sumsq[r];
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(counters + blockIdx.x, 1) == static_cast<int>(gridDim.y) - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int row = row0 + warp * RW + r;
      float v = 0.f;
      if (row < t && writes) {
        for (int s = 0; s < static_cast<int>(gridDim.y); ++s) {
          v += __ldcg(partial + (static_cast<size_t>(s) * t + row) * kVals + slot);
        }
      }
      mine[r] = v;
      sumsq[r] = __shfl_sync(kFull, v, kSsLane);
    }
    if (tid == 0) counters[blockIdx.x] = 0;  // ready for the next launch
  }

  // the coefficients, a warp a row
  const int group = col < kN ? 0 : (col < 2 * kN ? 1 : 2);
  const float a = col >= 0 ? __ldg(alpha + group) : 0.f;
  const float b = col >= 0 ? __ldg(bias + col) : 0.f;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int rl = warp * RW + r, row = row0 + rl;
    const float scale = rsqrtf(sumsq[r] / static_cast<float>(k) + norm_eps);
    const float h = col >= 0 ? mine[r] * scale * a + b : 0.f;
    float m = expf(fminf(fmaxf(h, kClampLo), kClampHi));
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      float s = m + __shfl_xor_sync(kFull, m, 1);
      s += __shfl_xor_sync(kFull, s, 2);
      m = m / (s + kEps);
      s = m + __shfl_xor_sync(kFull, m, 4);
      s += __shfl_xor_sync(kFull, s, 8);
      m = m / (s + kEps);
    }
    if (row < t) {
      if (col >= 0 && col < kN) spre[rl][col] = sigmoid(h);
      if (col >= kN && col < 2 * kN) h_post[static_cast<size_t>(row) * kN + col - kN] = 2.f * sigmoid(h);
      if (lane >= kResLane) h_res[static_cast<size_t>(row) * kN * kN + lane - kResLane] = m;
    }
  }
  __syncthreads();

  // u = H_pre X for the CTA's rows, 16 bytes a thread
  constexpr int kV = Vec<T>::kLen;
  const int cv = c / kV;
  for (int i = tid; i < kRows * cv; i += kThreads) {
    const int rl = i / cv, row = row0 + rl, ci = i - rl * cv;
    if (row >= t) continue;
    const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * k) + ci;
    float out[kV];
#pragma unroll
    for (int e = 0; e < kV; ++e) out[e] = 0.f;
#pragma unroll
    for (int s = 0; s < kN; ++s) {
      float xv[kV];
      Vec<T>::unpack(__ldg(xr + s * cv), xv);
      const float hp = spre[rl][s];
#pragma unroll
      for (int e = 0; e < kV; ++e) out[e] = fmaf(hp, xv[e], out[e]);
    }
    reinterpret_cast<uint4*>(u + static_cast<size_t>(row) * c)[ci] = Vec<T>::pack(out);
  }
}

// x [t, n, c], y [t, c] like x, h_post [t, n], h_res [t, n, n] float32;
// out [t, n, c] like x.  A CTA a token.
template <typename T>
__global__ void __launch_bounds__(kPostThreads)
    mhc_post_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    const float* __restrict__ h_post, const float* __restrict__ h_res,
                    T* __restrict__ out, int c) {
  __shared__ float sres[kN * kN], spost[kN];
  const size_t row = blockIdx.x;
  if (threadIdx.x < kN * kN) sres[threadIdx.x] = h_res[row * kN * kN + threadIdx.x];
  if (threadIdx.x < kN) spost[threadIdx.x] = h_post[row * kN + threadIdx.x];
  __syncthreads();
  constexpr int kV = Vec<T>::kLen;
  const int cv = c / kV;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * kN * c);
  const uint4* yr = reinterpret_cast<const uint4*>(y + row * c);
  uint4* orow = reinterpret_cast<uint4*>(out + row * kN * c);
  for (int i = threadIdx.x; i < cv; i += kPostThreads) {
    float xv[kN][kV], yv[kV];
#pragma unroll
    for (int s = 0; s < kN; ++s) Vec<T>::unpack(__ldcs(xr + s * cv + i), xv[s]);
    Vec<T>::unpack(__ldcs(yr + i), yv);
#pragma unroll
    for (int a = 0; a < kN; ++a) {
      float o[kV];
#pragma unroll
      for (int e = 0; e < kV; ++e) {
        float acc = sres[a * kN] * xv[0][e];
#pragma unroll
        for (int s = 1; s < kN; ++s) acc = fmaf(sres[a * kN + s], xv[s][e], acc);
        o[e] = fmaf(spost[a], yv[e], acc);
      }
      __stcs(orow + a * cv + i, Vec<T>::pack(o));
    }
  }
}

}  // namespace

// The arguments of one launch of each kernel, packed by the Python
// wrapper into one buffer (kernels/lib.py::MHC_PRE_ARGS and MHC_POST_ARGS
// mirror these layouts field by field).  All operands contiguous; x, phi,
// u, y and out 16-byte aligned (alpha, bias, norm, H_post and H_res are
// read element by element: a group's slice of stacked leaves); c a
// multiple of 16 bytes of the stream's type, n 4.
// The plan (rows a warp, slices, tiles a slice) comes from
// kernels/mhc.py::pre_plan; partial and counters may be null for one slice.
struct MhcPreArgs {
  const void* x;
  const float* phi;
  const float* alpha;
  const float* bias;
  const float* norm;
  void* u;
  float* h_post;
  float* h_res;
  float* partial;
  int32_t* counters;
  void* stream;  // a raw cudaStream_t of `device`
  int32_t device;
  int32_t t;
  int32_t c;
  int32_t n;
  int32_t rows_per_warp;
  int32_t splits;
  int32_t tiles_per_split;
  float norm_eps;
};

struct MhcPostArgs {
  const void* x;
  const void* y;
  const float* h_post;
  const float* h_res;
  void* out;
  void* stream;  // a raw cudaStream_t of `device`
  int32_t device;
  int32_t t;
  int32_t c;
  int32_t n;
};

namespace {

template <typename T>
int pre_entry(const MhcPreArgs* a) {
  const repro_torch::DeviceGuard guard(a->device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (a->t <= 0) return static_cast<int>(cudaGetLastError());
  const bool sliced = a->splits > 1;
  if (a->n != kN || a->c <= 0 || a->c % Vec<T>::kLen || a->splits < 1 ||
      a->splits > 65535 || a->tiles_per_split < 1 ||
      (sliced && (a->partial == nullptr || a->counters == nullptr)) ||
      (a->rows_per_warp != 1 && a->rows_per_warp != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = kWarps * a->rows_per_warp;
  const dim3 grid((a->t + rows - 1) / rows, a->splits);
  const auto s = static_cast<cudaStream_t>(a->stream);
  const T* x = static_cast<const T*>(a->x);
  T* u = static_cast<T*>(a->u);
  if (a->rows_per_warp == 1) {
    mhc_pre_kernel<T, 1><<<grid, kThreads, 0, s>>>(
        x, a->phi, a->alpha, a->bias, a->norm, u, a->h_post, a->h_res, a->partial,
        a->counters, a->t, a->c, a->tiles_per_split, a->norm_eps);
  } else {
    mhc_pre_kernel<T, 4><<<grid, kThreads, 0, s>>>(
        x, a->phi, a->alpha, a->bias, a->norm, u, a->h_post, a->h_res, a->partial,
        a->counters, a->t, a->c, a->tiles_per_split, a->norm_eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int post_entry(const MhcPostArgs* a) {
  const repro_torch::DeviceGuard guard(a->device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (a->t <= 0) return static_cast<int>(cudaGetLastError());
  if (a->n != kN || a->c <= 0 || a->c % Vec<T>::kLen) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mhc_post_kernel<T><<<a->t, kPostThreads, 0, static_cast<cudaStream_t>(a->stream)>>>(
      static_cast<const T*>(a->x), static_cast<const T*>(a->y), a->h_post, a->h_res,
      static_cast<T*>(a->out), a->c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sizeof(MhcPreArgs) and sizeof(MhcPostArgs), which the wrapper checks
// its layouts against.
extern "C" int mhc_pre_args_size() { return static_cast<int>(sizeof(MhcPreArgs)); }
extern "C" int mhc_post_args_size() { return static_cast<int>(sizeof(MhcPostArgs)); }

// Make `device` current if it is not, launch on `stream` and return
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for shapes
// or a plan the kernel does not take.  The suffix names the stream's type.
extern "C" int mhc_pre_f32(const MhcPreArgs* a) { return pre_entry<float>(a); }
extern "C" int mhc_pre_bf16(const MhcPreArgs* a) { return pre_entry<__nv_bfloat16>(a); }
extern "C" int mhc_post_f32(const MhcPostArgs* a) { return post_entry<float>(a); }
extern "C" int mhc_post_bf16(const MhcPostArgs* a) { return post_entry<__nv_bfloat16>(a); }
