// kda_step: one recurrent step of Kimi Delta Attention (models/kda.py)
// for every (sequence, head) of a layer, the float32 state read and
// written once.
//
// Per (sequence, head), q, k, v of d and the state S of d x d:
//
//   q <- q / |q| * scale,  k <- k / |k|      (|x| = sqrt(sum x^2 + eps))
//   S' = Diag(exp(g)) S
//   u  = v - S'^T k
//   S  <- S' + beta k u^T                     (in place)
//   o  = S^T q = S'^T q + beta (q . k) u
//
// New in the port: the TPU kernels of the repo have no linear-attention
// step.  Bound: bytes.  The state is 64 KB a (sequence, head) at d 128,
// read and written once (131,072 B), against ~6 d^2 flops, ~0.1 flop a
// byte; q, k, v, the decay and beta add 1.3 KB.  At decode's batch 128
// and 32 heads a launch moves 537 MB, ~160 us at 3.35 TB/s.
//
// One CTA of 256 threads (8 warps) a (sequence, head).  Lane l holds
// columns 4l..4l+3 of the rows w, w + 8, ... of warp w: d / 8 rows of one
// float4 each, all loaded (streaming: ld.global.cs, the state is read
// once) before anything else so that the CTA's 64 KB are in flight
// together.  While they arrive the CTA stages q, k, v and exp(g) in
// shared memory and reduces |q|^2, |k|^2 and q . k.  Each thread then
// decays its rows in registers and sums its partial S'^T k and S'^T q
// over them; the eight warps' partials meet in shared memory, a thread a
// column forms u and o, and each thread adds k_i beta u_j to its rows
// and stores them (st.global.cs).  4096 CTAs at batch 128 fill the card
// ~15 times over at two CTAs an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxD = 128;
constexpr int kMaxRows = kMaxD / kWarps;  // rows a thread holds
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// qkv [B, 3, H, d] (q, k, v side by side), g [B, H, d] and beta [B, H]
// float32, state [B, H, d, d] float32 (in place), o [B, H, d].
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    kda_step_kernel(float* __restrict__ state, const T* __restrict__ qkv,
                    const float* __restrict__ g, const float* __restrict__ beta,
                    T* __restrict__ o, int h, int d, float scale, float eps) {
  __shared__ float sq[kMaxD], sk[kMaxD], sv[kMaxD], sa[kMaxD];
  __shared__ __align__(16) float su[kMaxD];
  __shared__ float red[2][kWarps][kMaxD];
  __shared__ float dots[3];

  const int bh = blockIdx.x;
  const int b = bh / h, head = bh - b * h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = d / kWarps;
  const bool cols = 4 * lane < d;
  float4* s_rows = reinterpret_cast<float4*>(state + static_cast<size_t>(bh) * d * d);
  const int row_vecs = d / 4;

  float4 s[kMaxRows];
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    if (j < rows && cols) s[j] = __ldcs(s_rows + (warp + kWarps * j) * row_vecs + lane);
  }

  if (tid < d) {
    const size_t base = static_cast<size_t>(b) * 3 * h + head;
    sq[tid] = to_f32(qkv[base * d + tid]);
    sk[tid] = to_f32(qkv[(base + h) * d + tid]);
    sv[tid] = to_f32(qkv[(base + 2 * h) * d + tid]);
    sa[tid] = expf(g[static_cast<size_t>(bh) * d + tid]);
  }
  __syncthreads();
  if (warp < 3) {  // |q|^2, |k|^2, q . k
    const float* x = warp == 1 ? sk : sq;
    const float* y = warp == 0 ? sq : sk;
    float acc = 0.f;
    for (int i = lane; i < d; i += 32) acc += x[i] * y[i];
    acc = warp_sum(acc);
    if (lane == 0) dots[warp] = acc;
  }
  __syncthreads();
  const float rq = rsqrtf(dots[0] + eps) * scale;
  const float rk = rsqrtf(dots[1] + eps);

  // S' = Diag(exp(g)) S; partial S'^T k and S'^T q over this thread's rows
  float4 pk = make_float4(0.f, 0.f, 0.f, 0.f), pq = pk;
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) {
    if (j < rows && cols) {
      const int i = warp + kWarps * j;
      const float a = sa[i], ki = sk[i] * rk, qi = sq[i] * rq;
      float4 v = s[j];
      v.x *= a, v.y *= a, v.z *= a, v.w *= a;
      s[j] = v;
      pk.x += ki * v.x, pk.y += ki * v.y, pk.z += ki * v.z, pk.w += ki * v.w;
      pq.x += qi * v.x, pq.y += qi * v.y, pq.z += qi * v.z, pq.w += qi * v.w;
    }
  }
  if (cols) {
    reinterpret_cast<float4*>(red[0][warp])[lane] = pk;
    reinterpret_cast<float4*>(red[1][warp])[lane] = pq;
  }
  __syncthreads();
  const float bt = beta[bh];
  if (tid < d) {  // a thread a column: u and o
    float sk_col = 0.f, sq_col = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sk_col += red[0][w][tid], sq_col += red[1][w][tid];
    const float u = sv[tid] - sk_col;
    const float qk = dots[2] * rq * rk;
    o[static_cast<size_t>(bh) * d + tid] = from_f32<T>(sq_col + bt * qk * u);
    su[tid] = bt * u;
  }
  __syncthreads();
  if (cols) {
    const float4 bu = reinterpret_cast<const float4*>(su)[lane];
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) {
      if (j < rows) {
        const float ki = sk[warp + kWarps * j] * rk;
        float4 v = s[j];
        v.x += ki * bu.x, v.y += ki * bu.y, v.z += ki * bu.z, v.w += ki * bu.w;
        __stcs(s_rows + (warp + kWarps * j) * row_vecs + lane, v);
      }
    }
  }
}

}  // namespace

// The arguments of one launch, packed by the Python wrapper into one
// buffer (kernels/lib.py::KDA_STEP_ARGS mirrors this layout field by
// field).  All operands contiguous; bh = B * H CTAs.
struct KdaStepArgs {
  float* state;
  const void* qkv;
  const float* g;
  const float* beta;
  void* o;
  void* stream;  // a raw cudaStream_t of `device`
  int32_t device;
  int32_t bh;
  int32_t h;
  int32_t d;
  float scale;
  float eps;
};

namespace {

template <typename T>
int entry(const KdaStepArgs* a) {
  const repro_torch::DeviceGuard guard(a->device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (a->bh <= 0) return static_cast<int>(cudaGetLastError());
  if (a->h <= 0 || a->d <= 0 || a->d % kWarps || a->d > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kda_step_kernel<T><<<a->bh, kThreads, 0, static_cast<cudaStream_t>(a->stream)>>>(
      a->state, static_cast<const T*>(a->qkv), a->g, a->beta, static_cast<T*>(a->o),
      a->h, a->d, a->scale, a->eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sizeof(KdaStepArgs), which the wrapper checks its layout against.
extern "C" int kda_step_args_size() { return static_cast<int>(sizeof(KdaStepArgs)); }

// Make `device` current if it is not, launch on `stream` and return
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a head
// width the kernel does not take.
extern "C" int kda_step_f32(const KdaStepArgs* a) { return entry<float>(a); }

extern "C" int kda_step_bf16(const KdaStepArgs* a) { return entry<__nv_bfloat16>(a); }
