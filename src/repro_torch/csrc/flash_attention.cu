// flash_attention: causal FlashAttention-2 forward with GQA, a sliding
// window and a tanh logit softcap.
//
//   o[b, i, h, :] = sum_j softmax_j(mask(cap(scale * q[b,i,h] . k[b,j,h/g]))) v[b,j,h/g]
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_bhsd), whose grid walked the kv blocks in order on one
// core and carried the online-softmax state in VMEM scratch from one grid
// step to the next.  Hopper runs CTAs in parallel and in no order, so the
// kv walk is a loop inside the CTA: one CTA per (batch * q-head, 64-row
// q tile), its softmax state (m, l) in shared memory and its output
// accumulator in registers for the whole walk.
//
// Layout: q [B, S, Hq, D], k/v [B, S, Hkv, D], o [B, S, Hq, D], all
// contiguous, so the model's projections feed it with no transpose.  Query
// head h reads kv head h / (Hq / Hkv) in place: no repeat in memory.
//
// Bound: operations.  4 * B * Hq * D flops per unmasked (query, key) pair;
// at h2o-danube-3-4b's prefill (B 4, S 1000, Hq 32, D 120) that is 31 GFLOP
// a layer against 6 MB of q/k/v/o, ~5,000 flops a byte.  This first kernel
// does the products as float32 FMAs from shared memory (no tensor cores),
// so it runs far from the bf16 tensor-core bound; it is kept simple and
// exact first (float32 throughout, the reference's arithmetic).  wgmma,
// TMA and warp specialisation are the later redesign.
//
// Masks: causal (key <= query), window (query - key < window) and the true
// sequence length (key < S): the reference pads S and leans on causal
// masking to hide the padded keys; this kernel masks the tail itself.
// Fully masked kv tiles are never visited: the loop runs only over the
// tiles that the causal and window bounds of the q tile reach.  A masked
// score contributes exactly 0 to the row sum and the accumulator.
//
// head_dim: any D <= 128 (120 in h2o-danube-3-4b).  The q and k tiles keep
// a row stride of D rounded up to odd, so 16 threads reading 16 rows at one
// column hit 16 banks; the v tile keeps 128 columns, zero past D.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 32;          // keys per kv tile
constexpr int kMaxD = 128;       // largest head_dim
constexpr int kThreads = 256;    // a 16 x 16 grid of threads over the tiles
constexpr int kRows = kBQ / 16;  // query rows per thread: ty + 16 * i
constexpr int kKeys = kBK / 16;  // keys per thread in the score tile
constexpr int kCols = kMaxD / 16;  // output columns per thread: tx + 16 * j
constexpr int kSP = kBK + 1;     // padded row of the score tile
constexpr float kNegInf = -1e30f;  // the reference's mask value
static_assert(kBK == 32, "the softmax step gives one key of a tile to each lane");

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
  return __float2bfloat16_rn(x);
}

__host__ __device__ constexpr int odd_stride(int d) { return d | 1; }

__host__ __device__ constexpr size_t smem_bytes(int d) {
  return sizeof(float) *
         (static_cast<size_t>(kBQ + kBK) * odd_stride(d)  // q, k tiles
          + kBK * kMaxD                                   // v tile
          + kBQ * kSP                                     // scores / probs
          + 3 * kBQ);                                     // m, l, corr
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, int s,
                           int hq, int hkv, int d, float scale, float softcap,
                           int causal, int window) {
  extern __shared__ float smem[];
  const int ld = odd_stride(d);
  float* sQ = smem;                 // [kBQ][ld]
  float* sK = sQ + kBQ * ld;        // [kBK][ld]
  float* sV = sK + kBK * ld;        // [kBK][kMaxD]
  float* sP = sV + kBK * kMaxD;     // [kBQ][kSP]
  float* sM = sP + kBQ * kSP;       // [kBQ] running max
  float* sL = sM + kBQ;             // [kBQ] running sum
  float* sC = sL + kBQ;             // [kBQ] this tile's rescale factor

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  // the longest causal rows first: q tiles are handed out last to first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int bh = blockIdx.x;
  const int b = bh / hq, h = bh % hq;
  const int hk = h / (hq / hkv);
  const int64_t q_row = static_cast<int64_t>(hq) * d;   // stride of a q row
  const int64_t kv_row = static_cast<int64_t>(hkv) * d;
  const T* qb = q + static_cast<int64_t>(b) * s * q_row + static_cast<int64_t>(h) * d;
  const T* kb = k + static_cast<int64_t>(b) * s * kv_row + static_cast<int64_t>(hk) * d;
  const T* vb = v + static_cast<int64_t>(b) * s * kv_row + static_cast<int64_t>(hk) * d;

  // q tile (rows past S read as 0: their output is never stored)
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const int qpos = q0 + r;
    for (int c = lane; c < d; c += 32) {
      sQ[r * ld + c] = qpos < s ? to_f32(qb[qpos * q_row + c]) : 0.f;
    }
  }
  // the v tile's columns past D stay 0 for the whole walk
  for (int e = tid; e < kBK * kMaxD; e += kThreads) {
    if (e % kMaxD >= d) sV[e] = 0.f;
  }
  if (tid < kBQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  float acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  // the kv tiles this q tile reaches
  const int q_end = min(s, q0 + kBQ);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int k_hi = causal ? q_end : s;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's k, v and p are consumed
    for (int r = warp; r < kBK; r += kThreads / 32) {
      const int kpos = k0 + r;
      for (int c = lane; c < d; c += 32) {
        const bool in = kpos < s;
        sK[r * ld + c] = in ? to_f32(kb[kpos * kv_row + c]) : 0.f;
        sV[r * kMaxD + c] = in ? to_f32(vb[kpos * kv_row + c]) : 0.f;
      }
    }
    __syncthreads();

    // scores: thread (ty, tx) owns rows ty + 16 i and keys tx + 16 j
    float sc[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sQ[(ty + 16 * i) * ld + c];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = sK[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kk = tx + 16 * j, kpos = k0 + kk;
        float x = sc[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        const bool valid = kpos < s && (!causal || kpos <= qpos) &&
                           (window <= 0 || qpos - kpos < window);
        sP[r * kSP + kk] = valid ? x : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: warp w updates rows 8w .. 8w+7, one key per lane
    for (int r = warp * (kBQ / 8); r < (warp + 1) * (kBQ / 8); ++r) {
      const float x = sP[r * kSP + lane];
      float mx = x;
#pragma unroll
      for (int o2 = 16; o2 > 0; o2 >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o2));
      }
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = x == kNegInf ? 0.f : expf(x - m_new);
      float sum = p;
#pragma unroll
      for (int o2 = 16; o2 > 0; o2 >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o2);
      }
      sP[r * kSP + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sC[r] = corr;
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float corr = sC[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
    }
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows], vv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = sP[(ty + 16 * i) * kSP + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = sV[kk * kMaxD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();  // the last tile's row sums are in sL

  T* ob = o + static_cast<int64_t>(b) * s * q_row + static_cast<int64_t>(h) * d;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
    if (qpos >= s) continue;
    const float l = fmaxf(sL[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      if (c < d) ob[qpos * q_row + c] = from_f32<T>(acc[i][j] / l);
    }
  }
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, int b, int s, int hq,
           int hkv, int d, float scale, float softcap, int causal, int window,
           void* stream) {
  if (b <= 0 || s <= 0 || hq <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hq, (s + kBQ - 1) / kBQ);
  flash_attention_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, o, s, hq, hkv, d, scale, softcap, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [b, s, hq, d], k/v [b, s, hkv, d], o [b, s, hq, d], contiguous; hq a
// multiple of hkv; 1 <= d <= 128; window <= 0 means none, softcap <= 0
// means none.  Launches on `stream` and returns cudaGetLastError().
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int b, int s,
                                   int hq, int hkv, int d, float scale,
                                   float softcap, int causal, int window,
                                   void* stream) {
  return launch(q, k, v, o, b, s, hq, hkv, d, scale, softcap, causal, window,
                stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int b, int s,
                                    int hq, int hkv, int d, float scale,
                                    float softcap, int causal, int window,
                                    void* stream) {
  using bf = __nv_bfloat16;
  return launch(static_cast<const bf*>(q), static_cast<const bf*>(k),
                static_cast<const bf*>(v), static_cast<bf*>(o), b, s, hq, hkv,
                d, scale, softcap, causal, window, stream);
}
