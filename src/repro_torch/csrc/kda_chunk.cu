// kda_chunk: Kimi Delta Attention's prefill (models/kda.py) over whole
// sequences in one launch, chunk by chunk, the float32 state kept on chip.
//
// Per (sequence, head), for each chunk of kC = 64 tokens (the last one
// padded with q = k = v = 0, g = 0 and beta = 0, which leave the state as
// it is), with q and k L2-normalised (|x| = sqrt(sum x^2 + eps)), q scaled,
// gc the cumulative log-decay inside the chunk and S the d x d state:
//
//   Aqk[t, i] = sum_c q_tc k_ic exp(gc_tc - gc_ic)      (i <= t)
//   L[t, i]   = beta_t sum_c k_tc k_ic exp(gc_tc - gc_ic) (i < t)
//   (I + L) [U | W] = beta [v | k exp(gc)]              (forward substitution)
//   w  = U - W S
//   o  = Aqk w + (q exp(gc)) S
//   S <- Diag(exp(gc_last)) S + (k exp(gc_last - gc))^T w
//
// The pairwise products take every decay as a difference of two points of
// one chunk by halving (kernels/kda_chunk.py::_intra, the plain version's
// arithmetic): at level h the chunk splits into blocks of 2h tokens, and
// the pairs with t in a block's right half and i in its left half factor
// through gc_m, m the left half's last token, as (q_t e^(gc_t - gc_m)) .
// (k_i e^(gc_m - gc_i)): both exponents -|gc - gc_m|, never positive, so
// -gc reaching hundreds over a chunk neither overflows nor loses a pair.
//
// New in the port: the TPU kernels of the repo have no linear attention
// (the published design is flash-linear-attention's chunk_kda).  Bound:
// operations.  A 64-token chunk of a head at d 128 needs ~8.9 MFLOP of
// products (the pairwise products and Aqk w on and below the diagonal,
// the substitution, W S and q S, the state's update; ~10.5 counting the
// triangles whole), all float32 FFMA; at Kimi's prefill of 128 x 1024
// tokens and 32 heads a layer is ~583 GFLOP against ~9.9 GB moved (q, k,
// v and g read in float32, o written in bf16, the state in float32), so
// ~8.7 ms at 67 TFLOP/s and 3.0 ms by bytes.  Every product and sum is
// float32 FFMA, as the plain version's with TF32 off.
//
// One pass, one CTA of 256 threads a (sequence, head), walking its chunks
// in order.  Why not flash-linear-attention's split (chunk-parallel
// products, then a state-passing pass): the split writes and reads again
// each chunk's U, W, Aqk, q exp(gc) and k exp(gc_last - gc), ~150 KB a
// chunk of a head, 2.4 GB each way for a 32-row slice of the prefill,
// while one pass reads each input once.  A 32-row slice gives 1,024 CTAs,
// ~7.8 waves over 132 SMs at one CTA an SM, so the card is full without
// the split.  Shared memory, 225.5 KB of the 227 available, holds a
// chunk's q, k, v and g, the pairwise matrices and the buffers of the
// products; the 64 KB state lives in registers between chunks (an 8 x 8
// tile a thread) and in shared memory only while the chunk's products
// read it.  Rows are padded by 4 floats so that float4 reads of
// neighbouring rows fall in other banks.  Each product is a register-tiled
// float4 loop (8 x 8 or 4 x 8 outputs a thread for W S, q S, Aqk w and the
// state's update); the substitution gives each of the 2d right-hand
// columns to one thread, right-looking, so each step's updates are
// independent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int kC = 64;  // tokens a chunk
constexpr int kMaxD = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLd = kMaxD + 4;  // row stride of [token][channel] buffers
constexpr int kLdT = kC + 4;    // row stride of [channel][token] and [token][token]
constexpr int kBig = kC * kLd > kMaxD * kLdT ? kC * kLd : kMaxD * kLdT;
// region R1: gc [kC][kLd], the right halves' q e [kC / 2][kLd] and L^T
// [kC][kLdT] while a chunk's pairs are formed; the state S^T [d][kLd] while
// its products read it
constexpr int kGc = kC * kLd;
constexpr int kQer = kC / 2 * kLd;
constexpr int kLt = kC * kLdT;
constexpr int kR1 = kGc + kQer + kLt > kMaxD * kLd ? kGc + kQer + kLt : kMaxD * kLd;
constexpr int kAqk = kC * kLdT;
constexpr int kSmemFloats = 4 * kBig + kR1 + kAqk + kC + kMaxD;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;
static_assert(kSmemBytes <= 232448, "more shared memory than a block may have");
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
__device__ __forceinline__ float4 scale4(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}
__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

struct Smem {
  float* q;      // q (normalised, scaled) -> q exp(gc) -> q S
  float* k;      // k (normalised) -> beta k exp(gc) -> W
  float* v;      // beta v -> U -> w^T [d][kLdT]
  float* e;      // a level's k e -> (k exp(gc_last - gc))^T [d][kLdT]
  float* gc;     // R1: cumulative log-decay
  float* qer;    // R1: a level's q e of the right halves
  float* lt;     // R1: L^T [i][t]
  float* st;     // R1: S^T [c][r]
  float* aqk;    // [t][i], zero above the diagonal
  float* beta;   // [kC]
  float* decay;  // exp(gc_last) [d]
};

// One level of the halving: each token's q and k times exp(-|gc - gc_m|)
// (only the right halves' q is kept), then every (right t, left i) pair's
// two products.  TN left tokens a thread, one right token.
__device__ __forceinline__ void scale_level(const Smem& s, int hh, int d, int tid) {
  const int nv = d >> 2;
  for (int idx = tid; idx < kC * nv; idx += kThreads) {
    const int t = idx / nv, c = 4 * (idx - t * nv);
    const int m = (t & ~(2 * hh - 1)) + hh - 1;
    const float4 gt = ld4(s.gc + t * kLd + c), gm = ld4(s.gc + m * kLd + c);
    const float4 e = make_float4(expf(-fabsf(gt.x - gm.x)), expf(-fabsf(gt.y - gm.y)),
                                 expf(-fabsf(gt.z - gm.z)), expf(-fabsf(gt.w - gm.w)));
    st4(s.e + t * kLd + c, mul4(ld4(s.k + t * kLd + c), e));
    if (t & hh) {
      const int rt = t / (2 * hh) * hh + (t & (hh - 1));
      st4(s.qer + rt * kLd + c, mul4(ld4(s.q + t * kLd + c), e));
    }
  }
}

template <int TN>
__device__ __forceinline__ void level_products(const Smem& s, int hh, int d, int tid) {
  const int n_ig = hh / TN;
  if (tid >= 32 * n_ig) return;
  const int ig = tid % n_ig, rt = tid / n_ig;
  const int blk = rt / hh, base = blk * 2 * hh;
  const int t = base + hh + (rt - blk * hh);
  const float* pq = s.qer + rt * kLd;
  const float* pk = s.e + t * kLd;
  float aq[TN], ak[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) aq[j] = ak[j] = 0.f;
  for (int c = 0; c < d; c += 4) {
    const float4 xq = ld4(pq + c), xk = ld4(pk + c);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float4 y = ld4(s.e + (base + ig + n_ig * j) * kLd + c);
      aq[j] = dot4(aq[j], xq, y);
      ak[j] = dot4(ak[j], xk, y);
    }
  }
  const float bt = s.beta[t];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int i = base + ig + n_ig * j;
    s.aqk[t * kLdT + i] = aq[j];
    s.lt[i * kLdT + t] = bt * ak[j];
  }
}

// qkv [B, S, 3, H, d] (q, k, v side by side), g [B, S, H, d] and beta
// [B, S, H] float32; o [B, S, H, d]; state [B, H, d, d] float32, the state
// after the last token (zero before the first).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    kda_chunk_kernel(const float* __restrict__ qkv, const float* __restrict__ g,
                     const float* __restrict__ beta, T* __restrict__ o,
                     float* __restrict__ state, int s_len, int h, int d, float scale,
                     float eps) {
  extern __shared__ __align__(16) float smem[];
  Smem s;
  s.q = smem;
  s.k = s.q + kBig;
  s.v = s.k + kBig;
  s.e = s.v + kBig;
  s.gc = s.e + kBig;
  s.qer = s.gc + kGc;
  s.lt = s.qer + kQer;
  s.st = s.gc;
  s.aqk = s.gc + kR1;
  s.beta = s.aqk + kAqk;
  s.decay = s.beta + kC;

  const int bh = blockIdx.x;
  const int b = bh / h, head = bh - b * h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nv = d >> 2;  // float4 a row
  const int nd = d >> 3;  // the products' column groups
  const size_t hd = static_cast<size_t>(h) * d;
  const int n_chunks = (s_len + kC - 1) / kC;

  for (int i = tid; i < kAqk; i += kThreads) s.aqk[i] = 0.f;

  // this thread's tile of the state: S[r][c] at r = tr + nd i, c = tc + nd j
  const bool owns_s = tid < nd * nd;
  const int tc = owns_s ? tid / nd : 0, tr = owns_s ? tid - tc * nd : 0;
  float s_reg[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) s_reg[j][i] = 0.f;
  }
  // the products' tiles: 16 row groups x nd column groups
  const bool p_thread = tid < 2 * d;
  const int tm = p_thread ? tid / nd : 0, tn = p_thread ? tid - tm * nd : 0;

  for (int ck = 0; ck < n_chunks; ++ck) {
    const int t0 = ck * kC;
    // ---- the chunk's q, k (normalised), beta v, beta, and gc
    for (int t = warp; t < kC; t += kWarps) {
      const int tg = t0 + t;
      const bool real = tg < s_len;
      const size_t tok = static_cast<size_t>(b) * s_len + tg;
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f), kv = qv, vv = qv;
      if (real && lane < nv) {
        const float4* row = reinterpret_cast<const float4*>(
            qkv + tok * 3 * hd + static_cast<size_t>(head) * d);
        qv = __ldcs(row + lane);
        kv = __ldcs(row + hd / 4 + lane);
        vv = __ldcs(row + hd / 2 + lane);
      }
      const float bt = real ? __ldg(beta + tok * h + head) : 0.f;
      const float rq = rsqrtf(warp_sum(dot4(0.f, qv, qv)) + eps);
      const float rk = rsqrtf(warp_sum(dot4(0.f, kv, kv)) + eps);
      if (lane < nv) {
        st4(s.q + t * kLd + 4 * lane, scale4(scale4(qv, rq), scale));
        st4(s.k + t * kLd + 4 * lane, scale4(kv, rk));
        st4(s.v + t * kLd + 4 * lane, scale4(vv, bt));
      }
      if (lane == 0) s.beta[t] = bt;
    }
    if (tid < d) {
      const float* gp = g + (static_cast<size_t>(b) * s_len + t0) * hd +
                        static_cast<size_t>(head) * d + tid;
      const int valid = min(kC, s_len - t0);
      float acc = 0.f;
#pragma unroll 8
      for (int t = 0; t < kC; ++t) {
        acc += t < valid ? __ldcs(gp + static_cast<size_t>(t) * hd) : 0.f;
        s.gc[t * kLd + tid] = acc;
      }
    }
    __syncthreads();

    // ---- Aqk and L by halving; Aqk's diagonal is q_t . k_t
    for (int t = warp; t < kC; t += kWarps) {
      const float x =
          lane < nv ? dot4(0.f, ld4(s.q + t * kLd + 4 * lane), ld4(s.k + t * kLd + 4 * lane))
                    : 0.f;
      const float dsum = warp_sum(x);
      if (lane == 0) s.aqk[t * kLdT + t] = dsum;
    }
    for (int hh = 1; hh < kC; hh <<= 1) {
      scale_level(s, hh, d, tid);
      __syncthreads();
      if (hh >= 32) {
        level_products<4>(s, hh, d, tid);
      } else if (hh == 16) {
        level_products<2>(s, hh, d, tid);
      } else {
        level_products<1>(s, hh, d, tid);
      }
      __syncthreads();
    }

    // ---- q exp(gc), beta k exp(gc), (k exp(gc_last - gc))^T, exp(gc_last)
    for (int idx = tid; idx < kC * nv; idx += kThreads) {
      const int t = idx % kC, c = 4 * (idx / kC);
      const float4 gt = ld4(s.gc + t * kLd + c), gl = ld4(s.gc + (kC - 1) * kLd + c);
      const float4 kv = ld4(s.k + t * kLd + c);
      const float4 eg = make_float4(expf(gt.x), expf(gt.y), expf(gt.z), expf(gt.w));
      st4(s.q + t * kLd + c, mul4(ld4(s.q + t * kLd + c), eg));
      st4(s.k + t * kLd + c, scale4(mul4(kv, eg), s.beta[t]));
      s.e[(c + 0) * kLdT + t] = kv.x * expf(gl.x - gt.x);
      s.e[(c + 1) * kLdT + t] = kv.y * expf(gl.y - gt.y);
      s.e[(c + 2) * kLdT + t] = kv.z * expf(gl.z - gt.z);
      s.e[(c + 3) * kLdT + t] = kv.w * expf(gl.w - gt.w);
    }
    if (tid < d) s.decay[tid] = expf(s.gc[(kC - 1) * kLd + tid]);
    __syncthreads();

    // ---- (I + L) [U | W] = [beta v | beta k exp(gc)]: a column a thread
    if (tid < 2 * d) {
      float* col = tid < d ? s.v + tid : s.k + (tid - d);
      float x[kC];
#pragma unroll
      for (int t = 0; t < kC; ++t) x[t] = col[t * kLd];
#pragma unroll
      for (int i = 0; i < kC - 1; ++i) {
        const float xi = x[i];
#pragma unroll
        for (int t4 = (i + 1) / 4 * 4; t4 < kC; t4 += 4) {
          const float4 l = ld4(s.lt + i * kLdT + t4);
          if (t4 + 0 > i) x[t4 + 0] = fmaf(-l.x, xi, x[t4 + 0]);
          if (t4 + 1 > i) x[t4 + 1] = fmaf(-l.y, xi, x[t4 + 1]);
          if (t4 + 2 > i) x[t4 + 2] = fmaf(-l.z, xi, x[t4 + 2]);
          if (t4 + 3 > i) x[t4 + 3] = fmaf(-l.w, xi, x[t4 + 3]);
        }
      }
#pragma unroll
      for (int t = 0; t < kC; ++t) col[t * kLd] = x[t];
    }
    __syncthreads();

    // ---- the state into shared memory, as S^T
    if (owns_s) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 8; ++i) s.st[(tc + nd * j) * kLd + tr + nd * i] = s_reg[j][i];
      }
    }
    __syncthreads();

    // ---- [W; q exp(gc)] S: rows 0-63 give W S - U (so w, negated), rows
    // 64-127 q S
    float acc[8][8];
    const bool w_rows = tm < 8;
    const int r0 = (tm & 7) * 8;
    if (p_thread) {
      const float* src = w_rows ? s.k : s.q;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = w_rows ? -s.v[(r0 + i) * kLd + tn + nd * j] : 0.f;
        }
      }
      for (int c = 0; c < d; c += 4) {
        float4 a[8], y[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = ld4(src + (r0 + i) * kLd + c);
#pragma unroll
        for (int j = 0; j < 8; ++j) y[j] = ld4(s.st + (tn + nd * j) * kLd + c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = dot4(acc[i][j], a[i], y[j]);
        }
      }
    }
    __syncthreads();
    if (p_thread) {
      if (w_rows) {  // w^T = -(W S - U)^T over U's rows
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float* dst = s.v + (tn + nd * j) * kLdT + r0;
          st4(dst, make_float4(-acc[0][j], -acc[1][j], -acc[2][j], -acc[3][j]));
          st4(dst + 4, make_float4(-acc[4][j], -acc[5][j], -acc[6][j], -acc[7][j]));
        }
      } else {  // q S over q exp(gc)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) s.q[(r0 + i) * kLd + tn + nd * j] = acc[i][j];
        }
      }
    }
    __syncthreads();

    // ---- o = q S + Aqk w (4 x 8 a thread), and the state's update
    if (p_thread) {
      const int q0 = tm * 4;
      float ao[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) ao[i][j] = s.q[(q0 + i) * kLd + tn + nd * j];
      }
      for (int c = 0; c < q0 + 4; c += 4) {
        float4 a[4], y[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ld4(s.aqk + (q0 + i) * kLdT + c);
#pragma unroll
        for (int j = 0; j < 8; ++j) y[j] = ld4(s.v + (tn + nd * j) * kLdT + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) ao[i][j] = dot4(ao[i][j], a[i], y[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int tg = t0 + q0 + i;
        if (tg < s_len) {
          T* orow = o + (static_cast<size_t>(b) * s_len + tg) * hd +
                    static_cast<size_t>(head) * d;
#pragma unroll
          for (int j = 0; j < 8; ++j) orow[tn + nd * j] = from_f32<T>(ao[i][j]);
        }
      }
    }
    if (owns_s) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s_reg[j][i] = s.st[(tc + nd * j) * kLd + tr + nd * i] * s.decay[tr + nd * i];
        }
      }
      for (int t = 0; t < kC; t += 4) {
        float4 a[8], y[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) a[j] = ld4(s.v + (tc + nd * j) * kLdT + t);
#pragma unroll
        for (int i = 0; i < 8; ++i) y[i] = ld4(s.e + (tr + nd * i) * kLdT + t);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int i = 0; i < 8; ++i) s_reg[j][i] = dot4(s_reg[j][i], a[j], y[i]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int i = 0; i < 8; ++i) s_reg[j][i] = 0.f;
      }
    }
    __syncthreads();
  }

  // the final state, through shared memory so that the stores are rows
  if (owns_s) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 8; ++i) s.gc[(tr + nd * i) * kLd + tc + nd * j] = s_reg[j][i];
    }
  }
  __syncthreads();
  float* out = state + static_cast<size_t>(bh) * d * d;
  for (int idx = tid; idx < d * nv; idx += kThreads) {
    const int r = idx / nv, c = 4 * (idx - r * nv);
    st4(out + r * d + c, ld4(s.gc + r * kLd + c));
  }
}

}  // namespace

// The arguments of one launch, packed by the Python wrapper into one
// buffer (kernels/lib.py::KDA_CHUNK_ARGS mirrors this layout field by
// field).  All operands contiguous and 16-byte aligned; b * h CTAs.
struct KdaChunkArgs {
  const float* qkv;
  const float* g;
  const float* beta;
  void* o;
  float* state;
  void* stream;  // a raw cudaStream_t of `device`
  int32_t device;
  int32_t b;
  int32_t s;
  int32_t h;
  int32_t d;
  float scale;
  float eps;
};

namespace {

template <typename T>
int entry(const KdaChunkArgs* a) {
  const repro_torch::DeviceGuard guard(a->device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (a->b <= 0 || a->h <= 0) return static_cast<int>(cudaGetLastError());
  if (a->s < 0 || a->d <= 0 || a->d % 8 || a->d > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // once per process and type: the block's shared memory is over 48 KB
  static const cudaError_t attr = cudaFuncSetAttribute(
      kda_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kda_chunk_kernel<T><<<a->b * a->h, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(a->stream)>>>(
      a->qkv, a->g, a->beta, static_cast<T*>(a->o), a->state, a->s, a->h, a->d,
      a->scale, a->eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sizeof(KdaChunkArgs), which the wrapper checks its layout against.
extern "C" int kda_chunk_args_size() { return static_cast<int>(sizeof(KdaChunkArgs)); }

// Make `device` current if it is not, launch on `stream` and return
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a head
// width the kernel does not take.  The suffix names o's type.
extern "C" int kda_chunk_f32(const KdaChunkArgs* a) { return entry<float>(a); }

extern "C" int kda_chunk_bf16(const KdaChunkArgs* a) {
  return entry<__nv_bfloat16>(a);
}
