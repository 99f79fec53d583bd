// flash_attention: causal FlashAttention-2 forward with GQA, a sliding
// window and a tanh logit softcap.
//
//   o[b, i, h, :] = sum_j softmax_j(mask(cap(scale * q[b,i,h] . k[b,j,h/g]))) v[b,j,h/g]
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_bhsd), whose grid walked the kv blocks in order on one
// core and carried the online-softmax state in VMEM scratch from one grid
// step to the next.  Hopper runs CTAs in parallel and in no order, so the
// kv walk is a loop inside the CTA, which owns a tile of query rows of one
// (batch, head) and keeps its softmax state and output for the whole walk.
// q tiles are handed out last to first, so the longest causal rows start
// first.
//
// Layout: q [B, S, Hq, D], k/v [B, S, Hkv, D], o [B, S, Hq, D], all
// contiguous, so the model's projections feed it with no transpose.  Query
// head h reads kv head h / (Hq / Hkv) in place: no repeat in memory.
//
// Masks: causal (key <= query), window (query - key < window) and the true
// sequence length (key < S): the reference pads S and leans on causal
// masking to hide the padded keys; both kernels mask the tail themselves.
// Fully masked kv tiles are never visited.  A masked score (-1e30 in the
// scalar kernel, -inf in the tensor-core one) adds exactly 0 to the row
// sum and the output.
//
// Bound: operations, 4 * D flops per unmasked (query, key) pair; at
// h2o-danube-3-4b's prefill (B 4, S 1000, Hq 32, D 120, bf16) 31 GFLOP a
// layer against 6 MB of q/k/v/o, ~5,000 flops a byte.  Two kernels, one
// route each, chosen by the wrapper (kernels/flash_attention.py) before
// the launch:
//
// * Tensor cores (flash_attention_bf16_wgmma): bf16 with D % 8 == 0 and
//   D <= 128.  A CTA is one consumer warpgroup (64 query rows, the wgmma M)
//   and one producer warp.  The producer's lane 0 issues TMA loads: q once,
//   then k and v tiles of 64 keys through two rings of two slots each, with
//   a full and an empty mbarrier per slot.  A k slot is freed as soon as
//   its q k^T is done, a v slot once its P v is, so each tile is in flight
//   a whole tile ahead of its use.  Per tile the warpgroup computes
//   S = q k^T by wgmma with both operands in 128-byte-swizzled shared
//   memory, then the online softmax on the accumulator fragment in
//   registers (row max and sum over the 4 lanes of a row; one FFMA and one
//   EX2 a score), then O += P v by wgmma with P rounded to bf16 and fed
//   from registers (the f32 accumulator of two n8 blocks is the bf16 A
//   fragment of one k16 step) and v read MN-major.  The head dim is loaded
//   as 64-column halves; TMA's zero fill pads D up to 64 or 128 and the
//   rows past S of each batch.  150 registers a thread and 81 KB of
//   shared memory at D > 64 let two CTAs share an SM, so one's softmax
//   overlaps the other's products.  Rounding P to bf16 is the one change
//   of arithmetic against the reference (float32 P), as in
//   FlashAttention-2/3.
// * Scalar (flash_attention_f32, flash_attention_bf16): float32, and bf16
//   with D % 8 != 0 (TMA wants 16-byte row strides).  float32 FMAs from
//   shared memory, 256 threads over a 64-row q tile and 32-key kv tiles:
//   the reference's float32 arithmetic, far from the tensor cores' rate.
//   The q and k tiles keep a row stride of D rounded up to odd, so 16
//   threads reading 16 rows at one column hit 16 banks; the v tile keeps
//   128 columns, zero past D.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int kMaxD = 128;         // largest head_dim
constexpr float kNegInf = -1e30f;  // the reference's mask value

// ---------------------------------------------------------------------------
// Scalar route
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 32;          // keys per kv tile
constexpr int kThreads = 256;    // a 16 x 16 grid of threads over the tiles
constexpr int kRows = kBQ / 16;  // query rows per thread: ty + 16 * i
constexpr int kKeys = kBK / 16;  // keys per thread in the score tile
constexpr int kCols = kMaxD / 16;  // output columns per thread: tx + 16 * j
constexpr int kSP = kBK + 1;     // padded row of the score tile
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
  // once per process and type: room for the largest head_dim
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxD)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(b * hq, (s + kBQ - 1) / kBQ);
  flash_attention_kernel<T><<<grid, kThreads, smem_bytes(d), static_cast<cudaStream_t>(stream)>>>(
      q, k, v, o, s, hq, hkv, d, scale, softcap, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Tensor-core route (bf16, D % 8 == 0, D <= 128)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kRowsWG = 64;   // query rows per CTA: one consumer warpgroup (wgmma M)
constexpr int kKeysT = 64;    // keys per kv tile (wgmma N of S)
constexpr int kAtom = 64;     // bf16 columns per 128-byte swizzle row
constexpr int kStages = 2;    // depth of the k ring and of the v ring
constexpr int kThreads = 128 + 32;  // the consumer warpgroup, then the producer warp
constexpr int kTileBytes = kRowsWG * kAtom * 2;  // a 64 x 64 bf16 tile: 8 KB
constexpr float kLog2e = 1.4426950408889634f;

// kHalves: 64-column halves of the head dim (1 for D <= 64, else 2)
template <int kHalves>
struct Smem {
  static constexpr int kStageBytes = kHalves * kTileBytes;  // q, or one k or v slot
  // 1024 bytes of slack: the swizzle pattern repeats every 1024 bytes and
  // the tiles must start on that boundary; then q, the k and v rings, and
  // a full and an empty barrier for each ring slot, one for q
  static constexpr int kBytes =
      1024 + (1 + 2 * kStages) * kStageBytes + 8 * (4 * kStages + 1);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// returns once the phase of `bar` with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of the 4-d map [B, S, H, D] (innermost first: column, head, row,
// batch) into shared memory; completion is counted on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving register reads or writes across a wgmma
// that is still in flight
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define FA_D32(d)                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define FA_R32                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"

// d (+)= a b, m64n64k16, a and b K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FA_D32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += a b, m64n64k16, a from registers (4 x bf16x2), b MN-major in shared
// memory (trans-b = 1)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef FA_D32
#undef FA_R32

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = q k^T into sc, committed as one group: 4 k16 steps per 64-column
// half, each 32 bytes further into the 128-byte swizzled rows; 8-row
// groups 1024 bytes apart
template <int kHalves>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint32_t q_tile,
                                         uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * kHalves; ++kk) {
    const uint32_t off = (kk / 4) * kTileBytes + (kk % 4) * 32;
    wgmma_ss(sc, sw128_desc(q_tile + off, 16, 1024),
             sw128_desc(k_tile + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// acc += P v, committed as one group.  P's A fragment for k16 step t is
// pa[t] (see to_a_fragment); v is [key][column]: MN-major, step t 16 keys =
// 2048 bytes further.  With N = 64 one swizzle atom spans N, so the only
// stride used is the 1024 bytes between 8-key groups (given as both
// offsets).
template <int kHalves>
__device__ __forceinline__ void issue_pv(float (&acc)[kHalves][32],
                                         const uint32_t (&pa)[4][4],
                                         uint32_t v_tile) {
  wgmma_fence();
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf)
      wgmma_rs(acc[hf], pa[t],
               sw128_desc(v_tile + hf * kTileBytes + t * 2048, 1024, 1024));
  wgmma_commit();
}

// P (f32 accumulator layout) -> bf16 A fragments.  The accumulator of n8
// blocks 2t and 2t+1 is the A fragment of k16 step t: {p[8t], p[8t+1]}
// row ra keys 16t+kc.., {p[8t+2], p[8t+3]} row rb, {p[8t+4], p[8t+5]} row
// ra keys 16t+8+kc.., {p[8t+6], p[8t+7]} row rb.
__device__ __forceinline__ void to_a_fragment(const float (&p)[32],
                                              uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[t][r] = pack_bf16(p[8 * t + 2 * r], p[8 * t + 2 * r + 1]);
}

// The masks and scaling of one CTA and the online-softmax state of the
// two rows a thread holds (ra, rb = ra + 8).  Scores stay in the units of
// the product (of the cap, when there is one) and `f` takes them to log2
// units inside the exponent: p = 2^(x f - m f), one FFMA and one EX2 a
// score.  Masked scores are -inf; m is the running row max (-inf until a
// key of the row is seen), l this thread's share of the row sum.
struct Softmax {
  int s, causal, window, ra, rb, kc;
  float f, cap_in, cap;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  // the scores of the tile at keys k0.. -> probabilities in place;
  // returns the factors that rescale the rows' output so far.  sc[4j+e]
  // is row (e < 2 ? ra : rb), key k0 + 8j + kc + (e & 1).
  __device__ __forceinline__ void tile(float (&sc)[32], int k0, bool edge,
                                       float& c_a, float& c_b) {
    if (cap > 0.f) {
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = cap * tanhf(sc[i] * cap_in);
    }
    if (edge) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = e < 2 ? ra : rb;
          const int kpos = k0 + 8 * j + kc + (e & 1);
          const bool ok = kpos < s && (!causal || kpos <= qpos) &&
                          (window <= 0 || qpos - kpos < window);
          if (!ok) sc[4 * j + e] = -INFINITY;
        }
    }
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    // the four lanes of a row hold its 64 keys
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    // a row with no key seen yet keeps m = -inf: subtract 0 there, so that
    // its masked scores give 2^-inf = 0 and not NaN
    const float base_a = mx_a == -INFINITY ? 0.f : mx_a * f;
    const float base_b = mx_b == -INFINITY ? 0.f : mx_b * f;
    c_a = ex2(fmaf(m_a, f, -base_a));
    c_b = ex2(fmaf(m_b, f, -base_b));
    m_a = mx_a;
    m_b = mx_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[4 * j + 0] = ex2(fmaf(sc[4 * j + 0], f, -base_a));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], f, -base_a));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], f, -base_b));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], f, -base_b));
      sum_a += sc[4 * j] + sc[4 * j + 1];
      sum_b += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l_a = l_a * c_a + sum_a;
    l_b = l_b * c_b + sum_b;
  }
};

template <int kHalves>
__global__ void __launch_bounds__(kThreads, 2)
    attention_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     __nv_bfloat16* __restrict__ o, int s, int hq, int hkv,
                     int d, float scale, float softcap, int causal,
                     int window) {
  constexpr int kStageBytes = Smem<kHalves>::kStageBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + kStageBytes;                // [stage][half] tiles
  const uint32_t sV = sK + kStages * kStageBytes;      // [stage][half] tiles
  const uint32_t bars = sV + kStages * kStageBytes;
  const uint32_t bar_q = bars + 32 * kStages;          // q has arrived
  // k and v have rings of their own, so that a k slot is free as soon as
  // its q k^T is done: full(kv, st) says that slot st of ring kv (0 = k,
  // 1 = v) has arrived, empty(kv, st) that the consumer warps are done with it
  auto full = [bars](int kv, int st) { return bars + 8 * (kv * kStages + st); };
  auto empty = [bars](int kv, int st) {
    return bars + 8 * ((2 + kv) * kStages + st);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the longest causal rows first: q tiles are handed out last to first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRowsWG;
  const int b = blockIdx.x / hq, h = blockIdx.x % hq;
  const int hk = h / (hq / hkv);
  // the kv tiles this q tile reaches; each holds a key some row attends to
  const int q_end = min(s, q0 + kRowsWG);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) / kKeysT * kKeysT : 0;
  const int k_hi = causal ? q_end : s;
  const int n_tiles = (k_hi - k_lo + kKeysT - 1) / kKeysT;

  if (threadIdx.x == 0) {
    for (int kv = 0; kv < 2; ++kv)
      for (int st = 0; st < kStages; ++st) {
        mbar_init(full(kv, st), 1);
        mbar_init(empty(kv, st), 4);
      }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // producer: one lane issues every load
    if (lane == 0) {
      mbar_expect_tx(bar_q, kStageBytes);
      for (int hf = 0; hf < kHalves; ++hf)
        tma_load(sQ + hf * kTileBytes, &tm_q, bar_q, kAtom * hf, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages, k0 = k_lo + i * kKeysT;
        for (int kv = 0; kv < 2; ++kv) {
          // the previous round of this slot has been freed
          mbar_wait(empty(kv, st), ((i / kStages) & 1) ^ 1);
          mbar_expect_tx(full(kv, st), kStageBytes);
          for (int hf = 0; hf < kHalves; ++hf)
            tma_load((kv ? sV : sK) + st * kStageBytes + hf * kTileBytes,
                     kv ? &tm_v : &tm_k, full(kv, st), kAtom * hf, hk, k0, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: warp w holds rows q0 + 16w .. q0 + 16w + 15;
  // in each n8 block of a fragment a thread holds columns kc, kc + 1
  Softmax sm;
  sm.s = s;
  sm.causal = causal;
  sm.window = window;
  sm.ra = q0 + 16 * warp + lane / 4;
  sm.rb = sm.ra + 8;
  sm.kc = 2 * (lane % 4);
  sm.f = (softcap > 0.f ? 1.f : scale) * kLog2e;
  sm.cap_in = softcap > 0.f ? scale / softcap : 0.f;
  sm.cap = softcap;
  // a tile needs masks if it crosses the diagonal, the window edge or S
  auto edge = [&](int k0) {
    return (causal && k0 + kKeysT - 1 > q0) || k0 + kKeysT > s ||
           (window > 0 && q0 + kRowsWG - 1 - k0 >= window);
  };

  float acc[kHalves][32];
  float sc[32];
  uint32_t pa[4][4];
#pragma unroll
  for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[hf][i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;

  // Per tile: q k^T, softmax, rescale, P v.  The two CTAs of an SM
  // overlap one's softmax with the other's products.  A k slot is freed as
  // soon as its q k^T is done, a v slot once its P v is.
  auto release = [lane](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % kStages, k0 = k_lo + i * kKeysT;
    const uint32_t par = (i / kStages) & 1;
    mbar_wait(full(0, st), par);
    issue_qk<kHalves>(sc, sQ, sK + st * kStageBytes);
    wgmma_wait_all();
    fence_regs(sc);
    release(empty(0, st));
    float c_a, c_b;
    sm.tile(sc, k0, edge(k0), c_a, c_b);
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[hf][4 * j + 0] *= c_a;
        acc[hf][4 * j + 1] *= c_a;
        acc[hf][4 * j + 2] *= c_b;
        acc[hf][4 * j + 3] *= c_b;
      }
    to_a_fragment(sc, pa);
    mbar_wait(full(1, st), par);
    issue_pv<kHalves>(acc, pa, sV + st * kStageBytes);
    wgmma_wait_all();
#pragma unroll
    for (int hf = 0; hf < kHalves; ++hf) fence_regs(acc[hf]);
#pragma unroll
    for (int t = 0; t < 4; ++t) fence_regs(pa[t]);
    release(empty(1, st));
  }

  // epilogue: o = acc / l, rows < S and columns < D, straight from registers
  float l_a = sm.l_a, l_b = sm.l_b;
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
  const int64_t q_row = static_cast<int64_t>(hq) * d;
  __nv_bfloat16* ob =
      o + static_cast<int64_t>(b) * s * q_row + static_cast<int64_t>(h) * d;
#pragma unroll
  for (int hf = 0; hf < kHalves; ++hf)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = kAtom * hf + 8 * j + sm.kc;
      if (col >= d) continue;
      if (sm.ra < s)
        *reinterpret_cast<uint32_t*>(ob + sm.ra * q_row + col) =
            pack_bf16(acc[hf][4 * j] * inv_a, acc[hf][4 * j + 1] * inv_a);
      if (sm.rb < s)
        *reinterpret_cast<uint32_t*>(ob + sm.rb * q_row + col) =
            pack_bf16(acc[hf][4 * j + 2] * inv_b, acc[hf][4 * j + 3] * inv_b);
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime once
// per process (so the library links no -lcuda); null where it is missing
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// [B, S, heads, D] bf16 in boxes of 64 rows x 64 columns of one (batch,
// head), 128-byte swizzle; what lies past D or S reads as zero
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int b,
              int s, int heads, int d) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t row = static_cast<cuuint64_t>(d) * 2;  // bytes
  const cuuint64_t strides[3] = {row, row * heads, row * heads * s};
  const cuuint32_t box[4] = {kAtom, 1, kRowsWG, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kHalves>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
           __nv_bfloat16* o, int b, int s, int hq, int hkv, int d, float scale,
           float softcap, int causal, int window, cudaStream_t stream) {
  constexpr int kBytes = Smem<kHalves>::kBytes;
  // once per process and instantiation
  static const cudaError_t attr = cudaFuncSetAttribute(
      attention_kernel<kHalves>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(b * hq, (s + kRowsWG - 1) / kRowsWG);
  attention_kernel<kHalves><<<grid, kThreads, kBytes, stream>>>(
      mq, mk, mv, o, s, hq, hkv, d, scale, softcap, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// The arguments of one launch, packed by the Python wrapper into one
// buffer (kernels/lib.py::FLASH_ATTENTION_ARGS mirrors this layout field
// by field): pointers and the stream first, then 32-bit fields.
// q [b, s, hq, d], k/v [b, s, hkv, d], o [b, s, hq, d], contiguous; hq a
// multiple of hkv; 1 <= d <= 128; window <= 0 means none, softcap <= 0
// means none.
struct FlashAttentionArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  void* stream;  // a raw cudaStream_t of `device`
  int32_t device;
  int32_t b;
  int32_t s;
  int32_t hq;
  int32_t hkv;
  int32_t d;
  int32_t causal;
  int32_t window;
  float scale;
  float softcap;
};

// sizeof(FlashAttentionArgs), which the wrapper checks its layout against.
extern "C" int flash_attention_args_size() {
  return static_cast<int>(sizeof(FlashAttentionArgs));
}

namespace {

template <typename T>
int launch_scalar(const FlashAttentionArgs* a) {
  const repro_torch::DeviceGuard guard(a->device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  return launch(static_cast<const T*>(a->q), static_cast<const T*>(a->k),
                static_cast<const T*>(a->v), static_cast<T*>(a->o), a->b,
                a->s, a->hq, a->hkv, a->d, a->scale, a->softcap, a->causal,
                a->window, a->stream);
}

}  // namespace

// The scalar route.  Each entry point makes `device` current if it is
// not, launches on `stream` and returns cudaGetLastError().
extern "C" int flash_attention_f32(const FlashAttentionArgs* a) {
  return launch_scalar<float>(a);
}

extern "C" int flash_attention_bf16(const FlashAttentionArgs* a) {
  return launch_scalar<__nv_bfloat16>(a);
}

// The tensor-core route: as above, bf16 only, d % 8 == 0 and q, k, v
// 16-byte aligned (TMA's rule for the base and the row strides).  Returns
// cudaErrorInvalidValue if the operands break that rule or a tensor map
// cannot be built.
extern "C" int flash_attention_bf16_wgmma(const FlashAttentionArgs* a) {
  const repro_torch::DeviceGuard guard(a->device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  const int b = a->b, s = a->s, hq = a->hq, hkv = a->hkv, d = a->d;
  if (b <= 0 || s <= 0 || hq <= 0) return static_cast<int>(cudaGetLastError());
  const bool aligned = ((reinterpret_cast<uintptr_t>(a->q) |
                         reinterpret_cast<uintptr_t>(a->k) |
                         reinterpret_cast<uintptr_t>(a->v)) & 15) == 0;
  if (d % 8 != 0 || d > kMaxD || !aligned) return cudaErrorInvalidValue;
  const tc::EncodeTiled encode = tc::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!tc::make_map(encode, &mq, a->q, b, s, hq, d) ||
      !tc::make_map(encode, &mk, a->k, b, s, hkv, d) ||
      !tc::make_map(encode, &mv, a->v, b, s, hkv, d)) {
    return cudaErrorInvalidValue;
  }
  auto* out = static_cast<__nv_bfloat16*>(a->o);
  auto* st = static_cast<cudaStream_t>(a->stream);
  if (d <= tc::kAtom) {
    return tc::launch<1>(mq, mk, mv, out, b, s, hq, hkv, d, a->scale,
                         a->softcap, a->causal, a->window, st);
  }
  return tc::launch<2>(mq, mk, mv, out, b, s, hq, hkv, d, a->scale,
                       a->softcap, a->causal, a->window, st);
}
