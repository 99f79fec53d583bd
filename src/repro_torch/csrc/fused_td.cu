// fused_td: the whole TD tail of a stacked DQN update, from the Q-values
// to each agent's mean loss and its gradient, in one launch
//
//   a        = the stored action, truncated to an int (as astype(int32))
//   q_sel    = q[a] (a in [-A, -1] wraps; any other a out of range: NaN,
//              as jnp.take_along_axis)
//   target   = r + gamma * (1 - done) * max_a q_next[a]
//   delta    = q_sel - target
//   loss_row = 0.5 * delta^2 if |delta| <= 1 else |delta| - 0.5
//   dq       = clip(delta, -1, 1)
//   loss     = sum_b loss_row / B                         (per agent)
//   grad_q   = dq / B at the selected action, 0 elsewhere
//
// and, when the caller asks for them (non-null pointers), the fleet
// observatory's two per-agent statistics from the same launch:
//
//   td_abs   = sum_b |delta| / B       (the unclipped |delta|'s mean)
//   q_max    = max_{b, a} |q[b, a]|    (NaN if any q is NaN)
//
// Replaces the TPU kernel src/repro/kernels/fused_td/kernel.py
// (fused_td), which computed loss_row and dq over (block_b, A) VMEM tiles
// and required B % block_b == 0; the reference's caller selected q_sel
// before it and took the mean after it in the same XLA program
// (src/repro/rl/fleet.py::make_dqn_loss_fn, ops.py::td_loss).  Here the
// selection, the mean and the gradient's scatter are in the kernel, so
// the stacked step's tail is one launch and one multiply in backward.
//
// Bound: bytes, a few kilobytes at the fleet's shapes (N = 4, B = 32,
// A = 6), so the launch bounds the call.  action, reward and done are
// read from the gathered replay rows [N, B, F] in place: three strided
// 4-byte loads a row, uncoalesced, and cheaper than the copy that would
// coalesce them.
//
// Layout: a CTA per agent, a thread per row (looping when B exceeds the
// block), the max over A in registers.  The per-agent sum is a tree in a
// fixed order (each thread's rows in order, warp shuffles, then the
// warps' partial sums through shared memory), so it is deterministic and
// the same for any N; the block size depends on B alone.  The statistics
// ride the same tree: |delta| is summed beside the loss and max |q| is
// reduced beside it, NaN-propagating at every level (the reference's
// jnp.mean and jnp.max propagate NaN; fmaxf would drop it).  Without
// them the kernel does exactly what it did before they existed: the
// extra work is behind one uniform branch on a null pointer.
//
// The arithmetic is written with round-to-nearest intrinsics so that
// nvcc cannot contract a multiply and an add into an FMA: the kernel then
// rounds exactly as the plain PyTorch version does.  Max and clip
// propagate NaN like torch.max and torch.clamp.  The sum and the gradient
// are divided by B (not multiplied by a rounded 1/B), as the reference's
// jnp.mean and g * dq / B.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"

// The arguments of one launch, packed by the Python wrapper into one
// buffer (kernels/lib.py::FUSED_TD_ARGS mirrors this layout field by
// field): pointers and the stream first, then 32-bit fields.
struct FusedTdArgs {
  const float* q;       // [n, b, a] online net's Q-values
  const float* q_next;  // [n, b, a] target net's Q-values
  const float* rows;    // [n, b, f] gathered replay rows
  float* loss_rows;     // [n, b]
  float* dq;            // [n, b] clip(delta, -1, 1)
  float* loss;          // [n]
  float* grad_q;        // [n, b, a]
  float* td_abs;        // [n] or null: no statistics
  float* q_max;         // [n], null exactly when td_abs is
  void* stream;         // a raw cudaStream_t of `device`
  int32_t device;
  int32_t n;
  int32_t b;
  int32_t a;
  int32_t f;
  int32_t col_action;  // column offsets in a row of `rows`
  int32_t col_reward;
  int32_t col_done;
  float gamma;
};

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;  // lane 0 holds the warp's sum
}

// NaN wins, as in jnp.max: `v > best || v != v` keeps a NaN once seen.
__device__ __forceinline__ float nan_max(float best, float v) {
  return (v > best || v != v) ? v : best;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = nan_max(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;  // lane 0 holds the warp's max
}

__global__ void __launch_bounds__(kMaxThreads) fused_td_kernel(FusedTdArgs p) {
  const int b = p.b, a = p.a;
  const float nb = static_cast<float>(b);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * b;
  const bool stats = p.td_abs != nullptr;
  float part = 0.f, abs_part = 0.f, qmax = 0.f;
  for (int i = threadIdx.x; i < b; i += blockDim.x) {
    const int64_t r = first + i;
    const float* qn = p.q_next + r * a;
    float best = qn[0];
    for (int k = 1; k < a; ++k) {
      const float v = qn[k];
      best = nan_max(best, v);
    }
    const float* row = p.rows + r * p.f;
    // truncates and saturates, NaN to 0: astype(int32) in the reference
    int sel = __float2int_rz(row[p.col_action]);
    if (sel < 0) sel += a;
    const bool valid = sel >= 0 && sel < a;
    const float q_sel = valid ? p.q[r * a + sel] : __int_as_float(0x7fffffff);
    const float discount = __fmul_rn(p.gamma, __fsub_rn(1.0f, row[p.col_done]));
    const float target = __fadd_rn(row[p.col_reward], __fmul_rn(discount, best));
    const float delta = __fsub_rn(q_sel, target);
    const float ad = fabsf(delta);
    const float loss = ad <= 1.0f ? __fmul_rn(__fmul_rn(0.5f, delta), delta)
                                  : __fsub_rn(ad, 0.5f);
    const float clip = delta < -1.0f ? -1.0f : (delta > 1.0f ? 1.0f : delta);
    p.loss_rows[r] = loss;
    p.dq[r] = clip;
    const float g = __fdiv_rn(clip, nb);
    float* gq = p.grad_q + r * a;
    for (int k = 0; k < a; ++k) gq[k] = (valid && k == sel) ? g : 0.f;
    part = __fadd_rn(part, loss);
    if (stats) {
      abs_part = __fadd_rn(abs_part, ad);
      const float* qr = p.q + r * a;
      for (int k = 0; k < a; ++k) qmax = nan_max(qmax, fabsf(qr[k]));
    }
  }
  __shared__ float warp_part[kMaxThreads / 32];
  __shared__ float warp_abs[kMaxThreads / 32];
  __shared__ float warp_qmax[kMaxThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int n_warps = static_cast<int>(blockDim.x / 32);
  part = warp_sum(part);
  if (lane == 0) warp_part[warp] = part;
  if (stats) {
    abs_part = warp_sum(abs_part);
    qmax = warp_max(qmax);
    if (lane == 0) {
      warp_abs[warp] = abs_part;
      warp_qmax[warp] = qmax;
    }
  }
  __syncthreads();
  if (warp == 0) {
    float v = lane < n_warps ? warp_part[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) p.loss[blockIdx.x] = __fdiv_rn(v, nb);
    if (stats) {
      // |q| >= 0, so 0 is the max's identity for the idle lanes
      float s = lane < n_warps ? warp_abs[lane] : 0.f;
      float m = lane < n_warps ? warp_qmax[lane] : 0.f;
      s = warp_sum(s);
      m = warp_max(m);
      if (lane == 0) {
        p.td_abs[blockIdx.x] = __fdiv_rn(s, nb);
        p.q_max[blockIdx.x] = m;
      }
    }
  }
}

}  // namespace

// sizeof(FusedTdArgs), which the wrapper checks its layout against.
extern "C" int fused_td_args_size() {
  return static_cast<int>(sizeof(FusedTdArgs));
}

// Makes `device` current if it is not, launches on `stream` and returns
// cudaGetLastError() (0 on success).  All tensors contiguous, a >= 1.
extern "C" int fused_td_f32(const FusedTdArgs* p) {
  const repro_torch::DeviceGuard guard(p->device);
  if (guard.error() != cudaSuccess) return static_cast<int>(guard.error());
  if (p->n > 0) {
    // a warp per 32 rows up to kMaxThreads: the sum's order follows B only
    const int warps = p->b > 0 ? (p->b + 31) / 32 : 1;
    const int threads = warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads;
    fused_td_kernel<<<p->n, threads, 0, static_cast<cudaStream_t>(p->stream)>>>(*p);
  }
  return static_cast<int>(cudaGetLastError());
}
