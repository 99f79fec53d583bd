// fused_td: the TD-target + Huber tail of a DQN update, per sample
//
//   target = r + gamma * (1 - done) * max_a q_next[a]
//   delta  = q_sel - target
//   loss   = 0.5 * delta^2 if |delta| <= 1 else |delta| - 0.5
//   dq     = clip(delta, -1, 1)
//
// Replaces the TPU kernel src/repro/kernels/fused_td/kernel.py
// (fused_td), which ran the same arithmetic over (block_b, A) VMEM
// tiles and required B % block_b == 0.  Here one thread owns one sample:
// the max over the A actions stays in registers and the tail of the last
// block is masked, so any B works.
//
// Bound: bytes.  Per sample it reads (A + 3) floats and writes 2; at the
// fleet's shapes (N * 32 rows, A = 6) that is a few kilobytes, so the
// launch bounds the call.  The fleet calls it once per train step on the
// flattened rows of every agent, which keeps it to one launch a step.
//
// The arithmetic is written with round-to-nearest intrinsics so that
// nvcc cannot contract a multiply and an add into an FMA: the kernel then
// rounds exactly as the plain PyTorch version does.  Max and clip
// propagate NaN like torch.max and torch.clamp.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

__global__ void fused_td_kernel(const float* __restrict__ q_sel,
                                const float* __restrict__ q_next,
                                const float* __restrict__ reward,
                                const float* __restrict__ done,
                                float* __restrict__ loss,
                                float* __restrict__ dq, int b, int a,
                                float gamma) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  const float* row = q_next + static_cast<int64_t>(i) * a;
  float best = row[0];
  for (int k = 1; k < a; ++k) {
    const float v = row[k];
    best = (v > best || v != v) ? v : best;
  }
  const float discount = __fmul_rn(gamma, __fsub_rn(1.0f, done[i]));
  const float target = __fadd_rn(reward[i], __fmul_rn(discount, best));
  const float delta = __fsub_rn(q_sel[i], target);
  const float ad = fabsf(delta);
  loss[i] = ad <= 1.0f ? __fmul_rn(__fmul_rn(0.5f, delta), delta)
                       : __fsub_rn(ad, 0.5f);
  dq[i] = delta < -1.0f ? -1.0f : (delta > 1.0f ? 1.0f : delta);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int fused_td_f32(const float* q_sel, const float* q_next,
                            const float* reward, const float* done,
                            float* loss, float* dq, int b, int a, float gamma,
                            void* stream) {
  if (b > 0) {
    const int blocks = (b + kThreads - 1) / kThreads;
    fused_td_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        q_sel, q_next, reward, done, loss, dq, b, a, gamma);
  }
  return static_cast<int>(cudaGetLastError());
}
