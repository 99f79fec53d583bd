"""Hand-written Hopper kernels of the port and their plain versions.

* :mod:`repro_torch.kernels.replay_gather` — the fleet's minibatch gather;
* :mod:`repro_torch.kernels.fused_td` — the DQN update's TD tail (action
  select, TD target, Huber loss, per-agent mean and its gradient);
* :mod:`repro_torch.kernels.rmsnorm` — the model zoo's RMSNorm;
* :mod:`repro_torch.kernels.flash_attention` — the model zoo's prefill
  attention;
* :mod:`repro_torch.kernels.kda_step` — Kimi Delta Attention's decode step;
* :mod:`repro_torch.kernels.kda_chunk` — Kimi Delta Attention's chunked
  prefill;
* :mod:`repro_torch.kernels.mhc` — kernel G, a site of the
  manifold-constrained hyper-connection residual (Xing4.0);
* :mod:`repro_torch.kernels.lib` — builds ``csrc/*.cu`` with ``nvcc`` and
  loads the library with ``ctypes``;
* :mod:`repro_torch.kernels.graphs` — the port's CUDA-graph capture and
  replay, and the kernels' launch counts across them;
* :mod:`repro_torch.kernels.launch_cost` — what a kernel call costs.
"""
