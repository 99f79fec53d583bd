"""Hand-written Hopper kernels of the port and their plain versions.

* :mod:`repro_torch.kernels.replay_gather` — the fleet's minibatch gather;
* :mod:`repro_torch.kernels.fused_td` — the TD-target + Huber tail;
* :mod:`repro_torch.kernels.lib` — builds ``csrc/*.cu`` with ``nvcc`` and
  loads the library with ``ctypes``.
"""
