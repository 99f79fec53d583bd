"""PyTorch/CUDA port of the ADFLL reproduction, for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports none
of it (nor JAX).  Entry points run on the CUDA card unless the caller
passes ``device="cpu"`` (see :mod:`repro_torch.device`).  The two TPU
kernels of the training path are hand-written CUDA under
``repro_torch/csrc/`` (see :mod:`repro_torch.kernels`).
"""
