"""The model zoo: dense GQA, MoE, MLA, M-RoPE and embedding-input configs.

* :mod:`repro_torch.models.layers` — norms, MLPs, embeddings;
* :mod:`repro_torch.models.rope` — rotary position embeddings, M-RoPE;
* :mod:`repro_torch.models.attention` — GQA prefill (``flash_attention``
  kernel) and cached decode, MLA;
* :mod:`repro_torch.models.moe` — the MoE FFN (router, capacity
  dispatch, grouped SwiGLU);
* :mod:`repro_torch.models.blocks` — the (mixer, FFN) blocks;
* :mod:`repro_torch.models.model` — init, caches, forward, prefill and
  decode steps, :class:`~repro_torch.models.model.Model`.
"""
