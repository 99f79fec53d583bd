"""The model zoo (serving slice: dense GQA configs such as h2o-danube-3-4b).

* :mod:`repro_torch.models.layers` — norms, MLPs, embeddings;
* :mod:`repro_torch.models.rope` — rotary position embeddings;
* :mod:`repro_torch.models.attention` — GQA prefill (``flash_attention``
  kernel) and cached decode;
* :mod:`repro_torch.models.blocks` — the (attention, dense FFN) block;
* :mod:`repro_torch.models.model` — init, caches, forward, prefill and
  decode steps, :class:`~repro_torch.models.model.Model`.
"""
