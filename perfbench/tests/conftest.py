"""The benchmark's CPU tests: ``python -m pytest perfbench/tests``.

They run the harness on the CPU at small sizes (``SMALL``); the tests
marked ``cuda`` need the card and skip without one."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

SMALL_DQN = {
    "volume_shape": [12, 12, 12], "box_size": [4, 4, 4], "n_actions": 6, "frame_history": 1,
    "conv_features": [4, 8], "hidden": [16], "gamma": 0.9, "lr": 0.001, "eps_start": 1.0,
    "eps_end": 0.05, "eps_decay_steps": 100, "target_update": 50, "batch_size": 8,
    "max_episode_steps": 8, "step_size": 1,
}  # fmt: skip
SMALL_LM = {
    "arch": "deepseek-v2-lite-16b-smoke", "hidden_size": 256, "num_attention_heads": 4,
    "head_dim": 64, "intermediate_size": 512, "vocab_size": 512, "n_routed_experts": 4,
    "num_experts_per_tok": 2, "n_shared_experts": 1, "moe_intermediate_size": 128,
    "kv_lora_rank": 64, "qk_rope_head_dim": 16, "qk_nope_head_dim": 32, "v_head_dim": 32,
    "dtype": "float32", "num_hidden_layers": 3,
}  # fmt: skip
SMALL = {
    "adfll-dqn.fleet_paper": {"config": {"dqn": SMALL_DQN}, "traffic": {"warmup_flushes": 3}},
    "deepseek-v2-lite-16b.train": {"config": SMALL_LM, "traffic": {"batch": 2, "seq": 64}},
    "deepseek-v2-lite-16b.decode": {
        "config": dict(SMALL_LM, num_hidden_layers=3),
        "traffic": {"batch": 4, "gen": 8, "cycle": [32, 64, 16]},
    },
}


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
