"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure ends the run with a
non-zero exit code and no result line:

1. device  — the card's name and power limit (``nvidia-smi``); no CUDA,
   no run.
2. build   — compile ``src/repro_torch/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a`` and load the library.
3. kernels — each hand-written kernel against its plain PyTorch version
   on the card, at the fleet's shapes and at a ragged shape (and
   ``replay_gather`` in every 16-byte phase of its rows; ``fused_td``, the
   whole TD tail, also with one action, with out-of-range actions and
   through its gradient, and timed as forward and backward of the tail
   through autograd, ``tail_ms``; in all four cases also with the fleet
   observatory's statistics ``td_abs`` and ``q_max`` against the plain
   version's within 1e-6, NaN where it has NaN, its other outputs bit
   for bit those without statistics, timed as ``stats_ms``), with times for
   the kernel, the plain version and (where one exists) a single PyTorch
   library call, and the least time the card could take (bytes over 3.35
   TB/s; both kernels are bound by bytes).  Three times per kernel (see
   ``repro_torch/kernels/launch_cost.py``): ``ms``, CUDA events around
   back-to-back calls from Python (host and device together);
   ``device_ms``, 100 calls captured in one CUDA graph and replayed
   (the device alone; capture also proves the call capturable), with
   ``library_device_ms`` the same for the library call; ``floor_ms``, one
   ATen elementwise launch (``torch.mul`` that keeps its operand's dtype)
   on a tensor of about the call's output size, timed like ``ms``: the
   least one launch from Python costs on this host.
4. chunk   — one ``FleetSteps.train_chunk`` at ``DQNConfig()`` widths
   (N=4 agents, K=4 steps) on the card and on the CPU from one state,
   pool and index tensor; params must agree within 1e-4.
5. main    — the paper's deployment experiment (``paper_fig2``, fast
   variant, with ``DQNConfig()`` swapped in) through the port's runner
   on the card, with each kernel's launch count read around that run
   alone: every stacked train step launches each kernel once.
6. baselines — the paper's Table 1 comparison rows and FedAvg through
   the port's runner on the card, each at ``DQNConfig()``, ``--fast``,
   with launches read around each run alone: Agent X
   (``baseline_all_knowing``: one job of 20 x 8 steps), Agent Y
   (``baseline_partial``: 20 steps), Agent M (``baseline_sequential``:
   8 rounds of 20, one flush each) and ``fedavg_sync`` (3 agents, 2
   rounds of 8 on one shared engine); every stacked step launches each
   of ``replay_gather`` and ``fused_td`` once, and after FedAvg every
   agent holds agent 0's params bit for bit.  Agent M runs on the CPU
   too, from the same init (drawn on the host): round 0's loss must
   agree within 1e-4 (its collection is all exploration, so both sides
   replay the same rows); later rounds are printed beside each other.
7. sweep — ``paper_table1_sweep`` (ADFLL against Agents X, Y and M) at
   the registry's widths, seeds 0 and 1, ``--fast``, inline
   (``workers=1``): every cell ``ok`` with a finite error; each
   variant's mean and its paired p-values against ADFLL are printed.
8. topology — the topology ablation's ``topo_gossip_topk`` (hub-less
   gossip, weights as int8 top-k deltas) and ``topo_hybrid`` (hubs and
   gossip at once, dense weights) at ``DQNConfig()``, ``--fast``:
   every round recorded, weight snapshots mixed, one launch of each
   fleet kernel per stacked step, and top-k's weight messages at least
   4x below the dense ``4 * numel`` bytes.
9. stepwise — ``paper_fig2`` at ``DQNConfig()``, ``--fast``, on
   ``engine="stepwise"`` (each agent its own state, one dispatch a
   step): one ``fused_td`` launch per agent step, one ``replay_gather``
   launch per replay pick, printed beside the fleet's ``main`` numbers.
10. main_card_vs_cpu — ``paper_fig2 --fast`` at ``DQNConfig()`` on the
   card and on the CPU from one init (drawn on the host): each round's
   loss side by side, the first round past 1e-4, the largest parameter
   difference after the first flush, both errors; round 0 within 1e-4.
11. population — churn, hub failures and a wide fleet at ``DQNConfig()``
   through the port's runner, launches read around each run alone:
   ``paper_table2_hub_failure --fast`` (hub 2 dies at t = 1.5 and
   strands agents 2 and 3; the probe at 1.5 sees 4 agents),
   ``paper_table2_hybrid_failover --fast`` (every hub dies; gossip
   keeps delivering), ``churn_addition_fig4 --fast`` (4 -> 16 agents,
   the resident axis growing 4 -> 8 -> 16 mid-run; probes at 4, 8, 12)
   and ``flash_crowd`` at its full population (4 + 200 agents on one
   engine of capacity 256) with ``--fast``'s 8 train steps a round.
   Cuts, to evaluation only: one patient throughout, and one task for
   flash_crowd.  Each run: one launch of each fleet kernel per stacked
   step, every joined agent's rounds (agents x rounds), finite errors
   at every probe.  Then ``paper_table2_hub_failure`` through the sweep
   runner as in phase 7 (``--fast``, seeds 0 and 1, 8 cells).
12. serve — the localization serving plane (train-while-serve) at
   ``DQNConfig()``, launches read around each run alone: (a)
   ``serve_localization --fast`` through the port's runner (2 agents, 32
   requests, ``max_batch`` 8, two waves around one round of 8 steps):
   every request answered, a finite error, no new act shape after
   warmup, a hot swap, versions {0, 1}, one launch of each fleet kernel
   per stacked step; (b) one ``build_session`` (4 agents, 128 requests,
   2 waves around one round of 20 steps) served at ``max_batch`` 1 and
   16 from identical seeds: every request's final voxel, ticks and
   pinned version identical, 20 launches of each fleet kernel in each,
   requests/s, p50/p99 latency and ticks per request side by side; (c)
   ``ActSteps`` on 16 requests batched against each dispatched alone on
   the card (max |dq| printed), and against the CPU (within 1e-4); (d)
   the batched session of (b) again with enabled telemetry (the fleet
   observatory on): every request identical to (b)'s, 20 launches of
   each fleet kernel.
13. kernels — the model zoo's ``rmsnorm`` and ``flash_attention`` against
   their plain versions on the card at the serving path's shapes (of
   h2o-danube-3-4b, and the prefills of every other zoo_main arch:
   head_dim 128 for qwen2.5-14b, starcoder2-15b, qwen2-vl-2b (12/2),
   qwen3-moe (64/4), moonshot (16/16), deepseek-v2-lite's dense prefix
   layer (16/16 at S = 480) and jamba's attention layer (64/8),
   musicgen-medium at 24/24 of 64; rmsnorm also
   at qwen's d 5120, at qwen2-vl's 1536, moonshot's 2048, qwen3-moe's
   4096, jamba's 8192 and xlstm's 768, prefill and decode, and at
   danube's train step [2048, 3840]) and at
   ragged / windowed / softcapped / odd-head-dim ones, each attention case
   on the route it must take (tensor cores for bf16 with D % 8 == 0, the
   scalar kernel otherwise), timed like phase 3 beside one PyTorch library
   call (attention: SDPA with the boolean mask, and with ``is_causal``
   where the window does not bind); rmsnorm is bound by bytes, attention
   by operations (4 B Hq D flops per unmasked pair at the dtype's peak).
   rmsnorm's cases cover both of its routes (``cta``, ``masked``), and
   each must move its route's launch count.  rmsnorm's backward
   (``RMSNorm``: the kernel forward, a plain float32 backward) against
   autograd through the plain version at the train shape, bf16 and f32
   (3e-2 and 1e-5 of each output's largest magnitude).  Then ``kda_step``
   (E, Kimi Delta Attention's fused decode step) against its plain
   version at Kimi-Linear's decode shape (B 128, H 32, d 128) in bf16 and
   float32 and at a ragged one (B 3, H 5, d 72), three steps each from
   one state (the state within 1e-5 of its largest magnitude, ``o``
   within 2**-7 in bf16 and 1e-5 in float32), the bf16 call timed like
   phase 3 (no library call computes it) against its bytes' bound (543
   MB at B 128 over 3.35 TB/s).  Then ``kda_chunk`` (F, KDA's chunked
   prefill from a zero state) against its plain version at the main
   path's slice (32 rows of 128 x 1024, H 32, d 128, o in bf16), in
   float32 (2 rows) and at a ragged one (B 3, S 200, H 5, d 72), decays
   whose negation overflows: the state within 1e-4 of its largest
   magnitude, ``o`` within 1e-4 (float32) or 2**-7 (bf16) of its
   largest; the slice timed (``device_ms`` over 10 calls in a graph)
   against its operations' bound (FFMA at 67 TFLOP/s) and its bytes'.
14. zoo_chunk — a reduced float32 h2o-danube-3-4b (2 kv heads, window 64)
   on the card and on the CPU from the same params and tokens: prefill
   of 96 tokens (past the window), then 8 decode steps; logits must
   agree within 1e-4.
15. zoo_main — ``python -m repro_torch.launch.serve`` at full width for
   h2o-danube-3-4b, qwen2.5-14b, starcoder2-15b, qwen2-vl-2b (M-RoPE,
   embeds in), musicgen-medium (embeds in, LayerNorm),
   qwen3-moe-235b-a22b (MoE; cut to 8 of its 94 layers),
   moonshot-v1-16b-a3b (MoE with shared experts, a dense prefix layer),
   deepseek-v2-lite-16b (MLA, MoE, the dense prefix; prompt cut to
   480), jamba-1.5-large-398b (Mamba, MoE; cut to its first 4 of 72
   layers: (mamba, moe), (mamba, dense), (mamba, moe), (attn, dense))
   and xlstm-125m (mLSTM and sLSTM, no FFN; full depth) in turn, each in
   bfloat16, random weights drawn on the card from seed 0, batch 4,
   prompt 1000, 32 greedy steps, freed before the next; launches read
   around the prefill and decode alone (``flash_attention`` once an
   attention layer, all on the tensor-core route: 24, 48, 40, 28, 48, 8,
   48, 1, 1, 0; ``rmsnorm`` a norm per mixer, per FFN and the final one,
   x 33, all on the ``cta`` route: 1617 for danube, 3201 for qwen and
   moonshot, 1881 for qwen2-vl, 561 for qwen3-moe, 1815 for deepseek,
   297 for jamba, 429 for xlstm, none for starcoder2's and musicgen's
   LayerNorm), then decode logits at 4
   positions against the teacher-forced ``forward`` on the card (an MoE
   arch: on a second generation at capacity factor 16, where no pair is
   dropped; the timed one runs at the published 1.25 and prints the
   pairs it dropped at prefill and at decode, counted on an eager twin
   of it: the timed decode replays the model's CUDA graphs, which make
   no Python call to record).  Init, peak memory,
   prefill and decode times printed for each.  Then
   kimi-linear-48b-a3b-ep4 (KDA, NoPE MLA, the sigmoid router; one card's
   64 of 256 experts a layer, full depth) the same way at prompt 1024:
   E 20 x 32 (one a KDA layer a decode step, none at prefill), C a norm
   per mixer, per FFN, the final one and KDA's output norm, (55 + 20) x
   33, all ``cta``, D never; finite logits.
16. observatory (run after the Table 2 sweep, before phase 13) —
   ``paper_fig2 --fast`` at ``DQNConfig()`` (4 agents, ``share_planes``
   as registered; evaluation cut to one patient) twice with telemetry
   off and once with ``Telemetry(enabled=True)``: the round records,
   losses and ``mean_dist_err`` of the observed run equal the
   unobserved one's (if the two unobserved runs differ, that is printed
   and the observed one is held to what they allow); A = B = stacked
   steps (80) in both; every agent's learning series finite,
   ``params_finite`` true at every flush, no ``alert`` in the health
   verdict; the trace written as JSONL and Perfetto and loaded back,
   its ``fleet.flushes`` counter equal to the engine's flushes; the
   training wall off and on (three more runs each way, in turns; the
   ratio of the medians), and a stacked step's device operations and
   device time with statistics on and off
   (``repro_torch.experiments.profile._profile_steps``).

17. cli (after the observatory) — the reference CI's experiments call
   through the port's CLI: ``--scenario churn_addition_fig4 --scenario
   gossip_hetero --fast --json --trace --dashboard`` into a temporary
   directory; exit 0, the per-scenario traces and dashboards, the JSON's
   keys those of ``benchmarks/baselines/BENCH_experiments.json``, one
   launch of each fleet kernel per stacked step.
18. lm_train_chunk (before zoo_main) — a reduced float32 h2o-danube-3-4b,
   deepseek-v2-lite-16b-smoke (MoE, MLA, the dense prefix) and
   qwen2-vl-2b-smoke (embeds, M-RoPE positions [3, B, S]), each card vs
   CPU from one init: ``loss_fn`` and its backward (loss and router loss
   1e-5 relative, every gradient leaf within 1e-4 of its largest
   magnitude and non-zero on the card, the routers' included; an embeds
   config's unused token table excepted), one ``train_step`` each way,
   one at ``microbatches=2``; C a norm per mixer, per FFN and the final
   one a forward (2L + 1 where every block has an FFN) and, as every
   train step here rematerialises per layer (``ShardingPolicy()``), each
   group's norms again in the backward (``norms_recomputed``: its blocks
   but the last, then each block), D never; also
   jamba-1.5-large-398b-smoke (Mamba, MoE) and xlstm-125m-smoke (mLSTM,
   sLSTM).
19. lm_train_main — ``python -m repro_torch.launch.train`` for
   h2o-danube-3-4b at full width and depth in bfloat16 with float32
   moments, batch 2, seq 1024, 4 steps: finite losses, ``gnorm > 0``
   every step, C (2L + 1 + 2L recomputed = 97) x 4 times, D never; wall,
   tokens a second and peak memory printed.
   lm_train_remat (after lm_train_main) — per-layer rematerialisation
   at full width and depth: (a) danube's loss and gradients at batch 2,
   seq 1024 from one init and batch without remat and with (loss 1e-5
   relative, every gradient leaf 1e-4 of its scale, the max |delta| of
   each printed; C 49 and 97, D never; each forward and backward's time
   and peak); (b) ``launch.train`` at batch 4, seq 4096, 3 steps (finite
   losses, ``gnorm > 0``, C 97 x 3, D never), its peak beside
   ``dryrun.run_pair``'s estimates at that shape with remat and without
   (the resident part of each at most the peak).
20. zoo_window (after zoo_main) — the sliding-window prefill -> decode
   handoff at full width: h2o-danube-3-4b (window 4096), batch 1, a
   prompt of 4100 tokens (past the window, no multiple of it), 8 greedy
   steps, each step's logits against the teacher-forced forward at 3e-2
   of the largest logit; D 24, C 49 x 9.
21. examples (after zoo_window) — the four ``examples/torch_*.py`` on the
   card, steps cut and widths never: ``torch_train_lm_125m`` (xlstm-125m
   at full width and depth, batch 4, seq 256, 3 steps, its checkpoint in
   a temporary directory: finite losses, ``gnorm > 0``, C (13 + 18
   recomputed) x 3, D never), ``torch_quickstart`` (the zoo, two agents
   through a hub, D's scalar float32 route against its plain version
   within 2e-5: one scalar launch), ``torch_adfll_deployment --fast`` and
   ``torch_federated_lm`` at its steps (the per-style loss table);
   A = B over the phase, D exactly the quickstart's one scalar launch.
22. planner — ``launch/dryrun.py::run_pair`` at one card on ``meta``:
   lm_train_main's step and every zoo_main arch's serving, each
   estimate (params, optimizer, gradients, caches, saved activations)
   beside the peak measured above; the resident part must not exceed
   it; the planned FLOPs of danube's step over its CUDA-event time as
   a share of 989 TFLOP/s.  No kernel launches.
23. fleet_mesh (run after serve, before table2_sweep) — the fleet axis on
   a device mesh: every visible card (``make_fleet_mesh(-1)``) where
   there are several; with one card ``make_fleet_mesh(-1)`` must give no
   mesh and the mesh is ``FleetMesh((cuda:0,) * 4)``, which runs every
   part of the sharded path on the one card (not copies between cards,
   nor overlap across them).  ``paper_fig2 --fast`` at ``DQNConfig()``
   through ``ADFLLSystem`` with ``make_fleet_mesh`` giving that mesh for
   this run alone: the main phase's round records, each round's loss
   and every slot's params after the first flush bit for bit (one agent
   a shard trains as two lanes, so its convolution is the unsharded
   one's grouped convolution), ``mean_dist_err`` within 1e-4; A and B launched once per
   shard with jobs per stacked step (``n_shard_steps``: 3 x 80 for its 3
   agents on 4 shards, one of them idle); training and
   evaluation walls and a stacked step's device time and operations
   beside the unsharded run's.  flash_crowd's widest stacked step (N =
   183, 4 steps) whole and over 2 and 4 same-card shards (device time a
   step; numbers, not a claim).  Phase 12 (b)'s batched session on the
   mesh: every request's voxel, ticks and version those of the
   unsharded session, A = B = 20 x 4 shard steps.
24. moe_ep (after zoo_window) — expert-parallel MoE through a one-rank
   NCCL group and its ``(data 1, model 1)`` ``DeviceMesh``
   (``launch/mesh.py::one_rank_device_mesh``, torn down after the
   phase).  (a) qwen3-moe-235b-a22b at full width and zoo_main's 8 of 94
   layers through ``Model(mesh=)`` against the mesh-less model on the
   same params: the prefill's last logits and 4 decode steps' logits
   bit for bit (model 1 takes the local path, as in the reference); D
   once an attention layer a prefill (two prefills: 16), C a norm per
   mixer, per FFN and the final one, x 6 (102).  (b) the per-shard body
   forced past ``moe_apply``'s routing at n_model = 1 on one layer at
   full width (E 128, top-k 8, d_ff_expert 1536, bf16): train at T =
   4000 (the all-to-all branch) and decode at T = 4 (the psum branch),
   ``y`` and the router loss bit for bit the local path's; the layer's
   time both ways and each NCCL collective's time and bytes (CUDA
   events).  Ranks past one need cards this machine does not have: the
   multi-rank proof is ``tests/test_torch_moe_ep.py``, over gloo on the
   CPU.
   ``lm_train_mesh`` (after ``moe_ep``): the zoo's tensor, sequence and
   FSDP parallel body on a one-rank NCCL ``(data 1, model 1)`` mesh, where
   every collective is issued over groups of one.  h2o-danube-3-4b at full
   width and depth (bf16, float32 moments, seed 0), batch 2, seq 1024,
   3 train steps through ``Model(mesh=)``, then a prefill of the batch
   and 4 decode steps of fixed tokens; the mesh-less model runs the same
   from the same init after the first is freed.  Each step's loss and
   grad norm within 1e-5 relative, every param within 1e-4 of its leaf's
   scale, the logits within 3e-2; printed: the max |delta| of each, the
   step walls both ways (CUDA events), the peaks, the collectives a step
   with their bytes, one all-gather's and one reduce-scatter's time at
   an FFN weight (a copy through NCCL at one rank), C's and D's launches (C a norm per mixer, per FFN
   and the final one a forward, the groups' again in a train step's
   recompute: 97 x 3 steps + 49 x 5 serving passes; D 24 for the
   prefill).  The meshed train steps also without remat
   (``ShardingPolicy(remat=False)``: C 49 x 3), held to the same
   tolerances, its peak and collectives beside the rematerialised run's:
   the all-gathers a step must rise by exactly the recomputed ones, each
   group's blocks' forward gathers as the plain step issues them (its
   blocks but the last, then each block).  Then ``launch/train.py::train_on_mesh`` (the
   ``--production-mesh`` body) on the same mesh for 2 steps of
   h2o-danube-3-4b-smoke.  The multi-rank proof is
   ``tests/test_torch_zoo_mesh.py``, over gloo on the CPU.
   ``lm_mixers_mesh`` (after ``lm_train_mesh``, on the same kind of
   one-rank NCCL mesh): MLA, Mamba, mLSTM and sLSTM in their
   tensor-parallel regions, every leaf in its ``leaf_pspec`` block and
   every cache in its ``cache_pspec`` block (MLA's latent cache a
   sequence block read by the split-K combine), each config through
   ``Model(mesh=)`` against the mesh-less model from the same init at
   full width (bf16): deepseek-v2-lite-16b at full depth, a prefill of
   batch 2 at prompt 480 and 4 decode steps, then 3 train steps at 6 of
   27 layers (batch 2, seq 1024); jamba-1.5-large-398b at 4 of 72 layers
   (zoo_main's depth), a prefill of batch 2 at prompt 480 and 4 decode
   steps, then its (mamba, dense) block's forward and backward through
   ``block_apply(layout=)`` at batch 1, seq 1024 against the mesh-less
   block (no layer set with an MoE layer trains on one card); xlstm-125m
   at full width and depth, a prefill of batch 4 at prompt 256 and 4
   decode steps, then 3 train steps at 4 of its 12 layers (batch 4, seq
   128: the rematerialised step runs its host-bound token loops
   again).  lm_train_mesh's
   tolerances (loss and grad norm 1e-5 relative, params and the block's output and gradients 1e-4 of
   scale, logits 3e-2); printed: the max |delta| of each, the step,
   prefill and decode walls both ways (CUDA events), the peaks, the
   collectives a step or a serving pass with their bytes, and C's and
   D's launches (C a norm per mixer, per FFN and the final one a
   forward, and a train step's recomputed groups' norms; D once an
   attention layer a prefill: deepseek's dense prefix
   layer and jamba's attention layer).  The multi-rank proof is
   ``tests/test_torch_mixers_mesh.py``, over gloo on the CPU.

Then the script's wall time, one line with the card as ``nvidia-smi``
reports it, one ``{"kernels": [...]}`` line, and last ``{"ok": true,
"device": ...}``.  ``replay_gather`` and ``fused_td`` run on the fleet
paths (main, baselines, sweep, topology, population, serve, fleet_mesh,
table2_sweep, observatory, cli, examples) and the stepwise path,
``rmsnorm`` and ``flash_attention`` on the zoo's (lm_train_chunk,
lm_train_main, lm_train_remat, zoo_main for each arch, zoo_window, moe_ep,
lm_train_mesh,
lm_mixers_mesh and examples), ``kda_step`` and ``kda_chunk`` on
Kimi-Linear's zoo_main; the planner path launches none.  Every entry
carries ``launches_by_path`` and ``launches`` is its sum.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs.adfll_dqn import DQNConfig  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    ATTN,
    FFN_DENSE,
    FFN_MOE,
    FFN_NONE,
    KDA,
    MAMBA,
    InputShape,
    get_config,
)
from repro_torch.core.erb import flat_columns, flat_width  # noqa: E402
from repro_torch.core.experiment import ExperimentHooks  # noqa: E402
from repro_torch.core import federated  # noqa: E402
from repro_torch.experiments import __main__ as experiments_cli  # noqa: E402
from repro_torch.experiments.profile import _profile_steps  # noqa: E402
from repro_torch.experiments.registry import get_scenario  # noqa: E402
from repro_torch.experiments.runner import build, evaluate_into  # noqa: E402
from repro_torch.rl.agent import DQNAgent  # noqa: E402
from repro_torch.sweeps import failed_cells, get_sweep, run_sweep  # noqa: E402
from repro_torch.kernels import lib  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    attention_plain,
    flash_attention,
    route,
)
from repro_torch.kernels.fused_td import fused_td, fused_td_plain, td_loss  # noqa: E402
from repro_torch.kernels.kda_chunk import kda_chunk, kda_chunk_plain  # noqa: E402
from repro_torch.kernels.kda_step import kda_step, kda_step_plain  # noqa: E402
from repro_torch.kernels.mhc import mhc, mhc_post_plain, mhc_pre_plain  # noqa: E402
from repro_torch.kernels.launch_cost import cuda_ms, graph_ms  # noqa: E402
from repro_torch.kernels.replay_gather import (  # noqa: E402
    replay_gather,
    replay_gather_plain,
)
from repro_torch.kernels.rmsnorm import RMSNorm, rmsnorm, rmsnorm_plain  # noqa: E402
from repro_torch.launch import dryrun, profile_serve, serve  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    PEAK_FLOPS_BF16,
    make_local_mesh,
    one_rank_device_mesh,
)
from repro_torch.models import model as model_module  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    Model,
    forward,
    logits_fn,
    make_loss_fn,
    make_train_step,
)
from repro_torch.models import spmd  # noqa: E402
from repro_torch.models.blocks import block_apply, block_init  # noqa: E402
from repro_torch.models.layers import named_ranges, torch_dtype  # noqa: E402
from repro_torch.models.sharding import (  # noqa: E402
    ShardingPolicy,
    mesh_axes,
    param_specs,
)
from repro_torch.models.spmd import make_layout  # noqa: E402
from repro_torch.models.rope import positions_for  # noqa: E402
from repro_torch.data.pipeline import TokenStreamConfig, token_batches  # noqa: E402
from repro_torch.launch.specs import opt_cfg_for  # noqa: E402
from repro_torch.models.sharding import FleetMesh, make_fleet_mesh  # noqa: E402
from repro_torch.optim.adamw import (  # noqa: E402
    AdamWConfig,
    leaves,
    tree_adamw_init,
    tree_leaves,
)
from repro_torch.rl.dqn import dqn_init  # noqa: E402
from repro_torch.rl.fleet import (  # noqa: E402
    ActSteps,
    FleetEngine,
    FleetSteps,
    tree_map,
)
from repro_torch.serve import TrafficSpec, build_session, run_session  # noqa: E402
from repro_torch.serve import driver as serve_driver  # noqa: E402
from repro_torch.telemetry import Telemetry, load_trace, write_trace  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# dense peaks of one H100 SXM at 700 W (NVIDIA data sheet): bf16 on the
# tensor cores, float32 outside them
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
N_AGENTS, BATCH = 4, 32  # the fleet's minibatch rows per step: N * B
ZOO_ARCH = "h2o-danube-3-4b"
# zoo_main serves each at full width; the first is the zoo's reference arch
ZOO_ARCHS = (
    ZOO_ARCH,
    "qwen2.5-14b",
    "starcoder2-15b",
    "qwen2-vl-2b",
    "musicgen-medium",
    "qwen3-moe-235b-a22b",
    "moonshot-v1-16b-a3b",
    "deepseek-v2-lite-16b",
    "jamba-1.5-large-398b",
    "xlstm-125m",
)
ZOO_BATCH, ZOO_PROMPT, ZOO_GEN = 4, 1000, 32
# served apart from ZOO_ARCHS (the planner refuses KDA, mHC and a held share)
KIMI_ARCH = "kimi-linear-48b-a3b-ep4"
XING_ARCH = "xing4.0-29b-a4b-ep4"
# zoo_main's cuts (launch/profile_serve.py): deepseek-v2-lite at prompt
# 480, qwen3-moe at 8 of its 94 layers, jamba-1.5-large at 4 of its 72
ZOO_PROMPTS, ZOO_LAYERS = profile_serve.PROMPTS, profile_serve.LAYERS
# moe_ep: qwen3-moe through Model(mesh=) on a one-rank (data, model) mesh,
# (a) at zoo_main's depth and (b) one layer's per-shard body at these T
MOE_ARCH = "qwen3-moe-235b-a22b"
MOE_EP_GEN = 4
MOE_EP_TOKENS = {"train": 4000, "decode": 4}
MOE_EP_TOL = 0.0  # (b) against the local path: the same products, one rank
# lm_train_mesh: danube's train steps and serving passes on a one-rank mesh
MESH_STEPS, MESH_GEN = 3, 4
MESH_REL, MESH_PARAM_TOL, MESH_LOGITS_TOL = 1e-5, 1e-4, 3e-2
# lm_mixers_mesh: arch -> ((serving depth or None, batch, prompt), (train
# depth or None, batch, seq) or None: jamba's (mamba, dense) block instead)
MIXERS_GEN = 4
MIXERS = {
    "deepseek-v2-lite-16b": ((None, 2, 480), (6, 2, 1024)),
    "jamba-1.5-large-398b": ((4, 2, 480), None),
    # xlstm trains at 4 of its 12 layers: its host-bound token loops run
    # again in the rematerialised step's recompute
    "xlstm-125m": ((None, 4, 256), (4, 4, 128)),
}
MAMBA_BLOCK = (1, 1024)  # batch, seq of jamba's (mamba, dense) block
# zoo_window: danube's window handoff, a prompt past 4096 and no multiple of it
WINDOW_PROMPT, WINDOW_GEN = 4100, 8
# zoo_main's float32 decode check of the MoE archs: full width, the depth
# that fits the card with capacity factor 16's buffers
ZOO_F32_LAYERS = {
    "qwen3-moe-235b-a22b": 2,
    "moonshot-v1-16b-a3b": 6,
    "deepseek-v2-lite-16b": 6,
    "jamba-1.5-large-398b": 2,
}
# and its prompt where capacity factor 16's buffers need a shorter one:
# jamba's 2 float32 layers hold 48.7 GB; at prompt 256 the forward's
# T = 4 x 288 tokens give C = 2304 rows an expert, three [16, 2304, 24576]
# float32 buffers of 3.6 GB at once (at prompt 1000, 13 GB each)
ZOO_F32_PROMPTS = {"jamba-1.5-large-398b": 256}
# lm_train_main: launch.train at full width
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 1024, 4
# lm_train_remat (b): launch.train at 16,384 tokens a step, rematerialised
REMAT_BATCH, REMAT_SEQ, REMAT_STEPS = 4, 4096, 3
# examples: examples/torch_train_lm_125m.py (xlstm-125m at full width and
# depth) for a few steps at the example's batch and sequence
EXAMPLE_ARCH = "xlstm-125m"
EXAMPLE_BATCH, EXAMPLE_SEQ, EXAMPLE_STEPS = 4, 256, 3
# quickstart's attention call: float32 [1, 128, 4|2, 32], D's scalar route
QUICKSTART_ATTENTION = (1, 128, 4, 2, 32)
# the reference CI's experiments smoke (.github/workflows/ci.yml)
CLI_SCENARIOS = ("churn_addition_fig4", "gossip_hetero")
ROOT = Path(__file__).resolve().parent
BENCH_BASELINE = ROOT / "benchmarks" / "baselines" / "BENCH_experiments.json"
RMS_EPS = get_config(ZOO_ARCH).norm_eps
KERNELS = (replay_gather, fused_td, rmsnorm, flash_attention, kda_step, kda_chunk, mhc)
FLEET_KERNELS = ("replay_gather", "fused_td")
# Table 1 / FedAvg scenarios: (n_rounds, stacked train steps) at --fast
BASELINES = {
    "baseline_all_knowing": (1, 160),
    "baseline_partial": (1, 20),
    "baseline_sequential": (8, 160),
    "fedavg_sync": (6, 16),
}
# sub-entries and extra times a kernel's entry of the kernels line carries
EXTRA_FIELDS = (
    "qwen25_14b_prefill",
    "qwen25_14b_decode",
    "starcoder2_15b_prefill",
    "qwen2_vl_2b_prefill",
    "qwen2_vl_2b_decode",
    "musicgen_medium_prefill",
    "qwen3_moe_235b_a22b_prefill",
    "qwen3_moe_235b_a22b_decode",
    "moonshot_v1_16b_a3b_prefill",
    "moonshot_v1_16b_a3b_decode",
    "deepseek_v2_lite_16b_prefill",
    "jamba_15_large_398b_prefill",
    "jamba_15_large_398b_decode",
    "xlstm_125m_prefill",
    "xlstm_125m_decode",
    "train",
    "backward",
    "launches_by_path",
    "stats_ms",
    "stats_device_ms",
    "stats_bound_ms",
    "tail_ms",
    "plain_tail_ms",
    "tail_floor_ms",
    "decode",
    "window",
    "library_causal_ms",
    "library_causal_device_ms",
    "xlstm_125m_train",
    "quickstart_scalar",
    "operations_ms",
    "bytes_ms",
    "gflop",
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def norms_per_forward(cfg) -> int:
    """C launches of one forward of an RMSNorm config: a norm before every
    mixer, one before every FFN (xLSTM's blocks have none) and the final
    norm."""
    return sum(1 + (ffn != FFN_NONE) for _, ffn in cfg.layer_pattern) + 1


def norms_recomputed(cfg) -> int:
    """C launches a rematerialised train step (``ShardingPolicy.remat``,
    the default) adds to a forward's: each group's recompute runs its
    blocks but the last (the checkpoint stops once the last block's input
    is saved), then each block's recompute its own norms; the dense prefix
    and the final norm are not recomputed."""
    per = [1 + (ffn != FFN_NONE) for _, ffn in cfg.pattern]
    return cfg.n_groups * (2 * sum(per) - per[-1])


def norms_per_train_forward(cfg) -> int:
    """C launches of one rematerialised forward and its backward."""
    return norms_per_forward(cfg) + norms_recomputed(cfg)


def sector_bytes(base: int, offsets) -> int:
    """Bytes of the distinct 32-byte sectors that 4-byte loads at byte
    ``offsets`` from address ``base`` touch: what a gather must move."""
    return 32 * len({(base + int(o)) // 32 for o in offsets})


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing to run")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    ).stdout.strip()
    emit(
        {
            "phase": "device",
            "name": name,
            "count": torch.cuda.device_count(),
            "nvidia_smi": smi,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
        }
    )
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    path = lib.build()
    lib.load()
    emit({"phase": "build", "library": str(path), "seconds": time.perf_counter() - t0})


def timings(fn, library, floor, **kw) -> dict:
    """``ms`` and ``device_ms`` of the kernel's call, the same two of the
    library call (None where there is none), and ``floor_ms``."""
    return {
        "ms": cuda_ms(fn, **kw),
        "device_ms": graph_ms(fn),
        "library_ms": None if library is None else cuda_ms(library, **kw),
        "library_device_ms": None if library is None else graph_ms(library),
        "floor_ms": cuda_ms(floor, **kw),
    }


def check_replay_gather(dev) -> dict:
    """The main path's call (w = 1 over N * B rows), a weighted one, a
    narrow one, and every (destination, source) phase of a 16-byte vector
    at the fleet's width: output rows i of each i % 4 read pool rows of
    each idx % 4 (1033 = 1 mod 4), from a pool based on and 4 bytes off a
    16-byte boundary.  Exact: a copy and one multiply."""
    rng = np.random.default_rng(0)
    feat = flat_width(DQNConfig().box_size)  # 1033
    worst = 0.0
    timed = None
    rows = N_AGENTS * BATCH
    i = np.arange(64)
    phased = 4 * (i // 4 + 3 * (i % 7)) + (i // 16 + i) % 4  # all 16 pairs
    cases = (
        (16384, feat, rng.integers(0, 16384, rows), True, 0),
        (16384, feat, rng.integers(0, 16384, rows), False, 0),
        (128, 33, rng.integers(0, 128, 5), False, 0),
        (256, feat, phased, False, 0),
        (256, feat, phased, False, 1),
    )
    for cap, f, idx_np, unit_w, offset in cases:
        b = len(idx_np)
        flat = torch.tensor(rng.standard_normal(cap * f + offset), dtype=torch.float32)
        pool = flat.to(dev)[offset:].view(cap, f)  # contiguous, maybe 4 B off
        idx = torch.tensor(idx_np, dtype=torch.int32, device=dev)
        w = torch.tensor(np.ones(b) if unit_w else rng.random(b), dtype=torch.float32)
        w = w.to(dev)
        got = replay_gather(pool, idx, w)
        want = replay_gather_plain(pool, idx, w)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        what = f"replay_gather {cap}x{f}/{b}, pool {4 * offset} B off"
        require(torch.equal(got, want), f"{what}: max|d|={err}")
        worst = max(worst, err)
        if timed is None:  # the main path's call: w = 1 over N*B rows
            read = int(torch.unique(idx).numel())  # rows this call must read
            w_col = w[:, None]
            nbytes = read * f * 4 + b * f * 4 + b * 8
            timed = {
                **timings(
                    lambda: replay_gather(pool, idx, w),
                    lambda: torch.index_select(pool, 0, idx),
                    lambda: torch.mul(got, w_col),
                ),
                "plain_ms": cuda_ms(lambda: replay_gather_plain(pool, idx, w)),
                "bound_ms": bound_ms(nbytes),
                "shape": [cap, f, b],
            }
    emit({"phase": "kernel", "name": "replay_gather", "max_abs_err": worst, **timed})
    return {"max_abs_err": worst, **timed}


def check_fused_td(dev) -> dict:
    """The fleet's TD tail (N=4 agents, B=32 rows, A=6 actions, rows of
    F=1033 with action, reward and done at columns 515, 516 and 1032), a
    ragged one (N=3, B=50), one agent with one action, and out-of-range
    actions (A and beyond select NaN, -1 .. -A wrap, a NaN action reads
    as 0): all four outputs, and the gradient through ``td_loss`` against
    autograd through the plain version, within 1e-6.  Each case again
    with the observatory's statistics: ``td_abs`` and ``q_max`` against
    the plain version's within 1e-6 (NaN where it has NaN: the
    out-of-range case's NaN-selected rows make agent 0's ``td_abs`` NaN,
    and one NaN q, at an action no row selects, agent 1's ``q_max``),
    the other four outputs bit for bit those without statistics.  Timed:
    the main path's call (``ms``, ``device_ms``), with statistics
    (``stats_ms``, ``stats_device_ms``), and ``tail_ms``, forward and
    backward of the whole tail through autograd, beside the plain tail's
    and one multiply's (``tail_floor_ms``)."""
    rng = np.random.default_rng(1)
    cfg = DQNConfig()
    columns = flat_columns(cfg.box_size)
    cols = tuple(columns[k].start for k in ("action", "reward", "done"))
    feat, gamma = columns["done"].stop, cfg.gamma
    edge = [2.7, -0.5, np.nan, -1, -6, 6, 7, -7, -100, 1e10, 5.9, 0]
    cases = (
        ("fleet", N_AGENTS, BATCH, cfg.n_actions),
        ("ragged", 3, 50, 6),
        ("one_action", 1, 7, 1),
        ("out_of_range", 2, len(edge), 6),
    )
    worst, timed = 0.0, None
    for name, n, b, a in cases:
        q, q_next = (
            torch.tensor(
                rng.standard_normal((n, b, a)), dtype=torch.float32, device=dev
            )
            for _ in range(2)
        )
        rows_np = rng.standard_normal((n, b, feat))
        rows_np[..., cols[0]] = rng.integers(0, a, (n, b))
        rows_np[..., cols[2]] = rng.random((n, b)) < 0.3
        if name == "out_of_range":
            rows_np[0, :, cols[0]] = edge
            # a NaN q at an action agent 1's first row does not select
            q[1, 0, (int(rows_np[1, 0, cols[0]]) + 1) % a] = float("nan")
        rows = torch.tensor(rows_np, dtype=torch.float32, device=dev)
        got = fused_td(q, q_next, rows, cols, gamma)
        stats = (torch.empty(n, device=dev), torch.empty(n, device=dev))
        got_stats = fused_td(q, q_next, rows, cols, gamma, stats)
        want = fused_td_plain(q, q_next, rows, cols, gamma)
        grads = []
        for tail in (td_loss, lambda *xs: fused_td_plain(*xs).loss):
            leaf = q.clone().requires_grad_(True)
            loss = tail(leaf, q_next, rows, cols, gamma).sum()
            grads.append(torch.autograd.grad(loss, leaf)[0])
        torch.cuda.synchronize()
        for what, x, y in (
            *zip(got._fields[:4], got[:4], want[:4]),
            ("td_abs", got_stats.td_abs, want.td_abs),
            ("q_max", got_stats.q_max, want.q_max),
            ("grad", *grads),
        ):
            err = float((x - y).abs().nan_to_num(0.0).max())
            worst = max(worst, err)
            require(
                torch.allclose(x, y, rtol=1e-6, atol=1e-6, equal_nan=True),
                f"fused_td {name} {[n, b, a]} {what}: max|d|={err}",
            )
        for what, x, y in zip(got._fields[:4], got[:4], got_stats[:4]):
            require(
                torch.equal(x.nan_to_num(7.0), y.nan_to_num(7.0)),
                f"fused_td {name}: {what} moved with the statistics on",
            )
        if name == "out_of_range":
            require(
                bool(torch.isnan(got.loss[0]) and torch.isfinite(got.loss[1])),
                f"fused_td: out-of-range actions gave loss {got.loss.tolist()}",
            )
            require(
                bool(
                    torch.isnan(got_stats.td_abs[0])
                    and torch.isfinite(got_stats.td_abs[1])
                    and torch.isnan(got_stats.q_max[1])
                    and torch.isfinite(got_stats.q_max[0])
                ),
                f"fused_td: NaN statistics {got_stats.td_abs.tolist()}, "
                f"{got_stats.q_max.tolist()}",
            )
        if timed is None:  # the main path's call
            leaf = q.clone().requires_grad_(True)
            # read: q_next whole, the sectors of q that hold the selected
            # actions and the sectors of rows that hold the three columns
            # (at F = 1033 action and reward share one in 7 of 8 rows); written:
            # loss_rows, dq, loss and grad_q
            row = np.arange(n * b)
            sel = row * a + rows_np[..., cols[0]].ravel().astype(np.int64)
            row_cols = row[:, None] * feat + np.array(cols)
            nbytes = (
                4 * n * b * a
                + sector_bytes(q.data_ptr(), 4 * sel)
                + sector_bytes(rows.data_ptr(), 4 * row_cols.ravel())
                + 4 * (2 * n * b + n + n * b * a)
            )
            timed = {
                **timings(
                    lambda: fused_td(q, q_next, rows, cols, gamma),
                    None,
                    lambda: torch.mul(q_next, gamma),
                ),
                "plain_ms": cuda_ms(
                    lambda: fused_td_plain(q, q_next, rows, cols, gamma)
                ),
                "stats_ms": cuda_ms(
                    lambda: fused_td(q, q_next, rows, cols, gamma, stats)
                ),
                "stats_device_ms": graph_ms(
                    lambda: fused_td(q, q_next, rows, cols, gamma, stats)
                ),
                # with statistics q is read whole and td_abs, q_max written
                "stats_bound_ms": bound_ms(
                    nbytes
                    - sector_bytes(q.data_ptr(), 4 * sel)
                    + 4 * n * b * a
                    + 8 * n
                ),
                "tail_ms": cuda_ms(
                    lambda: torch.autograd.grad(
                        td_loss(leaf, q_next, rows, cols, gamma).sum(), leaf
                    )
                ),
                "plain_tail_ms": cuda_ms(
                    lambda: torch.autograd.grad(
                        fused_td_plain(leaf, q_next, rows, cols, gamma).loss.sum(),
                        leaf,
                    )
                ),
                # the least a forward and backward through autograd costs
                "tail_floor_ms": cuda_ms(
                    lambda: torch.autograd.grad(torch.mul(leaf, gamma).sum(), leaf)
                ),
                "bound_ms": bound_ms(nbytes),
                "shape": [n, b, a, feat],
            }
    emit({"phase": "kernel", "name": "fused_td", "max_abs_err": worst, **timed})
    return {"max_abs_err": worst, **timed}


def phase_chunk(dev) -> None:
    """One train chunk at full width, card (kernels) vs CPU (plain
    versions).  1e-4: cuDNN/cuBLAS and the CPU sum in different orders
    (TF32 is off on the card), and the drift compounds over K steps."""
    cfg = DQNConfig()
    rng = np.random.default_rng(2)
    cpu_steps = FleetSteps(cfg, "cpu")
    slots = [cpu_steps.init_slot(seed) for seed in range(N_AGENTS)]
    state = slots[0].map(lambda *xs: torch.cat(xs), *slots[1:])
    rows, obs_f = 4096, int(np.prod(cfg.box_size))
    pool = np.concatenate(
        [
            rng.random((rows, obs_f)),
            rng.random((rows, 3)),
            rng.integers(0, cfg.n_actions, (rows, 1)),
            rng.standard_normal((rows, 1)),
            rng.random((rows, obs_f)),
            rng.random((rows, 3)),
            rng.random((rows, 1)) < 0.1,
        ],
        axis=1,
    ).astype(np.float32)
    idx = rng.integers(0, rows, (4, N_AGENTS, cfg.batch_size)).astype(np.int32)
    pool_t, idx_t = torch.from_numpy(pool), torch.from_numpy(idx)
    new_cpu, loss_cpu = cpu_steps.train_chunk(state, pool_t, idx_t)
    gpu_steps = FleetSteps(cfg, dev)
    new_gpu, loss_gpu = gpu_steps.train_chunk(
        state.map(lambda x: x.to(dev)), pool_t.to(dev), idx_t.to(dev)
    )
    torch.cuda.synchronize()
    diffs = new_gpu.map(lambda g, c: (g.cpu().float() - c.float()).abs().max(), new_cpu)
    p_err = max(float(x) for x in leaves(diffs.params) + leaves(diffs.target))
    l_err = float((loss_gpu.cpu() - loss_cpu).abs().max())
    emit(
        {
            "phase": "chunk",
            "agents": N_AGENTS,
            "steps": 4,
            "params_max_abs_err": p_err,
            "loss_max_abs_err": l_err,
        }
    )
    require(bool(torch.isfinite(loss_gpu).all()), "train chunk: non-finite loss")
    require(p_err <= 1e-4, f"train chunk params differ by {p_err}")
    require(l_err <= 1e-4, f"train chunk losses differ by {l_err}")


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
    for k in (rmsnorm, flash_attention):
        k.launches_by_route = dict.fromkeys(k.launches_by_route, 0)


def read_launches() -> dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def record_flushes(engine, out: dict) -> None:
    """Fill ``out["params"]`` with a host copy of every resident slot's
    params right after ``engine``'s first flush, and ``out["flush_s"]``
    with the host wall of every flush call (each ends in the flush's one
    host sync), the copy left out."""
    flush = engine.flush
    out["flush_s"] = 0.0

    def recording():
        t0 = time.perf_counter()
        flush()
        out["flush_s"] += time.perf_counter() - t0
        if "params" not in out and engine.n_flushes:
            out["params"] = tree_map(lambda t: t.cpu(), engine.state.params)

    engine.flush = recording


def timed_run(spec, dev, hooks=(), telemetry=None, flushes=None) -> tuple:
    """Build ``spec`` on ``dev``, run it with the launches read around
    the run alone, then evaluate it.  The evaluation probes a churn or
    hub-failure scenario fires during the run count to ``eval_s``, not
    to ``run_s``.  With a dict ``flushes``, the params after the
    engine's first flush are copied into it (one copy a run) and the
    flushes' wall summed (:func:`record_flushes`)."""
    system = build(spec, hooks=hooks, device=dev, telemetry=telemetry)
    if flushes is not None:
        record_flushes(system.engine, flushes)
    probe_s = 0.0
    evaluate = system.evaluate

    def timed_evaluate(*args, **kw):
        nonlocal probe_s
        t = time.perf_counter()
        out = evaluate(*args, **kw)
        probe_s += time.perf_counter() - t
        return out

    system.evaluate = timed_evaluate
    reset_launches()
    t0 = time.perf_counter()
    report = system.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    run_s = time.perf_counter() - t0 - probe_s
    launches = read_launches()
    t1 = time.perf_counter()
    evaluate_into(report, system, spec)
    eval_s = time.perf_counter() - t1 + probe_s
    return system, report, launches, run_s, eval_s


def phase_main(dev) -> dict:
    spec = replace(get_scenario("paper_fig2"), dqn=DQNConfig()).fast()
    flushes: dict = {}
    system, report, launches, run_s, eval_s = timed_run(spec, dev, flushes=flushes)
    engine = system.engine
    emit(
        {
            "phase": "main",
            "scenario": "paper_fig2 --fast, dqn=DQNConfig()",
            "cuts": "none",
            "mean_dist_err": report.mean_dist_err,
            "n_rounds": report.n_rounds,
            "run_s": run_s,
            "eval_s": eval_s,
            "agent_steps": engine.n_steps_trained,
            "stacked_steps": engine.n_chunk_steps,
            "flushes": engine.n_flushes,
            "agent_steps_per_s": engine.n_steps_trained / run_s,
            "launches": launches,
        }
    )
    want_rounds = spec.sys.n_agents * spec.sys.rounds
    require(
        report.n_rounds == want_rounds, f"{report.n_rounds} rounds, not {want_rounds}"
    )
    require(bool(np.isfinite(report.mean_dist_err)), "mean_dist_err is not finite")
    require(engine.n_chunk_steps > 0, "the main path trained nothing")
    for name in ("replay_gather", "fused_td"):
        require(
            launches[name] == engine.n_chunk_steps,
            f"{name} launched {launches[name]} times for "
            f"{engine.n_chunk_steps} stacked steps",
        )
    return {
        "launches": launches,
        "run_s": run_s,
        "eval_s": eval_s,
        "mean_dist_err": report.mean_dist_err,
        "n_rounds": report.n_rounds,
        "agent_steps": engine.n_steps_trained,
        "stacked_steps": engine.n_chunk_steps,
        # what the fleet_mesh phase holds its sharded run to
        "reference": {
            "report": report,
            "flushes": flushes,
            "run_s": run_s,
            "eval_s": eval_s,
        },
    }


@contextmanager
def round_losses():
    """Collect the loss every ``DQNAgent.train_round`` returns (Agent M's
    per-round losses, which its trainer does not return)."""
    losses: list[float] = []
    train_round = DQNAgent.train_round

    def recording(self, *args, **kw):
        shared, loss = train_round(self, *args, **kw)
        losses.append(loss)
        return shared, loss

    DQNAgent.train_round = recording
    try:
        yield losses
    finally:
        DQNAgent.train_round = train_round


def run_baseline(name: str, dev) -> tuple:
    """One Table 1 / FedAvg scenario at ``DQNConfig()``, ``--fast``, on
    ``dev``; launches read around the run alone."""
    return timed_run(replace(get_scenario(name), dqn=DQNConfig()).fast(), dev)


def phase_baselines(dev) -> dict[str, dict[str, int]]:
    by_path = {}
    for name, (want_rounds, want_steps) in BASELINES.items():
        with round_losses() as losses:
            system, report, launches, run_s, eval_s = run_baseline(name, dev)
        engine = system.engine if name == "fedavg_sync" else system.agent.engine
        emit(
            {
                "phase": "baselines",
                "scenario": f"{name} --fast, dqn=DQNConfig()",
                "cuts": "none",
                "mean_dist_err": report.mean_dist_err,
                "n_rounds": report.n_rounds,
                "run_s": run_s,
                "eval_s": eval_s,
                "agent_steps": engine.n_steps_trained,
                "stacked_steps": engine.n_chunk_steps,
                "flushes": engine.n_flushes,
                "agent_steps_per_s": engine.n_steps_trained / run_s,
                "launches": launches,
            }
        )
        require(bool(np.isfinite(report.mean_dist_err)), f"{name}: error not finite")
        require(
            report.n_rounds == want_rounds,
            f"{name}: {report.n_rounds} rounds, not {want_rounds}",
        )
        require(
            engine.n_chunk_steps == want_steps,
            f"{name}: {engine.n_chunk_steps} stacked steps, not {want_steps}",
        )
        for k in FLEET_KERNELS:
            require(
                launches[k] == want_steps,
                f"{name}: {k} launched {launches[k]} times for {want_steps} steps",
            )
        if name == "fedavg_sync":
            first = leaves(system.agents[0].params)
            for agent in system.agents[1:]:
                require(
                    all(map(torch.equal, leaves(agent.params), first)),
                    f"fedavg: agent {agent.agent_id}'s params are not agent 0's",
                )
        if name == "baseline_sequential":
            card_losses, card_err = list(losses), report.mean_dist_err
        by_path[name] = {k: launches[k] for k in FLEET_KERNELS}

    # Agent M on the CPU from the same init: the port's init is drawn on
    # the host, so both sides start from the same weights
    with round_losses() as cpu_losses:
        _, cpu_report, *_ = run_baseline("baseline_sequential", torch.device("cpu"))
    diffs = [abs(a - b) for a, b in zip(card_losses, cpu_losses, strict=True)]
    first_off = next((i for i, d in enumerate(diffs) if d > 1e-4), None)
    emit(
        {
            "phase": "baselines_card_vs_cpu",
            "scenario": "baseline_sequential --fast, dqn=DQNConfig()",
            "round_losses": [[a, b] for a, b in zip(card_losses, cpu_losses)],
            "first_round_over_1e-4": first_off,
            "mean_dist_err": [card_err, cpu_report.mean_dist_err],
        }
    )
    require(diffs[0] <= 1e-4, f"agent M round 0 loss: card vs CPU differ by {diffs[0]}")
    return by_path


def phase_sweep(dev, name: str = "paper_table1_sweep") -> dict[str, int]:
    sweep = get_sweep(name).with_seeds((0, 1))
    reset_launches()
    t0 = time.perf_counter()
    summary = run_sweep(sweep, fast=True, workers=1, device=str(dev))
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    p_values = {
        c["variant"]: {"p_ttest": c["p_ttest"], "p_permutation": c["p_permutation"]}
        for c in summary["comparisons"]
        if c["metric"] == "mean_dist_err"
    }
    emit(
        {
            "phase": "sweep",
            "sweep": f"{name} --fast, seeds (0, 1), workers=1",
            "cuts": "seeds 0 and 1 of 5",
            "wall_s": wall_s,
            "mean_dist_err": {
                label: v["metrics"]["mean_dist_err"]["mean"]
                for label, v in summary["variants"].items()
            },
            f"paired_vs_{sweep.baseline}": p_values,
            "cells": [
                [c["label"], c["seed"], c["status"], c["elapsed_s"]]
                for c in summary["cells"]
            ],
            "launches": launches,
        }
    )
    bad = failed_cells(summary)
    require(not bad, f"sweep cells failed: {bad}")
    require(len(summary["cells"]) == 8, f"{len(summary['cells'])} sweep cells, not 8")
    devices = {summary["device"], *(c["device"] for c in summary["cells"])}
    require(devices == {"cuda"}, f"sweep cells recorded devices {devices}")
    for label, v in summary["variants"].items():
        values = v["metrics"]["mean_dist_err"]["values"]
        require(
            len(values) == 2 and all(np.isfinite(x) for x in values.values()),
            f"sweep {label}: errors {values}",
        )
    require(
        launches["replay_gather"] == launches["fused_td"] > 0,
        f"sweep launches {launches}",
    )
    return {k: launches[k] for k in FLEET_KERNELS}


def phase_topology(dev) -> dict[str, int]:
    """Hub-less top-k gossip and the hybrid topology at full width."""
    total = dict.fromkeys(FLEET_KERNELS, 0)
    for name in ("topo_gossip_topk", "topo_hybrid"):
        spec = replace(get_scenario(name), dqn=DQNConfig()).fast()
        system, report, launches, run_s, eval_s = timed_run(spec, dev)
        engine = system.engine
        dense = 4 * sum(x.numel() for x in leaves(system.agents[0].params))
        wbytes = report.bytes_by_plane["weights"]
        wmsgs = report.msgs_by_plane["weights"]
        emit(
            {
                "phase": "topology",
                "scenario": f"{name} --fast, dqn=DQNConfig()",
                "cuts": "none",
                "mean_dist_err": report.mean_dist_err,
                "n_rounds": report.n_rounds,
                "run_s": run_s,
                "eval_s": eval_s,
                "agent_steps": engine.n_steps_trained,
                "stacked_steps": engine.n_chunk_steps,
                "flushes": engine.n_flushes,
                "launches": launches,
                "bytes_by_plane": report.bytes_by_plane,
                "msgs_by_plane": report.msgs_by_plane,
                "snapshots_mixed": report.n_mixed,
                "weight_bytes_per_msg": wbytes / max(wmsgs, 1),
                "dense_weight_bytes": dense,
                "gossip": report.extra.get("gossip"),
            }
        )
        want_rounds = spec.sys.n_agents * spec.sys.rounds
        require(report.n_rounds == want_rounds, f"{name}: {report.n_rounds} rounds")
        require(bool(np.isfinite(report.mean_dist_err)), f"{name}: error not finite")
        require(engine.n_chunk_steps > 0, f"{name}: trained nothing")
        for k in FLEET_KERNELS:
            require(
                launches[k] == engine.n_chunk_steps,
                f"{name}: {k} launched {launches[k]} times for "
                f"{engine.n_chunk_steps} stacked steps",
            )
            total[k] += launches[k]
        require(wbytes > 0, f"{name}: no weight bytes on the wire")
        require(report.n_mixed >= 1, f"{name}: no snapshot mixed")
        if name == "topo_gossip_topk":
            require(
                wbytes / wmsgs <= dense / 4,
                f"{name}: {wbytes / wmsgs} weight bytes a message against "
                f"dense {dense}: not 4x below",
            )
    return total


def phase_stepwise(dev, fleet: dict) -> dict[str, int]:
    """``paper_fig2`` on the stepwise engine, beside the fleet's run."""
    spec = replace(get_scenario("paper_fig2"), dqn=DQNConfig()).fast()
    spec = replace(spec, sys=replace(spec.sys, engine="stepwise"))
    system, report, launches, run_s, eval_s = timed_run(spec, dev)
    agents = list(system.agents.values())
    steps = sum(a.step_count for a in agents)
    picks = sum(a.n_picks_gathered for a in agents)
    emit(
        {
            "phase": "stepwise",
            "scenario": "paper_fig2 --fast, dqn=DQNConfig(), engine=stepwise",
            "cuts": "none",
            "mean_dist_err": report.mean_dist_err,
            "n_rounds": report.n_rounds,
            "run_s": run_s,
            "eval_s": eval_s,
            "agent_steps": steps,
            "picks_gathered": picks,
            "agent_steps_per_s": steps / run_s,
            "launches": launches,
            "fleet": fleet,
            "slowdown_vs_fleet": run_s / fleet["run_s"],
        }
    )
    require(
        report.n_rounds == fleet["n_rounds"], f"stepwise: {report.n_rounds} rounds"
    )
    require(bool(np.isfinite(report.mean_dist_err)), "stepwise: error not finite")
    require(steps == fleet["agent_steps"] > 0, f"stepwise: {steps} agent steps")
    require(
        launches["fused_td"] == steps,
        f"stepwise: fused_td launched {launches['fused_td']} times for {steps} steps",
    )
    require(
        launches["replay_gather"] == picks,
        f"stepwise: replay_gather launched {launches['replay_gather']} times "
        f"for {picks} picks",
    )
    return {k: launches[k] for k in FLEET_KERNELS}


def phase_main_card_vs_cpu(dev) -> None:
    """The main path on the card and on the CPU from one init: where do
    the two sides part?"""
    spec = replace(get_scenario("paper_fig2"), dqn=DQNConfig()).fast()
    side = []
    for d in (dev, torch.device("cpu")):
        system, flushes = build(spec, device=d), {}
        record_flushes(system.engine, flushes)
        report = system.run()
        evaluate_into(report, system, spec)
        side.append((report, flushes["params"]))
    (card, card_first), (cpu, cpu_first) = side
    diffs = [
        abs(a.loss - b.loss) for a, b in zip(card.history, cpu.history, strict=True)
    ]
    first_off = next((i for i, x in enumerate(diffs) if x > 1e-4), None)
    p_err = max(
        float((a - b).abs().max())
        for a, b in zip(leaves(card_first), leaves(cpu_first), strict=True)
    )
    emit(
        {
            "phase": "main_card_vs_cpu",
            "scenario": "paper_fig2 --fast, dqn=DQNConfig()",
            "round_losses": [
                [a.loss, b.loss] for a, b in zip(card.history, cpu.history)
            ],
            "round_agents": [a.agent_id for a in card.history],
            "first_round_over_1e-4": first_off,
            "params_max_abs_err_after_first_flush": p_err,
            "mean_dist_err": [card.mean_dist_err, cpu.mean_dist_err],
        }
    )
    require(
        [a.agent_id for a in card.history] == [b.agent_id for b in cpu.history],
        "main card vs CPU: the round order differs",
    )
    require(diffs[0] <= 1e-4, f"main round 0 loss: card vs CPU differ by {diffs[0]}")


class MembershipLog(ExperimentHooks):
    """What the population phase holds the run to: churn and hub-failure
    events as they fire, and the gossip deliveries counted by then."""

    def __init__(self):
        self.churn: list = []
        self.failures: list = []

    def on_churn(self, system, event, agent_ids, t):
        self.churn.append([event.action, list(agent_ids), t])

    def on_hub_failure(self, system, event, orphaned, t):
        gossip = system.network.gossip
        delivered = gossip.stats.n_delivered if gossip is not None else None
        self.failures.append([event.hub_id, list(orphaned), t, delivered])


def population_specs() -> dict[str, tuple]:
    """The population phase's scenarios at ``DQNConfig()``, each with its
    evaluation cut: one patient throughout, and one task for flash_crowd,
    whose population stays at its full 4 + 200 agents."""
    full = DQNConfig()
    out = {}
    for name in (
        "paper_table2_hub_failure",
        "paper_table2_hybrid_failover",
        "churn_addition_fig4",
    ):
        spec = replace(get_scenario(name), dqn=full, eval_patients=1).fast()
        out[name] = (spec, "eval_patients=1", f"{name} --fast")
    crowd = replace(
        get_scenario("flash_crowd"),
        dqn=full,
        eval_patients=1,
        eval_tasks=1,
        fast_population_scale=1.0,
    ).fast()
    out["flash_crowd"] = (
        crowd,
        "eval_patients=1, eval_tasks=1",
        "flash_crowd, full population 4 + 200, --fast train steps",
    )
    return out


def joined_agents(spec) -> int:
    """Every agent the scenario brings in: incumbents, churn joiners or
    the whole population."""
    if spec.population is not None:
        return spec.population.n_agents
    adds = sum(ev.count for ev in spec.churn if ev.action == "add")
    return spec.sys.n_agents + adds


def phase_population(dev) -> dict[str, int]:
    """Churn, hub failures and a wide fleet at full width: Table 2's hub
    death and hybrid failover, Fig 4's joins (the resident axis grows
    mid-run) and flash_crowd's 204 agents on one engine."""
    total = dict.fromkeys(FLEET_KERNELS, 0)
    for name, (spec, cuts, label) in population_specs().items():
        log = MembershipLog()
        system, report, launches, run_s, eval_s = timed_run(spec, dev, hooks=(log,))
        engine = system.engine
        curve = [[p.t, p.n_agents, p.mean_err] for p in report.eval_curve]
        gossip = report.extra.get("gossip")
        emit(
            {
                "phase": "population",
                "scenario": f"{label}, dqn=DQNConfig()",
                "cuts": cuts,
                "mean_dist_err": report.mean_dist_err,
                "n_rounds": report.n_rounds,
                "run_s": run_s,
                "eval_s": eval_s,
                "agent_steps": engine.n_steps_trained,
                "stacked_steps": engine.n_chunk_steps,
                "flushes": engine.n_flushes,
                "flush_sizes": engine.flush_sizes,
                "agent_steps_per_s": engine.n_steps_trained / run_s,
                "launches": launches,
                "capacity": engine.capacity,
                "eval_curve": curve,
                "bytes_by_plane": report.bytes_by_plane,
                "population": report.extra.get("population"),
                "gossip": gossip,
                "churn_events": len(log.churn),
                "churn": log.churn[:8],  # flash_crowd's 201 joins: the first
                "hub_failures": log.failures,
            }
        )
        joined = joined_agents(spec)
        want_rounds = joined * spec.sys.rounds
        require(len(system.agents) == joined, f"{name}: {len(system.agents)} agents")
        require(
            report.n_rounds == want_rounds,
            f"{name}: {report.n_rounds} rounds, not {want_rounds}",
        )
        require(
            all(np.isfinite(err) for _, _, err in curve),
            f"{name}: errors {curve} not all finite",
        )
        require(engine.n_chunk_steps > 0, f"{name}: trained nothing")
        for k in FLEET_KERNELS:
            require(
                launches[k] == engine.n_chunk_steps,
                f"{name}: {k} launched {launches[k]} times for "
                f"{engine.n_chunk_steps} stacked steps",
            )
            total[k] += launches[k]
        if name == "paper_table2_hub_failure":
            require(
                [f[:3] for f in log.failures] == [[2, [2, 3], 1.5]],
                f"{name}: hub failures {log.failures}",
            )
            require(curve[0][:2] == [1.5, 4], f"{name}: first probe {curve[0]}")
        if name == "paper_table2_hybrid_failover":
            dead_at = max(f[3] for f in log.failures)
            require(
                gossip["delivered"] > dead_at,
                f"{name}: {gossip['delivered']} gossip deliveries, "
                f"{dead_at} of them before every hub was dead",
            )
        if name == "churn_addition_fig4":
            require(engine.capacity == 16, f"{name}: capacity {engine.capacity}")
            require(
                [n for _, n, _ in curve[:3]] == [4, 8, 12],
                f"{name}: probes {curve}",
            )
        if name == "flash_crowd":
            require(
                report.extra["population"]["n_agents"] == 204
                and engine.capacity == 256,
                f"{name}: {report.extra['population']['n_agents']} agents, "
                f"capacity {engine.capacity}",
            )
    return total


def serve_batching_run(dev, max_batch: int, telemetry=None, devices: int = 0) -> dict:
    """Phase 12 (b): one train-while-serve session at ``DQNConfig()``, 4
    agents, 128 requests in 2 waves around one round of 20 steps (with
    ``telemetry``, observed: phase 12 (d); with ``devices``, on the fleet
    mesh ``make_fleet_mesh`` gives: phase 23)."""
    traffic = TrafficSpec(
        n_requests=128,
        max_batch=max_batch,
        n_version_slots=2,
        max_staleness=1,
        seed=0,
    )
    session = build_session(
        DQNConfig(),
        n_agents=4,
        traffic=traffic,
        seed=0,
        telemetry=telemetry,
        devices=devices,
        device=dev,
    )
    reset_launches()
    t0 = time.perf_counter()
    report = run_session(session, traffic, n_waves=2, train_steps=20)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    s = report.summary()
    results = session.service.results
    return {
        "summary": {
            "max_batch": max_batch,
            "wall_s": wall_s,
            **{
                k: s[k]
                for k in (
                    "n_requests",
                    "requests_per_sec",
                    "p50_latency_ms",
                    "p99_latency_ms",
                    "ticks_per_request",
                    "n_ticks",
                    "n_swaps",
                    "versions_served",
                    "recompiles",
                    "mean_dist_err",
                )
            },
            "service_ticks_per_request": s["n_ticks"] / s["n_requests"],
            "buckets_dispatched": sorted(set(report.batch_sizes)),
            "stacked_steps": session.engine.n_chunk_steps,
            "shard_steps": session.engine.n_shard_steps,
            "launches": launches,
        },
        "per_request": [
            (results[i].final_loc.tolist(), results[i].n_ticks, results[i].version)
            for i in sorted(results)
        ],
    }


def check_act_steps(dev) -> dict:
    """Phase 12 (c): 16 requests on a 2-version ring of 4 agents at
    ``DQNConfig()`` (params drawn on the host), batched against each
    request dispatched alone on the card, and the batch on the CPU."""
    cfg = DQNConfig()
    rng = np.random.default_rng(6)
    gen = torch.Generator().manual_seed(6)
    inits = [dqn_init(cfg, gen) for _ in range(8)]
    ring = tree_map(lambda *xs: torch.stack(xs), *inits)
    b = 16
    host = (
        torch.tensor(rng.integers(0, 8, b)),
        torch.tensor(rng.standard_normal((b, *cfg.box_size)), dtype=torch.float32),
        torch.tensor(rng.random((b, 3)), dtype=torch.float32),
    )
    card = ActSteps(cfg, dev)
    ring_d, (slot, obs, loc) = tree_to(ring, dev), (t.to(dev) for t in host)
    actions, q = card.act(ring_d, slot, obs, loc)
    alone = [
        card.act(ring_d, slot[i : i + 1], obs[i : i + 1], loc[i : i + 1])
        for i in range(b)
    ]
    cpu_actions, cpu_q = ActSteps(cfg, "cpu").act(ring, *host)
    torch.cuda.synchronize()
    q_alone = torch.cat([qi for _, qi in alone])
    a_alone = torch.cat([ai for ai, _ in alone])
    return {
        "requests": b,
        "batched_vs_alone_max_abs_dq": float((q_alone - q).abs().max()),
        "batched_vs_alone_actions_equal": bool(torch.equal(a_alone, actions)),
        "card_vs_cpu_max_abs_dq": float((q.cpu() - cpu_q).abs().max()),
        "card_vs_cpu_actions_equal": bool(torch.equal(actions.cpu(), cpu_actions)),
    }


def phase_serve(dev) -> tuple[dict[str, int], list]:
    """The serving plane at full width: the scenario, batched against
    single serving of one session, and the act program alone.  Returns
    the launches and the batched session's requests (the fleet_mesh
    phase's reference)."""
    t_phase = time.perf_counter()
    total = dict.fromkeys(FLEET_KERNELS, 0)
    # (a) the scenario through the port's runner
    spec = replace(get_scenario("serve_localization"), dqn=DQNConfig()).fast()
    system, report, launches, run_s, eval_s = timed_run(spec, dev)
    engine = system.session.engine
    s = report.extra["serve"]
    emit(
        {
            "phase": "serve",
            "scenario": "serve_localization --fast, dqn=DQNConfig()",
            "cuts": "none",
            "mean_dist_err": report.mean_dist_err,
            "run_s": run_s,
            "eval_s": eval_s,
            "serve": s,
            "agent_steps": engine.n_steps_trained,
            "stacked_steps": engine.n_chunk_steps,
            "launches": launches,
        }
    )
    n_requests = spec.serve_traffic.n_requests
    require(
        s["n_requests"] == n_requests == 32,
        f"serve: {s['n_requests']} of {n_requests} requests answered",
    )
    require(bool(np.isfinite(report.mean_dist_err)), "serve: error not finite")
    require(s["recompiles"] == 0, f"serve: {s['recompiles']} new act shapes")
    require(s["n_swaps"] >= 1, "serve: no hot swap")
    require(
        set(s["versions_served"]) == {"0", "1"},
        f"serve: versions served {s['versions_served']}",
    )
    require(engine.n_chunk_steps == 8, f"serve: {engine.n_chunk_steps} stacked steps")
    for k in FLEET_KERNELS:
        require(
            launches[k] == engine.n_chunk_steps,
            f"serve: {k} launched {launches[k]} times for "
            f"{engine.n_chunk_steps} stacked steps",
        )
        total[k] += launches[k]

    # (b) one session served one request at a time, then batched
    single, batched = serve_batching_run(dev, 1), serve_batching_run(dev, 16)
    differ = [
        i
        for i, (x, y) in enumerate(
            zip(single["per_request"], batched["per_request"], strict=True)
        )
        if x != y
    ]
    emit(
        {
            "phase": "serve_batching",
            "session": "build_session(DQNConfig(), n_agents=4), 128 requests, "
            "2 waves, 20 train steps",
            "single": single["summary"],
            "batched": batched["summary"],
            "batched_over_single_requests_per_sec": batched["summary"][
                "requests_per_sec"
            ]
            / single["summary"]["requests_per_sec"],
            "requests_differing": differ,
        }
    )
    require(not differ, f"serve: batched and single differ at requests {differ}")
    for run in (single, batched):
        summary = run["summary"]
        require(summary["n_requests"] == 128, f"serve: {summary['n_requests']} served")
        require(
            summary["recompiles"] == 0 and summary["n_swaps"] == 1,
            f"serve: {summary['recompiles']} new shapes, {summary['n_swaps']} swaps",
        )
        for k in FLEET_KERNELS:
            require(
                summary["launches"][k] == summary["stacked_steps"] == 20,
                f"serve: {k} launched {summary['launches'][k]} times for "
                f"{summary['stacked_steps']} stacked steps",
            )
            total[k] += summary["launches"][k]
    require(
        {v for *_, v in single["per_request"]} == {0, 1},
        "serve: the session did not serve both versions",
    )

    # (d) the batched session observed
    tel = Telemetry(enabled=True)
    observed = serve_batching_run(dev, 16, tel)
    differ = [
        i
        for i, (x, y) in enumerate(
            zip(batched["per_request"], observed["per_request"], strict=True)
        )
        if x != y
    ]
    counters = {
        k: tel.registry.counter_value(k)
        for k in ("serve.ticks", "serve.swaps", "serve.requests.completed")
    }
    emit(
        {
            "phase": "serve_observed",
            "session": "as serve_batching's batched run, with Telemetry(enabled=True)",
            "observed": observed["summary"],
            "counters": counters,
            "requests_differing_from_unobserved": differ,
        }
    )
    require(not differ, f"serve: observed and unobserved differ at requests {differ}")
    require(
        counters["serve.ticks"] == observed["summary"]["n_ticks"]
        and counters["serve.requests.completed"] == 128,
        f"serve: observed counters {counters}",
    )
    for k in FLEET_KERNELS:
        require(
            observed["summary"]["launches"][k] == 20,
            f"serve: observed {k} launched {observed['summary']['launches'][k]}",
        )
        total[k] += observed["summary"]["launches"][k]

    # (c) the act program alone
    act = check_act_steps(dev)
    emit({"phase": "serve_act", **act})
    require(act["card_vs_cpu_max_abs_dq"] <= 1e-4, f"serve act: card vs CPU {act}")
    require(act["batched_vs_alone_actions_equal"], f"serve act: batched vs alone {act}")
    emit({"phase": "serve_wall", "seconds": time.perf_counter() - t_phase})
    return total, batched["per_request"]


# the fleet_mesh phase's tolerances, sharded against unsharded on the card.
# paper_fig2's 3 agents on 4 shards put one agent on a shard, which trains
# as two lanes (rl/fleet.py::FleetEngine._flush_group) and so convolves as
# the unsharded engine's grouped convolution: bit for bit on an H100 (0.0
# in losses and params; 8.57e-7 in params before the two lanes, at
# groups=1).  Evaluation keeps its bound.
MESH_LOSS_TOL = 0.0  # each round's loss
MESH_PARAMS_TOL = 0.0  # every slot's params after the first flush
MESH_ERR_TOL = 1e-4  # mean_dist_err (voxels)
CROWD_AGENTS = 183  # flash_crowd's widest flush (PERF.md section 5)


@contextmanager
def fleet_mesh_given(module, mesh):
    """``module.make_fleet_mesh`` hands out ``mesh`` inside the block."""
    saved = module.make_fleet_mesh
    module.make_fleet_mesh = lambda *args, **kw: mesh
    try:
        yield
    finally:
        module.make_fleet_mesh = saved


def _meta(report) -> list:
    """Every round record's fields but the loss."""
    return [(*r[:6], *r[7:]) for r in _records(report)]


def _step_numbers(step: dict) -> dict:
    return {k: v for k, v in step.items() if k != "top"}


def phase_fleet_mesh(dev, main_ref: dict, serve_ref: list) -> dict[str, int]:
    """The fleet axis on a device mesh: ``paper_fig2 --fast`` at
    ``DQNConfig()`` through ``ADFLLSystem`` sharded over the mesh, held
    to the main phase's unsharded run; one stacked step whole and split
    over same-card shards, at N = 4 and at flash_crowd's N = 183; the
    serving session of phase 12 (b) on the mesh, held to the batched
    one request by request.  With one visible card ``make_fleet_mesh(-1)``
    must give no mesh, and the mesh is cuda:0 four times."""
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    auto = make_fleet_mesh(-1)
    if auto is None:
        mesh = FleetMesh((torch.device("cuda", 0),) * 4)
        used = "FleetMesh((cuda:0,) * 4)"
    else:
        mesh, used = auto, "make_fleet_mesh(-1)"
    emit(
        {
            "phase": "fleet_mesh_device",
            "visible_cards": n_cards,
            "make_fleet_mesh(-1)": auto and [str(d) for d in auto.devices],
            "mesh": [str(d) for d in mesh.devices],
            "used": used,
        }
    )
    require(
        (auto is None) == (n_cards == 1),
        f"fleet_mesh: make_fleet_mesh(-1) gave {auto} with {n_cards} cards",
    )
    total = dict.fromkeys(FLEET_KERNELS, 0)

    # (a) the main path sharded
    spec = replace(get_scenario("paper_fig2"), dqn=DQNConfig()).fast()
    spec = replace(spec, sys=replace(spec.sys, fleet_devices=mesh.size))
    n_agents = spec.sys.n_agents
    flushes: dict = {}
    with fleet_mesh_given(federated, mesh):
        system, report, launches, run_s, eval_s = timed_run(spec, dev, flushes=flushes)
    engine = system.engine
    ref, ref_flushes = main_ref["report"], main_ref["flushes"]
    loss_diff = max(
        abs(a.loss - b.loss) for a, b in zip(report.history, ref.history, strict=True)
    )
    p_err = max(
        float((a[:n_agents] - b[:n_agents]).abs().max())
        for a, b in zip(
            leaves(flushes["params"]), leaves(ref_flushes["params"]), strict=True
        )
    )
    err_diff = abs(report.mean_dist_err - ref.mean_dist_err)
    # shards with agents: the others hold dead rows and launch nothing
    n_shards = min(n_agents, mesh.size)
    step = {
        "whole": _profile_steps(spec.dqn, n_agents, 4, repeats=3),
        "sharded": _profile_steps(spec.dqn, n_agents, 4, repeats=3, shards=n_shards),
    }
    emit(
        {
            "phase": "fleet_mesh",
            "scenario": "paper_fig2 --fast, dqn=DQNConfig(), fleet_devices="
            f"{mesh.size} on {used}",
            "cuts": "none",
            "capacity": engine.capacity,
            "records_equal_but_loss": _meta(report) == _meta(ref),
            "max_round_loss_diff": loss_diff,
            "params_max_abs_err_after_first_flush": p_err,
            "params_bound": MESH_PARAMS_TOL,
            "loss_bound": MESH_LOSS_TOL,
            "agents_a_shard_at_most": -(-n_agents // mesh.size),
            "mean_dist_err": [report.mean_dist_err, ref.mean_dist_err],
            "mean_dist_err_diff": err_diff,
            "run_s": [run_s, main_ref["run_s"]],
            "flush_s": [flushes["flush_s"], ref_flushes["flush_s"]],
            "eval_s": [eval_s, main_ref["eval_s"]],
            "stacked_steps": engine.n_chunk_steps,
            "shard_steps": engine.n_shard_steps,
            "flushes": engine.n_flushes,
            "launches": launches,
            "step_sharded": _step_numbers(step["sharded"]),
            "step_whole": _step_numbers(step["whole"]),
        }
    )
    capacity = max(1 << (n_agents - 1).bit_length(), mesh.size)
    require(
        engine.mesh is mesh and engine.capacity == capacity,
        f"fleet_mesh: engine mesh {engine.mesh}, capacity {engine.capacity}",
    )
    require(_meta(report) == _meta(ref), "fleet_mesh: the round records differ")
    require(loss_diff <= MESH_LOSS_TOL, f"fleet_mesh: losses differ by {loss_diff}")
    require(p_err <= MESH_PARAMS_TOL, f"fleet_mesh: params differ by {p_err}")
    require(err_diff <= MESH_ERR_TOL, f"fleet_mesh: errors differ by {err_diff}")
    for k in FLEET_KERNELS:
        require(
            launches[k] == engine.n_shard_steps > engine.n_chunk_steps > 0,
            f"fleet_mesh: {k} launched {launches[k]} times for "
            f"{engine.n_shard_steps} shard steps",
        )
        total[k] += launches[k]

    # (b) flash_crowd's widest stacked step, whole and over same-card shards
    crowd = {
        n: _step_numbers(
            _profile_steps(DQNConfig(), CROWD_AGENTS, 4, repeats=3, shards=n)
        )
        for n in (1, 2, 4)
    }
    emit({"phase": "fleet_mesh_crowd_step", "agents": CROWD_AGENTS, "by_shards": crowd})

    # (c) the serving session on the mesh
    with fleet_mesh_given(serve_driver, mesh):
        served = serve_batching_run(dev, 16, devices=mesh.size)
    differ = [
        i
        for i, (x, y) in enumerate(zip(serve_ref, served["per_request"], strict=True))
        if x != y
    ]
    summary = served["summary"]
    emit(
        {
            "phase": "fleet_mesh_serve",
            "session": "as serve_batching's batched run, on the mesh",
            "sharded": summary,
            "requests_differing_from_unsharded": differ,
        }
    )
    require(not differ, f"fleet_mesh serve: requests {differ} differ from unsharded")
    for k in FLEET_KERNELS:
        require(
            summary["launches"][k] == summary["shard_steps"] == 20 * min(4, mesh.size),
            f"fleet_mesh serve: {k} launched {summary['launches'][k]} times for "
            f"{summary['shard_steps']} shard steps",
        )
        total[k] += summary["launches"][k]
    emit({"phase": "fleet_mesh_wall", "seconds": time.perf_counter() - t_phase})
    return total


def _key(arch: str) -> str:
    """An arch's name as a key of the kernels line: ``qwen2.5-14b`` ->
    ``qwen25_14b``."""
    return arch.replace(".", "").replace("-", "_")


def check_rmsnorm(dev) -> dict:
    """The prefill [B*S, d] and decode [B, d] calls of the zoo main path
    (the ``cta`` route) for h2o-danube-3-4b (d 3840) and qwen2.5-14b
    (d 5120: 640 vectors a row, the 256-thread plan at prefill too), the
    danube train step's forward [B*S, d] at batch 2, seq 1024, and
    xlstm-125m's (the train_lm_125m example's) at batch 4, seq 256, float32
    rows, many and few 16 KB rows (the reference's largest, d = 8192
    bf16), and the ``masked`` route: rows of 1001 elements, whose width is
    no multiple of 16 bytes, rows over 16 KB, and an x 2 bytes off a
    16-byte boundary.  Each case must move its route's launch count.
    Tolerances: bf16 2e-2 (one bf16 rounding, as
    tests/test_kernels_rmsnorm.py), f32 1e-5 (sum order and rsqrt).
    Then C's backward (``RMSNorm``, plain torch) against autograd through
    ``rmsnorm_plain`` at the train shape in bf16 and f32: 3e-2 and 1e-5
    of each output's largest magnitude."""
    rng = np.random.default_rng(3)
    d = get_config(ZOO_ARCH).d_model
    dq = get_config("qwen2.5-14b").d_model
    dx = get_config(EXAMPLE_ARCH).d_model
    bf, f32 = torch.bfloat16, torch.float32
    # the serving shapes of the other RMSNorm widths: qwen2-vl d 1536,
    # moonshot's (and deepseek's) 2048, qwen3-moe's 4096, jamba's 8192 and
    # xlstm's 768
    new_widths = [
        (_key(arch), get_config(arch).d_model)
        for arch in (
            "qwen2-vl-2b",
            "moonshot-v1-16b-a3b",
            "qwen3-moe-235b-a22b",
            "jamba-1.5-large-398b",
            "xlstm-125m",
        )
    ]
    cases = (
        ("prefill", ZOO_BATCH * ZOO_PROMPT, d, bf, "cta", 0, 2e-2),
        ("decode", ZOO_BATCH, d, bf, "cta", 0, 2e-2),
        ("qwen25_14b_prefill", ZOO_BATCH * ZOO_PROMPT, dq, bf, "cta", 0, 2e-2),
        ("qwen25_14b_decode", ZOO_BATCH, dq, bf, "cta", 0, 2e-2),
        *(
            (f"{key}_{mode}", n, width, bf, "cta", 0, 2e-2)
            for key, width in new_widths
            for mode, n in (("prefill", ZOO_BATCH * ZOO_PROMPT), ("decode", ZOO_BATCH))
        ),
        ("train", TRAIN_BATCH * TRAIN_SEQ, d, bf, "cta", 0, 2e-2),
        ("xlstm_125m_train", EXAMPLE_BATCH * EXAMPLE_SEQ, dx, bf, "cta", 0, 2e-2),
        ("many_f32", 1500, 1000, f32, "cta", 0, 1e-5),
        ("many_16k", 1024, 8192, bf, "cta", 0, 2e-2),
        ("one_f32", 1, d, f32, "cta", 0, 1e-5),
        ("ragged", 37, 1000, f32, "cta", 0, 1e-5),
        ("few_16k", 4, 8192, bf, "cta", 0, 2e-2),
        ("tail", 37, 1001, f32, "masked", 0, 1e-5),
        ("tail", 5, 1001, bf, "masked", 0, 2e-2),
        ("wide", 6, 8200, bf, "masked", 0, 2e-2),
        ("unaligned", ZOO_BATCH, d, bf, "masked", 1, 2e-2),
    )
    worst, timed = 0.0, {}
    for name, n, width, dtype, way, offset, tol in cases:
        flat = torch.tensor(
            rng.standard_normal(n * width + offset), dtype=dtype, device=dev
        )
        x = flat[offset:].view(n, width)
        scale = torch.tensor(
            rng.standard_normal(width), dtype=torch.float32, device=dev
        )
        before = dict(rmsnorm.launches_by_route)
        got = rmsnorm(x, scale, RMS_EPS)
        want = rmsnorm_plain(x, scale, RMS_EPS)
        torch.cuda.synchronize()
        moved = {r: k - before[r] for r, k in rmsnorm.launches_by_route.items()}
        require(
            moved == {r: int(r == way) for r in moved},
            f"rmsnorm {name}: expected one {way} launch, got {moved}",
        )
        err = float((got.float() - want.float()).abs().max())
        require(
            torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
            f"rmsnorm {name} [{n}, {width}] {dtype}: max|d|={err}",
        )
        worst = max(worst, err)
        if name in ("many_f32", "many_16k", "one_f32", "ragged", "few_16k"):
            continue
        if name in ("tail", "wide", "unaligned"):
            continue
        nbytes = 2 * n * width * x.element_size() + width * 4
        timed[name] = {
            "route": way,
            **timings(
                lambda: rmsnorm(x, scale, RMS_EPS),
                lambda: torch.nn.functional.rms_norm(
                    x.float(), (width,), scale, RMS_EPS
                ).to(x.dtype),
                lambda: torch.mul(x, 2.0),
            ),
            "plain_ms": cuda_ms(lambda: rmsnorm_plain(x, scale, RMS_EPS)),
            "bound_ms": bound_ms(nbytes),
            "bound_by": "bytes",
            "shape": [n, width, str(dtype).removeprefix("torch.")],
        }
    main = {
        "max_abs_err": worst,
        **timed.pop("prefill"),
        **timed,
        "backward": check_rmsnorm_backward(dev),
    }
    emit({"phase": "kernel", "name": "rmsnorm", **main})
    return main


def check_rmsnorm_backward(dev) -> dict:
    """C's backward at the train shape, bf16 and f32, against autograd
    through ``rmsnorm_plain``; times of one forward and backward each."""
    n, d = TRAIN_BATCH * TRAIN_SEQ, get_config(ZOO_ARCH).d_model
    gen = torch.Generator(device=dev).manual_seed(9)
    out = {}
    for dtype, rtol in ((torch.bfloat16, 3e-2), (torch.float32, 1e-5)):
        x = torch.randn(n, d, generator=gen, device=dev).to(dtype)
        scale = torch.randn(d, generator=gen, device=dev)
        g = torch.randn(n, d, generator=gen, device=dev).to(dtype)
        xa, sa = x.requires_grad_(), scale.requires_grad_()

        def kernel():
            y = RMSNorm.apply(xa, sa, RMS_EPS)
            return (y, *torch.autograd.grad(y, (xa, sa), g))

        def plain():
            y = rmsnorm_plain(xa, sa, RMS_EPS)
            return (y, *torch.autograd.grad(y, (xa, sa), g))

        before = rmsnorm.launches
        got = kernel()
        launched = rmsnorm.launches - before
        want = plain()
        torch.cuda.synchronize()
        errs = {}
        for key, a, b in zip(("y", "dx", "dscale"), got, want, strict=True):
            a, b = a.detach(), b.detach()
            err = float((a.float() - b.float()).abs().max())
            scale_ = float(b.float().abs().max())
            require(
                a.dtype == b.dtype and err <= rtol * scale_,
                f"rmsnorm backward {dtype} {key}: max|d|={err}, max={scale_}",
            )
            errs[key] = err / scale_
        require(launched == 1, f"rmsnorm backward: {launched} launches, not 1")
        out[str(dtype).removeprefix("torch.")] = {
            "rel_err": errs,
            "tol": rtol,
            "ms": cuda_ms(kernel, reps=50, warmup=5),
            "plain_ms": cuda_ms(plain, reps=50, warmup=5),
        }
    return out


def unmasked_pairs(s: int, window: int | None) -> int:
    """(query, key) pairs a causal attention over ``s`` tokens computes."""
    w = s if window is None else window
    return sum(min(i + 1, w) for i in range(s))


def attention_bound(b, s, hq, hkv, d, dtype, window) -> tuple[float, str]:
    flops = 4 * b * hq * d * unmasked_pairs(s, window)
    elem = torch.finfo(dtype).bits // 8
    nbytes = (2 * b * s * hq * d + 2 * b * s * hkv * d) * elem  # q, o, k, v
    f_ms, b_ms = flops / PEAK_FLOPS[dtype] * 1e3, bound_ms(nbytes)
    return (f_ms, "operations") if f_ms >= b_ms else (b_ms, "bytes")


def check_flash_attention(dev) -> dict:
    """The zoo main path's prefill shape, a 4608-token one with the 4096
    window live, the quickstart example's float32 [1, 128, 4|2, 32] call
    (the scalar route; timed beside SDPA), a float32 one with a softcap,
    and the edges of the tensor-core route: a single tile, tails at S =
    1000 and 130, GQA
    groups 1, 4 and 8, a window that cuts inside a tile, a bf16 softcap,
    D = 40 (one zero-padded half) and D = 36 (the scalar route).  v has a
    different spread for every key, so a key taken in the wrong order
    shows.  Each case must move its route's launch count.  Tolerances: bf16
    3e-2 (as tests/test_kernels.py), f32 2e-5."""
    rng = np.random.default_rng(4)
    cfg = get_config(ZOO_ARCH)
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    w = cfg.sliding_window
    bf, f32 = torch.bfloat16, torch.float32
    # the prefills of the other zoo_main archs that attend (no window): the
    # two 15 B configs, qwen2-vl (12/2), musicgen (24/24 of 64), qwen3-moe
    # (64/4), moonshot (MHA 16/16), deepseek's dense prefix layer (16/16 at
    # its prompt of 480) and jamba's attention layer (64/8); xlstm has none
    prefills = tuple(
        (f"{_key(arch)}_prefill", ZOO_BATCH, ZOO_PROMPTS.get(arch, ZOO_PROMPT),
         c.n_heads, c.n_kv_heads, c.resolved_head_dim, bf, None, 0.0, 3e-2)
        for arch in ZOO_ARCHS[1:]
        for c in (get_config(arch),)
        if any(mixer == ATTN for mixer, _ in c.layer_pattern)
    )
    cases = (
        ("main", ZOO_BATCH, ZOO_PROMPT, hq, hkv, d, bf, w, 0.0, 3e-2),
        *prefills,
        ("window", 1, 4608, hq, hkv, d, bf, w, 0.0, 3e-2),
        ("quickstart_scalar", *QUICKSTART_ATTENTION, f32, None, 0.0, 2e-5),
        ("softcap", 2, 333, 8, 2, d, f32, None, 30.0, 2e-5),
        ("tile", 1, 64, 1, 1, 64, bf, None, 0.0, 3e-2),
        ("group1", 2, 1000, 8, 8, d, bf, None, 0.0, 3e-2),
        ("group4", 1, 130, 8, 2, d, bf, None, 0.0, 3e-2),
        ("group8", 1, 130, 8, 1, d, bf, None, 0.0, 3e-2),
        ("window48", 2, 200, 4, 1, 64, bf, 48, 0.0, 3e-2),
        ("softcap_bf16", 1, 300, 4, 2, 128, bf, None, 30.0, 3e-2),
        ("d40", 2, 150, 4, 2, 40, bf, None, 0.0, 3e-2),
        ("d36", 1, 150, 4, 2, 36, bf, None, 0.0, 3e-2),
    )
    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst, out = 0.0, {}
    for name, b, s, nq, nkv, hd, dtype, window, cap, tol in cases:
        q, k = (
            torch.tensor(rng.standard_normal((b, s, n, hd)), dtype=dtype, device=dev)
            for n in (nq, nkv)
        )
        spread = rng.uniform(0.25, 2.0, (1, s, 1, 1))
        v = torch.tensor(
            rng.standard_normal((b, s, nkv, hd)) * spread, dtype=dtype, device=dev
        )
        kw = {"window": window, "softcap": cap}
        way = route(dtype, hd)
        before = dict(flash_attention.launches_by_route)
        got = flash_attention(q, k, v, **kw)
        want = attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        moved = {r: n - before[r] for r, n in flash_attention.launches_by_route.items()}
        require(
            moved == {r: int(r == way) for r in moved},
            f"flash_attention {name}: expected one {way} launch, got {moved}",
        )
        err = float((got.float() - want.float()).abs().max())
        require(
            torch.allclose(got.float(), want.float(), atol=tol, rtol=tol),
            f"flash_attention {name} {[b, s, nq, nkv, hd]} {dtype}: max|d|={err}",
        )
        worst = max(worst, err)
        timed_case = name in ("main", "window", "quickstart_scalar")
        if not timed_case and not name.endswith("_prefill"):
            continue
        bound, by = attention_bound(b, s, nq, nkv, hd, dtype, window)
        # SDPA's boolean mask: True = attend (causal, inside the window)
        i = torch.arange(s, device=dev)
        mask = i[None, :] <= i[:, None]
        if window is not None:
            mask &= i[:, None] - i[None, :] < window
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        reps = 50 if name == "main" else 20
        out[name] = {
            "route": way,
            **timings(
                lambda: flash_attention(q, k, v, **kw),
                lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True),
                lambda: torch.mul(q, 0.5),
                reps=reps,
                warmup=5,
            ),
            "bound_ms": bound,
            "bound_by": by,
            "shape": [b, s, nq, nkv, hd, str(dtype).removeprefix("torch.")],
        }
        if name != "window":
            # no window, or one (4096) that does not bind at S = 1000:
            # is_causal computes the same function and may take SDPA's
            # flash backend
            require(window is None or s <= window, f"{name}: the window binds")

            def causal():
                return sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)

            out[name]["library_causal_ms"] = cuda_ms(causal, reps=reps, warmup=5)
            out[name]["library_causal_device_ms"] = graph_ms(causal)
            out[name]["plain_ms"] = cuda_ms(
                lambda: attention_plain(q, k, v, **kw), reps=20, warmup=2
            )
        del q, k, v, got, want, mask
    main = {"max_abs_err": worst, **out.pop("main"), **out}
    emit({"phase": "kernel", "name": "flash_attention", **main})
    return main


def kda_step_bytes(b: int, h: int, d: int, act_bytes: int) -> int:
    """The least a ``kda_step`` launch moves: per (sequence, head) the
    float32 d x d state read and written, q, k and v read and o written in
    the activations' dtype, the float32 decay and beta read."""
    return b * h * (2 * d * d * 4 + 4 * d * act_bytes + (d + 1) * 4)


def check_kda_step(dev) -> dict:
    """E (``kda_step``) against ``kda_step_plain`` on the card: Kimi-Linear's
    decode call at batch 128 (B 128, H 32, d 128) in bf16, the same in
    float32, and a ragged one (B 3, H 5, d 72: fewer columns than lanes),
    each three steps in a row from one state, one launch a step.
    Tolerances as tests/test_torch_cuda_paths.py's card test: the float32
    state within 1e-5 of the plain state's largest magnitude (float32 both
    sides, sums in another order), ``o`` within 2**-7 (bf16: its rounding,
    twice) or 1e-5 (float32) of its largest.  The bf16 decode call timed
    like phase 3 (no library call computes the step); bound: bytes."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = (
        ("decode", 128, 32, 128, torch.bfloat16, 2**-7),
        ("decode_f32", 128, 32, 128, torch.float32, 1e-5),
        ("ragged", 3, 5, 72, torch.bfloat16, 2**-7),
    )
    worst, timed = 0.0, {}
    for name, b, h, d, dtype, o_rtol in cases:
        state = torch.randn(b, h, d, d, generator=gen, device=dev) * 0.1
        mine, plain = state.clone(), state.clone()
        for _ in range(3):
            qkv = torch.randn(b, 3, h, d, generator=gen, device=dev).to(dtype)
            g = -torch.exp(torch.randn(b, h, d, generator=gen, device=dev))
            beta = torch.rand(b, h, generator=gen, device=dev)
            before = kda_step.launches
            o = kda_step(mine, qkv, g, beta, d**-0.5)
            want = kda_step_plain(plain, qkv, g, beta, d**-0.5)
            torch.cuda.synchronize()
            require(
                kda_step.launches == before + 1,
                f"kda_step {name}: {kda_step.launches - before} launches, not 1",
            )
            err = float((o.float() - want.float()).abs().max())
            require(
                err <= o_rtol * float(want.float().abs().max()),
                f"kda_step {name} [{b}, {h}, {d}] {dtype}: o max|d|={err}",
            )
            worst = max(worst, err)
            err = float((mine - plain).abs().max())
            require(
                err <= 1e-5 * float(plain.abs().max()),
                f"kda_step {name} [{b}, {h}, {d}] {dtype}: state max|d|={err}",
            )
        if name != "decode":
            continue
        out = torch.empty(b, h, d, dtype=dtype, device=dev)
        timed = {
            **timings(
                lambda: kda_step(mine, qkv, g, beta, d**-0.5),
                None,
                lambda: torch.mul(out, 2.0),
            ),
            "plain_ms": cuda_ms(
                lambda: kda_step_plain(plain, qkv, g, beta, d**-0.5), reps=20, warmup=2
            ),
            "bound_ms": bound_ms(kda_step_bytes(b, h, d, qkv.element_size())),
            "bound_by": "bytes",
            "shape": [b, h, d, str(dtype).removeprefix("torch.")],
        }
    main = {"max_abs_err": worst, **timed}
    emit({"phase": "kernel", "name": "kda_step", **main})
    return main


def kda_chunk_flops(b: int, s: int, h: int, d: int) -> int:
    """The products a ``kda_chunk`` launch needs (multiply and add, two
    flops), per (sequence, head) and 64-token chunk (the last counted
    whole): the pairwise products (q.k on and below the diagonal, k.k
    below it), the substitution over 2d right-hand columns, W S and q S,
    Aqk w on and below the diagonal, and the state's update."""
    c, lower, strict = 64, 64 * 65 // 2, 64 * 63 // 2
    per_chunk = (
        (lower + strict) * d  # Aqk, L
        + strict * 2 * d  # (I + L) [U | W] = [beta v | beta k exp(gc)]
        + 2 * c * d * d  # W S, q S
        + lower * d  # Aqk w
        + c * d * d  # the state's update
    )
    return 2 * b * h * -(-s // c) * per_chunk


def kda_chunk_bytes(b: int, s: int, h: int, d: int, out_bytes: int) -> int:
    """The least a ``kda_chunk`` launch moves: q, k, v and g read in
    float32, beta read, o written in its dtype, the float32 state written."""
    return b * s * h * (4 * d * 4 + 4 + d * out_bytes) + b * h * d * d * 4


def check_kda_chunk(dev) -> dict:
    """F (``kda_chunk``) against ``kda_chunk_plain`` on the card: a slice of
    Kimi-Linear's prefill at batch 128 (32 rows of prompt 1024, H 32, d 128,
    ``o`` in bf16), its slice at prompt 512 (64 rows: ``SLICE_BYTES`` over
    S H d 4), the same 1024 in float32 at 2 rows, and a ragged one (B 3,
    S 200: a chunk and a partial one past three; H 5, d 72), decays drawn as
    the CPU test's (``-exp(2 randn)`` up to 60: a chunk's cumulative decay
    reaches hundreds), one launch a call.  Tolerances as
    tests/test_torch_cuda_paths.py's card test: the float32 state within
    1e-4 of the plain state's largest magnitude and float32 ``o`` within
    1e-4 of its largest (float32 both sides; the substitution, the halving's
    sums and the state's products in another order), bf16 ``o`` within
    2**-7 (each side rounds once to bf16: one part in 2**8, twice).  The
    bf16 slice timed like phase 3 (no library call computes it; ``device_ms``
    over 10 calls in a graph, each allocating its outputs); bound: the
    larger of its products at 67 TFLOP/s (FFMA) and its bytes at 3.35 TB/s."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = (
        ("prefill", 32, 1024, 32, 128, torch.bfloat16, 2**-7),
        ("prefill_512", 64, 512, 32, 128, torch.bfloat16, 2**-7),
        ("prefill_f32", 2, 1024, 32, 128, torch.float32, 1e-4),
        ("ragged", 3, 200, 5, 72, torch.bfloat16, 2**-7),
    )
    worst, timed = 0.0, {}
    for name, b, s, h, d, dtype, o_rtol in cases:
        qkv = torch.randn(b, s, 3, h, d, generator=gen, device=dev)
        g = -torch.exp(2 * torch.randn(b, s, h, d, generator=gen, device=dev))
        g = g.clamp(min=-60.0)
        beta = torch.rand(b, s, h, generator=gen, device=dev)
        before = kda_chunk.launches
        o, state = kda_chunk(qkv, g, beta, d**-0.5, 64, dtype)
        want, want_state = kda_chunk_plain(qkv, g, beta, d**-0.5, 64, dtype)
        torch.cuda.synchronize()
        require(
            kda_chunk.launches == before + 1,
            f"kda_chunk {name}: {kda_chunk.launches - before} launches, not 1",
        )
        err = float((o.float() - want.float()).abs().max())
        require(
            err <= o_rtol * float(want.float().abs().max()),
            f"kda_chunk {name} [{b}, {s}, {h}, {d}] {dtype}: o max|d|={err}",
        )
        worst = max(worst, err)
        err = float((state - want_state).abs().max())
        require(
            err <= 1e-4 * float(want_state.abs().max()),
            f"kda_chunk {name} [{b}, {s}, {h}, {d}] {dtype}: state max|d|={err}",
        )
        del want, want_state
        if name != "prefill":
            continue

        def call():
            return kda_chunk(qkv, g, beta, d**-0.5, 64, dtype)

        flops = kda_chunk_flops(b, s, h, d)
        nbytes = kda_chunk_bytes(b, s, h, d, o.element_size())
        f_ms, b_ms = flops / PEAK_FLOPS[torch.float32] * 1e3, bound_ms(nbytes)
        timed = {
            "ms": cuda_ms(call, reps=20, warmup=3),
            "device_ms": graph_ms(call, launches=10, replays=3),
            "library_ms": None,
            "library_device_ms": None,
            "floor_ms": cuda_ms(lambda: torch.mul(o, 2.0), reps=20, warmup=3),
            "plain_ms": cuda_ms(
                lambda: kda_chunk_plain(qkv, g, beta, d**-0.5, 64, dtype),
                reps=3,
                warmup=1,
            ),
            "bound_ms": max(f_ms, b_ms),
            "bound_by": "operations" if f_ms >= b_ms else "bytes",
            "operations_ms": f_ms,
            "bytes_ms": b_ms,
            "gflop": flops / 1e9,
            "shape": [b, s, h, d, str(dtype).removeprefix("torch.")],
        }
        del o, state
    main = {"max_abs_err": worst, **timed}
    emit({"phase": "kernel", "name": "kda_chunk", **main})
    return main


MHC_KW = dict(norm_eps=1e-6)


def mhc_site_bytes(t: int, c: int, act_bytes: int) -> int:
    """The least one mHC site's two launches move over ``t`` tokens of 4
    rows of ``c``: the stream read by ``mhc_pre_kernel``, read and written
    by ``mhc_post_kernel``; u written and y read; phi [4c, 24] and the
    norm's scale read once; H_post and H_res written and read."""
    return 3 * t * 4 * c * act_bytes + 2 * t * c * act_bytes + 4 * c * 25 * 4 + 2 * t * 20 * 4


def mhc_site_flops(t: int, c: int) -> int:
    """One site's products: the 24 columns of the projection and the
    squares over 4c, u's 4 a column, the new stream's 5 a column of a row."""
    return 2 * t * 4 * c * 25 + 2 * t * 4 * c + 2 * t * 4 * c * 5


def check_mhc(dev) -> dict:
    """G (``mhc.pre``, ``mhc.post``: one mHC site) against its plain forms
    on the card: Xing4.0's decode call (128 rows of 4 x 3584) in bf16 and
    float32, a slice of its 1024-token prefill at batch 128 (16,384 rows:
    32 rows a CTA), and a ragged one (37 rows of 4 x 256), a site's
    parameters drawn away from their init.  Two launches a site;
    tolerances as tests/test_torch_cuda_paths.py's card test: H_post and
    H_res within 1e-5, ``u`` and the new stream within 2**-7 (bf16: each
    side rounds once) or 1e-5 (float32) of their largest.  The bf16
    decode site and the prefill slice timed like phase 3 (no library call
    computes it); bound: the larger of the products at the float32 units'
    67 TFLOP/s and the bytes at 3.35 TB/s."""
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = (
        ("decode", 128, 3584, torch.bfloat16, 2**-7),
        ("decode_f32", 128, 3584, torch.float32, 1e-5),
        ("prefill", 16384, 3584, torch.bfloat16, 2**-7),
        ("ragged", 37, 256, torch.bfloat16, 2**-7),
    )
    worst, timed = 0.0, {}
    for name, t, c, dtype, rtol in cases:
        x = torch.randn(t, 4, c, generator=gen, device=dev).to(dtype)
        p = (
            (4 * c) ** -0.5 * torch.randn(4 * c, 24, generator=gen, device=dev),
            1 + 0.3 * torch.randn(3, generator=gen, device=dev),
            0.5 * torch.randn(24, generator=gen, device=dev),
            1 + 0.3 * torch.randn(4 * c, generator=gen, device=dev),
        )
        y = torch.randn(t, c, generator=gen, device=dev).to(dtype)
        before = mhc.launches
        u, h_post, h_res = mhc.pre(x, *p, **MHC_KW)
        out = mhc.post(x, y, h_post, h_res)
        torch.cuda.synchronize()
        require(mhc.launches == before + 2, f"mhc {name}: {mhc.launches - before} launches, not 2")
        want_u, want_post, want_res = mhc_pre_plain(x, *p, **MHC_KW)
        want_out = mhc_post_plain(x, y, h_post, h_res)
        for what, got, want in (("H_post", h_post, want_post), ("H_res", h_res, want_res)):
            err = float((got - want).abs().max())
            require(err <= 1e-5, f"mhc {name} [{t}, 4, {c}] {dtype}: {what} max|d|={err}")
        for what, got, want in (("u", u, want_u), ("stream", out, want_out)):
            err = float((got.float() - want.float()).abs().max())
            require(
                err <= rtol * float(want.float().abs().max()),
                f"mhc {name} [{t}, 4, {c}] {dtype}: {what} max|d|={err}",
            )
            worst = max(worst, err)
        del want_u, want_out
        if name not in ("decode", "prefill"):
            continue

        def site():
            u, h_post, h_res = mhc.pre(x, *p, **MHC_KW)
            return mhc.post(x, y, h_post, h_res)

        def plain():
            u, h_post, h_res = mhc_pre_plain(x, *p, **MHC_KW)
            return mhc_post_plain(x, y, h_post, h_res)

        flops, nbytes = mhc_site_flops(t, c), mhc_site_bytes(t, c, x.element_size())
        f_ms, b_ms = flops / PEAK_FLOPS[torch.float32] * 1e3, bound_ms(nbytes)
        row = {
            "ms": cuda_ms(site, reps=50, warmup=5),
            "device_ms": graph_ms(site, launches=20, replays=3),
            "library_ms": None,
            "library_device_ms": None,
            "floor_ms": cuda_ms(lambda: torch.mul(out, 2.0), reps=50, warmup=5),
            "plain_ms": cuda_ms(plain, reps=5, warmup=1),
            "bound_ms": max(f_ms, b_ms),
            "bound_by": "operations" if f_ms >= b_ms else "bytes",
            "operations_ms": f_ms,
            "bytes_ms": b_ms,
            "shape": [t, 4, c, str(dtype).removeprefix("torch.")],
        }
        if name == "decode":
            timed = row
        else:
            timed["prefill"] = row
        del site, plain
    main = {"max_abs_err": worst, **timed}
    emit({"phase": "kernel", "name": "mhc", **main})
    return main


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def phase_zoo_chunk(dev) -> None:
    """A narrow float32 h2o-danube-3-4b, card (kernels) vs CPU (plain
    versions), from the same params and tokens: prefill past the window,
    then decode steps fed the same tokens.  1e-4: two devices' sum orders
    through 2 layers (TF32 off on the card)."""
    cfg = replace(get_config(ZOO_ARCH).reduced(), n_kv_heads=2, sliding_window=64)
    b, s, steps = 2, 96, 8
    rng = np.random.default_rng(5)
    toks = torch.tensor(
        rng.integers(0, cfg.vocab_size, (b, s + steps)), dtype=torch.int32
    )
    cpu, gpu = Model(cfg, "cpu"), Model(cfg, dev)
    params_cpu = cpu.init_params(0)
    params_gpu = tree_to(params_cpu, dev)
    reset_launches()
    logits = {}
    for name, model, params in (("cpu", cpu, params_cpu), ("gpu", gpu, params_gpu)):
        t = toks.to(model.device)
        last, pre = model.prefill_step(params, {"tokens": t[:, :s]})
        caches = serve.load_prefill(model.init_caches(b, s + steps), pre)
        out = [last]
        for i in range(steps):
            pos = torch.full((b,), s + i, dtype=torch.int32, device=model.device)
            lg, caches = model.serve_step(
                params, caches, {"tokens": t[:, s + i : s + i + 1], "pos": pos}
            )
            out.append(lg)
        logits[name] = torch.stack(out).float().cpu()
    torch.cuda.synchronize()
    launches = read_launches()
    err = float((logits["gpu"] - logits["cpu"]).abs().max())
    emit(
        {
            "phase": "zoo_chunk",
            "config": f"{cfg.name}, n_kv_heads=2, sliding_window=64, float32",
            "prefill": s,
            "steps": steps,
            "logits_max_abs_err": err,
            "launches": launches,
        }
    )
    require(bool(torch.isfinite(logits["gpu"]).all()), "zoo chunk: non-finite logits")
    require(err <= 1e-4, f"zoo chunk: card and CPU logits differ by {err}")
    n_layers = cfg.n_layers
    require(
        launches["flash_attention"] == n_layers
        and launches["rmsnorm"] == (2 * n_layers + 1) * (steps + 1)
        and flash_attention.launches_by_route["scalar"] == n_layers,
        f"zoo chunk: launches {launches}, {flash_attention.launches_by_route}",
    )


def _records(report) -> list:
    return [dataclasses.astuple(r) for r in report.history]


def phase_observatory(dev) -> dict[str, int]:
    """``paper_fig2 --fast`` at ``DQNConfig()`` unobserved twice, then
    observed (evaluation cut to one patient); the observed run held to
    the unobserved one (as far as two unobserved runs agree on this
    card); the trace written in both formats and read back; the training
    wall of three more runs each way, in turns; a stacked step profiled
    with statistics on and off."""
    t_phase = time.perf_counter()
    spec = replace(get_scenario("paper_fig2"), dqn=DQNConfig(), eval_patients=1)
    spec = spec.fast()
    off = [timed_run(spec, dev) for _ in range(2)]
    tel = Telemetry(enabled=True)
    system, on, launches, run_s, _ = timed_run(spec, dev, telemetry=tel)
    engine = system.engine
    (_, off1, off_launches, *_), (_, off2, *_) = off
    # training walls in turns (off, on, ...), runs alone: no evaluation
    walls = {"off": [r[3] for r in off], "on": [run_s]}
    for _ in range(3):
        for key in ("off", "on"):
            walled = build(
                spec, device=dev, telemetry=Telemetry() if key == "on" else None
            )
            t0 = time.perf_counter()
            walled.run()
            torch.cuda.synchronize()
            walls[key].append(time.perf_counter() - t0)
    wall_ratio = float(np.median(walls["on"]) / np.median(walls["off"]))
    card_repeats = _records(off1) == _records(off2) and (
        off1.mean_dist_err == off2.mean_dist_err
    )
    off_loss_diff = max(
        abs(a.loss - b.loss) for a, b in zip(off1.history, off2.history, strict=True)
    )
    on_loss_diff = max(
        abs(a.loss - b.loss) for a, b in zip(on.history, off1.history, strict=True)
    )
    learning = on.extra["learning"]
    health = on.extra["health"]
    out = Path(__file__).resolve().parent / "build" / "chip_smoke"
    paths = [write_trace(tel, out / f"observatory{x}") for x in (".jsonl", ".json")]
    flushes_read = []
    for path in paths:
        metrics = load_trace(path)["metrics"]
        flushes_read.append(
            sum(
                m["value"]
                for m in metrics
                if m["kind"] == "counter" and m["name"] == "fleet.flushes"
            )
        )
    n_agents = spec.sys.n_agents
    step_off = _profile_steps(spec.dqn, n_agents, 4, repeats=3)
    step_on = _profile_steps(spec.dqn, n_agents, 4, stats=True, repeats=3)
    emit(
        {
            "phase": "observatory",
            "scenario": "paper_fig2 --fast, dqn=DQNConfig(), Telemetry(enabled=True)",
            "cuts": "evaluation: one patient (eval_patients=1)",
            "card_repeats_itself": card_repeats,
            "off_vs_off_max_loss_diff": off_loss_diff,
            "on_vs_off_max_loss_diff": on_loss_diff,
            "records_equal": _records(on) == _records(off1),
            "mean_dist_err": [off1.mean_dist_err, off2.mean_dist_err, on.mean_dist_err],
            "launches_off": off_launches,
            "launches_on": launches,
            "stacked_steps": engine.n_chunk_steps,
            "flushes": engine.n_flushes,
            "trace_flushes": flushes_read,
            "trace_events": len(tel.tracer),
            "run_s_off": walls["off"],
            "run_s_on": walls["on"],
            "run_on_over_off_median": wall_ratio,
            "step_off": {k: v for k, v in step_off.items() if k != "top"},
            "step_on": {k: v for k, v in step_on.items() if k != "top"},
            "health": health["status"],
            "learning": {
                a: {k: d[k] for k in ("n_steps", "last_loss", "max_grad_norm", "max_q")}
                for a, d in learning.items()
            },
        }
    )
    if not card_repeats:
        print(
            f"observatory: the card differs from itself between two unobserved "
            f"runs (max loss diff {off_loss_diff})",
            flush=True,
        )
    require(
        _records(on) == _records(off1) and on.mean_dist_err == off1.mean_dist_err
        if card_repeats
        else on_loss_diff <= off_loss_diff,
        f"observatory: observed run differs from unobserved (loss {on_loss_diff}, "
        f"off vs off {off_loss_diff})",
    )
    for k in FLEET_KERNELS:
        require(
            launches[k] == off_launches[k] == engine.n_chunk_steps == 80,
            f"observatory: {k} launched {off_launches[k]} off, {launches[k]} on, "
            f"for {engine.n_chunk_steps} stacked steps",
        )
    require(
        sorted(learning) == [str(i) for i in range(n_agents)]
        and all(
            d["nonfinite_flushes"] == 0
            and all(
                np.isfinite(d[k]) for k in ("last_loss", "min_loss", "max_grad_norm")
            )
            and all(np.isfinite(v) for _, v in d["loss_curve"])
            for d in learning.values()
        ),
        f"observatory: learning series {learning}",
    )
    require(health["status"] != "alert", f"observatory: health {health}")
    require(
        flushes_read == [engine.n_flushes, engine.n_flushes],
        f"observatory: trace flushes {flushes_read}, engine {engine.n_flushes}",
    )
    emit({"phase": "observatory_wall", "seconds": time.perf_counter() - t_phase})
    return {k: launches[k] for k in FLEET_KERNELS}


def _loss_and_grads(cfg, params, batch):
    """``loss_fn``'s loss, router loss and gradients (in ``tree_leaves``
    order) at a copy of ``params`` that requires them; C and D launches
    moved."""
    live = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    flat = tree_leaves(live)
    before = rmsnorm.launches, flash_attention.launches
    total, metrics = make_loss_fn(cfg)(live, batch)
    grads = torch.autograd.grad(total, flat, materialize_grads=True)
    moved = (rmsnorm.launches - before[0], flash_attention.launches - before[1])
    loss, aux = (float(metrics[k].detach()) for k in ("loss", "aux"))
    return loss, aux, [g.float().cpu() for g in grads], moved


def leaf_paths(tree, prefix="") -> list[str]:
    """``/``-joined key paths of a nested dict's leaves, in ``tree_leaves``
    order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def lm_train_batch(cfg, rng) -> dict[str, torch.Tensor]:
    """A [4, 96] batch on the host: tokens or embeds, the next-token
    labels, and for M-RoPE distinct t/h/w positions [3, 4, 96]."""
    b, s = 4, 96
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (b, s + 1)), dtype=torch.int32)
    batch = {"labels": toks[:, 1:]}
    if cfg.input_kind == "embeds":
        emb = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        batch["embeds"] = torch.tensor(emb)
    else:
        batch["tokens"] = toks[:, :-1]
    if cfg.rope == "mrope":
        hw = np.sort(rng.integers(0, s, (2, b, s)), axis=-1)
        t = np.broadcast_to(np.arange(s), (1, b, s))
        batch["positions"] = torch.tensor(np.concatenate([t, hw]), dtype=torch.int32)
    return batch


def lm_train_configs() -> list:
    """``lm_train_chunk``'s configs: a narrow danube (2 kv heads, window 64,
    as zoo_chunk), deepseek-v2-lite's reduced config (MLA, MoE with a
    shared expert, the dense prefix layer), qwen2-vl-2b's (embeds in,
    M-RoPE, positions [3, B, S] split by the microbatches), jamba's
    (Mamba with MoE and dense FFNs, attention without rope: its chunked
    scan checkpointed 2 chunks of 48) and xlstm's (mLSTM checkpointed
    alike, sLSTM 96 sequential steps, blocks without an FFN)."""
    danube = replace(get_config(ZOO_ARCH).reduced(), n_kv_heads=2, sliding_window=64)
    return [
        (danube, f"{danube.name}, n_kv_heads=2, sliding_window=64, float32"),
        (get_config("deepseek-v2-lite-16b-smoke"), "float32"),
        (get_config("qwen2-vl-2b-smoke"), "float32"),
        (get_config("jamba-1.5-large-398b-smoke"), "float32"),
        (get_config("xlstm-125m-smoke"), "float32"),
    ]


def phase_lm_train_chunk(dev) -> dict[str, int]:
    """Each of :func:`lm_train_configs`, card (C on the card) vs CPU (plain
    versions), from the same params and batch: ``loss_fn`` and its
    backward, then one ``train_step`` each way and, on the card, one at
    ``microbatches=2``.  Loss and router loss within 1e-5 relative; every
    gradient leaf within 1e-4 of its largest magnitude, and non-zero on
    the card wherever the loss reaches it (a kernel output that autograd
    cannot see through would leave the norms and the attention
    projections without one; the routers' gradients come through the
    gates): every leaf but an embeds config's unused token table; C
    launched :func:`norms_per_train_forward` times a forward and its
    backward (2L + 1 where every block has an FFN, and the rematerialised
    groups' norms again; k times that with k microbatches), D never."""
    rng = np.random.default_rng(6)
    reset_launches()
    rows = []
    for cfg, label in lm_train_configs():
        rows.append(lm_train_chunk_one(dev, cfg, label, lm_train_batch(cfg, rng)))
    launches = read_launches()
    emit({"phase": "lm_train_chunk", "configs": rows, "launches": launches})
    for row in rows:
        name = row["config"]
        require(row["loss_rel_err"] <= 1e-5, f"lm train chunk {name}: loss differs")
        require(row["aux_rel_err"] <= 1e-5, f"lm train chunk {name}: aux differs")
        require(
            row["grad_max_rel_err"] <= 1e-4,
            f"lm train chunk {name}: a gradient leaf differs by "
            f"{row['grad_max_rel_err']}",
        )
        require(
            row["zero_grad_leaves_on_card"] == row["unreached_leaves"],
            f"lm train chunk {name}: zero gradient leaves "
            f"{row['zero_grad_leaves_on_card']}",
        )
        per_forward = row["rmsnorm_per_forward"]
        require(
            row["loss_fn_launches_cpu_gpu"] == [(0, 0), (per_forward, 0)],
            f"lm train chunk {name}: loss_fn launches "
            f"{row['loss_fn_launches_cpu_gpu']}",
        )
        step_launches = [v["launches"] for v in row["train_step"].values()]
        require(
            step_launches == [(0, 0), (per_forward, 0), (2 * per_forward, 0)],
            f"lm train chunk {name}: train_step launches {step_launches}",
        )
        require(
            row["train_step_rel_err"] <= 1e-5,
            f"lm train chunk {name}: step metrics differ by "
            f"{row['train_step_rel_err']}",
        )
        require(
            row["train_step_params_max_abs_err"] <= 1e-4,
            f"lm train chunk {name}: params differ",
        )
    return {k: launches[k] for k in ("rmsnorm", "flash_attention")}


def lm_train_chunk_one(dev, cfg, label, batch) -> dict:
    params = Model(cfg, "cpu").init_params(0)
    Model(cfg, dev)  # the card's precision settings (TF32 off)
    loss_c, aux_c, grads_c, moved_c = _loss_and_grads(cfg, params, batch)
    loss_g, aux_g, grads_g, moved_g = _loss_and_grads(
        cfg, tree_to(params, dev), tree_to(batch, dev)
    )
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    aux_err = abs(aux_g - aux_c) / abs(aux_c) if aux_c else abs(aux_g)
    leaf_err = max(
        float((g - c).abs().max()) / max(float(c.abs().max()), 1e-30)
        for g, c in zip(grads_g, grads_c, strict=True)
    )
    paths = leaf_paths(params)
    zero_leaves = [p for p, g in zip(paths, grads_g) if not bool(g.abs().max() > 0)]
    unreached = ["embed/tok"] if cfg.input_kind == "embeds" else []
    steps = {}
    opt = AdamWConfig()
    for name, where, k in (("cpu", "cpu", 1), ("gpu", dev, 1), ("gpu_k2", dev, 2)):
        # a copy each: the step updates its state in place
        p = tree_map(lambda t: t.clone(), tree_to(params, where))
        state = {"params": p, "opt": tree_adamw_init(opt, p)}
        step = make_train_step(cfg, opt, microbatches=k)
        before = rmsnorm.launches, flash_attention.launches
        state, m = step(state, tree_to(batch, where))
        steps[name] = {
            "loss": float(m["loss"]),
            "aux": float(m["aux"]),
            "grad_norm": float(m["grad_norm"]),
            "launches": (
                rmsnorm.launches - before[0],
                flash_attention.launches - before[1],
            ),
            "params": [t.float().cpu() for t in tree_leaves(state["params"])],
        }
    step_err = max(
        abs(steps["gpu"][key] - steps["cpu"][key]) / abs(steps["cpu"][key])
        for key in ("loss", "aux", "grad_norm")
        if steps["cpu"][key]
    )
    param_err = max(
        float((a - b).abs().max())
        for a, b in zip(steps["gpu"]["params"], steps["cpu"]["params"], strict=True)
    )
    return {
        "config": cfg.name,
        "label": label,
        "batch": sorted(batch),
        "loss": [loss_c, loss_g],
        "aux": [aux_c, aux_g],
        "loss_rel_err": loss_err,
        "aux_rel_err": aux_err,
        "grad_leaves": len(grads_g),
        "router_leaves": [p for p in paths if p.endswith("router")],
        "grad_max_rel_err": leaf_err,
        "zero_grad_leaves_on_card": zero_leaves,
        "unreached_leaves": unreached,
        "rmsnorm_per_forward": norms_per_train_forward(cfg),
        "loss_fn_launches_cpu_gpu": [moved_c, moved_g],
        "train_step": {
            k: {kk: v for kk, v in step.items() if kk != "params"}
            for k, step in steps.items()
        },
        "train_step_rel_err": step_err,
        "train_step_params_max_abs_err": param_err,
    }


@contextmanager
def timed_train_steps():
    """CUDA-event times (ms) of every train step of the models built inside:
    ``Model`` makes its step with ``models/model.py::make_train_step``,
    wrapped here to record an event before and after each call (and wait
    for the second: the step's device time, its idle gaps included)."""
    times: list[float] = []
    inner = model_module.make_train_step

    def make(*args, **kw):
        step = inner(*args, **kw)

        def timed(state, batch):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = step(state, batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            return out

        return timed

    model_module.make_train_step = make
    try:
        yield times
    finally:
        model_module.make_train_step = inner


def train_lines(lines: list[str]) -> tuple[list, re.Match | None]:
    """``launch.train``'s printed ``(step, loss, gnorm)`` lines and its last
    ``N steps in Xs (Y tok/s)`` line."""
    step_line = re.compile(r"step +(\d+) loss=(\S+) gnorm=(\S+)")
    steps = [
        (int(m.group(1)), float(m.group(2)), float(m.group(3)))
        for m in map(step_line.fullmatch, lines)
        if m
    ]
    last = lines[-2] if lines and lines[-1].startswith("saved params") else lines[-1]
    return steps, re.fullmatch(r"(\d+) steps in (\S+)s \((\d+) tok/s\)", last)


def run_train_cli(argv: list[str]) -> dict:
    """``launch.train``'s ``main(argv)`` in this process on the card, its
    printed lines read back: the exit code, the lines, the ``(step, loss,
    gnorm)`` lines and the last line's match, the wall, each step's
    CUDA-event time, the peak of device memory and C's and D's launches;
    the device memory freed after."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), timed_train_steps() as step_ms:
        rc = train_cli.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    lines = buf.getvalue().splitlines()
    steps, done = train_lines(lines)
    return {"rc": rc, "lines": lines, "steps": steps, "done": done, "wall_s": wall_s,
            "step_ms": step_ms, "peak_gb": peak_gb, "launches": launches}  # fmt: skip


def require_trained(run: dict, n_steps: int, want_rms: int, what: str) -> None:
    """Every step printed with a finite loss and ``gnorm > 0``, C launched
    ``want_rms`` times and D never."""
    steps, launches = run["steps"], run["launches"]
    require(
        run["rc"] == 0 and run["done"] is not None,
        f"{what}: exit {run['rc']}, lines {run['lines']}",
    )
    require([i for i, _, _ in steps] == list(range(n_steps)), f"{what}: steps {steps}")
    require(
        all(np.isfinite(loss) and gnorm > 0 for _, loss, gnorm in steps),
        f"{what}: losses and grad norms {steps}",
    )
    require(
        launches["rmsnorm"] == want_rms and launches["flash_attention"] == 0,
        f"{what}: launches {launches}, want rmsnorm {want_rms} and no D",
    )


def phase_lm_train_main(dev, measured: dict) -> dict[str, int]:
    """``python -m repro_torch.launch.train`` at full width and depth:
    h2o-danube-3-4b in bfloat16 with float32 moments (``opt_cfg_for``),
    batch 2, seq 1024, 4 steps, weights from seed 0, rematerialised per
    layer (``ShardingPolicy()``, as the reference's ``launch/train.py``
    trains).  Its printed lines are read back: every step's loss finite
    and ``gnorm > 0``; C launched :func:`norms_per_train_forward` (2L +
    1, and 2L again in the recompute) x steps times, D never; the steps'
    wall and tokens a second, each step's time by CUDA events, and the
    peak of device memory (kept in ``measured`` for the planner phase)."""
    cfg = get_config(ZOO_ARCH)
    argv = ["--arch", ZOO_ARCH, "--steps", str(TRAIN_STEPS)]
    argv += ["--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]
    run = run_train_cli(argv)
    step_ms, done, launches = run["step_ms"], run["done"], run["launches"]
    # the steps after the first (which also allocates the moments' use)
    measured["lm_train_main"] = {
        "peak_gb": run["peak_gb"],
        "step_ms": float(np.median(step_ms[1:])) if len(step_ms) > 1 else float("nan"),
    }
    steps_s = float(done.group(2)) if done else float("nan")
    emit(
        {
            "phase": "lm_train_main",
            "arch": ZOO_ARCH,
            "cuts": "none (full width and depth; random weights from seed 0)",
            "argv": argv,
            "stdout": run["lines"],
            "steps": run["steps"],
            "wall_s": run["wall_s"],
            # the driver's own clock over its steps, the first included
            "step_s": steps_s / TRAIN_STEPS,
            "tok_per_s": int(done.group(3)) if done else None,
            "step_ms_cuda_events": step_ms,
            "peak_gb": run["peak_gb"],
            "launches": launches,
            "launches_by_route": {"rmsnorm": dict(rmsnorm.launches_by_route)},
        }
    )
    want_rms = norms_per_train_forward(cfg) * TRAIN_STEPS
    require_trained(run, TRAIN_STEPS, want_rms, "lm train main")
    return {"rmsnorm": launches["rmsnorm"], "flash_attention": 0}


def remat_loss_and_grads(cfg, params, batch, policy, keep_on_card: bool) -> dict:
    """``make_loss_fn(policy=)``'s loss and gradients at ``params`` on the
    card: the loss, the gradient leaves (bf16; on the host unless
    ``keep_on_card``, so that a later run's peak does not hold them), the
    forward and backward's CUDA-event time, its peak of device memory and
    C's and D's launches."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    loss_fn = make_loss_fn(cfg, loss_chunk=policy.loss_chunk, policy=policy)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    _, metrics, grads = model_module.value_and_grad(loss_fn, params, batch)
    end.record()
    end.synchronize()
    grads = tree_leaves(grads)
    return {
        "loss": float(metrics["loss"]),
        "grads": grads if keep_on_card else [g.cpu() for g in grads],
        "ms": start.elapsed_time(end),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": read_launches(),
    }


def phase_lm_train_remat(dev) -> dict[str, int]:
    """Per-layer rematerialisation (``ShardingPolicy.remat``) at full width
    and depth, h2o-danube-3-4b in bfloat16 from seed 0.

    (a) the loss and its gradients at batch 2, seq 1024 (lm_train_main's
    shape) from the same params and batch, without remat and with: the
    loss within 1e-5 relative, every gradient leaf within 1e-4 of its
    largest magnitude (lm_train_chunk's tolerances; the recompute runs the
    same kernels at the same shapes), the max |delta| of each printed; C
    :func:`norms_per_forward` times without remat and
    :func:`norms_per_train_forward` with it (49 and 97), D never; each
    forward and backward's time and peak.  (b) ``launch.train`` at batch
    4, seq 4096 (16,384 tokens a step), 3 steps: every loss finite,
    ``gnorm > 0``, C 97 x 3, D never; its peak beside
    ``dryrun.run_pair``'s estimate at that shape with remat and without
    (the latter only planned: it does not fit the card), the resident
    part of each at most the peak."""
    t_phase = time.perf_counter()
    cfg = get_config(ZOO_ARCH)
    model = Model(cfg, dev, opt_cfg=opt_cfg_for(cfg))
    params = model.init_params(0)
    del model
    raw = next(token_batches(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, seed=0
    )))  # fmt: skip
    batch = {k: torch.tensor(raw[k] % cfg.vocab_size, device=dev)
             for k in ("tokens", "labels")}  # fmt: skip
    plain = remat_loss_and_grads(cfg, params, batch, ShardingPolicy(remat=False), False)
    remat = remat_loss_and_grads(cfg, params, batch, ShardingPolicy(), True)
    loss_rel = abs(remat["loss"] - plain["loss"]) / abs(plain["loss"])
    grad_abs, grad_rel = 0.0, 0.0
    for a, b in zip(remat["grads"], plain["grads"], strict=True):
        b = b.to(dev)
        d = float((a.float() - b.float()).abs().max())
        grad_abs = max(grad_abs, d)
        grad_rel = max(grad_rel, d / max(float(b.float().abs().max()), 1e-30))
    del params, batch, plain["grads"], remat["grads"]
    gc.collect()
    torch.cuda.empty_cache()
    want_a = (norms_per_forward(cfg), norms_per_train_forward(cfg))
    got_a = (plain["launches"], remat["launches"])

    argv = ["--arch", ZOO_ARCH, "--steps", str(REMAT_STEPS)]
    argv += ["--batch", str(REMAT_BATCH), "--seq", str(REMAT_SEQ)]
    run = run_train_cli(argv)
    shape = InputShape("lm_train_remat", REMAT_SEQ, REMAT_BATCH, "train")
    plans = {
        name: planner_row(
            f"lm_train_remat ({name})",
            dryrun.run_pair(cfg, shape, mesh=make_local_mesh(), print_analyses=False,
                            policy_overrides={"remat": on}),  # fmt: skip
            run["peak_gb"],
        )
        for name, on in (("remat", True), ("no remat", False))
    }
    want_b = norms_per_train_forward(cfg) * REMAT_STEPS
    emit(
        {
            "phase": "lm_train_remat",
            "arch": ZOO_ARCH,
            "cuts": "none (full width and depth; random weights from seed 0)",
            "a": {
                "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                "loss": {"no_remat": plain["loss"], "remat": remat["loss"]},
                "loss_rel_err": loss_rel,
                "grad_max_abs_err": grad_abs,
                "grad_max_err_of_scale": grad_rel,
                "tol": {"loss_rel": 1e-5, "grad_of_scale": 1e-4},
                "fwd_bwd_ms": {"no_remat": plain["ms"], "remat": remat["ms"]},
                "peak_gb": {"no_remat": plain["peak_gb"], "remat": remat["peak_gb"]},
                "launches": {"no_remat": plain["launches"], "remat": remat["launches"]},
            },
            "b": {
                "argv": argv,
                "stdout": run["lines"],
                "steps": run["steps"],
                "wall_s": run["wall_s"],
                "step_ms_cuda_events": run["step_ms"],
                "peak_gb": run["peak_gb"],
                "launches": run["launches"],
                "plans": plans,
            },
            "seconds": time.perf_counter() - t_phase,
        }
    )  # fmt: skip
    require(loss_rel <= 1e-5, f"lm_train_remat: losses differ by {loss_rel} relative")
    require(grad_rel <= 1e-4, f"lm_train_remat: a gradient off by {grad_rel} of scale")
    for (c, d), got in zip(((want_a[0], 0), (want_a[1], 0)), got_a, strict=True):
        require(
            (got["rmsnorm"], got["flash_attention"]) == (c, d),
            f"lm_train_remat: launches {got_a}, want C {want_a} and no D",
        )
    require_trained(run, REMAT_STEPS, want_b, "lm_train_remat (b)")
    for row in plans.values():
        require(
            row["resident_gb"] <= row["measured_peak_gb"],
            f"lm_train_remat: {row['path']} resident {row['resident_gb']} GB past "
            f"the measured peak {row['measured_peak_gb']} GB",
        )
    return {
        "rmsnorm": sum(r["launches"]["rmsnorm"] for r in (plain, remat, run)),
        "flash_attention": 0,
    }


@contextmanager
def fleet_engines():
    """Every ``FleetEngine`` built inside the block, in order."""
    built, init = [], FleetEngine.__init__

    def spy(self, *args, **kw):
        init(self, *args, **kw)
        built.append(self)

    FleetEngine.__init__ = spy
    try:
        yield built
    finally:
        FleetEngine.__init__ = init


def phase_cli(dev) -> dict[str, int]:
    """The reference CI's experiments call through the port's CLI on the
    card: ``--scenario churn_addition_fig4 --scenario gossip_hetero --fast
    --json --trace --dashboard`` into a temporary directory.  Exit 0; both
    traces and both dashboards under the per-scenario names; the JSON's
    top-level keys, and each config's keys, those of
    ``benchmarks/baselines/BENCH_experiments.json``; A = B = the engines'
    stacked steps, read around the call."""
    baseline = json.loads(BENCH_BASELINE.read_text())
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        argv = [a for name in CLI_SCENARIOS for a in ("--scenario", name)]
        argv += ["--fast", "--json", str(out / "BENCH_experiments.json")]
        argv += ["--trace", str(out / "trace.jsonl")]
        argv += ["--dashboard", str(out / "dashboard.html")]
        reset_launches()
        buf = io.StringIO()
        with fleet_engines() as engines, contextlib.redirect_stdout(buf):
            rc = experiments_cli.main(argv)
        torch.cuda.synchronize()
        launches = read_launches()
        steps = sum(e.n_chunk_steps for e in engines)
        files = sorted(p.name for p in out.iterdir())
        payload = json.loads((out / "BENCH_experiments.json").read_text())
    want_files = sorted(
        ["BENCH_experiments.json"]
        + [f"trace.{n}.jsonl" for n in CLI_SCENARIOS]
        + [f"dashboard.{n}.html" for n in CLI_SCENARIOS]
    )
    configs = payload.get("configs", {})
    emit(
        {
            "phase": "cli",
            "argv": argv,
            "seconds": time.perf_counter() - t0,
            "stdout": buf.getvalue().splitlines(),
            "files": files,
            "stacked_steps": steps,
            "launches": launches,
            "mean_dist_err": {k: v.get("mean_dist_err") for k, v in configs.items()},
        }
    )
    require(rc == 0, f"cli: exit {rc}")
    require(files == want_files, f"cli: wrote {files}, not {want_files}")
    require(
        sorted(payload) == sorted(baseline)
        and sorted(configs) == sorted(CLI_SCENARIOS),
        f"cli: JSON keys {sorted(payload)}, configs {sorted(configs)}",
    )
    for name in CLI_SCENARIOS:
        # the baseline carries no `extra` (the traced run's holds the
        # observatory's and telemetry's documents): the keys outside it
        got = sorted(k for k in configs[name] if k != "extra")
        want = sorted(k for k in baseline["configs"][name] if k != "extra")
        require(got == want, f"cli {name}: keys {got}, baseline {want}")
        require(
            np.isfinite(configs[name]["mean_dist_err"]),
            f"cli {name}: mean_dist_err {configs[name]['mean_dist_err']}",
        )
    require(
        steps > 0
        and launches["replay_gather"] == steps
        and launches["fused_td"] == steps,
        f"cli: launches {launches}, stacked steps {steps}",
    )
    return {k: launches[k] for k in FLEET_KERNELS}


@contextmanager
def moe_dispatches():
    """Each MoE layer's dispatch in call order, as (its expert choices
    [T, k], the pairs it dropped): ``models/moe.py``'s dispatch wrapped
    for the block (one device reduction a layer, no host sync).  The
    zoo's named ranges are on inside, so a generation there decodes
    eagerly: a replayed decode graph makes no Python call to record."""
    calls = []
    dispatch = moe._dispatch_indices

    def recording(eidx, *args):
        e_flat, slot, keep = dispatch(eidx, *args)
        calls.append((eidx, (~keep).sum()))
        return e_flat, slot, keep

    moe._dispatch_indices = recording
    try:
        with named_ranges():
            yield calls
    finally:
        moe._dispatch_indices = dispatch


def generation_choices(calls, n_moe: int, prompt_len: int) -> list[torch.Tensor]:
    """Per MoE layer, the expert choices [B, prompt + ZOO_GEN, k] a
    generation made: its prefill's for the prompt, then each decode
    step's (``calls`` from :func:`moe_dispatches`, prefill first)."""
    decode = calls[n_moe : n_moe * (ZOO_GEN + 1)]
    return [
        torch.cat(
            [
                calls[layer][0].view(ZOO_BATCH, prompt_len, -1),
                torch.stack([decode[i * n_moe + layer][0] for i in range(ZOO_GEN)], 1),
            ],
            1,
        )
        for layer in range(n_moe)
    ]


@contextmanager
def replayed_routing(choices: list[torch.Tensor]):
    """Route every MoE layer of one forward as ``choices`` say (one
    [B, S, k] tensor a layer, in order): the layer's own float32 router
    gives the gates of those experts, renormalised, and its loss."""
    route = moe._route
    layers = iter(choices)

    def replay(cfg, router_w, x_flat, bias=None):
        _, _, aux = route(cfg, router_w, x_flat, bias)
        eidx = next(layers).reshape(x_flat.shape[0], -1)
        probs = torch.softmax(x_flat.float() @ router_w, dim=-1)
        gates = probs.gather(-1, eidx)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        return gates.to(x_flat.dtype), eidx, aux

    moe._route = replay
    try:
        yield
    finally:
        moe._route = route


def moe_decode_check(model, params, prompt, at) -> dict:
    """An MoE config's decode against the teacher-forced forward, at a
    capacity factor where nothing drops: a generation, then the forward
    twice.  Free, it routes by its own router: where rounding breaks a
    near-tie of the top-k otherwise than the generation did, an expert
    changes (``routing_flips``: the share of decode's choices that
    differ a layer, first, last and mean; the prompt tokens whose
    choices differ from the prefill's).  Replayed, it takes the
    generation's choices (:func:`replayed_routing`), so the two compute
    the same function and the difference is the arithmetic's alone."""
    prompt_len = prompt.shape[1]
    n_moe = sum(ffn == FFN_MOE for _, ffn in model.cfg.layer_pattern)
    with moe_dispatches() as calls:
        out = serve.generate(model, params, prompt, ZOO_GEN)
        free = decode_vs_forward(model, params, prompt, out, at)
    choices = generation_choices(calls, n_moe, prompt_len)
    forced = [c[0].view(ZOO_BATCH, prompt_len + ZOO_GEN, -1) for c in calls[-n_moe:]]
    flips, prompt_flips = [], 0
    for got, want in zip(choices, forced, strict=True):
        differ = (got.sort(-1).values != want.sort(-1).values).any(-1)
        flips.append(float(differ[:, prompt_len:].float().mean()))
        prompt_flips += int(differ[:, :prompt_len].sum())
    with replayed_routing(choices):
        err, scale, agree = decode_vs_forward(model, params, prompt, out, at)
    del calls, choices, forced, out
    return {
        "max_abs_err": err,
        "max_abs_logit": scale,
        "argmax_agree": agree,
        "free_max_abs_err": free[0],
        "free_argmax_agree": free[2],
        "routing_flips_first_last_mean": [flips[0], flips[-1], sum(flips) / n_moe],
        "prompt_routing_flips": prompt_flips,
    }


def moe_float32_check(dev, arch: str, prompt_len: int) -> dict:
    """:func:`moe_decode_check` in float32 at full width, depth cut to
    ``ZOO_F32_LAYERS`` (to fit the card; jamba's pattern cut with it by
    ``serve.cut_depth``), capacity factor 16, every decode step: the
    replayed forward within 1e-4 of the largest logit (zoo_chunk's
    float32 tolerance)."""
    cfg = serve.cut_depth(get_config(arch), ZOO_F32_LAYERS[arch])
    no_drop = replace(cfg.moe, capacity_factor=16.0)
    cfg = replace(cfg, dtype="float32", moe=no_drop)
    model = Model(cfg, dev)
    params = model.init_params(0)
    tok = serve.prompt_tokens(cfg.vocab_size, ZOO_BATCH, prompt_len, 0)
    prompt = torch.tensor(tok, dtype=torch.int32, device=dev)
    check = moe_decode_check(model, params, prompt, list(range(ZOO_GEN)))
    del model, params, prompt
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "n_layers": cfg.n_layers,
        "prompt": prompt_len,
        "capacity_factor": 16.0,
        **check,
        "tol": 1e-4,
    }


def decode_vs_forward(model, params, prompt, out, at) -> tuple[float, float, float]:
    """Decode logits of ``out`` at steps ``at`` against the teacher-forced
    forward over the prompt and the inputs decode was fed (the greedy
    ids, or an embeds config's zero embeds): (max |d|, max |logit|,
    argmax agreement)."""
    cfg, (b, s) = model.cfg, prompt.shape[:2]
    if cfg.input_kind == "embeds":
        fed = prompt.new_zeros((b, ZOO_GEN, cfg.d_model))
    else:
        fed = out.tokens[:, :ZOO_GEN]
    inputs = torch.cat([prompt, fed], 1)
    pos = positions_for(cfg, b, inputs.shape[1], device=prompt.device)
    hidden = forward(cfg, params, inputs, pos, mode="train")[0]
    want = logits_fn(cfg, params, hidden[:, [s + i for i in at]]).float()
    got = out.logits[at].transpose(0, 1)
    torch.cuda.synchronize()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    return err, scale, float((got.argmax(-1) == want.argmax(-1)).float().mean())


def phase_zoo_main(
    dev, arch: str, measured: dict
) -> tuple[dict[str, int], dict[str, dict[str, int]]]:
    """The serving CLI's path at full width for ``arch`` (prompt and depth
    as ``ZOO_PROMPTS``/``ZOO_LAYERS`` cut them), then decode logits at 4
    positions against the teacher-forced forward on the card; the model
    is freed before the next one is drawn.  D launches once an attention
    layer at prefill (MLA layers attend through ``chunked_attention``),
    all on the tensor-core route; C :func:`norms_per_forward` x 33 times,
    all on the ``cta`` route, for an RMSNorm config, never for a LayerNorm one
    (starcoder2-15b, musicgen-medium).  An MoE config's timed generation
    runs at its published capacity factor 1.25, where pairs are dropped
    (counted at prefill and at decode).  Its decode check runs where no
    pair is dropped (capacity factor 16: the forward over every token
    drops other pairs than decode's four-token steps), on a second
    generation of the same prompt, with the forward routed as the
    generation was (:func:`moe_decode_check`): in bf16 the two paths
    round the router's input differently, and where that breaks a top-k
    near-tie otherwise an expert changes, which moves the logits past
    the tolerance below (the free forward's difference and its routing
    flips are printed).  Then :func:`moe_float32_check`.  The timed
    generation's peak of device memory is kept in ``measured`` (the
    planner phase sets its estimate beside it).

    Tolerance: the bf16 3e-2 of tests/test_kernels.py, relative to the
    largest logit.  The two paths round differently at every bf16 product
    (a [B, 1, D] decode GEMM against a [B, S, D] one) through every layer
    of a bf16 residual stream, so an element-wise allclose(3e-2, 3e-2) is
    too tight at full depth (max |d| 0.057 on an H100 for danube); the
    float32 zoo_chunk holds the arithmetic itself to 1e-4."""
    prompt_len, n_layers = ZOO_PROMPTS.get(arch, ZOO_PROMPT), ZOO_LAYERS.get(arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params, prompt = serve.setup(
        arch, ZOO_BATCH, prompt_len, 0, dev, n_layers=n_layers
    )
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = model.cfg
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_moe = sum(ffn == FFN_MOE for _, ffn in cfg.layer_pattern)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = serve.generate(model, params, prompt, ZOO_GEN)
    launches = read_launches()
    by_route = {
        "flash_attention": dict(flash_attention.launches_by_route),
        "rmsnorm": dict(rmsnorm.launches_by_route),
    }
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    measured[f"zoo_main:{arch}"] = {"peak_gb": peak_gb}
    finite = bool(torch.isfinite(out.logits).all())
    prefill_s, decode_s = out.prefill_s, out.decode_s
    sample_ids = out.tokens[0, :8].tolist()
    calls = []
    if n_moe:  # the timed generation's pairs, from its eager twin (bit for bit)
        with moe_dispatches() as calls:
            serve.generate(model, params, prompt, ZOO_GEN)
    n_dispatches = len(calls)
    dropped = {
        "prefill": int(sum(n for _, n in calls[:n_moe])),
        "decode": int(sum(n for _, n in calls[n_moe:])),
        "prefill_pairs": ZOO_BATCH * prompt_len * cfg.moe.top_k * n_moe,
        "decode_pairs": ZOO_BATCH * ZOO_GEN * cfg.moe.top_k * n_moe,
    }
    at = [0, 10, 21, ZOO_GEN - 1]
    moe_checks = {}
    if n_moe:
        # a second generation where nothing drops, held to the forward
        # under its own routing (the gate) and under the forward's (printed)
        del out, calls
        no_drop = replace(cfg.moe, capacity_factor=16.0)
        checked = Model(replace(cfg, moe=no_drop), dev)
        moe_checks = moe_decode_check(checked, params, prompt, at)
        err, scale, agree = (
            moe_checks.pop(k) for k in ("max_abs_err", "max_abs_logit", "argmax_agree")
        )
        del checked
        out = None
    else:
        err, scale, agree = decode_vs_forward(model, params, prompt, out, at)
        del calls
    cuts = []
    if n_layers is not None:
        cuts.append(f"depth {n_layers} of {get_config(arch).n_layers} layers")
        if cfg.pattern != get_config(arch).pattern:
            cuts.append(f"pattern cut to its first {len(cfg.pattern)}: {cfg.pattern}")
    if prompt_len != ZOO_PROMPT:
        cuts.append(
            f"prompt {prompt_len} (chunked_attention's S: <= 512 or a multiple of 1024)"
        )
    n_attn = sum(mixer == ATTN for mixer, _ in cfg.layer_pattern)
    emit(
        {
            "phase": "zoo_main",
            "arch": arch,
            "cuts": "; ".join(cuts) or "none",
            "weights": "random from seed 0",
            "n_layers": cfg.n_layers,
            "params": n_params,
            "batch": ZOO_BATCH,
            "prompt": prompt_len,
            "gen": ZOO_GEN,
            "init_s": init_s,
            "init_peak_gb": init_peak_gb,
            "prefill_s": prefill_s,
            "decode_s": decode_s,
            "decode_tok_per_s": ZOO_GEN * ZOO_BATCH / decode_s,
            "peak_gb": peak_gb,
            "launches": launches,
            "launches_by_route": by_route,
            "dropped_pairs": dropped if n_moe else None,
            "teacher_forced_capacity_factor": 16.0 if n_moe else None,
            "teacher_forced_positions": at,
            "teacher_forced_max_abs_err": err,
            "teacher_forced_max_abs_logit": scale,
            "teacher_forced_argmax_agree": agree,
            **moe_checks,
            "sample_ids": sample_ids,
        }
    )
    del model, params, prompt, out
    gc.collect()
    torch.cuda.empty_cache()
    if n_moe:
        f32 = moe_float32_check(dev, arch, ZOO_F32_PROMPTS.get(arch, prompt_len))
        emit({"phase": "zoo_main_float32", "arch": arch, **f32})
        require(
            f32["max_abs_err"] <= f32["tol"] * f32["max_abs_logit"],
            f"zoo main {arch}: float32 decode vs teacher-forced max|d|="
            f"{f32['max_abs_err']}, max|logit|={f32['max_abs_logit']}",
        )
    require(finite, f"zoo main {arch}: non-finite logits")
    require(
        launches["flash_attention"] == n_attn,
        f"{arch}: flash_attention launched {launches['flash_attention']} times, "
        f"not {n_attn}",
    )
    require(
        by_route["flash_attention"] == {"wgmma": n_attn, "scalar": 0},
        f"{arch}: flash_attention routes {by_route}: every prefill layer on wgmma",
    )
    want_rms = norms_per_forward(cfg) * (ZOO_GEN + 1) if cfg.norm == "rmsnorm" else 0
    require(
        launches["rmsnorm"] == want_rms,
        f"{arch}: rmsnorm launched {launches['rmsnorm']} times, not {want_rms}",
    )
    want_routes = {"cta": want_rms, "masked": 0}
    require(
        by_route["rmsnorm"] == want_routes,
        f"{arch}: rmsnorm routes {by_route['rmsnorm']}, not {want_routes}",
    )
    require(
        n_dispatches == n_moe * (ZOO_GEN + 1),
        f"{arch}: {n_dispatches} MoE dispatches, not {n_moe} x {ZOO_GEN + 1}",
    )
    require(
        err <= 3e-2 * scale,
        f"zoo main {arch}: decode vs teacher-forced logits max|d|={err}, "
        f"max|logit|={scale}",
    )
    return launches, by_route


def phase_kimi_main(dev) -> dict[str, int]:
    """Kimi-Linear-48B-A3B's serving path at full width and depth on one
    card's expert share (``KIMI_ARCH``: experts 0-63 of each layer's 256,
    every other weight whole), as zoo_main serves (random weights from seed
    0 in bfloat16, batch 4, 32 greedy steps) at prompt 1024 (the
    ``perfbench`` cell's longer prompt); launches read around the
    generation alone.  E once a KDA layer a decode step (20 x 32), never at
    prefill; F once a KDA layer at prefill (20: the 4 rows are one slice);
    C a norm per mixer, per
    FFN and the final one, and KDA's gated output norm, a forward (55 + 20,
    x 33; the prefill's KDA runs the 4 rows as one slice), all on the
    ``cta`` route; D never (MLA attends through ``chunked_attention``).
    Finite logits; init, prefill and decode times and the peak printed.
    The model's logits are held to a plain reference by the cell's check
    (``perfbench/reference/kimi-linear-48b-a3b-ep4.py``)."""
    prompt_len = ZOO_PROMPTS[KIMI_ARCH]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params, prompt = serve.setup(KIMI_ARCH, ZOO_BATCH, prompt_len, 0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = model.cfg
    n_kda = sum(mixer == KDA for mixer, _ in cfg.layer_pattern)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = serve.generate(model, params, prompt, ZOO_GEN)
    torch.cuda.synchronize()
    launches = read_launches()
    rms_routes = dict(rmsnorm.launches_by_route)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finite = bool(torch.isfinite(out.logits).all())
    want_rms = (norms_per_forward(cfg) + n_kda) * (ZOO_GEN + 1)
    emit(
        {
            "phase": "zoo_main",
            "arch": KIMI_ARCH,
            "cuts": "64 of 256 experts a layer held (one card of expert parallel 4)",
            "weights": "random from seed 0",
            "n_layers": cfg.n_layers,
            "kda_layers": n_kda,
            "params": sum(t.numel() for t in tree_leaves(params)),
            "batch": ZOO_BATCH,
            "prompt": prompt_len,
            "gen": ZOO_GEN,
            "init_s": init_s,
            "prefill_s": out.prefill_s,
            "decode_s": out.decode_s,
            "decode_tok_per_s": ZOO_GEN * ZOO_BATCH / out.decode_s,
            "peak_gb": peak_gb,
            "launches": launches,
            "launches_by_route": {"rmsnorm": rms_routes},
            "sample_ids": out.tokens[0, :8].tolist(),
        }
    )
    del model, params, prompt, out
    gc.collect()
    torch.cuda.empty_cache()
    require(finite, f"zoo main {KIMI_ARCH}: non-finite logits")
    require(
        launches["kda_step"] == n_kda * ZOO_GEN,
        f"{KIMI_ARCH}: kda_step launched {launches['kda_step']} times, "
        f"not {n_kda} x {ZOO_GEN}",
    )
    require(
        launches["kda_chunk"] == n_kda,
        f"{KIMI_ARCH}: kda_chunk launched {launches['kda_chunk']} times, not {n_kda}",
    )
    require(
        launches["flash_attention"] == 0,
        f"{KIMI_ARCH}: flash_attention launched {launches['flash_attention']} times",
    )
    require(
        rms_routes == {"cta": want_rms, "masked": 0},
        f"{KIMI_ARCH}: rmsnorm routes {rms_routes}, not {want_rms} on cta",
    )
    return {
        k: launches[k] for k in ("rmsnorm", "flash_attention", "kda_step", "kda_chunk")
    }


def phase_xing_main(dev) -> dict[str, int]:
    """Xing4.0-29B-A4B's serving path at full width and depth on one card's
    expert share (``XING_ARCH``: experts 0-15 of each layer's 64, every
    other weight whole), as zoo_main serves (random weights from seed 0 in
    bfloat16, batch 4, 32 greedy steps) at prompt 1024 (the ``perfbench``
    cell's longer prompt); launches read around the generation alone.  G
    twice a site, two sites a layer, a forward (160 x 33: the decode steps'
    counted by their graph replays), every site on the ``kernel`` route; C
    a norm per mixer, per FFN, the final one and the q and kv latents'
    norms, a forward ((81 + 80) x 33), all ``cta``; D never (MLA attends
    through ``chunked_attention``).  Finite logits; init, prefill and decode
    times and the peak printed.  The model's logits are held to a plain
    reference by the cell's check
    (``perfbench/reference/xing4.0-29b-a4b-ep4.py``)."""
    prompt_len = ZOO_PROMPTS[XING_ARCH]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, params, prompt = serve.setup(XING_ARCH, ZOO_BATCH, prompt_len, 0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = model.cfg
    sites = 2 * cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    routes_before = dict(mhc.calls_by_route)
    out = serve.generate(model, params, prompt, ZOO_GEN)
    torch.cuda.synchronize()
    launches = read_launches()
    rms_routes = dict(rmsnorm.launches_by_route)
    mhc_routes = {r: n - routes_before[r] for r, n in mhc.calls_by_route.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finite = bool(torch.isfinite(out.logits).all())
    forwards = ZOO_GEN + 1
    want_rms = (norms_per_forward(cfg) + 2 * cfg.n_layers) * forwards
    emit(
        {
            "phase": "zoo_main",
            "arch": XING_ARCH,
            "cuts": "16 of 64 experts a layer held (one card of expert parallel 4)",
            "weights": "random from seed 0",
            "n_layers": cfg.n_layers,
            "mhc_sites": sites,
            "params": sum(t.numel() for t in tree_leaves(params)),
            "batch": ZOO_BATCH,
            "prompt": prompt_len,
            "gen": ZOO_GEN,
            "init_s": init_s,
            "prefill_s": out.prefill_s,
            "decode_s": out.decode_s,
            "decode_tok_per_s": ZOO_GEN * ZOO_BATCH / out.decode_s,
            "peak_gb": peak_gb,
            "launches": launches,
            "launches_by_route": {"rmsnorm": rms_routes, "mhc_sites": mhc_routes},
            "sample_ids": out.tokens[0, :8].tolist(),
        }
    )
    del model, params, prompt, out
    gc.collect()
    torch.cuda.empty_cache()
    require(finite, f"zoo main {XING_ARCH}: non-finite logits")
    require(
        launches["mhc"] == 2 * sites * forwards,
        f"{XING_ARCH}: mhc launched {launches['mhc']} times, not 2 x {sites} x {forwards}",
    )
    # the prefill's sites are counted by route; a replayed decode step's are
    # not (a graph replay makes no Python call)
    require(
        mhc_routes["kernel"] >= sites * 2 and mhc_routes["plain"] == 0,
        f"{XING_ARCH}: mhc sites by route {mhc_routes}",
    )
    require(
        launches["flash_attention"] == 0,
        f"{XING_ARCH}: flash_attention launched {launches['flash_attention']} times",
    )
    require(
        rms_routes == {"cta": want_rms, "masked": 0},
        f"{XING_ARCH}: rmsnorm routes {rms_routes}, not {want_rms} on cta",
    )
    return {k: launches[k] for k in ("rmsnorm", "flash_attention", "mhc")}


def phase_zoo_window(dev) -> dict[str, int]:
    """The sliding-window prefill -> decode handoff at full width:
    h2o-danube-3-4b (window 4096), batch 1, a prompt of ``WINDOW_PROMPT``
    tokens (past the window and no multiple of it, so the handed-over ring
    is rolled by 4100 % 4096), then ``WINDOW_GEN`` greedy steps, every
    step's logits against the teacher-forced forward at 3e-2 of the
    largest logit (zoo_main's tolerance).  D once a layer, C (2L + 1) x
    (steps + 1)."""
    cfg = get_config(ZOO_ARCH)
    require(
        WINDOW_PROMPT > cfg.sliding_window and WINDOW_PROMPT % cfg.sliding_window,
        "zoo window: the prompt must pass the window and be no multiple of it",
    )
    gc.collect()
    torch.cuda.empty_cache()
    model, params, prompt = serve.setup(ZOO_ARCH, 1, WINDOW_PROMPT, 0, dev)
    reset_launches()
    out = serve.generate(model, params, prompt, WINDOW_GEN)
    launches = read_launches()
    toks = torch.cat([prompt, out.tokens[:, :WINDOW_GEN]], 1)
    pos = positions_for(cfg, 1, toks.shape[1], device=dev)
    hidden = forward(cfg, params, toks, pos, mode="train")[0][:, WINDOW_PROMPT:]
    want = logits_fn(cfg, params, hidden).float()
    got = out.logits.transpose(0, 1)
    torch.cuda.synchronize()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    per_step = (got - want).abs().amax((0, 2)).tolist()
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    emit(
        {
            "phase": "zoo_window",
            "arch": ZOO_ARCH,
            "window": cfg.sliding_window,
            "batch": 1,
            "prompt": WINDOW_PROMPT,
            "gen": WINDOW_GEN,
            "ring_shift": WINDOW_PROMPT % cfg.sliding_window,
            "teacher_forced_max_abs_err": err,
            "teacher_forced_max_abs_err_per_step": per_step,
            "teacher_forced_max_abs_logit": scale,
            "teacher_forced_argmax_agree": agree,
            "prefill_s": out.prefill_s,
            "launches": launches,
        }
    )
    del model, params, prompt, out, hidden, want, got, toks
    gc.collect()
    torch.cuda.empty_cache()
    want_rms = norms_per_forward(cfg) * (WINDOW_GEN + 1)
    require(
        launches["flash_attention"] == cfg.n_layers and launches["rmsnorm"] == want_rms,
        f"zoo window: launches {launches}",
    )
    require(
        err <= 3e-2 * scale,
        f"zoo window: decode vs teacher-forced logits max|d|={err}, max|logit|={scale}",
    )
    return {k: launches[k] for k in ("rmsnorm", "flash_attention")}


def moe_ep_model(dev, mesh) -> dict[str, int]:
    """(a) qwen3-moe at full width and ``ZOO_LAYERS`` depth, as zoo_main
    builds it, through ``Model(mesh=)`` on the one-rank mesh against the
    mesh-less model on the same params: the prefill's last logits and
    ``MOE_EP_GEN`` decode steps' logits bit for bit (model 1 takes the
    local path, as in the reference).  C and D launches read around the
    mesh run alone."""
    gc.collect()
    torch.cuda.empty_cache()
    model, params, prompt = serve.setup(
        MOE_ARCH, ZOO_BATCH, ZOO_PROMPT, 0, dev, n_layers=ZOO_LAYERS[MOE_ARCH]
    )
    cfg = model.cfg
    on_mesh = Model(cfg, dev, mesh=mesh)
    mine = on_mesh.shard(params)
    same_tensors = all(
        a is b for a, b in zip(tree_leaves(mine), tree_leaves(params), strict=True)
    )
    batch = {"tokens": prompt}
    with torch.no_grad():
        want_last = model.prefill_step(params, batch)[0]
        want = serve.generate(model, params, prompt, MOE_EP_GEN)
        reset_launches()
        got_last = on_mesh.prefill_step(mine, batch)[0]
        got = serve.generate(on_mesh, mine, prompt, MOE_EP_GEN)
        torch.cuda.synchronize()
        launches = read_launches()
    prefill_err = float((got_last.float() - want_last.float()).abs().max())
    decode_err = float((got.logits - want.logits).abs().max())
    tokens_equal = torch.equal(got.tokens, want.tokens)
    n_attn = sum(mixer == ATTN for mixer, _ in cfg.layer_pattern)
    want_rms = norms_per_forward(cfg) * (2 + MOE_EP_GEN)  # the extra prefill
    emit(
        {
            "phase": "moe_ep_model",
            "arch": MOE_ARCH,
            "mesh": "DeviceMesh('cuda', (1, 1), ('data', 'model')), NCCL, one rank",
            "cuts": f"depth {cfg.n_layers} of {get_config(MOE_ARCH).n_layers} layers",
            "weights": "random from seed 0",
            "batch": ZOO_BATCH,
            "prompt": ZOO_PROMPT,
            "gen": MOE_EP_GEN,
            "params_are_the_given_tensors": same_tensors,
            "prefill_logits_max_abs_err": prefill_err,
            "decode_logits_max_abs_err": decode_err,
            "tokens_equal": tokens_equal,
            "bound": 0.0,
            "prefill_s": [got.prefill_s, want.prefill_s],
            "decode_s": [got.decode_s, want.decode_s],
            "launches": launches,
        }
    )
    del model, on_mesh, params, mine, prompt, got, want, got_last, want_last
    gc.collect()
    torch.cuda.empty_cache()
    require(same_tensors, "moe_ep: a one-rank mesh must keep the params it was given")
    require(
        prefill_err == 0.0 and decode_err == 0.0 and tokens_equal,
        f"moe_ep: Model(mesh=) logits differ from the mesh-less model's: "
        f"prefill {prefill_err}, decode {decode_err}",
    )
    require(
        launches["flash_attention"] == 2 * n_attn and launches["rmsnorm"] == want_rms,
        f"moe_ep: launches {launches}, not D {2 * n_attn} and C {want_rms}",
    )
    return {k: launches[k] for k in ("rmsnorm", "flash_attention")}


def moe_ep_layer(dev, mesh) -> None:
    """(b) the per-shard body (``moe.moe_local``) forced past
    ``moe_apply``'s routing at n_model = 1, on one qwen3-moe layer at full
    width (D 4096, E 128, top-k 8, d_ff_expert 1536, bf16; 4.8 GB of
    experts), against the local path on the same inputs: train mode at
    T = 4000 tokens takes the all-to-all branch (two NCCL
    ``all_to_all_single``), decode at T = 4 the psum branch (one NCCL
    ``all_reduce``); ``y`` and the router loss held to ``MOE_EP_TOL``.
    Times with CUDA events: the layer both ways, and each collective alone
    at the body's shapes with its bytes."""
    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = moe.moe_init(cfg, gen)
    experts = [p[k] for k in moe.EXPERTS]
    model_group, data_group = mesh.get_group("model"), mesh.get_group("data")
    dtype = p["w1"].dtype
    rows = []
    for mode, t in MOE_EP_TOKENS.items():
        x = torch.randn(t, cfg.d_model, generator=gen, device=dev, dtype=dtype)
        cap = moe.capacity(cfg, t)

        def local(x=x):
            return moe.moe_local(cfg, x, p["router"], *experts, seq_sharded=False)

        def sharded(x=x, mode=mode):
            return moe.moe_local(
                cfg, x, p["router"], *experts,
                seq_sharded=mode == "train", model=model_group, data=data_group,
            )  # fmt: skip

        with torch.no_grad():
            y0, aux0 = local()
            with moe_dispatches() as calls:
                y1, aux1 = sharded()
            dropped = int(calls[0][1])
            err = float((y1.float() - y0.float()).abs().max())
            aux_err = abs(float(aux1) - float(aux0))
            local_ms = cuda_ms(local, reps=10, warmup=2)
            sharded_ms = cuda_ms(sharded, reps=10, warmup=2)
            if mode == "train":
                send = torch.empty(1, cfg.moe.n_experts, cap, cfg.d_model, device=dev,
                                   dtype=dtype)  # fmt: skip
                coll = {
                    "all_to_all_single": {
                        "per_layer": 2,
                        "bytes": send.nbytes,
                        "ms": cuda_ms(
                            lambda: moe._all_to_all(send, model_group), 10, 2
                        ),
                    }
                }
            else:
                out = torch.empty(t, cfg.d_model, device=dev, dtype=dtype)
                coll = {
                    "all_reduce": {
                        "per_layer": 1,
                        "bytes": out.nbytes,
                        "ms": cuda_ms(
                            lambda: dist.all_reduce(out, group=model_group), 10, 2
                        ),
                    }
                }
        # the grouped SwiGLU over every expert's C rows: 3 products of
        # 2 E C D F flops; bytes: the experts, x and y once each
        flops = 6 * cfg.moe.n_experts * cap * cfg.d_model * cfg.moe.d_ff_expert
        nbytes = sum(w.nbytes for w in experts) + 2 * x.nbytes
        bounds = {
            "operations": flops / PEAK_FLOPS[dtype],
            "bytes": nbytes / HBM_BYTES_PER_S,
        }
        bound_by = max(bounds, key=bounds.get)
        rows.append(
            {
                "mode": mode,
                "tokens": t,
                "capacity": cap,
                "bound_ms": bounds[bound_by] * 1e3,
                "bound_by": bound_by,
                "branch": "all_to_all" if mode == "train" else "psum",
                "dropped_pairs": dropped,
                "y_max_abs_err": err,
                "aux_abs_err": aux_err,
                "tol": MOE_EP_TOL,
                "layer_ms": sharded_ms,
                "local_ms": local_ms,
                "collectives": coll,
            }
        )
        del x, y0, y1
    emit({"phase": "moe_ep_layer", "arch": MOE_ARCH, "n_model": 1, "cases": rows})
    del p, experts
    gc.collect()
    torch.cuda.empty_cache()
    for r in rows:
        require(
            r["y_max_abs_err"] <= MOE_EP_TOL and r["aux_abs_err"] <= MOE_EP_TOL,
            f"moe_ep: the forced {r['branch']} body differs from the local path "
            f"by {r['y_max_abs_err']} (aux {r['aux_abs_err']})",
        )


def phase_moe_ep(dev) -> dict[str, int]:
    """Expert-parallel MoE on the card: a one-rank NCCL group and its
    ``(data 1, model 1)`` ``DeviceMesh`` (``launch/mesh.py``), (a) the
    model path and (b) the sharded body (:func:`moe_ep_model`,
    :func:`moe_ep_layer`); the group is torn down at the end.  The
    machine has one card, so ranks > 1 run on the CPU over gloo
    (``tests/test_torch_moe_ep.py``)."""
    t_phase = time.perf_counter()
    torch.cuda.set_device(dev.index or 0)
    with one_rank_device_mesh("cuda") as mesh:
        launches = moe_ep_model(dev, mesh)
        moe_ep_layer(dev, mesh)
    emit({"phase": "moe_ep_wall", "seconds": time.perf_counter() - t_phase})
    return launches


def load_example(name: str):
    """``main`` of ``examples/<name>.py``, loaded from its file."""
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _delta(before: dict[str, int]) -> dict[str, int]:
    return {k: n - before[k] for k, n in read_launches().items()}


def run_example(name: str, argv: list[str]):
    """``examples/<name>.py``'s ``main(argv)`` with its stdout captured:
    (what it returns, its lines, the kernel launches it made, its wall)."""
    before = read_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = load_example(name)(argv)
    torch.cuda.synchronize()
    return out, buf.getvalue().splitlines(), _delta(before), time.perf_counter() - t0


def phase_examples(dev) -> tuple[dict[str, int], dict[str, int]]:
    """The four ``examples/torch_*.py`` on the card, their steps cut and
    their widths never, launches read around the phase and each example:

    - ``torch_train_lm_125m``: xlstm-125m at full width and depth (bf16
      params, f32 moments), batch 4, seq 256, 3 steps, its checkpoint
      written under a temporary directory: every loss finite, ``gnorm >
      0``, C 13 a forward (a norm a mixer and the final one) and 18 in
      the rematerialised groups' recompute, x steps, D never; tok/s, each
      step's CUDA-event
      time and the peak of device memory;
    - ``torch_quickstart``: the zoo section (qwen3-moe smoke, one train and
      one decode step), two DQN agents sharing an ERB and a weight
      snapshot through a hub, and D's scalar route on float32 [1, 128,
      4|2, 32] against its plain version (2e-5): one scalar launch;
    - ``torch_adfll_deployment --fast``: ``paper_fig2`` and the Table 1
      rows; every mean finite;
    - ``torch_federated_lm`` at its 25 steps a round: three heterogeneous
      agents (dense, MoE, xLSTM smoke configs) through two hubs; every
      loss and the per-style table finite.

    Over the phase A = B (one each a stacked step), D exactly the
    quickstart's one scalar launch.  Returns the fleet kernels' and the
    zoo kernels' launches."""
    cfg = get_config(EXAMPLE_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "xlstm125m_params.npz")
        argv = ["--steps", str(EXAMPLE_STEPS), "--batch", str(EXAMPLE_BATCH)]
        argv += ["--seq", str(EXAMPLE_SEQ), "--ckpt", ckpt]
        with timed_train_steps() as step_ms:
            ran = run_example("torch_train_lm_125m", argv)
        rc, lines, train_launches, train_s = ran
        saved = os.path.getsize(ckpt) if os.path.exists(ckpt) else 0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    steps, done = train_lines(lines)
    want_rms = norms_per_train_forward(cfg) * EXAMPLE_STEPS
    train = {
        "stdout": lines,
        "steps": steps,
        "wall_s": train_s,
        "tok_per_s": int(done.group(3)) if done else None,
        "step_ms_cuda_events": step_ms,
        "peak_gb": peak_gb,
        "checkpoint_bytes": saved,
        "launches": train_launches,
    }
    require(rc == 0 and done is not None and saved > 0, f"train_lm_125m: {lines}")
    require(
        [i for i, _, _ in steps] == list(range(EXAMPLE_STEPS))
        and all(np.isfinite(loss) and gnorm > 0 for _, loss, gnorm in steps),
        f"train_lm_125m: losses and grad norms {steps}",
    )
    require(
        train_launches["rmsnorm"] == want_rms
        and train_launches["flash_attention"] == 0,
        f"train_lm_125m: launches {train_launches}, want rmsnorm {want_rms}, no D",
    )

    scalar_before = flash_attention.launches_by_route["scalar"]
    quick, q_lines, q_launches, q_s = run_example("torch_quickstart", [])
    scalar = flash_attention.launches_by_route["scalar"] - scalar_before
    q = quick["kernels"]
    quickstart = {
        "stdout": q_lines,
        "wall_s": q_s,
        "zoo": {k: quick["zoo"][k] for k in ("loss", "aux")},
        "adfll": quick["adfll"],
        "kernels": q,
        "launches": q_launches,
    }
    require(
        np.isfinite([quick["zoo"]["loss"], *quick["adfll"].values()]).all()
        and bool(torch.isfinite(quick["zoo"]["logits"]).all()),
        f"quickstart: {quickstart}",
    )
    require(
        q["scalar_launches"] == scalar == 1 and q["err"] <= 2e-5,
        f"quickstart: D's scalar route {q}, {scalar} scalar launches",
    )

    deploy, d_lines, d_launches, d_s = run_example("torch_adfll_deployment", ["--fast"])
    deployment = {"stdout": d_lines, "wall_s": d_s, **deploy, "launches": d_launches}
    require(
        all(np.isfinite(m) for m in deploy["means"].values())
        and len(deploy["means"]) >= 7,
        f"adfll_deployment: {deploy}",
    )

    fed, f_lines, f_launches, f_s = run_example("torch_federated_lm", [])
    federated = {"stdout": f_lines, "wall_s": f_s, **fed, "launches": f_launches}
    require(
        np.isfinite(fed["losses"]).all() and np.isfinite(fed["table"]).all(),
        f"federated_lm: {fed}",
    )

    launches = read_launches()
    by_route = dict(flash_attention.launches_by_route)
    emit(
        {
            "phase": "examples",
            "cuts": "steps only (widths never): train_lm_125m 3 steps; "
            "adfll_deployment --fast",
            "train_lm_125m": train,
            "quickstart": quickstart,
            "adfll_deployment": deployment,
            "federated_lm": federated,
            "launches": launches,
            "flash_attention_by_route": by_route,
        }
    )
    require(
        launches["replay_gather"] == launches["fused_td"] > 0,
        f"examples: fleet launches {launches}",
    )
    require(
        by_route == {"wgmma": 0, "scalar": 1},
        f"examples: D's launches by route {by_route}, want the quickstart's one",
    )
    fleet = {k: launches[k] for k in FLEET_KERNELS}
    return fleet, {k: launches[k] for k in ("rmsnorm", "flash_attention")}


def planner_row(path: str, plan: dict, measured_gb: float) -> dict:
    mem = plan["memory_estimate"]
    return {
        "path": path,
        "measured_peak_gb": measured_gb,
        "estimate_gb": mem["total_bytes"] / 1e9,
        "resident_gb": mem["resident_bytes"] / 1e9,
        "params_gb": mem["params_bytes"] / 1e9,
        "opt_gb": mem["opt_bytes"] / 1e9,
        "grad_gb": mem["grad_bytes"] / 1e9,
        "cache_gb": mem["cache_bytes"] / 1e9,
        "act_gb": mem["act_bytes"] / 1e9,
        "recompute_gb": mem["recompute_bytes"] / 1e9,
        "flops_global": plan["flops_global"],
        "roofline": plan["roofline"],
    }


def phase_planner(dev, measured: dict) -> dict[str, int]:
    """The H100 planner (``launch/dryrun.py::run_pair``, on ``meta``
    tensors, no card) at one card (``make_local_mesh``) for this run's own
    paths, each estimate beside the peak measured above: lm_train_main's
    step (h2o-danube-3-4b, batch 2, seq 1024) and zoo_main's serving of
    every arch (batch 4, its prompt and 32 steps: the decode step with
    the caches of prompt + 32 tokens, at the depth zoo_main cut).  The
    resident part of each estimate (params, optimizer, caches) must not
    exceed the measured peak.  Then the planned FLOPs of danube's step
    over its CUDA-event time, as a share of the H100's 989 TFLOP/s.
    The planner launches no kernel."""
    reset_launches()
    t0 = time.perf_counter()
    local = make_local_mesh()
    shape = InputShape("lm_train_main", TRAIN_SEQ, TRAIN_BATCH, "train")
    cfg = get_config(ZOO_ARCH)
    plan = dryrun.run_pair(cfg, shape, mesh=local, print_analyses=False)
    train = measured["lm_train_main"]
    rows = [planner_row("lm_train_main", plan, train["peak_gb"])]
    flops_per_s = plan["flops_global"] / (train["step_ms"] / 1e3)
    for arch in ZOO_ARCHS:
        cfg = get_config(arch)
        if arch in ZOO_LAYERS:
            cfg = serve.cut_depth(cfg, ZOO_LAYERS[arch])
        prompt = ZOO_PROMPTS.get(arch, ZOO_PROMPT)
        shape = InputShape("zoo_main", prompt + ZOO_GEN, ZOO_BATCH, "decode")
        plan = dryrun.run_pair(cfg, shape, mesh=local, print_analyses=False)
        peak = measured[f"zoo_main:{arch}"]["peak_gb"]
        rows.append(planner_row(f"zoo_main:{arch}", plan, peak))
    launches = read_launches()
    emit(
        {
            "phase": "planner",
            "basis": dryrun.BASIS,
            "mesh": local,
            "rows": rows,
            "lm_train_main_step_ms": train["step_ms"],
            "lm_train_main_flops_per_s": flops_per_s,
            "lm_train_main_share_of_989_tflops": flops_per_s / PEAK_FLOPS_BF16,
            "wall_s": time.perf_counter() - t0,
            "launches": launches,
        }
    )
    require(all(n == 0 for n in launches.values()), f"planner launched {launches}")
    for row in rows:
        require(
            row["resident_gb"] <= row["measured_peak_gb"],
            f"planner {row['path']}: resident {row['resident_gb']} GB past the "
            f"measured peak {row['measured_peak_gb']} GB",
        )
    return {"rmsnorm": 0, "flash_attention": 0}


@contextmanager
def counted_collectives():
    """Every NCCL collective issued inside, as ``(name, bytes)``: the
    all-gathers (output bytes), reduce-scatters (input bytes), all-reduces
    and all-to-alls (the buffer's bytes) of ``models/spmd.py``."""
    calls: list[tuple[str, int]] = []
    real = (spmd._ALL_GATHER, spmd._REDUCE_SCATTER, dist.all_reduce)

    def gather(out, src, **kw):
        calls.append(("all_gather", out.nbytes))
        return real[0](out, src, **kw)

    def scatter(out, src, **kw):
        calls.append(("reduce_scatter", src.nbytes))
        return real[1](out, src, **kw)

    def reduce(t, *a, **kw):
        calls.append(("all_reduce", t.nbytes))
        return real[2](t, *a, **kw)

    spmd._ALL_GATHER, spmd._REDUCE_SCATTER, dist.all_reduce = gather, scatter, reduce
    try:
        yield calls
    finally:
        spmd._ALL_GATHER, spmd._REDUCE_SCATTER, dist.all_reduce = real


def _per_step(calls: list, steps: int) -> dict:
    out: dict = {}
    for name, nbytes in calls:
        row = out.setdefault(name, {"count": 0, "bytes": 0})
        row["count"] += 1
        row["bytes"] += nbytes
    return {k: {"count": v["count"] / steps, "bytes": v["bytes"] / steps}
            for k, v in out.items()}  # fmt: skip


@contextmanager
def forward_gathers(calls: list):
    """The all-gathers (entries of ``calls``, as :func:`counted_collectives`
    fills it) that each call of a group's block issues, in order.  Read
    from a step without remat, these are the forward's; under remat the
    recompute calls the blocks again."""
    per_block: list[int] = []
    real = model_module.block_apply

    def block(*a, path="", **kw):
        before = sum(name == "all_gather" for name, _ in calls)
        out = real(*a, path=path, **kw)
        if path.startswith("groups/"):
            per_block.append(sum(name == "all_gather" for name, _ in calls) - before)
        return out

    model_module.block_apply = block
    try:
        yield per_block
    finally:
        model_module.block_apply = real


def recomputed_gathers(cfg, per_block: list[int]) -> int:
    """The all-gathers a rematerialised step issues again, from the plain
    step's forward gathers of each block (:func:`forward_gathers`): each
    group's recompute runs its blocks but the last, each block's its
    own."""
    n, out = len(cfg.pattern), 0
    for i in range(0, len(per_block), n):
        group = per_block[i : i + n]
        out += sum(group) + sum(group[:-1])
    return out


def lm_mesh_run(
    dev, mesh, batches, prompt, gen_tokens, policy=ShardingPolicy()
) -> dict:
    """One run of lm_train_mesh's work: ``MESH_STEPS`` train steps of
    h2o-danube-3-4b from seed 0 (``mesh`` None: the mesh-less model) under
    ``policy``, the prefill of ``prompt`` and ``MESH_GEN`` decode steps of
    ``gen_tokens``; the losses, grad norms, step times, logits and final
    params to the host, the peak, the launches and the collectives of the
    train steps (and without remat each group's block's forward
    all-gathers); the device memory freed."""
    cfg = get_config(ZOO_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    model = Model(cfg, dev, opt_cfg=opt_cfg_for(cfg), mesh=mesh, policy=policy)
    state = model.init_train_state(0)
    lines, step_ms = [], []
    with counted_collectives() as calls, forward_gathers(calls) as per_block:
        for batch in batches:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            state, m = model.train_step(state, batch)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            lines.append((float(m["loss"]), float(m["grad_norm"])))
    train_launches = read_launches()
    params = state["params"]
    logits = []
    with torch.no_grad():
        if prompt is not None:  # None: the train steps alone
            b, s = prompt.shape
            last, pre = model.prefill_step(params, {"tokens": prompt})
            logits.append(last.float().cpu())
            caches = serve.load_prefill(model.init_caches(b, s + MESH_GEN), pre)
            del pre
            for i in range(MESH_GEN):
                step = {"tokens": gen_tokens[:, i : i + 1],
                        "pos": torch.full((b,), s + i, dtype=torch.int32, device=dev)}
                lg, caches = model.serve_step(params, caches, step)  # fmt: skip
                logits.append(lg.float().cpu())
            del caches
    torch.cuda.synchronize()
    out = {
        "lines": lines,
        "step_ms": step_ms,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "train_launches": train_launches,
        "launches": read_launches(),
        "collectives": _per_step(calls, len(batches)),
        "recomputed_gathers": recomputed_gathers(cfg, per_block) / len(batches),
        "logits": torch.stack(logits) if logits else None,
        "params": {k: v.detach().cpu() for k, v in flatten_tree(params).items()},
    }
    del model, state, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def flatten_tree(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def time_collectives(dev, mesh, cfg) -> dict:
    """CUDA-event times of one all-gather and one reduce-scatter over the
    one-rank mesh's data group at the largest FSDP block of the step (an
    FFN weight, ``[d_model, d_ff]`` bf16), each with its bytes and rate:
    at one rank each is a copy through NCCL."""
    w = torch.empty(cfg.d_model, cfg.d_ff, dtype=torch.bfloat16, device=dev)
    group = mesh.get_group("data")
    out = {}
    for name, fn in (("all_gather", spmd.all_gather), ("reduce_scatter", spmd.reduce_scatter)):
        ms = cuda_ms(lambda fn=fn: fn(w, group, 0), 10, 2)
        out[name] = {"bytes": w.nbytes, "ms": ms, "gb_per_s": w.nbytes / ms / 1e6}
    del w
    return out


def phase_lm_train_mesh(dev) -> dict[str, int]:
    """The zoo's sharded body on the card (the module docstring): the
    meshed run and the mesh-less run of :func:`lm_mesh_run`, one after the
    other, and ``launch.train``'s meshed body for 2 smoke steps."""
    t_phase = time.perf_counter()
    cfg = get_config(ZOO_ARCH)
    sc = TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, seed=0
    )
    stream = token_batches(sc)
    batches = []
    for _ in range(MESH_STEPS):
        raw = next(stream)
        batches.append({
            k: torch.tensor(raw[k] % cfg.vocab_size, device=dev)
            for k in ("tokens", "labels")
        })  # fmt: skip
    prompt = batches[0]["tokens"]
    rng = np.random.default_rng(1)
    gen_tokens = torch.tensor(
        rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, MESH_GEN)), device=dev
    )
    torch.cuda.set_device(dev.index or 0)
    with one_rank_device_mesh("cuda") as mesh:
        got = lm_mesh_run(dev, mesh, batches, prompt, gen_tokens)
        plain = lm_mesh_run(
            dev, mesh, batches, None, None, ShardingPolicy(remat=False)
        )
        want = lm_mesh_run(dev, None, batches, prompt, gen_tokens)
        smoke = "h2o-danube-3-4b-smoke"
        argv = ["--arch", smoke, "--steps", "2", "--batch", "2", "--seq", "64",
                "--device", str(dev)]  # fmt: skip
        reset_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train_cli.train_on_mesh(train_cli._parser().parse_args(argv), mesh)
        cli_launches = read_launches()
        cli_lines = buf.getvalue().splitlines()
        coll_ms = time_collectives(dev, mesh, cfg)
    cli_steps, _ = train_lines(cli_lines)
    rel = _max_rel(got["lines"], want["lines"])
    param_err, param_rel = _err_of_scale(got["params"], want["params"], dev)
    logits_err = float((got["logits"] - want["logits"]).abs().max())
    plain_rel = _max_rel(plain["lines"], want["lines"])
    _, plain_param_rel = _err_of_scale(plain["params"], want["params"], dev)
    n_attn = sum(mixer == ATTN for mixer, _ in cfg.layer_pattern)
    norms = norms_per_forward(cfg)
    serving_c = norms * (1 + MESH_GEN)
    want_c = serving_c + norms_per_train_forward(cfg) * MESH_STEPS
    plain_c = norms * MESH_STEPS  # its train steps alone
    gathers = {
        name: run["collectives"].get("all_gather", {}).get("count", 0)
        for name, run in (("remat", got), ("no_remat", plain))
    }
    extra_gathers = plain["recomputed_gathers"]
    emit(
        {
            "phase": "lm_train_mesh",
            "arch": ZOO_ARCH,
            "mesh": "DeviceMesh('cuda', (1, 1), ('data', 'model')), NCCL, one rank",
            "cuts": "none (full width and depth; random weights from seed 0)",
            "batch": TRAIN_BATCH,
            "seq": TRAIN_SEQ,
            "steps": MESH_STEPS,
            "mesh_lines": got["lines"],
            "meshless_lines": want["lines"],
            "loss_gnorm_max_rel_err": rel,
            "param_max_abs_err": param_err,
            "param_max_err_of_scale": param_rel,
            "logits_max_abs_err": logits_err,
            "tol": {"rel": MESH_REL, "param_of_scale": MESH_PARAM_TOL,
                    "logits": MESH_LOGITS_TOL},  # fmt: skip
            "step_ms": {"mesh": got["step_ms"], "meshless": want["step_ms"],
                        "mesh_no_remat": plain["step_ms"]},
            "peak_gb": {"mesh": got["peak_gb"], "meshless": want["peak_gb"],
                        "mesh_no_remat": plain["peak_gb"]},
            "collectives_per_step": got["collectives"],
            "collectives_per_step_no_remat": plain["collectives"],
            "all_gathers_per_step": gathers,
            "recomputed_gathers_per_step_predicted": extra_gathers,
            "mesh_no_remat": {"loss_gnorm_max_rel_err": plain_rel,
                              "param_max_err_of_scale": plain_param_rel},
            "collective_ms": coll_ms,
            "launches": {"mesh": got["launches"], "meshless": want["launches"],
                         "mesh_no_remat": plain["launches"]},
            "train_on_mesh": {"argv": argv, "rc": rc, "stdout": cli_lines,
                              "launches": cli_launches},  # fmt: skip
            "seconds": time.perf_counter() - t_phase,
        }
    )
    require(rel <= MESH_REL, f"lm_train_mesh: loss/grad norm off by {rel} relative")
    require(
        param_rel <= MESH_PARAM_TOL,
        f"lm_train_mesh: params off by {param_rel} of their scale",
    )
    require(logits_err <= MESH_LOGITS_TOL, f"lm_train_mesh: logits off by {logits_err}")
    require(
        plain_rel <= MESH_REL and plain_param_rel <= MESH_PARAM_TOL,
        f"lm_train_mesh without remat: off by {plain_rel} rel, {plain_param_rel} of "
        "scale",
    )
    require(got["collectives"], "lm_train_mesh: the sharded body issued no collective")
    require(
        extra_gathers > 0 and gathers["remat"] - gathers["no_remat"] == extra_gathers,
        f"lm_train_mesh: all-gathers a step {gathers}, want {extra_gathers} more "
        "with remat",
    )
    runs = ((got, want_c, n_attn), (want, want_c, n_attn), (plain, plain_c, 0))
    for run, c, d in runs:
        require(
            run["launches"]["rmsnorm"] == c and run["launches"]["flash_attention"] == d,
            f"lm_train_mesh: launches {run['launches']}, want C {c}, D {d}",
        )
    smoke_c = norms_per_train_forward(get_config(smoke)) * 2
    require(
        rc == 0
        and [i for i, _, _ in cli_steps] == [0, 1]
        and all(np.isfinite(loss) and g > 0 for _, loss, g in cli_steps)
        and cli_launches["rmsnorm"] == smoke_c,
        f"lm_train_mesh: train_on_mesh rc {rc}, lines {cli_lines}, {cli_launches}",
    )
    return {
        "rmsnorm": sum(r["launches"]["rmsnorm"] for r in (got, plain))
        + cli_launches["rmsnorm"],
        "flash_attention": sum(r["launches"]["flash_attention"] for r in (got, plain)),
    }


def _events():
    return [torch.cuda.Event(enable_timing=True) for _ in range(3)]


def _max_rel(got: list, want: list) -> float:
    return max(
        abs(a - b) / abs(b)
        for g, w in zip(got, want, strict=True)
        for a, b in zip(g, w, strict=True)
    )


def _err_of_scale(got: dict, want: dict, dev) -> tuple[float, float]:
    """(max |delta|, max |delta| over the leaf's largest |value|) over the
    leaves of two flat dicts of tensors."""
    err, rel = 0.0, 0.0
    for k, w in want.items():
        d = float((got[k].to(dev).float() - w.to(dev).float()).abs().max())
        scale = max(float(w.float().abs().max()), 1e-30)
        err, rel = max(err, d), max(rel, d / scale)
    return err, rel


def mixers_serve(dev, cfg, params, prompt, gen_tokens, mesh) -> dict:
    """A prefill of ``prompt`` and ``MIXERS_GEN`` decode steps of
    ``gen_tokens`` through ``Model(cfg, mesh=)`` (None: mesh-less) on
    ``params``: the logits to the host, the prefill's and a decode
    step's wall (CUDA events), the peak, the launches and the
    collectives of each."""
    model = Model(cfg, dev, mesh=mesh)
    b, s = prompt.shape
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    start, mid, end = _events()
    with torch.no_grad(), counted_collectives() as calls:
        start.record()
        last, pre = model.prefill_step(params, {"tokens": prompt})
        caches = model.load_prefill(model.init_caches(b, s + MIXERS_GEN), pre)
        mid.record()
        del pre
        n_prefill = len(calls)
        logits = [last.float()]
        for i in range(MIXERS_GEN):
            step = {"tokens": gen_tokens[:, i : i + 1],
                    "pos": torch.full((b,), s + i, dtype=torch.int32, device=dev)}
            lg, caches = model.serve_step(params, caches, step)  # fmt: skip
            logits.append(lg.float())
        end.record()
        end.synchronize()
    out = {
        "logits": torch.stack(logits).cpu(),
        "prefill_ms": start.elapsed_time(mid),
        "decode_ms": mid.elapsed_time(end) / MIXERS_GEN,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": read_launches(),
        "collectives": {"prefill": _per_step(calls[:n_prefill], 1),
                        "decode_step": _per_step(calls[n_prefill:], MIXERS_GEN)},
    }  # fmt: skip
    del model, caches
    return out


def mixers_train(dev, cfg, mesh, batches) -> dict:
    """The train steps of ``batches`` from seed 0 through ``Model(cfg,
    mesh=)`` (None: mesh-less): losses, grad norms, step walls, the peak,
    the launches, the collectives a step and the final params on the
    host; the device memory freed."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, dev, opt_cfg=opt_cfg_for(cfg), mesh=mesh)
    state = model.init_train_state(0)
    reset_launches()
    lines, step_ms = [], []
    with counted_collectives() as calls:
        for batch in batches:
            start, end, _ = _events()
            start.record()
            state, m = model.train_step(state, batch)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            lines.append((float(m["loss"]), float(m["grad_norm"])))
    out = {
        "lines": lines,
        "step_ms": step_ms,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": read_launches(),
        "collectives": _per_step(calls, len(batches)),
        "params": {
            k: v.detach().cpu() for k, v in flatten_tree(state["params"]).items()
        },
    }
    del model, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mamba_block_run(dev, cfg, p, x, g, mesh) -> dict:
    """jamba's (mamba, dense) block at full width, forward and backward of
    ``(y * g).sum()``, through ``block_apply`` (on ``mesh`` with its
    layout: every collective of the Mamba and FFN regions over groups of
    one): the output, the gradients of the input and of every leaf, the
    wall (CUDA events), the launches and the collectives."""
    j = cfg.pattern.index((MAMBA, FFN_DENSE))
    b, s, _ = x.shape
    layout = None
    if mesh is not None:
        specs = param_specs(cfg, mesh_axes(mesh))
        layout = make_layout(mesh, ShardingPolicy(), specs, batch=b, seq_len=s,
                             mode="train")  # fmt: skip
    names = list(flatten_tree(p))
    live = {k: v.detach().requires_grad_(True) for k, v in flatten_tree(p).items()}
    tree: dict = {}
    for k, v in live.items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    xi = x.detach().requires_grad_(True)
    positions = positions_for(cfg, b, s, device=dev)
    reset_launches()
    start, end, _ = _events()
    with counted_collectives() as calls:
        start.record()
        y, _, _ = block_apply(
            cfg, tree, xi, mixer=MAMBA, ffn=FFN_DENSE, mode="train",
            positions=positions, attn_impl="chunked", layout=layout, path=f"groups/b{j}",
        )  # fmt: skip
        grads = torch.autograd.grad((y.float() * g.float()).sum(), [xi, *live.values()])
        end.record()
        end.synchronize()
    return {
        "y": y.detach(),
        "grads": dict(zip(["x", *names], grads, strict=True)),
        "ms": start.elapsed_time(end),
        "launches": read_launches(),
        "collectives": _per_step(calls, 1),
    }


def phase_lm_mixers_mesh(dev) -> dict[str, int]:
    """MLA, Mamba, mLSTM and sLSTM on a one-rank NCCL mesh against the
    mesh-less model (the module docstring): per config a JSON line with
    the serving and training (or jamba's block) comparisons; returns the
    meshed runs' launches."""
    t_phase = time.perf_counter()
    torch.cuda.set_device(dev.index or 0)
    rng = np.random.default_rng(2)
    launched = {"rmsnorm": 0, "flash_attention": 0}
    failures = []
    with one_rank_device_mesh("cuda") as mesh:
        for arch, (serving, training) in MIXERS.items():
            t_arch = time.perf_counter()
            n_layers, b, s = serving
            model, params, prompt = serve.setup(arch, b, s, 0, dev, n_layers=n_layers)
            cfg = model.cfg
            del model
            gen_tokens = torch.tensor(
                rng.integers(0, cfg.vocab_size, (b, MIXERS_GEN)), device=dev
            )
            want = mixers_serve(dev, cfg, params, prompt, gen_tokens, None)
            got = mixers_serve(dev, cfg, params, prompt, gen_tokens, mesh)
            del params, prompt
            gc.collect()
            torch.cuda.empty_cache()
            n_attn = sum(mixer == ATTN for mixer, _ in cfg.layer_pattern)
            want_c = norms_per_forward(cfg) * (1 + MIXERS_GEN)
            logits_err = float((got["logits"] - want["logits"]).abs().max())
            row = {
                "phase": "lm_mixers_mesh",
                "arch": arch,
                "mesh": "DeviceMesh('cuda', (1, 1), ('data', 'model')), NCCL, one rank",
                "serve": {
                    "layers": cfg.n_layers, "batch": b, "prompt": s, "gen": MIXERS_GEN,
                    "logits_max_abs_err": logits_err,
                    "prefill_ms": {"mesh": got["prefill_ms"], "meshless": want["prefill_ms"]},
                    "decode_step_ms": {"mesh": got["decode_ms"], "meshless": want["decode_ms"]},
                    "peak_gb": {"mesh": got["peak_gb"], "meshless": want["peak_gb"]},
                    "collectives": got["collectives"],
                    "launches": {"mesh": got["launches"], "meshless": want["launches"]},
                },
            }  # fmt: skip
            if logits_err > MESH_LOGITS_TOL:
                failures.append(f"{arch}: serving logits off by {logits_err}")
            for run in (got, want):
                if (run["launches"]["rmsnorm"], run["launches"]["flash_attention"]) != (
                    want_c, n_attn
                ):
                    failures.append(f"{arch}: serving launches {run['launches']}, "
                                    f"want C {want_c}, D {n_attn}")  # fmt: skip
            for k in launched:
                launched[k] += got["launches"][k]
            if training is not None:
                depth, tb, ts = training
                tcfg = get_config(arch)
                if depth is not None:
                    tcfg = serve.cut_depth(tcfg, depth)
                sc = TokenStreamConfig(
                    vocab_size=tcfg.vocab_size, seq_len=ts, batch_size=tb, seed=0
                )
                stream = token_batches(sc)
                batches = []
                for _ in range(MESH_STEPS):
                    raw = next(stream)
                    batches.append({
                        k: torch.tensor(raw[k] % tcfg.vocab_size, device=dev)
                        for k in ("tokens", "labels")
                    })  # fmt: skip
                tg = mixers_train(dev, tcfg, mesh, batches)
                tw = mixers_train(dev, tcfg, None, batches)
                rel = _max_rel(tg["lines"], tw["lines"])
                err, of_scale = _err_of_scale(tg["params"], tw["params"], dev)
                want_c = norms_per_train_forward(tcfg) * MESH_STEPS
                row["train"] = {
                    "layers": tcfg.n_layers, "batch": tb, "seq": ts, "steps": MESH_STEPS,
                    "mesh_lines": tg["lines"], "meshless_lines": tw["lines"],
                    "loss_gnorm_max_rel_err": rel,
                    "param_max_abs_err": err, "param_max_err_of_scale": of_scale,
                    "step_ms": {"mesh": tg["step_ms"], "meshless": tw["step_ms"]},
                    "peak_gb": {"mesh": tg["peak_gb"], "meshless": tw["peak_gb"]},
                    "collectives_per_step": tg["collectives"],
                    "launches": {"mesh": tg["launches"], "meshless": tw["launches"]},
                }  # fmt: skip
                if rel > MESH_REL or of_scale > MESH_PARAM_TOL:
                    failures.append(
                        f"{arch}: train off by {rel} rel, {of_scale} of scale"
                    )
                for run in (tg, tw):
                    if run["launches"]["rmsnorm"] != want_c:
                        failures.append(f"{arch}: train launches {run['launches']}, "
                                        f"want C {want_c}")  # fmt: skip
                for k in launched:
                    launched[k] += tg["launches"][k]
                del tg, tw, batches
            else:
                gen = torch.Generator(device=dev).manual_seed(0)
                p = block_init(cfg, MAMBA, FFN_DENSE, gen)
                bb, bs = MAMBA_BLOCK
                x, g = (
                    torch.randn(bb, bs, cfg.d_model, generator=gen, device=dev).to(
                        torch_dtype(cfg.dtype)
                    )
                    for _ in range(2)
                )
                bw = mamba_block_run(dev, cfg, p, x, g, None)
                bg = mamba_block_run(dev, cfg, p, x, g, mesh)
                y_err, y_rel = _err_of_scale({"y": bg["y"]}, {"y": bw["y"]}, dev)
                g_err, g_rel = _err_of_scale(bg["grads"], bw["grads"], dev)
                row["mamba_block"] = {
                    "block": "(mamba, dense)", "batch": bb, "seq": bs,
                    "y_max_abs_err": y_err, "y_max_err_of_scale": y_rel,
                    "grad_max_abs_err": g_err, "grad_max_err_of_scale": g_rel,
                    "fwd_bwd_ms": {"mesh": bg["ms"], "meshless": bw["ms"]},
                    "collectives": bg["collectives"],
                    "launches": {"mesh": bg["launches"], "meshless": bw["launches"]},
                }  # fmt: skip
                if max(y_rel, g_rel) > MESH_PARAM_TOL:
                    failures.append(
                        f"{arch}: mamba block off by {y_rel}, {g_rel} of scale"
                    )
                for run in (bg, bw):
                    if run["launches"]["rmsnorm"] != 2:
                        failures.append(f"{arch}: block launches {run['launches']}")
                for k in launched:
                    launched[k] += bg["launches"][k]
                del p, x, g, bw, bg
            row["seconds"] = time.perf_counter() - t_arch
            emit(row)
            gc.collect()
            torch.cuda.empty_cache()
    emit({"phase": "lm_mixers_mesh", "seconds": time.perf_counter() - t_phase,
          "launches": launched, "failures": failures})  # fmt: skip
    require(not failures, f"lm_mixers_mesh: {failures}")
    require(launched["rmsnorm"] > 0 and launched["flash_attention"] > 0,
            f"lm_mixers_mesh: launches {launched}")  # fmt: skip
    return launched


def main() -> int:
    t_start = time.perf_counter()
    kind, smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    results = {
        "replay_gather": check_replay_gather(dev),
        "fused_td": check_fused_td(dev),
    }
    phase_chunk(dev)
    main = phase_main(dev)
    main_ref = main.pop("reference")
    by_path = {"main": {k: main["launches"][k] for k in FLEET_KERNELS}}
    by_path.update(phase_baselines(dev))
    by_path["sweep"] = phase_sweep(dev)
    by_path["topology"] = phase_topology(dev)
    fleet = {k: v for k, v in main.items() if k != "launches"}
    by_path["stepwise"] = phase_stepwise(dev, fleet)
    phase_main_card_vs_cpu(dev)
    by_path["population"] = phase_population(dev)
    by_path["serve"], serve_ref = phase_serve(dev)
    by_path["fleet_mesh"] = phase_fleet_mesh(dev, main_ref, serve_ref)
    by_path["table2_sweep"] = phase_sweep(dev, "paper_table2_hub_failure")
    by_path["observatory"] = phase_observatory(dev)
    by_path["cli"] = phase_cli(dev)
    results["rmsnorm"] = check_rmsnorm(dev)
    results["flash_attention"] = check_flash_attention(dev)
    results["kda_step"] = check_kda_step(dev)
    results["kda_chunk"] = check_kda_chunk(dev)
    results["mhc"] = check_mhc(dev)
    phase_zoo_chunk(dev)
    # the zoo's paths, C and D launches read around each alone
    measured: dict = {}  # peaks and step times the planner is set beside
    zoo_paths = {"lm_train_chunk": phase_lm_train_chunk(dev)}
    zoo_paths["lm_train_main"] = phase_lm_train_main(dev, measured)
    zoo_paths["lm_train_remat"] = phase_lm_train_remat(dev)
    by_route = None
    for arch in ZOO_ARCHS:
        zoo_paths[f"zoo_main:{arch}"], routes = phase_zoo_main(dev, arch, measured)
        by_route = by_route or routes  # danube's: the zoo's reference path
    zoo_paths[f"zoo_main:{KIMI_ARCH}"] = phase_kimi_main(dev)
    zoo_paths[f"zoo_main:{XING_ARCH}"] = phase_xing_main(dev)
    zoo_paths["zoo_window"] = phase_zoo_window(dev)
    zoo_paths["moe_ep"] = phase_moe_ep(dev)
    zoo_paths["lm_train_mesh"] = phase_lm_train_mesh(dev)
    zoo_paths["lm_mixers_mesh"] = phase_lm_mixers_mesh(dev)
    by_path["examples"], zoo_paths["examples"] = phase_examples(dev)
    zoo_paths["planner"] = phase_planner(dev, measured)
    by_path["planner"] = {k: 0 for k in FLEET_KERNELS}
    launches = {k: sum(p[k] for p in by_path.values()) for k in FLEET_KERNELS}
    for name in ("rmsnorm", "flash_attention", "kda_step", "kda_chunk", "mhc"):
        launches[name] = sum(p.get(name, 0) for p in zoo_paths.values())
        results[name]["launches_by_path"] = {
            p: n.get(name, 0) for p, n in zoo_paths.items()
        }
    meta = {
        "replay_gather": (
            "src/repro_torch/csrc/replay_gather.cu",
            "src/repro/kernels/replay_gather/kernel.py:31",
        ),
        "fused_td": (
            "src/repro_torch/csrc/fused_td.cu",
            "src/repro/kernels/fused_td/kernel.py:38",
        ),
        "rmsnorm": (
            "src/repro_torch/csrc/rmsnorm.cu",
            "src/repro/kernels/rmsnorm/kernel.py:27",
        ),
        "flash_attention": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:106",
        ),
        "kda_step": ("src/repro_torch/csrc/kda_step.cu", "none: new in the port"),
        "kda_chunk": ("src/repro_torch/csrc/kda_chunk.cu", "none: new in the port"),
        "mhc": ("src/repro_torch/csrc/mhc.cu", "none: new in the port"),
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r.get("bound_by", "bytes"),
            "library_ms": r["library_ms"],
            "device_ms": r["device_ms"],
            "library_device_ms": r["library_device_ms"],
            "floor_ms": r["floor_ms"],
            "shape": r["shape"],
            "check": "pass",
            **({"kernel_route": r["route"]} if "route" in r else {}),
            **{k: r[k] for k in EXTRA_FIELDS if k in r},
        }
        for name, r in results.items()
    ]
    for entry in kernels:
        if entry["name"] in by_route:
            entry["launches_by_route"] = by_route[entry["name"]]
        if entry["name"] in FLEET_KERNELS:
            name = entry["name"]
            entry["launches_by_path"] = {p: n[name] for p, n in by_path.items()}
    emit({"phase": "wall", "seconds": time.perf_counter() - t_start})
    print(smi)
    emit({"kernels": kernels})
    device = {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
