"""Config system of the model zoo: architecture configs, the input
shapes the planner sizes, the registry and the analytic parameter
count.

A copy of the reference's ``repro/configs/base.py`` (the port imports
nothing of ``repro``).  Every architecture gets a module in
``repro_torch/configs/<id>.py`` that builds a :class:`ModelConfig` with
the published hyper-parameters and registers it under its id.
``reduced()`` derives the CPU-smoke variant (2 layers, d_model<=512,
<=4 experts) from the same config, so the CPU tests run the code path of
the full-width run.  The port registers every architecture the
reference assigns (:data:`ASSIGNED`), and the port's own
(:data:`PORT_ONLY`: Kimi-Linear, ``configs/kimi_linear.py``, and
Xing4.0, ``configs/xing4.py``), which need fields the reference's config
lacks: a dense prefix whose mixer is not attention (``prefix_mixer``),
unrolled layers after the groups (``suffix``), the KDA mixer (``kda``), a
sigmoid router and a held share of the experts (``MoEConfig.router``,
``routed_scale``, ``n_held``, ``held_offset``), MLA's latent norms
(``MLAConfig.latent_norms``) and the manifold-constrained
hyper-connection residual (``hc_mult``; ``models/hyper.py``).  Each
defaults to what the reference's configs run.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

# ---------------------------------------------------------------------------
# Block kinds
# ---------------------------------------------------------------------------
ATTN = "attn"  # (GQA / MHA) attention mixer
MLA = "mla"  # DeepSeek multi-head latent attention mixer
MAMBA = "mamba"  # Mamba-1 selective SSM mixer
SLSTM = "slstm"  # xLSTM sLSTM block (scalar memory, strictly recurrent)
MLSTM = "mlstm"  # xLSTM mLSTM block (matrix memory, parallelizable)
KDA = "kda"  # Kimi Delta Attention (gated delta rule, per-channel decay)

FFN_DENSE = "dense"
FFN_MOE = "moe"
FFN_NONE = "none"


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0  # routed experts
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_jitter: float = 0.0
    # --- the port's own (defaults: the reference's softmax router, every
    # expert held) -------------------------------------------------------------
    router: str = "softmax"  # softmax | sigmoid (DeepSeek-V3's, with a selection bias)
    routed_scale: float = 1.0  # the sigmoid router's gates are scaled by it
    n_held: int = 0  # experts held here, 0 => all n_experts (one card's share)
    held_offset: int = 0  # the first expert held

    @property
    def held(self) -> int:
        return self.n_held or self.n_experts


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0 => direct q projection (DeepSeek-V2-Lite)
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    # the port's own: an RMSNorm on the q latent (after ``w_dq``, where
    # there is one) and on the kv latent (after ``w_dkv``, before the
    # cache), DeepSeek-V3's q_a_layernorm and kv_a_layernorm
    latent_norms: bool = False


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 => ceil(d_model / 16)
    chunk: int = 64  # remat chunk for the selective scan


@dataclass(frozen=True)
class XLSTMConfig:
    # mLSTM: matrix-memory heads, projection factor for the up projection.
    mlstm_proj_factor: float = 2.0
    # sLSTM: post-block gated FFN factor (xLSTM paper uses 4/3 * d).
    slstm_ffn_factor: float = 4.0 / 3.0
    conv_width: int = 4
    chunk: int = 64


@dataclass(frozen=True)
class KDAConfig:
    """Kimi Delta Attention (``models/kda.py``): ``n_heads`` heads of
    ``head_dim`` keys and values, short causal convolutions of
    ``conv_width``, low-rank decay and output-gate projections of
    ``gate_rank``, the prefill's chunk of ``chunk`` tokens."""

    n_heads: int = 32
    head_dim: int = 128
    conv_width: int = 4
    gate_rank: int = 128
    chunk: int = 64


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 => d_model // n_heads
    # --- block layout -----------------------------------------------------
    # Repeating pattern of (mixer, ffn) kinds. The pattern tiles over
    # n_layers - first_k_dense; the first first_k_dense layers are unrolled
    # (attn + dense FFN), DeepSeek style.
    pattern: tuple[tuple[str, str], ...] = ((ATTN, FFN_DENSE),)
    first_k_dense: int = 0
    first_k_dense_d_ff: int = 0
    # the port's own: the dense prefix's mixer, and layers unrolled after
    # the groups (a layer list that does not tile, Kimi-Linear's)
    prefix_mixer: str = ATTN
    suffix: tuple[tuple[str, str], ...] = ()
    # --- attention ---------------------------------------------------------
    qkv_bias: bool = False
    sliding_window: int | None = None
    rope: str = "rope"  # rope | mrope | none
    rope_theta: float = 10_000.0
    attn_logit_softcap: float = 0.0
    # --- sub-configs --------------------------------------------------------
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: MLAConfig | None = None
    ssm: SSMConfig = field(default_factory=SSMConfig)
    xlstm: XLSTMConfig = field(default_factory=XLSTMConfig)
    kda: KDAConfig | None = None
    # --- the port's own: manifold-constrained hyper-connections (mHC,
    # ``models/hyper.py``): ``hc_mult`` residual streams around every
    # sublayer, 0 => today's single stream ------------------------------------
    hc_mult: int = 0
    # --- io ------------------------------------------------------------------
    # "tokens": int32 token ids; "embeds": precomputed frontend embeddings
    # (audio codec frames / vision patches) — the one allowed stub.
    input_kind: str = "tokens"
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # t,h,w splits of head_dim/2
    # --- misc ----------------------------------------------------------------
    mlp_variant: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # Sub-quadratic decode path exists (SSM / hybrid / sliding window)?
    subquadratic: bool = False
    # citation for the config numbers
    source: str = ""

    # -- derived -------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def layer_pattern(self) -> tuple[tuple[str, str], ...]:
        """Full per-layer (mixer, ffn) list: prefix + tiled pattern +
        suffix."""
        body = self.n_layers - self.first_k_dense - len(self.suffix)
        p = len(self.pattern)
        if body % p != 0:
            raise ValueError(f"{self.name}: pattern period {p} !| {body}")
        prefix = ((self.prefix_mixer, FFN_DENSE),) * self.first_k_dense
        return prefix + self.pattern * (body // p) + self.suffix

    @property
    def n_groups(self) -> int:
        return (self.n_layers - self.first_k_dense - len(self.suffix)) // len(
            self.pattern
        )

    def reduced(self) -> "ModelConfig":
        """CPU smoke variant of the same family: 2 pattern periods,
        d_model<=512, <=4 experts, short rope."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        moe = self.moe
        if moe.n_experts:
            moe = replace(
                moe,
                n_experts=min(4, moe.n_experts),
                top_k=min(2, moe.top_k),
                n_shared_experts=min(1, moe.n_shared_experts),
                d_ff_expert=min(128, moe.d_ff_expert),
            )
        if moe.n_held:  # a held share keeps one: 4 of 8 experts
            moe = replace(moe, n_experts=8, n_held=4, held_offset=0)
        kda = self.kda
        if kda is not None:
            kda = replace(kda, n_heads=min(kda.n_heads, 2), head_dim=32, gate_rank=16)
        mla = self.mla
        if mla is not None:
            mla = replace(
                mla,
                kv_lora_rank=64,
                rope_head_dim=16,
                nope_head_dim=32,
                v_head_dim=32,
                q_lora_rank=(32 if mla.q_lora_rank else 0),
            )
        # compress long patterns (e.g. jamba's 8-layer period) to the unique
        # (mixer, ffn) combos so the smoke variant stays <=4 layers while
        # still exercising every block kind of the family
        pattern = tuple(dict.fromkeys(self.pattern))[:4]
        suffix = tuple(dict.fromkeys(self.suffix))
        n_layers = (
            self.first_k_dense + len(pattern) * max(1, 2 // len(pattern)) + len(suffix)
        )
        return replace(
            self,
            name=self.name + "-smoke",
            pattern=pattern,
            suffix=suffix,
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            first_k_dense_d_ff=min(self.first_k_dense_d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            head_dim=(d_model // n_heads),
            sliding_window=(64 if self.sliding_window else None),
            moe=moe,
            mla=mla,
            kda=kda,
            ssm=replace(self.ssm, d_state=8, chunk=16),
            mrope_sections=tuple(
                s * (d_model // n_heads) // self.resolved_head_dim or 1
                for s in self.mrope_sections
            ),
            dtype="float32",
        )


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"unknown config {name!r}")


def list_configs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_LOADED = False

# the reference's assigned architectures, all registered
ASSIGNED = (
    "h2o-danube-3-4b",
    "jamba-1.5-large-398b",
    "xlstm-125m",
    "musicgen-medium",
    "qwen2.5-14b",
    "moonshot-v1-16b-a3b",
    "deepseek-v2-lite-16b",
    "qwen3-moe-235b-a22b",
    "starcoder2-15b",
    "qwen2-vl-2b",
)
# the port's own architectures (no copy of the reference's; kept out of
# ASSIGNED, which is the reference's list)
PORT_ONLY = (
    "kimi-linear-48b-a3b",
    "kimi-linear-48b-a3b-ep4",
    "xing4.0-29b-a4b",
    "xing4.0-29b-a4b-ep4",
)


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    import importlib

    for mod in (
        "h2o_danube3",
        "jamba15_large",
        "xlstm125m",
        "musicgen_medium",
        "qwen25_14b",
        "moonshot_16b",
        "deepseek_v2_lite",
        "qwen3_moe_235b",
        "starcoder2_15b",
        "qwen2_vl_2b",
        "kimi_linear",
        "xing4",
    ):
        importlib.import_module(f"repro_torch.configs.{mod}")


def refuse_unplanned(cfg: ModelConfig, what: str) -> None:
    """Raise for a config that ``what`` (the mesh paths, the planner) does
    not support yet: a KDA mixer, a held share of the experts (one
    card's expert-parallel slice, which the mesh paths would split
    again), or the mHC residual (``hc_mult > 0``: its stream of
    ``hc_mult`` rows has no sharded layout)."""
    if any(m == KDA for m, _ in cfg.layer_pattern) or cfg.moe.n_held or cfg.hc_mult:
        raise NotImplementedError(
            f"{what} does not support {cfg.name}: the KDA mixer, a held "
            "share of the experts and the mHC residual run on one card only "
            "(Model without a mesh)"
        )


def hc_site_params(cfg: ModelConfig) -> int:
    """One mHC site's parameters (``models/hyper.py``): the projection
    ``phi`` [n d, 2n + n^2], its bias, the three group scales and the
    norm over ``n d``; 0 without mHC."""
    n = cfg.hc_mult
    if not n:
        return 0
    cols = 2 * n + n * n
    return n * cfg.d_model * cols + cols + 3 + n * cfg.d_model


def param_count(cfg: ModelConfig) -> tuple[int, int]:
    """(total params, active params per token) — analytic, for roofline.
    A held share counts the experts held here; MLA's latent norms and
    each mHC site (``hc_site_params``) count with their sublayer."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    total = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    active = total
    for mixer, ffn in cfg.layer_pattern:
        if mixer == ATTN:
            m = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
        elif mixer == MLA:
            a = cfg.mla
            q_dim = a.nope_head_dim + a.rope_head_dim
            m = (
                d * (a.q_lora_rank or 0)
                + (a.q_lora_rank or d) * cfg.n_heads * q_dim
                + d * (a.kv_lora_rank + a.rope_head_dim)
                + a.kv_lora_rank * cfg.n_heads * (a.nope_head_dim + a.v_head_dim)
                + cfg.n_heads * a.v_head_dim * d
                + (a.q_lora_rank + a.kv_lora_rank if a.latent_norms else 0)
            )
        elif mixer == MAMBA:
            di = cfg.ssm.expand * d
            dtr = cfg.ssm.dt_rank or -(-d // 16)
            m = (
                d * 2 * di
                + di * cfg.ssm.d_conv
                + di * (dtr + 2 * cfg.ssm.d_state)
                + dtr * di
                + di * cfg.ssm.d_state
                + di
                + di * d
            )
        elif mixer == MLSTM:
            di = int(cfg.xlstm.mlstm_proj_factor * d)
            m = d * 2 * di + di * cfg.xlstm.conv_width + 3 * di * di + 3 * di + di * d
        elif mixer == SLSTM:
            dff = int(cfg.xlstm.slstm_ffn_factor * d)
            m = 4 * d * d + 4 * d + 2 * d * dff
        elif mixer == KDA:
            k = cfg.kda
            hk, r = k.n_heads * k.head_dim, k.gate_rank
            m = (
                3 * d * hk  # q, k, v
                + 3 * k.conv_width * hk  # their short convolutions
                + d * r + r * hk + hk  # the decay's low rank and dt_bias
                + d * k.n_heads + k.n_heads  # beta, A_log
                + d * r + r * hk + hk  # the output gate and its bias
                + k.head_dim  # the gated norm's scale
                + hk * d  # out
            )
        else:
            raise ValueError(mixer)
        m += hc_site_params(cfg) * (1 if ffn == FFN_NONE else 2)
        total += m
        active += m
        if ffn == FFN_DENSE:
            f = 3 * d * cfg.d_ff if cfg.mlp_variant == "swiglu" else 2 * d * cfg.d_ff
            total += f
            active += f
        elif ffn == FFN_MOE:
            fe = 3 * d * cfg.moe.d_ff_expert
            total += (
                fe * (cfg.moe.held + cfg.moe.n_shared_experts)
                + d * cfg.moe.n_experts
            )
            active += (
                fe * (cfg.moe.top_k + cfg.moe.n_shared_experts)
                + d * cfg.moe.n_experts
            )
    return total, active
