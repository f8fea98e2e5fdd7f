"""Config system of the port: model/arch configs, input shapes, and the
registry (a copy of the reference's, field for field).

Every assigned architecture has a module ``repro_torch/configs/<id>.py``
that builds a :class:`ModelConfig` with the exact dimensions from its
source paper/model card, plus a ``REDUCED`` variant used by CPU smoke
tests. The paper models' :class:`PaperModelConfig` lives here too.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Sequence

__all__ = [
    "ARCH_IDS", "INPUT_SHAPES", "PAPER_IDS", "InputShape", "ModelConfig",
    "MoEConfig", "PaperModelConfig", "active_param_count", "get_config",
    "get_reduced_config", "param_count", "reduce_config",
]

# ---------------------------------------------------------------------------
# Input shapes (assigned; fixed across architectures)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    """One assigned input shape: sequence length, global batch, kind."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts widths, routing and capacity."""
    num_experts: int = 0           # routed experts
    num_shared_experts: int = 0    # always-on experts (DeepSeek-MoE)
    top_k: int = 0
    expert_d_ff: int = 0           # per-expert FFN width (fine-grained MoE)
    router_aux_weight: float = 0.01
    capacity_factor: float = 1.25  # tokens over capacity are dropped
    renormalize: bool = True       # top-k gates divided by their sum


@dataclass(frozen=True)
class ModelConfig:
    """One architecture's dimensions and structural features."""
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # attention features
    rope_theta: float = 10_000.0
    use_qk_norm: bool = False
    use_qkv_bias: bool = False
    use_mrope: bool = False        # multimodal rotary (Qwen2-VL)
    sliding_window: int = 0        # 0 = full attention; >0 = SWA window
    # norm / act
    norm_eps: float = 1e-6
    use_rmsnorm: bool = True
    tie_embeddings: bool = False
    # MoE
    moe: MoEConfig = field(default_factory=MoEConfig)
    moe_layer_period: int = 1      # every n-th layer is MoE (1 = all, when moe on)
    first_dense_layers: int = 0    # leading layers with a dense FFN (DeepSeek's
                                   # first_k_dense_replace), before the pattern
    # hybrid (Jamba): 1 attention layer per `attn_period` layers, rest Mamba
    attn_period: int = 0           # 0 = pure attention (or pure ssm for rwkv)
    # ssm dims
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    rwkv_head_dim: int = 64
    # encoder-decoder (Whisper)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq_len: int = 0       # e.g. 1500 audio frames
    max_decoder_len: int = 0       # architecture-native decoder context (0 = unlimited)
    # modality frontend stub: inputs arrive as precomputed embeddings
    embedding_inputs: bool = False
    citation: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_kinds(self) -> list[str]:
        """Per-layer kind sequence: 'attn' | 'mamba' for the mixer."""
        if self.family == "ssm":
            return ["rwkv"] * self.num_layers
        if self.attn_period and self.attn_period > 1:
            # Jamba: one attention layer per attn_period, at position
            # (attn_period//2) within each block (matches Jamba's 1:7).
            kinds = []
            for i in range(self.num_layers):
                kinds.append("attn" if i % self.attn_period == self.attn_period // 2
                             else "mamba")
            return kinds
        return ["attn"] * self.num_layers

    def moe_layer_mask(self) -> list[bool]:
        """Per-layer flag: is the layer's FFN a mixture of experts (never
        in the ``first_dense_layers`` leading layers)."""
        if self.moe.num_experts == 0:
            return [False] * self.num_layers
        p = max(self.moe_layer_period, 1)
        return [i >= self.first_dense_layers
                and ((i % p == p - 1) if p > 1 else True)
                for i in range(self.num_layers)]

    def supports_long_decode(self) -> bool:
        """long_500k policy (DESIGN.md §5): native for ssm/hybrid, via SWA for
        decoder-only attention archs, skipped for enc-dec (whisper)."""
        if self.is_encoder_decoder:
            return False
        return True

    def replace(self, **kw) -> "ModelConfig":
        """A copy with the given fields replaced."""
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Paper-scale model configs (MCLR / CNN / DNN from the PerMFL experiments)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PaperModelConfig:
    """One of the paper's models (MCLR, CNN, DNN)."""
    name: str
    kind: str                      # "mclr" | "cnn" | "dnn"
    input_shape: tuple             # e.g. (784,) or (28, 28, 1) or (60,)
    num_classes: int = 10
    hidden: Sequence[int] = ()     # dnn hidden widths
    conv_channels: Sequence[int] = ()  # cnn channels
    l2_reg: float = 0.0            # strongly-convex regularizer for MCLR
    convex: bool = False


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ARCH_IDS: list[str] = [
    "phi3-mini-3.8b",
    "qwen2-vl-2b",
    "qwen1.5-32b",
    "deepseek-moe-16b",
    "whisper-small",
    "qwen3-14b",
    "dbrx-132b",
    "jamba-1.5-large-398b",
    "yi-34b",
    "rwkv6-7b",
]

_MODULE_FOR_ARCH = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
                    for a in ARCH_IDS}
# paper-scale configs used by the faithful reproduction
PAPER_IDS = ["paper-mclr", "paper-cnn", "paper-dnn"]
_MODULE_FOR_ARCH.update({a: "repro_torch.configs." + a.replace("-", "_") for a in PAPER_IDS})


def get_config(arch: str) -> ModelConfig:
    """The registered config of ``arch`` (an ARCH_IDS or PAPER_IDS id)."""
    if arch not in _MODULE_FOR_ARCH:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULE_FOR_ARCH)}")
    mod = importlib.import_module(_MODULE_FOR_ARCH[arch])
    return mod.CONFIG


def get_reduced_config(arch: str) -> ModelConfig:
    """Smoke-test variant: ≤2 layers, d_model ≤ 512, ≤4 experts."""
    mod = importlib.import_module(_MODULE_FOR_ARCH[arch])
    if hasattr(mod, "REDUCED"):
        return mod.REDUCED
    return reduce_config(mod.CONFIG)


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Generic reducer preserving the family's structural features."""
    heads = min(cfg.num_heads, 4)
    kv = max(1, min(cfg.num_kv_heads, heads))
    # keep GQA ratio if it was grouped
    if cfg.num_kv_heads < cfg.num_heads:
        kv = max(1, heads // max(1, cfg.num_heads // cfg.num_kv_heads))
    d_model = min(cfg.d_model, 256)
    hd = max(32, d_model // heads)
    moe = cfg.moe
    if moe.num_experts:
        moe = dataclasses.replace(
            moe, num_experts=min(moe.num_experts, 4),
            num_shared_experts=min(moe.num_shared_experts, 1),
            top_k=min(moe.top_k, 2),
            expert_d_ff=min(moe.expert_d_ff or 128, 128))
    return cfg.replace(
        num_layers=2 if not cfg.attn_period else min(cfg.num_layers, cfg.attn_period),
        d_model=d_model, num_heads=heads, num_kv_heads=kv, head_dim=hd,
        d_ff=min(cfg.d_ff, 512), vocab_size=min(cfg.vocab_size, 512),
        moe=moe, encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq_len=min(cfg.encoder_seq_len, 64) if cfg.encoder_seq_len else 0,
        attn_period=min(cfg.attn_period, 2) if cfg.attn_period else 0,
    )


def param_count(cfg: ModelConfig) -> int:
    """Analytic parameter count (used for 6ND model FLOPs)."""
    d, v = cfg.d_model, cfg.vocab_size
    hd = cfg.resolved_head_dim
    n_q, n_kv = cfg.num_heads, cfg.num_kv_heads
    total = v * d  # embed
    if not cfg.tie_embeddings:
        total += v * d  # lm head
    kinds = cfg.layer_kinds()
    moe_mask = cfg.moe_layer_mask()
    for kind, is_moe in zip(kinds, moe_mask):
        if kind == "attn":
            attn = d * n_q * hd + 2 * d * n_kv * hd + n_q * hd * d
            if cfg.use_qkv_bias:
                attn += (n_q + 2 * n_kv) * hd
            total += attn
        elif kind == "mamba":
            d_in = cfg.mamba_expand * d
            total += (2 * d * d_in            # in_proj (x, z)
                      + d_in * cfg.mamba_d_conv
                      + d_in * (2 * cfg.mamba_d_state + d_in // 16 + 1)
                      + d_in * d)             # out_proj
        elif kind == "rwkv":
            # time-mix: r,k,v,g,o projections + data-dependent decay lora
            total += 5 * d * d + 4 * d * 64 + d * 32
            # channel-mix
            total += 2 * d * cfg.d_ff // 2 + d * d
        if is_moe:
            e_ff = cfg.moe.expert_d_ff or cfg.d_ff
            total += (cfg.moe.num_experts + cfg.moe.num_shared_experts) * 3 * d * e_ff
            total += d * cfg.moe.num_experts  # router
        elif kind != "rwkv":
            total += 3 * d * cfg.d_ff  # SwiGLU
        total += 2 * d  # norms
    if cfg.is_encoder_decoder:
        for _ in range(cfg.encoder_layers):
            total += 4 * d * d + 2 * d * cfg.d_ff + 2 * d     # enc self-attn + mlp(gelu)
        total += cfg.num_layers * (4 * d * d + d)              # decoder cross-attn
    return int(total)


def active_param_count(cfg: ModelConfig) -> int:
    """Active (per-token) params for MoE: routed top_k + shared only."""
    if cfg.moe.num_experts == 0:
        return param_count(cfg)
    full = param_count(cfg)
    e_ff = cfg.moe.expert_d_ff or cfg.d_ff
    per_expert = 3 * cfg.d_model * e_ff
    n_moe_layers = sum(cfg.moe_layer_mask())
    inactive = n_moe_layers * (cfg.moe.num_experts - cfg.moe.top_k) * per_expert
    return int(full - inactive)
