"""Config system of the PyTorch port: plain dataclasses and a registry of
named architectures.

This is the port's own copy of the reference package's config module (the
port imports nothing of the reference package), cut to what the dense, MoE,
SSM, hybrid, VLM and audio encoder-decoder serving and training paths read (plus the data pipeline's
:class:`DataConfig`), and :data:`DTYPES`, the map from the config's dtype
strings to torch dtypes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch

VOCAB_PAD_MULTIPLE = 256  # Megatron-style embedding padding

#: config dtype strings -> torch dtypes
DTYPES: Dict[str, torch.dtype] = {"float32": torch.float32,
                                  "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    """``"float32"``/``"bfloat16"`` (or a torch dtype) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; known: "
                         f"{sorted(DTYPES)}") from None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


PEFT_METHODS = (
    "none",      # plain frozen linear (or full FT)
    "psoft",     # the paper's method (strict orthogonality if relax_vectors=False)
    "lora",
    "pissa",     # LoRA with principal-SVD init
    "dora",
    "lora_xs",
    "oft",       # block-diagonal OFTv2 (Cayley-Neumann)
    "boft",      # butterfly OFT
    "goft",      # Givens-rotation OFT
    "qgoft",     # quasi-Givens (relaxed 2x2) OFT
)


@dataclass
class PEFTConfig:
    method: str = "psoft"
    rank: int = 64                  # r for psoft/lora/pissa/dora/lora_xs
    relax_vectors: bool = True      # PSOFT alpha/beta; False = strict
    neumann_terms: int = 5          # K in the truncated Neumann series
    exact_cayley: bool = False      # exact (I+Q)^-1 solve instead of Neumann
    lora_alpha: float = 16.0        # LoRA scaling
    oft_block_size: int = 32        # b for block-diagonal OFT
    boft_blocks: int = 8            # b for BOFT
    boft_factors: int = 2           # m for BOFT
    #: logical module names that get wrapped: a tuple (every listed module
    #: uses ``method``) or a dict {"q": "psoft", "up": "lora"} (per-module
    #: methods; unlisted modules stay unwrapped)
    target_modules: Union[Tuple[str, ...], Mapping[str, str]] = (
        "q", "k", "v", "o", "gate", "up", "down", "in_proj", "out_proj",
    )

    def method_for(self, module: Optional[str]) -> str:
        """PEFT method name for one logical module ("none" if unwrapped)."""
        if module is None:
            return self.method
        tm = self.target_modules
        if isinstance(tm, Mapping):
            return tm.get(module, "none")
        return self.method if module in tm else "none"

    def is_target(self, module: Optional[str]) -> bool:
        return self.method_for(module) != "none"

    def replace(self, **kw) -> "PEFTConfig":
        return dataclasses.replace(self, **kw)


@dataclass
class MoEConfig:
    num_experts: int = 0            # routed experts (0 = dense)
    num_shared_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    sharding: str = "ep"            # "ep" (experts over model axis) or "tp"
    aux_loss_weight: float = 0.01


@dataclass
class SSMConfig:
    state_size: int = 128           # N, the SSD state dimension
    head_dim: int = 64              # P, per-head channel dim
    expand: int = 2                 # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 256           # SSD intra-chunk block length
    ngroups: int = 1                # B/C groups


@dataclass
class ModelConfig:
    name: str = "tiny"
    # the port builds dense | moe | ssm | hybrid | vlm | audio
    family: str = "dense"
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0               # 0 => d_model // num_heads
    d_ff: int = 512
    vocab_size: int = 1024
    max_seq_len: int = 4096
    mlp_type: str = "swiglu"        # swiglu | gelu | relu2
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    dtype: str = "bfloat16"         # compute dtype
    param_dtype: str = "bfloat16"   # frozen base weights
    peft_dtype: str = "float32"     # trainable PEFT params
    # remat, one boundary per layer: "full" recomputes the layer in the
    # backward (torch.utils.checkpoint), "minimal" keeps every linear's
    # output and recomputes the rest (attention, norms, activations, RoPE),
    # "none" keeps every activation
    remat_policy: str = "full"      # none | minimal | full
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    # hybrid (zamba2-style): one shared attention block applied every k
    # layers
    hybrid_attn_every: int = 6
    # vlm: number of prepended patch-embedding positions (precomputed
    # vision-encoder outputs, a stub frontend)
    num_patch_tokens: int = 0
    # audio / encoder-decoder: the source is precomputed frame embeddings
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    peft: PEFTConfig = field(default_factory=PEFTConfig)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab_size(self) -> int:
        return _round_up(self.vocab_size, VOCAB_PAD_MULTIPLE)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic families (SSM, hybrid) run the long_500k shape."""
        return self.family in ("ssm", "hybrid")

    def layer_pattern(self) -> str:
        """One char per decoder layer: M (Mamba2 SSD) or A (attention)."""
        if self.family == "ssm":
            return "M" * self.num_layers
        if self.family == "hybrid":
            k = self.hybrid_attn_every
            return "".join("A" if i % k == k - 1 else "M"
                           for i in range(self.num_layers))
        return "A" * self.num_layers

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, **extra) -> "ModelConfig":
        """A tiny same-family config for CPU tests: the reference's
        ``reduced()`` for the families the port builds (an MoE config keeps
        4 experts, top-2, at most one shared expert, ``d_ff`` 64; SSM and
        hybrid state 16, head_dim 16, chunk 32, and a hybrid 4 layers with
        attention every 2; a VLM 8 patch tokens; an encoder-decoder 2
        encoder layers)."""
        kw: Dict = dict(
            num_layers=min(self.num_layers,
                           2 if self.family != "hybrid" else 4),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            max_seq_len=128,
            dtype="float32",
            param_dtype="float32",
        )
        if self.family == "moe":
            kw["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2,
                num_shared_experts=min(self.moe.num_shared_experts, 1))
            kw["d_ff"] = 64
        if self.family in ("ssm", "hybrid"):
            kw["ssm"] = dataclasses.replace(
                self.ssm, state_size=16, head_dim=16, chunk_size=32)
            kw["hybrid_attn_every"] = 2
        if self.family == "vlm":
            kw["num_patch_tokens"] = 8
        if self.is_encoder_decoder:
            kw["num_encoder_layers"] = 2
        kw["peft"] = dataclasses.replace(self.peft, rank=8)
        kw.update(extra)
        return dataclasses.replace(self, **kw)


@dataclass
class TrainConfig:
    """What the train step and the training launcher
    (:mod:`repro_torch.launch.train`) read: the step's optimizer and
    accumulation settings, then the loop's seed and checkpoint cadence
    (its logging cadence is the launcher's ``--log-every`` flag, as in the
    reference)."""
    learning_rate: float = 4e-4
    warmup_ratio: float = 0.1
    schedule: str = "cosine"        # cosine | linear | constant
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    grad_clip_norm: float = 1.0
    steps: int = 100
    microbatches: int = 1           # gradient accumulation
    full_finetune: bool = False     # True = FFT baseline (all params trainable)
    grad_allreduce_dtype: str = ""  # "" | "bfloat16" | "int8" (compression)
    seed: int = 0
    checkpoint_every: int = 50
    checkpoint_dir: str = ""


# ---------------------------------------------------------------------------
# input shapes (the dry-run's per-arch shape set) and the mesh
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


LM_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """(runnable, reason if skipped) for an (arch, shape) cell."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full-attention arch: long_500k needs sub-quadratic "
                       "attention")
    return True, ""


@dataclass
class MeshConfig:
    """The production mesh: one pod ``(data, model)`` or several
    ``(pod, data, model)``; ``pod_role`` says whether the pod axis carries
    data parallelism (``"dp"``) or pipeline stages (``"pp"``)."""
    multi_pod: bool = False
    pod: int = 2
    data: int = 16
    model: int = 16
    pod_role: str = "dp"

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.pod, self.data, self.model) if self.multi_pod else (
            self.data, self.model)

    @property
    def axes(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data",
                                                                "model")


@dataclass
class DataConfig:
    seed: int = 0
    branching: int = 4          # out-degree of the Markov chain
    num_hosts: int = 1
    host_id: int = 0


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    cfg = _REGISTRY[name]()
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


@register("llama32-3b")
def llama32_3b() -> ModelConfig:
    # LLaMA-3.2-3B, the paper's decoder-only testbed
    return ModelConfig(
        name="llama32-3b", family="dense",
        num_layers=28, d_model=3072, num_heads=24, num_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=128256, mlp_type="swiglu",
        peft=PEFTConfig(rank=352),  # paper Table 4
    )


@register("lm-100m")
def lm_100m() -> ModelConfig:
    return ModelConfig(
        name="lm-100m", family="dense",
        num_layers=12, d_model=768, num_heads=12, num_kv_heads=4, head_dim=64,
        d_ff=2048, vocab_size=32000, mlp_type="swiglu", max_seq_len=1024,
        peft=PEFTConfig(rank=46),
    )


@register("starcoder2-15b")
def starcoder2_15b() -> ModelConfig:
    # [arXiv:2402.19173] 40L d=6144 48H GQA kv=4 ffn=24576 vocab=49152,
    # GQA + RoPE
    return ModelConfig(
        name="starcoder2-15b", family="dense",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4, head_dim=128,
        d_ff=24576, vocab_size=49152, mlp_type="gelu", norm_type="layernorm",
        peft=PEFTConfig(rank=128, target_modules=("q", "k", "v", "o", "up",
                                                  "down")),
    )


@register("granite-8b")
def granite_8b() -> ModelConfig:
    # [arXiv:2405.04324] llama-arch 36L d=4096 32H kv=8 ffn=14336 vocab=49152
    return ModelConfig(
        name="granite-8b", family="dense",
        num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=49152, mlp_type="swiglu",
        peft=PEFTConfig(rank=128),
    )


@register("internlm2-1.8b")
def internlm2_1p8b() -> ModelConfig:
    # [arXiv:2403.17297] 24L d=2048 16H kv=8 ffn=8192 vocab=92544
    return ModelConfig(
        name="internlm2-1.8b", family="dense",
        num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=92544, mlp_type="swiglu",
        peft=PEFTConfig(rank=64),
    )


@register("nemotron-4-15b")
def nemotron4_15b() -> ModelConfig:
    # [arXiv:2402.16819] 32L d=6144 48H kv=8 ffn=24576 vocab=256000,
    # squared-ReLU
    return ModelConfig(
        name="nemotron-4-15b", family="dense",
        num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
        d_ff=24576, vocab_size=256000, mlp_type="relu2", norm_type="layernorm",
        peft=PEFTConfig(rank=128, target_modules=("q", "k", "v", "o", "up",
                                                  "down")),
    )


@register("dbrx-132b")
def dbrx_132b() -> ModelConfig:
    # [hf:databricks/dbrx-base] 40L d=6144 48H kv=8 ffn=10752 vocab=100352,
    # 16 experts top-4 fine-grained
    return ModelConfig(
        name="dbrx-132b", family="moe",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
        d_ff=10752, vocab_size=100352, mlp_type="swiglu", norm_type="layernorm",
        moe=MoEConfig(num_experts=16, top_k=4, capacity_factor=1.25, sharding="ep"),
        peft=PEFTConfig(rank=128),
    )


@register("deepseek-moe-16b")
def deepseek_moe_16b() -> ModelConfig:
    # [arXiv:2401.06066] 28L d=2048 16H kv=16 ffn=1408/expert vocab=102400,
    # 2 shared + 64 routed top-6
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
        d_ff=1408, vocab_size=102400, mlp_type="swiglu",
        moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6,
                      capacity_factor=1.25, sharding="ep"),
        peft=PEFTConfig(rank=64),
    )


@register("mamba2-1.3b")
def mamba2_1p3b() -> ModelConfig:
    # [arXiv:2405.21060] 48L d_model=2048, attention-free SSD,
    # ssm_state=128, vocab 50280
    return ModelConfig(
        name="mamba2-1.3b", family="ssm",
        num_layers=48, d_model=2048, num_heads=64, num_kv_heads=64, head_dim=64,
        d_ff=0, vocab_size=50280, mlp_type="swiglu", norm_type="rmsnorm",
        ssm=SSMConfig(state_size=128, head_dim=64, expand=2, conv_width=4,
                      chunk_size=256),
        peft=PEFTConfig(rank=64, target_modules=("in_proj", "out_proj")),
    )


@register("zamba2-1.2b")
def zamba2_1p2b() -> ModelConfig:
    # [arXiv:2411.15242] 38L d=2048 Mamba2 backbone + one shared attention
    # block, 32H kv=32 ffn=8192 vocab=32000 ssm_state=64
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
        d_ff=8192, vocab_size=32000, mlp_type="swiglu",
        ssm=SSMConfig(state_size=64, head_dim=64, expand=2, conv_width=4,
                      chunk_size=256),
        hybrid_attn_every=6,
        peft=PEFTConfig(rank=64, target_modules=(
            "q", "k", "v", "o", "gate", "up", "down", "in_proj", "out_proj")),
    )


@register("internvl2-26b")
def internvl2_26b() -> ModelConfig:
    # [arXiv:2404.16821] InternViT (stub) + InternLM2 backbone:
    # 48L d=6144 48H kv=8 ffn=16384 vocab=92553
    return ModelConfig(
        name="internvl2-26b", family="vlm",
        num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
        d_ff=16384, vocab_size=92553, mlp_type="swiglu",
        num_patch_tokens=256,  # precomputed InternViT patch embeddings (stub)
        peft=PEFTConfig(rank=128),
    )


@register("seamless-m4t-medium")
def seamless_m4t_medium() -> ModelConfig:
    # [arXiv:2308.11596] enc-dec 12L d=1024 16H kv=16 ffn=4096 vocab=256206
    return ModelConfig(
        name="seamless-m4t-medium", family="audio",
        num_layers=12, num_encoder_layers=12, is_encoder_decoder=True,
        d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
        d_ff=4096, vocab_size=256206, mlp_type="gelu", norm_type="layernorm",
        peft=PEFTConfig(rank=48),
    )


@register("tiny")
def tiny() -> ModelConfig:
    return ModelConfig(name="tiny", family="dense", dtype="float32",
                       param_dtype="float32", peft=PEFTConfig(rank=8))
