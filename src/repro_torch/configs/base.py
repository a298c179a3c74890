"""Model configuration schema + registry (the port's own copy).

Field for field the same ``ModelConfig``, ``MoEConfig``, ``SSMConfig``
and ``RWKVConfig`` as ``repro.configs.base``, so a configuration means
the same model in both packages; the tests compare the two copies with
``dataclasses.asdict``. The port serves every block kind: ``attn``
(dense or MoE), ``shared_attn`` and ``cross`` under every attention
backend, ``mamba`` and ``rwkv``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

VALID_KINDS = ("attn", "shared_attn", "cross", "mamba", "rwkv")
VALID_ATTENTION_BACKENDS = ("softmax", "linear", "gated_linear")
# auto and fused: the hand-written CUDA kernel for CUDA tensors, its plain
# PyTorch version for CPU tensors; reference: always the plain version
VALID_DECODE_KERNELS = ("auto", "fused", "reference")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # "shard_map" (JAX's all-to-all expert parallelism) or "einsum"; on
    # one device both take the einsum path, the only one the port has
    dispatch: str = "shard_map"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|audio|hybrid|ssm|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    layer_pattern: Tuple[str, ...] = ("attn",)
    n_repeats: int = 0               # 0 → n_layers repeats of the pattern
    tail: Tuple[str, ...] = ()
    attention_backend: str = "softmax"
    feature_map: str = "elu1"        # identity = paper-faithful
    linear_normalize: bool = True
    linear_chunk: int = 128
    feature_gate: bool = False       # paper §4 gate f = σ(Wh+b)⊙h on k/v
    decay_mode: str = "vector"       # gated_linear: vector|scalar decay
    decay_temp: float = 8.0          # log-decay temperature (slow forget)
    decode_kernel: str = "auto"
    qk_norm: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    act: str = "swiglu"              # swiglu|gelu
    norm: str = "rmsnorm"            # rmsnorm|layernorm
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    n_img_tokens: int = 0            # VLM cross-attention memory length
    tie_embeddings: bool = False
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"
    remat: str = "unit"              # none|unit (training only)

    def __post_init__(self):
        kinds = tuple(self.layer_pattern) + tuple(self.tail)
        unknown = sorted({k for k in kinds if k not in VALID_KINDS})
        if unknown:
            raise ValueError(
                f"{self.name}: unknown layer_pattern/tail kind(s) "
                f"{unknown}; valid kinds are {list(VALID_KINDS)}")
        if self.attention_backend not in VALID_ATTENTION_BACKENDS:
            raise ValueError(
                f"{self.name}: unknown attention_backend "
                f"{self.attention_backend!r}; valid backends are "
                f"{list(VALID_ATTENTION_BACKENDS)}")
        if self.decode_kernel not in VALID_DECODE_KERNELS:
            raise ValueError(
                f"{self.name}: unknown decode_kernel "
                f"{self.decode_kernel!r}; valid kernels are "
                f"{list(VALID_DECODE_KERNELS)}")
        if self.decode_kernel == "fused":
            has_linear_attn = (
                any(k in ("attn", "shared_attn") for k in kinds)
                and self.attention_backend in ("linear", "gated_linear"))
            if not has_linear_attn:
                raise ValueError(
                    f"{self.name}: decode_kernel='fused' has no fused "
                    f"kernel for this config (attention_backend="
                    f"{self.attention_backend!r}, pattern kinds "
                    f"{sorted(set(kinds))}); the fused recurrent decode "
                    f"kernels cover linear/gated_linear attention layers "
                    f"— use decode_kernel='auto' or 'reference'")

    def with_backend(self, backend: str) -> "ModelConfig":
        return dataclasses.replace(self, attention_backend=backend)

    @property
    def pattern_and_repeats(self) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
        reps = self.n_repeats
        if reps == 0:
            if self.n_layers % len(self.layer_pattern):
                raise ValueError(
                    f"{self.name}: n_layers {self.n_layers} not divisible "
                    f"by pattern {self.layer_pattern}")
            reps = self.n_layers // len(self.layer_pattern)
        return self.layer_pattern, reps, self.tail

    @property
    def uses_attention(self) -> bool:
        pattern, _, tail = self.pattern_and_repeats
        kinds = set(pattern) | set(tail)
        return bool(kinds & {"attn", "shared_attn", "cross"})

    @property
    def fixed_state_decode(self) -> bool:
        """True if decode state is O(1) in context length (the paper's
        fixed-size-representation property)."""
        pattern, _, tail = self.pattern_and_repeats
        kinds = set(pattern) | set(tail)
        if not kinds & {"attn", "shared_attn", "cross"}:
            return True
        return self.attention_backend in ("linear", "gated_linear")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (sequence length, global batch, step kind) cell of the dry
    run (JAX ``ShapeConfig``)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def with_depth(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """``cfg`` at ``n_layers`` layers, whole repeats of its layer pattern:
    the depth cut of a model too large for one card, its widths
    unchanged. A config with a tail after its repeats (zamba2-7b's three
    Mamba-2 blocks after 13 units of 5 Mamba-2 + 1 shared attention)
    drops the tail: the cut model is whole units only. ``depth_cut``
    says what was cut."""
    pattern, _, _ = cfg.pattern_and_repeats
    reps, rest = divmod(n_layers, len(pattern))
    if rest or reps < 1:
        raise ValueError(
            f"{cfg.name}: {n_layers} layers are not whole repeats of the "
            f"pattern {pattern}")
    return dataclasses.replace(cfg, n_layers=n_layers,
                               n_repeats=reps if cfg.n_repeats else 0,
                               tail=())


def depth_cut(full: ModelConfig, cut: ModelConfig) -> str:
    """One line on ``with_depth``'s cut of ``full`` to ``cut``."""
    pattern, reps, tail = full.pattern_and_repeats
    _, cut_reps, _ = cut.pattern_and_repeats
    return (f"{cut.n_layers} of {full.n_layers} layers: {cut_reps} of "
            f"{reps} repeats of {'+'.join(pattern)}"
            + (f", the tail {'+'.join(tail)} dropped" if tail else ""))


_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(fn: Callable[[], ModelConfig]):
    cfg = fn()
    _REGISTRY[cfg.name] = fn
    return fn


def register_smoke(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _SMOKE_REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)
    return _REGISTRY[name]()


def get_smoke_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401
    return _SMOKE_REGISTRY[name]()


def list_architectures():
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
