"""Model configuration schema + registry (the port's own copy).

Field for field the same ``ModelConfig`` as ``repro.configs.base``, so a
configuration means the same model in both packages; the tests compare
the two copies with ``dataclasses.asdict``. The port serves the
``attn`` block kind under ``attention_backend="linear"``; the other
kinds and backends stay in the schema so that the copy does not drift.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

VALID_KINDS = ("attn", "shared_attn", "cross", "mamba", "rwkv")
VALID_ATTENTION_BACKENDS = ("softmax", "linear", "gated_linear")
# auto and fused: the hand-written CUDA kernel for CUDA tensors, its plain
# PyTorch version for CPU tensors; reference: always the plain version
VALID_DECODE_KERNELS = ("auto", "fused", "reference")


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
    # sub-configs of the MoE / Mamba-2 / RWKV-6 families, which the port
    # does not serve yet; None for every configuration it registers
    moe: Optional[Any] = None
    ssm: Optional[Any] = None
    rwkv: Optional[Any] = None
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
    def fixed_state_decode(self) -> bool:
        """True if decode state is O(1) in context length (the paper's
        fixed-size-representation property)."""
        pattern, _, tail = self.pattern_and_repeats
        kinds = set(pattern) | set(tail)
        if not kinds & {"attn", "shared_attn", "cross"}:
            return True
        return self.attention_backend in ("linear", "gated_linear")


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

