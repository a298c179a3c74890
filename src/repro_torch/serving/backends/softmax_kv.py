"""SoftmaxKVBackend, the growing-KV-cache baseline (port of
``repro/serving/backends/softmax_kv.py``).

Classic softmax attention: per layer the decode state is an
(S, max_len, Hkv, Dh) key/value cache that grows with the context, the
representation the paper's mechanism replaces. The engine drives it
through the same :class:`DecodeBackend` surface: batched admission runs
B10 (``flash_attention_fwd``) in the varlen prefill on CUDA tensors and
lands each wave's caches into the slots' ``max_len`` caches, rows past
the bucket width zeroed; decode and chunked ingest gate the one written
cache row per slot and step. ``decode_kernel="reference"`` selects the
reference route as it does for the linear family: every prefill through
B10's plain version (``attention_kernel=False``). The capability flags say so:
``fixed_size_state=False`` and ``state_bytes_per_slot`` grows as
O(max_len·k), since admission moves a whole cache. Its prefix cache is
the paged, refcounted KV-block cache (``make_prefix_cache``), where the
linear family keeps one fixed-size state per prefix.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.serving.backends.base import (
    ATTN_KINDS,
    DecodeBackend,
    _pattern_kinds,
    register_backend,
)


@register_backend
class SoftmaxKVBackend(DecodeBackend):
    """Softmax attention with a growing per-slot KV cache (the baseline
    the paper's fixed-size representation is measured against)."""

    name = "softmax_kv"
    priority = 20

    @classmethod
    def handles(cls, cfg: ModelConfig) -> bool:
        return bool(_pattern_kinds(cfg) & set(ATTN_KINDS)) and (
            cfg.attention_backend == "softmax")

    def prefill(self, params, tokens):
        return lm.prefill(params, tokens, self.cfg,
                          attention_kernel=self._kernel)

    def prefill_varlen(self, params, tokens, lens):
        return lm.prefill_varlen(params, tokens, lens, self.cfg,
                                 attention_kernel=self._kernel)

    @property
    def _kernel(self) -> bool:
        return self.cfg.decode_kernel != "reference"

    def make_prefix_cache(self, max_bytes: int, chunk: int):
        """The growing representation forces block machinery: a paged,
        refcounted, content-hashed KV cache instead of the linear
        family's flat hash → O(k²) state table. A cached prefix of n
        tokens occupies n/chunk blocks: bytes ∝ n."""
        from repro_torch.serving.prefix_cache import PagedKVCache
        self._check_prefix_cache()
        return PagedKVCache(max_bytes=max_bytes, chunk=chunk)

    def _validate(self, cfg: ModelConfig) -> None:
        if cfg.attention_backend != "softmax":
            raise ValueError(
                f"backend {self.name!r} serves softmax attention; config "
                f"{cfg.name!r} has attention_backend="
                f"{cfg.attention_backend!r}")
