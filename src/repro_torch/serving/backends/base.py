"""The DecodeBackend seam (port of ``repro/serving/backends/base.py``):
engine scheduling against a family's state layout.

A :class:`DecodeBackend` holds everything the scheduler asks of a
family:

* **state ops** — ``init_slots``, ``prefill`` / ``prefill_varlen``,
  ``decode_window`` / ``decode_window_varlen`` / ``ingest_window_varlen``,
  ``generate_segment``, ``sample_token``, ``snapshot_state`` /
  ``restore_state`` / ``write_slot_state``, ``where_state``, the
  row-ranged ``snapshot_state_rows`` / ``restore_state_rows`` /
  ``where_state_rows``, ``state_rows_view``, ``slot_state_finite``,
  ``decode_step`` and ``pad_decode_state`` — all of them
  ``models/lm.py``'s, which update states in place (the surface of the
  engine, its lifecycle, its prefix cache and ``serving/speculative.py``);
* **capability flags** — ``fixed_size_state`` (admission, preemption
  and a speculative rewind move O(k²) bytes, never a KV history),
  ``supports_varlen_prefill`` (bucket-padded batched admission),
  ``supports_spec`` (draft/verify windows and rewind; every family, as
  in JAX), ``supports_prefix_cache`` (equal to
  ``supports_varlen_prefill``: a hit must leave the suffix on the chunk
  grid of batched admission), and ``state_bytes_per_slot(max_len)``,
  read from the shapes of a state built on the ``meta`` device (nothing
  is allocated; JAX uses ``eval_shape``);
* **the prefix cache** — ``make_prefix_cache``: the paper's
  hash → fixed-size-state table here, paged refcounted KV blocks for the
  softmax baseline (``softmax_kv.py``).

No backend takes a config with ``cross`` blocks: they attend to an
encoded memory that the engine has no path to pass (JAX's admission
prefills without one, so its engine cannot serve them either), and
construction raises a ValueError that names it.

``resolve_modes`` is the one place the engine's ``admission`` and
``ingest`` "auto" settings are decided. ``backend_for_config`` walks the
registry by priority; the first backend whose ``handles(cfg)`` is True
wins; ``list_backends`` and ``get_backend_cls`` read the registry.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Type

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm

ATTN_KINDS = ("attn", "shared_attn", "cross")
ADMISSIONS = ("auto", "batched", "per_request")
INGESTS = ("auto", "parallel", "recurrent")


def _pattern_kinds(cfg: ModelConfig) -> frozenset:
    pattern, _, tail = cfg.pattern_and_repeats
    return frozenset(pattern) | frozenset(tail)


class DecodeBackend:
    """Base backend: every state op goes to ``models/lm.py``. Subclasses
    pin the family (``name``), claim configs (``handles``) and check
    family invariants (``_validate``). Capabilities are instance
    attributes: they depend on the config."""

    name: str = "base"
    # dispatch priority for backend_for_config (lower = checked first)
    priority: int = 50

    def __init__(self, cfg: ModelConfig):
        if "cross" in _pattern_kinds(cfg):
            # JAX's engine has no memory path either: its admission
            # prefills without one
            raise ValueError(
                f"{cfg.name}: its 'cross' blocks attend to an encoded "
                f"memory (B, n_img_tokens={cfg.n_img_tokens}, d_model), and "
                f"the engine has no path to pass one; serve it with "
                f"--mode generate, which draws the memory")
        self.cfg = cfg
        self.fixed_size_state = cfg.fixed_state_decode
        self.supports_varlen_prefill = lm.supports_varlen_prefill(cfg)
        self.supports_spec = True
        # a cache hit must leave the suffix on the chunk grid a cold
        # batched admission uses, so the capability follows varlen prefill
        self.supports_prefix_cache = self.supports_varlen_prefill
        self._validate(cfg)

    # -- registry hooks ------------------------------------------------

    @classmethod
    def handles(cls, cfg: ModelConfig) -> bool:
        raise NotImplementedError

    def _validate(self, cfg: ModelConfig) -> None:
        """Family-specific config invariants (raise early)."""

    # -- mode resolution -----------------------------------------------

    def resolve_modes(self, admission: str, ingest: str) -> Tuple[str, str]:
        """Resolve the engine's ``admission`` and ``ingest`` settings
        against this backend's capabilities. ``ingest="auto"`` is
        ``"recurrent"``: JAX picks the chunk-parallel continuation on a
        TPU only, and the masked recurrent window (B1/B7 here) on any
        other backend. Under softmax both settings take the per-step
        path (``lm.ingest_window_varlen`` falls back to it)."""
        if admission not in ADMISSIONS:
            raise ValueError(f"admission must be one of {ADMISSIONS}, got "
                             f"{admission!r}")
        if ingest not in INGESTS:
            raise ValueError(f"ingest must be one of {INGESTS}, got "
                             f"{ingest!r}")
        if admission == "auto":
            admission = ("batched" if self.supports_varlen_prefill
                         else "per_request")
        if admission == "batched" and not self.supports_varlen_prefill:
            raise ValueError(
                f"admission='batched' unsupported by backend {self.name!r}:"
                f" missing capability supports_varlen_prefill (varlen "
                f"prefill masking needs an attention-only layer pattern; "
                f"got {sorted(_pattern_kinds(self.cfg))})")
        if ingest == "auto":
            ingest = "recurrent"
        return admission, ingest

    # -- sizing --------------------------------------------------------

    def state_bytes_per_slot(self, max_len: int) -> int:
        """Bytes one slot's decode state occupies at ``max_len``: the
        admission copy's cost. Read from a state built on the ``meta``
        device, which allocates nothing. Constant in ``max_len`` iff
        ``fixed_size_state``."""
        st = lm.init_decode_state(self.cfg, 1, max_len=max_len,
                                  device="meta")
        return lm.state_bytes(st)

    # -- state ops -----------------------------------------------------

    def init_slots(self, batch: int, max_len: int,
                   device: Optional[torch.device] = None) -> Any:
        return lm.init_decode_state(self.cfg, batch, max_len=max_len,
                                    device=device)

    def prefill(self, params, tokens):
        return lm.prefill(params, tokens, self.cfg)

    def prefill_varlen(self, params, tokens, lens):
        return lm.prefill_varlen(params, tokens, lens, self.cfg)

    def decode_step(self, params, state, token, pos, *, active=None):
        return lm.decode_step(params, state, token, pos, self.cfg,
                              active=active)

    def decode_window(self, params, state, tokens, pos0):
        return lm.decode_window(params, state, tokens, pos0, self.cfg)

    def decode_window_varlen(self, params, state, tokens, pos0, lens, *,
                             active=None, last_only=False):
        return lm.decode_window_varlen(params, state, tokens, pos0, lens,
                                       self.cfg, active=active,
                                       last_only=last_only)

    def ingest_window_varlen(self, params, state, tokens, pos0, lens, *,
                             last_only=False):
        return lm.ingest_window_varlen(params, state, tokens, pos0, lens,
                                       self.cfg, last_only=last_only)

    def generate_segment(self, params, state, tok, pos, active, remaining,
                         n_steps, *, eos_id=None, temperature=0.0,
                         generator=None, pad_id=-1):
        return lm.generate_segment(
            params, state, tok, pos, active, remaining, n_steps, self.cfg,
            eos_id=eos_id, temperature=temperature, generator=generator,
            pad_id=pad_id)

    def sample_token(self, logits, temperature, generator=None):
        return lm.sample_token(logits, temperature, generator)

    def pad_decode_state(self, state, *, max_len: int):
        return lm.pad_decode_state(state, self.cfg, max_len)

    def snapshot_state(self, state, slot):
        return lm.snapshot_state(state, slot)

    def restore_state(self, engine_state, snapshot, slot):
        return lm.restore_state(engine_state, snapshot, slot)

    def write_slot_state(self, engine_state, snapshot, slot):
        return lm.write_slot_state(engine_state, snapshot, slot)

    def where_state(self, active, new, old):
        return lm.where_state(active, new, old)

    def snapshot_state_rows(self, state, slot, n_rows: int):
        return lm.snapshot_state_rows(state, slot, n_rows)

    def restore_state_rows(self, engine_state, snapshot, slot):
        return lm.restore_state_rows(engine_state, snapshot, slot)

    def where_state_rows(self, active, new, old, start, width: int):
        return lm.where_state_rows(active, new, old, start, width)

    def state_rows_view(self, state, slot, n_rows: int):
        return lm.state_rows_view(state, slot, n_rows)

    def slot_state_finite(self, state):
        return lm.slot_state_finite(state)

    # -- prefix caching ------------------------------------------------

    def _check_prefix_cache(self) -> None:
        if not self.supports_prefix_cache:
            raise ValueError(
                f"backend {self.name!r} does not support prefix caching "
                f"(missing capability supports_prefix_cache)")

    def make_prefix_cache(self, max_bytes: int, chunk: int):
        """This family's prefix cache: a hash → fixed-size-state table
        (the softmax baseline overrides it with paged KV blocks). Raises
        ValueError when the backend lacks the capability."""
        from repro_torch.serving.prefix_cache import FixedStatePrefixCache
        self._check_prefix_cache()
        return FixedStatePrefixCache(max_bytes=max_bytes, chunk=chunk)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_BACKENDS: Dict[str, Type[DecodeBackend]] = {}


def register_backend(cls: Type[DecodeBackend]) -> Type[DecodeBackend]:
    """Class decorator: add a backend to the registry. Dispatch walks
    backends by ``priority`` (then name), so import order never decides
    who claims a config."""
    if cls.name in _BACKENDS:
        raise ValueError(f"duplicate backend {cls.name!r}")
    _BACKENDS[cls.name] = cls
    return cls


def list_backends() -> List[str]:
    return list(_BACKENDS)


def get_backend_cls(name: str) -> Type[DecodeBackend]:
    if name not in _BACKENDS:
        raise KeyError(
            f"unknown backend {name!r}; registered: {list(_BACKENDS)}")
    return _BACKENDS[name]


def backend_for_config(cfg: ModelConfig) -> DecodeBackend:
    """The first registered backend, by priority, that claims ``cfg``."""
    for cls in sorted(_BACKENDS.values(),
                      key=lambda c: (c.priority, c.name)):
        if cls.handles(cfg):
            return cls(cfg)
    raise ValueError(
        f"no registered backend handles config {cfg.name!r} "
        f"(pattern kinds {sorted(_pattern_kinds(cfg))}, "
        f"attention_backend={cfg.attention_backend!r}); "
        f"registered: {list(_BACKENDS)}")
