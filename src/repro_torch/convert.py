"""Carry parameters and states over from the JAX package.

Every function takes the JAX trees with their leaves as numpy arrays
(``jax.tree.map(np.asarray, tree)``), so this module needs neither JAX
nor ``repro``, and copies them onto an explicit device. Dense weights
keep their (d_in, d_out) layout and stacked groups their leading repeat
axis: the port's trees have the same shape as the JAX ones, and both
sides compute from the same numbers.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.state import DocumentState
from repro_torch.models.attention import AttnState
from repro_torch.optim import AdamState


def _tensor(x, device) -> torch.Tensor:
    """A tensor that owns a copy of ``x``: the port updates decode states
    in place, which must never write through to the caller's arrays."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":        # ml_dtypes: no numpy→torch path
        return torch.tensor(a.astype(np.float32), device=device,
                            dtype=torch.bfloat16)
    return torch.tensor(a, device=device)


def _tree(x, device):
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return tuple(_tree(v, device) for v in x)
    return _tensor(x, device)


def params_from_jax(np_tree: Any, cfg: ModelConfig, *,
                    device: Optional[torch.device] = None) -> dict:
    """Convert the ``repro.models.lm.init_params`` tree: ``embed``,
    ``stack`` (per pattern position, leaves with a leading repeat axis),
    ``tail``, ``final_norm`` and ``lm_head`` unless embeddings are tied.
    Each attention entry carries every leaf it has: wq, wk, wv, wo, the
    qk-norm scales (all softmax has) and, under ``gated_linear``, the
    decay projection
    ``w_gate`` / ``b_gate`` and the groupnorm ``gn_scale`` / ``gn_bias``.
    The JAX ``shared`` entry must be empty: the port has no
    ``shared_attn`` blocks."""
    if np_tree.get("shared"):
        raise NotImplementedError("shared_attn parameters are not ported")
    keys = ["embed", "stack", "tail", "final_norm"]
    if not cfg.tie_embeddings:
        keys.append("lm_head")
    return {k: _tree(np_tree[k], device) for k in keys}


def opt_state_from_jax(np_state: Any, cfg: ModelConfig, *,
                       device: Optional[torch.device] = None) -> AdamState:
    """Convert a ``repro.optim.adamw.AdamState`` (step, mu, nu as numpy;
    mu and nu shaped like the parameter tree), so the port can continue
    a JAX run where it stopped."""
    step, mu, nu = np_state
    return AdamState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=device),
        mu=params_from_jax(mu, cfg, device=device),
        nu=params_from_jax(nu, cfg, device=device))


def _attn_state(st, device) -> AttnState:
    return AttnState(*(None if x is None else _tensor(x, device)
                       for x in st))


def state_from_jax(np_state: Any, *,
                   device: Optional[torch.device] = None) -> dict:
    """Convert a JAX decode state {"stack": (AttnState, ...), "tail":
    (...)} with its leaves as numpy, field for field: softmax KV caches
    (k_cache, v_cache; s and z None), or the linear family's s and z
    (k_cache and v_cache None; z None for ``gated_linear`` and for
    ``linear`` without the normaliser). bf16 caches stay bf16."""
    return {part: tuple(_attn_state(st, device) for st in np_state[part])
            for part in ("stack", "tail")}


def encoder_from_jax(np_tree: Any, *,
                     device: Optional[torch.device] = None) -> dict:
    """Convert a lookup encoder {"embed": (V, d), "gru": {"w_i", "w_h",
    "b"}} (``repro.qa.gru.gru_params`` layout, kept as it is)."""
    return {"embed": _tensor(np_tree["embed"], device),
            "gru": {k: _tensor(np_tree["gru"][k], device)
                    for k in ("w_i", "w_h", "b")}}


def document_state_from_jax(c, z, n_tokens: int, *,
                            device: Optional[torch.device] = None
                            ) -> DocumentState:
    """Convert the fields of a ``repro.core.state.DocumentState``."""
    return DocumentState(c=_tensor(c, device),
                         z=None if z is None else _tensor(z, device),
                         n_tokens=int(n_tokens))
