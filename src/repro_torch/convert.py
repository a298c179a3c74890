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
from repro_torch.configs.paper_qa import QAConfig
from repro_torch.core.state import DocumentState
from repro_torch.models.attention import AttnState, CrossMemory
from repro_torch.models.mamba2 import MambaState
from repro_torch.models.rwkv6 import RWKVState
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
    ``tail``, ``final_norm``, ``lm_head`` unless embeddings are tied, and
    ``shared`` (the one attention block every ``shared_attn`` site
    applies; its sites hold empty entries in ``stack`` and ``tail``) when
    it is not empty. Each norm carries its ``scale``, and under ``norm="layernorm"`` its
    ``bias`` too (``norm1``/``norm2`` of the stack, with the repeat axis,
    of the tail, and ``final_norm``): a tree whose ``final_norm`` holds
    other leaves than ``cfg.norm`` builds raises ValueError. Each
    attention entry carries every leaf it has: wq, wk, wv, wo, the
    qk-norm scales (all softmax has) and, under ``gated_linear``, the
    decay projection ``w_gate`` / ``b_gate`` and the groupnorm
    ``gn_scale`` / ``gn_bias``; an MoE block its ``moe`` entry (router,
    w_gate, w_up, w_down and the ``shared`` experts' SwiGLU), a cross
    block its ``cross`` projections and its ``xgate``; an rwkv block its
    RWKV-6 tree as it is (token-shift mixes, the r/k/v/g/o projections,
    the decay's w_decay0/1/2, the per-head ``u_bonus`` and groupnorm, the
    channel-mix and its ``ln1``/``ln2``); a mamba block its ``norm1`` and
    its ``mamba`` tree (``in_proj``, ``conv_w``, ``dt_bias``, ``a_log``,
    ``d_skip``, ``norm_scale``, ``out_proj``); under ``feature_gate``
    (linear family) an attention entry its gate's ``w_fgate`` and
    ``b_fgate``."""
    norm = {"scale", "bias"} if cfg.norm == "layernorm" else {"scale"}
    if set(np_tree["final_norm"]) != norm:
        raise ValueError(f"{cfg.name}: final_norm holds "
                         f"{sorted(np_tree['final_norm'])}, a {cfg.norm} "
                         f"holds {sorted(norm)}")
    keys = ["embed", "stack", "tail", "final_norm"]
    if not cfg.tie_embeddings:
        keys.append("lm_head")
    if np_tree.get("shared"):
        keys.append("shared")
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


def _block_state(st, device):
    kind = next(k for k in (AttnState, CrossMemory, MambaState, RWKVState)
                if st._fields == k._fields)
    return kind(*(None if x is None else _tensor(x, device) for x in st))


def state_from_jax(np_state: Any, *,
                   device: Optional[torch.device] = None) -> dict:
    """Convert a JAX decode state {"stack": (AttnState | CrossMemory |
    MambaState | RWKVState, ...), "tail": (...)} with its leaves as numpy,
    field for field: softmax KV caches (k_cache, v_cache; s and z None), or the
    linear family's s and z (k_cache and v_cache None; z None for
    ``gated_linear`` and for ``linear`` without the normaliser); a cross
    block's memory (k, v under softmax, else c, z); a mamba block's conv
    window and SSD matrices; an rwkv block's shift rows and wkv
    matrices. bf16 caches stay bf16."""
    return {part: tuple(_block_state(st, device) for st in np_state[part])
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


def qa_params_from_jax(np_tree: Any, cfg: QAConfig, *,
                       device: Optional[torch.device] = None) -> dict:
    """Convert a ``repro.qa.model.QAModel.init`` tree under
    ``cfg.attention``: ``embed``, ``query_gru``, ``w_out``, ``b_out``,
    ``ans_embed``; ``doc_gru`` unless second_order, which has ``so``
    (``gru``, ``w_probe`` and the 0-d ``alpha_logit``) instead; gated_linear
    adds ``w_gate`` and ``b_gate``. A tree of another variant raises
    ValueError."""
    want = {"embed", "query_gru", "w_out", "b_out", "ans_embed",
            "so" if cfg.attention == "second_order" else "doc_gru"}
    if cfg.attention == "gated_linear":
        want |= {"w_gate", "b_gate"}
    if set(np_tree) != want:
        raise ValueError(f"a {cfg.attention} QAModel holds {sorted(want)}, "
                         f"the tree {sorted(np_tree)}")
    return _tree(np_tree, device)
