"""Abstract stand-ins for every model input and state (port of
``repro/launch/specs.py``): the dry run traces against these, and
nothing is ever allocated.

A stand-in is a ``FakeTensor`` (``FakeTensorMode``): its shape, type and
device, no storage. Each is made on the caller's device, "cuda" unless
asked (a fake CUDA tensor needs no card). Made under an active
``FakeTensorMode`` they belong to it, and the dry run uses them there;
otherwise each call opens a mode of its own, which is enough for shapes
and counts.

``input_specs(cfg, shape)`` follows the assignment:
  train_*    {tokens (B,T), labels (B,T)}           → train step
  prefill_*  {tokens (B,T)}                         → prefill
  decode_* / long_*  {token (B,), pos ()} + decode state with a
             seq_len-sized KV cache (softmax) or fixed-size matrix
             states (linear family / SSM)           → decode step

Vision configs (``n_img_tokens``) additionally get the modality
frontend's input: precomputed patch embeddings (B, n_img, d_model) in
bf16 for cross-attention.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.optim import Optimizer
from repro_torch.tree import leaves, leaves_with_paths, tree_map


def _fake_mode():
    """The active ``FakeTensorMode``, or a new one."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    active = torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
    return contextlib.nullcontext() if active is not None \
        else FakeTensorMode()


def _on(tree, device):
    """Fake tensors of ``tree``'s shapes and types on ``device`` (a fake
    CPU tensor cannot be moved to a device the build lacks, but one can
    be made there)."""
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device=device), tree)


def abstract_params(cfg: ModelConfig, *, device="cuda") -> Any:
    with _fake_mode():
        return _on(lm.init_params(torch.Generator(), cfg), device)


def abstract_params_serving(cfg: ModelConfig, *, device="cuda") -> Any:
    """Serving checkpoints hold bf16 matrices (fp32 masters stay with the
    trainer), as ``lm.cast_params`` casts them: half the weight reads of
    each decode step."""
    with _fake_mode():
        return lm.cast_params(abstract_params(cfg, device=device),
                              torch.bfloat16)


def abstract_opt_state(cfg: ModelConfig, optimizer: Optimizer, *,
                       device="cuda") -> Any:
    with _fake_mode():
        return optimizer.init(abstract_params(cfg, device=device))


def abstract_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                          rules=None, *, device="cuda") -> Any:
    """``lm.init_decode_state``: under ``rules`` the linear family's
    heads padded to the model axis, and on a mesh each leaf a DTensor."""
    with _fake_mode():
        return lm.init_decode_state(cfg, batch, max_len=max_len,
                                    device=device, rules=rules)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, rules=None, *,
                device="cuda") -> Dict[str, Any]:
    b, t = shape.global_batch, shape.seq_len
    with _fake_mode():
        def tok(*s):
            return torch.empty(s, dtype=torch.int32, device=device)

        def memory():
            return torch.empty((b, cfg.n_img_tokens, cfg.d_model),
                               dtype=torch.bfloat16, device=device)
        if shape.kind == "train":
            specs = {"tokens": tok(b, t), "labels": tok(b, t)}
            if cfg.n_img_tokens:
                specs["memory"] = memory()
            return specs
        if shape.kind == "prefill":
            specs = {"tokens": tok(b, t)}
            if cfg.n_img_tokens:
                specs["memory"] = memory()
            return specs
        if shape.kind == "decode":
            return {
                "token": tok(b),
                "pos": tok(),
                "state": abstract_decode_state(cfg, b, t, rules,
                                               device=device),
            }
    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# parameter / FLOP accounting (roofline MODEL_FLOPS terms)
# ---------------------------------------------------------------------------

def count_params(cfg: ModelConfig) -> Tuple[int, int]:
    """(total, active) parameter counts from the abstract tree.

    ``active`` discounts routed-expert weights by top_k/n_experts (the
    MoE per-token activation fraction); used for MODEL_FLOPS = 6·N_active·D.
    """
    params = abstract_params(cfg, device="cpu")
    total = sum(math.prod(x.shape) for x in leaves(params))
    active = total
    if cfg.moe is not None:
        routed = sum(
            math.prod(leaf.shape)
            for path, leaf in leaves_with_paths(params)
            if "moe" in path and any(k in ("w_gate", "w_up", "w_down")
                                     for k in path.split("/")))
        active = total - routed + int(
            routed * cfg.moe.top_k / cfg.moe.n_experts)
    return total, active


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Useful-model FLOPs for one step of this (cfg, shape) cell.

    train:   6·N_active·(B·T)  (fwd 2 + bwd 4)
    prefill: 2·N_active·(B·T)
    decode:  2·N_active·B      (one token per sequence)
    """
    _, active = count_params(cfg)
    if shape.kind == "train":
        return 6.0 * active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len
    return 2.0 * active * shape.global_batch
