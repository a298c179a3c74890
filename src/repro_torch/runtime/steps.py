"""Train and eval step builders (port of ``repro/runtime/steps.py``).

PyTorch runs eagerly, so a step is a plain function: no jit and no
sharding trees. The train step differentiates ``lm.lm_loss`` through the
gradient accumulator and updates the parameters in place. Training
covers ``attention_backend="linear"``, whose core runs B2 forward and B3
backward on the card, and ``"gated_linear"``, whose core runs B8 forward
and B9 backward. Softmax training is not ported (the port's softmax
path serves only: B10 is forward only), so that backend raises rather
than train through plain code.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.optim import GradAccumulator, Optimizer, global_norm
from repro_torch.tree import tree_map


def _require_trainable(cfg: ModelConfig) -> None:
    if cfg.attention_backend not in ("linear", "gated_linear"):
        raise NotImplementedError(
            f"{cfg.name}: the port trains attention_backend 'linear' or "
            f"'gated_linear' only (got {cfg.attention_backend!r}); softmax "
            f"training (the backward of B10) is not ported")


def make_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    *,
    n_micro: int = 1,
    grad_compress: bool = False,
    attention_kernel: bool = True,
) -> Callable:
    """(params, opt_state, batch) → (params, opt_state, metrics), with
    the parameters and moments updated in place. Metrics: loss, xent,
    aux, grad_norm (of the gradients before clipping).

    ``grad_compress``: round the gradients through bf16 before the
    update, as the JAX step does before its data-parallel reduction.
    ``attention_kernel=False`` runs the attention core's plain versions
    on the card (the reference route of the tests and chip_smoke.py).
    """
    _require_trainable(cfg)
    accum = GradAccumulator(n_micro)

    def loss_fn(params, batch):
        return lm.lm_loss(params, batch, cfg,
                          attention_kernel=attention_kernel)

    def step(params, opt_state, batch):
        loss, metrics, grads = accum.run(loss_fn, params, batch)
        if grad_compress:
            grads = tree_map(
                lambda g: g.to(torch.bfloat16).to(torch.float32), grads)
        gnorm = global_norm(grads)
        params, opt_state = optimizer.update(grads, opt_state, params)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return step


def make_eval_step(cfg: ModelConfig, *,
                   attention_kernel: bool = True) -> Callable:
    """(params, batch) → metrics (loss, xent, aux), without gradients."""
    @torch.no_grad()
    def step(params, batch):
        loss, metrics = lm.lm_loss(params, batch, cfg,
                                   attention_kernel=attention_kernel)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return metrics
    return step
