"""Train, eval, prefill and decode step builders (port of
``repro/runtime/steps.py``).

PyTorch runs eagerly, so a step is a plain function: no jit. On a mesh
(``rules``) the parameters, moments and batch are DTensors placed by
``train_state_specs``, and the metrics come back as whole tensors. The
train step differentiates ``lm.lm_loss`` through the
gradient accumulator and updates the parameters in place. Training
covers every attention backend of the port: ``"linear"``, whose core
runs B2 forward and B3 backward on the card; ``"gated_linear"``, B8
forward and B9 backward; and ``"softmax"``, the paper's baseline, B10
forward (with its log-sum-exp) and JAX's blockwise flash backward in
plain PyTorch.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.optim import (
    GradAccumulator, Optimizer, global_norm, opt_state_specs)
from repro_torch.sharding import Rules, full, mixed_for
from repro_torch.tree import tree_map

NULL = Rules.null()


def make_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    *,
    n_micro: int = 1,
    grad_compress: bool = False,
    attention_kernel: bool = True,
    rules: Rules = NULL,
) -> Callable:
    """(params, opt_state, batch) → (params, opt_state, metrics), with
    the parameters and moments updated in place. Metrics: loss, xent,
    aux, grad_norm (of the gradients before clipping).

    ``grad_compress``: round the gradients through bf16 before the
    update, as the JAX step does before its data-parallel reduction.
    ``attention_kernel=False`` runs the attention core's plain versions
    on the card (the reference route of the tests and chip_smoke.py).
    """
    accum = GradAccumulator(n_micro)

    def loss_fn(params, batch):
        return lm.lm_loss(params, batch, cfg,
                          attention_kernel=attention_kernel, rules=rules)

    def step(params, opt_state, batch):
        with mixed_for(params):      # the backward meets plain tensors too
            loss, metrics, grads = accum.run(loss_fn, params, batch)
        if grad_compress:
            grads = tree_map(
                lambda g: g.to(torch.bfloat16).to(torch.float32), grads)
        gnorm = global_norm(grads)
        params, opt_state = optimizer.update(grads, opt_state, params)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = gnorm
        return params, opt_state, {k: full(v) for k, v in metrics.items()}

    return step


def make_prefill_step(cfg: ModelConfig, *,
                      attention_kernel: bool = True) -> Callable:
    """(params, tokens, memory=None) → (last-position logits, decode
    states), ``lm.prefill`` without gradients; ``memory`` (B, N, D) for
    the cross blocks."""
    @torch.no_grad()
    def step(params, tokens, memory=None):
        return lm.prefill(params, tokens, cfg, memory=memory,
                          attention_kernel=attention_kernel)
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


def train_state_specs(cfg: ModelConfig, rules: Rules = NULL):
    """(param specs, opt-state specs, batch specs) as logical names
    (JAX ``train_state_specs``)."""
    pspecs = lm.param_specs(cfg)
    bspecs = {"tokens": ("batch", None), "labels": ("batch", None)}
    if cfg.n_img_tokens:
        bspecs["memory"] = ("batch", None, "embed")
    return pspecs, opt_state_specs(pspecs), bspecs


def make_decode_step(cfg: ModelConfig) -> Callable:
    """(params, state, token, pos) → (logits (B, V), state): one
    autoregressive step without gradients, the state updated in place
    (``lm.decode_step``, the call behind ``DecodeBackend.decode_step``:
    the decode kernel, B1 or B7, once per attention layer on CUDA
    tensors under the linear family)."""
    @torch.no_grad()
    def step(params, state, token, pos):
        return lm.decode_step(params, state, token, pos, cfg)
    return step
