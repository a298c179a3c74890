"""Gradient accumulation over microbatches (port of
``repro/optim/accumulate.py``).

``GradAccumulator.run`` splits the batch's leading dim into ``n_micro``
slices and runs the loss and its backward on each in turn, summing the
gradients in fp32; only one microbatch's activations are alive at a
time.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.tree import leaves, tree_map


def _value_and_grad(loss_fn: Callable, params, batch):
    """(loss, metrics, grads): autograd over every leaf of ``params``,
    which are marked as requiring gradients."""
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, metrics = loss_fn(params, batch)
    grads = iter(torch.autograd.grad(loss, flat))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), params))


@dataclasses.dataclass(frozen=True)
class GradAccumulator:
    n_micro: int

    def run(self, loss_fn: Callable, params, batch: Dict[str, Any]
            ) -> Tuple[torch.Tensor, Any, Any]:
        """loss_fn(params, microbatch) -> (loss, metrics).

        Returns (mean loss, mean metrics, summed-then-averaged grads).
        """
        if self.n_micro <= 1:
            return _value_and_grad(loss_fn, params, batch)
        micro = {k: v.reshape(self.n_micro, -1, *v.shape[1:])
                 for k, v in batch.items()}
        loss_sum, grads, metrics = 0.0, None, []
        for i in range(self.n_micro):
            loss, m, g = _value_and_grad(
                loss_fn, params, {k: v[i] for k, v in micro.items()})
            g = tree_map(lambda x: x.to(torch.float32), g)
            grads = g if grads is None else tree_map(torch.add, grads, g)
            loss_sum = loss_sum + loss
            metrics.append(m)
        inv = 1.0 / self.n_micro
        grads = tree_map(lambda g: g * inv, grads)
        metrics = {k: torch.stack([m[k] for m in metrics]).mean(dim=0)
                   for k in metrics[0]}
        return loss_sum * inv, metrics, grads
