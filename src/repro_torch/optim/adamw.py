"""Adam / AdamW on parameter trees (port of ``repro/optim/adamw.py``).

The numbers are the JAX package's: ``b2 = 0.95``, clipping by the global
norm inside ``update``, 1-based bias correction, weight decay added to
the update (decoupled), fp32 moments. The PyTorch idiom differs in one
way: ``update`` writes the new parameters and moments in place, under
``torch.no_grad()``, and returns the same tensors, where JAX returns new
arrays. The gradients are not modified.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import leaves, tree_map

Tensor = torch.Tensor
Schedule = Callable[[Tensor], Tensor]


class AdamState(NamedTuple):
    step: Tensor    # () int32
    mu: Any         # first moment, same tree as params
    nu: Any         # second moment


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], AdamState]
    update: Callable[[Any, AdamState, Any], Tuple[Any, AdamState]]


def adamw(
    lr,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    clip_norm: Optional[float] = 1.0,
    moment_dtype: torch.dtype = torch.float32,
) -> Optimizer:
    """``lr``: a float or a schedule (step tensor → lr tensor)."""
    lr_fn: Schedule = lr if callable(lr) else (
        lambda step: torch.tensor(lr, dtype=torch.float32,
                                  device=step.device))

    def init(params) -> AdamState:
        device = leaves(params)[0].device
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,  # noqa
                                      device=p.device)
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    @torch.no_grad()
    def update(grads, state: AdamState, params):
        step = state.step + 1
        scale = (_clip_scale(global_norm(grads), clip_norm)
                 if clip_norm is not None else None)
        lr_t = lr_fn(step)
        stepf = step.to(torch.float32)
        c1 = 1.0 - b1 ** stepf
        c2 = 1.0 - b2 ** stepf
        for g, m, v, p in zip(leaves(grads), leaves(state.mu),
                              leaves(state.nu), leaves(params)):
            if scale is not None:
                g = g * scale.to(g.dtype)
            gf = g.to(moment_dtype)
            m.copy_(b1 * m + (1 - b1) * gf)
            v.copy_(b2 * v + (1 - b2) * torch.square(gf))
            delta = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.to(moment_dtype)
            p.copy_((p.to(moment_dtype) - lr_t * delta).to(p.dtype))
        return params, AdamState(step=step, mu=state.mu, nu=state.nu)

    return Optimizer(init=init, update=update)


def adam(lr, **kw) -> Optimizer:
    """Paper §5: plain ADAM (no weight decay)."""
    kw.setdefault("weight_decay", 0.0)
    return adamw(lr, **kw)


@torch.no_grad()
def apply_updates(params, updates):
    """params += updates, in place; returns params."""
    for p, u in zip(leaves(params), leaves(updates)):
        p.add_(u.to(p.dtype))
    return params


def global_norm(tree) -> Tensor:
    """sqrt(Σ x²) over every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


def _clip_scale(norm: Tensor, max_norm: float) -> Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(tree, max_norm: float):
    """A new tree scaled so its global norm is at most ``max_norm``."""
    scale = _clip_scale(global_norm(tree), max_norm)
    return tree_map(lambda x: x * scale.to(x.dtype), tree)
