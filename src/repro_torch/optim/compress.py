"""Gradient compression with error feedback (port of
``repro/optim/compress.py``).

Casting gradients to bf16 before a data-parallel reduction halves the
bytes on the wire; the rounding error is kept in a per-parameter fp32
residual and added back at the next step (error feedback), which keeps
convergence unaffected to first order. As in the JAX package, nothing
wires ``ErrorFeedback`` into the train step: ``runtime/steps.py``'s
``grad_compress`` rounds the gradients through bf16 without a residual.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_map


def compress_bf16(grads: Any) -> Any:
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def decompress_bf16(grads: Any) -> Any:
    return tree_map(lambda g: g.to(torch.float32), grads)


class ErrorFeedback(NamedTuple):
    residual: Any  # fp32 tree, same structure as grads

    @classmethod
    def init(cls, params) -> "ErrorFeedback":
        return cls(residual=tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params))

    def compress(self, grads) -> Tuple[Any, "ErrorFeedback"]:
        """Returns (bf16 grads to reduce, the updated residual)."""
        corrected = tree_map(lambda g, r: g.to(torch.float32) + r, grads,
                             self.residual)
        compressed = compress_bf16(corrected)
        new_residual = tree_map(lambda c, q: c - q.to(torch.float32),
                                corrected, compressed)
        return compressed, ErrorFeedback(residual=new_residual)
