"""Training driver for the paper's QA experiment, Figure 1 (port of
``repro/qa/train.py``).

The same draws as the JAX driver: training batches ``task.batch(
cfg.batch_size, step=i)``, one held-out validation batch of 256 at
``step=10_000_000``, plain Adam at ``cfg.lr`` (``optim.adam``: b2 0.95,
clipping at global norm 1, as JAX's), and the validation loss and
accuracy after the first step and every ``eval_every`` steps. The
parameters come from ``torch.Generator(seed)`` unless given.

``train_qa`` runs on CUDA unless ``device`` says otherwise, and raises
when CUDA is missing (``device.resolve_device``).

  PYTHONPATH=src python -c "from repro_torch.qa import train_qa; \\
      print(train_qa('linear', steps=3, device='cpu'))"
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Union

import torch

from repro_torch.configs.paper_qa import QAConfig
from repro_torch.data.cloze import ClozeBatch, ClozeTask
from repro_torch.device import resolve_device
from repro_torch.optim import Optimizer, adam
from repro_torch.qa.model import QAModel
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass
class TrainResult:
    attention: str
    steps: List[int]
    val_acc: List[float]
    val_loss: List[float]

    @property
    def final_acc(self) -> float:
        return self.val_acc[-1]

    @property
    def best_acc(self) -> float:
        return max(self.val_acc)

    def steps_to_acc(self, target: float) -> int:
        """First step at which validation accuracy ≥ target (-1 if never),
        Figure 1's convergence-speed claim."""
        for s, a in zip(self.steps, self.val_acc):
            if a >= target:
                return s
        return -1


def put_batch(batch: ClozeBatch, device: torch.device) -> ClozeBatch:
    """A numpy ``ClozeBatch`` as int64 tensors on ``device``."""
    return ClozeBatch(*(torch.from_numpy(x).long().to(device)
                        for x in batch))


def make_step(model: QAModel, optimizer: Optimizer) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, loss, grads): one
    Adam step on the batch's loss, the parameters and moments updated in
    place (``optim.adamw``)."""

    def step(params, opt_state, batch: ClozeBatch):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss, _ = model.loss_and_acc(params, batch)
        grads = iter(torch.autograd.grad(loss, flat))
        grads = tree_map(lambda _: next(grads), params)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, loss.detach(), grads

    return step


def train_qa(
    attention: str,
    *,
    steps: int = 400,
    eval_every: int = 40,
    seed: int = 0,
    cfg: Optional[QAConfig] = None,
    task: Optional[ClozeTask] = None,
    device: Optional[Union[str, torch.device]] = None,
    params: Optional[Dict] = None,
) -> TrainResult:
    """Train one variant; ``params`` (e.g. JAX's, through
    ``convert.qa_params_from_jax``) replaces the seeded init and is
    updated in place."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg or QAConfig(attention=attention),
                              attention=attention)
    task = task or ClozeTask(seed=seed + 1)

    model = QAModel(cfg)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    optimizer = adam(cfg.lr)
    opt_state = optimizer.init(params)
    step = make_step(model, optimizer)

    val = put_batch(task.batch(256, step=10_000_000), dev)
    result = TrainResult(attention=attention, steps=[], val_acc=[],
                         val_loss=[])
    for i in range(steps):
        params, opt_state, _, _ = step(
            params, opt_state,
            put_batch(task.batch(cfg.batch_size, step=i), dev))
        if (i + 1) % eval_every == 0 or i == 0:
            with torch.no_grad():
                vloss, vacc = model.loss_and_acc(params, val)
            result.steps.append(i + 1)
            result.val_acc.append(vacc.item())
            result.val_loss.append(vloss.item())
    return result


def run_figure1(steps: int = 400, seed: int = 0,
                device: Optional[Union[str, torch.device]] = None
                ) -> Dict[str, TrainResult]:
    """Train the four variants of Figure 1 on the same data."""
    return {att: train_qa(att, steps=steps, seed=seed, device=device)
            for att in ("none", "linear", "gated_linear", "softmax")}
