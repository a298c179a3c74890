"""Fault-tolerant training loop (port of ``repro/runtime/train_loop.py``).

Beyond calling the step in a loop:

* **auto-resume**: on construction, restore the newest checkpoint in
  ``ckpt_dir`` if there is one (parameters, AdamState and the step; the
  datasets are pure functions of the step), so a preempted or killed job
  relaunches into the exact step it lost. The restored values are copied
  into the live tensors, which the in-place AdamW update then owns.
* **periodic and preemption checkpoints**: async saves every
  ``ckpt_every`` steps and a blocking one at the last step;
  ``request_preemption()`` (wired to SIGTERM by the launcher) forces a
  blocking save at the next step boundary and stops.
* **failure injection**: ``fail_at_step`` raises after that step's
  update and its checkpoint, so tests can prove that a crash and a
  relaunch reproduce the uninterrupted run bit for bit.
* **straggler telemetry**: every step time feeds the EWMA detector.

A step's time ends when its loss reaches the host, which waits for the
whole step, optimizer update included (JAX's ``block_until_ready``); the
checkpoint's host copy comes after it.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.runtime.straggler import StragglerDetector
from repro_torch.sharding import mixed_for
from repro_torch.tree import leaves

log = logging.getLogger(__name__)


class InjectedFailure(RuntimeError):
    """Raised by the failure-injection hook (tests / chaos drills)."""


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep: int = 3
    log_every: int = 10
    fail_at_step: Optional[int] = None   # failure injection
    async_ckpt: bool = True


class TrainLoop:
    def __init__(
        self,
        step_fn: Callable,                   # (params, opt, batch) -> ...
        params: Any,
        opt_state: Any,
        dataset: Any,                        # has .batch_at(step)
        config: TrainLoopConfig,
        put_batch: Optional[Callable] = None,  # host batch -> device batch
    ):
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.dataset = dataset
        self.config = config
        self.put_batch = put_batch or (
            lambda b: {k: torch.from_numpy(v) for k, v in b.items()})
        self.step = 0
        self.metrics_history: List[Dict[str, float]] = []
        self.detector = StragglerDetector()
        self._preempted = False

        self.ckpt: Optional[CheckpointManager] = None
        if config.ckpt_dir:
            self.ckpt = CheckpointManager(config.ckpt_dir, keep=config.keep)
            if self.ckpt.has_checkpoint():
                state = self._state()
                restored, extra, step = self.ckpt.restore(state)
                # on a mesh each rank keeps its block of the whole array
                with torch.no_grad(), mixed_for(state):
                    for live, new in zip(leaves(state), leaves(restored)):
                        live.copy_(new)
                self.step = int(extra.get("step", step))
                log.info("auto-resumed from step %d", self.step)

    def _state(self) -> Dict[str, Any]:
        return {"params": self.params, "opt": self.opt_state}

    def request_preemption(self) -> None:
        """SIGTERM handler target: checkpoint at the next boundary."""
        self._preempted = True

    def run(self) -> Dict[str, Any]:
        cfg = self.config
        while self.step < cfg.total_steps:
            batch = self.put_batch(self.dataset.batch_at(self.step))
            self.detector.start()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            loss = metrics["loss"].item()        # waits for the step
            dt = self.detector.stop(self.step)
            self.step += 1

            host = {k: float(v) for k, v in metrics.items()}
            host["loss"] = loss
            host["step_time"] = dt
            self.metrics_history.append(host)
            if self.step % cfg.log_every == 0:
                log.info("step %d loss %.4f (%.0f ms)", self.step, loss,
                         dt * 1e3)
            if self.ckpt and (self.step % cfg.ckpt_every == 0
                              or self.step == cfg.total_steps
                              or self._preempted):
                self.ckpt.save(
                    self.step, self._state(), extra={"step": self.step},
                    blocking=(self._preempted
                              or self.step == cfg.total_steps
                              or not cfg.async_ckpt))
            if self._preempted:
                log.warning("preemption checkpoint at step %d", self.step)
                break
            if cfg.fail_at_step is not None and self.step == cfg.fail_at_step:
                raise InjectedFailure(f"injected failure at {self.step}")
        if self.ckpt:
            self.ckpt.wait()
        return {
            "params": self.params,
            "opt_state": self.opt_state,
            "step": self.step,
            "metrics": self.metrics_history,
            "straggler_events": self.detector.events,
        }
