"""Training loop (port of ``repro/runtime/train_loop.py``, without
checkpointing).

Beyond calling the step in a loop:

* **failure injection** — ``fail_at_step`` raises after the optimizer
  update of that step;
* **preemption** — ``request_preemption()`` (wired to SIGTERM by the
  launcher) stops the loop at the next step boundary;
* **straggler telemetry** — every step time feeds the EWMA detector.

A step's time ends when its loss reaches the host, which waits for the
whole step, optimizer update included (JAX's ``block_until_ready``).
``checkpoint/manager.py`` is not ported (ROADMAP queue A, rest of
serving), so a ``ckpt_dir`` raises.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.runtime.straggler import StragglerDetector

log = logging.getLogger(__name__)


class InjectedFailure(RuntimeError):
    """Raised by the failure-injection hook (tests / chaos drills)."""


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None       # raises: not ported
    log_every: int = 10
    fail_at_step: Optional[int] = None   # failure injection


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
        if config.ckpt_dir:
            raise NotImplementedError(
                "checkpointing is not ported: checkpoint/manager.py waits in "
                "ROADMAP queue A (rest of serving, with the fleet)")
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

    def request_preemption(self) -> None:
        """SIGTERM handler target: stop at the next boundary."""
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
            if self._preempted:
                log.warning("preempted at step %d", self.step)
                break
            if cfg.fail_at_step is not None and self.step == cfg.fail_at_step:
                raise InjectedFailure(f"injected failure at {self.step}")
        return {
            "params": self.params,
            "opt_state": self.opt_state,
            "step": self.step,
            "metrics": self.metrics_history,
            "straggler_events": self.detector.events,
        }
