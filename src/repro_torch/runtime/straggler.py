"""Straggler / hang detection from step-time telemetry (the port's own
copy of ``repro/runtime/straggler.py``).

At thousand-node scale the common failure modes are (a) a chip running
slow (thermal, ECC retry storms) and (b) a hung collective. Both show up
first in the step-time series. The detector keeps an EWMA and flags steps
exceeding ``threshold ×`` the smoothed time; a run of consecutive flags
triggers the mitigation callback (at real scale: snapshot + re-mesh
around the slow host — here, the callback is injected by tests and the
training loop records the event).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StragglerDetector:
    alpha: float = 0.2            # EWMA smoothing
    threshold: float = 2.5        # step slower than this × EWMA → flag
    patience: int = 3             # consecutive flags → mitigation
    warmup_steps: int = 2         # ignore compile-dominated first steps
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    ewma: Optional[float] = None
    consecutive: int = 0
    events: List[dict] = dataclasses.field(default_factory=list)
    _seen: int = 0
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> float:
        dt = time.perf_counter() - self._t0
        self.observe(step, dt)
        return dt

    def observe(self, step: int, dt: float) -> bool:
        """Feed one step time; returns True if the step was flagged."""
        self._seen += 1
        if self._seen <= self.warmup_steps:
            return False
        if self.ewma is None:
            self.ewma = dt
            return False
        flagged = dt > self.threshold * self.ewma
        if flagged:
            self.consecutive += 1
            self.events.append(
                {"step": step, "dt": dt, "ewma": self.ewma})
            if self.consecutive >= self.patience and self.on_straggler:
                self.on_straggler(step, dt, self.ewma)
                self.consecutive = 0
        else:
            self.consecutive = 0
            # only update the baseline with healthy steps so a slow
            # patch cannot normalise itself away
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return flagged
