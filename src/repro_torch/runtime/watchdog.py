"""Fault-tolerance runtime: heartbeats and straggler detection (a copy of
``repro/runtime/watchdog.py``; standard library only).

The host-side signals a restart wrapper consumes:

  * Heartbeat      — train loop touches a file every step; an external
                     watchdog (watch_heartbeat) kills/reforms if it goes
                     stale (hung collective, dead host)
  * StepTimer      — EWMA step-time anomaly detector; flags stragglers
                     (consistently slow steps) so the orchestrator can
                     checkpoint-and-reform.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional


class Heartbeat:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: int):
        with open(self.path, "w") as f:
            f.write(f"{step} {time.time()}")

    def last(self) -> Optional[tuple]:
        try:
            with open(self.path) as f:
                s, t = f.read().split()
            return int(s), float(t)
        except (FileNotFoundError, ValueError):
            return None

    def stale(self, timeout_s: float) -> bool:
        last = self.last()
        return last is None or (time.time() - last[1]) > timeout_s


@dataclasses.dataclass
class StepTimer:
    """EWMA-based straggler/anomaly detector."""
    alpha: float = 0.1
    slow_factor: float = 2.0
    ewma: float = 0.0
    count: int = 0
    slow_steps: int = 0
    _t0: float = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> dict:
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count == 1:
            self.ewma = dt
        slow = dt > self.slow_factor * self.ewma and self.count > 5
        if slow:
            self.slow_steps += 1
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return {"step_time_s": dt, "ewma_s": self.ewma, "straggler": slow}

    def should_reform(self, patience: int = 10) -> bool:
        return self.slow_steps >= patience
