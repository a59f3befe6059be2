"""Straggler detection for long training runs: a step-time monitor that
flags a step whose wall time stands out from its recent window, and a
stopwatch around one step.

A controller reads the flags to exclude a slow host or to restart from the
latest checkpoint; here the detector is the reference's, step for step.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Callable, Deque, List, Optional

import torch


@dataclass
class StepTimeMonitor:
    """Flags a step whose time lies more than ``zscore_threshold`` standard
    deviations (at least 1% of the mean) above the mean of the last
    ``window`` steps, once ``warmup_steps`` steps are in the window;
    ``on_anomaly(step, seconds, mean)`` hears of each flag."""
    window: int = 50
    zscore_threshold: float = 4.0
    warmup_steps: int = 5
    on_anomaly: Optional[Callable[[int, float, float], None]] = None
    _times: Deque[float] = field(default_factory=collections.deque)
    _step: int = 0
    anomalies: List[int] = field(default_factory=list)

    def record(self, step_seconds: float) -> bool:
        """Record one step's wall time; True if flagged as a straggler."""
        self._step += 1
        flagged = False
        if len(self._times) >= self.warmup_steps:
            mean = sum(self._times) / len(self._times)
            var = sum((t - mean) ** 2 for t in self._times) / len(self._times)
            std = max(var ** 0.5, 1e-6, 0.01 * mean)
            z = (step_seconds - mean) / std
            if z > self.zscore_threshold:
                flagged = True
                self.anomalies.append(self._step)
                if self.on_anomaly:
                    self.on_anomaly(self._step, step_seconds, mean)
        self._times.append(step_seconds)
        while len(self._times) > self.window:
            self._times.popleft()
        return flagged


def block_until_ready(t: torch.Tensor) -> torch.Tensor:
    """Wait for the work that produces ``t``: on a GPU, its device's
    current stream, so that a step timed around it ends when the step
    does (the CPU runs eagerly)."""
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return t


class Stopwatch:
    """``with Stopwatch() as sw: ...``, then ``sw.seconds``: the host
    clock around the block (end the block in :func:`block_until_ready` to
    time device work)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.seconds = time.perf_counter() - self.t0
