"""Per-stage wall-clock timer.

A jax-free copy of `StageTimer` from `review_recommender_tpu/utils/
profiling.py` (that package's `__init__` loads jax). Stages that end in a
device->host copy include the device time; others time the enqueue only.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator


class StageTimer:
    """Accumulates wall-clock per named stage."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_ms": round(self.totals[name] * 1e3, 3),
                "count": self.counts[name],
                "mean_ms": round(self.totals[name] / self.counts[name] * 1e3, 3),
            }
            for name in self.totals
        }
