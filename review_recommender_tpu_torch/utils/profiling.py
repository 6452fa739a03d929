"""Observability: per-stage timers, rolling latency stats, profiler hooks.

Counterparts of `review_recommender_tpu/utils/profiling.py` (that package's
`__init__` loads jax):

  StageTimer    with-block timing of named stages -> dict. Stages that end
                in a device->host copy include the device time; others
                time the enqueue only.
  LatencyStats  rolling reservoir of request latencies -> p50/p95/p99/qps
  device_trace  torch.profiler around a block, written as a Chrome trace
                (CUDA kernels included when a card is present)
  annotate      a named range in that trace
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator

import numpy as np
import torch


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


class LatencyStats:
    """Rolling reservoir of request latencies with percentile summary."""

    def __init__(self, capacity: int = 4096):
        self._buf = np.zeros(capacity, np.float64)
        self._n = 0
        self._start = time.perf_counter()
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._buf[self._n % len(self._buf)] = seconds
            self._n += 1

    def summary(self) -> Dict[str, float]:
        with self._lock:
            n = min(self._n, len(self._buf))
            if n == 0:
                return {"count": 0}
            lat = np.sort(self._buf[:n])
            elapsed = time.perf_counter() - self._start
            return {
                "count": self._n,
                "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 3),
                "p95_ms": round(float(np.percentile(lat, 95)) * 1e3, 3),
                "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 3),
                "mean_ms": round(float(lat.mean()) * 1e3, 3),
                "qps": round(self._n / elapsed, 2) if elapsed > 0 else 0.0,
            }


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: str, *, host_profile: bool = False) -> Iterator[None]:
    """torch.profiler around a block, exported to `log_dir`/trace.json
    (open it in Perfetto or chrome://tracing). CUDA activity is recorded
    when CUDA is available; host_profile adds input shapes and Python
    stacks. A profiler that cannot start raises."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, record_shapes=host_profile,
                 with_stack=host_profile) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named range in the device trace (torch.profiler.record_function)."""
    with torch.profiler.record_function(name):
        yield
