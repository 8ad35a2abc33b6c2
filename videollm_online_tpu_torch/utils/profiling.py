"""Wall-clock latency summaries.

Counterpart of ``LatencyHistogram`` in ``videollm_online_tpu/utils/profiling.py``
(the JAX profiler helpers there are not carried over).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np


class LatencyHistogram:
    """Per-stage wall-clock samples -> p50/p90/p99 summaries.

    ``max_samples`` bounds per-stage memory for long-running servers
    (a sliding window of the most recent samples; None = unbounded)."""

    def __init__(self, max_samples: Optional[int] = None):
        self.samples: Dict[str, List[float]] = {}
        self.max_samples = max_samples

    @contextlib.contextmanager
    def measure(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(stage, time.perf_counter() - t0)

    def add(self, stage: str, seconds: float):
        xs = self.samples.setdefault(stage, [])
        xs.append(seconds)
        if self.max_samples is not None and len(xs) > 2 * self.max_samples:
            del xs[:-self.max_samples]

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for stage, xs in self.samples.items():
            a = np.asarray(xs)
            out[stage] = {
                "count": int(a.size),
                "mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p90_ms": float(np.percentile(a, 90) * 1e3),
                "p99_ms": float(np.percentile(a, 99) * 1e3),
            }
        return out
