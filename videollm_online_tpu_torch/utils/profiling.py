"""Wall-clock latency summaries and the spans that feed them.

Counterpart of ``LatencyHistogram`` in
``videollm_online_tpu/utils/profiling.py`` (the JAX profiler helpers there
are not carried over). ``measure(stage)`` is also a span on
``torch.profiler``'s timeline while a profiler records.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
from torch.autograd import profiler as _profiler


class _Span:
    """``LatencyHistogram.measure``'s context: the body's wall-clock seconds
    go to the histogram under ``stage``; while ``torch.profiler`` records,
    the body is also a ``record_function(stage)`` range (a
    ``user_annotation`` on the trace's clock, beside the device's events).
    With no profiler on, no ``record_function`` or dispatcher call is
    made."""

    __slots__ = ("_hist", "_stage", "_t0", "_rf")

    def __init__(self, hist: "LatencyHistogram", stage: str):
        self._hist, self._stage, self._rf = hist, stage, None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self._stage)
            self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.add(self._stage, time.perf_counter() - self._t0)
        if self._rf is not None:
            rf, self._rf = self._rf, None
            rf.__exit__(*exc)
        return False


class LatencyHistogram:
    """Per-stage wall-clock samples -> p50/p90/p99 summaries.

    ``max_samples`` bounds per-stage memory for long-running servers
    (a sliding window of the most recent samples; None = unbounded)."""

    def __init__(self, max_samples: Optional[int] = None):
        self.samples: Dict[str, List[float]] = {}
        self.max_samples = max_samples

    def measure(self, stage: str) -> _Span:
        """``with hist.measure(stage): ...`` times the body as one sample
        of ``stage`` (and names it on a running profiler's trace)."""
        return _Span(self, stage)

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
