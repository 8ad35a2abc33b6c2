"""Metric logging: a JSONL file plus a line on stdout.

A copy of ``videollm_online_tpu/utils/logging.py`` without its TensorBoard
writer, which comes from ``flax`` (which the port does not import). The
reference reports through HF Trainer (scripts/*: --logging_steps 10); the
JSONL keeps the same records greppable.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricLogger:
    def __init__(self, output_dir: str):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")

    def log(self, step: int, metrics: Dict[str, float]):
        rec = {"step": step, "time": time.time(), **metrics}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"[step {step}] " + " ".join(
            f"{k}={v:.5g}" if isinstance(v, (int, float)) else f"{k}={v}"
            for k, v in metrics.items()), flush=True)

    def log_dict(self, prefix: str, metrics: Dict[str, float],
                 step: int = 0):
        self.log(step, {f"{prefix}/{k}": v for k, v in metrics.items()})
