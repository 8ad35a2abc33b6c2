"""Data-side helpers: fps time grids, temporal IoU.

Behavioral equivalents of reference data/utils.py:19-49,115-122.

A copy of what the port's datasets use of ``videollm_online_tpu/data/utils.py``:
the port imports nothing of the JAX package, so it keeps its own."""

from __future__ import annotations

import math
import random
from typing import Sequence


def round_time_by_fps(time: float, fps: float, min_time: float, max_time: float) -> float:
    return min(max(round(time * fps) / fps, min_time), max_time)


def ceil_time_by_fps(time: float, fps: float, min_time: float, max_time: float) -> float:
    return min(max(math.ceil(time * fps) / fps, min_time), max_time)


def floor_time_by_fps(time: float, fps: float, min_time: float, max_time: float) -> float:
    return min(max(math.floor(time * fps) / fps, min_time), max_time)


def rand_bool() -> bool:
    return bool(random.getrandbits(1))


def temporal_iou(region1: Sequence[float], region2: Sequence[float]) -> float:
    area1 = region1[1] - region1[0]
    area2 = region2[1] - region2[0]
    inter = max(0.0, min(region1[1], region2[1]) - max(region1[0], region2[0]))
    union = area1 + area2 - inter
    return inter / union if union else 0.0
