"""Peaks of the card, and the operations and bytes the work needs, counted
from shapes.

The peaks are NVIDIA's data sheet for one H100 SXM at its 700 W power
limit: 989 TFLOP/s dense bf16 on the tensor cores and 3.35 TB/s of HBM. A
card set below 700 W runs slower under load, so every share is reported
with the card's ``power.limit`` beside it. A kernel's least time is the
larger of its operations over the peak rate and its bytes over the
bandwidth; its bound kind says which.

K3's counts follow the bound arithmetic of ``chip_smoke.py`` (phase 13),
copied here: K/V bytes for the visible slots only, q and out once,
operations 4 d per visible (query, key) pair. Every family whose attention
runs K3 counts it here; what a whole forward needs, and which kernels it
calls, is the family's (``families/<family>.py``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def least_time(flops: float, nbytes: float) -> Tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def visible(q_pos: np.ndarray, window: Optional[int]) -> np.ndarray:
    """Keys a query at slot ``q_pos`` sees: slots (q_pos - window, q_pos]."""
    v = np.asarray(q_pos, np.int64) + 1
    return v if window is None else np.minimum(v, window)


# ------------------------------------------------------------------ K3
def k3_call(offsets: Sequence[int], S: int, Hq: int, Hkv: int, d: int,
            window: Optional[int], kv_bytes: float = 2.0,
            q_bytes: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of one K3 call (one layer) for the B streams
    with valid tokens in it, whose S queries sit at slots offsets[b] ..
    offsets[b] + S - 1 (a stream with no valid token is left out by the
    caller; a valid stream's S rows are all counted, as the kernel computes
    every row of a stream it reads). Bytes: each
    stream's K and V over the union of its queries' visible slots, q and
    out, the positions and the page table's rows are left out (under 0.1 %
    here)."""
    off = np.asarray(offsets, np.int64)
    last = off + S - 1
    first = (np.zeros_like(off) if window is None
             else np.maximum(off - window + 1, 0))
    slots = int((last - first + 1).sum())
    q_pos = off[:, None] + np.arange(S)[None]
    pairs = int(visible(q_pos, window).sum())
    B = len(off)
    flops = 4.0 * d * Hq * pairs
    nbytes = 2.0 * slots * Hkv * d * kv_bytes + 2.0 * B * Hq * S * d * q_bytes
    return flops, nbytes
