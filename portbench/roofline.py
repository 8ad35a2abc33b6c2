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
operations 4 d per visible (query, key) pair.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .weights import attention_window

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


# ------------------------------------------------------------ model FLOPs
def matrix_params(c: Dict) -> Dict[str, int]:
    """Weights of one decoder layer's matrices, and of the head."""
    D, F, d = c["hidden_size"], c["intermediate_size"], c["head_dim"]
    q, kv = c["num_attention_heads"] * d, c["num_key_value_heads"] * d
    return {"layer": D * q + 2 * D * kv + q * D + 3 * D * F,
            "head": D * c["vocab_size"]}


def serve_forward_flops(c: Dict, num_valid: Sequence[int],
                        offsets: Sequence[int], head_rows: int) -> float:
    """Operations a serving forward must do: 2 per weight per valid token
    in every layer, the head only on the rows whose logits are taken, and
    attention (4 d a visible pair a query head) for the valid queries.
    Padding rows, the embedding gather, norms, rope and the connector (under
    0.3 % of a frame's operations) are left out."""
    L, Hq, d = (c["num_hidden_layers"], c["num_attention_heads"],
                c["head_dim"])
    w = attention_window(c)
    p = matrix_params(c)
    nv = np.asarray(num_valid, np.int64)
    off = np.asarray(offsets, np.int64)
    pairs = sum(int(visible(o + np.arange(n), w).sum())
                for o, n in zip(off, nv) if n)
    return (2.0 * p["layer"] * L * int(nv.sum()) + 4.0 * d * Hq * L * pairs
            + 2.0 * p["head"] * head_rows)

