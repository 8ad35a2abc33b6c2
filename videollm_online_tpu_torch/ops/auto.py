"""Attention dispatch by call shape.

Counterpart of ``videollm_online_tpu/ops/auto.py``. One adapter with the
``models.llama._attention`` signature, plus its cache-resident ``layered``
form. ``route`` decides, in the JAX package's order (auto.py:36-44), for a
CUDA tensor with d in {64, 128, 256}:
  * full causal self-attention (no int8 K/V, T == S, T % 128 == 0: the
    training and cache-free forward, positions 0..T-1) goes to flash
    attention (K2), with its backward;
  * a query chunk of at most 64 tokens goes to the ring decode attention
    kernel (K1);
  * everything else (longer ragged chunks, other head sizes, any CPU
    tensor) takes the plain ``_attention``, as the JAX package sends them
    to XLA off the TPU.
"""

from __future__ import annotations

import torch

from .decode_attention import (HEAD_DIMS, ring_decode_attention,
                               ring_decode_attention_layered)
from .flash_attention import flash_attention

MAX_DECODE_CHUNK = 64


def route(q, k, k_scale=None) -> str:
    """"flash", "decode" or "plain" for q (B, Hq, T, d) against k
    (B, Hkv, S, d)."""
    T, S, d = q.shape[2], k.shape[2], q.shape[3]
    if not q.is_cuda or d not in HEAD_DIMS:
        return "plain"
    if k_scale is None and T == S and T % 128 == 0:
        return "flash"
    return "decode" if T <= MAX_DECODE_CHUNK else "plain"


def auto_attention(q, k, v, q_pos, kv_valid_upto, *, num_groups,
                   sliding_window=None, k_scale=None, v_scale=None):
    from ..models.llama import _attention
    kind = route(q, k, k_scale)
    if kind == "flash":
        # the JAX package's scale: a Python float, rounded to fp32 in-kernel
        return flash_attention(q, k, v, 1.0 / q.shape[3] ** 0.5, True, 0,
                               window=sliding_window)
    if kind == "decode":
        return ring_decode_attention(q, k.contiguous(), v.contiguous(),
                                     q_pos.to(torch.int32).contiguous(),
                                     window=sliding_window, k_scale=k_scale,
                                     v_scale=v_scale)
    return _attention(q, k, v, q_pos, kv_valid_upto, num_groups=num_groups,
                      sliding_window=sliding_window, k_scale=k_scale,
                      v_scale=v_scale)


def _auto_layered(q, k_all, v_all, q_pos, layer, *, num_groups,
                  sliding_window=None, k_scale=None, v_scale=None):
    """Reads the stacked (L, B, Hkv, C, d) ring at ``layer``; the kernel
    touches only the visible tiles of that layer."""
    if (q.is_cuda and q.shape[2] <= MAX_DECODE_CHUNK
            and q.shape[3] in HEAD_DIMS):
        return ring_decode_attention_layered(
            q, k_all, v_all, q_pos, layer, window=sliding_window,
            k_scale=k_scale, v_scale=v_scale)
    from ..models.llama import _attention
    sc = {}
    if k_scale is not None:
        sc = {"k_scale": k_scale[layer], "v_scale": v_scale[layer]}
    return _attention(q, k_all[layer], v_all[layer], q_pos, None,
                      num_groups=num_groups, sliding_window=sliding_window,
                      **sc)


auto_attention.layered = _auto_layered


def resolve_attn_impl(name: str):
    """``--attn_implementation`` -> the attention the forward calls (JAX
    ``ops/auto.py:78``): 'auto', 'pallas' and 'pallas_flash' dispatch by
    shape (``auto_attention``); 'xla' is the plain attention (None, the
    forward's default). 'sp_ring' and 'sp_ulysses' pass through as
    strings: they need the mesh, so ``LiveTrainer`` binds them to its model
    axis (``ops/ring_attention.py``, ``ops/ulysses_attention.py``)."""
    if name in ("auto", "pallas", "pallas_flash"):
        return auto_attention
    if name in ("sp_ring", "sp_ulysses"):
        return name
    return None
