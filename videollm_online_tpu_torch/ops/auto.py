"""Attention dispatch by call shape.

Counterpart of ``videollm_online_tpu/ops/auto.py``. One adapter with the
``models.llama._attention`` signature, plus its cache-resident ``layered``
form:
  * on CUDA, a query chunk of at most 64 tokens with d in {64, 128, 256}
    goes to the ring decode attention kernel (K1);
  * everything else (chunks over 64 tokens, other head sizes, any CPU
    tensor) takes the plain ``_attention``, as the JAX package sends them
    to XLA off the TPU.
"""

from __future__ import annotations

import torch

from .decode_attention import (HEAD_DIMS, ring_decode_attention,
                               ring_decode_attention_layered)

MAX_DECODE_CHUNK = 64


def _takes_kernel(q) -> bool:
    return (q.is_cuda and q.shape[2] <= MAX_DECODE_CHUNK
            and q.shape[3] in HEAD_DIMS)


def auto_attention(q, k, v, q_pos, kv_valid_upto, *, num_groups,
                   sliding_window=None, k_scale=None, v_scale=None):
    from ..models.llama import _attention
    if _takes_kernel(q):
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
    if _takes_kernel(q):
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
