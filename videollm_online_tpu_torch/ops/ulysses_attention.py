"""Ulysses sequence parallelism: an all-to-all head/sequence repartition.

Counterpart of ``videollm_online_tpu/ops/ulysses_attention.py``.
Activations enter SEQUENCE-sharded (B, H, T/N, d) a rank; one all-to-all
per operand (``parallel.collectives.all_to_all``, whose backward is the
reverse all-to-all) repartitions them HEAD-sharded (B, H/N, T, d); each
rank runs ordinary full-sequence attention on its head slice, and one
reverse all-to-all restores sequence sharding on the output. Against the
ring: two all-to-alls in all and one monolithic attention (K2 on the
card), but each rank holds H/N * T, so it needs H >= N.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel import collectives as coll
from ..parallel.mesh import Mesh


def _local_full_attn(q, k, v, scale, causal):
    """Full attention on the rank's head slice (B, Hl, T, d): flash
    attention (K2f forward, K2b/K2q backward) on a CUDA tensor when causal
    with T % 128 == 0 and d in {64, 128, 256}, the JAX package's
    condition; elsewhere the plain product."""
    T, d = q.shape[2], q.shape[3]
    if q.is_cuda and causal and T % 128 == 0 and d in (64, 128, 256):
        from .flash_attention import flash_attention
        return flash_attention(q, k, v, scale, True, 0)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        rows = torch.arange(T, device=q.device)[:, None]
        cols = torch.arange(T, device=q.device)[None, :]
        s = torch.where(cols <= rows, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(q.dtype), v)


def ulysses_attention(q, k, v, *, mesh: Mesh, axis_name: str,
                      scale: Optional[float] = None, causal: bool = True,
                      batch_axis: Optional[str] = None):
    """Sequence-parallel attention on this rank's shards q/k/v
    (B, H, T/N, d) of a sequence sharded over ``axis_name``; returns this
    rank's (B, H, T/N, d). Needs H % N == 0 (each rank computes at least
    one whole head). Gradients flow through the all-to-alls."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    n = mesh.shape[axis_name]
    assert q.shape[1] % n == 0, (
        f"Ulysses needs heads {q.shape[1]} divisible by axis {axis_name}={n} "
        "(use ops.ring_attention for head-poor, sequence-rich shapes)")
    # heads scatter, sequence gather: (B, H, T/N, d) -> (B, H/N, T, d)
    qh, kh, vh = (coll.all_to_all(x, mesh, axis_name, 1, 2)
                  for x in (q, k, v))
    oh = _local_full_attn(qh, kh, vh, scale, causal)
    # heads gather, sequence scatter: back to (B, H, T/N, d)
    return coll.all_to_all(oh, mesh, axis_name, 2, 1)


def make_ulysses_attn(mesh: Mesh, axis_name: str,
                      batch_axis: Optional[str] = None):
    """attn_impl for ``llama.forward``'s full-causal TRAINING path:
    Ulysses over ``axis_name`` (the forward keeps T/N positions a rank).
    GQA kv heads are expanded to the query heads first so the head
    all-to-all is uniform; cache-decode shapes go to ``auto_attention``."""
    def impl(q, k, v, q_pos, kv_valid_upto, *, num_groups,
             sliding_window=None):
        assert sliding_window is None, (
            "ulysses attention: sliding window not supported")
        if q.shape[2] != k.shape[2]:
            from .auto import auto_attention
            return auto_attention(q, k, v, q_pos, kv_valid_upto,
                                  num_groups=num_groups,
                                  sliding_window=sliding_window)
        if num_groups > 1:
            k = k.repeat_interleave(num_groups, dim=1)
            v = v.repeat_interleave(num_groups, dim=1)
        return ulysses_attention(q, k, v, mesh=mesh, axis_name=axis_name,
                                 causal=True, batch_axis=batch_axis)
    impl.sequence_axis = axis_name
    return impl
