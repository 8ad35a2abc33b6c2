"""Ring attention over the mesh: context (sequence) parallelism.

Counterpart of ``videollm_online_tpu/ops/ring_attention.py``. The SEQUENCE
axis of q/k/v is sharded over a mesh axis; the k/v shards travel around
the ring (``parallel.collectives.ring_shift``, whose backward is the
reverse shift) while each rank accumulates blockwise online-softmax
attention for its local queries: N steps, never the full sequence on one
rank.

Causality across shards: query shard i (global rows i*T_loc..) attends kv
shard j fully when j < i, causally when j == i, and not at all when
j > i, by one comparison of global offsets. The blocks are plain products
with fp32 statistics, as the JAX package computes them (XLA einsums, not a
Pallas kernel); a K2-backed ring block is later work (ROADMAP Queue 2).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel import collectives as coll
from ..parallel.mesh import Mesh

NEG_INF = -1e30


def _block_attn(q, k, v, scale, causal, q_off, k_off):
    """One (local-q x one-kv-shard) block with fp32 online-softmax stats.

    q: (B, H, Tq, d); k/v: (B, H, Tk, d); q_off/k_off are the shards'
    GLOBAL row/col offsets. Returns (unnormalized acc (B, H, Tq, d) f32,
    m, l (B, H, Tq, 1) f32)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        Tq, Tk = q.shape[2], k.shape[2]
        rows = torch.arange(Tq, device=q.device)[:, None] + q_off
        cols = torch.arange(Tk, device=q.device)[None, :] + k_off
        s = torch.where(cols <= rows, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return acc, m, l


def _merge(acc1, m1, l1, acc2, m2, l2):
    """Combine two online-softmax partial results."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    return acc1 * a1 + acc2 * a2, m, l1 * a1 + l2 * a2


def ring_attention(q, k, v, *, mesh: Mesh, axis_name: str,
                   scale: Optional[float] = None, causal: bool = True,
                   batch_axis: Optional[str] = None):
    """Context-parallel attention on this rank's shards q/k/v
    (B, H, T/N, d) of a (B, H, T, d) sequence sharded over ``axis_name``
    (and, with ``batch_axis``, a batch sharded over another axis: the
    local batch is whatever this rank holds). Returns this rank's
    (B, H, T/N, d). Gradients flow through the ring."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    n, idx = mesh.shape[axis_name], mesh.coord(axis_name)
    B, H, T_loc, d = q.shape
    acc = torch.zeros((B, H, T_loc, d), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, T_loc, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, T_loc, 1), dtype=torch.float32, device=q.device)
    for s in range(n):
        src = (idx - s) % n       # whose kv this rank holds at step s
        a_s, m_s, l_s = _block_attn(q, k, v, scale, causal, idx * T_loc,
                                    src * T_loc)
        acc, m, l = _merge(acc, m, l, a_s, m_s, l_s)
        if s + 1 < n:             # rotate kv around the ring
            k = coll.ring_shift(k, mesh, axis_name)
            v = coll.ring_shift(v, mesh, axis_name)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / safe_l).to(q.dtype)


def make_ring_attn(mesh: Mesh, axis_name: str,
                   batch_axis: Optional[str] = None):
    """attn_impl for ``llama.forward``'s full-causal TRAINING path:
    sequence-parallel attention over ``axis_name`` (the forward then keeps
    T/N positions a rank, ``parallel/context.py``). GQA is expanded to
    full heads first; cache-decode shapes go to ``auto_attention``; a
    sliding window is refused."""
    def impl(q, k, v, q_pos, kv_valid_upto, *, num_groups,
             sliding_window=None):
        assert sliding_window is None, (
            "ring attention: sliding window not supported")
        if q.shape[2] != k.shape[2]:
            # cache-decode shapes: SP is the full-causal training forward's
            from .auto import auto_attention
            return auto_attention(q, k, v, q_pos, kv_valid_upto,
                                  num_groups=num_groups,
                                  sliding_window=sliding_window)
        if num_groups > 1:
            k = k.repeat_interleave(num_groups, dim=1)
            v = v.repeat_interleave(num_groups, dim=1)
        return ring_attention(q, k, v, mesh=mesh, axis_name=axis_name,
                              causal=True, batch_axis=batch_axis)
    impl.sequence_axis = axis_name
    return impl


def shard_sequence(x, mesh: Mesh, axis_name: str, axis: int = 2):
    """This rank's block of ``x`` along ``axis`` over ``axis_name``."""
    n, i = mesh.shape[axis_name], mesh.coord(axis_name)
    assert x.shape[axis] % n == 0, (x.shape, axis, n)
    t = x.shape[axis] // n
    return x.narrow(axis, i * t, t)
