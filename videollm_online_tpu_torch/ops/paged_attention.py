"""Paged decode attention (K3): per-stream page tables over a shared KV pool.

Counterpart of ``videollm_online_tpu/ops/paged_attention.py``. Batched
multi-stream serving keeps every stream's K/V in pages of one pool
(``models.llama.PagedKVCache``); stream b's logical slot j lives at
``pool[layer, table[b, j // page], :, j % page]``. On a CUDA tensor
``paged_decode_attention`` launches the hand-written kernel in
``csrc/paged_attention.cu``; on a CPU tensor it takes the plain PyTorch
version beside it (``paged_attention_reference``), which is also what the
kernel is held against on the card. K3 runs K1's kernels
(``csrc/attention_common.cuh``) over the pool, so its design choice and
schedule are K1's (``ops/decode_attention.py``: ``kernel_design``,
``row_blocks``, ``num_splits``, ``visible_slots``, ``split_ranges``), with
a stream's slots counted over its page table; ``tile_rows`` mirrors its
page lookup.

Layouts are the JAX package's: q (B, Hq, S, d), pools (L, P, Hkv, page, d),
table (B, MAXP) int32, q_pos (B, S) int32 slot-relative positions, and for
int8 K/V fp32 (L, P, Hkv, page) scale pools paged like the codes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from . import _build
from .decode_attention import (BLOCK_K, DESIGNS, HEAD_DIMS,  # noqa: F401
                               kernel_design, num_splits, ptr, row_blocks,
                               schedule, split_ranges, visible_slots)

NEG_INF = -1e30


def paged_attention_reference(q, pool_k, pool_v, table, q_pos, layer: int, *,
                              window: Optional[int] = None, k_scale=None,
                              v_scale=None):
    """Plain PyTorch version, the JAX package's gather reference: each
    stream's logical K/V gathered from its pages (int8 codes times their
    scales), then masked attention in fp32. A row with nothing visible
    outputs 0, as the kernel does (the JAX reference averages every slot
    there)."""
    B, Hq, S, d = q.shape
    _, _, Hkv, page, _ = pool_k.shape
    maxp = table.shape[1]
    G = Hq // Hkv
    tab = table.to(q.device).long()

    def gather(pool):          # (P, Hkv, page[, d]) -> (B, Hkv, maxp*page[, d])
        g = pool[layer][tab].transpose(1, 2)
        return g.reshape((B, Hkv, maxp * page) + g.shape[4:])

    kg, vg = gather(pool_k).float(), gather(pool_v).float()
    if k_scale is not None:
        kg = kg * gather(k_scale)[..., None]
        vg = vg * gather(v_scale)[..., None]
    qf = q.float().reshape(B, Hkv, G * S, d)
    s = torch.matmul(qf, kg.transpose(-1, -2)) / torch.sqrt(
        torch.tensor(d, dtype=torch.float32))
    slot = torch.arange(maxp * page, device=q.device)
    qp = q_pos.to(q.device).long().repeat(1, G)[:, None, :, None]
    mask = slot <= qp
    if window is not None:
        mask = mask & (slot > qp - window)
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    p = p * mask.any(-1, keepdim=True)
    o = torch.matmul(p, vg)
    return o.reshape(B, Hq, S, d).to(q.dtype)


def tile_rows(table_row: Sequence[int], page: int, slot0: int, lo: int,
              hi: int, design: str = "tensor cores"
              ) -> List[Optional[Tuple[int, int]]]:
    """(pool page, row in the page) that each row of the tile at slot0
    loads from one stream's table, as the kernel looks it up (one lookup a
    row, or one a tile when the tile lies in one page); None where the row
    is outside the visible slots [lo, hi], zero-filled and not read."""
    bk = BLOCK_K[design]
    aligned = design == "tensor cores" and page % bk == 0
    base = (table_row[slot0 // page], slot0 % page)
    out = []
    for r in range(bk):
        slot = slot0 + r
        if not lo <= slot <= hi:
            out.append(None)
        elif aligned:
            out.append((base[0], base[1] + r))
        else:
            out.append((table_row[slot // page], slot % page))
    return out


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/paged_attention.cu, built at first use."""
    fn = _build.load("paged_attention").k3_paged_decode_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 15
                   + [ctypes.c_void_p])
    return fn


def _launch(q, pool_k, pool_v, table, q_pos, layer, window, k_scale,
            v_scale):
    B, Hq, S, d = q.shape
    L, P, Hkv, page, dk = pool_k.shape
    maxp = table.shape[1] if table.dim() == 2 else -1
    quant = k_scale is not None
    tensors = [q, pool_k, pool_v, table, q_pos] + (
        [k_scale, v_scale] if quant else [])
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("paged decode attention: every tensor must be on "
                         "q's CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged decode attention: tensors must be "
                         "contiguous")
    if any(t.data_ptr() % 16 for t in (q, pool_k, pool_v)):
        raise ValueError("paged decode attention: q and the pools must be "
                         "16-byte aligned (the kernel loads 16 bytes a lane)")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    if pool_v.dtype != pool_k.dtype or pool_v.shape != pool_k.shape:
        raise ValueError("pool_k and pool_v must share shape and dtype")
    if quant:
        if pool_k.dtype != torch.int8 or v_scale is None:
            raise TypeError("scales need int8 pools and both scale pools")
        for sc in (k_scale, v_scale):
            if sc.dtype != torch.float32 or sc.shape != (L, P, Hkv, page):
                raise ValueError(f"scale pools must be float32 "
                                 f"{(L, P, Hkv, page)}")
    elif pool_k.dtype != q.dtype:
        raise TypeError(f"pools {pool_k.dtype} must match q {q.dtype} "
                        f"(or be int8 with scales)")
    if dk != d or Hq % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} vs pool "
                         f"{tuple(pool_k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"kernel takes d in {HEAD_DIMS}, got {d}")
    if table.dtype != torch.int32 or table.shape != (B, maxp):
        raise ValueError(f"table must be int32 (B={B}, MAXP)")
    if q_pos.dtype != torch.int32 or q_pos.shape != (B, S):
        raise ValueError(f"q_pos must be int32 {(B, S)}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    if window is not None and int(window) <= 0:
        raise ValueError(f"window must be positive, got {window}")
    rows = (Hq // Hkv) * S
    design, slices, nsplit, part_acc, part_ml = schedule(
        q.device, q.dtype, B, Hkv, rows, d, maxp * page)
    out = torch.empty_like(q)
    err = _kernel()(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), ptr(k_scale),
        ptr(v_scale), table.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        ptr(part_acc), ptr(part_ml), B, Hkv, S, rows, d, P, page, maxp,
        int(layer), int(window) if window is not None else 0, nsplit,
        1 if q.dtype == torch.bfloat16 else 0, 1 if quant else 0,
        DESIGNS.index(design), slices,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"k3_paged_decode_attention launch failed: CUDA "
                           f"error {err}")
    paged_decode_attention.launches += 1
    return out


def paged_decode_attention(q, pool_k, pool_v, table, q_pos, layer: int, *,
                           window: Optional[int] = None, k_scale=None,
                           v_scale=None):
    """Attention of q (B, Hq, S, d) over layer ``layer`` of each stream's
    pages: slot j of stream b is visible iff j <= q_pos (and, with
    ``window``, j > q_pos - window). A CUDA tensor launches K3, which reads
    only the pages between each stream's first and last visible slot, or
    raises (d outside ``HEAD_DIMS``, a wrong dtype or layout); a CPU tensor
    takes the plain version. Returns (B, Hq, S, d) in q's dtype."""
    if not q.is_cuda:
        return paged_attention_reference(q, pool_k, pool_v, table, q_pos,
                                         layer, window=window,
                                         k_scale=k_scale, v_scale=v_scale)
    return _launch(q, pool_k, pool_v, table, q_pos, layer, window, k_scale,
                   v_scale)


paged_decode_attention.launches = 0


def paged_attention(q, pool_k, pool_v, table, q_pos, layer: int, *,
                    window: Optional[int] = None, k_scale=None, v_scale=None):
    """The dispatch the paged layer calls, at any query length: the JAX
    package's rule, Pallas on a TPU and the gather reference elsewhere, read
    as K3 on a CUDA tensor and the plain version on the CPU. A head size the
    kernel lacks raises on the card."""
    return paged_decode_attention(
        q.contiguous(), pool_k, pool_v, table,
        q_pos.to(torch.int32).contiguous(), layer, window=window,
        k_scale=k_scale, v_scale=v_scale)
