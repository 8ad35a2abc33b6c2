"""Paged latent attention (MLA) over a shared pool of latent rows.

DeepSeek-V2's attention in its absorbed form (``models/deepseek_v2.py``):
every token of every layer caches one row of ``kv_lora_rank +
qk_rope_head_dim`` values (the normed latent c and the roped shared key),
and each query head attends that one shared "KV head": its logits are q
(the head's nope query folded through W_UK, then its roped query) against
the whole row, and its output is the probabilities times the row's first
``dv`` values (the latent; W_UV is applied after). Stream b's logical slot
j lives at ``latent[layer, table[b, j // page], j % page]``, as in the
llama pool (``ops/paged_attention.py``).

On a CUDA tensor ``mla_paged_attention`` launches the hand-written kernel
in ``csrc/mla_attention.cu`` (``mla_paged_kernel``); on a CPU tensor it
takes the plain PyTorch version beside it (``mla_attention_reference``:
gather, then masked fp32 attention), which is also what the kernel is held
against on the card.

Layouts: q (B, S, H, dk), latent (L, P, page, dk), table (B, MAXP) int32,
q_pos (B, S) int32 slot-relative positions, nvalid (B,) int32: the first
nvalid[b] queries of stream b are real, the rest are padding, and a padding
query's output is 0, as is that of a query that sees no slot. Slot j is
visible to a query at q_pos p iff j <= p (and, with a window, j > p -
window). Output (B, S, H, dv) in q's dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30
# the kernel's widths: DeepSeek-V2's kv_lora_rank 512 + qk_rope_head_dim 64
KERNEL_DK, KERNEL_DV = 576, 512
BLOCK_ROWS = 64        # query rows (heads x queries) a CTA
BLOCK_SLOTS = 64       # latent slots a tile
MAX_SPLITS = 32


def mla_attention_reference(q, latent, table, q_pos, layer: int, nvalid, *,
                            scale: float, dv: int,
                            window: Optional[int] = None):
    """Plain PyTorch version: each stream's latent rows gathered from its
    pages, logits q . row in fp32 times ``scale``, the mask, an fp32
    softmax, and the probabilities times the rows' first ``dv`` values."""
    B, S, H, dk = q.shape
    _, _, page, _ = latent.shape
    maxp = table.shape[1]
    dev = q.device
    rows = latent[layer][table.to(dev).long()].reshape(B, maxp * page, dk)
    rows = rows.float()
    s = torch.einsum("bshd,bjd->bshj", q.float(), rows) * scale
    slot = torch.arange(maxp * page, device=dev)
    qp = q_pos.to(dev).long()[:, :, None, None]
    mask = slot <= qp
    if window is not None:
        mask = mask & (slot > qp - window)
    real = (torch.arange(S, device=dev)[None]
            < torch.as_tensor(nvalid).to(dev).long()[:, None])
    mask = mask & real[:, :, None, None]
    p = torch.softmax(s.masked_fill(~mask, NEG_INF), dim=-1)
    p = p * mask.any(-1, keepdim=True)
    o = torch.einsum("bshj,bjd->bshd", p, rows[..., :dv])
    return o.to(q.dtype)


def num_splits(B: int, rows: int, slots: int) -> int:
    """CTAs a (stream, row block) splits its visible tiles over, from the
    shapes alone (a replayed decode graph keeps its grid): one where the
    row blocks fill the card, else up to MAX_SPLITS with at least four
    tiles each. A decode forward (one row block a stream, of which only
    the one or two streams still answering have work) takes the most."""
    blocks = -(-rows // BLOCK_ROWS)
    tiles = -(-slots // BLOCK_SLOTS)
    if blocks > 2 and B * blocks >= 264:
        return 1
    return max(1, min(MAX_SPLITS, tiles // 4))


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/mla_attention.cu, built at first use."""
    fn = _build.load("mla_attention").mla_paged_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _launch(q, latent, table, q_pos, layer, nvalid, scale, window):
    B, S, H, dk = q.shape
    L, P, page, dkl = latent.shape
    maxp = table.shape[1] if table.dim() == 2 else -1
    tensors = (q, latent, table, q_pos, nvalid)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("mla attention: every tensor must be on q's CUDA "
                         "device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mla attention: tensors must be contiguous")
    if q.dtype != torch.bfloat16 or latent.dtype != torch.bfloat16:
        raise TypeError(f"mla attention takes bfloat16 q and latent, got "
                        f"{q.dtype} and {latent.dtype}")
    if dk != KERNEL_DK or dkl != KERNEL_DK:
        raise ValueError(f"the kernel takes rows of {KERNEL_DK}, got q "
                         f"{tuple(q.shape)} and latent {tuple(latent.shape)}")
    if table.dtype != torch.int32 or table.shape != (B, maxp):
        raise ValueError(f"table must be int32 (B={B}, MAXP)")
    if q_pos.dtype != torch.int32 or q_pos.shape != (B, S):
        raise ValueError(f"q_pos must be int32 {(B, S)}")
    if nvalid.dtype != torch.int32 or nvalid.shape != (B,):
        raise ValueError(f"nvalid must be int32 ({B},)")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    if window is not None and int(window) <= 0:
        raise ValueError(f"window must be positive, got {window}")
    rows = S * H
    nsplit = num_splits(B, rows, maxp * page)
    out = torch.empty((B, S, H, KERNEL_DV), dtype=q.dtype, device=q.device)
    part_acc = part_ml = None
    if nsplit > 1:
        part_acc = torch.empty((nsplit, B * rows, KERNEL_DV),
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty((nsplit, B * rows, 2), dtype=torch.float32,
                              device=q.device)
    err = _kernel()(
        q.data_ptr(), latent.data_ptr(), table.data_ptr(), q_pos.data_ptr(),
        nvalid.data_ptr(), out.data_ptr(),
        0 if part_acc is None else part_acc.data_ptr(),
        0 if part_ml is None else part_ml.data_ptr(),
        B, S, H, P, page, maxp, int(layer),
        int(window) if window is not None else 0, nsplit, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mla_paged_attention launch failed: CUDA error "
                           f"{err}")
    mla_paged_attention.launches += 1
    return out


def mla_paged_attention(q, latent, table, q_pos, layer: int, nvalid, *,
                        scale: float, dv: int,
                        window: Optional[int] = None):
    """Attention of q (B, S, H, dk) over layer ``layer`` of each stream's
    latent pages (module docstring). A CUDA tensor launches the kernel,
    which reads only the slots between each row block's first and last
    visible one and none of a stream with no real query, or raises (widths
    other than 576 / 512, a dtype other than bf16, a wrong layout); a CPU
    tensor takes the plain version."""
    if not q.is_cuda:
        return mla_attention_reference(q, latent, table, q_pos, layer, nvalid,
                                       scale=scale, dv=dv, window=window)
    if dv != KERNEL_DV:
        raise ValueError(f"the kernel takes dv {KERNEL_DV}, got {dv}")
    return _launch(q.contiguous(), latent, table,
                   q_pos.to(torch.int32).contiguous(), layer,
                   nvalid.to(torch.int32).contiguous(), scale, window)


mla_paged_attention.launches = 0
