"""Ring decode attention (K1): a short query chunk against the KV ring.

Counterpart of ``videollm_online_tpu/ops/decode_attention.py``. The serving
loop appends 1 to 64 tokens per forward (a decode step, a spec-verify step,
a one-frame step, a short prompt) and attends the whole ring. On a CUDA
tensor the wrappers launch the hand-written kernel in
``csrc/decode_attention.cu`` (or raise); on a CPU tensor they take the
plain PyTorch version beside it (``*_reference``), which is also what the
kernel is held against on the card.

``kernel_design`` names the implementation each (dtype, d) runs, and the
library refuses any other pairing: bf16 q with d in {64, 128}, over bf16
or int8 K/V, runs on the tensor cores (a cp.async ring of K/V tiles shared
by a CTA's query rows; wgmma warpgroups for more than 16 rows a kv head,
mma.sync warps that slice each tile for fewer), fp32 q and d = 256 on
fp32 FMA. ``row_blocks``, ``num_splits``, ``visible_slots`` and
``split_ranges`` are the schedule as the CUDA source computes it, for the
tests and for K3 (``ops/paged_attention.py``), which runs the same kernels
over its pool.

Layouts are the JAX package's: q (B, Hq, S, d), the stacked ring
(L, B, Hkv, C, d), q_pos (B, S) int32 slot-relative positions, and for int8
K/V fp32 (L, B, Hkv, C) per-slot scales.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

HEAD_DIMS = (64, 128, 256)
MAX_CHUNK = 64
DESIGNS = ("fma", "tensor cores")   # the library's design codes 0 and 1
BLOCK_K = {"fma": 32, "tensor cores": 64}   # slots per K/V tile
FMA_ROWS_PER_CTA = 16   # the FMA design: 4 warps x 4 query rows
FMA_CTAS_PER_SM = 4     # split CTAs the wrapper aims to put on each SM
# the tensor-core design by slices of each tile: query rows per CTA (two
# wgmma warpgroups of 64 rows, or 4 mma.sync warps sharing 16 rows and
# taking 4 slices of each tile's slots), and split CTAs aimed at per SM (a
# wgmma CTA fills an SM; two mma.sync CTAs fit on one)
TC_ROWS_PER_CTA = {1: 128, 4: 16}
TC_CTAS_PER_SM = {1: 1, 4: 2}


def kernel_design(dtype: torch.dtype, d: int) -> str:
    """The implementation the kernels run for q's dtype and head size:
    "tensor cores" for bf16 with d in {64, 128} (bf16 or int8 K/V),
    "fma" for fp32 (which bf16 tensor cores cannot hold to fp32 accuracy)
    and for d = 256 (whose accumulators do not fit a warp's registers)."""
    if dtype == torch.bfloat16 and d in (64, 128):
        return "tensor cores"
    return "fma"


def row_blocks(design: str, rows: int) -> Tuple[int, int, int]:
    """(slices, rows per CTA, row blocks) for the G * S query rows of a kv
    head. The tensor-core CTA runs two wgmma warpgroups of 64 rows; with at
    most 16 rows, 4 mma.sync warps share one m16 tile of rows and split
    each tile's slots into 4 slices, so that no warp idles (the split at 16
    rows as measured on the H100: chip_smoke.py --phases tc_configs)."""
    if design == "fma":
        return 1, FMA_ROWS_PER_CTA, -(-rows // FMA_ROWS_PER_CTA)
    slices = 4 if rows <= 16 else 1
    per = TC_ROWS_PER_CTA[slices]
    return slices, per, -(-rows // per)


def num_splits(design: str, sm_count: int, B: int, Hkv: int, rows: int,
               slots: int) -> int:
    """Enough split CTAs for the aimed-at CTAs on every SM, never more
    splits than tiles of a stream's slots. Sized from shapes alone (no
    device readback): splits past a stream's visible tiles find an empty
    range."""
    slices, _, nblk = row_blocks(design, rows)
    per_sm = FMA_CTAS_PER_SM if design == "fma" else TC_CTAS_PER_SM[slices]
    want = -(-per_sm * sm_count // (B * Hkv * nblk))
    return max(1, min(want, -(-slots // BLOCK_K[design])))


def visible_slots(q_pos: Sequence[int], window: Optional[int],
                  slots: int) -> Tuple[int, int]:
    """[lo, hi], the slots some query of one stream sees (hi < lo when
    none): the only slots the kernels read."""
    hi = min(max(q_pos), slots - 1)
    lo = max(min(q_pos) - window + 1, 0) if window else 0
    return lo, hi


def split_ranges(design: str, q_pos: Sequence[int], window: Optional[int],
                 slots: int, nsplit: int) -> List[Tuple[int, int]]:
    """Each split's tiles [start, end) of one stream with query positions
    ``q_pos``, as the kernels compute them: the visible tiles cut into
    nsplit runs of equal length (the last ones shorter or empty)."""
    bk = BLOCK_K[design]
    lo, hi = visible_slots(q_pos, window, slots)
    if hi < 0 or lo > hi:
        return [(0, 0)] * nsplit
    fb, nb = lo // bk, hi // bk + 1
    per = -(-(nb - fb) // nsplit)
    out = []
    for split in range(nsplit):
        start = fb + split * per
        out.append((start, max(min(nb, start + per), start)))
    return out


def _scale(d: int) -> float:
    # 1 / sqrt(d) rounded in fp32, as the JAX kernel computes it
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def ring_decode_attention_layered_reference(
        q, k_all, v_all, q_pos, layer: int, *, window: Optional[int] = None,
        k_scale=None, v_scale=None):
    """Plain PyTorch version of the kernel, same arithmetic order: fp32
    logits, int8 scales on the logits and probabilities, probabilities cast
    to q's dtype before P.V, normalised at the end; a row with nothing
    visible outputs 0."""
    B, Hq, S, d = q.shape
    Hkv, C = k_all.shape[2], k_all.shape[3]
    G = Hq // Hkv
    k, v = k_all[layer], v_all[layer]                      # (B, Hkv, C, d)
    qg = q.reshape(B, Hkv, G * S, d).float()
    qpos = q_pos.to(q.device).long().repeat(1, G)[:, None, :, None]
    s = torch.matmul(qg, k.float().transpose(-1, -2)) * _scale(d)
    if k_scale is not None:
        s = s * k_scale[layer][:, :, None, :]
    slot = torch.arange(C, device=q.device)
    mask = slot <= qpos
    if window is not None:
        mask = mask & (slot > qpos - window)
    m = s.masked_fill(~mask, float("-inf")).amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1, keepdim=True)
    if v_scale is not None:
        pv = (p * v_scale[layer][:, :, None, :]).to(q.dtype)
    else:
        pv = p.to(v.dtype)
    acc = torch.matmul(pv.float(), v.float())
    out = acc / torch.where(l == 0, torch.ones_like(l), l)
    return out.to(q.dtype).reshape(B, Hq, S, d)


def ring_decode_attention_reference(q, k, v, q_pos, *, window=None,
                                    k_scale=None, v_scale=None):
    return ring_decode_attention_layered_reference(
        q, k[None], v[None], q_pos, 0, window=window,
        k_scale=None if k_scale is None else k_scale[None],
        v_scale=None if v_scale is None else v_scale[None])


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/decode_attention.cu, built at first use."""
    fn = _build.load("decode_attention").k1_ring_decode_attention
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    return fn


def schedule(device, dtype, B, Hkv, rows, d, slots):
    """(design, slices, nsplit, part_acc, part_ml) of one launch of K1 or
    K3, with the fp32 split partials it needs allocated here (none for one
    split on the tensor cores, which then write the output directly)."""
    design = kernel_design(dtype, d)
    slices = row_blocks(design, rows)[0]
    nsplit = num_splits(design, _sm_count(device), B, Hkv, rows, slots)
    part_acc = part_ml = None
    if nsplit > 1 or design == "fma":
        part_acc = torch.empty((nsplit, B * Hkv, rows, d), dtype=torch.float32,
                               device=device)
        part_ml = torch.empty((nsplit, B * Hkv, rows, 2), dtype=torch.float32,
                              device=device)
    return design, slices, nsplit, part_acc, part_ml


def ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(q, k_all, v_all, q_pos, layer, window, k_scale, v_scale):
    B, Hq, S, d = q.shape
    L, Bk, Hkv, C, dk = k_all.shape
    quant = k_scale is not None
    tensors = [q, k_all, v_all, q_pos] + ([k_scale, v_scale] if quant else [])
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("ring decode attention: every tensor must be on "
                         "q's CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ring decode attention: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_all, v_all)):
        raise ValueError("ring decode attention: q and the ring must be "
                         "16-byte aligned (the kernel loads 16 bytes a lane)")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    if v_all.dtype != k_all.dtype or v_all.shape != k_all.shape:
        raise ValueError("k_all and v_all must share shape and dtype")
    if quant:
        if k_all.dtype != torch.int8 or v_scale is None:
            raise TypeError("scales need int8 k_all/v_all and both scales")
        for sc in (k_scale, v_scale):
            if sc.dtype != torch.float32 or sc.shape != (L, B, Hkv, C):
                raise ValueError(f"scales must be float32 {(L, B, Hkv, C)}")
    elif k_all.dtype != q.dtype:
        raise TypeError(f"k_all {k_all.dtype} must match q {q.dtype} "
                        f"(or be int8 with scales)")
    if Bk != B or dk != d or Hq % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} vs ring "
                         f"{tuple(k_all.shape)}")
    if d not in HEAD_DIMS or not 1 <= S <= MAX_CHUNK:
        raise ValueError(f"kernel takes d in {HEAD_DIMS} and S <= "
                         f"{MAX_CHUNK}, got d={d}, S={S}")
    if q_pos.dtype != torch.int32 or q_pos.shape != (B, S):
        raise ValueError(f"q_pos must be int32 {(B, S)}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} out of range [0, {L})")
    if window is not None and int(window) <= 0:
        raise ValueError(f"window must be positive, got {window}")
    rows = (Hq // Hkv) * S
    design, slices, nsplit, part_acc, part_ml = schedule(
        q.device, q.dtype, B, Hkv, rows, d, C)
    out = torch.empty_like(q)
    err = _kernel()(q.data_ptr(), k_all.data_ptr(), v_all.data_ptr(),
             ptr(k_scale), ptr(v_scale), q_pos.data_ptr(), out.data_ptr(),
             ptr(part_acc), ptr(part_ml), B, Hkv, S, rows, d, C, int(layer),
             int(window) if window is not None else 0, nsplit,
             1 if q.dtype == torch.bfloat16 else 0, 1 if quant else 0,
             DESIGNS.index(design), slices,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"k1_ring_decode_attention launch failed: CUDA "
                           f"error {err}")
    ring_decode_attention_layered.launches += 1
    return out


def ring_decode_attention_layered(q, k_all, v_all, q_pos, layer: int, *,
                                  window: Optional[int] = None,
                                  k_scale=None, v_scale=None):
    """Attention of q (B, Hq, S, d) over layer ``layer`` of the stacked ring
    (L, B, Hkv, C, d); slot j is visible iff j <= q_pos (and, with
    ``window``, j > q_pos - window). On CUDA the kernel reads only the
    visible tiles of that layer. Returns (B, Hq, S, d) in q's dtype."""
    if not q.is_cuda:
        return ring_decode_attention_layered_reference(
            q, k_all, v_all, q_pos, layer, window=window, k_scale=k_scale,
            v_scale=v_scale)
    return _launch(q, k_all, v_all, q_pos, layer, window, k_scale, v_scale)


ring_decode_attention_layered.launches = 0


def ring_decode_attention(q, k, v, q_pos, *, window: Optional[int] = None,
                          k_scale=None, v_scale=None):
    """The same kernel over one layer's ring k/v (B, Hkv, C, d), viewed as
    L = 1; its launches count on ``ring_decode_attention_layered``."""
    return ring_decode_attention_layered(
        q, k[None], v[None], q_pos, 0, window=window,
        k_scale=None if k_scale is None else k_scale[None],
        v_scale=None if v_scale is None else v_scale[None])
