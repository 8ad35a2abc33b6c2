"""Fused SwiGLU MLP and int4 matmul over weight-only quantized weights
(K4, K5, K6, K7).

Counterpart of ``videollm_online_tpu/ops/fused_mlp.py``. Four functions,
each a hand-written CUDA kernel family in ``csrc/fused_mlp.cu`` on a CUDA
tensor and a plain PyTorch version (``*_reference``) on a CPU tensor:

  ``fused_mlp_int4c`` (K4)  whole MLP over column-packed int4 (``q4c``)
  ``matmul_int4c``    (K5)  x @ column-packed int4 -> fp32 (the lm_head)
  ``fused_mlp_int8``  (K6)  whole MLP over int8 with per-column scales
  ``fused_mlp_int4``  (K7)  whole MLP over row-packed int4 (``q4p``)

What each computes, kernel and plain version alike: x rounded to bf16;
products of bf16 activations with the exact integer weight values,
accumulated in fp32; for the int4 layouts each group's partial sum times
its fp32 scale, the groups then added in fp32 (int8: the whole sum times
the column's scale); ``h = silu(gate) * up`` in fp32, rounded to bf16
before the down product; the down product accumulated the same way; fp32
out, cast to x's dtype by the MLP wrappers (``matmul_int4c`` returns fp32).
The plain versions are what the kernels are held against, on the CPU by the
tests and on the card by ``chip_smoke.py``; nothing on a CUDA tensor's path
calls them.

K4 runs the wgmma kernel (``fused_mlp_q4c_kernel``) where every byte row
of its matrices is 16-byte aligned (D and F multiples of 32, as in every
model); ``q4c_schedule`` and ``q4c_units`` are its work decomposition as
the CUDA source walks it. K5, K6 and K7 run the streaming weight-only core
(``wo_kernel``) where ``_wo_takes`` holds: byte rows 16-byte aligned, and
for the int4 layouts a group that is a multiple of 16 and divides a 64-row
slot or is a multiple of one; for K7 also half the reduction dim a
multiple of 16 and of the group (every model at group 128). It measured
faster than the ``mma.sync`` family at every row count from 1 to 128 on
the H100 (PERF.md); ``wo_schedule`` and ``wo_units`` are its work
decomposition. Other shapes (for K7 a matrix shorter than its group, whose
one group spans both halves) run the ``mma.sync`` family (``_split`` cuts
its reduction): a rule on the shapes, decided before any launch.

``maybe_fused`` / ``maybe_matmul_int4c`` are the dispatch of
``models/llama._layer`` and ``models/quant.quantized_matmul``, the JAX
package's rule with "on a TPU" read as "on a CUDA tensor": at most
``MAX_FUSED_TOKENS`` rows, no LoRA on the MLP, all three matrices of one
int4 layout (``q4c`` -> K4, ``q4p`` -> K7; int8 is not dispatched, K6 stays
an A/B kernel as in the JAX package) and of a shape the kernels take
(``_kernel_takes``: an even output dim, a group that is a multiple of 16,
for q4p a reduction dim that is a multiple of 32). Where the dispatch
declines, the caller takes the dequantizing route
(``quant.quantized_matmul``).
``VLO_FUSED_MLP=0`` switches the dispatch off.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import torch

from ..models.quant import _unpack_int4c, _unpack_nibbles
from . import _build

# serving-shape bound: decode is 1 row, a frame about 11, a spec-verify step
# 20, the 8-frame chunk ingest 91; longer prefills take the dequantizing
# route, where the matmul is bound by operations
MAX_FUSED_TOKENS = 128

KT = 64                 # reduction rows per staged tile (csrc/fused_mlp.cu)
K_STEP = 16             # reduction rows per mma step
LAYOUT_Q4C, LAYOUT_Q4P, LAYOUT_Q8 = 0, 1, 2
Q4C_ALIGN = 32          # D and F multiples of this take K4's wgmma kernel
Q4C_MAX_SPLITS = 32
WO_KW = 64              # reduction rows a slot of the streaming core
WO_STRIP = 128          # byte columns a group of its warps streams
WO_WARPS = 8            # warps a CTA
WO_MAX_SPLITS = 32


# ------------------------------------------------------------ plain versions
def _q4c(p: torch.Tensor) -> torch.Tensor:
    """(K, N/2) column-packed bytes -> (K, N) fp32 integer values."""
    return _unpack_int4c(p, torch.float32)


def _q4p(p: torch.Tensor) -> torch.Tensor:
    """(K/2, N) row-packed bytes -> (K, N) fp32 integer values."""
    return _unpack_nibbles(p, torch.float32)


def _group_matmul(xb: torch.Tensor, q: torch.Tensor, scale: torch.Tensor
                  ) -> torch.Tensor:
    """xb (B, K) bf16 @ integer values q (K, N) fp32 with group scales
    (K/group, N): fp32 partial sum per group, times the group's scale, the
    groups then added in fp32."""
    B, K = xb.shape
    n_groups = scale.shape[0]
    part = torch.matmul(
        xb.float().reshape(B, n_groups, K // n_groups).transpose(0, 1),
        q.reshape(n_groups, K // n_groups, -1))          # (groups, B, N)
    return (part * scale[:, None, :]).sum(0)


def _swiglu_bf16(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return ((g * torch.sigmoid(g)) * u).to(torch.bfloat16)


def matmul_int4c_reference(x, w_p, w_s):
    return _group_matmul(x.to(torch.bfloat16), _q4c(w_p), w_s)


def fused_mlp_int4c_reference(x, wg_p, wg_s, wu_p, wu_s, wd_p, wd_s):
    xb = x.to(torch.bfloat16)
    h = _swiglu_bf16(_group_matmul(xb, _q4c(wg_p), wg_s),
                     _group_matmul(xb, _q4c(wu_p), wu_s))
    return _group_matmul(h, _q4c(wd_p), wd_s).to(x.dtype)


def fused_mlp_int4_reference(x, wg_p, wg_s, wu_p, wu_s, wd_p, wd_s):
    xb = x.to(torch.bfloat16)
    h = _swiglu_bf16(_group_matmul(xb, _q4p(wg_p), wg_s),
                     _group_matmul(xb, _q4p(wu_p), wu_s))
    return _group_matmul(h, _q4p(wd_p), wd_s).to(x.dtype)


def fused_mlp_int8_reference(x, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s):
    xb = x.to(torch.bfloat16)
    h = _swiglu_bf16((xb.float() @ wg_q.float()) * wg_s,
                     (xb.float() @ wu_q.float()) * wu_s)
    return ((h.float() @ wd_q.float()) * wd_s).to(x.dtype)


# ------------------------------------------------------------------ kernels
@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _kernels():
    """The C entry points of csrc/fused_mlp.cu, built at first use."""
    lib = _build.load("fused_mlp")
    mlp = lib.fused_mlp_swiglu
    mlp.restype = ctypes.c_int
    mlp.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                    + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    mm = lib.fused_mlp_matmul_int4c
    mm.restype = ctypes.c_int
    mm.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    q4c = lib.fused_mlp_q4c
    q4c.restype = ctypes.c_int
    q4c.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
                    + [ctypes.c_void_p])
    wo_mm = lib.fused_mlp_wo_matmul
    wo_mm.restype = ctypes.c_int
    wo_mm.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                      + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    wo_mlp = lib.fused_mlp_wo_swiglu
    wo_mlp.restype = ctypes.c_int
    wo_mlp.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    return mlp, mm, q4c, wo_mm, wo_mlp


def _split(rows: int, group: int, byte_cols: int, B: int, n_mats: int,
           sms: int):
    """How one product's reduction is cut across CTAs: (splits, byte-matrix
    rows per split). The column tiles alone rarely fill the card (the down
    product at 8B has 16), so the reduction rows are cut too, on group
    boundaries where the group allows it, aiming at 4 CTAs an SM (2 for the
    wider row configurations); the merge kernel adds the splits' partial
    results in a fixed order."""
    tile_cols = 128 if B <= 32 else 64
    per_sm = 4 if B <= 32 else 2
    col_tiles = -(-byte_cols // tile_cols)
    want = -(-per_sm * sms // (col_tiles * n_mats))
    align = group if group >= KT else KT
    n = max(1, min(want, rows // align))
    per = -(-(-(-rows // n)) // align) * align
    return -(-rows // per), per


def q4c_rows(B: int) -> int:
    """The N of K4's wgmma products: the rows of x, rounded up to 8, 16,
    32, 64 or 128."""
    return next(n for n in (8, 16, 32, 64, 128) if B <= n)


def q4c_tile(B: int) -> int:
    """Byte columns of one work unit of K4's wgmma kernel: two warpgroups
    of 32 * MT, MT the 64-column m-tiles a warpgroup holds (4, 2 at N 64,
    1 at N 128: MT * N accumulators stay at 128 a thread)."""
    n = q4c_rows(B)
    return 2 * 32 * (1 if n >= 128 else 2 if n >= 64 else 4)


def q4c_schedule(rows: int, byte_cols: int, B: int, n_mats: int, sms: int):
    """How K4's wgmma kernel cuts one product: (tile byte columns, splits,
    reduction rows per split (a multiple of KT), persistent CTAs). Units
    are (matrix, column tile, split); CTA c takes units c, c + grid, ...
    The split count minimises the bytes the busiest CTAs stream (whole
    waves of units over the SMs) plus the fp32 partial results written and
    read again by the merges."""
    bc = q4c_tile(B)
    col_tiles = -(-byte_cols // bc)
    best = None
    for splits in range(1, max(1, min(Q4C_MAX_SPLITS, rows // KT)) + 1):
        per = -(-(-(-rows // splits)) // KT) * KT
        if -(-rows // per) != splits:
            continue                    # a split would get no rows
        units = n_mats * col_tiles * splits
        waves = -(-units // sms)
        cost = (waves * per * bc * sms
                + 2 * n_mats * splits * B * 2 * byte_cols * 4)
        if best is None or cost < best[0]:
            best = (cost, splits, per, min(units, sms))
    _, splits, per, grid = best
    return bc, splits, per, grid


def q4c_units(rows: int, byte_cols: int, B: int, n_mats: int, sms: int):
    """K4's work units in the order the CUDA kernel takes them: per CTA, a
    list of (matrix, byte columns [c0, c1), reduction rows [r0, r1))."""
    bc, splits, per, grid = q4c_schedule(rows, byte_cols, B, n_mats, sms)
    col_tiles = -(-byte_cols // bc)
    work = [[] for _ in range(grid)]
    for u in range(n_mats * col_tiles * splits):
        split, ct = u % splits, (u // splits) % col_tiles
        mat = u // (splits * col_tiles)
        work[u % grid].append((mat, ct * bc, min(byte_cols, (ct + 1) * bc),
                               split * per, min(rows, (split + 1) * per)))
    return work


def wo_design(layout: int, B: int) -> int:
    """N, the rows of x a unit of the streaming core serves: B rounded up
    to 8, 16, 24 (int4 only: int8 measured slower there than at 32), 32 or
    64; above 64 rows, units of 64-row blocks."""
    sizes = (8, 16, 24, 32) if layout != LAYOUT_Q8 else (8, 16, 32)
    return next((n for n in sizes if B <= n), 64)


def wo_group_warps(layout: int, n: int) -> int:
    """G, the warps of the streaming core that share one 128-byte strip:
    each keeps (16 / G m-tiles for q4c, 8 / G for int8 and q4p) x N / 8
    n-tiles of accumulators at 64 registers or fewer (twice for q4c's group
    sums, three times for q4p's two halves' group sums)."""
    nt = n // 8
    if layout != LAYOUT_Q8:
        return 4 if nt == 3 else max(2, nt)
    return nt // 2 if nt > 2 else 1


def _wo_align(layout: int, group: int, splits: int) -> int:
    """Byte rows a split of the streaming core is a multiple of: a slot,
    and for int4 at more than one split a whole scale group (one of a slot
    and a group divides the other; for q4p the high half's split then
    starts on a group too, K / 2 being a multiple of the group)."""
    if splits == 1 or layout == LAYOUT_Q8:
        return WO_KW
    return max(WO_KW, group)


def wo_schedule(layout: int, rows: int, byte_cols: int, B: int, group: int,
                n_mats: int, sms: int):
    """How the streaming core cuts one product of `rows` byte rows (the
    reduction rows, or for q4p half of them) and `byte_cols` byte columns:
    (N, splits, byte rows per split, persistent CTAs). Units are (matrix,
    row block, split, strip); the split count minimises the bytes the
    busiest SM streams (its groups' whole waves of units) plus the fp32
    partial results written and read again by the merges."""
    n = wo_design(layout, B)
    gpc = WO_WARPS // wo_group_warps(layout, n)
    strips = -(-byte_cols // WO_STRIP)
    rblocks = -(-B // n)
    out_cols = 2 * byte_cols if layout == LAYOUT_Q4C else byte_cols
    best = None
    for splits in range(1, WO_MAX_SPLITS + 1):
        align = _wo_align(layout, group, splits)
        per = -(-(-(-rows // splits)) // align) * align
        if -(-rows // per) != splits:
            continue                    # a split would get no rows
        units = n_mats * rblocks * splits * strips
        grid = min(sms, -(-units // gpc))
        waves = -(-units // (grid * gpc))
        cost = (waves * gpc * per * WO_STRIP * sms
                + 2 * n_mats * splits * B * out_cols * 4)
        if best is None or cost < best[0]:
            best = (cost, splits, per, grid)
    _, splits, per, grid = best
    return n, splits, per, grid


def wo_units(layout: int, rows: int, byte_cols: int, B: int, group: int,
             n_mats: int, sms: int):
    """The streaming core's work units in the order the CUDA kernel takes
    them: per worker w (group j of CTA c, w = j * grid + c), a list of
    (matrix, x rows [b0, b1), byte columns [c0, c1), byte rows [r0, r1))."""
    n, splits, per, grid = wo_schedule(layout, rows, byte_cols, B, group,
                                       n_mats, sms)
    workers = grid * (WO_WARPS // wo_group_warps(layout, n))
    strips = -(-byte_cols // WO_STRIP)
    rblocks = -(-B // n)
    work = [[] for _ in range(workers)]
    for u in range(n_mats * rblocks * splits * strips):
        strip, rest = u % strips, u // strips
        split, rest = rest % splits, rest // splits
        rb, mat = rest % rblocks, rest // rblocks
        work[u % workers].append(
            (mat, rb * n, min(B, (rb + 1) * n), strip * WO_STRIP,
             min(byte_cols, (strip + 1) * WO_STRIP), split * per,
             min(rows, (split + 1) * per)))
    return work


def _int4_groups(layout: int, w, s):
    """(K, group) of an int4 matrix's bytes ``w`` and scales ``s`` (the
    reduction dim and the rows a scale covers), or None unless both are 2-D
    and the scale rows cut K into whole groups."""
    if w.ndim != 2 or s is None or s.ndim != 2 or s.shape[0] == 0:
        return None
    K = 2 * w.shape[0] if layout == LAYOUT_Q4P else w.shape[0]
    return None if K % s.shape[0] else (K, K // s.shape[0])


def _wo_takes(layout: int, pairs) -> bool:
    """Whether the products of the (weight bytes, scales) ``pairs`` take the
    streaming core, the rule ``launch_design`` in csrc/fused_mlp.cu holds:
    every byte row 16-byte aligned (TMA reads them); for the int4 layouts
    a group that is a multiple of 16 and divides a slot's rows or is a
    multiple of them; for q4p byte rows (half the reduction dim) that are
    a multiple of 16 and of the group, so that a low-half group and its
    high-half partner end in one slot."""
    for w, s in pairs:
        if w.ndim != 2:
            return False
        rows, cols = w.shape
        if cols % 16 or w.data_ptr() % 16:
            return False
        if layout == LAYOUT_Q8:
            continue
        kg = _int4_groups(layout, w, s)
        if kg is None:
            return False
        group = kg[1]
        if group % K_STEP or (group % WO_KW and WO_KW % group):
            return False
        if layout == LAYOUT_Q4P and (rows % K_STEP or rows % group):
            return False
    return True


def _kernel_takes(layout: int, K: int, N: int, group: int) -> bool:
    """Whether the kernels take a (K, N) matrix of the layout with scale
    groups of ``group`` reduction rows: an even N, a group that is a
    multiple of K_STEP and, for q4p, half of K a multiple of K_STEP. The
    wrappers raise on any other shape (``_check_weights``), and the
    dispatch sends it to the dequantizing route."""
    return (N % 2 == 0 and group % K_STEP == 0
            and (layout != LAYOUT_Q4P or K % (2 * K_STEP) == 0))


def _check_weights(name, layout, x, w, s, K, N):
    """Shapes and types of one quantized matrix (K, N) in ``layout``;
    returns its group size over the reduction rows."""
    key_rows, key_cols = {LAYOUT_Q4C: (K, N // 2), LAYOUT_Q4P: (K // 2, N),
                          LAYOUT_Q8: (K, N)}[layout]
    if w.dtype != torch.int8 or tuple(w.shape) != (key_rows, key_cols):
        raise ValueError(f"{name}: weight bytes must be int8 "
                         f"{(key_rows, key_cols)}, got {w.dtype} "
                         f"{tuple(w.shape)}")
    if s.dtype != torch.float32:
        raise TypeError(f"{name}: scales must be float32, got {s.dtype}")
    if layout == LAYOUT_Q8:
        if tuple(s.shape) != (N,):
            raise ValueError(f"{name}: int8 scales must be {(N,)}, got "
                             f"{tuple(s.shape)}")
        group = K
    else:
        if s.ndim != 2 or s.shape[1] != N or s.shape[0] == 0 \
                or K % s.shape[0]:
            raise ValueError(f"{name}: int4 scales must be (K/group, {N}) "
                             f"with K = {K}, got {tuple(s.shape)}")
        group = K // s.shape[0]
    if not _kernel_takes(layout, K, N, group):
        raise ValueError(f"{name}: the kernel takes an even output dim and "
                         f"a group (and for row-packed int4 half the "
                         f"reduction dim) that is a multiple of {K_STEP}; "
                         f"got K {K}, N {N}, group {group}")
    for t in (w, s):
        if not (t.is_cuda and t.device == x.device and t.is_contiguous()):
            raise ValueError(f"{name}: weights and scales must be "
                             f"contiguous on x's CUDA device")
    return group


def _check_x(x, K):
    if x.ndim != 2 or x.shape[1] != K:
        raise ValueError(f"x must be (rows, {K}), got {tuple(x.shape)}")
    if not 1 <= x.shape[0] <= MAX_FUSED_TOKENS:
        raise ValueError(f"the kernel takes 1 to {MAX_FUSED_TOKENS} rows, "
                         f"got {x.shape[0]}")
    if x.dtype not in (torch.bfloat16, torch.float32, torch.float16):
        raise TypeError(f"x must be a floating tensor, got {x.dtype}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("the fused kernels have no backward")
    return x.to(torch.bfloat16).contiguous()


def _check_mlp(layout, x, wg, sg, wu, su, wd, sd):
    """x as bf16 and the MLP's group sizes: (xb, D, F, group_d, group_f)."""
    D = x.shape[-1]
    F = sg.shape[-1]
    xb = _check_x(x, D)
    group_d = _check_weights("w_gate", layout, x, wg, sg, D, F)
    if _check_weights("w_up", layout, x, wu, su, D, F) != group_d:
        raise ValueError("w_gate and w_up must share their group size")
    group_f = _check_weights("w_down", layout, x, wd, sd, F, D)
    return xb, D, F, group_d, group_f


def _launch_mlp(layout, x, wg, sg, wu, su, wd, sd):
    """The MLP on the mma.sync family (K6, K7, and K4 at unaligned
    shapes)."""
    xb, D, F, group_d, group_f = _check_mlp(layout, x, wg, sg, wu, su, wd,
                                            sd)
    B = xb.shape[0]
    sms = _sm_count(x.device)
    rows1, cols1 = wg.shape
    rows2, cols2 = wd.shape
    split1, per1 = _split(rows1, group_d, cols1, B, 2, sms)
    split2, per2 = _split(rows2, group_f, cols2, B, 1, sms)
    dev = x.device
    h = torch.empty((B, F), dtype=torch.bfloat16, device=dev)
    part = torch.empty((max(2 * split1 * B * F, split2 * B * D),),
                       dtype=torch.float32, device=dev)
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    mlp = _kernels()[0]
    err = mlp(layout, xb.data_ptr(), wg.data_ptr(), sg.data_ptr(),
              wu.data_ptr(), su.data_ptr(), wd.data_ptr(), sd.data_ptr(),
              h.data_ptr(), part.data_ptr(), out.data_ptr(), B, D, F,
              group_d, group_f, split1, per1, split2, per2,
              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_swiglu launch failed: CUDA error "
                           f"{err}")
    return out.to(x.dtype)


def _launch_q4c(x, wg, sg, wu, su, wd, sd):
    """K4 on the wgmma kernel (D and F multiples of Q4C_ALIGN, 16-byte
    aligned weights)."""
    xb, D, F, group_d, group_f = _check_mlp(LAYOUT_Q4C, x, wg, sg, wu, su,
                                            wd, sd)
    if xb.data_ptr() % 16:  # TMA reads x
        xb = xb.clone()
    B = xb.shape[0]
    sms = _sm_count(x.device)
    _, split1, per1, grid1 = q4c_schedule(D, F // 2, B, 2, sms)
    _, split2, per2, grid2 = q4c_schedule(F, D // 2, B, 1, sms)
    dev = x.device
    h = torch.empty((B, F), dtype=torch.bfloat16, device=dev)
    part = torch.empty((max(2 * split1 * B * F, split2 * B * D),),
                       dtype=torch.float32, device=dev)
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    err = _kernels()[2](xb.data_ptr(), wg.data_ptr(), sg.data_ptr(),
                        wu.data_ptr(), su.data_ptr(), wd.data_ptr(),
                        sd.data_ptr(), h.data_ptr(), part.data_ptr(),
                        out.data_ptr(), B, D, F, group_d, group_f, split1,
                        per1, grid1, split2, per2, grid2,
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_q4c launch failed: CUDA error {err}")
    return out.to(x.dtype)


def _launch_wo_mlp(layout, x, wg, sg, wu, su, wd, sd):
    """K6's int8 MLP (LAYOUT_Q8) or K7's q4p MLP (LAYOUT_Q4P) on the
    streaming core; a shape the core does not take raises."""
    xb, D, F, group_d, group_f = _check_mlp(layout, x, wg, sg, wu, su, wd,
                                            sd)
    if xb.data_ptr() % 16:  # TMA reads x
        xb = xb.clone()
    B = xb.shape[0]
    sms = _sm_count(x.device)
    design, split1, per1, grid1 = wo_schedule(layout, wg.shape[0],
                                              wg.shape[1], B, group_d, 2, sms)
    _, split2, per2, grid2 = wo_schedule(layout, wd.shape[0], wd.shape[1], B,
                                         group_f, 1, sms)
    dev = x.device
    h = torch.empty((B, F), dtype=torch.bfloat16, device=dev)
    part = torch.empty((max(2 * split1 * B * F, split2 * B * D),),
                       dtype=torch.float32, device=dev)
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    err = _kernels()[4](layout, xb.data_ptr(), wg.data_ptr(), sg.data_ptr(),
                        wu.data_ptr(), su.data_ptr(), wd.data_ptr(),
                        sd.data_ptr(), h.data_ptr(), part.data_ptr(),
                        out.data_ptr(), B, D, F, group_d, group_f, split1,
                        per1, grid1, split2, per2, grid2, design,
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_wo_swiglu launch failed: CUDA error "
                           f"{err}")
    return out.to(x.dtype)


def fused_mlp_int4c(x, wg_p, wg_s, wu_p, wu_s, wd_p, wd_s):
    """K4. SwiGLU MLP over column-packed int4: x (B, D) -> (B, D) in x's
    dtype. wg_p/wu_p (D, F/2) bytes with scales (D/group, F); wd_p (F, D/2)
    with scales (F/group, D)."""
    if not x.is_cuda:
        return fused_mlp_int4c_reference(x, wg_p, wg_s, wu_p, wu_s, wd_p,
                                         wd_s)
    mats = (wg_p, wu_p, wd_p)
    if (x.shape[-1] % Q4C_ALIGN == 0 and wg_s.shape[-1] % Q4C_ALIGN == 0
            and all(w.data_ptr() % 16 == 0 for w in mats)):
        out = _launch_q4c(x, wg_p, wg_s, wu_p, wu_s, wd_p, wd_s)
    else:
        out = _launch_mlp(LAYOUT_Q4C, x, wg_p, wg_s, wu_p, wu_s, wd_p, wd_s)
    fused_mlp_int4c.launches += 1
    return out


def fused_mlp_int4(x, wg_p, wg_s, wu_p, wu_s, wd_p, wd_s):
    """K7. SwiGLU MLP over row-packed int4: wg_p/wu_p (D/2, F) bytes with
    scales (D/group, F); wd_p (F/2, D) with scales (F/group, D)."""
    if not x.is_cuda:
        return fused_mlp_int4_reference(x, wg_p, wg_s, wu_p, wu_s, wd_p,
                                        wd_s)
    pairs = ((wg_p, wg_s), (wu_p, wu_s), (wd_p, wd_s))
    if _wo_takes(LAYOUT_Q4P, pairs):
        out = _launch_wo_mlp(LAYOUT_Q4P, x, wg_p, wg_s, wu_p, wu_s, wd_p,
                             wd_s)
    else:
        out = _launch_mlp(LAYOUT_Q4P, x, wg_p, wg_s, wu_p, wu_s, wd_p, wd_s)
    fused_mlp_int4.launches += 1
    return out


def fused_mlp_int8(x, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s):
    """K6. SwiGLU MLP over int8: wg_q/wu_q (D, F) with scales (F,); wd_q
    (F, D) with scales (D,)."""
    if not x.is_cuda:
        return fused_mlp_int8_reference(x, wg_q, wg_s, wu_q, wu_s, wd_q,
                                        wd_s)
    pairs = ((wg_q, wg_s), (wu_q, wu_s), (wd_q, wd_s))
    if _wo_takes(LAYOUT_Q8, pairs):
        out = _launch_wo_mlp(LAYOUT_Q8, x, wg_q, wg_s, wu_q, wu_s, wd_q,
                             wd_s)
    else:
        out = _launch_mlp(LAYOUT_Q8, x, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s)
    fused_mlp_int8.launches += 1
    return out


def _launch_matmul(x, w_p, w_s, streaming: Optional[bool] = None):
    """K5 on the streaming core, or on the mma.sync family; by default the
    core wherever it takes the shape (``_wo_takes``)."""
    K, N = w_p.shape[0], w_s.shape[-1]
    xb = _check_x(x, K)
    B = xb.shape[0]
    group = _check_weights("w", LAYOUT_Q4C, x, w_p, w_s, K, N)
    if streaming is None:
        streaming = _wo_takes(LAYOUT_Q4C, ((w_p, w_s),))
    sms = _sm_count(x.device)
    out = torch.empty((B, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if streaming:
        if xb.data_ptr() % 16:  # TMA reads x
            xb = xb.clone()
        design, split, per, grid = wo_schedule(LAYOUT_Q4C, K, N // 2, B,
                                               group, 1, sms)
        # at one split the kernel writes out itself and no merge runs
        part = out if split == 1 else torch.empty(
            (split * B * N,), dtype=torch.float32, device=x.device)
        err = _kernels()[3](LAYOUT_Q4C, xb.data_ptr(), w_p.data_ptr(),
                            w_s.data_ptr(), part.data_ptr(), out.data_ptr(),
                            B, K, N, group, split, per, grid, design, stream)
        name = "fused_mlp_wo_matmul"
    else:
        split, per = _split(K, group, N // 2, B, 1, sms)
        part = torch.empty((split * B * N,), dtype=torch.float32,
                           device=x.device)
        err = _kernels()[1](xb.data_ptr(), w_p.data_ptr(), w_s.data_ptr(),
                            part.data_ptr(), out.data_ptr(), B, K, N, group,
                            split, per, stream)
        name = "fused_mlp_matmul_int4c"
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out


def matmul_int4c(x, w_p, w_s):
    """K5. x (B, K) @ column-packed int4 (K, N/2) bytes with scales
    (K/group, N) -> (B, N) fp32."""
    if not x.is_cuda:
        return matmul_int4c_reference(x, w_p, w_s)
    out = _launch_matmul(x, w_p, w_s)
    matmul_int4c.launches += 1
    return out


for _fn in (fused_mlp_int4c, fused_mlp_int4, fused_mlp_int8, matmul_int4c):
    _fn.launches = 0


# ----------------------------------------------------------------- wrappers
def _mlp(fn, key, x, layer_params):
    B, S, D = x.shape
    wg, wu, wd = (layer_params["w_gate"], layer_params["w_up"],
                  layer_params["w_down"])
    y = fn(x.reshape(B * S, D), wg[key], wg["scale"], wu[key], wu["scale"],
           wd[key], wd["scale"])
    return y.reshape(B, S, D)


def mlp_int8(x, layer_params):
    """(B, S, D) wrapper over K6 for one layer's ``{"q8", "scale"}``
    matrices (valid without LoRA on the MLP)."""
    return _mlp(fused_mlp_int8, "q8", x, layer_params)


def mlp_int4(x, layer_params):
    """(B, S, D) wrapper over K7 for ``{"q4p", "scale"}`` matrices."""
    return _mlp(fused_mlp_int4, "q4p", x, layer_params)


def mlp_int4c(x, layer_params):
    """(B, S, D) wrapper over K4 for ``{"q4c", "scale"}`` matrices."""
    return _mlp(fused_mlp_int4c, "q4c", x, layer_params)


# ----------------------------------------------------------------- dispatch
def _enabled() -> bool:
    # read per call: a snapshot at import would ignore VLO_FUSED_MLP set
    # later in the process
    return os.environ.get("VLO_FUSED_MLP", "1") != "0"


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def maybe_matmul_int4c(x, qw) -> Optional[torch.Tensor]:
    """Dispatch for one column-packed int4 matmul (the lm_head and the
    gate's logits): a CUDA tensor of at most MAX_FUSED_TOKENS rows goes to
    K5. Returns (.., N) fp32, or None (the caller dequantizes)."""
    if not _enabled() or not _on_card(x):
        return None
    w_p, w_s = qw.get("q4c"), qw.get("scale")
    if w_p is None or w_p.ndim != 2:
        return None
    *lead, K = x.shape
    B = 1
    for d in lead:
        B *= d
    if B == 0 or B > MAX_FUSED_TOKENS:
        return None
    kg = _int4_groups(LAYOUT_Q4C, w_p, w_s)
    if (kg is None or kg[0] != K
            or not _kernel_takes(LAYOUT_Q4C, K, w_s.shape[1], kg[1])):
        return None
    y = matmul_int4c(x.reshape(B, K), w_p, w_s)
    return y.reshape(*lead, y.shape[-1])


def _layer_takes(key: str, mats) -> bool:
    """Whether the kernels take all of one layer's MLP matrices in the int4
    layout ``key`` (``_kernel_takes`` on each matrix's shape and group)."""
    layout = LAYOUT_Q4C if key == "q4c" else LAYOUT_Q4P
    for m in mats:
        kg = _int4_groups(layout, m[key], m.get("scale"))
        if kg is None or not _kernel_takes(layout, kg[0],
                                           m["scale"].shape[1], kg[1]):
            return False
    return True


def maybe_fused(x, layer_params, layer_lora) -> Optional[torch.Tensor]:
    """Dispatch for one layer's MLP: the whole-MLP kernel when x (B, S, D)
    is a CUDA tensor of at most MAX_FUSED_TOKENS rows, the MLP carries no
    LoRA and its three matrices share one int4 layout in a shape the
    kernels take. Returns the MLP's output, or None (the caller takes the
    three dequantizing matmuls)."""
    if not _enabled() or not _on_card(x):
        return None
    B, S, _ = x.shape
    if B * S > MAX_FUSED_TOKENS:
        return None
    if layer_lora is not None and any(
            layer_lora.get(n) is not None
            for n in ("w_gate", "w_up", "w_down")):
        return None
    mats = [layer_params.get(n) for n in ("w_gate", "w_up", "w_down")]
    if not all(isinstance(m, dict) for m in mats):
        return None
    # int8 is not dispatched, as in the JAX package: K6 stays an A/B kernel
    for key, fn in (("q4c", mlp_int4c), ("q4p", mlp_int4)):
        if all(key in m for m in mats):
            return fn(x, layer_params) if _layer_takes(key, mats) else None
    return None
