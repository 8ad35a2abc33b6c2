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

``maybe_fused`` / ``maybe_matmul_int4c`` are the dispatch of
``models/llama._layer`` and ``models/quant.quantized_matmul``, the JAX
package's rule with "on a TPU" read as "on a CUDA tensor": at most
``MAX_FUSED_TOKENS`` rows, no LoRA on the MLP, all three matrices of one
int4 layout (``q4c`` -> K4, ``q4p`` -> K7; int8 is not dispatched, K6 stays
an A/B kernel as in the JAX package). Where the dispatch declines, the
caller takes the dequantizing route (``quant.quantized_matmul``).
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
    return mlp, mm


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
    if N % 2 or group % K_STEP or (layout == LAYOUT_Q4P and K % (2 * K_STEP)):
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


def _launch_mlp(layout, x, wg, sg, wu, su, wd, sd):
    D = x.shape[-1]
    F = sg.shape[-1]
    xb = _check_x(x, D)
    B = xb.shape[0]
    group_d = _check_weights("w_gate", layout, x, wg, sg, D, F)
    if _check_weights("w_up", layout, x, wu, su, D, F) != group_d:
        raise ValueError("w_gate and w_up must share their group size")
    group_f = _check_weights("w_down", layout, x, wd, sd, F, D)
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
    mlp, _ = _kernels()
    err = mlp(layout, xb.data_ptr(), wg.data_ptr(), sg.data_ptr(),
              wu.data_ptr(), su.data_ptr(), wd.data_ptr(), sd.data_ptr(),
              h.data_ptr(), part.data_ptr(), out.data_ptr(), B, D, F,
              group_d, group_f, split1, per1, split2, per2,
              torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_swiglu launch failed: CUDA error "
                           f"{err}")
    return out.to(x.dtype)


def fused_mlp_int4c(x, wg_p, wg_s, wu_p, wu_s, wd_p, wd_s):
    """K4. SwiGLU MLP over column-packed int4: x (B, D) -> (B, D) in x's
    dtype. wg_p/wu_p (D, F/2) bytes with scales (D/group, F); wd_p (F, D/2)
    with scales (F/group, D)."""
    if not x.is_cuda:
        return fused_mlp_int4c_reference(x, wg_p, wg_s, wu_p, wu_s, wd_p,
                                         wd_s)
    out = _launch_mlp(LAYOUT_Q4C, x, wg_p, wg_s, wu_p, wu_s, wd_p, wd_s)
    fused_mlp_int4c.launches += 1
    return out


def fused_mlp_int4(x, wg_p, wg_s, wu_p, wu_s, wd_p, wd_s):
    """K7. SwiGLU MLP over row-packed int4: wg_p/wu_p (D/2, F) bytes with
    scales (D/group, F); wd_p (F/2, D) with scales (F/group, D)."""
    if not x.is_cuda:
        return fused_mlp_int4_reference(x, wg_p, wg_s, wu_p, wu_s, wd_p,
                                        wd_s)
    out = _launch_mlp(LAYOUT_Q4P, x, wg_p, wg_s, wu_p, wu_s, wd_p, wd_s)
    fused_mlp_int4.launches += 1
    return out


def fused_mlp_int8(x, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s):
    """K6. SwiGLU MLP over int8: wg_q/wu_q (D, F) with scales (F,); wd_q
    (F, D) with scales (D,)."""
    if not x.is_cuda:
        return fused_mlp_int8_reference(x, wg_q, wg_s, wu_q, wu_s, wd_q,
                                        wd_s)
    out = _launch_mlp(LAYOUT_Q8, x, wg_q, wg_s, wu_q, wu_s, wd_q, wd_s)
    fused_mlp_int8.launches += 1
    return out


def matmul_int4c(x, w_p, w_s):
    """K5. x (B, K) @ column-packed int4 (K, N/2) bytes with scales
    (K/group, N) -> (B, N) fp32."""
    if not x.is_cuda:
        return matmul_int4c_reference(x, w_p, w_s)
    K, N = w_p.shape[0], w_s.shape[-1]
    xb = _check_x(x, K)
    B = xb.shape[0]
    group = _check_weights("w", LAYOUT_Q4C, x, w_p, w_s, K, N)
    split, per = _split(K, group, N // 2, B, 1, _sm_count(x.device))
    part = torch.empty((split * B * N,), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((B, N), dtype=torch.float32, device=x.device)
    _, mm = _kernels()
    err = mm(xb.data_ptr(), w_p.data_ptr(), w_s.data_ptr(),
             part.data_ptr(), out.data_ptr(), B, K, N, group, split, per,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_mlp_matmul_int4c launch failed: CUDA "
                           f"error {err}")
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
    if K != w_p.shape[0] or K % w_s.shape[0]:
        return None
    y = matmul_int4c(x.reshape(B, K), w_p, w_s)
    return y.reshape(*lead, y.shape[-1])


def maybe_fused(x, layer_params, layer_lora) -> Optional[torch.Tensor]:
    """Dispatch for one layer's MLP: the whole-MLP kernel when x (B, S, D)
    is a CUDA tensor of at most MAX_FUSED_TOKENS rows, the MLP carries no
    LoRA and its three matrices share one int4 layout. Returns the MLP's
    output, or None (the caller takes the three dequantizing matmuls)."""
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
    if all("q4c" in m for m in mats):
        return mlp_int4c(x, layer_params)
    if all("q4p" in m for m in mats):
        return mlp_int4(x, layer_params)
    return None
