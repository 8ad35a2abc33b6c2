"""Flash attention (K2): fused causal attention, forward and backward.

Counterpart of ``videollm_online_tpu/ops/flash_attention.py``, the training
path's attention. ``flash_attention`` is a ``torch.autograd.Function``: its
forward runs the forward kernel and keeps (q, k, v, out, lse); its backward
computes ``delta = rowsum(dO * O)`` in fp32 as a plain tensor op (the JAX
package computes it in XLA outside Pallas) and runs the dK/dV kernel and the
dQ kernel. On a CUDA tensor each wrapper (``flash_fwd``, ``flash_dkdv``,
``flash_dq``) launches its hand-written kernel in ``csrc/flash_attention.cu``
or raises; on a CPU tensor it takes the plain PyTorch version beside it,
which is also what the kernels are held against on the card.

``kernel_design`` names the implementation each (dtype, d) runs and is
passed to the library, which refuses any other pairing: bf16 with d <= 128
runs on the tensor cores (the forward, dK/dV and dQ kernels on ``wgmma``
over tiles that TMA loads ahead through a ring of mbarrier-guarded slots),
fp32 and bf16 with d = 256 on fp32 FMA. ``kv_tile_range`` and ``q_tile_range`` are
the tensor-core kernels' schedule as the CUDA source computes it;
``computed_pairs`` marks the (row, col) pairs whose products they compute,
for the tests and for counting the work done in whole tiles.

Layouts are the JAX package's: q (B, Hq, T, d), k/v (B, Hkv, S, d) with
Hq % Hkv == 0, lse and delta (B, Hq, T) fp32. Slot ``col`` is visible to
query ``row`` iff col < kv_valid and, when causal, col <= row + q_offset
and, with ``window``, col > row + q_offset - window. A row that sees no slot
outputs 0 with lse -1e30 (the TPU kernel's value for such a row depends on
its block size; the training path never has one).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

HEAD_DIMS = (64, 128, 256)
NEG_INF = -1e30
_DTYPES = (torch.bfloat16, torch.float32)
DESIGNS = ("fma", "tensor cores")   # the library's design codes 0 and 1
# (q rows, kv rows) of a tile: the forward and dQ CTAs' q tile against their
# kv tiles, and the dK/dV kernel's streamed q tile against its CTA's k tile
FWD_TILE = (128, 128)
DQ_TILE = (128, 64)
DKDV_TILE = (64, 128)
# TMA coordinates and the kernels' row indices are 32-bit
MAX_ROWS = 2 ** 31 - 1


def kernel_design(dtype: torch.dtype, d: int) -> str:
    """The implementation the kernels run for (dtype, d): "tensor cores"
    for bf16 with d in {64, 128}, "fma" for fp32 and for bf16 with
    d = 256 (whose accumulators do not fit the tensor-core kernels'
    registers)."""
    if dtype == torch.bfloat16 and d in (64, 128):
        return "tensor cores"
    return "fma"


def kv_tile_range(q0: int, T: int, kv_len: int, q_offset: int,
                  causal: bool, window: Optional[int],
                  tile: Tuple[int, int] = FWD_TILE) -> Tuple[int, int]:
    """The kv tiles [first, last] that some row of the q tile at q0 sees
    (the forward's loop; the dQ kernel's with ``tile=DQ_TILE``)."""
    bm, bn = tile
    last = (kv_len + bn - 1) // bn - 1
    if causal:
        last = min(last, (min(q0 + bm, T) - 1 + q_offset) // bn)
    first = 0
    if window is not None:
        first = max(q0 + q_offset - window + 1, 0) // bn
    return first, last


def q_tile_range(k0: int, T: int, kv_len: int, q_offset: int, causal: bool,
                 window: Optional[int]) -> Tuple[int, int]:
    """The q tiles [first, last] with some row that sees a column of the
    k tile at k0 (the dK/dV loop); last < first if none does."""
    bm, bn = DKDV_TILE
    if k0 >= kv_len:
        return 0, -1
    first, last = 0, (T + bm - 1) // bm - 1
    if causal:
        first = max(k0 - q_offset, 0) // bm
    if window is not None:
        hi = min(k0 + bn, kv_len) - 1 - q_offset + window - 1
        if hi < 0:
            return 0, -1
        last = min(last, hi // bm)
    return first, last


def _block_visibility(r0: int, nr: int, c0: int, nc: int, T: int,
                      kv_len: int, q_offset: int, causal: bool,
                      window: Optional[int]) -> int:
    """0 if no (row, col) of rows [r0, r0 + nr) x cols [c0, c0 + nc) is
    visible (the kernels skip the block), 2 if all are (no mask), else 1."""
    c_hi = c0 + nc - 1
    p_lo, p_hi = r0 + q_offset, min(r0 + nr, T) - 1 + q_offset
    if c0 >= kv_len or r0 >= T or (causal and c0 > p_hi):
        return 0
    if window is not None and min(c_hi, kv_len - 1) <= p_lo - window:
        return 0
    full = (c_hi < kv_len and r0 + nr <= T and (not causal or c_hi <= p_lo)
            and (window is None or c0 > p_hi - window))
    return 2 if full else 1


def computed_pairs(kernel: str, T: int, S: int, q_offset: int, causal: bool,
                   window: Optional[int], kv_len: int) -> torch.Tensor:
    """(T, S) bool: the (row, col) pairs of one head whose products the
    tensor-core kernel ("fwd", "dkdv" or "dq") computes, as its schedule
    walks them. The forward computes its whole q tile against every kv tile
    of its loop (a consumer masks a block it does not see); the dK/dV
    kernel skips each consumer's 64-column block, and the dQ kernel each
    consumer's 64-row block, where no pair of it is visible."""
    done = torch.zeros(T, S, dtype=torch.bool)
    if kernel == "fwd":
        bm, bn = FWD_TILE
        for q0 in range(0, T, bm):
            first, last = kv_tile_range(q0, T, kv_len, q_offset, causal, window)
            done[q0:q0 + bm, first * bn:(last + 1) * bn] = True
        return done
    vis = functools.partial(_block_visibility, T=T, kv_len=kv_len,
                            q_offset=q_offset, causal=causal, window=window)
    if kernel == "dq":
        bm, bn = DQ_TILE
        for q0 in range(0, T, bm):
            first, last = kv_tile_range(q0, T, kv_len, q_offset, causal, window,
                                        DQ_TILE)
            for r0 in (q0, q0 + bm // 2):
                for c0 in range(first * bn, (last + 1) * bn, bn):
                    if vis(r0, bm // 2, c0, bn):
                        done[r0:r0 + bm // 2, c0:c0 + bn] = True
        return done
    bm, bn = DKDV_TILE
    for k0 in range(0, S, bn):
        first, last = q_tile_range(k0, T, kv_len, q_offset, causal, window)
        for c0 in (k0, k0 + bn // 2):
            for q0 in range(first * bm, (last + 1) * bm, bm):
                if vis(q0, bm, c0, bn // 2):
                    done[q0:q0 + bm, c0:c0 + bn // 2] = True
    return done


def visible_mask(T: int, S: int, q_offset: int, causal: bool,
                 window: Optional[int], kv_len: int, device) -> torch.Tensor:
    """(T, S) visibility of slot col to query row."""
    row = torch.arange(T, device=device)[:, None] + q_offset
    col = torch.arange(S, device=device)[None, :]
    mask = col < kv_len
    if causal:
        mask = mask & (col <= row)
    if window is not None:
        mask = mask & (col > row - window)
    return mask


def _grouped(x: torch.Tensor, groups: int) -> torch.Tensor:
    return x.repeat_interleave(groups, dim=1) if groups > 1 else x


def softmax_delta(do: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """rowsum(dO * O) in fp32, (B, Hq, T)."""
    return (do.float() * out.float()).sum(-1)


def flash_attention_fwd_reference(q, k, v, scale: float, causal: bool = True,
                                  q_offset: int = 0,
                                  window: Optional[int] = None,
                                  kv_valid: Optional[int] = None):
    """Plain PyTorch version of the forward kernel: fp32 logits and softmax,
    probabilities rounded to v's dtype before P.V. Returns (out in q's
    dtype, lse (B, Hq, T) fp32)."""
    B, Hq, T, d = q.shape
    S, G = k.shape[2], Hq // k.shape[1]
    mask = visible_mask(T, S, q_offset, causal, window,
                        S if kv_valid is None else kv_valid, q.device)
    s = torch.matmul(q.float(), _grouped(k, G).float().transpose(-1, -2))
    s = (s * scale).masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), _grouped(v, G).float())
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    out = torch.where(l == 0, torch.zeros_like(acc), acc / safe_l)
    lse = torch.where(l == 0, torch.full_like(l, NEG_INF), m + torch.log(safe_l))
    return out.to(q.dtype), lse[..., 0]


def flash_bwd_plain(q, k, v, do, lse, delta, scale: float,
                    causal: bool = True, q_offset: int = 0,
                    window: Optional[int] = None,
                    kv_valid: Optional[int] = None):
    """Plain PyTorch version of the dK/dV and dQ kernels, given delta:
    dq, dk, dv with the kernels' algorithm: P recomputed from the LSE,
    dS = P * (dP - delta) * scale, P and dS rounded to the input dtype
    before their products, dK/dV summed over each kv head's group in fp32
    and cast once."""
    B, Hq, T, d = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = Hq // Hkv
    mask = visible_mask(T, S, q_offset, causal, window,
                        S if kv_valid is None else kv_valid, q.device)
    kf, vf = _grouped(k, G).float(), _grouped(v, G).float()
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dof = do.float()
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float())
    dq = torch.matmul(ds.to(k.dtype).float(), kf)
    dk = dk.reshape(B, Hkv, G, S, d).sum(2).to(k.dtype)
    dv = dv.reshape(B, Hkv, G, S, d).sum(2).to(v.dtype)
    return dq.to(q.dtype), dk, dv


def flash_attention_bwd_reference(q, k, v, out, lse, do, scale: float,
                                  causal: bool = True, q_offset: int = 0,
                                  window: Optional[int] = None,
                                  kv_valid: Optional[int] = None):
    """Plain PyTorch version of the backward (delta, then dK/dV and dQ).
    Returns (dq, dk, dv) in the input dtypes."""
    return flash_bwd_plain(q, k, v, do, lse, softmax_delta(do, out), scale,
                           causal, q_offset, window, kv_valid)


@functools.lru_cache(maxsize=None)
def _kernels():
    """The three C entry points of csrc/flash_attention.cu, built at first
    use."""
    lib = _build.load("flash_attention")
    tail = [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p]
    fns = (lib.k2_flash_fwd, lib.k2_flash_dkdv, lib.k2_flash_dq)
    for fn, n_ptr in zip(fns, (5, 8, 7)):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + tail
    return fns


def _check(q, k, v, q_offset, window, kv_valid, rows=()):
    """Validates what the kernels take; returns (B, Hq, Hkv, T, S, d,
    kv_len)."""
    B, Hq, T, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    Hkv, S = k.shape[1], k.shape[2]
    if max(B * Hq * T, B * Hkv * S) > MAX_ROWS:
        raise ValueError(f"B * heads * rows must stay below 2^31 (32-bit "
                         f"TMA coordinates), got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    tensors = (q, k, v) + tuple(rows)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("flash attention: every tensor must be on q's CUDA "
                         "device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash attention: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash attention: tensors must be 16-byte aligned "
                         "(the kernels load 16 bytes a lane)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share bfloat16 or float32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS or Hq % Hkv or min(B, T, S) < 1:
        raise ValueError(f"kernel takes d in {HEAD_DIMS}, Hq % Hkv == 0 and "
                         f"non-empty shapes, got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    kv_len = S if kv_valid is None else int(kv_valid)
    if not 1 <= kv_len <= S:
        raise ValueError(f"kv_valid must be in [1, {S}], got {kv_valid}")
    if int(q_offset) < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if window is not None and int(window) <= 0:
        raise ValueError(f"window must be positive, got {window}")
    return B, Hq, Hkv, T, S, d, kv_len


def _check_rows(q, *rows):
    B, Hq, T, _ = q.shape
    for r in rows:
        if r.dtype != torch.float32 or tuple(r.shape) != (B, Hq, T):
            raise ValueError(f"lse and delta must be float32 {(B, Hq, T)}, "
                             f"got {r.dtype} {tuple(r.shape)}")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _tail(dims, q_offset, causal, window, scale, q):
    B, Hq, Hkv, T, S, d, kv_len = dims
    return (B, Hq, Hkv, T, S, d, kv_len, int(q_offset), 1 if causal else 0,
            0 if window is None else int(window), float(scale),
            1 if q.dtype == torch.bfloat16 else 0,
            DESIGNS.index(kernel_design(q.dtype, d)),
            torch.cuda.current_stream(q.device).cuda_stream)


def flash_fwd(q, k, v, scale: float, causal: bool = True, q_offset: int = 0,
              window: Optional[int] = None, kv_valid: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel (K2f): (out, lse)."""
    if not q.is_cuda:
        return flash_attention_fwd_reference(q, k, v, scale, causal,
                                             q_offset, window, kv_valid)
    dims = _check(q, k, v, q_offset, window, kv_valid)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _raise_on(_kernels()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), lse.data_ptr(),
                            *_tail(dims, q_offset, causal, window, scale, q)),
              "k2_flash_fwd")
    flash_fwd.launches += 1
    return out, lse


def flash_dkdv(q, k, v, do, lse, delta, scale: float, causal: bool = True,
               q_offset: int = 0, window: Optional[int] = None,
               kv_valid: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel (K2b): (dk, dv) at (B, Hkv, S, d), summed over each
    kv head's query group."""
    if not q.is_cuda:
        _, dk, dv = flash_bwd_plain(q, k, v, do, lse, delta, scale, causal,
                                    q_offset, window, kv_valid)
        return dk, dv
    dims = _check(q, k, v, q_offset, window, kv_valid, rows=(do, lse, delta))
    _check_rows(q, lse, delta)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("dO must match q's shape and dtype")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _raise_on(_kernels()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                            dk.data_ptr(), dv.data_ptr(),
                            *_tail(dims, q_offset, causal, window, scale, q)),
              "k2_flash_dkdv")
    flash_dkdv.launches += 1
    return dk, dv


def flash_dq(q, k, v, do, lse, delta, scale: float, causal: bool = True,
             q_offset: int = 0, window: Optional[int] = None,
             kv_valid: Optional[int] = None) -> torch.Tensor:
    """The dQ kernel (K2q)."""
    if not q.is_cuda:
        dq, _, _ = flash_bwd_plain(q, k, v, do, lse, delta, scale, causal,
                                   q_offset, window, kv_valid)
        return dq
    dims = _check(q, k, v, q_offset, window, kv_valid, rows=(do, lse, delta))
    _check_rows(q, lse, delta)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError("dO must match q's shape and dtype")
    dq = torch.empty_like(q)
    _raise_on(_kernels()[2](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                            dq.data_ptr(),
                            *_tail(dims, q_offset, causal, window, scale, q)),
              "k2_flash_dq")
    flash_dq.launches += 1
    return dq


flash_fwd.launches = 0
flash_dkdv.launches = 0
flash_dq.launches = 0


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, q_offset, window, kv_valid):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_fwd(q, k, v, scale, causal, q_offset, window,
                             kv_valid)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, q_offset, window, kv_valid)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        do = g.contiguous()
        delta = softmax_delta(do, out)
        dk, dv = flash_dkdv(q, k, v, do, lse, delta, *ctx.args)
        dq = flash_dq(q, k, v, do, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, scale: float, causal: bool = True,
                    q_offset: int = 0, window: Optional[int] = None,
                    kv_valid: Optional[int] = None) -> torch.Tensor:
    """Fused attention of q (B, Hq, T, d) over k/v (B, Hkv, S, d), with
    gradients for q, k and v. Returns (B, Hq, T, d) in q's dtype."""
    return _FlashAttention.apply(q, k, v, scale, causal, q_offset, window,
                                 kv_valid)
