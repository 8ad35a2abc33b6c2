"""Llama-3 decoder over a static KV ring, in PyTorch.

Counterpart of ``videollm_online_tpu/models/llama.py`` (inference with a KV
cache; training, paged caches and int8 KV are later slices). Parameters are
the JAX package's tree: ``layers`` leaves are stacked on a leading layer
axis, and a quantized matrix is a ``{"q8", "scale"}`` dict
(models/quant.py). The layer ``scan`` is a Python loop over layer indices
that writes each layer's new K/V into the stacked ring and calls the
attention's ``layered`` form on it.

The ring ``KVCache.k``/``v`` (L, B, Hkv, C, hd) lives on the device and is
updated IN PLACE by ``forward`` (the JAX package relied on buffer donation
instead). The offsets are host bookkeeping: ``offset``/``pos_base`` are
int32 CPU tensors, so appends need no device readback.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import LlamaConfig
from ..core.device import resolve_device, torch_dtype

Params = Dict[str, Any]


def init_params(generator: torch.Generator, cfg: LlamaConfig, device=None
                ) -> Params:
    """Random decoder weights, N(0, 0.02) matrices and unit norms, drawn from
    ``generator`` (which must live on ``device``)."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    L, D, F_ = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=device)
                * 0.02).to(dtype)

    layers = {
        "attn_norm": torch.ones((L, D), dtype=dtype, device=device),
        "mlp_norm": torch.ones((L, D), dtype=dtype, device=device),
        "wq": normal(L, D, cfg.q_dim), "wk": normal(L, D, cfg.kv_dim),
        "wv": normal(L, D, cfg.kv_dim), "wo": normal(L, cfg.q_dim, D),
        "w_gate": normal(L, D, F_), "w_up": normal(L, D, F_),
        "w_down": normal(L, F_, D),
    }
    if cfg.attention_bias:
        for name, dim in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                          ("bv", cfg.kv_dim)):
            layers[name] = torch.zeros((L, dim), dtype=dtype, device=device)
    params = {"embed": normal(cfg.vocab_size, D), "layers": layers,
              "final_norm": torch.ones((D,), dtype=dtype, device=device)}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = normal(D, cfg.vocab_size)
    return params


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return xf.to(x.dtype) * weight


def dense(x: torch.Tensor, w, lora: Optional[Dict] = None,
          scaling: float = 1.0) -> torch.Tensor:
    """x @ w for a plain or int8 ``{"q8","scale"}`` weight, plus the
    inference LoRA branch ``scaling * (x A^T) B^T`` (no dropout)."""
    if isinstance(w, dict):
        from .quant import quantized_matmul
        y = quantized_matmul(x, w)
    else:
        y = x @ w
    if lora is not None:
        y = y + scaling * ((x @ lora["lora_a"].transpose(-1, -2))
                           @ lora["lora_b"].transpose(-1, -2))
    return y


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., T) int -> cos/sin (..., T, head_dim) fp32, HF layout
    (the first half's angles duplicated into the second half)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, H, T, hd); cos/sin: (B, T, hd), cast to x's dtype first."""
    c = cos[:, None].to(x.dtype)
    s = sin[:, None].to(x.dtype)
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * c + rotated * s


@dataclass
class KVCache:
    """Static-shape KV ring: k/v (L, B, Hkv, C, hd) on the device, written
    in place; ``offset`` (B,) int32 on the CPU = valid slots per stream;
    ``pos_base`` (B,) int32 on the CPU = absolute position of slot 0.

    Appends pack valid tokens first; bucket padding is written past the end
    and overwritten by the next append (never attended: the mask is
    ``slot <= q_position``)."""
    k: torch.Tensor
    v: torch.Tensor
    offset: torch.Tensor
    pos_base: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.k.shape[3]

    def replace(self, **kw) -> "KVCache":
        return dataclasses.replace(self, **kw)


def init_kv_cache(cfg: LlamaConfig, batch: int, capacity: int, dtype=None,
                  quant: Optional[str] = None, device=None) -> KVCache:
    if quant is not None:
        raise NotImplementedError("int8 KV caches are a later slice")
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, capacity, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        offset=torch.zeros((batch,), dtype=torch.int32),
        pos_base=torch.zeros((batch,), dtype=torch.int32))


def trim_kv_cache(cache: KVCache, new_offset) -> KVCache:
    """Rewind to ``new_offset`` valid slots: stale slots past it are never
    attended and are overwritten by the next append."""
    off = torch.as_tensor(new_offset, dtype=torch.int32).expand(
        cache.offset.shape).clone()
    return cache.replace(offset=off)


def _attention(q, k, v, q_pos, kv_valid_upto, *, num_groups,
               sliding_window: Optional[int] = None, k_scale=None,
               v_scale=None):
    """Masked GQA attention, the plain path (the JAX package's XLA path).

    q: (B, Hq, S, hd); k/v: (B, Hkv, C, hd); q_pos: (B, S) slot-relative
    positions. Slot j is visible iff j <= q_pos (and j > q_pos - window).
    Logits and softmax in fp32, probabilities cast to q's dtype."""
    hd = q.shape[-1]
    C = k.shape[2]
    if k_scale is not None:
        k = (k.float() * k_scale[..., None]).to(q.dtype)
        v = (v.float() * v_scale[..., None]).to(q.dtype)
    if num_groups > 1:
        k = k.repeat_interleave(num_groups, dim=1)
        v = v.repeat_interleave(num_groups, dim=1)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    slot = torch.arange(C, device=q.device)
    qp = q_pos[:, None, :, None]
    mask = slot <= qp
    if sliding_window is not None:
        mask = mask & (slot > qp - sliding_window)
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _windowed(impl, window: int):
    """Bind a sliding window into an attention impl, keeping its
    ``layered`` form when it has one."""
    def wrapped(q, k, v, q_pos, kv_valid_upto, *, num_groups, **kw):
        return impl(q, k, v, q_pos, kv_valid_upto, num_groups=num_groups,
                    sliding_window=window, **kw)
    layered = getattr(impl, "layered", None)
    if layered is not None:
        def wrapped_layered(q, k_all, v_all, q_pos, layer, *, num_groups,
                            **kw):
            return layered(q, k_all, v_all, q_pos, layer,
                           num_groups=num_groups, sliding_window=window, **kw)
        wrapped.layered = wrapped_layered
    return wrapped


def _index_tree(tree, i: int):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return tree[i]


def _layer(h, lp, ll, cos, sin, q_pos, kv_ctx, cfg: LlamaConfig,
           lora_scaling, attn_impl):
    """One transformer block. ``kv_ctx`` = (k_all, v_all, starts, layer):
    this layer's K/V are written into the stacked ring at ``starts`` (one
    host int per stream) and attention reads the ring at ``layer``."""
    B, S, _ = h.shape
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def dns(x, name):
        return dense(x, lp[name], None if ll is None else ll.get(name),
                     lora_scaling)

    x = rms_norm(h, lp["attn_norm"], cfg.rms_norm_eps)
    q, k, v = dns(x, "wq"), dns(x, "wk"), dns(x, "wv")
    if cfg.attention_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(B, S, Hq, hd).transpose(1, 2)
    k = k.reshape(B, S, Hkv, hd).transpose(1, 2)
    v = v.reshape(B, S, Hkv, hd).transpose(1, 2)
    q = apply_rope(q, cos, sin).contiguous()
    k = apply_rope(k, cos, sin)

    if kv_ctx is not None:
        k_all, v_all, starts, layer = kv_ctx
        for b, start in enumerate(starts):
            k_all[layer, b, :, start:start + S] = k[b]
            v_all[layer, b, :, start:start + S] = v[b]
        layered = getattr(attn_impl, "layered", None)
        if layered is not None:
            attn_out = layered(q, k_all, v_all, q_pos, layer,
                               num_groups=Hq // Hkv)
        else:
            attn_out = attn_impl(q, k_all[layer], v_all[layer], q_pos, None,
                                 num_groups=Hq // Hkv)
    else:
        attn_out = attn_impl(q, k, v, q_pos, None, num_groups=Hq // Hkv)

    attn_out = attn_out.transpose(1, 2).reshape(B, S, Hq * hd)
    h = h + dns(attn_out, "wo")
    x = rms_norm(h, lp["mlp_norm"], cfg.rms_norm_eps)
    return h + dns(F.silu(dns(x, "w_gate")) * dns(x, "w_up"), "w_down")


def forward(
    params: Params,
    *,
    cfg: LlamaConfig,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    kv_cache: Optional[KVCache] = None,
    num_valid=None,
    lora: Optional[Params] = None,
    lora_scaling: float = 1.0,
    attn_impl=None,
    return_hidden: bool = False,
    last_logit_only: bool = False,
    logit_gather_positions: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder.

    Without a cache: full causal forward over (B, S). With a cache: writes
    the (B, S) chunk into the ring at ``kv_cache.offset`` per stream
    (``num_valid`` (B,) of the S tokens are real, the rest is bucket
    padding) and attends over the ring. The write start is clamped into the
    ring as ``jax.lax.dynamic_update_slice`` clamps it. Returns (logits,
    cache) where the cache shares the ring and has ``offset + num_valid``.
    """
    attn_impl = attn_impl or _attention
    if cfg.sliding_window is not None:
        attn_impl = _windowed(attn_impl, cfg.sliding_window)
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(params, input_ids, cfg)
    h = inputs_embeds
    B, S, _ = h.shape
    dev = h.device

    if positions is None:
        base = (kv_cache.pos_base + kv_cache.offset if kv_cache is not None
                else torch.zeros((B,), dtype=torch.int32))
        positions = base[:, None] + torch.arange(S, dtype=torch.int32)[None]
    positions = positions.to(device=dev, dtype=torch.int32)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    layer_lora = (lora or {}).get("layers") or None

    if kv_cache is not None:
        attn_pos = (positions - kv_cache.pos_base.to(dev)[:, None]).to(
            torch.int32).contiguous()
        C = kv_cache.capacity
        starts = [min(max(int(o), 0), C - S) for o in kv_cache.offset]
        for i in range(cfg.num_layers):
            h = _layer(h, _index_tree(params["layers"], i),
                       _index_tree(layer_lora, i), cos, sin, attn_pos,
                       (kv_cache.k, kv_cache.v, starts, i), cfg,
                       lora_scaling, attn_impl)
        nv = (torch.full((B,), S, dtype=torch.int32) if num_valid is None
              else torch.as_tensor(num_valid, dtype=torch.int32).cpu())
        new_cache = kv_cache.replace(offset=kv_cache.offset + nv)
    else:
        for i in range(cfg.num_layers):
            h = _layer(h, _index_tree(params["layers"], i),
                       _index_tree(layer_lora, i), cos, sin, positions,
                       None, cfg, lora_scaling, attn_impl)
        new_cache = None

    if logit_gather_positions is not None:
        # (B,) or (B, G) positions within the chunk
        pos = torch.as_tensor(logit_gather_positions).to(dev).long()
        if pos.ndim == 2:
            h = torch.take_along_dim(h, pos[..., None], dim=1)
        else:
            h = h[torch.arange(B, device=dev), pos][:, None]
    elif last_logit_only:
        h = h[:, -1:]
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    if return_hidden:
        return h, new_cache
    return lm_head(params, h, cfg, lora=lora, lora_scaling=lora_scaling), \
        new_cache


def embed_tokens(params: Params, input_ids: torch.Tensor, cfg: LlamaConfig
                 ) -> torch.Tensor:
    """Token embedding; ids are clamped into the vocab so the out-of-vocab
    ``<v>`` placeholder id is safe. int8 rows are multiplied by their
    per-row scale in the model dtype."""
    embed = params["embed"]
    table = embed["q8"] if isinstance(embed, dict) else embed
    ids = torch.as_tensor(input_ids).to(table.device).long().clamp(
        0, cfg.vocab_size - 1)
    if isinstance(embed, dict):
        dtype = torch_dtype(cfg.dtype)
        return embed["q8"][ids].to(dtype) * embed["scale"][ids][..., None].to(dtype)
    return embed[ids]


def lm_head(params: Params, h: torch.Tensor, cfg: LlamaConfig, *,
            lora: Optional[Params] = None, lora_scaling: float = 1.0
            ) -> torch.Tensor:
    if cfg.tie_word_embeddings:
        if isinstance(params["embed"], dict):
            raise ValueError("tied embeddings are not supported with int8 "
                             "weights")
        w = params["embed"].T
    else:
        w = params["lm_head"]
    return dense(h, w, (lora or {}).get("lm_head"), lora_scaling)
