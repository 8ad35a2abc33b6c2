"""Llama-3 decoder over a static KV ring or a paged KV pool, in PyTorch.

Counterpart of ``videollm_online_tpu/models/llama.py``: inference with a KV
ring (``KVCache``) or a shared page pool (``PagedKVCache``), either in the
model dtype or as int8 codes with per-slot scales, and the cache-free
training forward with LoRA, LoRA-input dropout, per-layer or grouped
remat and the sequence-sliced MLP (``LlamaConfig.mlp_chunk``).
Parameters are the JAX package's tree: ``layers`` leaves are stacked on a
leading layer axis, and a quantized matrix is a ``{"q8" | "q4c" | "q4p",
"scale"}`` dict (models/quant.py). A layer's MLP goes to the whole-MLP
kernel where ``ops.fused_mlp.maybe_fused`` dispatches it. The layer ``scan`` is a Python loop over layer indices
that writes each layer's new K/V into the stacked ring and calls the
attention's ``layered`` form on it.

The ring ``KVCache.k``/``v`` (L, B, Hkv, C, hd) and the pools of
``PagedKVCache`` live on the device and are updated IN PLACE by ``forward``
(the JAX package relied on buffer donation instead). The offsets and the
page table are host bookkeeping: ``offset``/``pos_base``/``table`` are
int32 CPU tensors, so appends need no device readback.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.config import LlamaConfig, LoraConfig
from ..core.device import resolve_device, to_device, torch_dtype
from ..ops import fused_mlp
from ..parallel import collectives as coll
from ..parallel.context import ParallelContext, local_kv_heads
from ..parallel.mesh import MODEL_AXIS
from ..parallel.sharding import MATRICES, logical_shape

Params = Dict[str, Any]

# what this decoder serves in the batched engine
# (serve/multistream.py::decoder_module reads these): its config type, the
# batched ring cache besides the paged pool, a tensor- or sequence-parallel
# mesh
CONFIG = LlamaConfig
RING = True
MESH = True


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


_LORA_NAMES = {"q_proj": "wq", "k_proj": "wk", "v_proj": "wv",
               "o_proj": "wo", "gate_proj": "w_gate", "up_proj": "w_up",
               "down_proj": "w_down"}
_PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def init_lora_params(generator: torch.Generator, cfg: LlamaConfig,
                     lora: LoraConfig, device=None) -> Params:
    """LoRA overlay tree, the JAX package's layout: ``layers`` leaves
    ``lora_a`` (L, r, in) ~ N(0, 1/r) and ``lora_b`` (L, out, r) = 0, and an
    ``lm_head`` pair (r, D) / (V, r), drawn from ``generator`` (which must
    live on ``device``)."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    L, D, F_, r = (cfg.num_layers, cfg.hidden_size, cfg.intermediate_size,
                   lora.r)
    dims = {"wq": (D, cfg.q_dim), "wk": (D, cfg.kv_dim),
            "wv": (D, cfg.kv_dim), "wo": (cfg.q_dim, D),
            "w_gate": (D, F_), "w_up": (D, F_), "w_down": (F_, D)}
    targets = {_LORA_NAMES[t] for t in lora.target_modules
               if t in _LORA_NAMES}

    def pair(shape_a, shape_b):
        a = torch.randn(shape_a, generator=generator, device=device)
        return {"lora_a": (a / np.sqrt(r)).to(dtype),
                "lora_b": torch.zeros(shape_b, dtype=dtype, device=device)}

    out = {"layers": {name: pair((L, r, din), (L, dout, r))
                      for name, (din, dout) in dims.items()
                      if name in targets}}
    if "lm_head" in lora.target_modules:
        out["lm_head"] = pair((r, D), (cfg.vocab_size, r))
    return out


def fold_seed(seed: int, *ids: int) -> int:
    """A dropout seed that depends only on ``seed`` and ``ids`` (step,
    microbatch, layer, projection): a remat recompute folds the same ids
    and so draws the same mask. ``torch.utils.checkpoint`` restores only
    the global RNG states, so an explicit generator carried across the
    forward would draw another mask in the recompute."""
    for i in ids:
        seed = (seed * 6364136223846793005 + 1442695040888963407 + int(i)
                ) % (1 << 63)
    return seed


def dropout(x: torch.Tensor, rate: float, seed: int,
            region: Optional[Tuple[tuple, tuple]] = None) -> torch.Tensor:
    """Inverted dropout: keep with probability 1 - rate and scale by
    1 / (1 - rate), in x's dtype; the mask comes from a fresh generator
    seeded with ``seed`` (the JAX package draws ``bernoulli`` from a
    folded key, so the masks differ, not their law). ``region`` = (the
    global shape, x's offsets in it): a rank's shard of a batch, sequence
    or column range draws the mask of the whole tensor and takes its
    block (an offset may be an index tensor: those rows), so a sharded
    step drops what the single-rank step drops."""
    g = torch.Generator(device=x.device)
    g.manual_seed(seed)
    if region is None:
        u = torch.rand(x.shape, generator=g, device=x.device)
    else:
        shape, offsets = region
        u = torch.rand(shape, generator=g, device=x.device)
        for d, o in enumerate(offsets):
            u = (u.index_select(d, o) if isinstance(o, torch.Tensor)
                 else u.narrow(d, o, x.shape[d]))
    keep = u < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return xf.to(x.dtype) * weight


def dense(x: torch.Tensor, w, lora: Optional[Dict] = None,
          scaling: float = 1.0, drop_seed: Optional[int] = None,
          drop_rate: float = 0.0, drop_region=None,
          tile_cols: Optional[int] = None) -> torch.Tensor:
    """x @ w for a plain or quantized (int8 ``q8``, int4 ``q4c`` / ``q4p``,
    models/quant.py) weight, plus the LoRA
    branch ``scaling * (x A^T) B^T``; with ``drop_seed`` and a rate, the
    branch's input goes through dropout first (PEFT's lora_dropout; a
    shard's mask is cut from ``drop_region``, see ``dropout``). With
    ``tile_cols`` an int8 weight is applied one column tile at a time
    (``quant.quantized_matmul``); other weights ignore it."""
    if isinstance(w, dict):
        from .quant import quantized_matmul
        y = quantized_matmul(x, w, tile_cols)
    else:
        y = x @ w
    if lora is not None:
        xl = x
        if drop_seed is not None and drop_rate > 0.0:
            xl = dropout(x, drop_rate, drop_seed, drop_region)
        y = y + scaling * ((xl @ lora["lora_a"].transpose(-1, -2))
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
    ``slot <= q_position``).

    int8 mode: k/v hold int8 codes and ``k_scale``/``v_scale``
    (L, B, Hkv, C) fp32 the per-token-per-head symmetric scales
    (``x ~ code * scale``), quantized at append."""
    k: torch.Tensor
    v: torch.Tensor
    offset: torch.Tensor
    pos_base: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def replace(self, **kw) -> "KVCache":
        return dataclasses.replace(self, **kw)


def _kv_pools(shape, dtype, quant: Optional[str], device):
    """Zeroed k, v (and for int8, fp32 scale pools of shape[:-1])."""
    if quant is not None and quant != "int8":
        raise ValueError(f"unsupported kv quant {quant!r}")
    if quant is None:
        return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                    v=torch.zeros(shape, dtype=dtype, device=device))
    return dict(k=torch.zeros(shape, dtype=torch.int8, device=device),
                v=torch.zeros(shape, dtype=torch.int8, device=device),
                k_scale=torch.zeros(shape[:-1], device=device),
                v_scale=torch.zeros(shape[:-1], device=device))


def init_kv_cache(cfg: LlamaConfig, batch: int, capacity: int, dtype=None,
                  quant: Optional[str] = None, device=None) -> KVCache:
    shape = (cfg.num_layers, batch, local_kv_heads(cfg), capacity,
             cfg.head_dim)
    return KVCache(
        **_kv_pools(shape, dtype or torch_dtype(cfg.dtype), quant,
                    resolve_device(device)),
        offset=torch.zeros((batch,), dtype=torch.int32),
        pos_base=torch.zeros((batch,), dtype=torch.int32))


@dataclass
class PagedKVCache:
    """Paged KV: a physical page pool shared by all streams plus per-stream
    page tables (``ops/paged_attention.py``).

    k/v (L, P, Hkv, page, hd) on the device; ``table`` (B, MAXP) int32 on
    the CPU maps stream b's logical page j to a pool page; ``offset`` /
    ``pos_base`` have the ring's semantics. Logical slot i of stream b
    lives at pool[l, table[b, i // page], :, i % page]. The host owns page
    allocation (serve/multistream.py); pool page 0 is the trash page that
    unmapped table entries point at. int8 mode adds fp32 scale pools
    (L, P, Hkv, page), paged like the codes."""
    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor
    offset: torch.Tensor
    pos_base: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def capacity(self) -> int:  # per-stream logical capacity
        return self.table.shape[1] * self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def pools(self):
        """Every tensor paged by ``table``: the codes, then any scales."""
        return [self.k, self.v] + ([self.k_scale, self.v_scale]
                                   if self.quantized else [])

    def replace(self, **kw) -> "PagedKVCache":
        return dataclasses.replace(self, **kw)


def init_paged_kv_cache(cfg: LlamaConfig, batch: int, *, pool_pages: int,
                        pages_per_stream: int, page_size: int = 512,
                        dtype=None, quant: Optional[str] = None,
                        device=None) -> PagedKVCache:
    shape = (cfg.num_layers, pool_pages, local_kv_heads(cfg), page_size,
             cfg.head_dim)
    return PagedKVCache(
        **_kv_pools(shape, dtype or torch_dtype(cfg.dtype), quant,
                    resolve_device(device)),
        table=torch.zeros((batch, pages_per_stream), dtype=torch.int32),
        offset=torch.zeros((batch,), dtype=torch.int32),
        pos_base=torch.zeros((batch,), dtype=torch.int32))


def paged_slots(table: torch.Tensor, offset: torch.Tensor, page: int,
                S: int, num_valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Physical (page, row) of every slot an S-token append writes, (B * S,)
    int64 each, computed once per forward on the host: token j of stream b
    goes to logical slot offset[b] + j, at pool page
    table[b, slot // page], row slot % page. Padding past the stream's
    mapped pages lands on trash page 0 through the table's zero entries.

    The JAX package (``_paged_append``) clips a logical page past the
    table to the last one, which the engine's capacity guard never lets a
    valid token reach. Here a VALID token past the table raises instead,
    and padding past it goes to the trash page (JAX's clip would write it
    over the stream's last page)."""
    B, maxp = table.shape
    slot = offset.long()[:, None] + torch.arange(S)[None]          # (B, S)
    lp = slot // page
    past = lp >= maxp
    if bool(past.any()):
        valid = torch.arange(S)[None] < num_valid.long()[:, None]
        if bool((past & valid).any()):
            raise ValueError(f"paged append past the page table: offsets "
                             f"{offset.tolist()} + {num_valid.tolist()} "
                             f"valid tokens > {maxp} pages of {page}")
    phys = torch.where(past, 0, torch.gather(
        table.long(), 1, lp.clamp(max=maxp - 1)))
    return phys.reshape(-1), (slot % page).reshape(-1)


def paged_append(pool: torch.Tensor, layer: int, phys: torch.Tensor,
                 row: torch.Tensor, x: torch.Tensor) -> None:
    """Write x (B, Hkv, S[, hd]) into ``pool[layer]`` (P, Hkv, page[, hd])
    at the pool rows ``paged_slots`` gave, in one indexed store (the pools
    and the scale pools alike)."""
    B, S = x.shape[0], x.shape[2]
    pool[layer][phys, :, row] = x.transpose(1, 2).reshape(
        (B * S,) + x.shape[1:2] + x.shape[3:]).to(pool.dtype)


def trim_kv_cache(cache: KVCache, new_offset) -> KVCache:
    """Rewind to ``new_offset`` valid slots: stale slots past it are never
    attended and are overwritten by the next append."""
    off = torch.as_tensor(new_offset, dtype=torch.int32).expand(
        cache.offset.shape).clone()
    return cache.replace(offset=off)


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(head, token) symmetric int8: x (..., hd) -> codes int8 (..., hd)
    and fp32 scales (...,) with ``x ~ codes * scale``; the JAX package's
    arithmetic, so codes and scales are bit-identical to it."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    safe = torch.clamp(scale, min=1e-12)
    codes = torch.clamp(torch.round(xf / safe[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def compact_kv_cache(cache: KVCache, keep) -> KVCache:
    """Move each stream's newest ``keep`` slots to the front of its ring (in
    place) and advance ``pos_base`` so absolute positions are unchanged;
    everything older is evicted. ``keep``: int or (B,)."""
    B = cache.k.shape[1]
    keep = torch.minimum(
        torch.as_tensor(keep, dtype=torch.int32).expand(B), cache.offset)
    shift = cache.offset - keep
    pools = [cache.k, cache.v] + ([cache.k_scale, cache.v_scale]
                                  if cache.quantized else [])
    for b in range(B):
        s = int(shift[b])
        if s:
            for pool in pools:
                pool[:, b] = torch.roll(pool[:, b], -s, dims=2)
    return cache.replace(offset=keep.clone(), pos_base=cache.pos_base + shift)


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


def _drop_region(x, rows, cols=None):
    """(global shape, offsets) of a LoRA input x (B, S, K) for ``dropout``:
    ``rows`` = (batch start, global batch, position start, global length)
    of a batch or sequence shard, ``cols`` = (start, global width) of a
    tensor-parallel column range; None when x is the whole tensor."""
    if rows is None and cols is None:
        return None
    b0, Bg, s0, Tg = rows if rows is not None else (0, x.shape[0], 0,
                                                    x.shape[1])
    k0, Kg = cols if cols is not None else (0, x.shape[2])
    return (Bg, Tg, Kg), (b0, s0, k0)


def _layer(h, lp, ll, cos, sin, q_pos, kv_ctx, cfg: LlamaConfig,
           lora_scaling, attn_impl, drop_seed=None, lora_dropout=0.0,
           par: Optional[ParallelContext] = None, rows=None):
    """One transformer block. ``kv_ctx`` = (cache, starts, layer) for a
    ring: this layer's K/V (int8 codes and scales for an int8 ring) are
    written into the stacked ring at ``starts`` (one host int per stream)
    and attention reads the ring at ``layer``. For a paged pool it is
    (cache, (table, phys, row), layer): K/V go to the pool rows ``phys``,
    ``row`` (``paged_slots``) with one indexed store per pool, and
    attention is ``ops.paged_attention`` whatever ``attn_impl`` is, as in
    the JAX package. ``drop_seed`` (the layer's) seeds each projection's
    LoRA dropout. Under a mesh (``par``) the layer's weight shards are
    gathered and its LoRA and biases cut as ``parallel/context.py`` says,
    the row-parallel products are summed over the model axis, and
    ``rows`` places a batch or sequence shard's dropout masks. With
    ``cfg.mlp_chunk`` (S a multiple of it and larger) the MLP runs in
    sequence slices (``_mlp_seq_chunked``)."""
    B, S, _ = h.shape
    hd = cfg.head_dim
    Hq, Hkv = (cfg.num_heads, cfg.num_kv_heads) if par is None \
        else par.heads()
    if par is not None:
        lp = {k: (par.weight(v, k) if k in MATRICES else
                  par.bias(v, "w" + k[1]) if k in ("bq", "bk", "bv") else v)
              for k, v in lp.items()}
        if ll is not None:
            ll = {k: par.lora(v, k) for k, v in ll.items()}

    def dns(x, name, at=None):
        # ``at``: x is the sequence slice of the layer's input starting at
        # that position (an MLP slice): its mask is cut from the whole draw
        seed = (None if drop_seed is None
                else fold_seed(drop_seed, _PROJECTIONS.index(name)))
        cols = None
        if par is not None and par.ranges is not None and \
                name in ("wo", "w_down"):
            full_in = cfg.q_dim if name == "wo" else cfg.intermediate_size
            cols = (par.col_range(name)[0], full_in)
        where = rows
        if at is not None:
            b0, Bg, s0, Tg = rows if rows is not None else (0, B, 0, S)
            where = (b0, Bg, s0 + at, Tg)
        region = (_drop_region(x, where, cols) if seed is not None
                  and lora_dropout > 0.0 else None)
        return dense(x, lp[name], None if ll is None else ll.get(name),
                     lora_scaling, seed, lora_dropout, region)

    def reduce(y):
        return y if par is None else par.reduce(y)

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
        cache, where, layer = kv_ctx
        sc = {}
        if cache.quantized:
            k, k_sc = quantize_kv(k)
            v, v_sc = quantize_kv(v)
            stores = ((cache.k, k), (cache.v, v), (cache.k_scale, k_sc),
                      (cache.v_scale, v_sc))
            sc = {"k_scale": cache.k_scale, "v_scale": cache.v_scale}
        else:
            stores = ((cache.k, k), (cache.v, v))
        if isinstance(cache, PagedKVCache):
            table, phys, row = where
            for pool, x in stores:
                paged_append(pool, layer, phys, row, x)
            from ..ops.paged_attention import paged_attention
            attn_out = paged_attention(q, cache.k, cache.v, table, q_pos,
                                       layer, window=cfg.sliding_window, **sc)
        else:
            for pool, x in stores:
                for b, start in enumerate(where):
                    pool[layer, b, :, start:start + S] = x[b]
            layered = getattr(attn_impl, "layered", None)
            if layered is not None:
                attn_out = layered(q, cache.k, cache.v, q_pos, layer,
                                   num_groups=Hq // Hkv, **sc)
            else:
                attn_out = attn_impl(q, cache.k[layer], cache.v[layer], q_pos,
                                     None, num_groups=Hq // Hkv,
                                     **{n: t[layer] for n, t in sc.items()})
    else:
        attn_out = attn_impl(q, k, v, q_pos, None, num_groups=Hq // Hkv)

    attn_out = attn_out.transpose(1, 2).reshape(B, S, Hq * hd)
    h = h + reduce(dns(attn_out, "wo"))
    x = rms_norm(h, lp["mlp_norm"], cfg.rms_norm_eps)
    fused = fused_mlp.maybe_fused(x, lp, ll)
    if fused is not None:
        return h + reduce(fused).to(h.dtype)
    if cfg.mlp_chunk and S > cfg.mlp_chunk and S % cfg.mlp_chunk == 0:
        return h + reduce(_mlp_seq_chunked(x, dns, cfg.mlp_chunk))
    return h + reduce(dns(F.silu(dns(x, "w_gate")) * dns(x, "w_up"),
                          "w_down"))


def _mlp_seq_chunked(x, dns, chunk: int) -> torch.Tensor:
    """The SwiGLU MLP over (B, chunk, D) sequence slices of x (B, S, D),
    joined on the sequence (``cfg.mlp_chunk``). The MLP mixes features
    only, so each position's value is the unsliced one; the backward's
    (S, intermediate) temps shrink to one slice's, as each slice runs under
    ``torch.utils.checkpoint`` when autograd records (it keeps only its
    input slice). A slice's LoRA dropout masks are cut from the whole
    layer's draws (``dns``'s ``at``), so the sliced MLP drops what the
    whole one drops. Under a mesh the row-parallel ``w_down`` partial sums
    are reduced by the caller once over the joined slices, as for the
    whole MLP."""
    def body(xc, at):
        return dns(F.silu(dns(xc, "w_gate", at)) * dns(xc, "w_up", at),
                   "w_down", at)

    parts = []
    for at in range(0, x.shape[1], chunk):
        xc = x[:, at:at + chunk]
        parts.append(checkpoint(body, xc, at, use_reentrant=False)
                     if torch.is_grad_enabled() else body(xc, at))
    return torch.cat(parts, dim=1)


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
    remat: bool = False,
    attn_impl=None,
    return_hidden: bool = False,
    last_logit_only: bool = False,
    logit_gather_positions: Optional[torch.Tensor] = None,
    dropout_seed: Optional[int] = None,
    lora_dropout: float = 0.0,
    shard_rows: Optional[Tuple[int, int, int, int]] = None,
    remat_group: int = 1,
    decode_graph: Optional["DecodeGraph"] = None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder.

    Without a cache: full causal forward over (B, S), the training path:
    with ``remat`` each layer runs under ``torch.utils.checkpoint`` (its
    activations are recomputed in the backward; with ``remat_group`` G > 1
    dividing the depth, an outer checkpoint over each group of G
    checkpointed layers keeps only the groups' inputs, for one more
    forward of each layer in the backward), and with ``dropout_seed``
    and ``lora_dropout`` every LoRA branch (the head's too) drops its input;
    layer i's masks are seeded by ``fold_seed(dropout_seed, i)`` and the
    head's by ``fold_seed(dropout_seed, num_layers)``. With a cache: writes
    the (B, S) chunk into the ring (or the paged pool) at
    ``kv_cache.offset`` per stream (``num_valid`` (B,) of the S tokens are
    real, the rest is bucket padding) and attends over it. A ring write's
    start is clamped into the ring as ``jax.lax.dynamic_update_slice``
    clamps it. Returns (logits, cache) where the cache shares the ring or
    pool and has ``offset + num_valid``.

    Under a mesh (``parallel.mesh.maybe_mesh``) ``params`` is the
    rank-local tree of ``train.step.shard_params`` and the forward runs
    tensor parallel, or sequence parallel when ``attn_impl`` is a ring or
    Ulysses attention (``parallel/context.py``); the logits are whole on
    every rank. ``shard_rows`` = (batch start, global batch, position
    start, global length) places a batch or sequence shard in the global
    tensor for the dropout masks.

    With ``decode_graph`` (a ``DecodeGraph``; a paged cache on a CUDA
    device, no mesh) the same forward is replayed as a CUDA graph: the
    host builds its index tensors as below, the graph's static buffers
    take them and ``inputs_embeds``, and the returned logits (or hidden
    states) are the graph's output tensor, overwritten by its next replay.
    """
    par = ParallelContext.current(cfg, attn_impl)
    if par is not None:
        par.check_sharded(params["layers"]["wq"])
    attn_impl = attn_impl or _attention
    if cfg.sliding_window is not None:
        attn_impl = _windowed(attn_impl, cfg.sliding_window)
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(params, input_ids, cfg)
    B, S, _ = inputs_embeds.shape
    paged = isinstance(kv_cache, PagedKVCache)
    if decode_graph is not None and not (
            paged and inputs_embeds.is_cuda and par is None):
        raise ValueError("a decode graph replays a paged-cache forward on a "
                         "CUDA device with no mesh")

    # the index tensors the forward builds on the host; they reach the card
    # through pinned, non-blocking copies (core/device.py::to_device), or a
    # decode graph's one staging copy: the forward makes the host wait for
    # nothing, so work can be dispatched ahead of its readback
    if positions is None:
        base = (kv_cache.pos_base + kv_cache.offset if kv_cache is not None
                else torch.zeros((B,), dtype=torch.int32))
        positions = base[:, None] + torch.arange(S, dtype=torch.int32)[None]
    positions = positions.to(torch.int32)
    idx = {"positions": positions}
    if kv_cache is not None:
        pos_base = kv_cache.pos_base.to(positions.device)
        idx["attn_pos"] = (positions - pos_base[:, None]).to(
            torch.int32).contiguous()
        nv = (torch.full((B,), S, dtype=torch.int32) if num_valid is None
              else torch.as_tensor(num_valid, dtype=torch.int32).cpu())
        if paged:
            idx["phys"], idx["row"] = paged_slots(
                kv_cache.table, kv_cache.offset, kv_cache.page_size, S, nv)
            idx["table"] = kv_cache.table
        else:
            C = kv_cache.capacity
            starts = [min(max(int(o), 0), C - S) for o in kv_cache.offset]
    if logit_gather_positions is not None:
        # (B,) or (B, G) positions within the chunk
        idx["gather"] = torch.as_tensor(logit_gather_positions)
    layer_lora = (lora or {}).get("layers") or None

    def run(h, idx):
        """The forward's device work, from the index tensors on h's
        device."""
        cos, sin = rope_cos_sin(idx["positions"], cfg.head_dim,
                                cfg.rope_theta)
        if kv_cache is not None:
            where = ((idx["table"], idx["phys"], idx["row"]) if paged
                     else starts)
            for i in range(cfg.num_layers):
                h = _layer(h, _index_tree(params["layers"], i),
                           _index_tree(layer_lora, i), cos, sin,
                           idx["attn_pos"], (kv_cache, where, i), cfg,
                           lora_scaling, attn_impl, par=par)
        else:
            use_dropout = (dropout_seed is not None and lora_dropout > 0.0
                           and layer_lora is not None)

            def layer(h, i):
                # layer i's masks are seeded by i alone, so a recompute
                # under either remat draws them again the same
                args = (h, _index_tree(params["layers"], i),
                        _index_tree(layer_lora, i), cos, sin,
                        idx["positions"], None, cfg, lora_scaling, attn_impl,
                        fold_seed(dropout_seed, i) if use_dropout else None,
                        lora_dropout if use_dropout else 0.0, par, shard_rows)
                if remat:
                    return checkpoint(_layer, *args, use_reentrant=False)
                return _layer(*args)

            G = remat_group
            if remat and G > 1 and cfg.num_layers % G == 0:
                def group(h, g0):
                    for i in range(g0, g0 + G):
                        h = layer(h, i)
                    return h

                for g0 in range(0, cfg.num_layers, G):
                    h = checkpoint(group, h, g0, use_reentrant=False)
            else:
                for i in range(cfg.num_layers):
                    h = layer(h, i)

        if "gather" in idx:
            pos = idx["gather"].long()
            if pos.ndim == 2:
                h = torch.take_along_dim(h, pos[..., None], dim=1)
            else:
                h = h[torch.arange(B, device=h.device), pos][:, None]
        elif last_logit_only:
            h = h[:, -1:]
        h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
        if return_hidden:
            return h
        head_seed = (fold_seed(dropout_seed, cfg.num_layers)
                     if dropout_seed is not None and lora_dropout > 0.0
                     else None)
        return lm_head(params, h, cfg, lora=lora, lora_scaling=lora_scaling,
                       drop_seed=head_seed, drop_rate=lora_dropout,
                       drop_region=(_drop_region(h, shard_rows)
                                    if head_seed is not None else None),
                       par=par)

    if decode_graph is None:
        dev = inputs_embeds.device
        out = run(inputs_embeds,
                  {k: to_device(t, dev) for k, t in idx.items()})
    else:
        out = decode_graph.run(
            run, inputs_embeds, idx,
            (cfg, lora_scaling, return_hidden, last_logit_only,
             _tensor_key((params, lora, kv_cache.k, kv_cache.v,
                          kv_cache.k_scale, kv_cache.v_scale))))
    new_cache = (None if kv_cache is None
                 else kv_cache.replace(offset=kv_cache.offset + nv))
    return out, new_cache


def _tensor_key(tree) -> tuple:
    """(address, shape, dtype) of every tensor in a tree of dicts, lists
    and tuples, in order: what a recorded graph reads them by."""
    if isinstance(tree, torch.Tensor):
        return ((tree.data_ptr(), tuple(tree.shape), tree.dtype),)
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return tuple(k for t in tree for k in _tensor_key(t))
    return ()


class DecodeGraph:
    """One forward shape recorded as a CUDA graph and replayed: the holder
    a caller passes to ``forward`` as ``decode_graph``, for the batched
    engine's 1-token decode forward (serve/multistream.py).

    ``forward`` builds its host index tensors (positions, the paged
    append's pool rows, the page table, the gather positions) as the eager
    forward does, host checks included, and hands them to ``run`` with its
    device work. The first call, or a call whose key differs from the
    recorded one, warms that work up eagerly on a side stream and captures
    it (``captures``); any other call replays the graph (``replays``). The
    key holds the shapes and dtypes of the inputs and index tensors, and
    the address, shape and dtype of every parameter and pool the forward
    reads, so a parameter swap or a new pool captures again. Each call
    packs the index tensors into one pinned host buffer, copies it to the
    device once and copies ``inputs_embeds`` into the graph's static input
    before the replay; the page table is such an input, never a recorded
    constant. ``post`` (output -> tensor), when given, is recorded after
    the forward and its result is ``post_out``. Outputs are the graph's
    static tensors, overwritten by the next replay. The kernel wrappers'
    ``.launches`` counters count a capture twice (its warm-up and the
    capture itself) and a replay not at all: a replay launches no kernel
    through them."""

    def __init__(self, post=None):
        self.post = post
        self.captures = 0
        self.replays = 0
        self.drop()

    def drop(self):
        """Forget the recorded graph and its buffers; the next ``run``
        captures again."""
        self._key = self._graph = self._out = self.post_out = None
        self._h = self._host = self._dev = self._host_idx = None
        self._copied = None

    def run(self, body, h: torch.Tensor, idx: Dict[str, torch.Tensor],
            key) -> torch.Tensor:
        """``body(h, idx)`` with idx's host tensors on h's device, replayed
        (or captured, then replayed). Returns its output tensor."""
        if any(t.device.type != "cpu" for t in idx.values()):
            raise ValueError("a decode graph stages host index tensors")
        key = (key, tuple(h.shape), h.dtype,
               tuple((k, tuple(t.shape), t.dtype) for k, t in idx.items()))
        if key != self._key:
            self._capture(body, h, idx)
            self._key = key
            self.captures += 1
        else:
            self._stage(h, idx)
            self.replays += 1
        self._graph.replay()
        return self._out

    def _stage(self, h, idx):
        # the previous call's copy must have left the pinned buffer
        self._copied.synchronize()
        for k, t in idx.items():
            self._host_idx[k].copy_(t)
        self._dev.copy_(self._host, non_blocking=True)
        self._copied.record()
        self._h.copy_(h)

    def _capture(self, body, h, idx):
        """Static buffers for these shapes, the staged inputs, an eager
        warm-up of ``body`` on a side stream, then its capture."""
        self.drop()
        dev = h.device
        spans, size = {}, 0
        for k, t in idx.items():
            nbytes = t.numel() * t.element_size()
            spans[k] = (size, nbytes, t.dtype, tuple(t.shape))
            size += -(-nbytes // 16) * 16

        def views(buf):
            return {k: buf[o:o + n].view(dtype).view(shape)
                    for k, (o, n, dtype, shape) in spans.items()}

        self._host = torch.empty(size, dtype=torch.uint8, pin_memory=True)
        self._dev = torch.empty(size, dtype=torch.uint8, device=dev)
        self._host_idx, dev_idx = views(self._host), views(self._dev)
        self._h = torch.empty_like(h)
        self._copied = torch.cuda.Event()
        self._stage(h, idx)

        def record():
            with torch.no_grad():
                out = body(self._h, dev_idx)
                return out, (None if self.post is None else self.post(out))

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            record()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's work on the card (a server's
        # handlers) does not break this thread's capture
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._out, self.post_out = record()
        self._graph = graph


def embed_tokens(params: Params, input_ids: torch.Tensor, cfg: LlamaConfig
                 ) -> torch.Tensor:
    """Token embedding; ids are clamped into the vocab so the out-of-vocab
    ``<v>`` placeholder id is safe. int8 rows are multiplied by their
    per-row scale in the model dtype. Under a mesh the table is the
    rank's shard: its vocabulary shards over ``data`` are gathered (the
    ranks of that axis hold other tokens), its hidden columns over
    ``model`` looked up locally and the rows all-gathered."""
    embed = params["embed"]
    par = ParallelContext.current(cfg)
    if par is not None:
        embed = par.weight(embed, "embed")
    table = embed["q8"] if isinstance(embed, dict) else embed
    ids = to_device(torch.as_tensor(input_ids), table.device).long().clamp(
        0, cfg.vocab_size - 1)
    if isinstance(embed, dict):
        dtype = torch_dtype(cfg.dtype)
        out = embed["q8"][ids].to(dtype) * \
            embed["scale"][ids][..., None].to(dtype)
    else:
        out = embed[ids]
    if par is not None and logical_shape(embed)[1] < cfg.hidden_size:
        out = coll.all_gather(out, par.mesh, MODEL_AXIS, -1)
    return out


def lm_head(params: Params, h: torch.Tensor, cfg: LlamaConfig, *,
            lora: Optional[Params] = None, lora_scaling: float = 1.0,
            drop_seed: Optional[int] = None, drop_rate: float = 0.0,
            drop_region=None, par: Optional[ParallelContext] = None,
            tile_cols: Optional[int] = None) -> torch.Tensor:
    """h @ the head (or the tied embedding's transpose), plus its LoRA.
    ``par`` (default: the current mesh's tensor-parallel context): the
    head's data shards are gathered, and under tensor parallel each rank
    computes its vocabulary columns and the logits are all-gathered (a
    tied head: its hidden columns, summed over the model axis).
    ``tile_cols`` (``quant.head_tile_cols(V)``): an int8 head is applied
    one column tile at a time, so its cast copy is one tile's, not the
    whole head's (the chunked CE loss, the evaluator's chunked stats); the
    same values, and no effect on other heads."""
    if par is None:
        par = ParallelContext.current(cfg)
    head_lora = (lora or {}).get("lm_head")
    if cfg.tie_word_embeddings:
        if isinstance(params["embed"], dict):
            raise ValueError("tied embeddings are not supported with "
                             "quantized (int8 / int4) weights")
        w = params["embed"]
        if par is None:
            return dense(h, w.T, head_lora, lora_scaling, drop_seed,
                         drop_rate, drop_region)
        w = par.weight(w, "embed")
        if par.ranges is None:
            return dense(h, w.T, head_lora, lora_scaling, drop_seed,
                         drop_rate, drop_region)
        s, c = par.ranges["d"]
        if head_lora is not None:
            head_lora = {"lora_a": head_lora["lora_a"].narrow(-1, s, c),
                         "lora_b": head_lora["lora_b"]}
        if drop_region is not None:
            (Bg, Tg, _), (b0, s0, _) = drop_region
            drop_region = (Bg, Tg, cfg.hidden_size), (b0, s0, s)
        return par.reduce(dense(h.narrow(-1, s, c), w.T, head_lora,
                                lora_scaling, drop_seed, drop_rate,
                                drop_region))
    w = params["lm_head"]
    if par is None:
        return dense(h, w, head_lora, lora_scaling, drop_seed, drop_rate,
                     drop_region, tile_cols)
    w = par.weight(w, "lm_head")
    y = dense(h, w, par.lora(head_lora, "lm_head"), lora_scaling,
              drop_seed, drop_rate, drop_region, tile_cols)
    if par.ranges is None:
        return y
    return coll.all_gather(y, par.mesh, MODEL_AXIS, -1)
