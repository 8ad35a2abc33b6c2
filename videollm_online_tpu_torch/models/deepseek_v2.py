"""DeepSeek-V2 decoder over a paged latent cache, in PyTorch.

The second decoder family of the port, beside ``models/llama.py``, with its
keyword interface (``forward``, ``embed_tokens``, ``init_paged_kv_cache``,
``DecodeGraph``), so the batched engine (serve/multistream.py) serves it
through the same calls. The published layer (DeepseekV2DecoderLayer):

  * latent attention (MLA) without a q LoRA: q = x W_q, split per head into
    a nope part (``qk_nope_head_dim``) and a rope part
    (``qk_rope_head_dim``); x W_kv_a gives the latent c (``kv_lora_rank``,
    then RMSNorm'd) and one rope key k_pe shared by the heads; W_kv_b maps
    c to each head's k_nope and v; yarn rope on q_pe and k_pe after HF's
    even/odd de-interleave; logits scaled by ``cfg.softmax_scale``;
  * the first ``first_k_dense_replace`` layers a SwiGLU MLP, the others
    DeepSeekMoE: an fp32 softmax gate, greedy top-k (weights not
    renormalised unless ``norm_topk_prob``, times
    ``routed_scaling_factor``), SwiGLU experts, and the shared experts (one
    SwiGLU of ``n_shared_experts`` x the expert width) added.

Attention runs in its absorbed form: the cache holds one row of
``kv_lora_rank + qk_rope_head_dim`` values a token a layer (c, then the
roped k_pe), W_UK is folded into the query (q_nope W_UK^T, a latent
query) and W_UV is applied to the latent output, so every head attends the
one shared row through ``ops.mla_attention`` (the kernel on a card, the
plain version on the CPU). The expert products are one grouped product
over the experts for gate/up and one for down (``torch._grouped_mm`` on a
card), tokens sorted by expert with the group offsets computed on the
device; padding tokens are routed nowhere. Nothing of the forward's device
work reads the device from the host, so the greedy decode forward replays
as one CUDA graph (``DecodeGraph``, llama's).

Parameters (``layers`` leaves stacked on a leading layer axis, matrices
(in, out) as in llama's tree): ``embed`` (V, D), ``layers`` {attn_norm,
mlp_norm (L, D), wq (L, D, H q_head_dim), wkv_a (L, D, latent_dim),
kv_norm (L, kv_lora_rank), wkv_b (L, kv_lora_rank, H (nope + v)), wo (L, H
v, D)}, ``dense`` {w_gate, w_up (Ld, D, F), w_down (Ld, F, D)} for the
leading dense layers, ``moe`` {gate (Lm, D, E), w_gate_up (Lm, E, D, 2
Fe), w_down (Lm, E, Fe, D), s_gate, s_up (Lm, D, Fs), s_down (Lm, Fs, D)}
for the rest, ``final_norm`` (D,), ``lm_head`` (D, V). No LoRA: training
is out of scope.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.config import DeepseekV2Config, yarn_mscale
from ..core.device import resolve_device, to_device, torch_dtype
from ..ops.mla_attention import mla_paged_attention
# the engine calls DecodeGraph and embed_tokens through this module
from .llama import (DecodeGraph, _index_tree, _tensor_key, dense,  # noqa: F401
                    embed_tokens, paged_slots, rms_norm)

Params = Dict[str, Any]

# what this decoder serves in the batched engine (as models/llama.py
# declares its own): the paged latent pool only, no ring, and no tensor or
# sequence parallelism
CONFIG = DeepseekV2Config
RING = False
MESH = False


@dataclass
class PagedLatentCache:
    """The paged latent pool: ``latent`` (L, P, page, latent_dim) on the
    device, one row a token a layer (c, then the roped k_pe); ``table``
    (B, MAXP), ``offset`` and ``pos_base`` (B,) int32 on the CPU with
    ``models.llama.PagedKVCache``'s meaning (pool page 0 is the trash
    page). ``moe_counts`` (3,) int64 on the device, added to by every
    forward that runs an expert layer: expert-layer calls, the valid
    (token, expert) pairs routed, and the busiest expert's pairs summed
    over calls (a decode graph's capture counts its eager warm-up too)."""
    latent: torch.Tensor
    table: torch.Tensor
    offset: torch.Tensor
    pos_base: torch.Tensor
    moe_counts: Optional[torch.Tensor] = None

    @property
    def page_size(self) -> int:
        return self.latent.shape[2]

    @property
    def capacity(self) -> int:  # per-stream logical capacity
        return self.table.shape[1] * self.latent.shape[2]

    @property
    def quantized(self) -> bool:
        return False

    def pools(self):
        """Every tensor paged by ``table``."""
        return [self.latent]

    def replace(self, **kw) -> "PagedLatentCache":
        return dataclasses.replace(self, **kw)


def init_paged_kv_cache(cfg: DeepseekV2Config, batch: int, *, pool_pages: int,
                        pages_per_stream: int, page_size: int = 512,
                        dtype=None, quant: Optional[str] = None,
                        device=None) -> PagedLatentCache:
    if quant is not None:
        raise ValueError(f"the latent cache is kept in the model dtype; kv "
                         f"quant {quant!r} is not supported")
    device = resolve_device(device)
    return PagedLatentCache(
        latent=torch.zeros((cfg.num_layers, pool_pages, page_size,
                            cfg.latent_dim),
                           dtype=dtype or torch_dtype(cfg.dtype), device=device),
        table=torch.zeros((batch, pages_per_stream), dtype=torch.int32),
        offset=torch.zeros((batch,), dtype=torch.int32),
        pos_base=torch.zeros((batch,), dtype=torch.int32),
        moe_counts=torch.zeros((3,), dtype=torch.int64, device=device))


def init_params(generator: torch.Generator, cfg: DeepseekV2Config,
                device=None, std: float = 0.02) -> Params:
    """Random weights, N(0, std) matrices and unit norms, drawn from
    ``generator`` (which must live on ``device``)."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    L, D, H = cfg.num_layers, cfg.hidden_size, cfg.num_heads
    Ld = min(cfg.first_k_dense_replace, L)
    Lm, E = L - Ld, cfg.n_routed_experts
    Fe, Fd = cfg.moe_intermediate_size, cfg.intermediate_size
    Fs = Fe * cfg.n_shared_experts

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=device)
                * std).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "embed": normal(cfg.vocab_size, D),
        "layers": {
            "attn_norm": ones(L, D), "mlp_norm": ones(L, D),
            "wq": normal(L, D, H * cfg.q_head_dim),
            "wkv_a": normal(L, D, cfg.latent_dim),
            "kv_norm": ones(L, cfg.kv_lora_rank),
            "wkv_b": normal(L, cfg.kv_lora_rank,
                            H * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
            "wo": normal(L, H * cfg.v_head_dim, D)},
        "dense": {"w_gate": normal(Ld, D, Fd), "w_up": normal(Ld, D, Fd),
                  "w_down": normal(Ld, Fd, D)},
        "moe": {"gate": normal(Lm, D, E),
                "w_gate_up": normal(Lm, E, D, 2 * Fe),
                "w_down": normal(Lm, E, Fe, D),
                "s_gate": normal(Lm, D, Fs), "s_up": normal(Lm, D, Fs),
                "s_down": normal(Lm, Fs, D)},
        "final_norm": ones(D),
        "lm_head": normal(D, cfg.vocab_size),
    }


# ------------------------------------------------------------------ rope
def yarn_inv_freq(cfg: DeepseekV2Config, device) -> torch.Tensor:
    """DeepseekV2YarnRotaryEmbedding's inverse frequencies (d_rope / 2,)
    fp32: the extrapolated and the interpolated ones blended by yarn's
    linear ramp between the correction dims of beta_fast and beta_slow.
    Built from device arithmetic alone (no host copy), so a captured
    graph may compute it."""
    d, base = cfg.qk_rope_head_dim, cfg.rope_theta
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    extra = 1.0 / (base ** exps)
    inter = 1.0 / (cfg.rope_factor * base ** exps)

    def corr_dim(rot):
        return (d * math.log(cfg.rope_original_max_position
                             / (rot * 2 * math.pi))) / (2 * math.log(base))

    lo = max(math.floor(corr_dim(cfg.rope_beta_fast)), 0)
    hi = min(math.ceil(corr_dim(cfg.rope_beta_slow)), d - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float32, device=device) - lo)
            / (hi - lo)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def rope_cos_sin(positions: torch.Tensor, cfg: DeepseekV2Config
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (B, S) -> cos, sin (B, S, d_rope) fp32, times yarn's
    mscale(factor, mscale) / mscale(factor, mscale_all_dim) (1 for
    DeepSeek-V2's equal pair)."""
    inv = yarn_inv_freq(cfg, positions.device)
    ang = positions.float()[..., None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    m = (yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
         / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))
    return torch.cos(ang) * m, torch.sin(ang) * m


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B, S, H, d) after HF DeepSeek's de-interleave (even dims, then
    odd), rotated by cos/sin (B, S, d) cast to x's dtype."""
    B, S, H, d = x.shape
    x = x.reshape(B, S, H, d // 2, 2).transpose(-1, -2).reshape(B, S, H, d)
    c, s = cos[:, :, None].to(x.dtype), sin[:, :, None].to(x.dtype)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * c + rot * s


# ------------------------------------------------------------------ MoE
def _swiglu(x, w_gate, w_up, w_down):
    return dense(F.silu(dense(x, w_gate)) * dense(x, w_up), w_down)


def _expert_products(xs: torch.Tensor, counts: torch.Tensor,
                     w_gate_up: torch.Tensor, w_down: torch.Tensor
                     ) -> torch.Tensor:
    """SwiGLU of each expert on its rows of ``xs`` (rows sorted by expert,
    ``counts`` (E,) rows each, then rows of no expert): on a card one
    grouped product over the experts for gate/up and one for down, the
    group offsets a device cumsum; on the CPU a loop over the experts. Rows
    of no expert come out as anything, for the caller to drop."""
    Fe = w_down.shape[1]
    if xs.is_cuda:
        offs = torch.cumsum(counts, 0).to(torch.int32)
        h = torch._grouped_mm(xs, w_gate_up, offs=offs)
        a = F.silu(h[:, :Fe]) * h[:, Fe:]
        return torch._grouped_mm(a, w_down, offs=offs)
    out = torch.zeros_like(xs)
    s = 0
    for e, n in enumerate(counts.tolist()):
        if n:
            h = xs[s:s + n] @ w_gate_up[e]
            out[s:s + n] = (F.silu(h[:, :Fe]) * h[:, Fe:]) @ w_down[e]
            s += n
    return out


def route(x: torch.Tensor, gate: torch.Tensor, cfg: DeepseekV2Config
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (T, D) -> (weights (T, k) fp32, experts (T, k)): MoEGate's fp32
    softmax scores and greedy top-k, renormalised with ``norm_topk_prob``
    (k > 1), else times ``routed_scaling_factor``."""
    scores = torch.softmax(x.float() @ gate.float(), dim=-1)
    w, e = torch.topk(scores, cfg.num_experts_per_tok, dim=-1, sorted=False)
    if cfg.num_experts_per_tok > 1 and cfg.norm_topk_prob:
        return w / (w.sum(-1, keepdim=True) + 1e-20), e
    return w * cfg.routed_scaling_factor, e


def moe(x: torch.Tensor, mp: Dict[str, torch.Tensor], cfg: DeepseekV2Config,
        valid: torch.Tensor, counts: Optional[torch.Tensor]) -> torch.Tensor:
    """The expert layer on x (T, D), ``valid`` (T,) bool marking the real
    tokens (the others are routed nowhere and get the shared experts
    alone): each real token's top-k experts' SwiGLU outputs, weighted and
    summed in fp32, plus the shared experts. ``counts`` (3,) int64 on the
    device, if given, gains [1, pairs routed, the busiest expert's
    pairs]."""
    T, D = x.shape
    E, k = cfg.n_routed_experts, cfg.num_experts_per_tok
    w, e = route(x, mp["gate"], cfg)
    key = torch.where(valid[:, None], e, E).reshape(-1)          # (T k,)
    order = torch.argsort(key, stable=True)
    per = torch.zeros((E + 1,), dtype=torch.int64, device=x.device)
    per.scatter_add_(0, key, torch.ones_like(key))
    ys = _expert_products(x[order // k], per[:E], mp["w_gate_up"],
                          mp["w_down"])
    # back to (token, slot) order by a row gather (a scatter of the rows,
    # y[order] = ys, is ~4x slower on the card)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    y = ys[inv]
    y = torch.where((key < E)[:, None], y, torch.zeros((), dtype=y.dtype,
                                                       device=y.device))
    routed = (y.view(T, k, D).float() * w[..., None]).sum(1).to(x.dtype)
    if counts is not None:
        counts += torch.stack([torch.ones_like(per[0]), per[:E].sum(),
                               per[:E].max()])
    return routed + _swiglu(x, mp["s_gate"], mp["s_up"], mp["s_down"])


# ------------------------------------------------------------- attention
def _mla(h, lp, cfg: DeepseekV2Config, cos, sin, cache: PagedLatentCache,
         idx, layer: int):
    """Absorbed latent attention of one layer: the block's latent rows
    appended to the pool, then every head's latent query against it."""
    B, S, _ = h.shape
    H, dn, dr, dv, R = (cfg.num_heads, cfg.qk_nope_head_dim,
                        cfg.qk_rope_head_dim, cfg.v_head_dim,
                        cfg.kv_lora_rank)
    x = rms_norm(h, lp["attn_norm"], cfg.rms_norm_eps)
    q = dense(x, lp["wq"]).view(B, S, H, dn + dr)
    kv = dense(x, lp["wkv_a"])
    c = rms_norm(kv[..., :R], lp["kv_norm"], cfg.rms_norm_eps)
    k_pe = apply_rope(kv[..., None, R:], cos, sin)[:, :, 0]
    cache.latent[layer][idx["phys"], idx["row"]] = torch.cat(
        [c, k_pe], dim=-1).reshape(B * S, R + dr).to(cache.latent.dtype)
    wb = lp["wkv_b"].view(R, H, dn + dv)
    # q_nope W_UK^T per head: (H, T, dn) @ (H, dn, R)
    q_lat = torch.matmul(q[..., :dn].reshape(B * S, H, dn).transpose(0, 1),
                         wb[..., :dn].permute(1, 2, 0))
    q_full = torch.cat([q_lat.transpose(0, 1).reshape(B, S, H, R),
                        apply_rope(q[..., dn:], cos, sin)], dim=-1)
    o = mla_paged_attention(q_full, cache.latent, idx["table"],
                            idx["attn_pos"], layer, idx["nvalid"],
                            scale=cfg.softmax_scale, dv=R,
                            window=cfg.sliding_window)
    # latent output times W_UV per head: (H, T, R) @ (H, R, dv)
    o = torch.matmul(o.reshape(B * S, H, R).transpose(0, 1),
                     wb[..., dn:].transpose(0, 1))
    return dense(o.transpose(0, 1).reshape(B, S, H * dv), lp["wo"])


def forward(
    params: Params,
    *,
    cfg: DeepseekV2Config,
    input_ids: Optional[torch.Tensor] = None,
    inputs_embeds: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    kv_cache: Optional[PagedLatentCache] = None,
    num_valid=None,
    lora: Optional[Params] = None,
    lora_scaling: float = 1.0,
    attn_impl=None,
    return_hidden: bool = False,
    last_logit_only: bool = False,
    logit_gather_positions: Optional[torch.Tensor] = None,
    decode_graph: Optional[DecodeGraph] = None,
) -> Tuple[torch.Tensor, Optional[PagedLatentCache]]:
    """Run the decoder, with ``models.llama.forward``'s keywords and
    meaning: with a cache, the (B, S) chunk is written into the latent pool
    at ``kv_cache.offset`` (``num_valid`` (B,) of the S tokens are real,
    the rest padding: they are attended by nothing, routed to no expert,
    and their outputs are not to be read) and attends over it; returns
    (logits, cache with ``offset + num_valid``). Without a cache: the full
    causal forward over (B, S), through a pool of its own. ``attn_impl``
    is ignored (the latent attention is the one path); a LoRA tree is
    refused. ``decode_graph``: the forward replayed as a CUDA graph (a
    card), as in llama."""
    if lora:
        raise ValueError("DeepSeek-V2 takes no LoRA tree: its training is "
                         "not supported")
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(params, input_ids, cfg)
    B, S, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    cache = kv_cache
    if cache is None:
        # a pool of one page a stream, S slots each, after the trash page
        cache = init_paged_kv_cache(cfg, B, pool_pages=B + 1,
                                    pages_per_stream=1, page_size=S,
                                    dtype=inputs_embeds.dtype, device=dev)
        cache = cache.replace(table=torch.arange(1, B + 1, dtype=torch.int32
                                                 )[:, None])
    if decode_graph is not None and not inputs_embeds.is_cuda:
        raise ValueError("a decode graph replays a forward on a CUDA device")

    # the index tensors the forward builds on the host (llama.forward's)
    if positions is None:
        positions = ((cache.pos_base + cache.offset)[:, None]
                     + torch.arange(S, dtype=torch.int32)[None])
    positions = positions.to(torch.int32)
    nv = (torch.full((B,), S, dtype=torch.int32) if num_valid is None
          else torch.as_tensor(num_valid, dtype=torch.int32).cpu())
    idx = {"positions": positions,
           "attn_pos": (positions - cache.pos_base[:, None]).to(
               torch.int32).contiguous(),
           "nvalid": nv,
           "valid": (torch.arange(S)[None] < nv[:, None].long()).reshape(-1),
           "table": cache.table}
    idx["phys"], idx["row"] = paged_slots(cache.table, cache.offset,
                                          cache.page_size, S, nv)
    if logit_gather_positions is not None:
        idx["gather"] = torch.as_tensor(logit_gather_positions)
    Ld = min(cfg.first_k_dense_replace, cfg.num_layers)

    def run(h, idx):
        cos, sin = rope_cos_sin(idx["positions"], cfg)
        for i in range(cfg.num_layers):
            lp = _index_tree(params["layers"], i)
            h = h + _mla(h, lp, cfg, cos, sin, cache, idx, i)
            x = rms_norm(h, lp["mlp_norm"], cfg.rms_norm_eps)
            if i < Ld:
                dp = _index_tree(params["dense"], i)
                m = _swiglu(x, dp["w_gate"], dp["w_up"], dp["w_down"])
            else:
                m = moe(x.reshape(B * S, -1),
                        _index_tree(params["moe"], i - Ld), cfg,
                        idx["valid"], cache.moe_counts).view(x.shape)
            h = h + m
        if "gather" in idx:
            pos = idx["gather"].long()
            if pos.ndim == 2:
                h = torch.take_along_dim(h, pos[..., None], dim=1)
            else:
                h = h[torch.arange(B, device=h.device), pos][:, None]
        elif last_logit_only:
            h = h[:, -1:]
        h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
        return h if return_hidden else dense(h, params["lm_head"])

    if decode_graph is None:
        out = run(inputs_embeds, {k: to_device(t, dev) for k, t in idx.items()})
    else:
        out = decode_graph.run(
            run, inputs_embeds, idx,
            (cfg, return_hidden, last_logit_only,
             _tensor_key((params, cache.latent, cache.moe_counts))))
    if kv_cache is None:
        return out, None
    return out, kv_cache.replace(offset=kv_cache.offset + nv)
