"""The DeepSeek-V2 decoder of a configuration in plain fp32 PyTorch, TF32
off, in its published (non-absorbed) form.

It takes the benchmark's weight tree (``families/deepseek_v2.py``
``make_decoder``: bf16 tensors) and casts each layer's weights to fp32 when
that layer runs, so the whole model never sits on the card in fp32.
Equations of DeepseekV2DecoderLayer: RMSNorm with its weight; q = x W_q
(no q LoRA), split per head into q_nope and q_pe; x W_kv_a gives the
latent c, RMSNorm'd by kv_a_layernorm, and the shared k_pe; c W_kv_b gives
each head's k_nope and v, expanded per head; yarn rope on q_pe and k_pe
after the even/odd de-interleave (``rope_scaling``: factor, original
positions, beta_fast / beta_slow, mscale / mscale_all_dim); causal
attention with the logits scaled by q_head_dim^-0.5 times
mscale(factor, mscale_all_dim)^2, in blocks of query rows; o_proj; then
the first ``first_k_dense_replace`` layers a SwiGLU MLP and the others
DeepSeekMoE: fp32 softmax scores of the gate, greedy top-k, weights
renormalised only with ``norm_topk_prob`` (else times
``routed_scaling_factor``), each expert's SwiGLU on its tokens, weighted
and summed, plus the shared experts (one SwiGLU of their joint width); the
final norm and the head. Nothing here reaches the port.

``Rounder`` (``common.py``) stands in a lower precision for the control at
the same points as the Llama reference: every matmul's activation operand,
and q, k and v.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import torch
import torch.nn.functional as F

from .common import Rounder


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def embed_ids(params: Dict[str, Any], ids: torch.Tensor) -> torch.Tensor:
    e = params["embed"]
    return e[ids.to(e.device).long()].float()


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def softmax_scale(c: Dict[str, Any]) -> float:
    d = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    rs = c["rope_scaling"]
    m = _mscale(rs["factor"], rs["mscale_all_dim"])
    return d ** -0.5 * m * m


def yarn_cos_sin(c: Dict[str, Any], pos: torch.Tensor):
    """DeepseekV2YarnRotaryEmbedding's cos / sin (T, d_rope) at positions
    ``pos``, fp32."""
    d, base = c["qk_rope_head_dim"], float(c["rope_theta"])
    rs = c["rope_scaling"]
    factor = float(rs["factor"])
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device) / d
    extra = 1.0 / (base ** exps)
    inter = 1.0 / (factor * base ** exps)

    def corr_dim(rot):
        return (d * math.log(rs["original_max_position_embeddings"]
                             / (rot * 2 * math.pi))) / (2 * math.log(base))

    lo = max(math.floor(corr_dim(rs["beta_fast"])), 0)
    hi = min(math.ceil(corr_dim(rs["beta_slow"])), d - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float32, device=pos.device)
             - lo) / (hi - lo)).clamp(0, 1)
    keep = 1.0 - ramp
    inv = inter * (1 - keep) + extra * keep
    ang = pos.float()[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)
    m = _mscale(factor, rs["mscale"]) / _mscale(factor, rs["mscale_all_dim"])
    return torch.cos(ang) * m, torch.sin(ang) * m


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
         ) -> torch.Tensor:
    """x (T, H, d): de-interleaved (even dims, then odd), then rotated."""
    T, H, d = x.shape
    x = x.reshape(T, H, d // 2, 2).transpose(-1, -2).reshape(T, H, d)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos[:, None] + rot * sin[:, None]


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
           block: int = 1024) -> torch.Tensor:
    """Causal attention, q / k (T, H, dq), v (T, H, dv) -> (T, H * dv)."""
    T, H, _ = q.shape
    dv = v.shape[-1]
    out = q.new_empty(T, H, dv)
    for a in range(0, T, block):
        b = min(a + block, T)
        s = torch.einsum("ihd,jhd->hij", q[a:b], k[:b]) * scale
        i = torch.arange(a, b, device=q.device)[:, None]
        j = torch.arange(0, b, device=q.device)[None]
        s = s.masked_fill(~(j <= i), float("-inf"))
        out[a:b] = torch.einsum("hij,jhd->ihd", torch.softmax(s, dim=-1),
                                v[:b])
    return out.reshape(T, H * dv)


def layer_weights(params: Dict[str, Any], c: Dict[str, Any], layer: int
                  ) -> Dict[str, Any]:
    w = {k: _f(v[layer]) for k, v in params["layers"].items()}
    nd = c["first_k_dense_replace"]
    if layer < nd:
        w["mlp"] = {k: _f(v[layer]) for k, v in params["dense"].items()}
    else:
        w["moe"] = {k: _f(v[layer - nd]) for k, v in params["moe"].items()}
    return w


def swiglu(x, wg, wu, wd, rnd):
    return rnd(F.silu(x @ wg) * (x @ wu)) @ wd


def moe(x: torch.Tensor, w: Dict[str, torch.Tensor], c: Dict[str, Any],
        rnd: Rounder) -> torch.Tensor:
    """DeepSeekMoE on x (T, D), already rounded."""
    T, D = x.shape
    k = c["num_experts_per_tok"]
    Fe = c["moe_intermediate_size"]
    scores = torch.softmax(x @ w["gate"], dim=-1)
    tw, ti = torch.topk(scores, k, dim=-1)
    if k > 1 and c.get("norm_topk_prob"):
        tw = tw / (tw.sum(-1, keepdim=True) + 1e-20)
    else:
        tw = tw * c["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in torch.unique(ti).tolist():
        tok, slot = torch.nonzero(ti == e, as_tuple=True)
        wgu = w["w_gate_up"][e]
        y = swiglu(x[tok], wgu[:, :Fe], wgu[:, Fe:], w["w_down"][e], rnd)
        out.index_add_(0, tok, y * tw[tok, slot][:, None])
    return out + swiglu(x, w["s_gate"], w["s_up"], w["s_down"], rnd)


def layer_forward(h: torch.Tensor, w: Dict[str, Any], c: Dict[str, Any],
                  cos, sin, rnd: Rounder, mlp_block: int = 4096
                  ) -> torch.Tensor:
    """One decoder layer on one sequence h (T, D), fp32."""
    T = h.shape[0]
    H = c["num_attention_heads"]
    dn, dr, dv, R = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                     c["v_head_dim"], c["kv_lora_rank"])
    eps = c["rms_norm_eps"]
    x = rnd(rms(h, w["attn_norm"], eps))
    q = (x @ w["wq"]).reshape(T, H, dn + dr)
    kv = x @ w["wkv_a"]
    latent = rms(kv[:, :R], w["kv_norm"], eps)
    kvb = (rnd(latent) @ w["wkv_b"]).reshape(T, H, dn + dv)
    q_pe = rope(q[..., dn:], cos, sin)
    k_pe = rope(kv[:, None, R:], cos, sin).expand(T, H, dr)
    q = rnd(torch.cat([q[..., :dn], q_pe], dim=-1))
    k = rnd(torch.cat([kvb[..., :dn], k_pe], dim=-1))
    v = rnd(kvb[..., dn:])
    h = h + rnd(attend(q, k, v, softmax_scale(c))) @ w["wo"]
    x = rnd(rms(h, w["mlp_norm"], eps))
    out = torch.empty_like(h)
    for s in range(0, T, mlp_block):
        xs = x[s:s + mlp_block]
        if "mlp" in w:
            m = w["mlp"]
            out[s:s + mlp_block] = swiglu(xs, m["w_gate"], m["w_up"],
                                          m["w_down"], rnd)
        else:
            out[s:s + mlp_block] = moe(xs, w["moe"], c, rnd)
    return h + out


def final_hidden(params: Dict[str, Any], c: Dict[str, Any],
                 seqs: Sequence[torch.Tensor], rnd: Rounder = Rounder()
                 ) -> List[torch.Tensor]:
    """Final-normed hidden states (T_i, D) of each input embedding sequence
    (T_i, D), layer by layer over all sequences."""
    hs = [s.float() for s in seqs]
    rot = [yarn_cos_sin(c, torch.arange(h.shape[0], device=h.device))
           for h in hs]
    for layer in range(c["num_hidden_layers"]):
        w = layer_weights(params, c, layer)
        hs = [layer_forward(h, w, c, cs, sn, rnd)
              for h, (cs, sn) in zip(hs, rot)]
        del w
    return [rms(h, params["final_norm"], c["rms_norm_eps"]) for h in hs]


def logits(params: Dict[str, Any], hidden: torch.Tensor,
           rnd: Rounder = Rounder()) -> torch.Tensor:
    return rnd(hidden) @ _f(params["lm_head"])
