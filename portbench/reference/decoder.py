"""The decoder of a configuration in plain fp32 PyTorch, TF32 off.

It takes the benchmark's weight tree (``weights.make``) and works out
itself what the program derives from it: each int8 matrix is dequantized
here (codes times their scales, in fp32), one layer at a time, so the
whole model never sits on the card in fp32. Equations: RMSNorm with its
weight, q/k/v projections (+ bias where the configuration has one),
rotary embedding in the HF layout (the first half's angles repeated),
grouped-query causal attention over keys j with i - window < j <= i, the
o projection, SwiGLU, the final norm and the head. Attention runs in
blocks of query rows, each over the keys its rows can see.

``Rounder`` (``common.py``) stands in a lower precision for the control:
every matmul's activation operand, and q, k and v, rounded to float8 e4m3
with one scale per row (amax / 448).

A family's reference module gives the shared judge (``dialogue.py``)
``embed_ids``, ``final_hidden`` and ``logits``, each over the decoder's
tree (``params["llama"]``); this is the Llama family's.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from .common import Rounder


def attention_window(c: Dict[str, Any]) -> Optional[int]:
    """The sliding window a configuration's attention uses (None: full
    causal); Qwen2's config carries a window it does not use."""
    if not c.get("use_sliding_window", True):
        return None
    return c.get("sliding_window")


def deq(m: Dict[str, torch.Tensor]) -> torch.Tensor:
    """An int8 matrix {"q8": (in, out), "scale": (out,)} in fp32."""
    return m["q8"].float() * m["scale"].float()


def layer_weights(params: Dict[str, Any], layer: int) -> Dict[str, Any]:
    lp = params["layers"]
    out = {}
    for k, v in lp.items():
        out[k] = deq({"q8": v["q8"][layer], "scale": v["scale"][layer]}) \
            if isinstance(v, dict) else v[layer].float()
    return out


def embed_ids(params: Dict[str, Any], ids: torch.Tensor) -> torch.Tensor:
    e = params["embed"]
    ids = ids.to(e["q8"].device).long()
    return e["q8"][ids].float() * e["scale"][ids].float()[:, None]


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, d) at absolute positions ``pos`` (T,)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device,
                                        dtype=torch.float32) / d))
    ang = pos.float()[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=-1)[:, None]
    half = d // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * torch.cos(ang) + rot * torch.sin(ang)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int], block: int = 1024) -> torch.Tensor:
    """Causal GQA attention, q (T, Hq, d), k / v (T, Hkv, d) -> (T, Hq * d)."""
    T, Hq, d = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    out = q.new_empty(T, Hq, d)
    scale = 1.0 / math.sqrt(d)
    for a in range(0, T, block):
        b = min(a + block, T)
        lo = 0 if window is None else max(0, a - window + 1)
        qb = q[a:b].reshape(b - a, Hkv, G, d)
        s = torch.einsum("ihgd,jhd->hgij", qb, k[lo:b]) * scale
        i = torch.arange(a, b, device=q.device)[:, None]
        j = torch.arange(lo, b, device=q.device)[None]
        mask = j <= i
        if window is not None:
            mask = mask & (j > i - window)
        s = s.masked_fill(~mask, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("hgij,jhd->ihgd", p, v[lo:b])
        out[a:b] = o.reshape(b - a, Hq, d)
    return out.reshape(T, Hq * d)


def layer_forward(h: torch.Tensor, w: Dict[str, Any], c: Dict[str, Any],
                  pos: torch.Tensor, rnd: Rounder, mlp_block: int = 4096
                  ) -> torch.Tensor:
    """One decoder layer on one sequence h (T, D), fp32."""
    T = h.shape[0]
    d, Hq, Hkv = (c["head_dim"], c["num_attention_heads"],
                  c["num_key_value_heads"])
    eps = c["rms_norm_eps"]
    x = rnd(rms(h, w["attn_norm"], eps))
    q, k, v = x @ w["wq"], x @ w["wk"], x @ w["wv"]
    if "bq" in w:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q = rnd(rope(q.reshape(T, Hq, d), pos, c["rope_theta"]))
    k = rnd(rope(k.reshape(T, Hkv, d), pos, c["rope_theta"]))
    v = rnd(v.reshape(T, Hkv, d))
    a = attend(q, k, v, attention_window(c))
    h = h + rnd(a) @ w["wo"]
    x = rnd(rms(h, w["mlp_norm"], eps))
    out = torch.empty_like(h)
    for s in range(0, T, mlp_block):
        xs = x[s:s + mlp_block]
        m = rnd(F.silu(xs @ w["w_gate"]) * (xs @ w["w_up"]))
        out[s:s + mlp_block] = m @ w["w_down"]
    return h + out


def final_hidden(params: Dict[str, Any], c: Dict[str, Any],
                 seqs: Sequence[torch.Tensor], rnd: Rounder = Rounder()
                 ) -> List[torch.Tensor]:
    """Final-normed hidden states (T_i, D) of each input embedding sequence
    (T_i, D), layer by layer over all sequences."""
    hs = [s.float() for s in seqs]
    pos = [torch.arange(h.shape[0], device=h.device) for h in hs]
    for layer in range(c["num_hidden_layers"]):
        w = layer_weights(params, layer)
        hs = [layer_forward(h, w, c, p, rnd) for h, p in zip(hs, pos)]
        del w
    return [rms(h, params["final_norm"], c["rms_norm_eps"]) for h in hs]


def logits(params: Dict[str, Any], hidden: torch.Tensor,
           rnd: Rounder = Rounder()) -> torch.Tensor:
    return rnd(hidden) @ deq(params["lm_head"])
