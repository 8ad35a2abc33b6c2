"""The DeepSeek-V2 family: latent attention (MLA) over a paged latent cache
and DeepSeekMoE expert layers after the leading dense ones. The port runs
it as ``models/deepseek_v2.py``; its plain reference is
``reference/deepseek_v2.py``.

Everything the benchmark knows of this decoder's shapes is here: the
port's config, the weight tree, the operations a serving forward needs and
the calls of its two kernel classes: ``MLA``, the paged latent attention
kernel and the merge of its split partials (``mla_paged_kernel``,
``mla_merge_kernel``), and ``MoE``, the grouped products over the experts
(PyTorch's CUTLASS grouped GEMM behind ``torch._grouped_mm``, whose kernel
name carries its ``GroupProblemShape``). What a family module provides is
listed in ``registry.py``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import numpy as np
import torch

from portbench import roofline
from portbench.reference import deepseek_v2 as reference
from portbench.weights import LOGIT_STD

ARCHITECTURES = ("DeepseekV2ForCausalLM",)
# tried before trace.CLASSES, whose "matmul" would take a cutlass kernel
KERNEL_CLASSES = (
    ("MLA", lambda n: "mla_paged_kernel" in n or "mla_merge_kernel" in n),
    ("MoE", lambda n: "groupproblemshape" in n or "grouped_gemm" in n),
)


def port_forward():
    """(module, attribute) of the port function a serving forward calls,
    which ``FlopMeter`` wraps."""
    from videollm_online_tpu_torch.models import deepseek_v2
    return deepseek_v2, "forward"


def decoder_config(c: Dict[str, Any]):
    """The configuration file's JSON as the port's ``DeepseekV2Config``."""
    from videollm_online_tpu_torch.core.config import DeepseekV2Config
    rs = c["rope_scaling"]
    return DeepseekV2Config(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        moe_intermediate_size=c["moe_intermediate_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"], kv_lora_rank=c["kv_lora_rank"],
        qk_nope_head_dim=c["qk_nope_head_dim"],
        qk_rope_head_dim=c["qk_rope_head_dim"], v_head_dim=c["v_head_dim"],
        n_routed_experts=c["n_routed_experts"],
        n_shared_experts=c["n_shared_experts"],
        num_experts_per_tok=c["num_experts_per_tok"],
        first_k_dense_replace=c["first_k_dense_replace"],
        norm_topk_prob=bool(c["norm_topk_prob"]),
        routed_scaling_factor=float(c["routed_scaling_factor"]),
        rope_theta=float(c["rope_theta"]), rope_factor=float(rs["factor"]),
        rope_original_max_position=rs["original_max_position_embeddings"],
        rope_beta_fast=float(rs["beta_fast"]),
        rope_beta_slow=float(rs["beta_slow"]),
        rope_mscale=float(rs["mscale"]),
        rope_mscale_all_dim=float(rs["mscale_all_dim"]),
        rms_norm_eps=c["rms_norm_eps"], dtype=c["activations"])


def live_config(c: Dict[str, Any], *, max_response_tokens: int,
                gate_logit_bias: float):
    """The configuration file's JSON as the port's ``LiveConfig`` (its
    decoder config under ``llama``, whatever the family)."""
    from videollm_online_tpu_torch.core.config import LiveConfig
    live = c["live"]
    return LiveConfig(
        llama=decoder_config(c), lora=None,
        vision_hidden_size=live["vision_hidden_size"],
        frame_num_tokens=live["frame_num_tokens"],
        frame_token_interval=live["frame_token_interval"],
        frame_fps=float(live["frame_fps"]),
        max_num_frames=live["max_num_frames"],
        frame_token_interval_threshold=live["frame_token_interval_threshold"],
        max_response_tokens=max_response_tokens,
        gate_logit_bias=float(gate_logit_bias),
        system_prompt=live["system_prompt"])


def _widths(c: Dict[str, Any]):
    H = c["num_attention_heads"]
    dn, dr, dv, R = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                     c["v_head_dim"], c["kv_lora_rank"])
    return H, dn, dr, dv, R


def make_decoder(c: Dict[str, Any], g: torch.Generator, device
                 ) -> Dict[str, Any]:
    """The decoder's tree, as the port's ``models/deepseek_v2.py`` takes
    it, in bf16, drawn from ``g`` one layer at a time (no fp32 copy of a
    whole stack). Every projection keeps unit output variance (normals of
    std 1 / sqrt(fan_in)) but q, the rope key and the nope keys, whose std
    is ``init.qk_gain`` times that; the gate's logits have unit std, the
    head's ``LOGIT_STD``; norm weights are 1 + 0.1 N(0, 1)."""
    L, D, V = c["num_hidden_layers"], c["hidden_size"], c["vocab_size"]
    H, dn, dr, dv, R = _widths(c)
    E, Fe = c["n_routed_experts"], c["moe_intermediate_size"]
    Fd, Fs = c["intermediate_size"], c["moe_intermediate_size"] * c[
        "n_shared_experts"]
    Ld = c["first_k_dense_replace"]
    dt = getattr(torch, c["activations"])
    gain = c["init"]["qk_gain"]

    def normal(shape, std):
        return (torch.randn(shape, generator=g, device=device) * std).to(dt)

    def stack(n, shape, std):
        t = torch.empty((n,) + tuple(shape), dtype=dt, device=device)
        for i in range(n):
            t[i] = normal(shape, std)
        return t

    def near_one(shape):
        return (1.0 + 0.1 * torch.randn(shape, generator=g, device=device)
                ).to(dt)

    wkv_b = stack(L, (R, H, dn + dv), 1 / math.sqrt(R))
    wkv_b[..., :dn] *= gain
    layers = {
        "attn_norm": near_one((L, D)), "mlp_norm": near_one((L, D)),
        "wq": stack(L, (D, H * (dn + dr)), gain / math.sqrt(D)),
        "wkv_a": stack(L, (D, R + dr), gain / math.sqrt(D)),
        "kv_norm": near_one((L, R)),
        "wkv_b": wkv_b.reshape(L, R, H * (dn + dv)),
        "wo": stack(L, (H * dv, D), 1 / math.sqrt(H * dv)),
    }
    Lm = L - Ld
    return {
        "embed": normal((V, D), 1.0),
        "layers": layers,
        "dense": {"w_gate": stack(Ld, (D, Fd), 1 / math.sqrt(D)),
                  "w_up": stack(Ld, (D, Fd), 1 / math.sqrt(D)),
                  "w_down": stack(Ld, (Fd, D), 1 / math.sqrt(Fd))},
        "moe": {"gate": stack(Lm, (D, E), 1 / math.sqrt(D)),
                "w_gate_up": stack(Lm, (E, D, 2 * Fe), 1 / math.sqrt(D)),
                "w_down": stack(Lm, (E, Fe, D), 1 / math.sqrt(Fe)),
                "s_gate": stack(Lm, (D, Fs), 1 / math.sqrt(D)),
                "s_up": stack(Lm, (D, Fs), 1 / math.sqrt(D)),
                "s_down": stack(Lm, (Fs, D), 1 / math.sqrt(Fs))},
        "final_norm": near_one((D,)),
        "lm_head": normal((D, V), LOGIT_STD / math.sqrt(D)),
    }


def active_params(c: Dict[str, Any]) -> Dict[str, int]:
    """Weights a token multiplies: the attention projections of a layer
    (in the published form, W_kv_b included), a dense layer's MLP, an
    expert layer's gate, its top-k experts and its shared experts, and the
    head."""
    D = c["hidden_size"]
    H, dn, dr, dv, R = _widths(c)
    Fe, k = c["moe_intermediate_size"], c["num_experts_per_tok"]
    return {"attn": D * H * (dn + dr) + D * (R + dr) + R * H * (dn + dv)
            + H * dv * D,
            "dense": 3 * D * c["intermediate_size"],
            "moe": D * c["n_routed_experts"] + 3 * D * Fe * k
            + 3 * D * Fe * c["n_shared_experts"],
            "head": D * c["vocab_size"]}


def forward_flops(c: Dict, num_valid: Sequence[int],
                  offsets: Sequence[int], head_rows: int) -> float:
    """Operations a serving forward must do, in the published form: 2 per
    active weight per valid token in every layer (attention projections,
    the dense MLP or the gate, top-k and shared experts), attention 2 H
    (q_head_dim + v_head_dim) a visible pair, and the head on the rows
    whose logits are taken. Padding rows, the embedding gather, norms,
    rope, routing and the connector are left out."""
    L, Ld = c["num_hidden_layers"], c["first_k_dense_replace"]
    H, dn, dr, dv, _ = _widths(c)
    p = active_params(c)
    nv = np.asarray(num_valid, np.int64)
    off = np.asarray(offsets, np.int64)
    pairs = sum(int(roofline.visible(o + np.arange(n), None).sum())
                for o, n in zip(off, nv) if n)
    per_token = L * p["attn"] + Ld * p["dense"] + (L - Ld) * p["moe"]
    return (2.0 * per_token * int(nv.sum()) + 2.0 * H * (dn + dr + dv) * L
            * pairs + 2.0 * p["head"] * head_rows)


def mla_call(offsets: Sequence[int], S: int, H: int, dk: int, dv: int
             ) -> tuple:
    """(operations, bytes) of one latent attention call (one layer) for the
    streams with valid tokens, whose S queries sit at slots offsets[b] ..
    offsets[b] + S - 1: 2 H (dk + dv) a visible (query, slot) pair; each
    stream's visible latent rows (dk bf16 values) read once, q (dk) and the
    output (dv) of its S H rows once. All S queries of a valid stream are
    counted (the meter does not say how many are padding)."""
    off = np.asarray(offsets, np.int64)
    pairs = int(roofline.visible(off[:, None] + np.arange(S)[None],
                                 None).sum())
    slots = int((off + S).sum())
    flops = 2.0 * H * (dk + dv) * pairs
    nbytes = 2.0 * slots * dk + 2.0 * len(off) * S * H * (dk + dv)
    return flops, nbytes


def moe_call(n: int, c: Dict[str, Any]) -> tuple:
    """(operations, bytes) of one expert layer's grouped products for n
    valid tokens: 2 . 3 D Fe a token and expert, top-k experts; each
    expert's three matrices (bf16) read once, for the expected number of
    distinct experts n tokens pick under uniform routing, E (1 - ((E -
    k) / E)^n)."""
    D, Fe = c["hidden_size"], c["moe_intermediate_size"]
    E, k = c["n_routed_experts"], c["num_experts_per_tok"]
    flops = 2.0 * 3 * D * Fe * k * n
    experts = E * (1.0 - ((E - k) / E) ** n)
    return flops, 3.0 * D * Fe * 2 * experts


def kernel_calls(c: Dict, offsets: Sequence[int], S: int
                 ) -> Dict[str, tuple]:
    """{"MLA": ..., "MoE": ...}: (operations, bytes, layers) of one
    forward's latent attention call and expert-layer products for the
    streams with valid tokens (``mla_call``; ``moe_call`` with every row
    of those streams taken as a valid token), and the layers that call
    each."""
    H, dn, dr, dv, R = _widths(c)
    L, Ld = c["num_hidden_layers"], c["first_k_dense_replace"]
    f, b = mla_call(offsets, S, H, R + dr, R)
    fm, bm = moe_call(len(offsets) * S, c)
    return {"MLA": (f, b, L), "MoE": (fm, bm, L - Ld)}
