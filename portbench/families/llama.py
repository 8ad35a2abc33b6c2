"""The Llama family: decoders of Llama's layer (RMSNorm, grouped-query
attention with rotary embedding, SwiGLU), with Qwen2's q/k/v biases
(``qkv_bias``) and Mistral's sliding window as keys of the configuration
file. The port runs it as ``models/llama.py``; its plain reference is
``reference/decoder.py``.

Everything the benchmark knows of this decoder's shapes is here: the
port's config, the weight tree, the operations a serving forward needs and
K3's calls. What a family module provides is listed in ``registry.py``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import numpy as np
import torch

from portbench import roofline
from portbench.reference import decoder as reference
from portbench.weights import CODE_STD, LOGIT_STD, bf16_scale

ARCHITECTURES = ("Qwen2ForCausalLM", "MistralForCausalLM", "LlamaForCausalLM")
# K1 to K7 are the shared classes of ``trace.CLASSES``
KERNEL_CLASSES = ()

# the reference's reading of the window: the reference may import nothing
# that reaches the port, so it cannot import this file
attention_window = reference.attention_window


def port_forward():
    """(module, attribute) of the port function a serving forward calls,
    which ``FlopMeter`` wraps."""
    from videollm_online_tpu_torch.models import llama
    return llama, "forward"


def live_config(c: Dict[str, Any], *, max_response_tokens: int,
                gate_logit_bias: float):
    """The configuration file's JSON as the port's ``LiveConfig``."""
    from videollm_online_tpu_torch.core.config import LiveConfig, LlamaConfig
    live = c["live"]
    lcfg = LlamaConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
        rope_theta=float(c["rope_theta"]), rms_norm_eps=c["rms_norm_eps"],
        max_position_embeddings=c["max_position_embeddings"],
        sliding_window=attention_window(c),
        attention_bias=bool(c.get("qkv_bias")),
        tie_word_embeddings=bool(c.get("tie_word_embeddings")),
        dtype=c["activations"])
    return LiveConfig(
        llama=lcfg, lora=None,
        vision_hidden_size=live["vision_hidden_size"],
        frame_num_tokens=live["frame_num_tokens"],
        frame_token_interval=live["frame_token_interval"],
        frame_fps=float(live["frame_fps"]),
        max_num_frames=live["max_num_frames"],
        frame_token_interval_threshold=live["frame_token_interval_threshold"],
        max_response_tokens=max_response_tokens,
        gate_logit_bias=float(gate_logit_bias),
        system_prompt=live["system_prompt"])


def shapes(c: Dict[str, Any]) -> Dict[str, Any]:
    D, F = c["hidden_size"], c["intermediate_size"]
    d = c["head_dim"]
    q, kv = c["num_attention_heads"] * d, c["num_key_value_heads"] * d
    return {"wq": (D, q), "wk": (D, kv), "wv": (D, kv), "wo": (q, D),
            "w_gate": (D, F), "w_up": (D, F), "w_down": (F, D)}


def make_decoder(c: Dict[str, Any], g: torch.Generator, device
                 ) -> Dict[str, Any]:
    """The decoder's tree, as the port's ``models/llama.py`` takes it
    (layers stacked on a leading axis; a matrix is ``{"q8": (in, out)
    int8, "scale": (out,)}``), drawn from ``g``. Each projection keeps
    unit variance but q and k, whose entries have the std
    ``init.qk_gain``: attention scores of std qk_gain^2, so that with a
    gain above 1 a softmax picks fewer keys and an answer depends more on
    what its context holds. Norm weights and the Qwen2 q/k/v biases are
    random too, in the activation type."""
    L, D, V = c["num_hidden_layers"], c["hidden_size"], c["vocab_size"]
    fdt = getattr(torch, c["activations"])
    qk_gain = c["init"]["qk_gain"]

    def codes(shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, generator=g,
                             device=device)

    def spread(shape, base):
        # per-channel scales within a factor 0.75 to 1.25 of ``base``
        u = torch.rand(shape, generator=g, device=device)
        return bf16_scale(base * (0.75 + 0.5 * u))

    def near_one(shape):
        return (1.0 + 0.1 * torch.randn(shape, generator=g, device=device)
                ).to(fdt)

    layers = {"attn_norm": near_one((L, D)), "mlp_norm": near_one((L, D))}
    for name, (din, dout) in shapes(c).items():
        gain = qk_gain if name in ("wq", "wk") else 1.0
        layers[name] = {"q8": codes((L, din, dout)),
                        "scale": spread((L, dout), gain / math.sqrt(din)
                                        / CODE_STD)}
    if c.get("qkv_bias"):
        for name, key in (("bq", "wq"), ("bk", "wk"), ("bv", "wv")):
            dim = shapes(c)[key][1]
            layers[name] = (0.5 * torch.randn((L, dim), generator=g,
                                              device=device)).to(fdt)
    return {"embed": {"q8": codes((V, D)),
                      "scale": spread((V,), 1 / CODE_STD)},
            "layers": layers,
            "final_norm": near_one((D,)),
            "lm_head": {"q8": codes((D, V)),
                        "scale": spread((V,), LOGIT_STD / math.sqrt(D)
                                        / CODE_STD)}}


def matrix_params(c: Dict) -> Dict[str, int]:
    """Weights of one decoder layer's matrices, and of the head."""
    return {"layer": sum(i * o for i, o in shapes(c).values()),
            "head": c["hidden_size"] * c["vocab_size"]}


def forward_flops(c: Dict, num_valid: Sequence[int],
                  offsets: Sequence[int], head_rows: int) -> float:
    """Operations a serving forward must do: 2 per weight per valid token
    in every layer, the head only on the rows whose logits are taken, and
    attention (4 d a visible pair a query head) for the valid queries.
    Padding rows, the embedding gather, norms, rope and the connector (under
    0.3 % of a frame's operations) are left out."""
    L, Hq, d = (c["num_hidden_layers"], c["num_attention_heads"],
                c["head_dim"])
    w = attention_window(c)
    p = matrix_params(c)
    nv = np.asarray(num_valid, np.int64)
    off = np.asarray(offsets, np.int64)
    pairs = sum(int(roofline.visible(o + np.arange(n), w).sum())
                for o, n in zip(off, nv) if n)
    return (2.0 * p["layer"] * L * int(nv.sum()) + 4.0 * d * Hq * L * pairs
            + 2.0 * p["head"] * head_rows)


def kernel_calls(c: Dict, offsets: Sequence[int], S: int
                 ) -> Dict[str, tuple]:
    """{"K3": (operations, bytes, layers)}: one K3 call's count
    (``roofline.k3_call``) for the streams with valid tokens, whose S
    queries start at ``offsets``, and the number of layers that call it."""
    f, b = roofline.k3_call(offsets, S, c["num_attention_heads"],
                            c["num_key_value_heads"], c["head_dim"],
                            attention_window(c))
    return {"K3": (f, b, c["num_hidden_layers"])}
