"""The weights of a configuration, made on the device from the seed.

The base decoder is made in the type it is served in: weight-only int8
codes with one fp32 scale per output channel (per row for the embedding),
laid out as the port's parameter tree takes them (layers stacked on a
leading axis; a matrix is ``{"q8": (in, out) int8, "scale": (out,)}``).
Scales are rounded to bf16 values, so a code times its scale is exact in
bf16 and in fp32 alike. Each projection keeps unit variance but q and k,
whose entries have the std ``init.qk_gain`` of the configuration file:
attention scores of std qk_gain^2, so that with a gain above 1 a softmax
picks fewer keys and an answer depends more on what its context holds.
Norm weights, the Qwen2 q/k/v biases and the connector are random too, so
every part of the model moves the output; they are in the configuration's
activation type. Every tensor comes from one CUDA generator in a few large
calls. The same tree goes to the program and to the
reference, which dequantizes it itself.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

CODE_STD = 127 / math.sqrt(3)   # std of codes uniform over [-127, 127]
LOGIT_STD = 4.0                 # the head's logits, roughly


def sub_seed(seed: int, tag: int) -> int:
    """A seed for one stream of randomness, from the run's seed and a tag."""
    state = np.random.SeedSequence([abs(int(seed)), int(tag)])
    return int(state.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def attention_window(c: Dict[str, Any]) -> Optional[int]:
    """The sliding window a configuration's attention uses (None: full
    causal); Qwen2's config carries a window it does not use."""
    if not c.get("use_sliding_window", True):
        return None
    return c.get("sliding_window")


def shapes(c: Dict[str, Any]) -> Dict[str, Any]:
    D, F = c["hidden_size"], c["intermediate_size"]
    d = c["head_dim"]
    q, kv = c["num_attention_heads"] * d, c["num_key_value_heads"] * d
    return {"wq": (D, q), "wk": (D, kv), "wv": (D, kv), "wo": (q, D),
            "w_gate": (D, F), "w_up": (D, F), "w_down": (F, D)}


def _bf16_scale(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def make(c: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """{"llama", "connector"} for configuration ``c`` (the
    configuration file's JSON)."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    L, D, V = c["num_hidden_layers"], c["hidden_size"], c["vocab_size"]
    fdt = getattr(torch, c["activations"])
    qk_gain = c["init"]["qk_gain"]

    def codes(shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8, generator=g,
                             device=device)

    def spread(shape, base):
        # per-channel scales within a factor 0.75 to 1.25 of ``base``
        u = torch.rand(shape, generator=g, device=device)
        return _bf16_scale(base * (0.75 + 0.5 * u))

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
    llama = {"embed": {"q8": codes((V, D)),
                       "scale": spread((V,), 1 / CODE_STD)},
             "layers": layers,
             "final_norm": near_one((D,)),
             "lm_head": {"q8": codes((D, V)),
                         "scale": spread((V,), LOGIT_STD / math.sqrt(D)
                                         / CODE_STD)}}
    vh = c["live"]["vision_hidden_size"]

    def uniform(shape, bound):
        u = torch.rand(shape, generator=g, device=device)
        return ((u * 2 - 1) * bound).to(fdt)

    connector = {"fc1": {"w": uniform((vh, D), 1 / math.sqrt(vh)),
                         "b": uniform((D,), 0.1)},
                 "fc2": {"w": uniform((D, D), 1 / math.sqrt(D)),
                         "b": uniform((D,), 0.1)}}
    return {"llama": llama, "connector": connector}

