"""Weight-only int8 quantization for serving.

Counterpart of the int8 part of ``videollm_online_tpu/models/quant.py``.
A quantized matrix is ``{"q8": int8 (in, out), "scale": fp32 (out,)}``
(per output channel; the embedding table keeps one scale per row).
``models.llama.dense``/``embed_tokens``/``lm_head`` accept these leaves.

``quantized_matmul`` is plain ``torch.matmul``: the JAX package leaves it
to XLA, which fuses the s8 -> bf16 convert into the matmul. PyTorch eager
does not fuse, so every call builds a dequantized copy of the weight; a
W8A16 kernel that dequantizes in registers is later work.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.device import resolve_device

QUANT_KEY = "q8"


def quantize_weight(w: torch.Tensor, axis: int = 0) -> Dict[str, torch.Tensor]:
    """Symmetric per-channel int8 over the reduction ``axis``; codes are
    bit-identical to the JAX package's on the same fp32 input."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {QUANT_KEY: q, "scale": scale.squeeze(axis)}


def dequantize_weight(qw: Dict[str, torch.Tensor], axis: int = 0,
                      dtype=torch.bfloat16) -> torch.Tensor:
    scale = qw["scale"].unsqueeze(axis)
    return (qw[QUANT_KEY].float() * scale).to(dtype)


def quantized_matmul(x: torch.Tensor, qw: Dict[str, torch.Tensor]
                     ) -> torch.Tensor:
    """x (.., in) @ q8 (in, out), then * scale (out,), both in x's dtype
    and in that order (the JAX epilogue order)."""
    y = x @ qw[QUANT_KEY].to(x.dtype)
    return y * qw["scale"].to(x.dtype)


def quantize_llama_params(params: Dict[str, Any], bits: int = 8
                          ) -> Dict[str, Any]:
    """Quantize every big decoder matrix to int8 (``bits`` = 8 only; the
    int4 layout is a later slice); norms and biases pass through."""
    if bits != 8:
        raise NotImplementedError("only int8 weights are ported")
    out = {"embed": quantize_weight(params["embed"], axis=1),
           "final_norm": params["final_norm"]}
    out["layers"] = {
        name: (w if name in ("attn_norm", "mlp_norm", "bq", "bk", "bv")
               else quantize_weight(w, axis=-2))
        for name, w in params["layers"].items()}
    if "lm_head" in params:
        out["lm_head"] = quantize_weight(params["lm_head"], axis=-2)
    return out


def random_quantized_llama_params(generator: torch.Generator, cfg,
                                  bits: int = 8, device=None
                                  ) -> Dict[str, Any]:
    """An int8 decoder with random codes, built directly on ``device`` from
    ``generator`` (which must live on that device): no bf16 staging copy
    exists at any point."""
    if bits != 8:
        raise NotImplementedError("only int8 weights are ported")
    device = resolve_device(device)
    L, D, F = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size

    def codes(shape):
        return torch.randint(-127, 128, shape, dtype=torch.int8,
                             generator=generator, device=device)

    def qrand8(shape, fan_in):
        scale = torch.full(shape[:-2] + (shape[-1],),
                           0.02 / 127.0 / np.sqrt(fan_in / D),
                           dtype=torch.float32, device=device)
        return {QUANT_KEY: codes(shape), "scale": scale}

    dims = {
        "wq": (D, cfg.q_dim), "wk": (D, cfg.kv_dim), "wv": (D, cfg.kv_dim),
        "wo": (cfg.q_dim, D), "w_gate": (D, F), "w_up": (D, F),
        "w_down": (F, D),
    }
    bf16 = dict(dtype=torch.bfloat16, device=device)
    layers = {"attn_norm": torch.ones((L, D), **bf16),
              "mlp_norm": torch.ones((L, D), **bf16)}
    for name, (din, dout) in dims.items():
        layers[name] = qrand8((L, din, dout), din)
    if cfg.attention_bias:
        layers["bq"] = torch.zeros((L, cfg.q_dim), **bf16)
        layers["bk"] = torch.zeros((L, cfg.kv_dim), **bf16)
        layers["bv"] = torch.zeros((L, cfg.kv_dim), **bf16)
    V = cfg.vocab_size
    return {
        "embed": {QUANT_KEY: codes((V, D)),
                  "scale": torch.full((V,), 0.02 / 127.0,
                                      dtype=torch.float32, device=device)},
        "layers": layers,
        "final_norm": torch.ones((D,), **bf16),
        "lm_head": qrand8((D, V), D),
    }


def param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()
