"""HF checkpoint -> the port's parameter trees (host-side, one time).

Counterpart of ``videollm_online_tpu/models/convert.py``: the base Llama
weights (and the Mistral / Qwen2 variants: a ``sliding_window`` needs no
weights, ``attention_bias`` adds the q/k/v bias vectors) are converted once
into the stacked-layer tree of models/llama.py, the SigLIP tower into the
tree of models/siglip.py. A state dict may hold torch tensors or numpy
arrays; ``load_safetensors_state_dict`` reads one file or a sharded
directory.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..core.config import LlamaConfig, VisionConfig
from ..core.device import resolve_device, torch_dtype


def to_tensor(x, dtype: torch.dtype, device, transpose: bool = False
              ) -> torch.Tensor:
    """A numpy array or a tensor -> a contiguous tensor of ``dtype`` on
    ``device`` (transposed when asked: HF stores (out, in), the trees
    (in, out))."""
    t = torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) \
        else x.detach()
    if transpose:
        t = t.T
    return t.to(device=device, dtype=dtype).contiguous()


def dtype_of(dtype, default: str) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch_dtype(dtype or default)


def llama_params_from_state_dict(sd: Mapping[str, Any], cfg: LlamaConfig,
                                 dtype=None, device=None) -> Dict[str, Any]:
    """An HF ``LlamaForCausalLM`` (or Mistral / Qwen2) state dict -> the
    stacked tree, in ``dtype`` (default ``cfg.dtype``) on ``device``."""
    device = resolve_device(device)
    dtype = dtype_of(dtype, cfg.dtype)
    sd = {k.removeprefix("model."): v for k, v in sd.items()}
    L = cfg.num_layers

    def get(name, transpose=False):
        return to_tensor(sd[name], dtype, device, transpose)

    def stack(fmt, transpose=True):
        return torch.stack([get(fmt.format(i), transpose) for i in range(L)])

    layers = {
        "attn_norm": stack("layers.{}.input_layernorm.weight", False),
        "mlp_norm": stack("layers.{}.post_attention_layernorm.weight", False),
        "wq": stack("layers.{}.self_attn.q_proj.weight"),
        "wk": stack("layers.{}.self_attn.k_proj.weight"),
        "wv": stack("layers.{}.self_attn.v_proj.weight"),
        "wo": stack("layers.{}.self_attn.o_proj.weight"),
        "w_gate": stack("layers.{}.mlp.gate_proj.weight"),
        "w_up": stack("layers.{}.mlp.up_proj.weight"),
        "w_down": stack("layers.{}.mlp.down_proj.weight"),
    }
    if cfg.attention_bias:  # the Qwen2 family: q/k/v bias vectors
        for name in ("q", "k", "v"):
            layers[f"b{name}"] = stack(
                f"layers.{{}}.self_attn.{name}_proj.bias", False)
    params = {"embed": get("embed_tokens.weight"), "layers": layers,
              "final_norm": get("norm.weight")}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = get("lm_head.weight", True)
    return params


class ViTStateDict:
    """Reads an HF ViT vision tower's weights (SigLIP's and CLIP's share
    their names; ``vision_model.``-prefixed, as a whole two-tower model
    holds them, or bare) into the towers' trees, in ``dtype`` on
    ``device``."""

    def __init__(self, sd: Mapping[str, Any], dtype, device):
        self.sd = {re.sub(r"^(vision_model\.)", "", k): v
                   for k, v in sd.items()}
        self.dtype, self.device = dtype, device

    def get(self, name, transpose=False):
        return to_tensor(self.sd[name], self.dtype, self.device, transpose)

    def linear(self, prefix):
        return {"w": self.get(prefix + ".weight", True),
                "b": self.get(prefix + ".bias")}

    def layer_norm(self, prefix):
        return {"scale": self.get(prefix + ".weight"),
                "bias": self.get(prefix + ".bias")}

    def layers(self, num_layers: int):
        """The encoder's blocks, stacked along a leading layer axis."""
        from .siglip import _stack

        def layer(i):
            p = f"encoder.layers.{i}."
            lin, ln = self.linear, self.layer_norm
            return {"ln1": ln(p + "layer_norm1"), "ln2": ln(p + "layer_norm2"),
                    "q": lin(p + "self_attn.q_proj"),
                    "k": lin(p + "self_attn.k_proj"),
                    "v": lin(p + "self_attn.v_proj"),
                    "o": lin(p + "self_attn.out_proj"),
                    "fc1": lin(p + "mlp.fc1"), "fc2": lin(p + "mlp.fc2")}

        return _stack([layer(i) for i in range(num_layers)])

    def patch_embed_weight(self):
        """The patch conv's (D, 3, P, P) weight as a (3 P P, D) matmul,
        channel-major as the conv flattens it."""
        w = self.get("embeddings.patch_embedding.weight")
        return w.reshape(w.shape[0], -1).T.contiguous()


def siglip_params_from_state_dict(sd: Mapping[str, Any], cfg: VisionConfig,
                                  dtype=None, device=None) -> Dict[str, Any]:
    """HF ``SiglipVisionModel`` weights -> the tree of models/siglip.py, in
    ``dtype`` (default ``cfg.dtype``) on ``device``."""
    r = ViTStateDict(sd, dtype_of(dtype, cfg.dtype), resolve_device(device))
    get, lin, ln = r.get, r.linear, r.layer_norm
    params = {
        "patch_embed": {"w": r.patch_embed_weight(),
                        "b": get("embeddings.patch_embedding.bias")},
        "pos_embed": get("embeddings.position_embedding.weight"),
        "layers": r.layers(cfg.num_layers),
        "post_ln": ln("post_layernorm"),
    }
    # the attention-pooling head (pooler_output, vision_live.py:27)
    if "head.probe" in r.sd:
        params["head"] = {
            "probe": get("head.probe")[0],                     # (1, D)
            "in_proj_w": get("head.attention.in_proj_weight", True),
            "in_proj_b": get("head.attention.in_proj_bias"),
            "out_proj": lin("head.attention.out_proj"),
            "ln": ln("head.layernorm"),
            "fc1": lin("head.mlp.fc1"),
            "fc2": lin("head.mlp.fc2"),
        }
    return params


def load_safetensors_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """One ``.safetensors`` file, or every one in a (sharded) directory, as
    CPU tensors."""
    from safetensors.torch import load_file

    if os.path.isdir(path):
        files = sorted(os.path.join(path, f) for f in os.listdir(path)
                       if f.endswith(".safetensors"))
    else:
        files = [path]
    if not files or not all(os.path.isfile(f) for f in files):
        raise FileNotFoundError(f"no safetensors file at {path}")
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(load_file(f, device="cpu"))
    return sd
