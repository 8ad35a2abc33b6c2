"""Functional CLIP ViT vision tower (laion / openai CLIP), in PyTorch.

Counterpart of ``videollm_online_tpu/models/clip.py`` (reference
models/vision_live.py:32-52): OPENAI mean/std normalization, a learned
class embedding before the patches, a pre-encoder LayerNorm, quick-GELU
(openai) or erf GELU (laion), position embeddings over CLS + patches; the
frame's CLS token is ``last_hidden[:, 0]`` and the spatial tokens pool the
patches without it.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..core.config import LiveConfig, VisionConfig
from ..core.device import resolve_device, torch_dtype
# preprocess is SigLIP's: the same math over CLIP's mean and std
from .siglip import (_linear_init, _ln_init, _normal, encoder_layer,
                     index_tree, init_layers, layer_norm, linear, patchify,
                     preprocess, spatial_pool)

Params = Dict[str, Any]

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_vision_config(**overrides) -> VisionConfig:
    kw = dict(image_size=336, patch_size=14, hidden_size=1024,
              intermediate_size=4096, num_layers=24, num_heads=16,
              layer_norm_eps=1e-5, mean=OPENAI_MEAN, std=OPENAI_STD,
              family="clip")
    kw.update(overrides)
    return VisionConfig(**kw)


def _quick_gelu(y):
    return y * torch.sigmoid(1.702 * y)


def _gelu_erf(y):
    return F.gelu(y, approximate="none")


def encode(params: Params, pixels: torch.Tensor, cfg: VisionConfig,
           quick_gelu: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """pixels (B, 3, H, W) normalized -> (last_hidden (B, 1 + P, D), pooled
    CLS (B, D) = the post-LN class token, CLIPVisionModel's
    pooler_output)."""
    B = pixels.shape[0]
    D = cfg.hidden_size
    dtype = params["pos_embed"].dtype
    x = linear(patchify(pixels.to(dtype), cfg.patch_size),
               params["patch_embed"])
    cls = params["class_embed"][None, None].expand(B, 1, D).to(x.dtype)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"][None]
    x = layer_norm(x, params["pre_ln"], cfg.layer_norm_eps)
    act = _quick_gelu if quick_gelu else _gelu_erf
    for i in range(params["layers"]["q"]["w"].shape[0]):
        x = encoder_layer(x, index_tree(params["layers"], i), cfg, act)
    pooled = layer_norm(x[:, :1], params["post_ln"], cfg.layer_norm_eps)[:, 0]
    return x, pooled


def frame_features(params: Params, pixels: torch.Tensor, cfg: VisionConfig,
                   live_cfg: LiveConfig, quick_gelu: bool = True
                   ) -> torch.Tensor:
    """The reference's _clip_vision_encode layout: CLS = the raw
    last_hidden[:, 0]; the spatial pool over the patches without it."""
    last_hidden, _ = encode(params, pixels, cfg, quick_gelu)
    parts = []
    if live_cfg.frame_token_cls:
        parts.append(last_hidden[:, :1])
    if live_cfg.frame_token_pooled:
        parts.append(spatial_pool(last_hidden[:, 1:],
                                  tuple(live_cfg.frame_token_pooled)))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def init_params(generator: torch.Generator, cfg: VisionConfig, device=None
                ) -> Params:
    """Random weights in the CLIP layout (the tree params_from_state_dict
    gives), drawn from ``generator`` on ``device``."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    D = cfg.hidden_size
    patch_dim = 3 * cfg.patch_size * cfg.patch_size
    return {
        "patch_embed": _linear_init(generator, patch_dim, D, dtype, device),
        "class_embed": _normal(generator, (D,), 0.02, dtype, device),
        "pos_embed": _normal(generator, (cfg.num_patches + 1, D), 0.02,
                             dtype, device),
        "pre_ln": _ln_init(D, dtype, device),
        "layers": init_layers(generator, cfg, dtype, device),
        "post_ln": _ln_init(D, dtype, device),
    }


def params_from_state_dict(sd, cfg: VisionConfig, dtype=None, device=None
                           ) -> Params:
    """HF CLIPVisionModel weights -> the tree above, in ``dtype`` (default
    ``cfg.dtype``) on ``device``."""
    from .convert import ViTStateDict, dtype_of
    device = resolve_device(device)
    dtype = dtype_of(dtype, cfg.dtype)
    r = ViTStateDict(sd, dtype, device)
    w = r.patch_embed_weight()
    return {
        # CLIP's patch conv has no bias
        "patch_embed": {"w": w, "b": torch.zeros((w.shape[1],), dtype=dtype,
                                                 device=device)},
        "class_embed": r.get("embeddings.class_embedding"),
        "pos_embed": r.get("embeddings.position_embedding.weight"),
        "pre_ln": r.layer_norm("pre_layrnorm"),  # (sic) the HF attribute name
        "layers": r.layers(cfg.num_layers),
        "post_ln": r.layer_norm("post_layernorm"),
    }
