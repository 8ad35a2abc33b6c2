"""Vision-tower factory: the encoder family by pretrained name.

Counterpart of ``videollm_online_tpu/models/vision.py`` (the reference's
build_live_vision dispatch, models/vision_live.py:54-61): google/siglip-*
-> SigLIP; laion/CLIP-* and openai/clip-* -> CLIP (quick-GELU only for
openai). Any other name raises, as the reference does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

from ..core.config import LiveConfig, VisionConfig
from . import clip as clip_mod
from . import convert
from . import siglip as siglip_mod


class VisionFns(NamedTuple):
    config: VisionConfig
    init_params: Callable
    preprocess: Callable
    frame_features: Callable   # (params, uint8 pixels) -> frame tokens
    params_from_state_dict: Callable


def build_vision(vision_pretrained: str, live_cfg: LiveConfig,
                 vision_cfg: Optional[VisionConfig] = None) -> VisionFns:
    name = vision_pretrained.lower()
    if "siglip" in name:
        cfg = vision_cfg or live_cfg.vision

        def feats(params, pixels):
            return siglip_mod.frame_features(
                params, siglip_mod.preprocess(pixels, cfg), cfg, live_cfg)

        return VisionFns(cfg, siglip_mod.init_params, siglip_mod.preprocess,
                         feats, convert.siglip_params_from_state_dict)
    if "clip" in name:
        quick = "openai" in name
        cfg = vision_cfg or clip_mod.clip_vision_config(
            image_size=live_cfg.frame_resolution
            if live_cfg.frame_resolution in (224, 336) else 336)

        def feats(params, pixels):
            return clip_mod.frame_features(
                params, clip_mod.preprocess(pixels, cfg), cfg, live_cfg,
                quick_gelu=quick)

        return VisionFns(cfg, clip_mod.init_params, clip_mod.preprocess,
                         feats, clip_mod.params_from_state_dict)
    raise ValueError(f"unverified vision_pretrained: {vision_pretrained} "
                     "(reference vision_live.py:61 raises the same)")
