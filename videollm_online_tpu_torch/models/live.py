"""The streaming video-dialogue model's connector, in PyTorch.

Counterpart of ``init_connector``/``apply_connector``/``visual_embed`` in
``videollm_online_tpu/models/live.py`` (Linear -> erf GELU -> Linear).
``joint_embed`` and the losses belong to the training slice.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import LiveConfig
from ..core.device import resolve_device, torch_dtype

Params = Dict[str, Any]


def init_connector(generator: torch.Generator, cfg: LiveConfig,
                   device=None) -> Params:
    """Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights, zero biases, drawn
    from ``generator`` (which must live on ``device``)."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.llama.dtype)
    vh, d = cfg.vision_hidden_size, cfg.llama.hidden_size

    def uniform(shape, bound):
        u = torch.rand(shape, generator=generator, device=device)
        return ((u * 2.0 - 1.0) * bound).to(dtype)

    return {
        "fc1": {"w": uniform((vh, d), 1.0 / np.sqrt(vh)),
                "b": torch.zeros((d,), dtype=dtype, device=device)},
        "fc2": {"w": uniform((d, d), 1.0 / np.sqrt(d)),
                "b": torch.zeros((d,), dtype=dtype, device=device)},
    }


def apply_connector(connector: Params, features: torch.Tensor) -> torch.Tensor:
    """(N, vision_hidden) -> (N, hidden); GELU is the exact erf form."""
    h = features @ connector["fc1"]["w"] + connector["fc1"]["b"]
    h = F.gelu(h, approximate="none")
    return h @ connector["fc2"]["w"] + connector["fc2"]["b"]


def visual_embed(params: Params, frames: torch.Tensor, cfg: LiveConfig
                 ) -> torch.Tensor:
    """Pre-extracted frame features (N, tokens_per_frame, vision_hidden) or
    (N*, vision_hidden) -> (N * tokens_per_frame, hidden)."""
    w = params["connector"]["fc1"]["w"]
    out = apply_connector(params["connector"],
                          frames.to(device=w.device, dtype=w.dtype))
    return out.reshape(-1, out.shape[-1])
