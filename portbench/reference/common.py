"""What every family's reference shares: exact fp32 products, the
control's rounding and the connector (``weights.make`` makes it alike for
every family)."""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


def exact_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Rounder:
    """Identity (the reference) or per-row float8 e4m3 (the control)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        with torch.no_grad():
            s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / FP8_MAX
            r = (x / s).to(torch.float8_e4m3fn).float() * s
        # straight through in a backward: the rounding's gradient is 1
        return x + (r - x).detach()


def connector(conn: Dict[str, Any], feats: torch.Tensor) -> torch.Tensor:
    """Frame features (n, vision_hidden) -> (n, D): Linear, erf GELU, Linear."""
    h = feats.float() @ conn["fc1"]["w"].float() + conn["fc1"]["b"].float()
    h = F.gelu(h, approximate="none")
    return h @ conn["fc2"]["w"].float() + conn["fc2"]["b"].float()
