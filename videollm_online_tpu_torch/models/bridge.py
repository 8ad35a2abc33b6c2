"""Carry a parameter tree of numpy arrays into the port's tensors.

The JAX package's params, fetched to the host as nested dicts of numpy
arrays, map one to one onto the port's tree: stacked ``layers`` leaves,
``{"q8", "scale"}`` int8 leaves, the int8 ``embed`` with per-row scales,
``lm_head``, ``final_norm``, ``connector`` and the optional ``lora`` tree.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..core.device import resolve_device


def _tensor(a: np.ndarray, device, dtype: Optional[torch.dtype],
            keep: bool) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    if dtype is not None and not keep and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Any, device=None,
                      dtype: Optional[torch.dtype] = None) -> Any:
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device``. ``dtype`` recasts floating leaves, except quantization
    scales (``"scale"`` keys stay fp32); int8 codes are never recast."""
    device = resolve_device(device)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return _tensor(node, device, dtype, keep=key == "scale")

    return walk(tree)
