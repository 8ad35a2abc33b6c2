"""Carry a parameter tree (and a training state) of numpy arrays into the
port's tensors.

The JAX package's params, fetched to the host as nested dicts of numpy
arrays, map one to one onto the port's tree: stacked ``layers`` leaves,
``{"q8", "scale"}`` int8 leaves, the int4 leaves ``{"q4c", "scale"}``
(column-packed) and ``{"q4p", "scale"}`` (row-packed) with their packed
int8 bytes and fp32 ``(in/group, out)`` scales, the int8 ``embed`` with
per-row scales, ``lm_head``, ``final_norm``, ``connector`` and the optional
``lora`` tree. The byte layouts are the JAX package's, so a
``quantize_llama_params(bits=4)`` tree crosses unchanged. The vision
towers' trees (SigLIP, CLIP) cross with ``vision_params_from_numpy``.
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
    scales (``"scale"`` keys stay fp32); int8 codes and packed int4 bytes
    are never recast."""
    device = resolve_device(device)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return _tensor(node, device, dtype, keep=key == "scale")

    return walk(tree)


def vision_params_from_numpy(tree: Any, device=None,
                             dtype: Optional[torch.dtype] = None) -> Any:
    """A JAX SigLIP or CLIP tree (nested dicts of numpy arrays) -> the same
    dicts of tensors on ``device``. Unlike ``params_from_numpy`` no key is
    kept out of ``dtype``: a vision tree's ``"scale"`` leaves are layer-norm
    weights, not quantization scales."""
    device = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _tensor(node, device, dtype, keep=False)

    return walk(tree)


def train_state_from_numpy(step: int, trainable: Any, mu: Any, nu: Any,
                           count: int, device=None):
    """The port's ``TrainState`` from a JAX one fetched to the host: the
    step, the trainable tree and optax's Adam ``mu``, ``nu`` and ``count``
    (each a nested dict of numpy arrays, or an int), so that both packages
    start the same step from the same state. Trainable leaves require
    gradients."""
    from ..train.optim import AdamState, tree_map
    from ..train.step import TrainState
    trainable = tree_map(lambda x: x.requires_grad_(True),
                         params_from_numpy(trainable, device))
    return TrainState(step=int(step), trainable=trainable,
                      opt_state=AdamState(
                          count=int(count),
                          mu=params_from_numpy(mu, device),
                          nu=params_from_numpy(nu, device)))
