"""Parameter, adapter and training-state checkpoints with ``torch.save``.

Counterpart of ``videollm_online_tpu/train/checkpoints.py``. The formats
differ: the JAX package writes Orbax directories, the port one
``torch.save`` file per checkpoint (``<path>/params.pt``,
``<path>/adapter.pt`` or ``<path>/train_state.pt``), and neither reads the
other's. What is saved is the same: a params tree is any tree of tensors (a
whole ``{llama, connector[, lora]}`` model, or a bare decoder or tower as
the weight converter writes it); the adapter is the trainable subtree
(``lora`` + ``connector``, the PEFT-checkpoint equivalent); the train state
is the step, the trainable tree and the Adam moments and count, so a run
resumes at the same step with the same moments. Loading maps tensors onto
the device of the tree they are loaded into, or the one asked for.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

from ..core.device import resolve_device
from . import optim

ADAPTER_KEYS = ("lora", "connector")
PARAMS_FILE = "params.pt"
ADAPTER_FILE = "adapter.pt"


def _load(path: str, like_leaf: torch.Tensor):
    return torch.load(path, map_location=like_leaf.device, weights_only=True)


def _check_like(tree, like, where="") -> None:
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            raise ValueError(f"checkpoint tree differs at {where or '/'}")
        for k in like:
            _check_like(tree[k], like[k], f"{where}/{k}")
    elif tree.shape != like.shape or tree.dtype != like.dtype:
        raise ValueError(f"checkpoint leaf {where}: {tuple(tree.shape)} "
                         f"{tree.dtype}, expected {tuple(like.shape)} "
                         f"{like.dtype}")


def save_params(path: str, params: Dict[str, Any]) -> None:
    """Write a tree of tensors to ``<path>/params.pt``."""
    os.makedirs(path, exist_ok=True)
    torch.save(optim.tree_map(lambda x: x.detach(), params),
               os.path.join(path, PARAMS_FILE))


def restore_params(path: str, device=None) -> Dict[str, Any]:
    """The tree saved at ``path`` on ``device`` (the card unless the caller
    asks for the CPU)."""
    return torch.load(os.path.join(path, PARAMS_FILE),
                      map_location=resolve_device(device), weights_only=True)


def save_adapter(path: str, params: Dict[str, Any]) -> None:
    """Write the trainable subtree of ``params`` to ``<path>/adapter.pt``."""
    os.makedirs(path, exist_ok=True)
    adapter = {k: optim.tree_map(lambda x: x.detach(), params[k])
               for k in ADAPTER_KEYS if k in params}
    torch.save(adapter, os.path.join(path, ADAPTER_FILE))


def load_adapter_into(params: Dict[str, Any], path: str) -> Dict[str, Any]:
    """``params`` with its adapter subtree replaced by the one at
    ``path`` (which must have the same tree, shapes and dtypes)."""
    like = {k: params[k] for k in ADAPTER_KEYS if k in params}
    adapter = _load(os.path.join(path, ADAPTER_FILE),
                    optim.tree_leaves(like)[0])
    _check_like(adapter, like)
    out = dict(params)
    out.update(adapter)
    return out


def save_train_state(path: str, state) -> None:
    os.makedirs(path, exist_ok=True)
    opt = state.opt_state
    torch.save({"step": int(state.step),
                "trainable": optim.tree_map(lambda x: x.detach(),
                                            state.trainable),
                "opt_state": {"count": int(opt.count), "mu": opt.mu,
                              "nu": opt.nu}},
               os.path.join(path, "train_state.pt"))


def restore_train_state(path: str, like_state):
    """The state saved at ``path``, checked against ``like_state``'s tree;
    trainable leaves require gradients."""
    tree = _load(os.path.join(path, "train_state.pt"),
                 optim.tree_leaves(like_state.trainable)[0])
    _check_like(tree["trainable"], like_state.trainable)
    _check_like(tree["opt_state"]["mu"], like_state.opt_state.mu)
    _check_like(tree["opt_state"]["nu"], like_state.opt_state.nu)
    opt = tree["opt_state"]
    return type(like_state)(
        step=tree["step"],
        trainable=optim.tree_map(lambda x: x.requires_grad_(True),
                                 tree["trainable"]),
        opt_state=optim.AdamState(count=opt["count"], mu=opt["mu"],
                                  nu=opt["nu"]))
