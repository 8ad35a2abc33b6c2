"""Optimizer and LR schedule for LoRA + connector finetuning.

Counterpart of ``videollm_online_tpu/train/optim.py``, whose optimizer is
optax's ``chain(clip_by_global_norm(max_grad_norm), adamw(schedule))``. The
update is written here as plain tensor ops in optax's order, so that the two
packages take the same step from the same state:

  1. clip: with g_norm the global norm of the raw gradients, each g becomes
     ``(g / g_norm) * max_norm`` unless g_norm < max_norm;
  2. Adam moments ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
     kept in the parameter dtype, bias-corrected with the incremented count
     (t = 1 on the first step);
  3. ``u = mu_hat / (sqrt(nu_hat) + eps)``, plus ``weight_decay * p``;
  4. ``p -= lr * u`` with lr from the schedule at the count BEFORE the
     increment: the warmup-cosine schedule gives lr 0 on the very first
     step, while the moments still move.

The base (``llama``) is frozen; ``lora`` and ``connector`` train
(reference finetune_modules + LoRA, models/modeling_live.py:203-213).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

Tree = Any


class OptimConfig(NamedTuple):
    learning_rate: float = 2e-4
    warmup_ratio: float = 0.05
    total_steps: int = 1000
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    schedule: str = "cosine"  # or "constant"


def make_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """optax's warmup_cosine_decay_schedule (init 0, end 0) or, for
    "constant", a linear warmup joined to a constant, as functions of the
    integer step count."""
    warmup = max(int(cfg.total_steps * cfg.warmup_ratio), 1)
    peak = cfg.learning_rate
    decay = max(cfg.total_steps, warmup + 1) - warmup

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        if cfg.schedule == "constant":
            return peak
        c = min(count - warmup, decay)
        return peak * 0.5 * (1.0 + math.cos(math.pi * c / decay))

    return schedule


def tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum((x.float() ** 2).sum() for x in tree_leaves(tree)))


@dataclass
class AdamState:
    """optax's ScaleByAdamState: ``count`` steps taken so far, moments in
    the parameter dtype."""
    count: int
    mu: Tree
    nu: Tree


def init_adam(trainable: Tree) -> AdamState:
    return AdamState(count=0, mu=tree_map(torch.zeros_like, trainable),
                     nu=tree_map(torch.zeros_like, trainable))


@torch.no_grad()
def adamw_update(grads: Tree, state: AdamState, params: Tree,
                 cfg: OptimConfig, schedule: Callable[[int], float]
                 ) -> Tuple[Tree, AdamState]:
    """One clip + AdamW step: (new params, new state). New tensors; the
    inputs are left as they are."""
    g_norm = global_norm(grads)
    clip = bool(g_norm >= cfg.max_grad_norm)
    if clip:
        grads = tree_map(lambda g: (g / g_norm.to(g.dtype)) * cfg.max_grad_norm,
                         grads)
    mu = tree_map(lambda g, m: (1 - cfg.b1) * g + cfg.b1 * m, grads, state.mu)
    nu = tree_map(lambda g, v: (1 - cfg.b2) * (g ** 2) + cfg.b2 * v, grads,
                  state.nu)
    count = state.count + 1
    bc1, bc2 = 1 - cfg.b1 ** count, 1 - cfg.b2 ** count
    lr = schedule(state.count)

    def step(p, m, v):
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if cfg.weight_decay:
            u = u + cfg.weight_decay * p
        return p + (-lr) * u

    new_params = tree_map(step, params, mu, nu)
    return new_params, AdamState(count=count, mu=mu, nu=nu)


def split_trainable(params: Dict[str, Any]):
    """(trainable, frozen): LoRA + connector train; the Llama base is
    frozen."""
    trainable = {k: params[k] for k in ("lora", "connector") if k in params}
    frozen = {k: v for k, v in params.items() if k not in trainable}
    return trainable, frozen


def merge_params(trainable: dict, frozen: dict) -> dict:
    out = dict(frozen)
    out.update(trainable)
    return out


def count_params(tree: Tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))
