"""Optimizer and LR schedule for LoRA + connector finetuning.

Counterpart of ``videollm_online_tpu/train/optim.py``, whose optimizer is
optax's ``chain(clip_by_global_norm(max_grad_norm), adamw(schedule))``. The
update is written here as plain tensor ops in optax's order, so that the two
packages take the same step from the same state:

  1. clip: with g_norm the global norm of the raw gradients, each g becomes
     ``(g / g_norm) * max_norm`` unless g_norm < max_norm;
  2. Adam moments ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``,
     kept in the parameter dtype, bias-corrected with the incremented count
     (t = 1 on the first step); with ``mu_dtype`` the first moment is
     stored in that dtype (optax's ``mu_dtype``: the step uses the moment
     before the cast);
  3. ``u = mu_hat / (sqrt(nu_hat) + eps)``, plus ``weight_decay * p``;
  4. ``p -= lr * u`` with lr from the schedule at the count BEFORE the
     increment: the warmup-cosine schedule gives lr 0 on the very first
     step, while the moments still move.

Each value takes optax's dtype: a Python scalar (a decay, eps, the weight
decay, ``max_grad_norm``) is rounded to the dtype of the tensor it meets,
as JAX rounds a weakly typed float (a bf16 moment is scaled by bf16 0.9);
the global norm is summed in the gradients' dtype; the bias correction is
``1 - decay**count`` in fp32 cast to the moment's dtype; lr is an fp32
value cast to the update's dtype, and the sum ``p + update`` is cast to
p's dtype.

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
    # the first moment's storage dtype ('' = the parameter dtype)
    mu_dtype: str = ""


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
    """sqrt of the sum of squares of every leaf, as optax's: each leaf's sum
    in its own dtype, the sums added in their promoted dtype (bf16 when
    every leaf is bf16)."""
    return torch.sqrt(sum((x * x).sum() for x in tree_leaves(tree)))


def _weak(x: float, t: torch.Tensor) -> torch.Tensor:
    """The Python scalar ``x`` as JAX applies it to ``t``: rounded to t's
    dtype (a bf16 moment is scaled by bf16 0.9)."""
    return torch.tensor(x, dtype=t.dtype)


@dataclass
class AdamState:
    """optax's ScaleByAdamState: ``count`` steps taken so far, moments in
    the parameter dtype."""
    count: int
    mu: Tree
    nu: Tree


def tree_unflatten(tree, leaves):
    """``leaves`` (in ``tree_leaves`` order) laid out as ``tree``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def init_adam(trainable: Tree, mu_dtype: str = "") -> AdamState:
    def mu(x):
        return torch.zeros_like(x, dtype=getattr(torch, mu_dtype)
                                if mu_dtype else None)
    return AdamState(count=0, mu=tree_map(mu, trainable),
                     nu=tree_map(torch.zeros_like, trainable))


@torch.no_grad()
def clip_grads(grads: Tree, cfg: OptimConfig) -> Tree:
    """Step 1: the gradients scaled to ``max_grad_norm`` when their global
    norm reaches it."""
    g_norm = global_norm(grads)
    if bool(g_norm >= _weak(cfg.max_grad_norm, g_norm)):
        grads = tree_map(lambda g: (g / g_norm.to(g.dtype))
                         * _weak(cfg.max_grad_norm, g), grads)
    return grads


@torch.no_grad()
def adam_leaf(g, m, v, p, count: int, lr: float, cfg: OptimConfig):
    """Steps 2-4 on one leaf, given its clipped gradient, moments and value
    and the incremented count: (new value, new mu as stored, new nu)."""
    def correct(t, decay):
        # 1 - decay**count in fp32, then in t's dtype (optax's
        # bias_correction)
        f32 = torch.tensor(decay, dtype=torch.float32)
        return t / (1 - f32 ** count).to(t.dtype)

    g2 = g ** 2
    m = _weak(1 - cfg.b1, g) * g + _weak(cfg.b1, m) * m
    v = _weak(1 - cfg.b2, g2) * g2 + _weak(cfg.b2, v) * v
    vh = torch.sqrt(correct(v, cfg.b2))
    u = correct(m, cfg.b1) / (vh + _weak(cfg.eps, vh))
    if cfg.weight_decay:
        u = u + _weak(cfg.weight_decay, p) * p
    if cfg.mu_dtype:
        m = m.to(getattr(torch, cfg.mu_dtype))
    step = torch.tensor(-lr, dtype=torch.float32).to(u.dtype)
    return (p + step * u).to(p.dtype), m, v


@torch.no_grad()
def adamw_update(grads: Tree, state: AdamState, params: Tree,
                 cfg: OptimConfig, schedule: Callable[[int], float]
                 ) -> Tuple[Tree, AdamState]:
    """One clip + AdamW step: (new params, new state). New tensors; the
    inputs are left as they are."""
    grads = clip_grads(grads, cfg)
    count, lr = state.count + 1, schedule(state.count)
    new = [adam_leaf(g, m, v, p, count, lr, cfg) for g, m, v, p in zip(
        *(tree_leaves(t) for t in (grads, state.mu, state.nu, params)))]
    ps, ms, vs = zip(*new)
    return tree_unflatten(params, ps), AdamState(
        count=count, mu=tree_unflatten(params, ms),
        nu=tree_unflatten(params, vs))


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
