"""The training step: weighted streaming CE over LoRA + connector.

Counterpart of ``videollm_online_tpu/train/step.py``. One step is forward
(per-layer remat) + backward + the clip/AdamW update of train/optim.py.
Gradient accumulation averages the gradients of the microbatches on a
leading axis of the batch, as the JAX package's scan does. PyTorch runs
eagerly, so there is no jit; sharding belongs to the parallel slice.

LoRA dropout is seeded per step (``fold_seed(DROPOUT_SEED, step)``, then per
microbatch), as the JAX package folds the step into its key: a resumed run
draws the same masks, and there is no RNG state to checkpoint.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.config import LiveConfig
from ..models import live
from ..models.llama import fold_seed
from . import optim

DROPOUT_SEED = 0x10AD


class TrainState(NamedTuple):
    step: int
    trainable: Dict[str, Any]
    opt_state: optim.AdamState


def init_train_state(params: Dict[str, Any]
                     ) -> Tuple[TrainState, Dict[str, Any]]:
    """(state, frozen). The trainable leaves are copied into fresh leaf
    tensors that require gradients; the frozen tree never does."""
    trainable, frozen = optim.split_trainable(params)
    trainable = optim.tree_map(
        lambda x: x.detach().clone().requires_grad_(True), trainable)
    return TrainState(step=0, trainable=trainable,
                      opt_state=optim.init_adam(trainable)), frozen


def loss_fn(trainable, frozen, cfg: LiveConfig, batch, *, remat=True,
            attn_impl=None, dropout_seed: Optional[int] = None,
            chunked_loss=False, loss_chunk=None) -> torch.Tensor:
    params = optim.merge_params(trainable, frozen)
    _, loss = live.forward(
        params, cfg, input_ids=batch["input_ids"], frames=batch.get("frames"),
        labels=batch["labels"], remat=remat, attn_impl=attn_impl,
        dropout_seed=dropout_seed, chunked_loss=chunked_loss,
        loss_chunk=loss_chunk)
    return loss


def _grads(trainable, frozen, cfg, batch, seed, kw):
    loss = loss_fn(trainable, frozen, cfg, batch, dropout_seed=seed, **kw)
    leaves = optim.tree_leaves(trainable)
    grads = torch.autograd.grad(loss, leaves)
    it = iter(grads)
    return loss.detach(), optim.tree_map(lambda _: next(it), trainable)


def train_step(state: TrainState, frozen, batch, *, cfg: LiveConfig,
               optim_cfg: optim.OptimConfig, schedule, accum_steps: int = 1,
               attn_impl=None, chunked_loss: bool = False, loss_chunk=None,
               remat: bool = True) -> Tuple[TrainState, Dict[str, Any]]:
    """One optimizer step. With ``accum_steps > 1`` every entry of
    ``batch`` carries a leading (accum_steps, ...) axis and the gradients
    (and loss) are averaged over it. Metrics: ``loss``, ``grad_norm`` (the
    global norm of the raw, unclipped gradients) and ``step`` (before the
    increment), as tensors."""
    kw = dict(remat=remat, attn_impl=attn_impl, chunked_loss=chunked_loss,
              loss_chunk=loss_chunk)
    step_seed = fold_seed(DROPOUT_SEED, state.step)
    if accum_steps == 1:
        loss, grads = _grads(state.trainable, frozen, cfg, batch, step_seed,
                             kw)
    else:
        loss, grads = None, None
        for a in range(accum_steps):
            micro = {k: v[a] for k, v in batch.items() if v is not None}
            l, g = _grads(state.trainable, frozen, cfg, micro,
                          fold_seed(step_seed, a), kw)
            loss = l if loss is None else loss + l
            grads = g if grads is None else optim.tree_map(torch.add, grads, g)
        loss = loss / accum_steps
        grads = optim.tree_map(lambda g: g / accum_steps, grads)
    grad_norm = optim.global_norm(grads)
    params = optim.tree_map(lambda p: p.detach(), state.trainable)
    new_params, opt_state = optim.adamw_update(grads, state.opt_state, params,
                                               optim_cfg, schedule)
    trainable = optim.tree_map(lambda p: p.requires_grad_(True), new_params)
    metrics = {"loss": loss, "grad_norm": grad_norm, "step": state.step}
    return TrainState(state.step + 1, trainable, opt_state), metrics
