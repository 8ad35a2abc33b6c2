"""The training step: weighted streaming CE over LoRA + connector.

Counterpart of ``videollm_online_tpu/train/step.py``. One step is forward
(per-layer remat, or grouped with ``remat_group``) + backward + the
clip/AdamW update of train/optim.py (``update``: train/offload.py gives
one that streams host-resident moments).
Gradient accumulation averages the gradients of the microbatches on a
leading axis of the batch, as the JAX package's scan does. PyTorch runs
eagerly, so there is no jit.

On a mesh (``parallel.mesh.maybe_mesh`` around the step) the params are
the rank-local tree of ``shard_params`` and the batch the rank's part of
``shard_batch``; each rank's loss is its share of the global loss
(``models/live.py``), so the gradient of every trainable (replicated)
leaf is the sum of the ranks' gradients over the whole mesh, taken
before the clip and the update: every rank then takes the same step.

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
from ..parallel import collectives as coll
from ..parallel import sharding as shd
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, current_mesh
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
            chunked_loss=False, loss_chunk=None,
            remat_group: int = 1) -> torch.Tensor:
    params = optim.merge_params(trainable, frozen)
    _, loss = live.forward(
        params, cfg, input_ids=batch["input_ids"], frames=batch.get("frames"),
        labels=batch["labels"], remat=remat, attn_impl=attn_impl,
        dropout_seed=dropout_seed, chunked_loss=chunked_loss,
        loss_chunk=loss_chunk, shard=batch.get("shard"),
        remat_group=remat_group)
    return loss


def _grads(trainable, frozen, cfg, batch, seed, kw):
    loss = loss_fn(trainable, frozen, cfg, batch, dropout_seed=seed, **kw)
    leaves = optim.tree_leaves(trainable)
    # a leaf the batch does not reach (the connector of a batch without
    # frames) gets a zero gradient, as under JAX's autodiff
    grads = coll.reduce_grads(
        torch.autograd.grad(loss, leaves, allow_unused=True,
                            materialize_grads=True), current_mesh())
    return loss.detach(), optim.tree_unflatten(trainable, grads)


def train_step(state: TrainState, frozen, batch, *, cfg: LiveConfig,
               optim_cfg: optim.OptimConfig, schedule, accum_steps: int = 1,
               attn_impl=None, chunked_loss: bool = False, loss_chunk=None,
               remat: bool = True, remat_group: int = 1,
               update=optim.adamw_update
               ) -> Tuple[TrainState, Dict[str, Any]]:
    """One optimizer step. With ``accum_steps > 1`` every entry of
    ``batch`` carries a leading (accum_steps, ...) axis and the gradients
    (and loss) are averaged over it. Metrics: ``loss``, ``grad_norm`` (the
    global norm of the raw, unclipped gradients) and ``step`` (before the
    increment), as tensors. ``update`` has ``optim.adamw_update``'s
    signature."""
    kw = dict(remat=remat, attn_impl=attn_impl, chunked_loss=chunked_loss,
              loss_chunk=loss_chunk, remat_group=remat_group)
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
    new_params, opt_state = update(grads, state.opt_state, params, optim_cfg,
                                   schedule)
    trainable = optim.tree_map(lambda p: p.requires_grad_(True), new_params)
    metrics = {"loss": loss, "grad_norm": grad_norm, "step": state.step}
    return TrainState(state.step + 1, trainable, opt_state), metrics


def shard_params(params, mesh, policy: str = "fsdp_tp", *, cfg=None,
                 axes=(DATA_AXIS, MODEL_AXIS)):
    """This rank's part of a whole param tree (the one ``bridge.py`` or
    ``init_params`` builds) under the rules of ``parallel/sharding.py``:
    every decoder matrix cut to the rank's block of the logical matrix,
    its layout rebuilt (``shard_matrix``); LoRA, the connector, norms and
    biases whole. Only the mesh ``axes`` given cut; a matrix stays whole
    along the others. ``cfg`` (a ``LiveConfig`` or ``LlamaConfig``) gives
    the head layout the model axis cuts along; it is needed when that
    axis cuts and is wider than 1."""
    assert policy in shd.POLICIES, policy
    if mesh is None or mesh.size == 1:
        return params
    n_model = mesh.shape[MODEL_AXIS] if MODEL_AXIS in axes else 1
    lcfg = getattr(cfg, "llama", cfg)
    if n_model > 1 and lcfg is None:
        raise ValueError("shard_params over a model axis needs cfg")
    ranges = (shd.tp_ranges(lcfg, n_model, mesh.coord(MODEL_AXIS))
              if n_model > 1 else None)

    def one(leaf, path, name):
        logical = shd.logical_shape(leaf)
        spec = shd._spec_for_path(path, policy, len(logical))
        for dim, axis in enumerate(spec):
            n = 1 if axis not in axes else mesh.shape[axis]
            if n == 1:
                continue
            if axis == MODEL_AXIS:
                start, count = ranges[shd.model_range_key(name)]
            else:
                if logical[dim] % n:
                    raise ValueError(f"{path}: dim {dim} of {logical} does "
                                     f"not split over {axis}={n}")
                count = logical[dim] // n
                start = mesh.coord(axis) * count
            leaf = shd.shard_matrix(leaf, dim, start, count,
                                    row_scaled=name == "embed")
        return leaf

    def llama_tree(tree, prefix):
        out = {}
        for k, v in tree.items():
            if k == "layers":
                out[k] = {n: (one(m, f"{prefix}layers/{n}", n)
                              if n in shd.MATRICES else m)
                          for n, m in v.items()}
            elif k in ("embed", "lm_head"):
                out[k] = one(v, prefix + k, k)
            else:
                out[k] = v
        return out

    if "llama" in params:
        return dict(params, llama=llama_tree(params["llama"], "llama/"))
    return llama_tree(params, "")


def shard_batch(batch, mesh, accum_axis: bool = False, *, cfg=None):
    """This rank's part of a collated batch: entries split over ``data``
    on the batch dim (dim 1 with ``accum_axis``); ``frames`` (flattened
    across the batch) whole; a batch that ``data`` does not divide whole
    on every rank. A split batch gains ``"shard"``: (row start, global
    rows, ``<v>`` count of the global rows before this rank's), one row
    per microbatch with ``accum_axis``; its ``<v>`` id comes from ``cfg``
    when there are frames."""
    n = 1 if mesh is None else mesh.shape[DATA_AXIS]
    bdim = 1 if accum_axis else 0
    ids = torch.as_tensor(batch["input_ids"])
    B = ids.shape[bdim]
    if n == 1 or B % n:
        return dict(batch)
    i = mesh.coord(DATA_AXIS)
    b = B // n
    out = {}
    for k, v in batch.items():
        if v is None or k == "frames":
            out[k] = v
        else:
            out[k] = torch.as_tensor(v).narrow(bdim, i * b, b)
    v_off = torch.zeros(ids.shape[:bdim], dtype=torch.int64)
    if batch.get("frames") is not None:
        if cfg is None:
            raise ValueError("shard_batch with frames needs cfg for <v>")
        before = ids.narrow(bdim, 0, i * b).cpu()
        v_off = (before == cfg.v_placeholder_id).reshape(
            *ids.shape[:bdim], -1).sum(-1)
    out["shard"] = torch.stack(torch.broadcast_tensors(
        torch.tensor(i * b), torch.tensor(B), v_off), dim=-1)
    return out
