"""Host-offloaded optimizer state: the Adam moments live in pinned host
memory between steps.

Counterpart of ``videollm_online_tpu/train/offload.py`` (the analog of the
reference's DeepSpeed ZeRO-2 CPU offload, configs/deepspeed/
zero2offload.json). ``make_offload_train_step`` gives the same step as
``step.train_step`` on a state whose moments are host-resident
(``offload_state``), in two variants:

  * in-step (a CUDA device): after the backward, each leaf's moments are
    copied to the card on a side stream just ahead of that leaf's update
    (``non_blocking`` from pinned memory, one leaf ahead, ordered by CUDA
    events), and each updated pair is written back into its pinned buffer
    on a second side stream. The card holds the moments of two or three
    leaves at a time, never the whole tree; the copies overlap the other
    leaves' updates. The counterpart of the JAX package's ``in_step``,
    where XLA overlaps the host DMA inside the program.
  * boundary (the CPU, or ``in_step=False``): the whole moment tree goes to
    the device before the plain step and back after it. Between steps the
    device holds no moment; during the update it holds all of them.

Both give the plain step's params, moments and loss bit for bit: the
update's arithmetic is ``optim.adam_leaf``'s on the same values. The
in-step variant writes the new moments into the pinned buffers it was
given (as the JAX step donates its state), and waits for the last write
before it returns, so the host may read them.
"""

from __future__ import annotations

import functools
from typing import Any, Optional

import torch

from . import optim
from . import step as step_mod


def _map_state(fn, tree: Any) -> Any:
    """fn over every tensor leaf of a moment tree or an ``AdamState``
    (its ``count``, a host int, stays as it is)."""
    if isinstance(tree, optim.AdamState):
        return optim.AdamState(count=tree.count, mu=_map_state(fn, tree.mu),
                               nu=_map_state(fn, tree.nu))
    return optim.tree_map(fn, tree)


def _pinned_copy(x: torch.Tensor) -> torch.Tensor:
    # pinned memory needs a CUDA runtime; without one a plain host copy
    return torch.empty(x.shape, dtype=x.dtype,
                       pin_memory=torch.cuda.is_available()).copy_(x)


def to_host(tree: Any) -> Any:
    """Pinned host copies of every non-scalar leaf (a scalar stays where it
    is, as the JAX package leaves its step counters)."""
    return _map_state(lambda x: x if x.ndim == 0 else _pinned_copy(x), tree)


def to_device(tree: Any, device) -> Any:
    """Every leaf of ``tree`` on ``device``."""
    return _map_state(lambda x: x.to(device), tree)


def offload_state(state: step_mod.TrainState) -> step_mod.TrainState:
    """``state`` with its optimizer moments in pinned host memory."""
    return state._replace(opt_state=to_host(state.opt_state))


def supports_in_step_offload(device=None) -> bool:
    """Whether the in-step variant can run: only on a CUDA device (its side
    streams and events), so False on the CPU, as the JAX package's probe
    is on its CPU backend. ``device`` None asks about the card."""
    if not torch.cuda.is_available():
        return False
    return device is None or torch.device(device).type == "cuda"


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size()
               for x in optim.tree_leaves(tree))


@torch.no_grad()
def streamed_adamw_update(grads, state: optim.AdamState, params, cfg,
                          schedule, moved=None):
    """``optim.adamw_update`` on host-resident moments, each leaf's moments
    brought to the card just ahead of its update and written back after it
    (the in-step variant). Returns (new params, the state with its pinned
    buffers updated in place). ``moved``: a dict whose "to_device" and
    "to_host" byte counts grow by what this call copies."""
    grads = optim.clip_grads(grads, cfg)
    count, lr = state.count + 1, schedule(state.count)
    g_l, m_l, v_l, p_l = (optim.tree_leaves(t)
                          for t in (grads, state.mu, state.nu, params))
    dev = p_l[0].device
    compute = torch.cuda.current_stream(dev)
    up, down = torch.cuda.Stream(dev), torch.cuda.Stream(dev)

    def fetch(i):
        with torch.cuda.stream(up):
            m = m_l[i].to(dev, non_blocking=True)
            v = v_l[i].to(dev, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(up)
        return m, v, ready

    new_p, ahead = [], fetch(0)
    for i in range(len(p_l)):
        m, v, ready = ahead
        if i + 1 < len(p_l):
            ahead = fetch(i + 1)
        compute.wait_event(ready)
        m.record_stream(compute)
        v.record_stream(compute)
        p, m, v = optim.adam_leaf(g_l[i], m, v, p_l[i], count, lr, cfg)
        done = torch.cuda.Event()
        done.record(compute)
        down.wait_event(done)
        with torch.cuda.stream(down):
            m_l[i].copy_(m, non_blocking=True)
            v_l[i].copy_(v, non_blocking=True)
        m.record_stream(down)
        v.record_stream(down)
        new_p.append(p)
    written = torch.cuda.Event()
    written.record(down)
    written.synchronize()
    if moved is not None:
        n = _nbytes(state.mu) + _nbytes(state.nu)
        moved["to_device"] += n
        moved["to_host"] += n
    return optim.tree_unflatten(params, new_p), optim.AdamState(
        count=count, mu=state.mu, nu=state.nu)


def make_offload_train_step(cfg, optim_cfg, schedule, *,
                            accum_steps: int = 1, attn_impl=None,
                            in_step: Optional[bool] = None,
                            chunked_loss: bool = False, loss_chunk=None,
                            remat_group: int = 1):
    """``step.train_step`` (same arguments) for a state whose moments are
    host-resident (``offload_state``): the in-step variant where
    ``supports_in_step_offload`` holds for the trainables' device (or
    ``in_step``), else the boundary variant. The returned function's
    ``moved`` dict counts the bytes its calls copied to the device and to
    the host."""
    base = functools.partial(step_mod.train_step, cfg=cfg,
                             optim_cfg=optim_cfg, schedule=schedule,
                             accum_steps=accum_steps, attn_impl=attn_impl,
                             chunked_loss=chunked_loss,
                             loss_chunk=loss_chunk, remat_group=remat_group)
    moved = {"to_device": 0, "to_host": 0}

    def run(state, frozen, batch):
        device = optim.tree_leaves(state.trainable)[0].device
        use = supports_in_step_offload(device) if in_step is None \
            else in_step
        if use:
            return base(state, frozen, batch, update=functools.partial(
                streamed_adamw_update, moved=moved))
        n = _nbytes(state.opt_state.mu) + _nbytes(state.opt_state.nu)
        state = state._replace(opt_state=to_device(state.opt_state, device))
        state, metrics = base(state, frozen, batch)
        moved["to_device"] += n
        moved["to_host"] += n
        return offload_state(state), metrics

    run.moved = moved
    return run
