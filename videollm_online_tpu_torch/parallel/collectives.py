"""The collectives of the parallel paths, differentiable, in one place.

GSPMD inserted the JAX package's collectives from its ``NamedSharding``s
and ``shard_map`` bodies supplied the rest (``ppermute`` in
``ops/ring_attention.py``, ``all_to_all`` in ``ops/ulysses_attention.py``);
here each is an explicit ``torch.distributed`` call over one axis of a
``parallel.mesh.Mesh``, wrapped in a ``torch.autograd.Function`` whose
backward is the collective's transpose:

  * ``all_reduce`` (sum) -- backward: all-reduce;
  * ``all_gather`` along a dim -- backward: reduce-scatter along it;
  * ``all_to_all`` (split one dim, concat another) -- backward: the reverse
    all-to-all;
  * ``ring_shift`` (send to the next rank on the axis, receive from the
    previous, ``batch_isend_irecv``) -- backward: the reverse shift.

With transposes as backwards, autograd on each rank gives the gradient of
the SUM over ranks of what the ranks compute. The training loss is
written so that this sum is the true loss (``models/live.py``: each rank
scores its share over the global label count), and the gradient of a
replicated leaf is then the sum of the ranks' gradients over the whole
mesh (``reduce_grads``). Megatron's f/g pair (an identity whose backward
all-reduces) is the same computation with the 1/N of a replicated region
folded into the operator instead of the loss.

Every collective over an axis of size 1 is skipped. Every call counts
into ``STATS`` (calls and the bytes this rank hands to the collective,
by kind), which ``chip_smoke.py`` reads per forward. On a ``gloo`` mesh
whose tensors are on a card, a collective copies its operand through a
pinned host buffer and its result back (``Mesh.host_staging``).
"""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh

STATS = {"calls": collections.Counter(), "bytes": collections.Counter()}


def reset_stats() -> None:
    STATS["calls"].clear()
    STATS["bytes"].clear()


def _count(kind: str, x: torch.Tensor) -> None:
    STATS["calls"][kind] += 1
    STATS["bytes"][kind] += x.numel() * x.element_size()


def _host(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The tensor the backend takes: a pinned host copy on a staging mesh."""
    x = x.contiguous()
    if mesh.host_staging and x.is_cuda:
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        return h
    return x


def _back(mesh: Mesh, h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return h.to(like.device) if h.device != like.device else h


def _empty(mesh: Mesh, shape, like: torch.Tensor) -> torch.Tensor:
    if mesh.host_staging and like.is_cuda:
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


# ------------------------------------------------------- raw collectives
def _all_reduce(x, mesh: Mesh, axis: Optional[str]):
    _count("all_reduce", x)
    h = _host(mesh, x)
    if h is x:
        h = x.clone()
    dist.all_reduce(h, group=mesh.group(axis))
    return _back(mesh, h, x)


def _all_gather(x, mesh: Mesh, axis: str, dim: int):
    _count("all_gather", x)
    n = mesh.shape[axis]
    h = _host(mesh, x)
    parts = [_empty(mesh, h.shape, x) for _ in range(n)]
    dist.all_gather(parts, h, group=mesh.group(axis))
    return _back(mesh, torch.cat(parts, dim=dim), x)


def _reduce_scatter(x, mesh: Mesh, axis: str, dim: int):
    # gloo has no reduce-scatter: all-reduce, then this rank's slice
    n, i = mesh.shape[axis], mesh.coord(axis)
    full = _all_reduce(x, mesh, axis)
    size = x.shape[dim] // n
    return full.narrow(dim, i * size, size).contiguous()


def _all_to_all(x, mesh: Mesh, axis: str, split_dim: int, concat_dim: int):
    _count("all_to_all", x)
    n = mesh.shape[axis]
    split_dim %= x.ndim
    concat_dim %= x.ndim
    assert x.shape[split_dim] % n == 0, (x.shape, split_dim, n)
    # chunk j (along split_dim) goes to rank j: lay the chunks out first
    chunks = x.movedim(split_dim, 0).reshape(
        (n, x.shape[split_dim] // n) + tuple(
            s for d, s in enumerate(x.shape) if d != split_dim))
    h = _host(mesh, chunks)
    out = _empty(mesh, h.shape, x)
    dist.all_to_all_single(out, h, group=mesh.group(axis))
    out = _back(mesh, out, x)
    # out[i] is rank i's chunk for this rank, in split-dim-first layout
    parts = [out[i].movedim(0, split_dim) for i in range(n)]
    return torch.cat(parts, dim=concat_dim)


def _ring_shift(x, mesh: Mesh, axis: str, shift: int):
    _count("ring_shift", x)
    n, i = mesh.shape[axis], mesh.coord(axis)
    group = mesh.group(axis)
    dst = dist.get_global_rank(group, (i + shift) % n)
    src = dist.get_global_rank(group, (i - shift) % n)
    h = _host(mesh, x)
    out = _empty(mesh, h.shape, x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, h, dst, group),
        dist.P2POp(dist.irecv, out, src, group)])
    for r in reqs:
        r.wait()
    return _back(mesh, out, x)


# --------------------------------------------------- autograd functions
class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh, ctx.axis, ctx.dim), None, None, \
            None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return _all_to_all(x, mesh, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return (_all_to_all(g, mesh, axis, concat_dim, split_dim),
                None, None, None, None)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.args = (mesh, axis, shift)
        return _ring_shift(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, shift = ctx.args
        return _ring_shift(g, mesh, axis, -shift), None, None, None


# ----------------------------------------------------------- public API
def all_reduce(x: torch.Tensor, mesh: Optional[Mesh],
               axis: Optional[str]) -> torch.Tensor:
    """Sum over ``axis`` (None: the whole mesh)."""
    if mesh is None or (mesh.size if axis is None else mesh.shape[axis]) == 1:
        return x
    return _AllReduce.apply(x, mesh, axis)


def all_gather(x: torch.Tensor, mesh: Optional[Mesh], axis: str,
               dim: int) -> torch.Tensor:
    """Concatenate the ranks' ``x`` along ``dim`` in axis order."""
    if mesh is None or mesh.shape[axis] == 1:
        return x
    return _AllGather.apply(x, mesh, axis, dim % x.ndim)


def all_to_all(x: torch.Tensor, mesh: Optional[Mesh], axis: str,
               split_dim: int, concat_dim: int) -> torch.Tensor:
    """Split ``x`` into axis-size chunks along ``split_dim``, send chunk j
    to rank j, and concatenate what arrives along ``concat_dim`` in rank
    order (``lax.all_to_all(..., tiled=True)``)."""
    if mesh is None or mesh.shape[axis] == 1:
        return x
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


def ring_shift(x: torch.Tensor, mesh: Optional[Mesh], axis: str,
               shift: int = 1) -> torch.Tensor:
    """Rank i's ``x`` arrives at rank i + shift (mod the axis size)."""
    if mesh is None or mesh.shape[axis] == 1:
        return x
    return _RingShift.apply(x, mesh, axis, shift)


def reduce_grads(grads: Sequence[torch.Tensor], mesh: Optional[Mesh]
                 ) -> List[torch.Tensor]:
    """Sum each gradient over the whole mesh, in one flat buffer per
    dtype (no autograd)."""
    grads = list(grads)
    if mesh is None or mesh.size == 1:
        return grads
    out = list(grads)
    by_dtype = collections.defaultdict(list)
    for i, g in enumerate(grads):
        by_dtype[g.dtype].append(i)
    for idx in by_dtype.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        flat = _all_reduce(flat, mesh, None)
        off = 0
        for i in idx:
            n = grads[i].numel()
            out[i] = flat[off:off + n].view_as(grads[i])
            off += n
    return out


def all_gather_object(obj) -> list:
    """Every rank's ``obj`` (a picklable host object), in rank order, over
    the initialised world (``[obj]`` without one)."""
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return [obj]
    STATS["calls"]["all_gather_object"] += 1
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def all_gather_list(x: torch.Tensor, mesh: Mesh, axis: str
                    ) -> List[torch.Tensor]:
    """Every rank's ``x`` on ``axis`` (equal shapes), in axis order, with
    no autograd: the per-layer gather of frozen weight shards."""
    if mesh is None or mesh.shape[axis] == 1:
        return [x]
    _count("all_gather", x)
    h = _host(mesh, x)
    parts = [_empty(mesh, h.shape, x) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, h, group=mesh.group(axis))
    return [_back(mesh, p, x) for p in parts]
