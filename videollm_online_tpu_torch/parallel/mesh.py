"""The (data, model) process mesh over ``torch.distributed``.

Counterpart of ``videollm_online_tpu/parallel/mesh.py``. The JAX package
names the parallelism with a ``jax.sharding.Mesh`` and lets GSPMD insert
the collectives; here every rank is one process, the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` of shape (data, model) over
the initialised world, and the collectives are explicit calls
(``parallel/collectives.py``).

Axes:
  * ``data``  -- data parallel (and, under ``fsdp_tp``, the frozen base
                 sharded over it: the ZeRO-3 analogue);
  * ``model`` -- tensor parallel (Megatron sharding of heads and the MLP),
                 or, with a sequence-parallel attention, the sequence.

``maybe_mesh(mesh)`` makes ``mesh`` the one the decoder's forward reads
(``current_mesh``), as ``with mesh:`` does for the JAX package.

The backend follows one rule, decided before the group is made and
returned by ``initialize_distributed``: ``nccl`` when every rank has a
card of its own; ``gloo`` otherwise (ranks on the CPU, or several ranks
sharing one card, which NCCL refuses). A mesh over a ``gloo`` world whose
tensors live on a card copies them through pinned host buffers inside the
collectives (``Mesh.host_staging``); the compute stays on the card.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)
DEFAULT_TIMEOUT_S = 600.0


class Mesh:
    """A (data, model) grid of ranks. ``shape`` maps an axis name to its
    size, as a JAX mesh's does; ``coord(axis)`` is this rank's index on an
    axis and ``group(axis)`` the process group of the ranks that differ
    from this one only on it. A mesh of one rank needs no process group
    (``device_mesh`` None) and every collective over it is skipped."""

    def __init__(self, device_mesh, shape: Dict[str, int], device,
                 backend: Optional[str]):
        self.device_mesh = device_mesh
        self.shape = dict(shape)
        self.device = torch.device(device)
        self.backend = backend
        self.host_staging = backend == "gloo" and self.device.type == "cuda"

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    def coord(self, axis: str) -> int:
        if self.shape[axis] == 1:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: Optional[str] = None):
        """The group of ``axis``; ``None`` is the group of the whole mesh."""
        if axis is None:
            return dist.group.WORLD
        return self.device_mesh.get_group(axis)

    def __repr__(self):
        return (f"Mesh(data={self.shape[DATA_AXIS]}, "
                f"model={self.shape[MODEL_AXIS]}, device={self.device}, "
                f"backend={self.backend})")


def choose_backend(world_size: int, device) -> str:
    """``nccl`` when the ranks run on cards and each has one of its own,
    else ``gloo`` (the CPU, or ranks that share a card)."""
    device = torch.device(device)
    if device.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def make_mesh(data: int = -1, model: int = 1, *,
              devices: Optional[Sequence[int]] = None, device=None) -> Mesh:
    """Build a (data, model) mesh over the ranks of the initialised world
    (``devices``: the ranks in mesh order, all of the world's; default
    0..world-1). ``data=-1`` means "all remaining ranks". ``device`` is
    where the mesh's tensors live: the card unless the caller asks for the
    CPU."""
    device = resolve_device(device)
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    ranks = list(devices) if devices is not None else list(range(world))
    n = len(ranks)
    if data == -1:
        assert n % model == 0, f"{n} devices not divisible by model={model}"
        data = n // model
    assert data * model == n, f"mesh {data}x{model} != {n} devices"
    assert sorted(ranks) == list(range(world)), (
        f"a mesh spans the whole world of {world} ranks, got {ranks}")
    shape = {DATA_AXIS: data, MODEL_AXIS: model}
    if n == 1:
        return Mesh(None, shape, device, dist.get_backend() if initialized
                    else None)
    from torch.distributed.device_mesh import DeviceMesh
    backend = dist.get_backend()
    # the mesh's groups are made on the world's backend; a gloo world keeps
    # them on the host whatever device the tensors live on
    dm_type = "cuda" if backend == "nccl" else "cpu"
    dm = DeviceMesh(dm_type, torch.tensor(ranks).reshape(data, model),
                    mesh_dim_names=AXES)
    return Mesh(dm, shape, device, backend)


def single_device_mesh(device=None) -> Mesh:
    return Mesh(None, {DATA_AXIS: 1, MODEL_AXIS: 1}, resolve_device(device),
                None)


_CURRENT: Optional[Mesh] = None


def current_mesh() -> Optional[Mesh]:
    """The mesh set by the innermost ``maybe_mesh``, or None."""
    return _CURRENT


@contextlib.contextmanager
def maybe_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the current mesh for the block (None: leave it)."""
    global _CURRENT
    if mesh is None:
        yield
        return
    prev, _CURRENT = _CURRENT, mesh
    try:
        yield
    finally:
        _CURRENT = prev


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *,
                           device=None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> str:
    """Join the process group and return its backend.

    With no arguments the rendezvous is torchrun's environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``), the counterpart of the JAX package's
    ``jax.distributed.initialize()``; otherwise ``coordinator_address``
    (``host:port``, or a URL such as ``tcp://...`` or ``file://...``) with
    ``num_processes`` and ``process_id``. ``device``: the card unless the
    caller asks for the CPU; with ``nccl`` each rank takes the card of its
    local rank."""
    device = resolve_device(device)
    if coordinator_address is None:
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank = int(num_processes), int(process_id)
    backend = choose_backend(world, device)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return backend
