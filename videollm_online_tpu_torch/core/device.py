"""Device selection for the port's entry points, and host-device transfers
that do not make the host wait for the card."""

from __future__ import annotations

import time
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card. There is no silent CPU fallback: without a
    CUDA device the caller has to ask for ``device="cpu"`` explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string ("bfloat16", "float32", ...) -> torch dtype."""
    return getattr(torch, name)


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``. A CPU tensor bound for a CUDA device is staged
    through pinned memory and copied with ``non_blocking=True``: a copy
    from pageable memory makes the host wait until the card's queue has
    drained, which would stall work dispatched ahead of its readback."""
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    # contiguous first: pinning keeps strides, and an expanded view's
    # overlapping elements cannot be written
    return t.contiguous().pin_memory().to(device, non_blocking=True)


class DeferredRead:
    """A small device result on its way to the host: copied, behind the
    work that makes it, into a pinned buffer of its own with
    ``non_blocking=True``, and an event recorded after the copy. ``read()``
    waits on that event alone and returns the host tensor; ``wait_s`` is
    how long it waited. Two reads in flight never share a buffer. A CPU
    tensor is read as it is."""

    def __init__(self, t: torch.Tensor):
        self.wait_s = 0.0
        self._event = None
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t.detach().clone()

    def read(self) -> torch.Tensor:
        if self._event is not None:
            t0 = time.perf_counter()
            self._event.synchronize()
            self.wait_s = time.perf_counter() - t0
            self._event = None
        return self._host
