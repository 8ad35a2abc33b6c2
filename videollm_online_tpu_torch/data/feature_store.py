"""Feature file access for pre-extracted frame embeddings.

The reference stores one bf16 torch tensor per video
(``torch.save``; data/utils.py:86-104) and slices it per sample with
``torch.load(path)[range]`` (data/stream.py:91). Here ``.npy`` is the native
format — memory-mapped, so a range slice reads only the needed frames from
disk (a big win for 16-worker dataloading) — with ``.pt`` still accepted for
drop-in compatibility with reference-extracted features. A small LRU keeps
hot .pt files decoded.

A copy of ``videollm_online_tpu/data/feature_store.py``: the port imports
nothing of the JAX package, so it keeps its own."""

from __future__ import annotations

import functools
from typing import Union

import numpy as np


@functools.lru_cache(maxsize=64)
def _load_pt(path: str) -> np.ndarray:
    import torch
    t = torch.load(path, weights_only=True, map_location="cpu")
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def load_feature_file(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path, mmap_mode="r")
    if path.endswith(".pt"):
        return _load_pt(path)
    raise ValueError(f"unsupported feature file: {path}")


def load_feature_range(path: str, ranger: Union[range, slice]) -> np.ndarray:
    arr = load_feature_file(path)
    out = arr[ranger.start:ranger.stop]
    return np.asarray(out, dtype=np.float32)


def feature_len(path: str) -> int:
    if path.endswith(".npy"):
        return np.load(path, mmap_mode="r").shape[0]
    return _load_pt(path).shape[0]
