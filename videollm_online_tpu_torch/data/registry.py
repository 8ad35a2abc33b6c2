"""Dataset registry + concat/eval-dict builders.

Equivalent of reference data/__init__.py:10-49: datasets are looked up by
``build_{name}`` in a registry; train datasets concatenate; eval datasets
form a name->dataset dict with per-dataset compute_metrics bindings.

A copy of ``videollm_online_tpu/data/registry.py``: the port imports nothing
of the JAX package, so it keeps its own."""

from __future__ import annotations

import bisect
import functools
import itertools
from typing import Callable, Dict, List, Optional, Sequence

from .coin import benchmarks as coin_benchmarks
from .ego4d import livechat, lta, narration, nlq
from . import robustness

_REGISTRY: Dict[str, Callable] = {}
for module in (narration, livechat, lta, nlq, coin_benchmarks, robustness):
    for name in dir(module):
        if name.startswith("build_"):
            _REGISTRY[name.removeprefix("build_")] = getattr(module, name)


def register_dataset(name: str, builder: Callable) -> None:
    _REGISTRY[name] = builder


def available_datasets() -> List[str]:
    return sorted(_REGISTRY)


class ConcatDataset:
    """Minimal torch-free ConcatDataset."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.cum = list(itertools.accumulate(len(d) for d in self.datasets))

    def __len__(self):
        return self.cum[-1] if self.cum else 0

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        d = bisect.bisect_right(self.cum, idx)
        prev = self.cum[d - 1] if d else 0
        return self.datasets[d][idx - prev]


def _build_list(datasets: Sequence[str], is_training: bool, **kwargs):
    unknown = [n for n in datasets if n not in _REGISTRY]
    if unknown:
        raise KeyError(f"unknown dataset(s) {unknown}; available: "
                       f"{available_datasets()}")
    return [_REGISTRY[name](is_training=is_training, **kwargs)
            for name in datasets]


def build_concat_train_dataset(train_datasets: Optional[Sequence[str]],
                               is_training: bool = True, **kwargs):
    if not train_datasets:
        return None
    return ConcatDataset(_build_list(train_datasets, is_training, **kwargs))


def build_eval_dataset_dict(eval_datasets: Optional[Sequence[str]],
                            is_training: bool = False, **kwargs):
    if not eval_datasets:
        return None
    built = _build_list(eval_datasets, is_training, **kwargs)
    return dict(zip(eval_datasets, built))


def get_compute_metrics_dict(dataset_dict: Optional[dict], **kwargs):
    if not dataset_dict:
        return None
    return {k: functools.partial(v.compute_metrics, **kwargs)
            for k, v in dataset_dict.items()}
