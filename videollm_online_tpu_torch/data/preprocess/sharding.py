"""Task sharding for offline preprocessing jobs.

The reference shards work over SLURM tasks via submitit's JobEnvironment
(``i % num_tasks == global_rank``; data/utils.py:80-81,93-94). Same contract
here, submitit-compatible but also driven by plain env vars so the jobs run
on plain workers / indexed jobs without SLURM:
  VLO_NUM_TASKS / VLO_TASK_RANK  (fallbacks: SLURM_NTASKS/SLURM_PROCID,
  submitit's JobEnvironment when importable).

A copy of ``videollm_online_tpu/data/preprocess/sharding.py``."""

from __future__ import annotations

import os
from typing import Iterable, Iterator, Tuple, TypeVar

T = TypeVar("T")


def task_env() -> Tuple[int, int]:
    """(num_tasks, rank)."""
    for nk, rk in (("VLO_NUM_TASKS", "VLO_TASK_RANK"),
                   ("SLURM_NTASKS", "SLURM_PROCID")):
        if os.environ.get(nk):
            return int(os.environ[nk]), int(os.environ.get(rk, 0))
    try:
        import submitit
        env = submitit.JobEnvironment()
        return env.num_tasks, env.global_rank
    except Exception:
        return 1, 0


def shard(items: Iterable[T]) -> Iterator[Tuple[int, T]]:
    """Yield (index, item) owned by this task."""
    num_tasks, rank = task_env()
    for i, item in enumerate(items):
        if i % num_tasks == rank:
            yield i, item
