"""Run a function in every rank of a small ``gloo`` world on the CPU.

``run_world(fn, world_size, tmp_path, *args)`` starts ``world_size``
processes (spawned, so each is a fresh interpreter), joins them into one
``torch.distributed`` group over a ``file://`` store under ``tmp_path``
(no TCP port to collide between parallel test workers), calls
``fn(rank, world_size, *args)`` in each and returns the ranks' results in
rank order. ``start_worlds`` starts several worlds at once and returns a
function that waits for their results, so the test process can compute
its references meanwhile. ``fn`` must live in a module that imports no
JAX (the workers import torch, numpy and the port only). A collective that hangs fails the
call after ``timeout`` seconds: the group's own timeout ends the ranks,
and the join kills what is left.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import traceback

DEFAULT_TIMEOUT = 120.0


def _worker(rank, world, store, fn, args, out_path, timeout):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        result = ("ok", fn(rank, world, *args))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the test
        result = ("error", traceback.format_exc())
    with open(out_path, "wb") as f:
        pickle.dump(result, f)


def _start(fn, world_size, tmp, args, timeout, index):
    ctx = mp.get_context("spawn")
    tag = f"{fn.__name__}_{world_size}_{index}"
    store = os.path.join(tmp, f"store_{tag}")
    outs = [os.path.join(tmp, f"out_{tag}_{r}.pkl")
            for r in range(world_size)]
    procs = [ctx.Process(target=_worker,
                         args=(r, world_size, store, fn, args, outs[r],
                               timeout))
             for r in range(world_size)]
    for p in procs:
        p.start()
    return fn.__name__, procs, outs


def _collect(name, procs, outs, timeout):
    for p in procs:
        p.join(timeout + 30)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        raise TimeoutError(f"ranks {hung} of {name} did not finish")
    results = []
    for r, path in enumerate(outs):
        if not os.path.exists(path):
            raise RuntimeError(f"rank {r} of {name} died (exit "
                               f"{procs[r].exitcode})")
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise RuntimeError(f"rank {r} of {name} failed:\n{value}")
        results.append(value)
    return results


def start_worlds(jobs, tmp_path, timeout: float = DEFAULT_TIMEOUT):
    """Start several worlds at once: ``jobs`` is a list of (fn, world
    size, args). Returns a function that waits for them and returns each
    world's results (ranks in order), in job order."""
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    started = [_start(fn, n, tmp, tuple(args), timeout, i)
               for i, (fn, n, args) in enumerate(jobs)]
    return lambda: [_collect(*s, timeout) for s in started]


def run_world(fn, world_size: int, tmp_path, *args,
              timeout: float = DEFAULT_TIMEOUT):
    return start_worlds([(fn, world_size, args)], tmp_path, timeout)()[0]
