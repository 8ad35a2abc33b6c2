"""A small data loader: shuffling, batching, collation and an ordered
thread pool.

A copy of ``videollm_online_tpu/data/loader.py``: the same seed gives the
same batch order as the JAX package's loader, with any number of workers
(batches are yielded strictly in index order). ``__getitem__`` here is numpy
slicing and string rendering, so threads suffice.
"""

from __future__ import annotations

import queue
import random
import threading
from typing import Callable, Iterator


class DataLoader:
    def __init__(self, dataset, *, batch_size: int, collate_fn: Callable,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 num_workers: int = 0, prefetch: int = 4,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset) // self.process_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self):
        idxs = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idxs)
        if self.process_count > 1:
            # same seed everywhere, disjoint stripes per process
            idxs = idxs[self.process_index::self.process_count]
        for i in range(0, len(idxs), self.batch_size):
            chunk = idxs[i:i + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
                return
            yield chunk

    def __iter__(self) -> Iterator:
        if self.num_workers <= 0:
            for chunk in self._index_batches():
                yield self.collate_fn([self.dataset[j] for j in chunk])
            self.epoch += 1
            return
        work: "queue.Queue" = queue.Queue()
        done: dict = {}
        done_cv = threading.Condition(threading.Lock())
        n_batches = 0
        for seq, chunk in enumerate(self._index_batches()):
            work.put((seq, chunk))
            n_batches += 1
        # bound in-flight results so fast workers don't buffer the epoch
        window = max(self.prefetch, self.num_workers)
        next_out = [0]

        def worker():
            while True:
                try:
                    seq, chunk = work.get_nowait()
                except queue.Empty:
                    return
                try:
                    batch = self.collate_fn([self.dataset[j] for j in chunk])
                    err = None
                except Exception as e:  # raised again on the consumer side
                    batch, err = None, e
                with done_cv:
                    while seq - next_out[0] >= window and err is None:
                        done_cv.wait(timeout=0.1)
                    done[seq] = (batch, err)
                    done_cv.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        for seq in range(n_batches):
            with done_cv:
                while seq not in done:
                    done_cv.wait(timeout=0.1)
                batch, err = done.pop(seq)
                next_out[0] = seq + 1
                done_cv.notify_all()
            if err is not None:
                raise err
            yield batch
        self.epoch += 1
