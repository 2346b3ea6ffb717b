"""Data loading: threaded prefetch over the host pipeline (counterpart of
``detmatch_tpu/data/loader.py``, the same index stream for the same seed).

A background thread draws batch indices, maps ``dataset[i]`` over a pool
of worker threads and queues the collated numpy batches; the train loop
moves them to the device. The pipelines of one dataset share one
``RandomState`` across the worker threads (``apis/build.py``), so the
augmentations a sample gets depend on the threads' interleaving: two runs
with one seed see the same indices, not the same augmented samples.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np


class Loader:
    """Infinite shuffling loader with background prefetch. An exception
    raised while loading a batch is raised again from the iterator."""

    def __init__(self, dataset, batch_size, collate_fn,
                 shuffle=True, seed=0, num_workers=4, prefetch=2,
                 drop_last=True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate = collate_fn
        self.shuffle = shuffle
        self.rng = np.random.RandomState(seed)
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _index_stream(self):
        n = len(self.dataset)
        if n == 0:
            raise ValueError("Loader: empty dataset")
        while True:
            order = self.rng.permutation(n) if self.shuffle else np.arange(n)
            if n < self.batch_size:
                # As the JAX package: a dataset smaller than the batch is
                # tiled with fresh permutations, whatever drop_last says,
                # and the permutation drawn above goes unused (ADVICE.md,
                # loader.py:52). Kept so that the index stream, and so the
                # random draws of every later epoch, equal the JAX
                # package's; without tiling, drop_last would make no batch
                # at all.
                reps = -(-self.batch_size // n)
                order = np.concatenate([
                    self.rng.permutation(n) if self.shuffle
                    else np.arange(n) for _ in range(reps)])
                yield order[:self.batch_size]
                continue
            for i in range(0, n - (self.batch_size - 1 if self.drop_last
                                   else 0), self.batch_size):
                yield order[i:i + self.batch_size]

    def _worker(self):
        try:
            with ThreadPoolExecutor(self.num_workers) as pool:
                for idxs in self._index_stream():
                    if self._stop.is_set():
                        return
                    samples = list(pool.map(self.dataset.__getitem__, idxs))
                    self._q.put(self.collate(samples))
        except Exception as e:  # handed to the consumer, raised there
            self._q.put(e)

    def __iter__(self) -> Iterator:
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker,
                                            daemon=True)
            self._thread.start()
        while True:
            item = self._q.get()
            if isinstance(item, Exception):
                raise item
            yield item

    def stop(self, timeout=60.0):
        """Stop the prefetch thread: drop the queued batches so that a
        blocked ``put`` returns, and wait for the thread to end."""
        self._stop.set()
        if self._thread is None:
            return
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.1)
            except queue.Empty:
                pass
            self._thread.join(timeout=0.1)
            timeout -= 0.2
            if timeout <= 0:
                raise TimeoutError("Loader: the prefetch thread did not stop")


def epoch_batches(dataset, batch_size, collate_fn):
    """Single ordered pass (evaluation); last short batch is padded by
    repeating the final sample (callers mask by true count)."""
    n = len(dataset)
    for i in range(0, n, batch_size):
        idxs = list(range(i, min(i + batch_size, n)))
        true = len(idxs)
        while len(idxs) < batch_size:
            idxs.append(idxs[-1])
        yield collate_fn([dataset[j] for j in idxs]), true
