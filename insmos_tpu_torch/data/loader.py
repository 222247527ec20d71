"""Parallel, cached host input pipeline (the port's own copy of
``insmos_tpu/data/loader.py``).

- ``ScanCache``: a thread-safe LRU over raw file reads. Consecutive
  sliding-window samples share 9 of 10 scans and their label files, so
  caching the raw arrays turns most reads into memory copies; ``get``
  returns a copy, which the dataset pose-aligns in place.
- ``iter_batches``: a thread pool that keeps ``prefetch_batches`` batches in
  flight while the device steps, with per-sample parallelism inside each
  batch. numpy IO releases the GIL, so threads suffice and share the cache.
- ``prefetch_map`` / ``iter_samples``: ordered per-item prefetch (the
  predict CLI's scan reads, a dataset's samples).
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np

from .sample import WindowSample, stack_samples


class ScanCache:
    """Thread-safe LRU keyed by (path, kind) holding raw numpy arrays.

    ``max_bytes`` bounds resident size (default 512 MB ≈ 250 raw scans).
    ``get`` returns a COPY so callers may mutate (the dataset pose-aligns
    points in place).
    """

    def __init__(self, max_bytes: int = 512 * 1024 * 1024):
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._data: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, key: tuple, load: Callable[[], np.ndarray]) -> np.ndarray:
        with self._lock:
            arr = self._data.get(key)
            if arr is not None:
                self._data.move_to_end(key)
                self.hits += 1
                return arr.copy()
        arr = load()
        with self._lock:
            self.misses += 1
            if key not in self._data:
                self._data[key] = arr
                self._bytes += arr.nbytes
                while self._bytes > self.max_bytes and len(self._data) > 1:
                    _, old = self._data.popitem(last=False)
                    self._bytes -= old.nbytes
        return arr.copy()

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "entries": len(self._data),
                "bytes": self._bytes,
            }


def iter_batches(ds, batch_size: int, shuffle: bool, seed: int = 0,
                 num_workers: int = 4, prefetch_batches: int = 2,
                 drop_last: bool = True) -> Iterator[dict]:
    """Yield stacked batches with background loading. The order (a
    permutation from ``seed`` when ``shuffle``) and the contents are those
    of the sequential loop; ``num_workers <= 0`` loads synchronously."""
    order = np.arange(len(ds))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    end = len(order) - batch_size + 1 if drop_last else len(order)
    batch_idx = [order[i:i + batch_size] for i in range(0, end, batch_size)]

    if num_workers <= 0:
        for b in batch_idx:
            yield stack_samples([ds[int(j)] for j in b])
        return

    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        pending: deque[list] = deque()
        it = iter(batch_idx)

        def submit_next() -> bool:
            try:
                b = next(it)
            except StopIteration:
                return False
            pending.append([ex.submit(ds.__getitem__, int(j)) for j in b])
            return True

        for _ in range(prefetch_batches + 1):
            if not submit_next():
                break
        while pending:
            futs = pending.popleft()
            samples: list[WindowSample] = [f.result() for f in futs]
            submit_next()  # keep the pipeline full before handing off
            yield stack_samples(samples)


def prefetch_map(fn, items, num_workers: int = 4, prefetch: int = 8):
    """Yield ``fn(item)`` in order with background worker threads (the
    predict CLI's scan-read prefetcher)."""
    items = list(items)
    if num_workers <= 0:
        for it in items:
            yield fn(it)
        return
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        pending: deque = deque()
        nxt = 0
        while nxt < len(items) and len(pending) <= prefetch:
            pending.append(ex.submit(fn, items[nxt]))
            nxt += 1
        while pending:
            fut = pending.popleft()
            if nxt < len(items):
                pending.append(ex.submit(fn, items[nxt]))
                nxt += 1
            yield fut.result()


def iter_samples(
    ds, num_workers: int = 4, prefetch: int = 8
) -> Iterator[WindowSample]:
    """Sequential per-sample prefetch (the predict/refine streaming shape)."""
    if num_workers <= 0:
        for i in range(len(ds)):
            yield ds[i]
        return
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        pending: deque = deque()
        nxt = 0
        n = len(ds)
        while nxt < n and len(pending) <= prefetch:
            pending.append(ex.submit(ds.__getitem__, nxt))
            nxt += 1
        while pending:
            fut = pending.popleft()
            if nxt < n:
                pending.append(ex.submit(ds.__getitem__, nxt))
                nxt += 1
            yield fut.result()
