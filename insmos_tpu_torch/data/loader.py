"""Host input prefetch for the predict CLI (the port's own copy of
``insmos_tpu/data/loader.py::prefetch_map``). numpy file reads release the
GIL, so worker threads overlap them with the device steps. The training
loader's cache and batch iterators are not carried over."""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor


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
