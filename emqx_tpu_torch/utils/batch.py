"""Generic size/interval-triggered batch accumulator and the publish
path's topic dedup (the port of the JAX package's ``utils/batch.py``).

Mirrors ``src/emqx_batch.erl``: items accumulate until either the
batch size cap or the linger interval fires, then the commit function
runs on the whole batch.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Callable, List, Optional


class Batch:
    """Synchronous accumulator: ``push`` returns the batch to commit
    when the size cap is hit; ``flush`` drains unconditionally;
    ``due(now)`` says whether the linger interval expired."""

    def __init__(self, batch_size: int = 1000,
                 linger_ms: float = 10.0,
                 commit_fun: Optional[Callable[[List[Any]], Any]] = None
                 ) -> None:
        self.batch_size = batch_size
        self.linger_ms = linger_ms
        self.commit_fun = commit_fun
        self._items: List[Any] = []
        self._first_at: Optional[float] = None

    def __len__(self) -> int:
        return len(self._items)

    def push(self, item: Any):
        if not self._items:
            self._first_at = time.monotonic()
        self._items.append(item)
        if len(self._items) >= self.batch_size:
            return self.flush()
        return None

    def due(self, now: Optional[float] = None) -> bool:
        if not self._items:
            return False
        now = time.monotonic() if now is None else now
        return (now - self._first_at) * 1000.0 >= self.linger_ms

    def flush(self):
        if not self._items:
            return None
        items, self._items = self._items, []
        self._first_at = None
        if self.commit_fun is not None:
            return self.commit_fun(items)
        return items


class AsyncBatcher:
    """asyncio wrapper: background linger timer commits partial
    batches; ``push`` commits full ones inline."""

    def __init__(self, commit_fun: Callable[[List[Any]], Any],
                 batch_size: int = 1000, linger_ms: float = 10.0) -> None:
        self.batch = Batch(batch_size, linger_ms, commit_fun)
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        if self._task is None:
            self._task = asyncio.get_event_loop().create_task(
                self._linger_loop())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
        self.batch.flush()

    def push(self, item: Any):
        return self.batch.push(item)

    async def _linger_loop(self) -> None:
        interval = max(self.batch.linger_ms / 1000.0, 0.001)
        while True:
            await asyncio.sleep(interval)
            try:
                if self.batch.due():
                    self.batch.flush()
            except Exception:
                # a transient commit failure must not kill the linger
                # task — that would silently stall partial batches
                logging.getLogger("emqx_tpu_torch.batch").exception(
                    "batch commit failed")



def dedup_topics(topics):
    """Collapse duplicate topics, first occurrence wins: returns
    ``(unique_topics, inverse_index)`` with
    ``unique_topics[inverse_index[i]] == topics[i]``. The publish
    path collapses hot topics to one device row per batch and expands
    results per message (broker.publish_begin)."""
    seen = {}
    uniq = []
    inv = []
    for t in topics:
        j = seen.get(t)
        if j is None:
            j = len(uniq)
            seen[t] = j
            uniq.append(t)
        inv.append(j)
    return uniq, inv
