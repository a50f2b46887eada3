"""Forced garbage-collection policies (the port of the JAX package's
``gc.py``).

Mirrors ``src/emqx_gc.erl`` (per connection: force a collection after
N messages / M bytes handled, driven from the connection loop at
src/emqx_connection.erl:650-655) and ``src/emqx_global_gc.erl``
(a periodic whole-VM collect). Python has one shared heap, so the
per-connection trigger counts per-transport work but runs the same
``gc.collect``: it bounds the drift between traffic bursts and
collection points instead of letting the allocator decide mid-burst.

:attr:`GcPolicy.forced` counts the collections every policy of the
process forced, so a run can read them after its connections closed.
"""

from __future__ import annotations

import asyncio
import gc as _gc
import logging
from typing import Optional

log = logging.getLogger("emqx_tpu_torch.gc")


class GcPolicy:
    """Count/bytes-triggered collection (emqx_gc:run/3; defaults from
    etc/emqx.conf force_gc_policy 16000|16MB)."""

    #: collections forced by every policy of the process (connections
    #: run on the event loop: a single writer)
    forced = 0

    def __init__(self, count: int = 16000,
                 bytes_: int = 16 * 1024 * 1024) -> None:
        self.count_limit = count
        self.bytes_limit = bytes_
        self._cnt = 0
        self._oct = 0
        self.collections = 0

    def inc(self, cnt: int = 1, oct: int = 0) -> bool:
        """Record work; returns True when a collection ran."""
        self._cnt += cnt
        self._oct += oct
        if self._cnt >= self.count_limit or self._oct >= self.bytes_limit:
            self.reset()
            self.collections += 1
            GcPolicy.forced += 1
            _gc.collect(0)  # young generation: cheap, frequent
            return True
        return False

    def reset(self) -> None:
        self._cnt = 0
        self._oct = 0


class GlobalGc:
    """Periodic full collection (emqx_global_gc: run_gc every 15 min by
    default; ``interval=None`` disables it)."""

    def __init__(self, interval: Optional[float] = 15 * 60.0) -> None:
        self.interval = interval
        self.runs = 0

    def run_gc(self) -> int:
        self.runs += 1
        return _gc.collect()

    async def run(self) -> None:
        if self.interval is None:
            return
        while True:
            await asyncio.sleep(self.interval)
            freed = self.run_gc()
            log.debug("global gc: %d objects collected", freed)
