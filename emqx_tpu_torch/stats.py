"""Gauge statistics with max-watermarks and registered update
functions (reference: src/emqx_stats.erl — subsystems register update
funs that run on the stats tick, e.g. src/emqx_broker_helper.erl:118).

Only the broker-core gauges are preset; any other key is created by
its first :meth:`Stats.setstat`.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List

log = logging.getLogger("emqx_tpu_torch.stats")

STATS_KEYS = [
    "connections.count", "connections.max",
    "sessions.count", "sessions.max",
    "topics.count", "topics.max",
    "suboptions.count", "suboptions.max",
    "subscribers.count", "subscribers.max",
    "subscriptions.count", "subscriptions.max",
    "subscriptions.shared.count", "subscriptions.shared.max",
    "routes.count", "routes.max",
    "retained.count", "retained.max",
    "channels.count", "channels.max",
    # the durability layer: the current journal segment's size, the
    # committed checkpoint generation and the seconds since the last
    # committed checkpoint (an ever-growing age with a non-empty
    # journal means checkpoints are failing — see checkpoint_failed)
    "journal.bytes", "journal.records",
    "durability.generation", "checkpoint.age_s",
]


class Stats:
    def __init__(self) -> None:
        self._vals: Dict[str, int] = {k: 0 for k in STATS_KEYS}
        self._update_funs: List[Callable[["Stats"], None]] = []

    def setstat(self, key: str, value: int, max_key: str = "") -> None:
        self._vals[key] = value
        if max_key:
            if value > self._vals.get(max_key, 0):
                self._vals[max_key] = value

    def getstat(self, key: str) -> int:
        return self._vals.get(key, 0)

    def register_update(self, fn: Callable[["Stats"], None]) -> None:
        self._update_funs.append(fn)

    def tick(self) -> None:
        """Run every registered update fun; one that raises is logged
        and the others still run."""
        for fn in list(self._update_funs):
            try:
                fn(self)
            except Exception:
                log.exception("stats update %r failed", fn)
