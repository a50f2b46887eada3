"""Gauge statistics with max-watermarks and registered update
functions (reference: src/emqx_stats.erl — subsystems register update
funs that run on the stats tick, e.g. src/emqx_broker_helper.erl:118).

The key table is the JAX package's: every row a JAX node presets is
preset here, so ``Stats.all`` lists the same keys. The node's stats
tick (``node.py``) and the replication fold (``replication.py``) set
the same rows the JAX package sets, the cluster plane's, journal
shipping's and each loop's included; a row stays at 0 on a node
without that layer (no cluster, no standbys, one loop). Any other key
is created by its first :meth:`Stats.setstat`.
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
    # live publish match-cache entries (ops/match_cache.py)
    "match.cache.entries.count", "match.cache.entries.max",
    # partition epoch keys in effect for the match cache (0 = cache
    # off, 1 = whole-epoch, else MatcherConfig.cache_partitions)
    "match.cache.partition.live",
    # freed filter ids quarantined until the next flatten
    # (Router._pending_free); sustained growth raises the
    # router_ids_quarantined alarm from the stats tick
    "router.ids.quarantined.count", "router.ids.quarantined.max",
    # publish-path telemetry (telemetry.py): recorded batch spans and
    # slow-publish breaches (the .max watermarks keep a burst between
    # heartbeats visible after a reset)
    "publish.spans.count", "publish.spans.max",
    "publish.slow.count", "publish.slow.max",
    # the durability layer: the current journal segment's size, the
    # committed checkpoint generation and the seconds since the last
    # committed checkpoint (an ever-growing age with a non-empty
    # journal means checkpoints are failing — see checkpoint_failed)
    "journal.bytes", "journal.records",
    "durability.generation", "checkpoint.age_s",
    # the cluster plane: membership size, the worst failure-detector
    # state across peers (0 ok / 1 suspect / 2 down) and the slowest
    # peer heartbeat RTT (0 on a node without a cluster)
    "cluster.members.count",
    "cluster.member.state", "cluster.hb.rtt_ms",
    # node lifecycle: 0 running / 1 draining / 2 stopping
    "node.state",
    # overload protection: the monitor's level (0 ok / 1 warn / 2
    # critical) and the device-path breaker's state (0 closed / 1
    # half-open / 2 open / 3 rebuilding)
    "overload.level", "breaker.state",
    # journal shipping to standbys: lag and ack age (0 without it)
    "durability.repl.lag_records", "durability.repl.lag_bytes",
    "durability.repl.last_ack_age_s",
    # walk-table level compression: permille of deepest-level walk
    # steps the compressed tables save over one hop per level
    "automaton.compaction.ratio",
    # sampled tracing and slow-subscriber attribution (tracing.py):
    # span records still held for export, clientids in the slow_subs
    # ranking and the worst average delivery latency among them
    "tracing.spans.pending",
    "slow_subs.tracked", "slow_subs.worst_ms",
    # the main event loop's scheduling lag (monitors.SysMon)
    "loop.0.lag_ms",
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

    def delstat(self, key: str) -> None:
        """Drop a dynamically created row (a departed peer's gauges
        must not linger at their last value)."""
        self._vals.pop(key, None)

    def all(self) -> Dict[str, int]:
        return dict(self._vals)

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
