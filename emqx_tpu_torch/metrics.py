"""Broker counters (a minimal ``emqx_metrics``).

The counter names the ported paths increment are registered up front;
a module registers its own with :meth:`Metrics.new` (idempotent), as
the retainer does for ``retained.*`` and ``monitors.SysMon`` for
``sysmon.long_gc`` and ``sysmon.long_schedule``. An unknown name raises
``KeyError``, as the JAX package's registry does.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from emqx_tpu_torch.concurrency import any_thread, shared_state

#: the mesh publish step's device accumulators, summed over the mesh
#: and folded into the host counters by Metrics.fold_device_stats — the
#: pdict-batched counter idea (src/emqx_pd.erl) across the host link
DEVICE_METRICS = (
    "device.matches", "device.deliveries", "device.overflows",
)

# the cluster plane (cluster.py, cluster_net.py), folded from the
# node's Cluster/transport event counters on the stats tick:
# `cluster.hb.*` = failure-detector transitions (ok→suspect,
# suspect→down, down→reappeared), `cluster.rpc.fastfail` = calls
# refused WITHOUT touching the wire because the detector held the
# peer suspect/down, `cluster.rpc.errors` = transport errors the
# detector judges instead of a nodedown, `cluster.forward.dropped` =
# at-most-once data-plane casts shed (cast buffer full, or net.drop) —
# the loss anti-entropy exists to repair, `cluster.heal.rejoins` =
# auto-heal handshakes completed, `cluster.ae.sweeps`/`.repairs` =
# anti-entropy rounds run / entries re-pushed, `cluster.locker.degraded`
# = lock quorums that proceeded without a suspect member's vote
CLUSTER_METRICS = (
    "cluster.hb.suspects", "cluster.hb.downs",
    "cluster.hb.reappears", "cluster.rpc.fastfail",
    "cluster.rpc.errors",
    "cluster.forward.dropped", "cluster.heal.rejoins",
    "cluster.ae.sweeps", "cluster.ae.repairs",
    "cluster.locker.degraded",
)

# overload protection (overload.py) and the device-path breaker
# (overload.DeviceBreaker, devloss.DeviceRecovery): the names
# ``ctl overload`` reports when non-zero
OVERLOAD_METRICS = (
    "overload.shed.qos0", "overload.shed.connect",
    "overload.shed.ingress_timeout", "overload.force_shutdown",
    "overload.transitions", "overload.heal.executor",
    "overload.heal.flatten", "overload.heal.loop",
    "overload.takeover.timeout",
)
BREAKER_METRICS = (
    "breaker.failures", "breaker.trips", "breaker.probes",
    "breaker.fallback.batches",
    "breaker.rebuilds", "breaker.rebuild.failures",
)

NAMES = (
    # the JAX package's catalogue, in its order (its ALL_METRICS), less
    # ``frame.fallback``: the port's frame parser has no fallback path.
    # ``Metrics.all`` and ``ctl metrics`` list them in this order
    # bytes and packets on the wire (emqx_metrics.erl:82-183)
    "bytes.received", "bytes.sent",
    "packets.received", "packets.sent", "packets.connect.received",
    "packets.connack.sent", "packets.connack.error",
    "packets.connack.auth_error", "packets.publish.received",
    "packets.publish.sent", "packets.publish.error",
    "packets.publish.auth_error", "packets.publish.dropped",
    "packets.puback.received", "packets.puback.sent",
    "packets.puback.inuse", "packets.puback.missed",
    "packets.pubrec.received", "packets.pubrec.sent",
    "packets.pubrec.inuse", "packets.pubrec.missed",
    "packets.pubrel.received", "packets.pubrel.sent",
    "packets.pubrel.missed", "packets.pubcomp.received",
    "packets.pubcomp.sent", "packets.pubcomp.inuse",
    "packets.pubcomp.missed", "packets.subscribe.received",
    "packets.suback.sent", "packets.subscribe.error",
    "packets.subscribe.auth_error", "packets.unsubscribe.received",
    "packets.unsuback.sent", "packets.unsubscribe.error",
    "packets.pingreq.received", "packets.pingresp.sent",
    "packets.disconnect.received", "packets.disconnect.sent",
    "packets.auth.received", "packets.auth.sent",
    # the publish path
    "messages.received", "messages.sent", "messages.qos0.received",
    "messages.qos0.sent", "messages.qos1.received", "messages.qos1.sent",
    "messages.qos2.received", "messages.qos2.sent", "messages.publish",
    "messages.dropped", "messages.dropped.expired",
    "messages.dropped.no_subscribers", "messages.forward",
    "messages.retained", "messages.redispatched", "messages.delayed",
    "messages.delivered", "messages.acked",
    # wills funnelled through the ingress batcher / published directly
    "wills.batched", "wills.direct",
    # deliveries dropped; connection flush wakeups after coalescing (≤ 1 per
    # connection per batch with the dispatch planner); PUBLISHes that paid
    # a full serialize on the event loop; the cross-loop delivery ring's
    # handoffs (at most one a peer loop a batch) and the deliveries they
    # carried, and deliveries lost to a gone or wedged front-door loop
    # (all 0 on a single-loop node; ``ctl overload`` reads the last)
    "delivery.dropped", "delivery.dropped.no_local",
    "delivery.dropped.too_large", "delivery.dropped.qos0_msg",
    "delivery.dropped.queue_full", "delivery.dropped.expired",
    "delivery.wakeups", "delivery.serialize.onloop",
    "delivery.xloop.handoffs", "delivery.xloop.deliveries",
    "delivery.xloop.orphaned",
    # client and session lifecycle, auth and ACL
    "client.connect", "client.connack", "client.connected",
    "client.authenticate", "client.check_acl", "client.subscribe",
    "client.unsubscribe", "client.disconnected",
    "session.created", "session.resumed", "session.takeovered",
    "session.discarded", "session.terminated",
    "client.auth.anonymous", "client.acl.cache_hit", "client.acl.deny",
    *DEVICE_METRICS,
    # the publish match cache and its epoch bumps
    # (Router.drain_cache_stats, folded by the node's housekeeping)
    "cache.match.hit", "cache.match.miss", "cache.match.insert",
    "cache.match.stale", "cache.match.bump.global",
    "cache.match.bump.partition",
    # the delta automaton and its compactions
    # (Router.drain_automaton_stats); compaction.* are table-state
    # gauges carried as deltas (a rebuild may shrink them)
    "automaton.delta.probes", "automaton.delta.filters",
    "automaton.delta.merges", "automaton.rebuild.stall_ms",
    "automaton.compaction.fused_edges", "automaton.compaction.chains",
    # slow-consumer guard closes (zone send_timeout)
    "connections.closed.slow_consumer",
    *OVERLOAD_METRICS,
    *BREAKER_METRICS,
    # armed fault points that fired (faults.py), folded by Node.tick
    "faults.injected",
    # the graceful drain (drain.py): `drain.rejected.connects` =
    # CONNECTs refused with 0x9C while DRAINING, `drain.redirects` =
    # live clients redirected by the paced waves, `drain.waves` /
    # `drain.waves.deferred` = waves executed / held because the
    # target reported critical overload, `drain.handoff.sessions` =
    # persistent sessions whose custody moved to the drain target,
    # `drain.handoff.errors` = hand-offs that failed or whose digest
    # never settled inside the bound
    "drain.rejected.connects", "drain.redirects", "drain.waves",
    "drain.waves.deferred", "drain.handoff.sessions",
    "drain.handoff.errors",
    # `ctl reload` (reload.py): knobs applied, boot-only knobs that
    # rejected a reload
    "config.reload.applied", "config.reload.rejected",
    # the durability layer (wal.py, durability.py) and replicated
    # durability (replication.py), folded by Node.tick: `wal.*` = journal
    # appends, batched fsyncs, failed flushes, shed records and group
    # commits; `checkpoint.*` = generation commits, failures and the
    # incremental ones; `recovery.*` = what a boot replayed, truncated,
    # resurrected and pruned; `durability.repl.*` = records shipped,
    # acked, failed ship calls, re-syncs, dropped queue entries,
    # promotions, quorum waits/timeouts and fail-backs
    "wal.appends", "wal.fsyncs", "wal.fsync_errors",
    "wal.degraded.dropped", "wal.group.commits", "wal.group.coalesced",
    "checkpoint.saves", "checkpoint.errors", "checkpoint.delta.saves",
    "recovery.replayed", "recovery.torn", "recovery.sessions",
    "recovery.routes.pruned", "durability.repl.shipped",
    "durability.repl.acked", "durability.repl.ship_errors",
    "durability.repl.resyncs", "durability.repl.dropped",
    "durability.repl.promotions", "durability.repl.quorum.waits",
    "durability.repl.quorum.timeouts", "durability.repl.failbacks",
    "durability.repl.failback_errors",
    *CLUSTER_METRICS,
    # sampled tracing and slow-subscriber attribution (tracing.py),
    # folded on the stats tick
    "tracing.spans", "tracing.dropped", "slow_subs.flushes",
    "slow_subs.breaches",
    # oversized frames refused at header decode; frames the C parser
    # framed (``Node(frame="native")``)
    "frame.native.frames", "frame.oversize",
)

#: registry names that are NOT monotonic (``Metrics.dec`` runs on them,
#: or they carry table-state deltas a rebuild may shrink). A Prometheus
#: ``counter`` may only go up (scrapers read a decrease as a restart),
#: so the exposition (modules/prometheus.render) types these ``gauge``
GAUGE_METRICS = frozenset({
    "retained.count",
    "automaton.compaction.fused_edges",
    "automaton.compaction.chains",
})

_QOS_RECV = ("messages.qos0.received", "messages.qos1.received",
             "messages.qos2.received")
_QOS_SENT = ("messages.qos0.sent", "messages.qos1.sent",
             "messages.qos2.sent")


@shared_state(lock="_lock", attrs=("_counters",))
class Metrics:
    def __init__(self) -> None:
        self._counters: Dict[str, int] = dict.fromkeys(NAMES, 0)
        # a multi-loop node increments from several loop threads, and
        # the bare read-modify-write would lose updates: Node.start()
        # arms the lock there; a single-loop node keeps the lock-free
        # single-writer path
        self._lock: Optional[threading.Lock] = None

    def enable_threadsafe(self) -> None:
        """Arm the increment lock (multi-loop nodes). One-way: a started
        multi-loop node never goes back to a single writer."""
        if self._lock is None:
            self._lock = threading.Lock()

    def new(self, name: str) -> None:
        """Register ``name`` at 0; a registered name keeps its value."""
        self._counters.setdefault(name, 0)

    @any_thread
    def inc(self, name: str, n: int = 1) -> None:
        lock = self._lock
        if lock is None:
            self._counters[name] += n
        else:
            with lock:
                self._counters[name] += n

    @any_thread
    def dec(self, name: str, n: int = 1) -> None:
        lock = self._lock
        if lock is None:
            self._counters[name] -= n
        else:
            with lock:
                self._counters[name] -= n

    def inc_msg(self, msg) -> None:
        """Count an inbound message by QoS."""
        self.inc("messages.received")
        self.inc(_QOS_RECV[min(msg.qos, 2)])

    def inc_sent(self, msg) -> None:
        """Count an outbound message by QoS."""
        self.inc("messages.sent")
        self.inc(_QOS_SENT[min(msg.qos, 2)])

    def fold_device_stats(self, stats: Dict[str, int]) -> None:
        """Fold a drained device accumulator (matches, deliveries,
        overflows; ``Router.drain_device_stats``) into the host
        counters."""
        for key, val in stats.items():
            self.inc(f"device.{key}", int(val))

    def fold_cache_stats(self, stats: Dict[str, int]) -> None:
        """Fold drained match-cache counter deltas
        (``Router.drain_cache_stats``)."""
        for key, val in stats.items():
            self.inc(f"cache.match.{key}", int(val))

    def fold_automaton_stats(self, stats: Dict[str, int]) -> None:
        """Fold drained delta-automaton / rebuild counter deltas
        (``Router.drain_automaton_stats``)."""
        for key, val in stats.items():
            self.inc(f"automaton.{key}", int(val))

    def fold_cluster_stats(self, stats: Dict[str, int]) -> None:
        """Fold drained cluster-plane event counters
        (``Cluster.drain_counters``). Keys outside CLUSTER_METRICS are
        registered on first sight — the cluster and transport may grow
        event names without a registry edit here."""
        for key, val in stats.items():
            name = f"cluster.{key}"
            self.new(name)
            self.inc(name, int(val))

    def val(self, name: str) -> int:
        return self._counters[name]

    def all(self) -> Dict[str, int]:
        return dict(self._counters)

    def names(self) -> List[str]:
        return list(self._counters)


_global = Metrics()


def global_metrics() -> Metrics:
    return _global
