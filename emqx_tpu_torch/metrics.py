"""Broker counters (a minimal ``emqx_metrics``).

The counter names the ported paths increment are registered up front;
a module registers its own with :meth:`Metrics.new` (idempotent), as
the retainer does for ``retained.*`` and ``monitors.SysMon`` for
``sysmon.long_gc`` and ``sysmon.long_schedule``. An unknown name raises
``KeyError``, as the JAX package's registry does.
"""

from __future__ import annotations

from typing import Dict

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

NAMES = (
    # the publish path
    "messages.received",
    "messages.qos0.received", "messages.qos1.received",
    "messages.qos2.received",
    "messages.sent",
    "messages.qos0.sent", "messages.qos1.sent", "messages.qos2.sent",
    "messages.publish", "messages.forward", "messages.retained",
    "messages.dropped", "messages.dropped.no_subscribers",
    "messages.dropped.expired",
    "messages.delivered", "messages.acked", "messages.redispatched",
    "delivery.dropped", "delivery.dropped.no_local",
    "delivery.dropped.qos0_msg", "delivery.dropped.queue_full",
    "delivery.dropped.expired", "delivery.dropped.too_large",
    # the front door (emqx_metrics.erl:82-183): bytes and packets on
    # the wire, client and session lifecycle, auth and ACL
    "bytes.received", "bytes.sent",
    "packets.received", "packets.sent",
    "packets.connect.received", "packets.connack.sent",
    "packets.connack.error", "packets.connack.auth_error",
    "packets.publish.received", "packets.publish.sent",
    "packets.publish.error", "packets.publish.auth_error",
    "packets.publish.dropped",
    "packets.puback.received", "packets.puback.sent",
    "packets.puback.inuse", "packets.puback.missed",
    "packets.pubrec.received", "packets.pubrec.sent",
    "packets.pubrec.inuse", "packets.pubrec.missed",
    "packets.pubrel.received", "packets.pubrel.sent",
    "packets.pubrel.missed",
    "packets.pubcomp.received", "packets.pubcomp.sent",
    "packets.pubcomp.inuse", "packets.pubcomp.missed",
    "packets.subscribe.received", "packets.suback.sent",
    "packets.subscribe.error", "packets.subscribe.auth_error",
    "packets.unsubscribe.received", "packets.unsuback.sent",
    "packets.unsubscribe.error",
    "packets.pingreq.received", "packets.pingresp.sent",
    "packets.disconnect.received", "packets.disconnect.sent",
    "packets.auth.received", "packets.auth.sent",
    "client.connect", "client.connack", "client.connected",
    "client.authenticate", "client.check_acl", "client.subscribe",
    "client.unsubscribe", "client.disconnected",
    "client.auth.anonymous", "client.acl.cache_hit", "client.acl.deny",
    "session.created", "session.resumed", "session.takeovered",
    "session.discarded", "session.terminated",
    # wills funnelled through the ingress batcher / published directly
    "wills.batched", "wills.direct",
    # connection flush wakeups after coalescing (≤ 1 per connection
    # per batch with the dispatch planner)
    "delivery.wakeups",
    # oversized frames refused at header decode; frames the C parser
    # framed (``Node(frame="native")``)
    "frame.oversize", "frame.native.frames",
    # PUBLISHes that paid a full serialize on the event loop (not
    # eligible for a pre-serialized frame, or preserialize off)
    "delivery.serialize.onloop",
    # the mesh step's device counters (Router.drain_device_stats,
    # folded by the stats flush: one host copy a flush)
    *DEVICE_METRICS,
    # the publish match cache and its epoch bumps
    # (Router.drain_cache_stats, folded by the node's housekeeping)
    "cache.match.hit", "cache.match.miss",
    "cache.match.insert", "cache.match.stale",
    "cache.match.bump.global", "cache.match.bump.partition",
    # the delta automaton and its compactions
    # (Router.drain_automaton_stats); compaction.* are table-state
    # gauges carried as deltas (a rebuild may shrink them)
    "automaton.delta.probes", "automaton.delta.filters",
    "automaton.delta.merges", "automaton.rebuild.stall_ms",
    "automaton.compaction.fused_edges", "automaton.compaction.chains",
    # overload protection (overload.py): `shed.*` = work refused at
    # warn/critical, `transitions` = level changes, `heal.*` = the
    # supervision actions (fetch executor respawn, compaction alarm)
    "overload.shed.qos0", "overload.shed.connect",
    "overload.shed.ingress_timeout", "overload.force_shutdown",
    "overload.transitions", "overload.heal.executor",
    "overload.heal.flatten",
    # the device-path circuit breaker and device-loss recovery
    # (overload.DeviceBreaker, devloss.DeviceRecovery)
    "breaker.failures", "breaker.trips", "breaker.probes",
    "breaker.fallback.batches",
    "breaker.rebuilds", "breaker.rebuild.failures",
    # armed fault points that fired (faults.py), folded by Node.tick
    "faults.injected",
    # the durability layer (wal.py, durability.py), folded by
    # Node.tick: `wal.appends` = journal records framed, `wal.fsyncs`
    # = batched write+sync cycles (one per shard per group commit, not
    # one per record), `wal.fsync_errors` = flushes that failed and
    # degraded a shard to memory-only, `wal.degraded.dropped` =
    # records shed by the bounded drop-oldest buffers,
    # `wal.group.commits`/`.coalesced` = leader group-commit passes /
    # follower flushes that rode one, `checkpoint.saves`/`.errors` =
    # generation commits and failed attempts, `checkpoint.delta.saves`
    # = the incremental ones, `recovery.replayed` = journal records
    # applied at boot, `recovery.torn` = journals truncated at a torn
    # tail, `recovery.sessions` = persistent sessions resurrected,
    # `recovery.routes.pruned` = crash-dead clean-session route refs
    # removed after restore
    "wal.appends", "wal.fsyncs", "wal.fsync_errors",
    "wal.degraded.dropped", "wal.group.commits",
    "wal.group.coalesced",
    "checkpoint.saves", "checkpoint.errors", "checkpoint.delta.saves",
    "recovery.replayed", "recovery.torn", "recovery.sessions",
    "recovery.routes.pruned",
    # replicated durability (replication.py), folded on the stats
    # tick: `durability.repl.shipped`/`.acked` = records shipped to /
    # acknowledged by the standbys, `.ship_errors` = ship calls that
    # failed (that link drops to local-only), `.resyncs` = full
    # snapshot re-syncs (first contact, gap repair, queue overflow),
    # `.dropped` = queued-but-unshipped records discarded by the
    # bounded ship queue, `.promotions` = standby promotions after a
    # primary death, `.quorum.waits`/`.quorum.timeouts` = group
    # commits that blocked for the ack quorum / hit quorum_timeout_ms,
    # `.failbacks`/`.failback_errors` = completed / aborted FAILBACK
    # hand-offs
    "durability.repl.shipped", "durability.repl.acked",
    "durability.repl.ship_errors", "durability.repl.resyncs",
    "durability.repl.dropped", "durability.repl.promotions",
    "durability.repl.quorum.waits", "durability.repl.quorum.timeouts",
    "durability.repl.failbacks", "durability.repl.failback_errors",
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
    # sampled tracing and slow-subscriber attribution (tracing.py),
    # folded on the stats tick: `tracing.spans` = span records drained
    # from the per-thread rings, `tracing.dropped` = spans shed because
    # a ring was full (the ring never blocks the hot path),
    # `slow_subs.flushes` = flush spans folded into the slow-subscriber
    # ranking, `slow_subs.breaches` = flushes whose delivery latency
    # crossed slow_subs_threshold_ms
    "tracing.spans", "tracing.dropped",
    "slow_subs.flushes", "slow_subs.breaches",
    *CLUSTER_METRICS,
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


class Metrics:
    def __init__(self) -> None:
        self._counters: Dict[str, int] = dict.fromkeys(NAMES, 0)

    def new(self, name: str) -> None:
        """Register ``name`` at 0; a registered name keeps its value."""
        self._counters.setdefault(name, 0)

    def inc(self, name: str, n: int = 1) -> None:
        self._counters[name] += n

    def dec(self, name: str, n: int = 1) -> None:
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
