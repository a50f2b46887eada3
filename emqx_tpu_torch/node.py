"""Broker node assembly — the ``emqx_app``/``emqx_sup`` analogue for
the ported paths.

Builds the kernel services (hooks, metrics, stats, the trace log),
the router and broker on one device, the ingress batcher, the
connection manager, the alarms, overload protection (the monitor, the
device-path breaker and device-loss recovery, at the JAX package's
defaults), observability at the JAX package's defaults (publish-batch
telemetry spans on, sampled tracing built at ``sample_rate = 0``, the
``$SYS`` heartbeat every 60 s with the stats flush, the host monitors
and the periodic full collection; every connection forces a young
collection per 16,000 packets or 16 MiB received), the module host
and the MQTT listeners, in the reference's boot order
(src/emqx_app.erl:31-44, src/emqx_sup.erl:64-80), and, when enabled,
the durability layer (journal, checkpoints, crash recovery). Plugins,
several front-door loops and the cluster come with their slices.

``Node(overload=OverloadConfig(enabled=False))`` builds no monitor,
breaker or recovery: every guard reads ``None``.
``Node(durability=DurabilityConfig(enabled=True, dir=...))`` builds
the durability manager: :meth:`start` recovers the directory's state
before any listener accepts, and :meth:`stop` commits a clean-shutdown
checkpoint. The default builds none.

    node = Node(device="cuda")
    node.modules.load(RetainerModule)
    node.add_listener(port=1883)
    await node.start()      # accepts MQTT clients on the running loop
    ...
    await node.stop()
"""

from __future__ import annotations

import asyncio
import logging
from typing import List, Optional

from emqx_tpu_torch import faults as _faults
from emqx_tpu_torch.alarm import AlarmManager
from emqx_tpu_torch.broker import Broker, DispatchConfig
from emqx_tpu_torch.cm import ConnectionManager
from emqx_tpu_torch.connection import Listener
from emqx_tpu_torch.gc import GlobalGc
from emqx_tpu_torch.hooks import Hooks
from emqx_tpu_torch.ingress import IngressBatcher
from emqx_tpu_torch.metrics import Metrics
from emqx_tpu_torch.modules import ModuleRegistry
from emqx_tpu_torch.monitors import OsMon, SysMon, VmMon
from emqx_tpu_torch.overload import (DeviceBreaker, OverloadConfig,
                                     OverloadMonitor)
from emqx_tpu_torch.router import MatcherConfig, Router
from emqx_tpu_torch.stats import Stats
from emqx_tpu_torch.sys_topics import SysTopics
from emqx_tpu_torch.telemetry import Telemetry, TelemetryConfig
from emqx_tpu_torch.tracer import Tracer
from emqx_tpu_torch.tracing import Tracing, TracingConfig
from emqx_tpu_torch.zone import Zone, get_zone

log = logging.getLogger("emqx_tpu_torch.node")

#: the ``node.state`` gauge's values (the drain's ``1`` comes with it)
NODE_RUNNING = 0
NODE_STOPPING = 2


class Node:
    def __init__(self, name: str = "emqx_tpu@127.0.0.1",
                 zone: Optional[Zone] = None,
                 matcher: Optional[MatcherConfig] = None,
                 dispatch_config: Optional[DispatchConfig] = None,
                 batch_size: int = 256,
                 device=None, frame: str = "py",
                 overload: Optional[OverloadConfig] = None,
                 faults_config: Optional[_faults.FaultsConfig] = None,
                 durability=None,
                 telemetry: Optional[TelemetryConfig] = None,
                 tracing: Optional[TracingConfig] = None,
                 sys_interval: float = 60.0) -> None:
        self.name = name
        self.zone = zone or get_zone()
        # [node] frame: the wire-framing parser of every connection,
        # "py" (the default, as in the JAX package) or "native". The
        # native one is built here, so a failed build raises at boot
        if frame not in ("py", "native"):
            raise ValueError(f'frame must be "py" or "native", '
                             f"got {frame!r}")
        if frame == "native":
            from emqx_tpu_torch.ops.native import load_library

            load_library()
        self.frame = frame
        # kernel services (emqx_kernel_sup)
        self.hooks = Hooks()
        self.metrics = Metrics()
        self.stats = Stats()
        self.tracer = Tracer()
        # routing + pubsub core, on the node's device
        self.router = Router(config=matcher, node=name, device=device)
        self.device = self.router.device
        # a crashed background compaction: the router's thread records
        # the error here (a plain attribute store — thread-safe); the
        # monitor or housekeeping tick turns it into the alarm and
        # retries the compaction after its backoff
        self._flatten_err: Optional[str] = None
        self._flatten_alarmed = False
        self.router.on_bg_error = self._note_flatten_error
        # on CUDA the Broker loads its kernel library here: a build
        # failure raises out of Node(...), before any breaker exists
        self.broker = Broker(router=self.router, hooks=self.hooks,
                             metrics=self.metrics, node=name,
                             dispatch_config=dispatch_config)
        self.broker.tracer = self.tracer
        # ingress batcher: PUBLISHes from all connections aggregate
        # into one device publish batch per tick (ingress.py)
        self.ingress = IngressBatcher(self.broker, batch_size=batch_size,
                                      device=self.device)
        self.broker.ingress = self.ingress
        # connection/session management (emqx_cm_sup)
        self.cm = ConnectionManager(broker=self.broker)
        self.alarms = AlarmManager(broker=self.broker, node=name)
        self.broker.alarms = self.alarms
        # overload protection and the device-path breaker
        # (overload.py); enabled=False builds neither, and the broker,
        # channel and session guards read None
        ocfg = overload or OverloadConfig()
        self.overload_config = ocfg
        self.overload: Optional[OverloadMonitor] = None
        if ocfg.enabled:
            self.overload = OverloadMonitor(self, ocfg)
            self.broker.overload = self.overload
            if ocfg.breaker:
                self.broker.breaker = DeviceBreaker(
                    self.metrics, alarms=self.alarms,
                    failures=ocfg.breaker_failures,
                    cooldown_s=ocfg.breaker_cooldown_s,
                    slow_ms=ocfg.breaker_slow_ms,
                    strict=self.device.type == "cuda")
                if ocfg.breaker_rebuild:
                    # device-loss recovery (devloss.py): classify
                    # trips, rebuild the device state on a lost
                    # backend, re-warm, re-arm the half-open probe
                    from emqx_tpu_torch.devloss import DeviceRecovery

                    self.broker.breaker.recovery = DeviceRecovery(
                        self.broker, self.metrics, self.alarms,
                        backoff_s=ocfg.rebuild_backoff_s,
                        sentinel_timeout_s=ocfg.sentinel_timeout_s)
            self.ingress.submit_wait_timeout = ocfg.ingress_wait_timeout_s
        # fault injection ([faults], faults.py): arm specs applied at
        # build; no section leaves the process registry untouched
        self.faults_config = faults_config
        if faults_config is not None:
            _faults.configure(faults_config)
        # durability layer (durability.py): write-ahead journal +
        # atomic checkpoints + crash recovery. enabled=False (the
        # default) builds NO manager: the broker, cm, channel, session
        # and retainer guards read None
        self.durability = None
        if durability is not None and durability.enabled:
            from emqx_tpu_torch.durability import DurabilityManager

            self.durability = DurabilityManager(self, durability)
            self.broker.durability = self.durability
            self.cm.durability = self.durability
        self.node_state = NODE_RUNNING
        # publish-path telemetry (telemetry.py): stage histograms and
        # the slow-publish log, on by default. Wired onto broker AND
        # router — the broker stamps the spans, the router's
        # cache-split dispatch leaves its probe/merge share for the
        # span and its compactions observe the rebuild stage
        self.telemetry = Telemetry(telemetry, tracer=self.tracer,
                                   alarms=self.alarms, node=name)
        self.broker.telemetry = self.telemetry
        self.router.telemetry = self.telemetry
        # per-message span tracing (tracing.py): always built; at
        # sample_rate = 0 (the default) no seam stamps a context and
        # the deliveries are the untraced build's, byte for byte
        self.tracing = Tracing(tracing, metrics=self.metrics,
                               alarms=self.alarms, node=name)
        self.broker.tracing = self.tracing
        # the $SYS heartbeat (sys_topics.py): runs the stats flush
        # (_update_stats) and publishes every sys_interval seconds
        self.sys = SysTopics(self.broker, node=name, stats=self.stats,
                             interval=sys_interval,
                             telemetry=self.telemetry,
                             tracing=self.tracing)
        # host monitors (emqx_os_mon / emqx_vm_mon / emqx_sys_mon) and
        # the periodic full collection (emqx_global_gc)
        self.os_mon = OsMon(self.alarms)
        self.vm_mon = VmMon(self.alarms, self.cm.connection_count,
                            max_count=Listener.MAX_CONNECTIONS)
        self.sys_mon = SysMon(metrics=self.metrics, hooks=self.hooks)
        self.global_gc = GlobalGc()
        # extension system
        self.modules = ModuleRegistry(self)
        self.listeners: List[Listener] = []
        self._started = False
        self._bg_tasks: list = []
        # fid-quarantine growth watch (stats tick): depth at the last
        # tick + consecutive-growth streak behind the
        # router_ids_quarantined alarm (_watch_quarantine)
        self._quar_prev = 0
        self._quar_streak = 0
        self.stats.register_update(self._update_stats)

    def add_listener(self, host: str = "127.0.0.1", port: int = 1883,
                     zone: Optional[Zone] = None,
                     name: str = "tcp:default",
                     proxy_protocol: bool = False,
                     access_rules=None) -> Listener:
        """A plain-TCP MQTT listener on the node's broker; it accepts
        from the next :meth:`start` on (``port=0`` takes a free port,
        read back from ``listener.port`` after the start)."""
        lst = Listener(self.broker, self.cm, host=host, port=port,
                       zone=zone or self.zone, name=name,
                       proxy_protocol=proxy_protocol,
                       access_rules=access_rules, device=self.device,
                       frame=self.frame)
        self.listeners.append(lst)
        return lst

    async def start(self) -> None:
        """Recover the durable state (when enabled), then start the
        listeners, the modules' loop-bound work and the session
        housekeeping on the running loop."""
        if self._started:
            return
        if self.durability is not None:
            if self.durability.last_recovery is None:
                # crash recovery BEFORE any listener accepts: newest
                # intact checkpoint, journal tail replayed, retained
                # topics re-armed, persistent sessions resurrected.
                # Runs with modules loaded so the retainer takes its
                # store back
                self.durability.recover()
            else:
                # started again after stop(): the live state stands;
                # re-arm the journal stop() closed
                self.durability.resume()
        br = self.broker.breaker
        if br is not None and br.recovery is not None:
            br.recovery.start()  # re-armed after an earlier stop()
        # a node started again after stop() runs again (the JAX node
        # keeps reporting the stop)
        self.node_state = NODE_RUNNING
        for lst in self.listeners:
            await lst.start()
        # vm_mon watches the node-wide connection count, so the
        # watermark's denominator is the summed listener capacity
        if self.listeners:
            self.vm_mon.max_count = (Listener.MAX_CONNECTIONS
                                     * len(self.listeners))
        self.modules.on_loop_start()
        loop = asyncio.get_running_loop()
        self._bg_tasks.append(loop.create_task(self._housekeeping()))
        self._bg_tasks.append(loop.create_task(self._sys_loop()))
        for mon in (self.os_mon, self.vm_mon, self.sys_mon,
                    self.global_gc):
            self._bg_tasks.append(loop.create_task(mon.run()))
        if self.overload is not None:
            self._bg_tasks.append(loop.create_task(self.overload.run()))
        if self.durability is not None:
            self._bg_tasks.append(loop.create_task(self.durability.run()))
        self._started = True

    async def stop(self) -> None:
        """Close the listeners and their connections, drain the ingress
        batcher, quiesce the modules' loop-bound work (modules stay
        loaded)."""
        if not self._started:
            return
        self._started = False
        self.node_state = NODE_STOPPING
        for t in self._bg_tasks:
            t.cancel()
        self._bg_tasks.clear()
        # the collector hook is process-wide: it goes now, not when
        # the cancelled SysMon task next runs (install is idempotent,
        # so a later start() puts it back once)
        self.sys_mon.remove_gc_hook()
        self.tracing.profiler.stop()
        if self.overload is not None:
            # its task is cancelled: a level it set must not keep
            # refusing CONNECTs with no sample behind it
            self.overload.reset()
        br = self.broker.breaker
        if br is not None and br.recovery is not None:
            # an in-flight device-state rebuild must not retry into a
            # stopping node (its thread is a daemon; this breaks its
            # backoff loop early)
            br.recovery.stop()
        self.modules.on_loop_stop()
        if self.durability is not None:
            # graceful shutdown: v5 clients get DISCONNECT
            # Server-Shutting-Down (0x8B) before their sockets close,
            # so they reconnect and resume
            from emqx_tpu_torch.mqtt import reason_codes as RC

            for lst in self.listeners:
                lst.shutdown_rc = RC.SERVER_SHUTTING_DOWN
        # listeners first: the drain waits for quiescence, which never
        # comes while live connections keep submitting publishes
        for lst in self.listeners:
            await lst.stop()
        await self.ingress.drain()
        if self.durability is not None:
            # after the listeners closed (sessions detached, final
            # state records written) and the ingress drained: flush
            # the journal and commit a clean-shutdown checkpoint — the
            # next boot recovers from it, not from a replay
            await asyncio.get_running_loop().run_in_executor(
                None, self.durability.shutdown)

    async def _housekeeping(self) -> None:
        while True:
            await asyncio.sleep(5.0)
            self.cm.expire_sessions()

    async def _sys_loop(self) -> None:
        while True:
            await asyncio.sleep(self.sys.interval)
            try:
                self.sys.heartbeat()
            except Exception:
                log.exception("sys heartbeat failed")

    def tick(self) -> None:
        """The stats flush on demand (what the ``$SYS`` heartbeat and a
        Prometheus scrape run first: :meth:`_update_stats` and every
        other registered update fun), then a retry of a crashed
        compaction once its backoff elapsed (the overload monitor's
        heal sweep does the same every second)."""
        self.stats.tick()
        self.router.retry_compaction()

    def _update_stats(self, stats: Stats) -> None:
        """The JAX node's stats flush: the connection, session, topic,
        route and subscription gauges; the match-cache and automaton
        counter folds; the compaction ratio and cache gauges; the
        quarantine watch; the overload level and breaker state; the
        fired fault points; the durability layer's counters, alarms
        and gauges; the robustness alarms; the span counts; the trace
        drain; the loop lag; the mesh's device counters. The per-loop
        rows and the cluster rows come with their slices."""
        stats.setstat("node.state", self.node_state)
        stats.setstat("connections.count", self.cm.connection_count(),
                      "connections.max")
        stats.setstat("sessions.count", self.cm.session_count(),
                      "sessions.max")
        rstats = self.router.stats()
        stats.setstat("topics.count", rstats["topics.count"], "topics.max")
        stats.setstat("routes.count", rstats["routes.count"], "routes.max")
        nsubs = sum(len(s) for s in self.broker._subscriptions.values())
        stats.setstat("subscriptions.count", nsubs, "subscriptions.max")
        nshared = sum(len(m) for m in self.broker.shared._subs.values())
        stats.setstat("subscriptions.shared.count", nshared,
                      "subscriptions.shared.max")
        stats.setstat("subscribers.count",
                      sum(len(v) for v in self.broker._subscribers.values()),
                      "subscribers.max")
        dev = self.router.drain_device_stats()
        if any(dev.values()):
            self.metrics.fold_device_stats(dev)
        cache = self.router.drain_cache_stats()
        if any(cache.values()):
            self.metrics.fold_cache_stats(cache)
        auto = self.router.drain_automaton_stats()
        if any(auto.values()):
            self.metrics.fold_automaton_stats(auto)
        stats.setstat("automaton.compaction.ratio",
                      self.router.walk_info()["ratio"])
        stats.setstat("match.cache.entries.count",
                      self.router.cache_entries(),
                      "match.cache.entries.max")
        stats.setstat("match.cache.partition.live",
                      self.router.cache_partitions_live())
        self._watch_quarantine(stats)
        if self.overload is not None:
            stats.setstat("overload.level", self.overload.level)
        if self.broker.breaker is not None:
            stats.setstat("breaker.state", self.broker.breaker.state)
        inj = _faults.drain_injected()
        if inj:
            self.metrics.inc("faults.injected", inj)
        if self.durability is not None:
            self._tick_durability(stats)
        self.drain_robustness_events()
        stats.setstat("publish.spans.count", self.telemetry.spans_total,
                      "publish.spans.max")
        stats.setstat("publish.slow.count", self.telemetry.slow_total,
                      "publish.slow.max")
        # the trace-span drain: swap the per-thread rings, fold flush
        # spans into slow_subs, bump the tracing.* counters and gauges
        # (a cheap no-op while nothing is sampled)
        self.tracing.drain_tick(stats)
        for i, lag in enumerate(self.sys_mon.loop_lags):
            stats.setstat(f"loop.{i}.lag_ms", round(lag, 3))

    def _tick_durability(self, stats: Stats) -> None:
        """Fold the journal/checkpoint counters (written off the loop)
        into :attr:`metrics`, apply the alarms the journal's threads
        recorded, and publish the journal and checkpoint gauges."""
        dur = self.durability
        dur.fold_metrics(self.metrics)
        dur.drain_events(self.alarms)
        info = dur.info()
        j = info["journal"]
        stats.setstat("journal.bytes", int(j.get("bytes", 0)))
        stats.setstat("journal.records", int(j.get("records", 0)))
        stats.setstat("durability.generation", info["generation"])
        age = info.get("checkpoint_age_s")
        if age is not None:
            stats.setstat("checkpoint.age_s", int(age))

    #: consecutive growing stats ticks before the fid-quarantine alarm
    #: fires (with the default 60 s heartbeat: about 3 minutes of
    #: monotonic growth)
    QUARANTINE_ALARM_TICKS = 3

    def _watch_quarantine(self, stats: Stats) -> None:
        """Publish the fid-quarantine depth gauge and raise the
        ``router_ids_quarantined`` alarm on sustained growth past the
        router's own reclaim bound: between flattens nothing drains
        ``_pending_free``, so depth growing every tick means subscribe
        churn is outpacing compaction and host memory grows linearly.
        Clears on the first non-growing tick (a flatten drained it)."""
        q = self.router.quarantined_ids()
        stats.setstat("router.ids.quarantined.count", q,
                      "router.ids.quarantined.max")
        bound = self.router.config.host_reclaim_pending
        if q > self._quar_prev and q > bound:
            self._quar_streak += 1
        else:
            self._quar_streak = 0
            self.alarms.deactivate("router_ids_quarantined")
        self._quar_prev = q
        if self._quar_streak >= self.QUARANTINE_ALARM_TICKS:
            self.alarms.activate(
                "router_ids_quarantined",
                details={"quarantined": q,
                         "streak_ticks": self._quar_streak,
                         "bound": bound},
                message=(f"router fid quarantine growing for "
                         f"{self._quar_streak} stats ticks "
                         f"(depth {q})"))

    def _note_flatten_error(self, exc) -> None:
        """Router background-compaction outcome callback — may run ON
        the compaction thread, so it only stores (the alarm is raised
        on the loop, in :meth:`drain_robustness_events`)."""
        self._flatten_err = repr(exc) if exc is not None else None

    def drain_robustness_events(self) -> None:
        """Turn thread-recorded robustness events into alarms and
        metrics — called from the overload monitor's tick and the
        housekeeping tick (whichever runs first; both on the loop)."""
        err = self._flatten_err
        if err is not None and not self._flatten_alarmed:
            self._flatten_alarmed = True
            self.metrics.inc("overload.heal.flatten")
            self.alarms.activate(
                "router_compaction_failed",
                details={"error": err},
                message="background compaction crashed; "
                        "backoff retry armed")
        elif err is None and self._flatten_alarmed:
            self._flatten_alarmed = False
            self.alarms.deactivate("router_compaction_failed")

    # -- facade (src/emqx.erl:26-64) --------------------------------------

    def subscribe(self, sub, topic_filter: str, **kw):
        return self.broker.subscribe(sub, topic_filter, **kw)

    def unsubscribe(self, sub, topic_filter: str):
        return self.broker.unsubscribe(sub, topic_filter)

    def publish(self, msg):
        return self.broker.publish(msg)
