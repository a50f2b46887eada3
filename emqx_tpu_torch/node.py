"""Broker node assembly — the ``emqx_app``/``emqx_sup`` analogue for
the ported paths.

Builds the kernel services (hooks, metrics, stats), the router and
broker on one device, the ingress batcher, the connection manager,
the alarms, overload protection (the monitor, the device-path breaker
and device-loss recovery, at the JAX package's defaults), the module
host and the MQTT listeners, in the reference's boot order
(src/emqx_app.erl:31-44, src/emqx_sup.erl:64-80), and, when enabled,
the durability layer (journal, checkpoints, crash recovery). Tracing,
``$SYS`` topics, plugins, several front-door loops and the cluster
come with their slices.

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
from typing import List, Optional

from emqx_tpu_torch import faults as _faults
from emqx_tpu_torch.alarm import AlarmManager
from emqx_tpu_torch.broker import Broker, DispatchConfig
from emqx_tpu_torch.cm import ConnectionManager
from emqx_tpu_torch.connection import Listener
from emqx_tpu_torch.hooks import Hooks
from emqx_tpu_torch.ingress import IngressBatcher
from emqx_tpu_torch.metrics import Metrics
from emqx_tpu_torch.modules import ModuleRegistry
from emqx_tpu_torch.overload import (DeviceBreaker, OverloadConfig,
                                     OverloadMonitor)
from emqx_tpu_torch.router import MatcherConfig, Router
from emqx_tpu_torch.stats import Stats
from emqx_tpu_torch.zone import Zone, get_zone


class Node:
    def __init__(self, name: str = "emqx_tpu@127.0.0.1",
                 zone: Optional[Zone] = None,
                 matcher: Optional[MatcherConfig] = None,
                 dispatch_config: Optional[DispatchConfig] = None,
                 batch_size: int = 256,
                 device=None, frame: str = "py",
                 overload: Optional[OverloadConfig] = None,
                 faults_config: Optional[_faults.FaultsConfig] = None,
                 durability=None) -> None:
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
        # extension system
        self.modules = ModuleRegistry(self)
        self.listeners: List[Listener] = []
        self._started = False
        self._bg_tasks: list = []

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
        for lst in self.listeners:
            await lst.start()
        self.modules.on_loop_start()
        loop = asyncio.get_running_loop()
        self._bg_tasks.append(loop.create_task(self._housekeeping()))
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
        for t in self._bg_tasks:
            t.cancel()
        self._bg_tasks.clear()
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
            self.tick()

    def tick(self) -> None:
        """The housekeeping tick, as the JAX node's stats flush: fold
        the match-cache and automaton counters into :attr:`metrics`,
        publish the overload level and breaker state gauges, fold the
        fired fault points into ``faults.injected`` and the durability
        layer's counters and alarms (:meth:`_tick_durability`), turn a
        crashed compaction into its alarm and retry it once its
        backoff elapsed."""
        cache = self.router.drain_cache_stats()
        if any(cache.values()):
            self.metrics.fold_cache_stats(cache)
        auto = self.router.drain_automaton_stats()
        if any(auto.values()):
            self.metrics.fold_automaton_stats(auto)
        if self.overload is not None:
            self.stats.setstat("overload.level", self.overload.level)
        if self.broker.breaker is not None:
            self.stats.setstat("breaker.state", self.broker.breaker.state)
        inj = _faults.drain_injected()
        if inj:
            self.metrics.inc("faults.injected", inj)
        if self.durability is not None:
            self._tick_durability()
        self.drain_robustness_events()
        self.router.retry_compaction()

    def _tick_durability(self) -> None:
        """Fold the journal/checkpoint counters (written off the loop)
        into :attr:`metrics`, apply the alarms the journal's threads
        recorded, and publish the journal and checkpoint gauges."""
        dur = self.durability
        dur.fold_metrics(self.metrics)
        dur.drain_events(self.alarms)
        info = dur.info()
        j = info["journal"]
        self.stats.setstat("journal.bytes", int(j.get("bytes", 0)))
        self.stats.setstat("journal.records", int(j.get("records", 0)))
        self.stats.setstat("durability.generation", info["generation"])
        age = info.get("checkpoint_age_s")
        if age is not None:
            self.stats.setstat("checkpoint.age_s", int(age))

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
