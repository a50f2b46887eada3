"""Broker node assembly — the ``emqx_app``/``emqx_sup`` analogue for
the ported paths.

Builds the kernel services (hooks, metrics, stats), the router and
broker on one device, the channel registry and the module host, in
the reference's boot order (src/emqx_app.erl:31-44,
src/emqx_sup.erl:64-80). Listeners, ingress batching, alarms,
overload protection, durability, tracing, ``$SYS`` topics, plugins
and the cluster come with their slices.

    node = Node(device="cuda")
    node.modules.load(RetainerModule)
    await node.start()
"""

from __future__ import annotations

from typing import Optional

from emqx_tpu_torch.broker import Broker, DispatchConfig
from emqx_tpu_torch.cm import ConnectionManager
from emqx_tpu_torch.hooks import Hooks
from emqx_tpu_torch.metrics import Metrics
from emqx_tpu_torch.modules import ModuleRegistry
from emqx_tpu_torch.router import MatcherConfig, Router
from emqx_tpu_torch.stats import Stats


class Node:
    def __init__(self, name: str = "emqx_tpu@127.0.0.1",
                 matcher: Optional[MatcherConfig] = None,
                 dispatch_config: Optional[DispatchConfig] = None,
                 device=None) -> None:
        self.name = name
        # kernel services (emqx_kernel_sup)
        self.hooks = Hooks()
        self.metrics = Metrics()
        self.stats = Stats()
        # routing + pubsub core, on the node's device
        self.router = Router(config=matcher, node=name, device=device)
        self.device = self.router.device
        self.broker = Broker(router=self.router, hooks=self.hooks,
                             metrics=self.metrics, node=name,
                             dispatch_config=dispatch_config)
        # connection/session management (emqx_cm_sup)
        self.cm = ConnectionManager(broker=self.broker)
        # extension system
        self.modules = ModuleRegistry(self)
        self._started = False

    async def start(self) -> None:
        """Start the modules' loop-bound work on the running loop."""
        if not self._started:
            self._started = True
            self.modules.on_loop_start()

    async def stop(self) -> None:
        """Quiesce the modules' loop-bound work; modules stay loaded."""
        if self._started:
            self._started = False
            self.modules.on_loop_stop()

    # -- facade (src/emqx.erl:26-64) --------------------------------------

    def subscribe(self, sub, topic_filter: str, **kw):
        return self.broker.subscribe(sub, topic_filter, **kw)

    def unsubscribe(self, sub, topic_filter: str):
        return self.broker.unsubscribe(sub, topic_filter)

    def publish(self, msg):
        return self.broker.publish(msg)
