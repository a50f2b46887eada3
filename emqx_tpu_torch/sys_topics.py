"""``$SYS`` broker heartbeat: periodic publication of uptime, version,
stats and metrics under ``$SYS/brokers/<node>/...`` (the port of the
JAX package's ``sys_topics.py``; reference: src/emqx_sys.erl:154-163).

Every message goes through ``broker.publish``, as in the JAX package:
on a node past the device threshold each one is a one-message device
batch (one walk launch apiece).
"""

from __future__ import annotations

import json
import time

from emqx_tpu_torch import __version__
from emqx_tpu_torch.types import Message

SYSDESCR = "emqx_tpu_torch — the PyTorch/CUDA port of the emqx_tpu broker"


class SysTopics:
    def __init__(self, broker, node: str = "emqx_tpu@127.0.0.1",
                 stats=None, interval: float = 60.0,
                 telemetry=None, tracing=None) -> None:
        self.broker = broker
        self.node = node
        self.stats = stats
        self.interval = interval
        self.telemetry = telemetry
        self.tracing = tracing
        self.started_at = time.time()

    def uptime(self) -> float:
        return time.time() - self.started_at

    def _pub(self, suffix: str, payload) -> None:
        if isinstance(payload, (dict, list)):
            payload = json.dumps(payload)
        if isinstance(payload, str):
            payload = payload.encode()
        self.broker.publish(Message(
            topic=f"$SYS/brokers/{self.node}/{suffix}",
            payload=payload, flags={"sys": True}))

    def heartbeat(self) -> None:
        """One tick: info + stats + metrics (the emqx_sys timer loop)."""
        self.broker.publish(Message(topic="$SYS/brokers",
                                    payload=self.node.encode(),
                                    flags={"sys": True}))
        self._pub("version", __version__)
        self._pub("uptime", str(int(self.uptime())))
        self._pub("datetime", time.strftime("%Y-%m-%d %H:%M:%S"))
        self._pub("sysdescr", SYSDESCR)
        if self.stats is not None:
            self.stats.tick()
            for k, v in self.stats.all().items():
                self._pub(f"stats/{k}", str(v))
        for k, v in self.broker.metrics.all().items():
            if v:
                self._pub(f"metrics/{k}", str(v))
        tel = self.telemetry
        if tel is not None and tel.enabled:
            # per-stage p50/p99 from the same sample rings the
            # Prometheus histograms read
            stages = {
                s: {"count": st["count"],
                    "p50_ms": round(st["p50_ms"], 3),
                    "p99_ms": round(st["p99_ms"], 3)}
                for s, st in tel.stage_stats().items() if st["count"]}
            self._pub("telemetry/stages", stages)
            self._pub("telemetry/slow",
                      {"count": tel.slow_total,
                       "threshold_ms": tel.config.slow_threshold_ms})
        trc = self.tracing
        if trc is not None and trc.config.enabled \
                and trc.config.slow_subs_enabled:
            # the slow-subscriber ranking, fleet-readable
            self._pub("slow_subs", [
                {"clientid": cid, "avg_ms": round(avg, 3),
                 "max_ms": round(mx, 3), "count": n}
                for cid, avg, mx, n, _last in trc.slow.top()])
