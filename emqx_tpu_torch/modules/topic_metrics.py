"""Per-topic in/out/dropped counters with rate EMA.

The port of the JAX package's ``TopicMetricsModule`` (reference:
src/emqx_mod_topic_metrics.erl): up to :data:`MAX_TOPICS` literal
topics, counted on 'message.publish' after the rewrites (priority
-100), 'message.dropped' and 'message.delivered'.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from emqx_tpu_torch import topic as T
from emqx_tpu_torch.modules import Module
from emqx_tpu_torch.types import Message

METRICS = ["messages.in", "messages.out", "messages.qos0.in",
           "messages.qos1.in", "messages.qos2.in", "messages.dropped"]
MAX_TOPICS = 512


class _Counters(dict):
    def __init__(self):
        super().__init__({m: 0 for m in METRICS})
        self.created = time.time()
        self._rate: Dict[str, float] = {}
        self._last: Dict[str, tuple] = {}

    def rate(self, metric: str) -> float:
        now = time.time()
        last_v, last_t = self._last.get(metric, (0, self.created))
        dt = max(now - last_t, 1e-9)
        inst = (self[metric] - last_v) / dt
        # exponential moving average (reference's speed calc)
        ema = self._rate.get(metric, 0.0) * 0.7 + inst * 0.3
        self._rate[metric] = ema
        self._last[metric] = (self[metric], now)
        return ema


class TopicMetricsModule(Module):
    name = "topic_metrics"

    def __init__(self, node) -> None:
        super().__init__(node)
        self._topics: Dict[str, _Counters] = {}

    def load(self, env: dict) -> None:
        for t in env.get("topics", []):
            self.register(t)
        self.node.hooks.add("message.publish", self.on_publish,
                            priority=-100)  # after rewrites
        self.node.hooks.add("message.dropped", self.on_dropped)
        self.node.hooks.add("message.delivered", self.on_delivered)

    def unload(self) -> None:
        self.node.hooks.delete("message.publish", self.on_publish)
        self.node.hooks.delete("message.dropped", self.on_dropped)
        self.node.hooks.delete("message.delivered", self.on_delivered)
        self._topics.clear()

    def register(self, topic: str) -> bool:
        if T.wildcard(topic):
            raise ValueError("wildcard topic not allowed")
        if len(self._topics) >= MAX_TOPICS:
            return False
        self._topics.setdefault(topic, _Counters())
        return True

    def unregister(self, topic: str) -> None:
        self._topics.pop(topic, None)

    def on_publish(self, msg: Message):
        c = self._topics.get(msg.topic)
        if c is not None:
            c["messages.in"] += 1
            c[f"messages.qos{min(msg.qos, 2)}.in"] += 1
        return None

    def on_dropped(self, msg: Message, reason: str):
        c = self._topics.get(msg.topic)
        if c is not None:
            c["messages.dropped"] += 1

    def on_delivered(self, msg: Message, n: int):
        self.inc_out(msg.topic, n)

    def inc_out(self, topic: str, n: int = 1) -> None:
        c = self._topics.get(topic)
        if c is not None:
            c["messages.out"] += n

    def metrics(self, topic: str) -> Optional[dict]:
        c = self._topics.get(topic)
        return dict(c) if c is not None else None

    def rates(self, topic: str) -> Optional[dict]:
        c = self._topics.get(topic)
        if c is None:
            return None
        return {m: c.rate(m) for m in METRICS}

    def all_topics(self):
        return list(self._topics)
