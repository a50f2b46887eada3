"""Broker counters of the publish path (a minimal ``emqx_metrics``).

Only the counter names the single-GPU publish → match → dispatch path
increments are registered; an unknown name raises ``KeyError``, as the
JAX package's registry does.
"""

from __future__ import annotations

from typing import Dict

NAMES = (
    "messages.received",
    "messages.qos0.received", "messages.qos1.received",
    "messages.qos2.received",
    "messages.publish", "messages.retained",
    "messages.dropped", "messages.dropped.no_subscribers",
    "messages.delivered",
    "delivery.dropped", "delivery.dropped.no_local",
)

_QOS_RECV = ("messages.qos0.received", "messages.qos1.received",
             "messages.qos2.received")


class Metrics:
    def __init__(self) -> None:
        self._counters: Dict[str, int] = dict.fromkeys(NAMES, 0)

    def inc(self, name: str, n: int = 1) -> None:
        self._counters[name] += n

    def inc_msg(self, msg) -> None:
        """Count an inbound message by QoS."""
        self.inc("messages.received")
        self.inc(_QOS_RECV[min(msg.qos, 2)])

    def val(self, name: str) -> int:
        return self._counters[name]

    def all(self) -> Dict[str, int]:
        return dict(self._counters)
