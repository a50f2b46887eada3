"""Alarm management: activate/deactivate with history, hooks and a
``$SYS`` publication (reference: src/emqx_alarm.erl +
emqx_alarm_handler.erl; the port of the JAX package's module).

An alarm publishes ``$SYS/brokers/<node>/alarms/alert`` (or
``/clear``) through the broker, as the JAX package does when no
``$SYS`` heartbeat is wired, then runs the ``alarm.activated`` or
``alarm.deactivated`` hook.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from emqx_tpu_torch.types import Message


@dataclass
class Alarm:
    name: str
    details: dict = field(default_factory=dict)
    message: str = ""
    activated_at: float = field(default_factory=time.time)
    deactivated_at: Optional[float] = None

    @property
    def active(self) -> bool:
        return self.deactivated_at is None


class AlarmManager:
    def __init__(self, broker=None, node: str = "emqx_tpu@127.0.0.1",
                 history_size: int = 1000) -> None:
        self.broker = broker
        self.node = node
        self.history_size = history_size
        self._active: Dict[str, Alarm] = {}
        self._history: List[Alarm] = []

    def activate(self, name: str, details: Optional[dict] = None,
                 message: str = "") -> bool:
        if name in self._active:
            return False  # already_existed
        alarm = Alarm(name=name, details=details or {}, message=message)
        self._active[name] = alarm
        self._publish(alarm, "alert")
        return True

    def deactivate(self, name: str) -> bool:
        alarm = self._active.pop(name, None)
        if alarm is None:
            return False
        alarm.deactivated_at = time.time()
        self._history.append(alarm)
        del self._history[:-self.history_size]
        self._publish(alarm, "clear")
        return True

    def get_alarms(self, which: str = "all") -> List[Alarm]:
        if which == "activated":
            return list(self._active.values())
        if which == "deactivated":
            return list(self._history)
        return list(self._active.values()) + list(self._history)

    def delete_all_deactivated(self) -> None:
        self._history.clear()

    def _publish(self, alarm: Alarm, kind: str) -> None:
        if self.broker is None:
            return
        payload = json.dumps({
            "name": alarm.name, "message": alarm.message,
            "details": alarm.details,
            "activated_at": alarm.activated_at,
            "deactivated_at": alarm.deactivated_at,
        }).encode()
        topic = f"$SYS/brokers/{self.node}/alarms/{kind}"
        self.broker.publish(Message(topic=topic, payload=payload,
                                    flags={"sys": True}))
        self.broker.hooks.run(
            "alarm.activated" if kind == "alert" else "alarm.deactivated",
            (alarm,))
