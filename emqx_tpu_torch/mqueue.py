"""Session message queue with per-topic priorities and bounded length.

Mirrors ``src/emqx_mqueue.erl`` (record at :94-102, ``in/2`` at
:148-168): QoS0 messages are dropped unless ``store_qos0``; when a
priority class reaches ``max_len`` the *oldest message of that class*
is dropped (drop-oldest, not drop-new); ``max_len == 0`` means
unbounded. No disk persistence by design (the reference documents the
same, emqx_mqueue.erl:20-25).
"""

from __future__ import annotations

from typing import Dict, Optional

from emqx_tpu_torch.pqueue import PQueue
from emqx_tpu_torch.types import QOS_0, Message

MAX_LEN_INFINITY = 0


class MQueue:
    def __init__(
        self,
        max_len: int = MAX_LEN_INFINITY,
        store_qos0: bool = False,
        priorities: Optional[Dict[str, int]] = None,
        default_priority: float = 0,
    ) -> None:
        self.max_len = max_len if isinstance(max_len, int) and max_len > 0 else 0
        self.store_qos0 = store_qos0
        self.p_table = priorities
        self.default_p = default_priority
        self.dropped = 0
        self._len = 0
        self._q = PQueue()

    def __len__(self) -> int:
        return self._len

    def is_empty(self) -> bool:
        return self._len == 0

    def _priority(self, topic: str) -> float:
        # no priority table -> always lowest (the reference's
        # micro-optimization, emqx_mqueue.erl:196-200)
        if not self.p_table:
            return 0
        return self.p_table.get(topic, self.default_p)

    def push(self, msg: Message) -> Optional[Message]:
        """Enqueue; returns the dropped message if any (the new one
        for unstored QoS0, the class-oldest when full)."""
        if msg.qos == QOS_0 and not self.store_qos0:
            return msg
        prio = self._priority(msg.topic)
        if self.max_len != 0 and self._q.plen(prio) >= self.max_len:
            _, dropped = self._q.pop(prio)
            self._q.push(msg, prio)
            self.dropped += 1
            return dropped
        self._q.push(msg, prio)
        self._len += 1
        return None

    def pop(self) -> Optional[Message]:
        if self._len == 0:
            return None
        found, msg = self._q.pop()
        if found:
            self._len -= 1
            return msg
        return None

    def info(self) -> dict:
        return {"store_qos0": self.store_qos0, "max_len": self.max_len,
                "len": self._len, "dropped": self.dropped}

    # -- serialization (session to_wire / durability checkpoints) ---------

    def snapshot(self):
        """Per-priority FIFO contents, order-preserving:
        ``[(priority, [Message, ...]), ...]`` — pure data, encodable
        by the wire codec."""
        return [(p, list(q)) for p, q in self._q._qs.items()]

    def restore(self, items) -> None:
        """Refill from :meth:`snapshot` output (onto an empty queue;
        bypasses the QoS0/length policies — the messages already
        passed them when first enqueued)."""
        for prio, msgs in items:
            for msg in msgs:
                self._q.push(msg, prio)
                self._len += 1
