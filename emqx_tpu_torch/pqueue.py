"""Priority queue with integer priorities and a plain-FIFO fast path.

Mirrors ``src/emqx_pqueue.erl``: priority 0 is the fallback plain
queue; higher numbers dequeue first; ``inf`` is the highest. The
reference uses a skew heap over Okasaki queues — here a dict of
deques keyed by priority, the highest found on demand (priorities are
few)."""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, Optional, Tuple


class PQueue:
    def __init__(self) -> None:
        self._qs: Dict[float, deque] = {}
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def is_empty(self) -> bool:
        return self._len == 0

    def plen(self, priority: float) -> int:
        q = self._qs.get(priority)
        return len(q) if q else 0

    def push(self, item: Any, priority: float = 0) -> None:
        self._qs.setdefault(priority, deque()).append(item)
        self._len += 1

    def pop(self, priority: Optional[float] = None) -> Tuple[bool, Any]:
        """Pop from ``priority``'s queue, or the highest non-empty one.
        Returns (found, item)."""
        if self._len == 0:
            return False, None
        if priority is None:
            priority = max(p for p, q in self._qs.items() if q)
        q = self._qs.get(priority)
        if not q:
            return False, None
        item = q.popleft()
        self._len -= 1
        if not q:
            del self._qs[priority]
        return True, item

    def peek(self) -> Tuple[bool, Any]:
        if self._len == 0:
            return False, None
        p = max(p for p, q in self._qs.items() if q)
        return True, self._qs[p][0]

    def to_list(self) -> list:
        out = []
        for p in sorted(self._qs, reverse=True):
            out.extend(self._qs[p])
        return out
