"""Task-monitor dictionary.

Mirrors ``src/emqx_pmon.erl`` (process-monitor refs with batch
erase): the broker monitors subscriber processes so their table
entries can be cleaned in batch when they die. Here the monitored
unit is an asyncio task (or any object with ``add_done_callback``);
the owner drains finished items and erases them in one pass — the
``demonitor/erase_all`` shape the cleanup pools rely on
(src/emqx_broker_helper.erl:134-139, src/emqx_cm.erl:396-400).
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List, Optional, Tuple

_MISSING = object()


class PMon:
    def __init__(self) -> None:
        self._items: Dict[Hashable, Any] = {}
        self._down: List[Hashable] = []

    def monitor(self, key: Hashable, val: Any = None,
                task=None) -> None:
        """Watch ``key``; if ``task`` is given its completion queues
        the key as down."""
        self._items[key] = val
        if task is not None:
            # bind the monitored generation: a stale task's callback
            # must not queue a key that was re-registered since (e.g.
            # client reconnected between old-task death and callback)
            task.add_done_callback(
                lambda _t, k=key, v=val: self._mark_down(k, v))

    def _mark_down(self, key: Hashable, val: Any = _MISSING) -> None:
        if key not in self._items:
            return
        if val is not _MISSING and self._items[key] is not val:
            return  # entry was re-registered; the down is stale
        self._down.append(key)

    def notify_down(self, key: Hashable) -> None:
        """Explicit down signal (no task attached)."""
        self._mark_down(key)

    def demonitor(self, key: Hashable) -> None:
        self._items.pop(key, None)

    def find(self, key: Hashable) -> Optional[Any]:
        return self._items.get(key)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._items

    def count(self) -> int:
        return len(self._items)

    def erase_all(self) -> List[Tuple[Hashable, Any]]:
        """Drain queued downs in one batch: [(key, val)] of entries
        erased (emqx_pmon:erase_all/2)."""
        out = []
        for key in self._down:
            if key in self._items:
                out.append((key, self._items.pop(key)))
        self._down.clear()
        return out
