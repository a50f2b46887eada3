"""QoS1/2 in-flight window, insertion-keyed by packet id.

Mirrors ``src/emqx_inflight.erl`` (gb_trees + max-size bound):
insert/update/delete/lookup plus the size/full tests the session's
delivery window logic depends on. ``max_size == 0`` means unbounded.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple


class KeyExists(KeyError):
    pass


class Inflight:
    def __init__(self, max_size: int = 32) -> None:
        self.max_size = max_size
        self._d: Dict[int, Any] = {}

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: int) -> bool:
        return key in self._d

    def is_empty(self) -> bool:
        return not self._d

    def is_full(self) -> bool:
        return self.max_size != 0 and len(self._d) >= self.max_size

    def insert(self, key: int, value: Any) -> None:
        if key in self._d:
            raise KeyExists(key)
        self._d[key] = value

    def update(self, key: int, value: Any) -> None:
        if key not in self._d:
            raise KeyError(key)
        self._d[key] = value

    def delete(self, key: int) -> None:
        del self._d[key]

    def lookup(self, key: int) -> Optional[Any]:
        return self._d.get(key)

    def to_list(self, sort_key=None) -> List[Tuple[int, Any]]:
        items = list(self._d.items())
        if sort_key is not None:
            items.sort(key=sort_key)
        return items

    def keys(self) -> List[int]:
        return list(self._d)

    def window(self) -> List[int]:
        return self.keys()

    # -- serialization (session to_wire / durability checkpoints) ---------

    def restore(self, items: List[Tuple[int, Any]]) -> None:
        """Refill from :meth:`to_list` output (onto an empty window;
        insertion order preserved so retry/replay scan order
        survives a restart)."""
        for key, value in items:
            self.insert(key, value)
