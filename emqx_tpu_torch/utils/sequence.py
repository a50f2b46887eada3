"""Per-key monotonic counters.

Mirrors ``src/emqx_sequence.erl`` (nextval/reclaim over an ETS
table): the broker uses one to number a topic's subscribers so shard
assignment is stable (src/emqx_broker_helper.erl:94-100).
"""

from __future__ import annotations

from typing import Dict, Hashable


class Sequence:
    def __init__(self) -> None:
        self._vals: Dict[Hashable, int] = {}

    def nextval(self, key: Hashable) -> int:
        """Increment and return (1 on first call — the reference's
        update_counter semantics)."""
        v = self._vals.get(key, 0) + 1
        self._vals[key] = v
        return v

    def currval(self, key: Hashable) -> int:
        return self._vals.get(key, 0)

    def reclaim(self, key: Hashable) -> int:
        """Decrement; at zero the key is deleted (so an idle topic
        frees its counter)."""
        v = self._vals.get(key, 0) - 1
        if v <= 0:
            self._vals.pop(key, None)
            return 0
        self._vals[key] = v
        return v
