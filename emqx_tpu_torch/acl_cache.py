"""Per-connection ACL result cache with TTL + size bound
(reference: src/emqx_acl_cache.erl — pdict LRU-ish cache)."""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Optional


class AclCache:
    def __init__(self, max_size: int = 32, ttl: float = 60.0) -> None:
        self.max_size = max_size
        self.ttl = ttl
        self._d: "OrderedDict[Tuple[str, str], Tuple[str, float]]" = OrderedDict()

    def get(self, pubsub: str, topic: str) -> Optional[str]:
        key = (pubsub, topic)
        hit = self._d.get(key)
        if hit is None:
            return None
        result, ts = hit
        if self.ttl and time.time() - ts > self.ttl:
            del self._d[key]
            return None
        self._d.move_to_end(key)
        return result

    def put(self, pubsub: str, topic: str, result: str) -> None:
        key = (pubsub, topic)
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = (result, time.time())
        while len(self._d) > self.max_size:
            self._d.popitem(last=False)  # evict oldest

    def drain(self) -> None:
        self._d.clear()

    def __len__(self) -> int:
        return len(self._d)
