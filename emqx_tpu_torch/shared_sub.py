"""Shared (``$share/<group>``) subscription dispatch.

Mirrors ``src/emqx_shared_sub.erl``: one subscriber per group receives
each message, picked by strategy — ``random`` / ``round_robin`` /
``sticky`` / ``hash`` (do_pick_subscriber/5:258-275); failed delivery
redispatches to remaining members (dispatch/4:112-125); ``$queue`` is
the group named "$queue". Per-(group, topic) round-robin counters and
sticky picks are host state (the reference keeps them in the process
dictionary, :269-275 — per-node state, not replicated).
"""

from __future__ import annotations

import random as _random
import zlib
from typing import Dict, List, Optional, Tuple

STRATEGIES = ("random", "round_robin", "sticky", "hash")


class SharedSub:
    def __init__(self, strategy: str = "round_robin") -> None:
        assert strategy in STRATEGIES, strategy
        self.strategy = strategy
        # (group, topic) -> [subscriber, ...] in subscription order
        self._subs: Dict[Tuple[str, str], List[object]] = {}
        self._rr: Dict[Tuple[str, str], int] = {}
        self._sticky: Dict[Tuple[str, str], object] = {}
        self._rng = _random.Random()

    def subscribe(self, group: str, topic: str, sub: object) -> None:
        members = self._subs.setdefault((group, topic), [])
        if sub not in members:
            members.append(sub)

    def unsubscribe(self, group: str, topic: str, sub: object) -> None:
        key = (group, topic)
        members = self._subs.get(key)
        if members and sub in members:
            members.remove(sub)
            if not members:
                self._subs.pop(key, None)
                self._rr.pop(key, None)
        if self._sticky.get(key) is sub:
            self._sticky.pop(key, None)

    def subscriber_down(self, sub: object) -> None:
        for key in list(self._subs):
            self.unsubscribe(key[0], key[1], sub)

    def subscribers(self, group: str, topic: str) -> List[object]:
        return list(self._subs.get((group, topic), ()))

    def groups(self, topic: str) -> List[str]:
        return [g for (g, t) in self._subs if t == topic]

    # -- dispatch ---------------------------------------------------------

    def dispatch(self, group: str, topic: str, msg,
                 deliver=None) -> int:
        """Deliver ``msg`` to one member; redispatch to the rest on
        failure (emqx_shared_sub:dispatch/4). ``deliver(sub)`` returns
        truthy on success; default calls ``sub.deliver(topic, msg)``.
        Returns number of successful deliveries (0 or 1)."""
        if deliver is None:
            def deliver(sub):  # noqa: E731 — default delivery fn
                sub.deliver(topic, msg)
                return True
        failed: List[object] = []
        while True:
            sub = self._pick(group, topic, getattr(msg, "from_", None), failed)
            if sub is None:
                return 0
            try:
                if deliver(sub):
                    return 1
            except Exception:
                pass
            failed.append(sub)

    def _pick(self, group: str, topic: str, sender: Optional[str],
              failed: List[object]) -> Optional[object]:
        key = (group, topic)
        members = self._subs.get(key, [])
        avail = [s for s in members if s not in failed]
        if not avail:
            return None
        if self.strategy == "sticky":
            cur = self._sticky.get(key)
            if cur is not None and cur in avail:
                return cur
            pick = self._rng.choice(avail)
            self._sticky[key] = pick
            return pick
        if self.strategy == "random":
            return self._rng.choice(avail)
        if self.strategy == "hash":
            h = zlib.crc32(str(sender).encode()) if sender else 0
            return avail[h % len(avail)]
        # round_robin over the full member list, skipping failed
        n = self._rr.get(key, -1)
        for _ in range(len(members)):
            n = (n + 1) % len(members)
            if members[n] not in failed:
                self._rr[key] = n
                return members[n]
        return None
