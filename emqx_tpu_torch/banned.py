"""Ban list: clientid / username / peerhost with expiry.

The port of the JAX package's ``Banned`` (reference:
src/emqx_banned.erl — a Mnesia table with an expiry timer). On a
clustered node :class:`~emqx_tpu_torch.cluster.Cluster` wraps
``create``, ``delete`` and ``create_unless_outlasted`` so the table
replicates.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass
class BanRule:
    who: Tuple[str, str]           # ("clientid"|"username"|"peerhost", value)
    by: str = "admin"
    reason: str = ""
    at: float = field(default_factory=time.time)
    until: Optional[float] = None  # None = forever


class Banned:
    """Writers arrive from the serving loop (CLI/flapping), the
    housekeeping task, AND — with a socket cluster — the transport IO
    thread (replicated ban applies), so the table takes a lock; the
    check() hot path holds it only for dict probes."""

    def __init__(self) -> None:
        self._rules: Dict[Tuple[str, str], BanRule] = {}
        self._lock = threading.Lock()

    def create(self, kind: str, value: str, by: str = "admin",
               reason: str = "", duration: Optional[float] = None) -> BanRule:
        if kind not in ("clientid", "username", "peerhost"):
            raise ValueError(f"bad ban kind: {kind}")
        until = time.time() + duration if duration is not None else None
        rule = BanRule(who=(kind, value), by=by, reason=reason, until=until)
        with self._lock:
            self._rules[rule.who] = rule
        return rule

    @staticmethod
    def _outlasts(a: Optional[float], b: Optional[float]) -> bool:
        """Does expiry ``a`` last at least as long as ``b``?
        (None = forever.)"""
        return a is None or (b is not None and a >= b)

    def apply(self, kind: str, value: str, by: str, reason: str,
              until: Optional[float], overwrite: bool = False) -> None:
        """Install a replicated rule with an absolute expiry.

        ``overwrite=True`` is a LIVE create relayed from a peer: it
        replaces whatever is here, exactly as the originating node's
        own create() did — otherwise tables diverge (an operator
        shortening a ban must win everywhere). ``overwrite=False`` is
        a join-time table sync: longest-ban-wins merge, so a stale
        short ban from one member never clobbers another member's
        permanent rule."""
        if until is not None and time.time() > until:
            # expired in transit (broadcast delay / clock skew). An
            # overwrite must still take effect as a DELETE — the
            # originator's table expires the rule too; a no-op here
            # would leave this node holding the replaced rule forever.
            # Direct pop, NOT self.delete: on a clustered node that
            # attribute is the replicating wrapper, and a receive
            # path must never re-broadcast (ping-pong / concurrent-
            # create deletion)
            if overwrite:
                with self._lock:
                    self._rules.pop((kind, value), None)
            return
        with self._lock:
            cur = self._rules.get((kind, value))
            if not overwrite and cur is not None \
                    and self._outlasts(cur.until, until):
                return
            self._rules[(kind, value)] = BanRule(
                who=(kind, value), by=by, reason=reason, until=until)

    def create_unless_outlasted(self, kind: str, value: str,
                                by: str = "auto", reason: str = "",
                                duration: Optional[float] = None
                                ) -> Optional[BanRule]:
        """Atomic check-and-create for AUTO bans (flapping): installs
        only if no existing rule outlasts the new one — the compare
        must live under the table lock, or a permanent operator ban
        applied between a caller's look_up and create would still be
        overwritten (and the downgrade would replicate)."""
        until = time.time() + duration if duration is not None else None
        with self._lock:
            cur = self._rules.get((kind, value))
            if cur is not None and self._outlasts(cur.until, until):
                return None
            rule = BanRule(who=(kind, value), by=by, reason=reason,
                           until=until)
            self._rules[rule.who] = rule
        return rule

    def delete(self, kind: str, value: str) -> None:
        with self._lock:
            self._rules.pop((kind, value), None)

    def look_up(self, kind: str, value: str) -> Optional[BanRule]:
        with self._lock:
            return self._rules.get((kind, value))

    def check(self, clientid: str = "", username: Optional[str] = None,
              peerhost: str = "") -> bool:
        """True if any identity facet is banned (emqx_banned:check/1)."""
        now = time.time()
        for who in (("clientid", clientid), ("username", username or ""),
                    ("peerhost", peerhost)):
            with self._lock:
                rule = self._rules.get(who)
                if rule is not None and rule.until is not None \
                        and now > rule.until:
                    # lazy expiry — re-checked under the lock so a
                    # concurrent refreshed ban is never deleted
                    del self._rules[who]
                    rule = None
            if rule is not None:
                return True
        return False

    def expire(self, now: Optional[float] = None) -> int:
        now = time.time() if now is None else now
        with self._lock:
            dead = [w for w, r in self._rules.items()
                    if r.until is not None and now > r.until]
            for w in dead:
                del self._rules[w]
        return len(dead)

    def info(self) -> list:
        with self._lock:
            return list(self._rules.values())
