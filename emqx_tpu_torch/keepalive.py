"""Keepalive by byte-counter delta (reference: src/emqx_keepalive.erl).

The check passes if any bytes arrived since the last check; a
connection idle for a full interval is dead."""

from __future__ import annotations


class Keepalive:
    def __init__(self, interval: float) -> None:
        # MQTT spec: server closes after 1.5x the keepalive interval;
        # the reference checks at interval with a byte-delta
        self.interval = interval
        self.last_bytes = 0

    def check_interval(self) -> float:
        return self.interval * 1.5

    def check(self, recv_bytes: int) -> bool:
        """True = alive (progress since last check)."""
        ok = recv_bytes != self.last_bytes
        self.last_bytes = recv_bytes
        return ok
