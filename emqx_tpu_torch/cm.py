"""Connection manager: the channel registry (``src/emqx_cm.erl``).

Only the registry the ported paths read: a clientid maps to its live
channel, and a channel holds its ``.session``. Opening sessions,
takeover, wills and session expiry come with the channel.
"""

from __future__ import annotations

from typing import Dict


class ConnectionManager:
    def __init__(self, broker=None) -> None:
        self.broker = broker
        self._channels: Dict[str, object] = {}   # clientid -> live channel

    def register_channel(self, client_id: str, channel) -> None:
        self._channels[client_id] = channel

    def unregister_channel(self, client_id: str, channel=None) -> None:
        cur = self._channels.get(client_id)
        if channel is None or cur is channel:
            self._channels.pop(client_id, None)

    def lookup_channel(self, client_id: str):
        return self._channels.get(client_id)

    def connection_count(self) -> int:
        return len(self._channels)

    def session_count(self) -> int:
        """Sessions held: one per live channel (no detached sessions
        until takeover is ported)."""
        return len(self._channels)
