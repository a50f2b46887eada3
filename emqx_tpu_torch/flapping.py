"""Connect/disconnect flap detection → auto-ban.

The port of the JAX package's ``Flapping`` (reference:
src/emqx_flapping.erl: a threshold of state changes within a window
bans the clientid for ban_time). The reasons in
:data:`SERVER_INITIATED` are the ones the port's channel and
connection write into ``disconnect_reason``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from emqx_tpu_torch.banned import Banned


@dataclass
class FlappingConfig:
    max_count: int = 15          # disconnects within window
    window: float = 60.0         # seconds (detect_window)
    ban_time: float = 300.0      # seconds


@dataclass
class _Track:
    started: float = field(default_factory=time.time)
    count: int = 0


#: disconnect reasons the BROKER caused (drain redirect wave,
#: graceful node shutdown): they say nothing about the client's
#: stability, and counting them would let a rolling restart auto-ban
#: a well-behaved fleet — the ban replicates cluster-wide, so the
#: receiving peer would refuse the very reconnects the drain
#: redirected to it (regression-pinned by tests/test_torch_drain.py)
SERVER_INITIATED = frozenset({"drained", "server_shutdown"})


class Flapping:
    def __init__(self, banned: Optional[Banned] = None,
                 config: Optional[FlappingConfig] = None,
                 metrics=None) -> None:
        self.banned = banned
        self.config = config or FlappingConfig()
        self.metrics = metrics
        self._tracks: Dict[str, _Track] = {}

    def connected(self, clientid: str, peerhost: str = "") -> None:
        pass  # tracked on disconnect (reference counts state changes)

    def disconnected(self, clientid: str, peerhost: str = "",
                     reason: Optional[str] = None) -> None:
        if reason in SERVER_INITIATED:
            return
        now = time.time()
        t = self._tracks.get(clientid)
        if t is None or now - t.started > self.config.window:
            t = _Track(started=now)
            self._tracks[clientid] = t
        t.count += 1
        if t.count >= self.config.max_count:
            del self._tracks[clientid]
            if self.banned is not None:
                # atomic check-and-create: never DOWNGRADE an
                # existing longer/permanent ban (e.g. an operator
                # rule) — the auto-ban replicates with live-create
                # overwrite semantics, so a short flapping ban would
                # replace it cluster-wide. The compare lives inside
                # Banned under its lock (a permanent ban applied
                # between a look_up and a create must win).
                self.banned.create_unless_outlasted(
                    "clientid", clientid, by="flapping",
                    reason=f"flapping: {t.count} in {self.config.window}s",
                    duration=self.config.ban_time)

    def gc(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        for cid in [c for c, t in self._tracks.items()
                    if now - t.started > self.config.window]:
            del self._tracks[cid]
