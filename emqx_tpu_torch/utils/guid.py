"""128-bit time-ordered global unique message ids.

Mirrors the reference's GUID layout (src/emqx_guid.erl:1-150): 64-bit
microsecond timestamp | node/pid entropy | per-process sequence. Ids
are monotonically increasing per generator, unique across generators.
"""

from __future__ import annotations

import os
import threading
import time

_lock = threading.Lock()
_seq = 0
_last_ts = 0
_node_bits = (os.getpid() & 0xFFFF) << 16 | (
    int.from_bytes(os.urandom(2), "big"))


def new_guid() -> int:
    """A 128-bit int: ts_us(64) | node+pid entropy(32) | seq(32).

    Monotonic per generator: the timestamp is read and clamped UNDER
    the lock — a wall-clock step backwards holds the last timestamp
    rather than emitting a smaller id, and no interleaving can pair
    an older ts with a newer seq. This clamp deliberately STRENGTHENS
    the reference (src/emqx_guid.erl takes a fresh erlang:system_time
    per call with no last-ts guard, so its ids are only
    timestamp-ordered while the clock is): same layout and ordering
    intent, stronger guarantee under clock steps."""
    global _seq, _last_ts
    with _lock:
        ts = int(time.time() * 1_000_000)
        if ts < _last_ts:
            ts = _last_ts  # clock stepped back: hold, stay monotonic
        _seq = (_seq + 1) & 0xFFFFFFFF
        if _seq == 0:
            # seq wrapped: advance the timestamp so the (ts, seq)
            # pair can never repeat under a held clock (the reference
            # advances ts on sequence exhaustion the same way)
            ts += 1
        _last_ts = ts
        seq = _seq
    return (ts << 64) | (_node_bits << 32) | seq


def guid_timestamp(guid: int) -> float:
    """Microsecond timestamp embedded in a guid, as seconds."""
    return (guid >> 64) / 1_000_000
