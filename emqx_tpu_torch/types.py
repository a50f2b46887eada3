"""Core record types shared across layers.

Mirrors the reference records in ``include/emqx.hrl``: ``#message{}``
(lines 57-76), ``#delivery{}`` (78-81), ``#route{}`` (87-90) and the
subscription options map of ``emqx_types`` (src/emqx_types.erl).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from emqx_tpu_torch.utils.guid import new_guid

QOS_0 = 0
QOS_1 = 1
QOS_2 = 2


@dataclass
class Message:
    """A routable message (include/emqx.hrl:57-76)."""

    topic: str
    payload: bytes = b""
    qos: int = QOS_0
    from_: str = "undefined"          # publisher clientid
    flags: Dict[str, bool] = field(default_factory=dict)   # sys/dup/retain
    headers: Dict[str, Any] = field(default_factory=dict)  # proto_ver, props, ...
    id: int = field(default_factory=new_guid)
    timestamp: float = field(default_factory=time.time)

    def copy(self) -> "Message":
        """Shallow copy with independent flags/headers dicts — for per-wire
        mutation (unmount, expiry rewrite) without corrupting the
        inflight/mqueue-retained original."""
        return Message(
            topic=self.topic, payload=self.payload, qos=self.qos,
            from_=self.from_, flags=dict(self.flags),
            headers={k: (dict(v) if isinstance(v, dict) else v)
                     for k, v in self.headers.items()},
            id=self.id, timestamp=self.timestamp)

    def get_flag(self, name: str, default: bool = False) -> bool:
        return self.flags.get(name, default)

    def set_flag(self, name: str, val: bool = True) -> "Message":
        self.flags[name] = val
        return self

    def get_header(self, name: str, default=None):
        return self.headers.get(name, default)

    def set_header(self, name: str, val) -> "Message":
        self.headers[name] = val
        return self

    def is_sys(self) -> bool:
        return self.get_flag("sys") or self.topic.startswith("$SYS/")

    def is_expired(self) -> bool:
        interval = (self.headers.get("properties") or {}).get(
            "Message-Expiry-Interval")
        if interval is None:
            return False
        return time.time() - self.timestamp > interval

    def update_expiry(self) -> "Message":
        """Shrink Message-Expiry-Interval by elapsed time on delivery
        (reference emqx_message:update_expiry/1)."""
        props = self.headers.get("properties") or {}
        interval = props.get("Message-Expiry-Interval")
        if interval is not None:
            elapsed = max(0, int(time.time() - self.timestamp))
            props = dict(props)
            props["Message-Expiry-Interval"] = max(1, interval - elapsed)
            self.headers["properties"] = props
        return self


@dataclass
class Delivery:
    """A message en-route from a publisher (include/emqx.hrl:78-81)."""

    sender: str
    message: Message


@dataclass(frozen=True)
class Route:
    """topic filter → destination node or (group, node)
    (include/emqx.hrl:87-90)."""

    topic: str
    dest: Any = "local"


@dataclass
class SubOpts:
    """Subscription options (MQTT v5 + EMQX extensions)."""

    qos: int = QOS_0
    nl: int = 0            # no-local
    rap: int = 0           # retain-as-published
    rh: int = 0            # retain-handling
    share: Optional[str] = None
    subid: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        d = {"qos": self.qos, "nl": self.nl, "rap": self.rap, "rh": self.rh}
        if self.share is not None:
            d["share"] = self.share
        if self.subid is not None:
            d["subid"] = self.subid
        return d
