"""Config zones: named bundles of per-listener/per-connection settings.

The port of the JAX package's ``Zone`` (``src/emqx_zone.erl`` + the
zone sections of etc/emqx.conf): a zone snapshot is read lock-free by
every connection. Defaults follow etc/emqx.conf:698-907, the forced-GC
policy included, with the ban check on every CONNECT and flapping
detection off. The registry below is this package's own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class Zone:
    name: str = "default"
    # connection
    idle_timeout: float = 15.0
    max_packet_size: int = 1024 * 1024
    max_clientid_len: int = 65535
    max_topic_levels: int = 0          # 0 = unlimited
    max_topic_alias: int = 65535
    max_qos_allowed: int = 2
    retain_available: bool = True
    wildcard_subscription: bool = True
    shared_subscription: bool = True
    server_keepalive: Optional[int] = None
    # the keepalive check's backoff factor, and per-zone stats: read by
    # no code path in either package, kept so one config file parses
    # in both
    keepalive_backoff: float = 0.75
    # session
    max_subscriptions: int = 0
    upgrade_qos: bool = False
    max_inflight: int = 32
    retry_interval: float = 30.0
    max_awaiting_rel: int = 100
    await_rel_timeout: float = 300.0
    session_expiry_interval: float = 7200.0
    max_mqueue_len: int = 1000
    mqueue_priorities: Optional[Dict[str, int]] = None
    mqueue_default_priority: float = 0
    mqueue_store_qos0: bool = True
    # auth/acl
    allow_anonymous: bool = True
    acl_nomatch: str = "allow"          # allow | deny
    # what an ACL deny does to the connection: "ignore" answers with
    # the reason code, "disconnect" drops the client
    # (etc/emqx.conf:617, src/emqx_channel.erl:372,470)
    acl_deny_action: str = "ignore"     # ignore | disconnect
    enable_acl: bool = True
    # skip the client.authenticate hook chain for this zone (internal
    # listeners; src/emqx_access_control.erl:37-41)
    bypass_auth_plugins: bool = False
    # CONNECT enrichment: the username becomes the clientid
    # (src/emqx_channel.erl:1385-1389)
    use_username_as_clientid: bool = False
    # v3/v4 subscriptions get nl=1 so a client never receives its own
    # publishes (v5 clients set nl themselves;
    # src/emqx_channel.erl:1386-1390 enrich_subopts)
    ignore_loop_deliver: bool = False
    # v5 Response-Information returned when the client CONNECTs with
    # Request-Response-Information=1 (src/emqx_channel.erl:1432-1437)
    response_information: str = ""
    # Deliberately NOT knobs (the full emqx_zone accessor sweep,
    # round 4): `strict_mode` — the wire codec here validates UTF-8,
    # reserved header bits and packet ids UNCONDITIONALLY
    # (mqtt/frame.py; the reference only does so when strict_mode is
    # set, src/emqx_frame.erl:92-94,215), so a knob would only add a
    # lax mode nothing wants; `force_shutdown_policy` — per-process
    # queue/heap kill thresholds assume BEAM-style per-process heaps;
    # the analogues here are the bounded per-session mqueue
    # (max_mqueue_len), the bytes/msgs limiters above, and the
    # host-level watermark alarms.
    # the ban check on CONNECT (banned.py) and flap detection on
    # disconnect (flapping.py)
    enable_ban: bool = True
    enable_flapping_detect: bool = False
    enable_stats: bool = True
    mountpoint: Optional[str] = None
    # rate limits (None = unlimited): (rate/sec, burst)
    ratelimit_msg_in: Optional[tuple] = None
    ratelimit_bytes_in: Optional[tuple] = None
    quota_conn_messages: Optional[tuple] = None
    # slow-consumer guard (reference listener.*.send_timeout +
    # send_timeout_close): once the transport write buffer crosses
    # high_watermark, the peer has send_timeout seconds to drain it
    # or the connection closes (0 disables)
    send_timeout: float = 15.0
    send_timeout_close: bool = True
    high_watermark: int = 1024 * 1024
    # forced-GC trigger (count, bytes), None disables
    # (etc/emqx.conf force_gc_policy, src/emqx_gc.erl)
    force_gc_policy: Optional[tuple] = (16000, 16 * 1024 * 1024)


_zones: Dict[str, Zone] = {}


def get_zone(name: str = "default") -> Zone:
    z = _zones.get(name)
    if z is None:
        z = Zone(name=name)
        _zones[name] = z
    return z


def set_zone(zone: Zone) -> None:
    _zones[zone.name] = zone


def force_reload() -> None:
    _zones.clear()
