"""MQTT v5 property table: ids, names, wire types, packet validity.

Mirrors ``src/emqx_mqtt_props.erl`` (id/name table :30-120, packet
filter, validation). Properties travel as ``{Name: value}`` dicts;
``User-Property`` is a list of (key, value) pairs.
"""

from __future__ import annotations

from typing import Dict, Tuple

from emqx_tpu_torch.mqtt import constants as C

# id -> (name, wire_type, allowed packet types)
BYTE = "byte"
TWO_BYTE = "two_byte"
FOUR_BYTE = "four_byte"
VARINT = "varint"
BINARY = "binary"
UTF8 = "utf8"
UTF8_PAIR = "utf8_pair"

_ALL = None  # allowed anywhere

PROPS: Dict[int, Tuple[str, str, object]] = {
    0x01: ("Payload-Format-Indicator", BYTE, {C.PUBLISH}),
    0x02: ("Message-Expiry-Interval", FOUR_BYTE, {C.PUBLISH}),
    0x03: ("Content-Type", UTF8, {C.PUBLISH}),
    0x08: ("Response-Topic", UTF8, {C.PUBLISH}),
    0x09: ("Correlation-Data", BINARY, {C.PUBLISH}),
    0x0B: ("Subscription-Identifier", VARINT, {C.PUBLISH, C.SUBSCRIBE}),
    0x11: ("Session-Expiry-Interval", FOUR_BYTE,
           {C.CONNECT, C.CONNACK, C.DISCONNECT}),
    0x12: ("Assigned-Client-Identifier", UTF8, {C.CONNACK}),
    0x13: ("Server-Keep-Alive", TWO_BYTE, {C.CONNACK}),
    0x15: ("Authentication-Method", UTF8, {C.CONNECT, C.CONNACK, C.AUTH}),
    0x16: ("Authentication-Data", BINARY, {C.CONNECT, C.CONNACK, C.AUTH}),
    0x17: ("Request-Problem-Information", BYTE, {C.CONNECT}),
    0x18: ("Will-Delay-Interval", FOUR_BYTE, {C.CONNECT}),
    0x19: ("Request-Response-Information", BYTE, {C.CONNECT}),
    0x1A: ("Response-Information", UTF8, {C.CONNACK}),
    0x1C: ("Server-Reference", UTF8, {C.CONNACK, C.DISCONNECT}),
    0x1F: ("Reason-String", UTF8, _ALL),
    0x21: ("Receive-Maximum", TWO_BYTE, {C.CONNECT, C.CONNACK}),
    0x22: ("Topic-Alias-Maximum", TWO_BYTE, {C.CONNECT, C.CONNACK}),
    0x23: ("Topic-Alias", TWO_BYTE, {C.PUBLISH}),
    0x24: ("Maximum-QoS", BYTE, {C.CONNACK}),
    0x25: ("Retain-Available", BYTE, {C.CONNACK}),
    0x26: ("User-Property", UTF8_PAIR, _ALL),
    0x27: ("Maximum-Packet-Size", FOUR_BYTE, {C.CONNECT, C.CONNACK}),
    0x28: ("Wildcard-Subscription-Available", BYTE, {C.CONNACK}),
    0x29: ("Subscription-Identifier-Available", BYTE, {C.CONNACK}),
    0x2A: ("Shared-Subscription-Available", BYTE, {C.CONNACK}),
}

NAME_TO_ID = {name: pid for pid, (name, _t, _p) in PROPS.items()}
NAME_TO_TYPE = {name: t for _pid, (name, t, _p) in PROPS.items()}


def prop_id(name: str) -> int:
    return NAME_TO_ID[name]


def prop_name(pid: int) -> str:
    return PROPS[pid][0]


def validate(props: dict, packet_type: int | None = None) -> None:
    """Raise ValueError on unknown names, wrong value types, or
    properties not allowed for the packet type."""
    for name, val in props.items():
        pid = NAME_TO_ID.get(name)
        if pid is None:
            raise ValueError(f"bad_property: {name}")
        pname, ptype, allowed = PROPS[pid]
        if packet_type is not None and allowed is not None \
                and packet_type not in allowed:
            raise ValueError(f"property_not_allowed: {name}")
        if ptype in (BYTE, TWO_BYTE, FOUR_BYTE, VARINT):
            if not isinstance(val, int) or val < 0:
                raise ValueError(f"bad_property_value: {name}={val!r}")
        elif ptype == UTF8:
            if not isinstance(val, str):
                raise ValueError(f"bad_property_value: {name}={val!r}")
        elif ptype == BINARY:
            if not isinstance(val, (bytes, bytearray)):
                raise ValueError(f"bad_property_value: {name}={val!r}")
        elif ptype == UTF8_PAIR:
            if not isinstance(val, list) or not all(
                    isinstance(p, tuple) and len(p) == 2 for p in val):
                raise ValueError(f"bad_property_value: {name}={val!r}")


def filter_for(packet_type: int, props: dict) -> dict:
    """Drop properties not valid for the packet type
    (emqx_mqtt_props:filter/2)."""
    out = {}
    for name, val in props.items():
        pid = NAME_TO_ID.get(name)
        if pid is None:
            continue
        allowed = PROPS[pid][2]
        if allowed is None or packet_type in allowed:
            out[name] = val
    return out
