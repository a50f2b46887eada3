"""MQTT v5 reason codes + v3 compatibility mapping
(reference: src/emqx_reason_codes.erl)."""

from __future__ import annotations

SUCCESS = 0x00
NORMAL_DISCONNECTION = 0x00
GRANTED_QOS_0 = 0x00
GRANTED_QOS_1 = 0x01
GRANTED_QOS_2 = 0x02
DISCONNECT_WITH_WILL = 0x04
NO_MATCHING_SUBSCRIBERS = 0x10
NO_SUBSCRIPTION_EXISTED = 0x11
CONTINUE_AUTHENTICATION = 0x18
REAUTHENTICATE = 0x19
UNSPECIFIED_ERROR = 0x80
MALFORMED_PACKET = 0x81
PROTOCOL_ERROR = 0x82
IMPLEMENTATION_SPECIFIC_ERROR = 0x83
UNSUPPORTED_PROTOCOL_VERSION = 0x84
CLIENT_IDENTIFIER_NOT_VALID = 0x85
BAD_USERNAME_OR_PASSWORD = 0x86
NOT_AUTHORIZED = 0x87
SERVER_UNAVAILABLE = 0x88
SERVER_BUSY = 0x89
BANNED = 0x8A
SERVER_SHUTTING_DOWN = 0x8B
BAD_AUTHENTICATION_METHOD = 0x8C
KEEPALIVE_TIMEOUT = 0x8D
SESSION_TAKEN_OVER = 0x8E
TOPIC_FILTER_INVALID = 0x8F
TOPIC_NAME_INVALID = 0x90
PACKET_IDENTIFIER_IN_USE = 0x91
PACKET_IDENTIFIER_NOT_FOUND = 0x92
RECEIVE_MAXIMUM_EXCEEDED = 0x93
TOPIC_ALIAS_INVALID = 0x94
PACKET_TOO_LARGE = 0x95
MESSAGE_RATE_TOO_HIGH = 0x96
QUOTA_EXCEEDED = 0x97
ADMINISTRATIVE_ACTION = 0x98
PAYLOAD_FORMAT_INVALID = 0x99
RETAIN_NOT_SUPPORTED = 0x9A
QOS_NOT_SUPPORTED = 0x9B
USE_ANOTHER_SERVER = 0x9C
SERVER_MOVED = 0x9D
SHARED_SUBSCRIPTIONS_NOT_SUPPORTED = 0x9E
CONNECTION_RATE_EXCEEDED = 0x9F
MAXIMUM_CONNECT_TIME = 0xA0
SUBSCRIPTION_IDENTIFIERS_NOT_SUPPORTED = 0xA1
WILDCARD_SUBSCRIPTIONS_NOT_SUPPORTED = 0xA2

_NAMES = {
    0x00: "success",
    0x01: "granted_qos1",
    0x02: "granted_qos2",
    0x04: "disconnect_with_will_message",
    0x10: "no_matching_subscribers",
    0x11: "no_subscription_existed",
    0x18: "continue_authentication",
    0x19: "re_authenticate",
    0x80: "unspecified_error",
    0x81: "malformed_packet",
    0x82: "protocol_error",
    0x83: "implementation_specific_error",
    0x84: "unsupported_protocol_version",
    0x85: "client_identifier_not_valid",
    0x86: "bad_username_or_password",
    0x87: "not_authorized",
    0x88: "server_unavailable",
    0x89: "server_busy",
    0x8A: "banned",
    0x8B: "server_shutting_down",
    0x8C: "bad_authentication_method",
    0x8D: "keepalive_timeout",
    0x8E: "session_taken_over",
    0x8F: "topic_filter_invalid",
    0x90: "topic_name_invalid",
    0x91: "packet_identifier_in_use",
    0x92: "packet_identifier_not_found",
    0x93: "receive_maximum_exceeded",
    0x94: "topic_alias_invalid",
    0x95: "packet_too_large",
    0x96: "message_rate_too_high",
    0x97: "quota_exceeded",
    0x98: "administrative_action",
    0x99: "payload_format_invalid",
    0x9A: "retain_not_supported",
    0x9B: "qos_not_supported",
    0x9C: "use_another_server",
    0x9D: "server_moved",
    0x9E: "shared_subscriptions_not_supported",
    0x9F: "connection_rate_exceeded",
    0xA0: "maximum_connect_time",
    0xA1: "subscription_identifiers_not_supported",
    0xA2: "wildcard_subscriptions_not_supported",
}


def name(code: int) -> str:
    return _NAMES.get(code, "unknown_error")


# v5 connack code -> v3 connack return code (emqx_reason_codes:compat/2)
_CONNACK_COMPAT = {
    0x00: 0,
    0x80: 3, 0x81: 3, 0x82: 3, 0x83: 3,
    0x84: 1,
    0x85: 2,
    0x86: 4,
    0x87: 5,
    0x88: 3, 0x89: 3,
    0x8A: 5,
    0x8C: 4,
    0x97: 3,
    0x9C: 3, 0x9D: 3, 0x9F: 3,
}


def compat(kind: str, code: int) -> int | None:
    """Map a v5 reason code onto the v3 wire equivalent."""
    if kind == "connack":
        return _CONNACK_COMPAT.get(code, 3)
    if kind == "suback":
        return 0x80 if code >= 0x80 else code
    if kind == "unsuback":
        return None
    return None
