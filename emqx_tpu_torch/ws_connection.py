"""MQTT-over-WebSocket transport (RFC 6455, server side) — the port of
the JAX package's ``ws_connection.py``.

Mirrors ``src/emqx_ws_connection.erl``: the same channel FSM and
connection loop as the TCP transport — :class:`WsConnection` subclasses
:class:`emqx_tpu_torch.connection.Connection`, overriding only the framing
seams — with the byte stream wrapped in WebSocket binary frames and
the HTTP upgrade handshake (cowboy's role in the reference) done
inline on the accepted socket. MQTT requires the ``mqtt`` subprotocol
and binary frames; client frames MUST be masked, server frames MUST
NOT be.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import logging
from typing import List, Optional, Tuple

from emqx_tpu_torch.connection import Connection, Listener
from emqx_tpu_torch.zone import Zone

log = logging.getLogger("emqx_tpu_torch.ws_connection")

_WS_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT = 0x0
OP_TEXT = 0x1
OP_BINARY = 0x2
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


def accept_key(key: str) -> str:
    """Sec-WebSocket-Accept for a client Sec-WebSocket-Key."""
    digest = hashlib.sha1(key.encode() + _WS_GUID).digest()
    return base64.b64encode(digest).decode()


def frame_header(opcode: int, n: int) -> bytes:
    """Server→client frame header for an ``n``-byte payload: FIN set,
    never masked. Split from :func:`encode_frame` so the coalesced
    egress flush can writev ``(header, payload, …)`` runs without
    concatenating (= copying) every payload into a fresh frame."""
    head = bytearray([0x80 | opcode])
    if n < 126:
        head.append(n)
    elif n < 65536:
        head.append(126)
        head += n.to_bytes(2, "big")
    else:
        head.append(127)
        head += n.to_bytes(8, "big")
    return bytes(head)


def encode_frame(opcode: int, payload: bytes) -> bytes:
    """Server→client frame: FIN set, never masked."""
    return frame_header(opcode, len(payload)) + payload


def _unmask(data: bytes, mask: bytes) -> bytes:
    """XOR-unmask as one big-int op (no per-byte Python loop)."""
    n = len(data)
    if n == 0:
        return b""
    full = (mask * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "big")
            ^ int.from_bytes(full, "big")).to_bytes(n, "big")


class WsParseError(Exception):
    pass


class WsFrameParser:
    """Incremental client→server frame parser (masked frames).

    Yields ``(opcode, payload)`` per complete message; continuation
    frames are reassembled onto the initial opcode.
    """

    def __init__(self, max_size: int = 16 * 1024 * 1024) -> None:
        self.buf = bytearray()
        self.max_size = max_size
        self._frag_op: Optional[int] = None
        self._frag_data = bytearray()
        # set instead of raised mid-batch so messages parsed before a
        # malformed frame still reach the caller (a clean DISCONNECT
        # ahead of garbage must not be dropped)
        self.error: Optional[WsParseError] = None

    def feed(self, data: bytes) -> List[Tuple[int, bytes]]:
        if self.error is not None:
            raise self.error
        self.buf += data
        out: List[Tuple[int, bytes]] = []
        while True:
            try:
                frame = self._next_frame()
            except WsParseError as e:
                self.error = e
                return out
            if frame is None:
                return out
            fin, opcode, payload = frame
            if opcode in (OP_CLOSE, OP_PING, OP_PONG):
                if not fin:
                    self.error = WsParseError("fragmented control frame")
                    return out
                out.append((opcode, payload))
                continue
            if opcode == OP_CONT:
                if self._frag_op is None:
                    self.error = WsParseError("continuation without start")
                    return out
                self._frag_data += payload
            else:
                if self._frag_op is not None:
                    self.error = WsParseError("interleaved data message")
                    return out
                self._frag_op = opcode
                self._frag_data = bytearray(payload)
            if len(self._frag_data) > self.max_size:
                self.error = WsParseError("message too large")
                return out
            if fin:
                out.append((self._frag_op, bytes(self._frag_data)))
                self._frag_op = None
                self._frag_data = bytearray()

    def _next_frame(self):
        buf = self.buf
        if len(buf) < 2:
            return None
        b0, b1 = buf[0], buf[1]
        fin = bool(b0 & 0x80)
        if b0 & 0x70:
            raise WsParseError("RSV bits set")
        opcode = b0 & 0x0F
        masked = bool(b1 & 0x80)
        if not masked:
            raise WsParseError("client frame not masked")
        n = b1 & 0x7F
        if opcode >= 0x8 and n > 125:
            # RFC 6455 §5.5: control frames MUST be ≤125 bytes
            raise WsParseError("control frame too large")
        pos = 2
        if n == 126:
            if len(buf) < 4:
                return None
            n = int.from_bytes(buf[2:4], "big")
            pos = 4
        elif n == 127:
            if len(buf) < 10:
                return None
            n = int.from_bytes(buf[2:10], "big")
            pos = 10
        if n > self.max_size:
            raise WsParseError("frame too large")
        end = pos + 4 + n
        if len(buf) < end:
            return None
        mask = bytes(buf[pos:pos + 4])
        payload = _unmask(bytes(buf[pos + 4:end]), mask)
        del self.buf[:end]
        return fin, opcode, payload


async def _read_http_request(reader: asyncio.StreamReader,
                             timeout: float) -> Optional[dict]:
    """Read one HTTP/1.1 request head; returns {path, headers} or None."""
    try:
        head = await asyncio.wait_for(
            reader.readuntil(b"\r\n\r\n"), timeout)
    except (asyncio.TimeoutError, asyncio.IncompleteReadError,
            asyncio.LimitOverrunError):
        return None
    lines = head.decode("latin-1").split("\r\n")
    try:
        method, path, _version = lines[0].split(" ", 2)
    except ValueError:
        return None
    if method.upper() != "GET":
        return None
    headers = {}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    return {"path": path, "headers": headers}


class WsConnection(Connection):
    """One WebSocket client <-> one Channel (post-handshake).

    Shares the TCP connection loop; only the framing seams differ:
    outbound MQTT bytes are wrapped in binary frames, inbound bytes
    route through :class:`WsFrameParser` (with ping/pong/close
    handling) before the MQTT parser.
    """

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter,
                 broker, cm, zone: Optional[Zone] = None,
                 listener: str = "ws:default", peername=None,
                 peer_cert_as_username=None, frame: str = "py") -> None:
        super().__init__(reader, writer, broker, cm, zone=zone,
                         listener=listener, peername=peername,
                         peer_cert_as_username=peer_cert_as_username,
                         frame=frame)
        # one WS message may batch MULTIPLE MQTT packets (MQTT 5 §6.0),
        # so the reassembly bound is a multiple of the per-packet limit
        # (which the MQTT parser itself enforces), not the limit + slack
        self.ws_parser = WsFrameParser(
            max_size=8 * self.zone.max_packet_size)
        self._sent_close = False

    def _wrap_out(self, data: bytes) -> bytes:
        return encode_frame(OP_BINARY, data)

    def _writev(self, frames) -> None:
        """Writev-coalesced egress for the WS transport: a run of
        pre-serialized MQTT frames becomes one flat
        ``(header, payload, header, payload, …)`` ``writelines`` —
        one transport write per drain (like the TCP path) and zero
        per-frame payload copies (``encode_frame`` would
        concatenate header + payload per frame)."""
        parts: list = []
        ap = parts.append
        for data in frames:
            ap(frame_header(OP_BINARY, len(data)))
            ap(data)
        self.writer.writelines(parts)

    async def _drain_and_close(self) -> None:
        if not self._closing and not self._sent_close:
            self._sent_close = True
            try:
                self.writer.write(encode_frame(OP_CLOSE, b"\x03\xe8"))
            except Exception:
                pass
        await super()._drain_and_close()

    async def _decode(self, data: bytes):
        try:
            msgs = self.ws_parser.feed(data)
        except WsParseError as e:
            log.debug("ws error from %s: %s", self.channel.peername, e)
            return None
        if self.ws_parser.error is not None:
            # malformed frame behind valid ones: process what parsed
            # cleanly, then finish (feed() raises from here on); the
            # run loop drains responses and closes after the batch
            log.debug("ws error from %s: %s", self.channel.peername,
                      self.ws_parser.error)
            self._finish_after_batch = True
        pkts = []
        for opcode, payload in msgs:
            if opcode == OP_PING:
                self.writer.write(encode_frame(OP_PONG, payload))
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                if not self._sent_close:
                    self._sent_close = True
                    self.writer.write(encode_frame(OP_CLOSE, payload[:2]))
                try:
                    await self.writer.drain()
                except Exception:
                    pass
                # MQTT packets decoded before the CLOSE (e.g. a clean
                # DISCONNECT in the same read) still get processed
                self._finish_after_batch = True
                return pkts
            if opcode != OP_BINARY:
                # MQTT over WS MUST use binary frames
                self._finish_after_batch = True
                return pkts
            mqtt_pkts = await super()._decode(payload)
            if mqtt_pkts is None:
                self._finish_after_batch = True
                return pkts
            pkts.extend(mqtt_pkts)
        return pkts


class WsListener(Listener):
    """WebSocket listener: HTTP upgrade → WsConnection
    (reference: cowboy router /mqtt → emqx_ws_connection).

    Shares the TCP Listener lifecycle; only the handshake differs."""

    connection_class = WsConnection

    def __init__(self, broker, cm, host: str = "127.0.0.1",
                 port: int = 8083, path: str = "/mqtt",
                 zone: Optional[Zone] = None, name: str = "ws:default",
                 max_connections: int = 1024000,
                 ssl_context=None, device=None,
                 frame: str = "py") -> None:
        super().__init__(broker, cm, host=host, port=port, zone=zone,
                         name=name, max_connections=max_connections,
                         ssl_context=ssl_context, device=device,
                         frame=frame)
        self.path = path

    async def _handshake(self, reader, writer) -> bool:
        req = await _read_http_request(reader, self.zone.idle_timeout)
        if req is None or not self._check_upgrade(req):
            writer.write(b"HTTP/1.1 400 Bad Request\r\n"
                         b"Connection: close\r\n\r\n")
            await writer.drain()
            writer.close()
            return False
        h = req["headers"]
        resp = (
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: "
            f"{accept_key(h['sec-websocket-key'])}\r\n"
            "Sec-WebSocket-Protocol: mqtt\r\n\r\n")
        writer.write(resp.encode("latin-1"))
        await writer.drain()
        return True

    def _check_upgrade(self, req: dict) -> bool:
        h = req["headers"]
        if req["path"].split("?")[0] != self.path:
            return False
        if h.get("upgrade", "").lower() != "websocket":
            return False
        if "upgrade" not in h.get("connection", "").lower():
            return False
        if h.get("sec-websocket-version") != "13":
            return False
        if "sec-websocket-key" not in h:
            return False
        protos = [p.strip() for p in
                  h.get("sec-websocket-protocol", "").split(",")]
        return "mqtt" in protos
