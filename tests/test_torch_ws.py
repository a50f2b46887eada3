"""The port's MQTT-over-WebSocket transport
(``emqx_tpu_torch.ws_connection``) against the JAX package's, case for
case with ``tests/test_ws.py``.

The frame codec cases feed the same bytes to the JAX ``WsFrameParser``
and the port's: the messages, the error state and the server frames
must be equal. The socket cases run on a JAX ``Node(boot_listeners=
False)`` with ``add_ws_listener`` and then on a port
``Node(device="cpu", boot_listeners=False)``, with the raw WebSocket
client of ``tests/test_ws.py``; what the clients observe (status
lines, SUBACKs, delivered payloads, PONG and CLOSE frames) must be
equal.
"""

import asyncio
import contextlib
import os
import random

import pytest

from emqx_tpu import ws_connection as JW
from emqx_tpu.mqtt import constants as C
from emqx_tpu.mqtt.frame import serialize
from emqx_tpu.mqtt.packet import Publish, Suback, Subscribe
from emqx_tpu.node import Node as JNode
from emqx_tpu_torch import ws_connection as PW
from emqx_tpu_torch.node import Node as PNode
from test_ws import WsTestClient, mask_frame


class _Pkg:
    def __init__(self, **kw) -> None:
        self.__dict__.update(kw)


JAX = _Pkg(name="jax", W=JW,
           Node=lambda **kw: JNode(boot_listeners=False, **kw))
PORT = _Pkg(name="port", W=PW,
            Node=lambda **kw: PNode(device="cpu", boot_listeners=False,
                                    **kw))


def both(scenario, *args):
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def both_async(scenario, *args):
    want = asyncio.run(scenario(JAX, *args))
    got = asyncio.run(scenario(PORT, *args))
    assert got == want
    return got


# -- frame codec ----------------------------------------------------------------

def test_accept_key_rfc_example():
    """RFC 6455 §1.3's worked example."""
    assert PW.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == \
        JW.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == \
        "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


def test_frame_roundtrip_sizes():
    def scenario(P):
        p = P.W.WsFrameParser()
        out = []
        for n in (0, 1, 125, 126, 65535, 65536, 100_000):
            payload = bytes(i % 251 for i in range(n))
            got = p.feed(mask_frame(P.W.OP_BINARY, payload))
            assert got == [(P.W.OP_BINARY, payload)]
            out.append((P.W.frame_header(P.W.OP_BINARY, n),
                        P.W.encode_frame(P.W.OP_PONG, payload[:125])))
        return out

    both(scenario)


def test_frame_incremental_and_fragmented():
    def scenario(P):
        p = P.W.WsFrameParser()
        data = mask_frame(P.W.OP_BINARY, b"hello", fin=False) + \
            mask_frame(0x0, b" world")
        seen = []
        for i in range(0, len(data), 3):
            seen += p.feed(data[i:i + 3])
        return seen

    assert both(scenario) == [(JW.OP_BINARY, b"hello world")]


def test_frame_rejects_unmasked():
    def scenario(P):
        p = P.W.WsFrameParser()
        out = p.feed(P.W.encode_frame(P.W.OP_BINARY, b"x"))
        err = str(p.error)
        with pytest.raises(P.W.WsParseError):
            p.feed(b"")  # poisoned: every later feed raises
        return out, err

    assert both(scenario) == ([], "client frame not masked")


def test_frame_rejects_bad_continuation():
    def scenario(P):
        p = P.W.WsFrameParser()
        return p.feed(mask_frame(0x0, b"orphan")), str(p.error)

    assert both(scenario) == ([], "continuation without start")


def test_frame_rejects_oversized_control():
    def scenario(P):
        p = P.W.WsFrameParser()
        return p.feed(mask_frame(P.W.OP_PING, b"p" * 126)), str(p.error)

    out, err = both(scenario)
    assert out == [] and "control" in err


def test_frame_error_preserves_earlier_messages():
    def scenario(P):
        p = P.W.WsFrameParser()
        data = mask_frame(P.W.OP_BINARY, b"keep-me") + \
            P.W.encode_frame(P.W.OP_BINARY, b"bad")
        return p.feed(data), p.error is not None

    assert both(scenario) == ([(JW.OP_BINARY, b"keep-me")], True)


# -- end to end over a real WS socket ---------------------------------------------


@contextlib.asynccontextmanager
async def ws_node(P):
    n = P.Node()
    n.add_ws_listener(port=0)
    await n.start()
    try:
        yield n
    finally:
        await n.stop()


def test_ws_connect_pub_sub():
    async def scenario(P):
        async with ws_node(P) as node:
            port = node.listeners[0].port
            sub, pub = WsTestClient("wsub"), WsTestClient("wpub")
            ack = await sub.connect(port)
            await pub.connect(port)
            await sub.send_mqtt(Subscribe(
                packet_id=1, topic_filters=[("t/#", {"qos": 0})]))
            sa = await asyncio.wait_for(sub.acks.get(), 5.0)
            assert isinstance(sa, Suback)
            await pub.send_mqtt(Publish(topic="t/x", payload=b"over-ws"))
            msg = await asyncio.wait_for(sub.inbox.get(), 5.0)
            seen = (ack.reason_code, sa.reason_codes, msg.topic,
                    msg.payload, node.metrics.val("client.connected"))
            await sub.close()
            await pub.close()
            return seen

    assert both_async(scenario) == (0, [0], "t/x", b"over-ws", 2)


def test_ws_ping_pong_and_close():
    async def scenario(P):
        async with ws_node(P) as node:
            c = WsTestClient("wping")
            await c.connect(node.listeners[0].port)
            await c.send_raw(mask_frame(P.W.OP_PING, b"hi"))
            pong = await asyncio.wait_for(c.acks.get(), 5.0)
            await c.send_raw(mask_frame(P.W.OP_CLOSE, b"\x03\xe8"))
            close = await asyncio.wait_for(c.acks.get(), 5.0)
            await c.close()
            return pong, close

    assert both_async(scenario) == (("pong", b"hi"),
                                    ("close", b"\x03\xe8"))


def test_ws_bad_handshake_rejected():
    async def scenario(P):
        async with ws_node(P) as node:
            port = node.listeners[0].port
            c = WsTestClient("wbad")
            wrong_path = await c.connect(port, path="/nope")
            await c.close()
            c2 = WsTestClient("wbad2")
            no_mqtt = await c2.connect(port, subprotocol="chat")
            await c2.close()
            return wrong_path, no_mqtt

    out = both_async(scenario)
    assert all("400" in s for s in out)


def test_ws_text_frame_disconnects():
    async def scenario(P):
        async with ws_node(P) as node:
            c = WsTestClient("wtext")
            await c.connect(node.listeners[0].port)
            await c.send_raw(mask_frame(0x1, b"not-binary"))
            kind, _ = await asyncio.wait_for(c.acks.get(), 5.0)
            await c.close()
            return kind

    assert both_async(scenario) == "close"


def test_ws_error_after_valid_packet_still_answered():
    """A malformed frame in the same read as a valid MQTT packet: the
    packet is answered, then a WS CLOSE, then the close."""
    async def scenario(P):
        async with ws_node(P) as node:
            c = WsTestClient("werr")
            ack = await c.connect(node.listeners[0].port)
            good = mask_frame(P.W.OP_BINARY, serialize(
                Subscribe(packet_id=7,
                          topic_filters=[("t/err", {"qos": 0})]),
                C.MQTT_V4))
            bad = P.W.encode_frame(P.W.OP_BINARY, b"junk")  # unmasked
            await c.send_raw(good + bad)
            got = []
            for _ in range(3):
                try:
                    item = await asyncio.wait_for(c.acks.get(), 5.0)
                except asyncio.TimeoutError:
                    break
                if isinstance(item, Suback):
                    got.append(("suback", item.packet_id))
                elif isinstance(item, tuple) and item[0] == "close":
                    got.append(item)
                    break
            await c.close()
            return ack.reason_code, got

    assert both_async(scenario) == (0, [("suback", 7),
                                        ("close", b"\x03\xe8")])


def test_ws_frame_fuzz_never_crashes_listener():
    """Random garbage and truncated or flag-corrupted frames after a
    valid upgrade close the socket cleanly; the listener survives."""
    async def scenario(P):
        rng = random.Random(99)
        n = P.Node()
        lst = n.add_ws_listener(port=0)
        await n.start()
        try:
            for trial in range(30):
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", lst.port)
                writer.write(
                    b"GET /mqtt HTTP/1.1\r\n"
                    b"Host: x\r\nUpgrade: websocket\r\n"
                    b"Connection: Upgrade\r\n"
                    b"Sec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n"
                    b"Sec-WebSocket-Version: 13\r\n"
                    b"Sec-WebSocket-Protocol: mqtt\r\n\r\n")
                await writer.drain()
                await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 5)
                kind = trial % 3
                if kind == 0:
                    junk = bytes(rng.randrange(256)
                                 for _ in range(rng.randrange(1, 64)))
                elif kind == 1:
                    junk = bytes([0x82 | rng.randrange(0x40),
                                  rng.randrange(256)]) + os.urandom(8)
                else:
                    junk = b"\x82\x05hello"
                writer.write(junk)
                await writer.drain()
                with contextlib.suppress(
                        asyncio.TimeoutError, ConnectionError,
                        asyncio.IncompleteReadError):
                    await asyncio.wait_for(reader.read(256), 2)
                writer.close()
            c = WsTestClient("post-fuzz")
            ack = await c.connect(lst.port)
            await c.close()
            return ack.reason_code, lst.current_connections() <= 1
        finally:
            await n.stop()

    assert both_async(scenario) == (0, True)


def test_ws_writev_frames_each_payload():
    """The coalesced egress: a run of MQTT frames written as one flat
    (header, payload, ...) ``writelines``, equal to the JAX one's."""
    class W:
        def __init__(self):
            self.parts = []

        def writelines(self, parts):
            self.parts.append(list(parts))

    def scenario(P):
        conn = P.W.WsConnection.__new__(P.W.WsConnection)
        conn.writer = W()
        frames = [b"\x30\x03a/b", b"x" * 200, b"y" * 70000]
        conn._writev(frames)
        return conn.writer.parts, conn._wrap_out(b"\xc0\x00")

    parts, wrapped = both(scenario)
    assert wrapped == b"\x82\x02\xc0\x00" and len(parts[0]) == 6
