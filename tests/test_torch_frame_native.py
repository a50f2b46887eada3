"""The port's native frame parser (``emqx_tpu_torch.mqtt.frame.
NativeParser`` over the C handle of ``csrc/host_native.cpp``) on the
CPU.

The cases of ``tests/test_frame_native.py`` run against the port: a
``Node(frame="native")`` serving the independent client
(``tests/indie_mqtt.py``) with its ``frame.native.frames`` counter, and
the oversize header answered with a v5 DISCONNECT 0x95 (or a bare
close before v5), with both parsers. Where the JAX package downgrades
to the Python parser when the library is missing, the port raises; the
``EMQX_TPU_FRAME`` and ``EMQX_TPU_NATIVE_FRAME`` environment switches
are not ported, and a case shows that they change nothing.

At the parser level the native parser is held frame for frame against
the port's Python ``Parser`` and the JAX package's ``NativeParser`` on
the fuzz corpus of ``tests/test_torch_frame.py``: split reads,
pipelined frames past the descriptor array's 512, corrupted frames
and malformed varints (error, message and bytes left buffered), and
``FrameTooLarge`` before the body. No tolerance: everything compared
is bytes or exact values.
"""

import asyncio
import random

import pytest

import indie_mqtt as im
from emqx_tpu.mqtt import frame as JF
from emqx_tpu_torch.mqtt import constants as C
from emqx_tpu_torch.mqtt import frame as PF
from emqx_tpu_torch.mqtt import reason_codes as RC
from emqx_tpu_torch.node import Node
from emqx_tpu_torch.ops import _build, native
from emqx_tpu_torch.router import MatcherConfig
from test_frame_fuzz import VERSIONS
from test_torch_frame import _corpus, _outcome

LIMIT = 60.0


def _giant_header(claimed: int = 0x0FFFFFFF) -> bytes:
    """A PUBLISH fixed header claiming ``claimed`` bytes of body."""
    return bytes([0x30]) + im.enc_varint(claimed)


def _serve(frame, body, **node_kw):
    """Run ``body(node, port)`` against a started port node."""
    async def go():
        node = Node(matcher=MatcherConfig(device_min_filters=1),
                    device="cpu", frame=frame, **node_kw)
        node.add_listener(port=0)
        await node.start()
        try:
            return await body(node, node.listeners[0].port)
        finally:
            await node.stop()

    return asyncio.run(asyncio.wait_for(go(), LIMIT))


def _three(version=C.MQTT_V4, max_size=1 << 20):
    """The port's native and Python parsers and the JAX package's
    native parser."""
    return (PF.make_parser(version=version, max_size=max_size,
                           mode="native"),
            PF.Parser(version=version, max_size=max_size),
            JF.NativeParser(version=version, max_size=max_size))


def _agree(chunks, version=C.MQTT_V4, max_size=1 << 20):
    got, py, ref = (_outcome(p, chunks)
                    for p in _three(version, max_size))
    assert got == py
    assert got == ref
    return got


# -- the node ---------------------------------------------------------------


def test_native_mode_roundtrip_and_counters():
    async def body(node, port):
        sub = im.IndieClient("nf-sub")
        await sub.connect(port=port)
        await sub.subscribe(("t/#", 1))
        pub = im.IndieClient("nf-pub")
        await pub.connect(port=port)
        await pub.publish("t/a", b"zero", qos=0)
        assert await pub.publish("t/b", b"one" * 400, qos=1) == 0
        got = {}
        for _ in range(2):
            p = await sub.recv()
            got[p.topic] = p.payload
        assert got == {"t/a": b"zero", "t/b": b"one" * 400}
        assert node.listeners[0].frame == "native"
        # both CONNECTs, the SUBSCRIBE and both PUBLISHes at least
        assert node.metrics.val("frame.native.frames") >= 5
        await sub.disconnect()
        await pub.disconnect()

    _serve("native", body)


def test_native_parser_raises_when_the_library_cannot_be_built(
        tmp_path, monkeypatch):
    """No downgrade: a native parser that cannot be built raises, at
    ``make_parser`` and at the node's construction."""
    bad = tmp_path / "host_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "HOST_SRC", bad)
    monkeypatch.setattr(_build, "HOST_LIB", tmp_path / "libhost.so")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="build failed"):
        PF.make_parser(mode="native")
    with pytest.raises(RuntimeError, match="build failed"):
        Node(device="cpu", frame="native")
    with pytest.raises(ValueError, match="frame must be"):
        Node(device="cpu", frame="turbo")
    # the Python parser and the Python trie engine need no build
    assert type(PF.make_parser()) is PF.Parser
    with pytest.raises(RuntimeError, match="build failed"):
        Node(device="cpu")   # the router's default engine is native
    assert Node(device="cpu", matcher=MatcherConfig(
        use_native=False)).frame == "py"


def test_frame_env_switches_are_not_ported(monkeypatch):
    """``EMQX_TPU_FRAME=py`` does not override ``frame="native"``, and
    ``EMQX_TPU_NATIVE_FRAME=1`` does not route the Python parser
    through the C scanner: the configured parser is the one that
    runs."""
    monkeypatch.setenv("EMQX_TPU_FRAME", "py")
    monkeypatch.setenv("EMQX_TPU_NATIVE_FRAME", "1")

    async def body(node, port):
        c = im.IndieClient("nf-env")
        await c.connect(port=port)
        await c.publish("t/x", b"ok")
        await c.disconnect()
        return node.listeners[0].frame, \
            node.metrics.val("frame.native.frames")

    assert _serve("native", body)[0] == "native"
    assert _serve("native", body)[1] > 0
    assert _serve("py", body) == ("py", 0)
    p = PF.Parser()
    blob = b"".join(PF.serialize(PF.Publish(topic="t", payload=b"x" * 60),
                                 4) for _ in range(40))   # > 1 KiB read
    assert len(p.feed(blob)) == 40 and not hasattr(p, "native_frames")


@pytest.mark.parametrize("frame_mode", ["py", "native"])
def test_oversize_header_gets_v5_disconnect_0x95(frame_mode):
    async def body(node, port):
        c = im.IndieClient("nf-big", version=5)
        await c.connect(port=port)
        c.writer.write(_giant_header())
        await c.writer.drain()
        p = await asyncio.wait_for(c.acks.get(), 5)
        assert p is not None and p.ptype == im.DISCONNECT
        assert p.rc == RC.PACKET_TOO_LARGE
        # ... and the transport closes after the DISCONNECT
        assert await asyncio.wait_for(c.acks.get(), 5) is None
        m = node.metrics
        assert m.val("frame.oversize") == 1
        assert m.val("delivery.dropped.too_large") == 1

    _serve(frame_mode, body)


@pytest.mark.parametrize("frame_mode", ["py", "native"])
def test_oversize_header_v4_just_closes(frame_mode):
    """Pre-v5 there is no server DISCONNECT: the connection closes
    with nothing extra on the wire."""
    async def body(node, port):
        c = im.IndieClient("nf-big4", version=4)
        await c.connect(port=port)
        c.writer.write(_giant_header())
        await c.writer.drain()
        assert await asyncio.wait_for(c.acks.get(), 5) is None  # EOF
        assert node.metrics.val("frame.oversize") == 1

    _serve(frame_mode, body)


# -- the parser, frame for frame --------------------------------------------


def _stream(version, n, seed):
    pkts = [p for p in _corpus(seed, version, n)
            if not isinstance(p, JF.Connect)]
    head = JF.Connect(proto_ver=version,
                      proto_name=C.PROTOCOL_NAMES[version], client_id="s")
    return b"".join(JF.serialize(p, version) for p in [head] + pkts), \
        len(pkts) + 1


@pytest.mark.parametrize("version", VERSIONS)
def test_native_parser_agrees_at_random_split_points(version):
    rng = random.Random(5000 + version)
    blob, n = _stream(version, 300, 5100 + version)
    for _ in range(3):
        cuts, i = [], 0
        while i < len(blob):
            k = rng.choice((1, 2, 3, 7, 40, 300))
            cuts.append(blob[i:i + k])
            i += k
        got = _agree(cuts)
        assert got[0] == "ok" and len(got[1]) == n


def test_native_parser_pipelined_past_the_descriptor_array():
    """One read holding 1,500 frames (the C side returns 512 rows a
    scan) and the same stream as one bytearray and one memoryview."""
    blob, n = _stream(C.MQTT_V5, 1500, 6100)
    for data in (blob, bytearray(blob), memoryview(blob)):
        got = _agree([data])
        assert got[0] == "ok" and len(got[1]) == n


@pytest.mark.parametrize("version", VERSIONS)
def test_native_parser_raises_alike_on_corrupted_frames(version):
    """Flipped bytes, truncation, appended garbage and pure garbage,
    after a valid frame in the same read: the same error, message and
    bytes left buffered as both references."""
    rng = random.Random(7000 + version)
    lead = JF.serialize(JF.Pingreq(), version)
    n_err = 0
    for pkt in _corpus(7100 + version, version, 500):
        data = bytearray(JF.serialize(pkt, version))
        mode = rng.random()
        if mode < 0.4:
            for _ in range(rng.randint(1, 4)):
                k = rng.randrange(len(data))
                data[k] ^= rng.randint(1, 255)
        elif mode < 0.7:
            data = data[:rng.randrange(max(1, len(data)))]
        else:
            data += rng.randbytes(rng.randint(1, 16))
        got = _agree([lead + bytes(data)], version)
        n_err += got[0] != "ok"
    for _ in range(150):
        got = _agree([rng.randbytes(rng.randint(1, 512))], C.MQTT_V5,
                     max_size=1 << 16)
        n_err += got[0] != "ok"
    assert n_err > 100


def test_native_parser_malformed_varint_and_frame_too_large():
    # a fifth continuation byte: malformed, after one good frame
    ping = PF.serialize(PF.Pingreq(), 4)
    got = _agree([ping + b"\x30\xff\xff\xff\xff\x01"])
    assert got[:2] == ("FrameError", "malformed_variable_byte_integer")
    # split inside the varint: nothing until the bad byte arrives
    got = _agree([ping + b"\x30\xff\xff", b"\xff\xff\x01"])
    assert got[0] == "FrameError"
    # a header claiming past max_size raises before its body arrives
    data = bytes([0x30]) + im.enc_varint(5000) + b"\x00\x01a"
    got = _agree([data], max_size=1024)
    assert got[:2] == ("FrameTooLarge", "frame_too_large: 5003")
    with pytest.raises(PF.FrameTooLarge):
        PF.make_parser(max_size=1024, mode="native").feed(data)
