"""The port's MQTT codec (emqx_tpu_torch.mqtt) against the JAX
package's (emqx_tpu.mqtt), byte for byte.

The packet corpus is the one tests/test_frame_fuzz.py generates (its
generators are imported, the file is not changed): every packet type
with random valid contents and v5 properties, over MQTT 3.1, 3.1.1
and 5.0. Each packet is built once with the JAX classes and copied
field for field into the port's dataclass of the same name. Compared:
the serialized bytes, the packets both parsers give at random split
points, and, on corrupted frames, the error type, its message and the
bytes left buffered. tests/indie_mqtt.py, a codec written
independently of both, encodes a client's packets for the port's
parser. No tolerance: everything compared is bytes or exact values.
"""

import dataclasses
import random

import pytest

from emqx_tpu.mqtt import frame as JF
from emqx_tpu_torch.mqtt import constants as C
from emqx_tpu_torch.mqtt import frame as PF
from emqx_tpu_torch.mqtt import packet as PP
from test_frame_fuzz import VERSIONS, gen_packet

import indie_mqtt as im


def _to_port(pkt):
    """The port's packet of the same class and fields."""
    cls = getattr(PP, type(pkt).__name__)
    return cls(**{f.name: getattr(pkt, f.name)
                  for f in dataclasses.fields(pkt)})


def _plain(pkt):
    """Class name and fields: how packets of the two packages compare."""
    return (type(pkt).__name__,
            {f.name: getattr(pkt, f.name) for f in dataclasses.fields(pkt)})


def _corpus(seed, version, n):
    rng = random.Random(seed)
    out = []
    while len(out) < n:
        pkt = gen_packet(rng, version)
        if isinstance(pkt, JF.Auth) and version != C.MQTT_V5:
            continue  # AUTH exists only in v5
        out.append(pkt)
    return out


def _outcome(parser, chunks):
    """("ok", packets) or (error class name, message, bytes left)."""
    got = []
    try:
        for c in chunks:
            got.extend(parser.feed(c))
    except (JF.FrameError, PF.FrameError) as e:
        return (type(e).__name__, str(e), parser.pending())
    return ("ok", [_plain(p) for p in got])


@pytest.mark.parametrize("version", VERSIONS)
def test_serialize_equals_jax_bytes(version):
    """2,000 packets a version: the port's serialize gives the JAX
    package's bytes, and publish_template the same frame and offset."""
    for i, pkt in enumerate(_corpus(2000 + version, version, 2000)):
        want = JF.serialize(pkt, version)
        port_pkt = _to_port(pkt)
        assert PF.serialize(port_pkt, version) == want, (i, pkt)
        if isinstance(pkt, JF.Publish) and pkt.qos > 0:
            assert PF.publish_template(port_pkt, version) == \
                JF.publish_template(pkt, version)


@pytest.mark.parametrize("version", VERSIONS)
def test_parsers_agree_at_random_split_points(version):
    """A stream of 300 packets (a CONNECT first) fed in random chunks
    of 1 to 40 bytes gives equal packets from both parsers."""
    rng = random.Random(3000 + version)
    pkts = [p for p in _corpus(3100 + version, version, 300)
            if not isinstance(p, JF.Connect)]
    head = JF.Connect(proto_ver=version,
                      proto_name=C.PROTOCOL_NAMES[version], client_id="s")
    blob = b"".join(JF.serialize(p, version) for p in [head] + pkts)
    cuts = []
    i = 0
    while i < len(blob):
        n = rng.randint(1, 40)
        cuts.append(blob[i:i + n])
        i += n
    want = _outcome(JF.Parser(), cuts)
    got = _outcome(PF.Parser(), cuts)
    assert want[0] == "ok" and len(want[1]) == len(pkts) + 1
    assert got == want


@pytest.mark.parametrize("version", VERSIONS)
def test_parsers_raise_alike_on_corrupted_frames(version):
    """The fuzz file's adversarial pass (flip 1-4 bytes, truncate,
    append garbage) and pure garbage: the same outcome from both
    parsers, error type, message and buffered bytes included."""
    rng = random.Random(31337 + version)
    n_err = 0
    for pkt in _corpus(4000 + version, version, 800):
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
        chunks = [bytes(data)]
        want = _outcome(JF.Parser(version=version, max_size=1 << 20),
                        chunks)
        got = _outcome(PF.Parser(version=version, max_size=1 << 20),
                       chunks)
        assert got == want, (pkt, bytes(data))
        n_err += want[0] != "ok"
    for _ in range(200):
        chunks = [rng.randbytes(rng.randint(1, 512))]
        want = _outcome(JF.Parser(version=C.MQTT_V5, max_size=1 << 16),
                        chunks)
        assert _outcome(PF.Parser(version=C.MQTT_V5, max_size=1 << 16),
                        chunks) == want
        n_err += want[0] != "ok"
    assert n_err > 100  # the corpus does reach the error paths


def test_frame_too_large_before_the_body():
    """A header that claims more than max_size raises FrameTooLarge in
    both parsers before its body arrives."""
    data = bytes([0x30]) + im.enc_varint(5000) + b"\x00\x01a"
    assert _outcome(PF.Parser(max_size=1024), [data]) == \
        _outcome(JF.Parser(max_size=1024), [data])
    with pytest.raises(PF.FrameTooLarge):
        PF.Parser(max_size=1024).feed(data)


def test_make_parser_has_only_the_python_parser():
    """The default is the pure-Python parser; ``mode="native"`` is the
    C framing (tests/test_torch_frame_native.py); any other mode
    raises instead of picking one."""
    p = PF.make_parser()
    assert type(p) is PF.Parser
    assert isinstance(PF.make_parser(mode="native"), PF.NativeParser)
    with pytest.raises(ValueError, match="native"):
        PF.make_parser(mode="turbo")


@pytest.mark.parametrize("version", [4, 5])
def test_indie_codec_packets_decode_in_the_port(version):
    """CONNECT (with a will), SUBSCRIBE and PUBLISH at QoS 0-2 as the
    independent codec encodes them, decoded by the port's parser to
    the fields the client meant; fed a byte at a time too."""
    will = {"topic": "w/t", "payload": b"bye", "qos": 1, "retain": True}
    parts = [im.build_connect("indie", version=version, keepalive=30,
                              username="u", password=b"p", will=will),
             im.build_subscribe(1, [("a/+", 1), ("b/#", 2)],
                                version=version),
             im.build_publish("a/b", b"x", qos=0, version=version),
             im.build_publish("a/c", b"y", qos=1, pkt_id=2,
                              version=version),
             im.build_publish("a/d", b"z", qos=2, pkt_id=3, retain=True,
                              version=version)]
    stream = b"".join(parts)
    whole = PF.Parser().feed(stream)
    bytewise = []
    p = PF.Parser()
    for i in range(len(stream)):
        bytewise.extend(p.feed(stream[i:i + 1]))
    assert whole == bytewise
    conn, sub, q0, q1, q2 = whole
    assert isinstance(conn, PP.Connect)
    assert (conn.client_id, conn.proto_ver, conn.keepalive,
            conn.username, conn.password) == ("indie", version, 30,
                                               "u", b"p")
    assert (conn.will_flag, conn.will_topic, conn.will_payload,
            conn.will_qos, conn.will_retain) == (True, "w/t", b"bye", 1,
                                                 True)
    assert sub.packet_id == 1
    assert [(f, o["qos"]) for f, o in sub.topic_filters] == \
        [("a/+", 1), ("b/#", 2)]
    assert [(m.topic, m.payload, m.qos, m.packet_id, m.retain)
            for m in (q0, q1, q2)] == [("a/b", b"x", 0, None, False),
                                       ("a/c", b"y", 1, 2, False),
                                       ("a/d", b"z", 2, 3, True)]
    # and the JAX parser reads the same packets
    assert [_plain(x) for x in JF.Parser().feed(stream)] == \
        [_plain(x) for x in whole]
