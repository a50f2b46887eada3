"""The port's egress pre-serialization
(``emqx_tpu_torch.ops.dispatch_plan.preserialize_plan``,
``Channel._wire_cached``/``_wire_template`` and
``mqtt.frame.publish_template``) on the CPU.

The cases of ``tests/test_egress_serialize.py`` run against the port:
the packet-id patch of a template against ``serialize`` and the
independent ``tests/indie_mqtt.py`` codec; what the planner primes and
what it leaves to the per-delivery path; session state and wire bytes
with ``preserialize`` on and off; the on-loop serialize counter; the
effective-QoS key of the shared wire image. The port has no config
parser: the schema case becomes the defaults against the JAX
package's ``DispatchConfig``.

Two cases hold the port to the JAX package as well: sans-IO channels
over a node each (QoS 0/1/2, MQTT 3.1, 3.1.1 and 5, retain-as-published,
retain, a subscription id, message expiry, a share group, outbound
topic aliases and a client maximum packet size), and a retained replay
burst through the retainer's pre-serialized tail. Each gives the same
bytes with ``preserialize`` on and off, in both packages. No
tolerance: everything compared is bytes or exact values, apart from
the Message-Expiry-Interval countdown, which depends on the clock and
is held to its bound.
"""

import asyncio
import random

import pytest
import torch

import indie_mqtt as im
from emqx_tpu.broker import DispatchConfig as JDispatchConfig
from emqx_tpu.channel import Channel as JChannel
from emqx_tpu.modules.retainer import RetainerModule as JRetainer
from emqx_tpu.mqtt import frame as JF
from emqx_tpu.mqtt import packet as JP
from emqx_tpu.node import Node as JNode
from emqx_tpu.router import MatcherConfig as JMatcherConfig
from emqx_tpu.types import Message as JMessage
from emqx_tpu_torch.broker import Broker, DispatchConfig
from emqx_tpu_torch.channel import Channel
from emqx_tpu_torch.cm import ConnectionManager
from emqx_tpu_torch.modules.retainer import RetainerModule
from emqx_tpu_torch.mqtt import constants as C
from emqx_tpu_torch.mqtt import frame as PF
from emqx_tpu_torch.mqtt import packet as PP
from emqx_tpu_torch.mqtt.frame import FrameError, publish_template
from emqx_tpu_torch.mqtt.frame import serialize as wire_serialize
from emqx_tpu_torch.mqtt.packet import Connect, Publish
from emqx_tpu_torch.node import Node
from emqx_tpu_torch.router import MatcherConfig, Router
from emqx_tpu_torch.session import Session
from emqx_tpu_torch.types import Message, SubOpts

VERSIONS = (C.MQTT_V3, C.MQTT_V4, C.MQTT_V5)
LIMIT = 60.0

# v5 property sets a template may legally carry (the planner routes
# the per-delivery rewrites to the slow path; the codec itself does
# not care, so the fuzz includes an expiry case too)
PROP_SETS = (
    {},
    {"Content-Type": "application/json"},
    {"User-Property": [("a", "b"), ("c", "d")]},
    {"Payload-Format-Indicator": 1, "Response-Topic": "r/t"},
    {"Correlation-Data": b"\x00\xffcorr"},
    {"Message-Expiry-Interval": 30},
)

PIDS = (1, 0x7F, 0x80, 0xFF, 0x100, 0x1234, 0x7FFF, 0x8000, 0xFFFF)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run torch single-threaded here and restore the setting after:
    these tests share worker processes and cores with timing-sensitive
    tests of the JAX package."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _indie_decode(frame: bytes, version: int):
    """Split a serialized frame with the independent codec's own
    primitives and decode the body."""
    rl, boff = im.dec_varint(frame, 1)
    body = bytes(frame[boff:])
    assert len(body) == rl
    return im.decode(frame[0] >> 4, frame[0] & 0x0F, body,
                     5 if version == C.MQTT_V5 else 4)


# -- golden-byte template fuzz --------------------------------------------


def test_template_pid_patch_matches_serialize_fuzz():
    rng = random.Random(0xE5)
    alphabet = "abcdefg/μτ0"
    for _ in range(150):
        ver = rng.choice(VERSIONS)
        qos = rng.choice((1, 2))
        retain = bool(rng.randrange(2))
        dup = bool(rng.randrange(2))
        topic = "".join(rng.choice(alphabet)
                        for _ in range(rng.randint(1, 60)))
        payload = rng.randbytes(rng.randrange(0, 200))
        props = dict(rng.choice(PROP_SETS)) if ver == C.MQTT_V5 else {}
        kw = dict(topic=topic, payload=payload, qos=qos, retain=retain,
                  dup=dup, packet_id=0x0B0B)
        tpl, off = publish_template(Publish(**kw, properties=dict(props)),
                                    ver)
        assert (tpl, off) == JF.publish_template(
            JP.Publish(**kw, properties=dict(props)), ver)
        for pid in rng.sample(PIDS, 4):
            buf = bytearray(tpl)
            buf[off] = (pid >> 8) & 0xFF
            buf[off + 1] = pid & 0xFF
            patched = bytes(buf)
            kw["packet_id"] = pid
            assert patched == wire_serialize(
                Publish(**kw, properties=dict(props)), ver)
            p = _indie_decode(patched, ver)
            assert (p.ptype, p.topic, p.payload, p.qos, p.retain,
                    p.dup, p.pkt_id) == (im.PUBLISH, topic, payload,
                                         qos, retain, dup, pid)
            if ver == C.MQTT_V5:
                assert p.props == props


def test_template_alias_variant_empty_topic():
    tpl, off = publish_template(
        Publish(topic="", payload=b"x", qos=1, packet_id=0,
                properties={"Topic-Alias": 5}), C.MQTT_V5)
    buf = bytearray(tpl)
    buf[off:off + 2] = (0xBEEF).to_bytes(2, "big")
    p = _indie_decode(bytes(buf), C.MQTT_V5)
    assert p.topic == "" and p.pkt_id == 0xBEEF
    assert p.props == {"Topic-Alias": 5}


def test_template_refuses_qos0():
    with pytest.raises(FrameError):
        publish_template(Publish(topic="t", qos=0), C.MQTT_V4)


# -- preserialize_plan: what gets primed, what stays slow -----------------


def _hinted_session(broker, cid, ver=C.MQTT_V4, upgrade=False):
    s = Session(cid, broker=broker, upgrade_qos=upgrade)
    s.proto_ver = ver
    s.wire_fast_hint = True
    return s


def _device_broker(preserialize=True, **mk):
    mk.setdefault("device_min_filters", 0)
    return Broker(router=Router(MatcherConfig(**mk), device="cpu"),
                  dispatch_config=DispatchConfig(preserialize=preserialize))


def test_preserialize_primes_templates_and_images():
    b = _device_broker()
    s1 = _hinted_session(b, "t1")                    # qos1 template
    s0 = _hinted_session(b, "t0")                    # downgrade to 0
    s5 = _hinted_session(b, "t5", ver=C.MQTT_V5)     # v5 template
    s1.subscribe("p/t", SubOpts(qos=1))
    s0.subscribe("p/t", SubOpts(qos=0))
    s5.subscribe("p/t", SubOpts(qos=2))
    msg = Message(topic="p/t", payload=b"pay", qos=1, from_="pub")
    pb = b.publish_begin([msg])
    assert not pb.done
    b.publish_fetch(pb)
    assert pb.plan is not None
    tpl = msg.headers["_wiretpl"]
    wire = msg.headers["_wire"]
    assert set(tpl) == {(C.MQTT_V4, 1, False, False),
                        (C.MQTT_V5, 1, False, False)}
    # the downgraded-to-QoS 0 copy's image keys with qos 0: it can
    # never serve the QoS 1 bytes
    assert set(wire) == {(C.MQTT_V4, 0, False, False)}
    data, off = tpl[(C.MQTT_V4, 1, False, False)]
    buf = bytearray(data)
    buf[off:off + 2] = (42).to_bytes(2, "big")
    assert bytes(buf) == wire_serialize(
        Publish(topic="p/t", payload=b"pay", qos=1, packet_id=42),
        C.MQTT_V4)
    assert wire[(C.MQTT_V4, 0, False, False)] == wire_serialize(
        Publish(topic="p/t", payload=b"pay", qos=0), C.MQTT_V4)
    assert b.publish_finish(pb) == [3]
    assert [pid for pid, _ in s1.outbox] == [1]
    assert [pid for pid, _ in s0.outbox] == [None]


def test_preserialize_skips_per_session_rewrites():
    b = _device_broker()
    s_subid = _hinted_session(b, "sid", ver=C.MQTT_V5)
    s_share = _hinted_session(b, "shr")
    s_nohint = Session("noh", broker=b)   # no channel hints
    s_subid.subscribe("q/t", SubOpts(qos=1, subid=9))
    s_share.subscribe("$share/g/q/t", SubOpts(qos=1))
    s_nohint.subscribe("q/t", SubOpts(qos=1))
    msg = Message(topic="q/t", qos=1, from_="pub")
    pb = b.publish_begin([msg])
    b.publish_fetch(pb)
    assert pb.plan is not None
    assert not msg.headers.get("_wiretpl")
    assert not msg.headers.get("_wire")
    b.publish_finish(pb)


def test_preserialize_skips_expiry_messages():
    b = _device_broker()
    s = _hinted_session(b, "e1")
    s.subscribe("x/t", SubOpts(qos=1))
    msg = Message(topic="x/t", qos=1, from_="pub")
    msg.set_header("properties", {"Message-Expiry-Interval": 60})
    pb = b.publish_begin([msg])
    b.publish_fetch(pb)
    assert "_wiretpl" not in msg.headers
    b.publish_finish(pb)


# -- session-state parity: preserialize must not perturb delivery ---------


def _metric_deltas(broker):
    return {k: v for k, v in broker.metrics.all().items()
            if v and (k.startswith("messages.")
                      or k.startswith("delivery."))
            and k != "delivery.serialize.onloop"}


def test_session_state_parity_preser_on_off():
    outs = []
    for preser in (True, False):
        b = _device_broker(preserialize=preser)
        sess = [_hinted_session(b, f"s{i}") for i in range(3)]
        sess[0].subscribe("m/+", SubOpts(qos=1))
        sess[1].subscribe("m/a", SubOpts(qos=2))
        sess[2].subscribe("m/#", SubOpts(qos=0))
        for _ in range(3):
            b.publish_batch([Message(topic="m/a", qos=2, from_="p"),
                             Message(topic="m/b", qos=1, from_="p"),
                             Message(topic="m/a", qos=0, from_="p")])
        outs.append((
            [[(pid, m.topic, m.qos, m.flags.get("dup", False))
              for pid, m in s.outbox] for s in sess],
            [sorted(pid for pid, _ in s.inflight.to_list())
             for s in sess],
            _metric_deltas(b)))
    assert outs[0] == outs[1]


# -- wire-level parity through real connections ---------------------------


async def _egress_run(preserialize: bool):
    from mqtt_client import TestClient

    node = Node(matcher=MatcherConfig(device_min_filters=0),
                dispatch_config=DispatchConfig(preserialize=preserialize),
                device="cpu")
    node.add_listener(port=0)
    await node.start()
    try:
        port = node.listeners[0].port
        a0 = TestClient("a0")                     # v4 qos0
        a1 = TestClient("a1")                     # v4 qos1
        a2 = TestClient("a2", version=C.MQTT_V5)  # v5 qos2
        a3 = TestClient("a3", version=C.MQTT_V5)  # v5 subid slow path
        g1 = TestClient("g1")                     # shared group
        g2 = TestClient("g2")
        pub = TestClient("wp")
        pub5 = TestClient("wp5", version=C.MQTT_V5)
        clients = [a0, a1, a2, a3, g1, g2, pub, pub5]
        for cli in clients:
            await cli.connect(port=port)
        await a0.subscribe("e/+", qos=0)
        await a1.subscribe("e/#", qos=1)
        await a2.subscribe("e/t", qos=2)
        await a3.subscribe("e/+", qos=1,
                           props={"Subscription-Identifier": 7})
        await g1.subscribe("$share/g/e/t", qos=1)
        await g2.subscribe("$share/g/e/t", qos=1)
        expect = {a0: 0, a1: 0, a2: 0, a3: 0}
        for i in range(3):
            await pub.publish("e/t", payload=b"q0-%d" % i, qos=0)
        for i in range(4):
            await pub.publish("e/t", payload=b"q1-%d" % i, qos=1)
        await pub.publish("e/x", payload=b"q1-x", qos=1)
        for i in range(2):
            await pub.publish("e/t", payload=b"q2-%d" % i, qos=2)
        await pub.publish("e/t", payload=b"rt", qos=1, retain=True)
        await pub5.publish("e/t", payload=b"v5p", qos=1,
                           props={"User-Property": [("k", "v")],
                                  "Payload-Format-Indicator": 1})
        await pub5.publish("e/t", payload=b"v5e", qos=1,
                           props={"Message-Expiry-Interval": 120})
        expect = {a0: 13, a1: 13, a2: 12, a3: 13}
        got = []
        for cli in (a0, a1, a2, a3):
            pkts = []
            for _ in range(expect[cli]):
                p = await cli.recv(timeout=5.0)
                props = {k: v for k, v in (p.properties or {}).items()
                         if k != "Message-Expiry-Interval"}
                pkts.append((p.topic, bytes(p.payload), p.qos,
                             p.retain, p.dup, p.packet_id, props))
            pkts.sort(key=lambda t: t[1])
            got.append(pkts)
        shared_total = 0
        for cli in (g1, g2):
            try:
                while True:
                    await asyncio.wait_for(cli.inbox.get(), 0.5)
                    shared_total += 1
            except asyncio.TimeoutError:
                pass
        got.append(shared_total)
        got.append({k: v for k, v in node.metrics.all().items()
                    if v and (k.startswith(("messages.", "delivery.",
                                            "packets.publish")))
                    and k != "delivery.serialize.onloop"})
        onloop = node.metrics.val("delivery.serialize.onloop")
        for cli in clients:
            await cli.close()
        return got, onloop
    finally:
        await node.stop()


def test_wire_parity_preser_on_vs_off():
    async def go():
        return (await asyncio.wait_for(_egress_run(True), LIMIT),
                await asyncio.wait_for(_egress_run(False), LIMIT))

    (on, onloop_on), (off, onloop_off) = asyncio.run(go())
    assert on == off
    # pre-serialization moved the eligible serializes off the loop
    assert onloop_on < onloop_off
    assert all(p[6].get("Subscription-Identifier") == 7 for p in on[3])


def test_onloop_counter_zero_for_eligible_qos1_fanout():
    from mqtt_client import TestClient

    async def run(preser):
        node = Node(matcher=MatcherConfig(device_min_filters=0),
                    dispatch_config=DispatchConfig(preserialize=preser),
                    device="cpu")
        node.add_listener(port=0)
        await node.start()
        try:
            port = node.listeners[0].port
            subs = [TestClient(f"k{i}") for i in range(2)]
            pub = TestClient("kp")
            for cli in subs + [pub]:
                await cli.connect(port=port)
            for cli in subs:
                await cli.subscribe("k/+", qos=1)
            for i in range(6):
                await pub.publish("k/t", payload=b"%d" % i, qos=1)
            for cli in subs:
                for _ in range(6):
                    await cli.recv(timeout=5.0)
            for cli in subs + [pub]:
                await cli.close()
            return node.metrics.val("delivery.serialize.onloop")
        finally:
            await node.stop()

    assert asyncio.run(asyncio.wait_for(run(True), LIMIT)) == 0
    assert asyncio.run(asyncio.wait_for(run(False), LIMIT)) == 12


# -- effective-QoS key regression -------------------------------------------


def _mk_channel(broker, cid, ver=C.MQTT_V4):
    ch = Channel(broker, ConnectionManager(broker=broker))
    ch.wire_fast = True
    out = ch.handle_in(Connect(client_id=cid, proto_ver=ver,
                               proto_name=C.PROTOCOL_NAMES[ver]))
    assert out and out[0].type == C.CONNACK
    return ch


def test_wire_cache_keys_by_effective_qos():
    b = Broker(device="cpu")
    ch = _mk_channel(b, "wc")
    ch.session.subscribe("z/t", SubOpts(qos=0))
    orig = Message(topic="z/t", payload=b"zz", qos=1, from_="p")
    orig.headers["_wire"] = {}
    # a hostile prior: a QoS 1 frame cached under qos byte 1
    q1_frame = wire_serialize(
        Publish(topic="z/t", payload=b"zz", qos=1, packet_id=7),
        C.MQTT_V4)
    orig.headers["_wire"][(C.MQTT_V4, 1, False, False)] = q1_frame
    ch.session.deliver("z/t", orig)
    out = ch.handle_deliver()
    assert len(out) == 1 and type(out[0]) is bytes
    assert out[0] != q1_frame
    assert out[0] == wire_serialize(
        Publish(topic="z/t", payload=b"zz", qos=0), C.MQTT_V4)
    assert orig.headers["_wire"][(C.MQTT_V4, 0, False, False)] == out[0]


def test_template_variant_miss_builds_on_loop_and_caches():
    b = Broker(device="cpu")
    ch = _mk_channel(b, "tm")
    ch.session.subscribe("y/t", SubOpts(qos=1))
    msg = Message(topic="y/t", payload=b"yy", qos=1, from_="p")
    msg.headers["_wiretpl"] = {}  # primed dict, but no variant yet
    base = b.metrics.val("delivery.serialize.onloop")
    ch.session.deliver("y/t", msg)
    out = ch.handle_deliver()
    assert len(out) == 1 and type(out[0]) is bytes
    pid = ch.session.inflight.to_list()[0][0]
    assert out[0] == wire_serialize(
        Publish(topic="y/t", payload=b"yy", qos=1, packet_id=pid),
        C.MQTT_V4)
    assert b.metrics.val("delivery.serialize.onloop") == base + 1
    assert (C.MQTT_V4, 1, False, False) in msg.headers["_wiretpl"]


def test_dispatch_config_defaults_equal_the_jax_package():
    """The port has no config parser: its ``DispatchConfig`` defaults
    are the JAX package's (pre-serialization and the planner on)."""
    port, ref = DispatchConfig(), JDispatchConfig()
    assert (port.planner, port.preserialize) == (True, True)
    assert (port.planner, port.preserialize) == \
        (ref.planner, ref.preserialize)
    assert DispatchConfig(preserialize=False).preserialize is False


# -- the port against the JAX package, on the wire ----------------------------


#: (name, proto_ver, CONNECT properties, [(filter, subopts)], SUBSCRIBE
#: properties)
CLIENTS = (
    ("v3q0", 3, {}, [("e/+", {"qos": 0})], {}),
    ("v4q1", 4, {}, [("e/#", {"qos": 1})], {}),
    ("v4q2", 4, {}, [("e/t", {"qos": 2})], {}),
    ("v5rap", 5, {}, [("e/t", {"qos": 2, "rap": 1})], {}),
    ("v5q0", 5, {}, [("e/#", {"qos": 0})], {}),
    ("v5sid", 5, {}, [("e/+", {"qos": 1})],
     {"Subscription-Identifier": 7}),
    ("share", 4, {}, [("$share/g/e/t", {"qos": 1})], {}),
    ("alias", 5, {"Topic-Alias-Maximum": 4}, [("e/#", {"qos": 1})], {}),
    ("cap0", 5, {"Maximum-Packet-Size": 40}, [("e/#", {"qos": 0})], {}),
    ("cap1", 5, {"Maximum-Packet-Size": 40}, [("e/#", {"qos": 1})], {}),
)

#: (topic, payload, qos, retain, v5 properties)
ROUNDS = (
    [("e/t", b"a", 0, False, {}), ("e/t", b"b", 1, False, {}),
     ("e/x", b"c", 2, False, {}), ("e/t", b"r", 1, True, {}),
     ("e/t", b"big" * 20, 0, False, {}), ("e/t", b"big1" * 15, 1, False, {})],
    [("e/t", b"u", 1, False, {"User-Property": [("k", "v")],
                              "Payload-Format-Indicator": 1}),
     ("e/t", b"x", 1, False, {"Message-Expiry-Interval": 120}),
     ("e/y", b"y", 0, True, {"Content-Type": "text/plain"}),
     ("e/t", b"z", 2, True, {})],
)


def _normal(frame: bytes, ver: int) -> bytes:
    """A frame with its Message-Expiry-Interval countdown (which
    depends on the clock) set back to its interval of 120 after
    checking its bound; every other frame as it is."""
    if ver != C.MQTT_V5 or frame[0] >> 4 != C.PUBLISH:
        return frame
    p = PF.Parser(version=ver)
    (pkt,) = p.feed(frame)
    left = pkt.properties.get("Message-Expiry-Interval")
    if left is None:
        return frame
    assert 117 <= left <= 120, left
    pkt.properties["Message-Expiry-Interval"] = 120
    return PF.serialize(pkt, ver)


def _frames(pkts, ver, serialize):
    return [_normal(p if type(p) is bytes else serialize(p, ver), ver)
            for p in pkts]


def _channels_run(pkg, preserialize):
    """The clients above on one node: their CONNACKs, SUBACKs and
    every delivered frame, and the on-loop serialize count."""
    if pkg == "jax":
        node = JNode(boot_listeners=False,
                     matcher=JMatcherConfig(device_min_filters=0),
                     dispatch_config=JDispatchConfig(
                         preserialize=preserialize))
        Chan, P, M, ser = JChannel, JP, JMessage, JF.serialize
    else:
        node = Node(matcher=MatcherConfig(device_min_filters=0),
                    dispatch_config=DispatchConfig(
                        preserialize=preserialize), device="cpu")
        Chan, P, M, ser = Channel, PP, Message, PF.serialize
    out = {}
    chans = {}
    for name, ver, cprops, subs, sprops in CLIENTS:
        ch = Chan(node.broker, node.cm)
        ch.wire_fast = True
        ch.on_deliver = lambda: None
        got = ch.handle_in(P.Connect(
            client_id=name, proto_ver=ver,
            proto_name=C.PROTOCOL_NAMES[ver], properties=dict(cprops)))
        got += ch.handle_in(P.Subscribe(
            packet_id=1, topic_filters=[(f, dict(o)) for f, o in subs],
            properties=dict(sprops)))
        out[name] = _frames(got, ver, ser)
        chans[name] = (ch, ver)
    for rnd in ROUNDS:
        msgs = []
        for topic, payload, qos, retain, props in rnd:
            headers = {"properties": dict(props)} if props else {}
            msgs.append(M(topic=topic, payload=payload, qos=qos,
                          from_="pub", flags={"retain": retain},
                          headers=headers))
        node.broker.publish_batch(msgs)
        for name, (ch, ver) in chans.items():
            out[name] += _frames(ch.handle_deliver(), ver, ser)
    return out, node.metrics.val("delivery.serialize.onloop")


def test_channel_wire_bytes_equal_on_off_and_the_jax_package():
    runs = {(pkg, pre): _channels_run(pkg, pre)
            for pkg in ("jax", "port") for pre in (True, False)}
    want = runs[("jax", False)][0]
    for key, (frames, _n) in runs.items():
        assert frames == want, key
    # every client got deliveries, the cap dropped the big ones, the
    # alias client's repeats carry no topic
    assert all(len(f) > 2 for f in want.values())
    assert len(want["cap0"]) < len(want["v5q0"])
    # the on-loop serialize count agrees with the JAX package's, and
    # pre-serialization cut it
    assert runs[("port", True)][1] == runs[("jax", True)][1]
    assert runs[("port", False)][1] == runs[("jax", False)][1]
    assert runs[("port", True)][1] < runs[("port", False)][1]


#: retained messages: (topic, payload, qos, v5 properties)
STORED = (("r/a", b"ra", 0, {}), ("r/b", b"rb", 1, {}),
          ("r/c/d", b"rcd", 2, {"User-Property": [("u", "1")]}),
          ("r/e", b"re", 1, {"Message-Expiry-Interval": 120}))
#: subscribers of the replay burst: (name, proto_ver, filter, subopts)
BURST = (("b0", 4, "r/+", {"qos": 0}), ("b1", 4, "r/#", {"qos": 1}),
         ("b2", 5, "r/#", {"qos": 2, "rap": 1}),
         ("b3", 3, "r/c/+", {"qos": 1}), ("b4", 5, "r/b", {"qos": 1}),
         ("b5", 5, "r/#", {"qos": 0}))


async def _replay_run(pkg, preserialize):
    if pkg == "jax":
        node = JNode(boot_listeners=False,
                     dispatch_config=JDispatchConfig(
                         preserialize=preserialize))
        Chan, P, M, ser, Ret = (JChannel, JP, JMessage, JF.serialize,
                                JRetainer)
    else:
        node = Node(dispatch_config=DispatchConfig(
            preserialize=preserialize), device="cpu",
            boot_listeners=False)
        Chan, P, M, ser, Ret = (Channel, PP, Message, PF.serialize,
                                RetainerModule)
    node.modules.load(Ret, {"index_device_threshold": 0})
    if pkg == "port":
        await node.start()
    try:
        node.broker.publish_batch([
            M(topic=t, payload=p, qos=q, from_="pub",
              flags={"retain": True},
              headers={"properties": dict(pr)} if pr else {})
            for t, p, q, pr in STORED])
        chans = {}
        for name, ver, _f, _o in BURST:
            ch = Chan(node.broker, node.cm)
            ch.wire_fast = True
            ch.on_deliver = lambda: None
            ch.handle_in(P.Connect(client_id=name, proto_ver=ver,
                                   proto_name=C.PROTOCOL_NAMES[ver]))
            chans[name] = (ch, ver)
        before = node.metrics.val("retained.replay.batches")
        for name, ver, flt, opts in BURST:
            chans[name][0].handle_in(P.Subscribe(
                packet_id=1, topic_filters=[(flt, dict(opts))]))
        await asyncio.sleep(0)   # the burst's one replay flush
        assert node.metrics.val("retained.replay.batches") == before + 1
        out = {name: _frames(ch.handle_deliver(), ver, ser)
               for name, (ch, ver) in chans.items()}
        return out, node.metrics.val("delivery.serialize.onloop")
    finally:
        if pkg == "port":
            await node.stop()
        node.modules.unload("retainer")


def test_replay_burst_bytes_equal_on_off_and_the_jax_package():
    async def go():
        return {(pkg, pre): await _replay_run(pkg, pre)
                for pkg in ("jax", "port") for pre in (True, False)}

    runs = asyncio.run(asyncio.wait_for(go(), LIMIT))
    want = runs[("jax", False)][0]
    for key, (frames, _n) in runs.items():
        assert frames == want, key
    assert sum(len(f) for f in want.values()) >= 14
    assert runs[("port", True)][1] == runs[("jax", True)][1]
    assert runs[("port", True)][1] < runs[("port", False)][1]
