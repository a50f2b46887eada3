"""The port's sans-IO MQTT channel against the JAX package's, frame for
frame.

Each test drives the same packet sequence through a JAX ``Channel``
over a JAX ``Broker`` and through the port's ``Channel`` over
``Broker(device="cpu")``, each with its own ``ConnectionManager``.
Packets are built once with the JAX classes and copied field for
field into the port's. After every step the acting channel's answer,
every channel's deliveries (``handle_deliver``) and every out-of-band
send (kick and takeover DISCONNECTs) are serialized with the
channel's protocol version; the two packages' bytes must be equal.

One field is normalised: the client id the server assigns to an
empty CONNECT client id comes from a random GUID in both packages
(``new_guid`` + base62), so the v5 CONNACK's Assigned-Client-Identifier
is replaced by a placeholder of the same length before serializing.
The sequences cover connect, subscribe, QoS 0/1/2 publish with the
full ack flows, unsubscribe and disconnect; the protocol-error cases
of tests/test_channel_fuzz.py (its generators are imported); topic
aliases both ways; a mountpoint; takeover with a resumed session; the
will on abnormal close; keepalive expiry and the retry timer, driven
with ``handle_timeout`` and ``Session.retry(now=...)``, never sleeps.
"""

import dataclasses
import random
import time

import pytest

from emqx_tpu.broker import Broker as JBroker
from emqx_tpu.channel import Channel as JChannel
from emqx_tpu.cm import ConnectionManager as JCM
from emqx_tpu.mqtt import frame as JF
from emqx_tpu.mqtt import packet as JP
from emqx_tpu.zone import Zone as JZone
from emqx_tpu_torch.broker import Broker as PBroker
from emqx_tpu_torch.channel import Channel as PChannel
from emqx_tpu_torch.cm import ConnectionManager as PCM
from emqx_tpu_torch.mqtt import frame as PF
from emqx_tpu_torch.mqtt import packet as PP
from emqx_tpu_torch.zone import Zone as PZone
from test_channel_fuzz import _connect_pkt, _rand_packet

C = JP.C


def to_port(pkt):
    cls = getattr(PP, type(pkt).__name__)
    return cls(**{f.name: getattr(pkt, f.name)
                  for f in dataclasses.fields(pkt)})


def _wire(pkts, ver, serialize):
    out = []
    for p in pkts:
        aid = getattr(p, "properties", {}).get("Assigned-Client-Identifier")
        if aid is not None:
            # random GUID in both packages: same length, fixed text
            p = dataclasses.replace(p, properties={
                **p.properties, "Assigned-Client-Identifier": "#" * len(aid)})
        out.append(serialize(p, ver))
    return out


class Pair:
    """The two packages side by side: brokers, CMs, named channels."""

    def __init__(self, **zone_kw):
        self.jb = JBroker()
        self.pb = PBroker(device="cpu")
        self.jcm = JCM(broker=self.jb)
        self.pcm = PCM(broker=self.pb)
        self.jzone = JZone(name="parity", **zone_kw)
        self.pzone = PZone(name="parity", **zone_kw)
        self.chans = {}
        self.oob = {}

    def open(self, name):
        j = JChannel(self.jb, self.jcm, zone=self.jzone,
                     peername=("10.0.0.1", 1000 + len(self.chans)))
        p = PChannel(self.pb, self.pcm, zone=self.pzone,
                     peername=("10.0.0.1", 1000 + len(self.chans)))
        self.oob[name] = ([], [])
        j.send_oob = self.oob[name][0].extend
        p.send_oob = self.oob[name][1].extend
        for c in (j, p):
            c.on_deliver = lambda: None
        self.chans[name] = (j, p)
        return j, p

    def _drain(self):
        """Every channel's deliveries and out-of-band sends."""
        got = []
        for name, (j, p) in self.chans.items():
            jo = _wire(j.handle_deliver(), j.proto_ver, JF.serialize)
            po = _wire(p.handle_deliver(), p.proto_ver, PF.serialize)
            jb, pb = self.oob[name]
            jo += _wire(jb, j.proto_ver, JF.serialize)
            po += _wire(pb, p.proto_ver, PF.serialize)
            jb.clear()
            pb.clear()
            got.append((name, jo, po))
        return got

    def step(self, name, pkt):
        """One inbound packet on both sides; returns the JAX bytes
        after asserting the port's are equal."""
        j, p = self.chans[name]
        jo = _wire(j.handle_in(pkt), j.proto_ver, JF.serialize)
        po = _wire(p.handle_in(to_port(pkt)), p.proto_ver, PF.serialize)
        assert po == jo, (name, pkt)
        for who, a, b in self._drain():
            assert b == a, (who, pkt)
        assert (j.state, j.closed, j.close_after_send) == \
            (p.state, p.closed, p.close_after_send), (name, pkt)
        return jo

    def both(self, name, fn):
        """Run ``fn(channel)`` on both sides, then compare the drain."""
        j, p = self.chans[name]
        fn(j)
        fn(p)
        for who, a, b in self._drain():
            assert b == a, (who, "both")


def _connect(ver, cid, clean=True, **kw):
    return JP.Connect(proto_ver=ver, proto_name=C.PROTOCOL_NAMES[ver],
                      client_id=cid, clean_start=clean, **kw)


@pytest.mark.parametrize("ver", [3, 4, 5])
def test_qos_flows_subscribe_unsubscribe_disconnect(ver):
    pr = Pair()
    pr.open("sub")
    pr.open("pub")
    assert pr.step("sub", _connect(ver, "sub"))
    pr.step("pub", _connect(5, "pub"))
    pr.step("sub", JP.Subscribe(packet_id=1, topic_filters=[
        ("t/+", {"qos": 1}), ("t/#", {"qos": 2}), ("x/y", {"qos": 0}),
        ("bad/#/x", {"qos": 0}), ("$share/g/t/s", {"qos": 2})]))
    for qos, pid in ((0, None), (1, 11), (2, 12)):
        for topic in ("t/a", "t/s", "x/y", "none"):
            pr.step("pub", JP.Publish(topic=topic, qos=qos, packet_id=pid,
                                      payload=b"m%d" % qos))
    # the publisher finishes its QoS2 flow, the subscriber acks
    pr.step("pub", JP.PubAck(type=C.PUBREL, packet_id=12))
    pr.step("pub", JP.PubAck(type=C.PUBREL, packet_id=99))  # unknown
    j, p = pr.chans["sub"]
    inflight = sorted(j.session.inflight.keys())
    assert inflight == sorted(p.session.inflight.keys())
    for pid in inflight:
        pr.step("sub", JP.PubAck(type=C.PUBACK, packet_id=pid))
        pr.step("sub", JP.PubAck(type=C.PUBREC, packet_id=pid))
        pr.step("sub", JP.PubAck(type=C.PUBCOMP, packet_id=pid))
    pr.step("sub", JP.Unsubscribe(packet_id=2,
                                  topic_filters=["t/+", "no/such"]))
    pr.step("pub", JP.Publish(topic="t/a", qos=1, packet_id=13,
                              payload=b"after"))
    pr.step("sub", JP.Pingreq())
    pr.step("sub", JP.Disconnect())
    pr.step("pub", JP.Publish(topic="t/a", qos=1, packet_id=14,
                              payload=b"gone"))


@pytest.mark.parametrize("ver", [3, 4, 5])
def test_protocol_error_sequences_of_the_channel_fuzz(ver):
    """tests/test_channel_fuzz.py's random sequences (duplicate
    CONNECT, PUBLISH to wildcards and ``$SYS``, unknown acks, AUTH,
    DISCONNECT with will, packets before CONNECT), closed channels
    replaced by fresh ones as there."""
    for seed in range(12):
        rng = random.Random(7000 + 100 * ver + seed)
        pr = Pair()
        n = 0
        pid_pool = []
        while n < 80:
            name = f"c{n}"
            j, _p = pr.open(name)
            while n < 80 and not j.closed:
                if j.state == "idle" and rng.random() < 0.9:
                    pkt = _connect_pkt(rng, ver)
                else:
                    pkt = _rand_packet(rng, ver, pid_pool)
                n += 1
                for data in pr.step(name, pkt):
                    if data[0] >> 4 == C.PUBLISH and data[0] & 0x06:
                        pid_pool.append(JF.Parser(version=ver).feed(
                            data)[0].packet_id)


def test_topic_alias_in_and_out():
    pr = Pair()
    pr.open("sub")
    pr.open("pub")
    pr.step("sub", _connect(5, "sub", properties={"Topic-Alias-Maximum": 2}))
    pr.step("pub", _connect(5, "pub"))
    pr.step("sub", JP.Subscribe(packet_id=1,
                                topic_filters=[("al/#", {"qos": 1})]))
    for i, (topic, alias) in enumerate([("al/a", 1), ("", 1), ("al/b", 2),
                                        ("", 2), ("al/c", 1), ("", 1),
                                        ("al/d", None), ("al/a", None)]):
        props = {} if alias is None else {"Topic-Alias": alias}
        pr.step("pub", JP.Publish(topic=topic, qos=1, packet_id=i + 1,
                                  payload=b"%d" % i, properties=props))
    # an unknown alias, then alias 0: protocol errors that disconnect
    pr.step("pub", JP.Publish(topic="", qos=0, payload=b"x",
                              properties={"Topic-Alias": 7}))
    pr.open("pub2")
    pr.step("pub2", _connect(5, "pub2"))
    pr.step("pub2", JP.Publish(topic="al/z", qos=0, payload=b"x",
                               properties={"Topic-Alias": 0}))


def test_mountpoint():
    pr = Pair(mountpoint="m/%c/")
    pr.open("a")
    pr.open("b")
    pr.step("a", _connect(4, "a"))
    pr.step("b", _connect(5, "b"))
    pr.step("a", JP.Subscribe(packet_id=1, topic_filters=[
        ("x/#", {"qos": 1}), ("$share/g/y/+", {"qos": 1})]))
    pr.step("b", JP.Subscribe(packet_id=1,
                              topic_filters=[("#", {"qos": 0})]))
    for i, t in enumerate(["x/1", "y/2", "z"]):
        pr.step("a", JP.Publish(topic=t, qos=1, packet_id=i + 1,
                                payload=b"a"))
        pr.step("b", JP.Publish(topic=t, qos=0, payload=b"b"))
    assert sorted(pr.jb._subscribers) == sorted(pr.pb._subscribers)
    pr.step("a", JP.Unsubscribe(packet_id=2, topic_filters=["x/#"]))


@pytest.mark.parametrize("ver", [4, 5])
def test_takeover_resumes_the_session(ver):
    props = {"Session-Expiry-Interval": 300} if ver == 5 else {}
    pr = Pair()
    pr.open("old")
    pr.open("pub")
    pr.step("pub", _connect(4, "pub"))
    pr.step("old", _connect(ver, "dev", clean=False, properties=props))
    pr.step("old", JP.Subscribe(packet_id=1,
                                topic_filters=[("d/#", {"qos": 1})]))
    for i in range(3):  # left unacked in the old connection's window
        pr.step("pub", JP.Publish(topic="d/x", qos=1, packet_id=i + 1,
                                  payload=b"%d" % i))
    pr.open("new")
    out = pr.step("new", _connect(ver, "dev", clean=False,
                                  properties=props))
    assert out[0][2] == 1  # session present, replay follows
    j, p = pr.chans["old"]
    assert j.closed and p.closed
    pr.step("pub", JP.Publish(topic="d/y", qos=1, packet_id=9,
                              payload=b"new"))
    pr.step("new", JP.Disconnect())
    # detached: the session queues, then a reconnect replays it
    pr.step("pub", JP.Publish(topic="d/z", qos=1, packet_id=10,
                              payload=b"queued"))
    pr.open("again")
    pr.step("again", _connect(ver, "dev", clean=False, properties=props))
    # a clean start discards the stored session and kicks the owner
    pr.open("clean")
    pr.step("clean", _connect(ver, "dev", clean=True))
    assert pr.jcm.session_count() == pr.pcm.session_count()


@pytest.mark.parametrize("ver", [4, 5])
def test_will_on_abnormal_close(ver):
    pr = Pair()
    pr.open("w")
    pr.open("s")
    pr.step("s", _connect(5, "s"))
    pr.step("s", JP.Subscribe(packet_id=1,
                              topic_filters=[("will/#", {"qos": 2})]))
    will = dict(will_flag=True, will_topic="will/w", will_payload=b"bye",
                will_qos=1, will_retain=False)
    pr.step("w", _connect(ver, "w", **will))
    pr.both("w", lambda c: c._shutdown())  # socket lost: the will fires
    pr.open("w2")
    pr.step("w2", _connect(ver, "w2", **will))
    pr.step("w2", JP.Disconnect())  # clean: no will
    if ver == 5:
        pr.open("w3")
        pr.step("w3", _connect(ver, "w3", **will))
        pr.step("w3", JP.Disconnect(reason_code=0x04))  # with will


@pytest.mark.parametrize("ver", [4, 5])
def test_keepalive_and_retry_timers(ver):
    """Keepalive expiry and the retry timer, driven by byte counts and
    an injected ``now``."""
    pr = Pair()
    pr.open("s")
    pr.open("p")
    pr.step("s", _connect(ver, "s", keepalive=10))
    pr.step("p", _connect(ver, "p", keepalive=10))
    pr.step("s", JP.Subscribe(packet_id=1,
                              topic_filters=[("r/#", {"qos": 2})]))
    pr.step("p", JP.Publish(topic="r/1", qos=1, packet_id=1, payload=b"1"))
    pr.step("p", JP.Publish(topic="r/2", qos=2, packet_id=2, payload=b"2"))
    now = time.time() + 31.0  # past the 30 s retry interval
    pr.both("s", lambda c: c.session.retry(now=now))
    j, p = pr.chans["s"]
    pid = sorted(j.session.inflight.keys())[-1]
    pr.step("s", JP.PubAck(type=C.PUBREC, packet_id=pid))
    pr.both("s", lambda c: c.session.retry(now=now + 31.0))  # PUBREL again
    for c in pr.chans["p"]:
        assert c.handle_timeout("keepalive", 100) == []  # bytes arrived
    jo = _wire(j.handle_timeout("keepalive", 0), ver, JF.serialize)
    po = _wire(p.handle_timeout("keepalive", 0), ver, PF.serialize)
    assert po == jo and (j.closed, p.closed) == (True, True)
    pr.both("p", lambda c: c.session.expire_awaiting_rel(now=now + 400))
    assert pr.jb.metrics.val("messages.dropped.expired") == \
        pr.pb.metrics.val("messages.dropped.expired") == 1


def test_shared_group_redispatch_when_a_member_dies():
    """A shared member's unacked QoS 1 messages go to the surviving
    member when its connection dies (DUP set: they were sent)."""
    pr = Pair()
    for name in ("a", "b", "p"):
        pr.open(name)
        pr.step(name, _connect(5 if name == "b" else 4, name))
    for name in ("a", "b"):
        pr.step(name, JP.Subscribe(packet_id=1, topic_filters=[
            ("$share/g/w/+", {"qos": 1})]))
    for i in range(4):
        pr.step("p", JP.Publish(topic="w/%d" % i, qos=1, packet_id=i + 1,
                                payload=b"%d" % i))
    pr.both("a", lambda c: c._shutdown())
    j, p = pr.chans["b"]
    assert sorted(j.session.inflight.keys()) == \
        sorted(p.session.inflight.keys())
    assert pr.jb.metrics.val("messages.redispatched") == \
        pr.pb.metrics.val("messages.redispatched") > 0
