"""The port's MQTT front door over live loopback sockets, frame for
frame against the JAX package's.

A JAX ``Node`` and a port ``Node(device="cpu")`` each get a listener
on port 0, and the same script runs against each. Its clients speak
through tests/indie_mqtt.py, a codec written independently of both
packages; they record every frame the broker sends them, byte for
byte, and answer QoS 1/2 flows as a client library does (PUBACK,
PUBREC, PUBREL, PUBCOMP). The frames each client received must be
equal between the two nodes.

The port's node routes with the device path (``device_min_filters=1``):
the ingress batcher's begin, off-loop fetch and chunked finish over
the plain twins of kernels B1 and B2, and retained replay through the
plain twin of B3 (``index_device_threshold=1``). The JAX node keeps
its defaults.

The scripts cover tests/test_integration.py's cases: QoS 0/1/2 round
trips, wildcard and ``$SYS`` isolation, unsubscribe, shared
subscriptions, takeover, the offline queue, clean start, wills, v5
topic aliases both ways, QoS downgrade, mountpoints and the error
CONNACK; and retained messages on subscribe. A script never sleeps:
it waits for the frames it expects, and for what shows on no wire (a
socket's close reaching the server) on the node's
``client.disconnected`` hook. Each test runs under its own
``asyncio.wait_for`` limit.
"""

import asyncio

import pytest

import indie_mqtt as im
from emqx_tpu.modules.retainer import RetainerModule as JRetainer
from emqx_tpu.node import Node as JNode
from emqx_tpu.types import Message as JMessage
from emqx_tpu.zone import Zone as JZone
from emqx_tpu_torch.modules.retainer import RetainerModule as PRetainer
from emqx_tpu_torch.node import Node as PNode
from emqx_tpu_torch.router import MatcherConfig
from emqx_tpu_torch.types import Message as PMessage
from emqx_tpu_torch.zone import Zone as PZone

LIMIT = 60.0


class Raw:
    """A client over the independent codec that records the raw
    frames it receives."""

    def __init__(self, node, name, version=4, clean=True, auto_ack=True,
                 **connect_kw):
        self.node = node
        self.name = name
        self.version = version
        self.clean = clean
        self.auto_ack = auto_ack
        self.connect_kw = dict(keepalive=0, **connect_kw)
        self.frames = []
        self.want = 0  # frames the script expects by now
        self.closed = asyncio.Event()
        self._new = asyncio.Event()
        self._pid = 0

    async def open(self):
        self.reader, self.writer = await asyncio.open_connection(
            "127.0.0.1", self.node.port)
        self._task = asyncio.get_running_loop().create_task(self._read())

    async def connect(self, frames=1):
        await self.open()
        await self.send(im.build_connect(self.name, version=self.version,
                                         clean=self.clean,
                                         **self.connect_kw))
        await self.more(frames)
        return self

    async def _read(self):
        try:
            while True:
                h = await self.reader.readexactly(1)
                n, mult, raw = 0, 1, bytearray(h)
                while True:
                    b = (await self.reader.readexactly(1))[0]
                    raw.append(b)
                    n += (b & 0x7F) * mult
                    mult *= 128
                    if not b & 0x80:
                        break
                body = await self.reader.readexactly(n) if n else b""
                raw += body
                self.frames.append(bytes(raw))
                self._new.set()
                if self.auto_ack:
                    await self._answer(h[0] >> 4, h[0] & 0x0F, body)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self.closed.set()
            self._new.set()

    async def _answer(self, ptype, flags, body):
        p = im.decode(ptype, flags, body, self.version)
        reply = {(im.PUBLISH, 1): im.PUBACK, (im.PUBLISH, 2): im.PUBREC,
                 (im.PUBREC, None): im.PUBREL,
                 (im.PUBREL, None): im.PUBCOMP}.get(
            (ptype, p.qos if ptype == im.PUBLISH else None))
        if reply is not None:
            await self.send(im.build_puback_like(reply, p.pkt_id,
                                                 self.version))

    async def send(self, data):
        self.writer.write(data)
        await self.writer.drain()

    async def until(self, total):
        """Wait until ``total`` frames have arrived in all."""
        self.want = max(self.want, total)
        while len(self.frames) < total:
            if self.closed.is_set():
                raise AssertionError(f"{self.name}: closed after "
                                     f"{len(self.frames)} of {total}")
            self._new.clear()
            await self._new.wait()

    async def more(self, n):
        """Wait for ``n`` more frames than the script expected so far
        (some may have arrived already)."""
        await self.until(self.want + n)

    def pid(self):
        self._pid += 1
        return self._pid

    async def publish(self, topic, payload, qos=0, retain=False,
                      props=None, acks=None):
        pid = self.pid() if qos else 0
        await self.send(im.build_publish(topic, payload, qos=qos,
                                         retain=retain, pkt_id=pid,
                                         version=self.version, props=props))
        await self.more(qos if acks is None else acks)

    async def subscribe(self, *filters, extra=0):
        fl = [(f, 0) if isinstance(f, str) else f for f in filters]
        await self.send(im.build_subscribe(self.pid(), fl, self.version))
        await self.more(1 + extra)

    async def unsubscribe(self, *filters):
        await self.send(im.build_unsubscribe(self.pid(), list(filters),
                                             self.version))
        await self.more(1)

    async def disconnect(self, rc=0):
        await self.send(im.build_disconnect(self.version, rc=rc))
        await self.closed.wait()

    async def close(self):
        self.writer.close()
        await self.closed.wait()


class Live:
    """One node with a listener on port 0, the script's clients, and
    the events of its ``client.disconnected`` hook."""

    def __init__(self, node, message_cls):
        self.node = node
        self.Message = message_cls
        self.clients = {}
        self.gone = {}
        node.hooks.add("client.disconnected", self._on_disconnected)

    def _on_disconnected(self, clientinfo, _reason):
        self.gone.setdefault(clientinfo["clientid"],
                             asyncio.Event()).set()

    async def server_saw_close(self, cid):
        """Wait for the server's teardown of ``cid``'s last connection
        (each teardown is waited for once)."""
        await self.gone.setdefault(cid, asyncio.Event()).wait()
        del self.gone[cid]

    @property
    def port(self):
        return self.node.listeners[0].port

    def client(self, name, **kw):
        c = Raw(self, name, **kw)
        self.clients[name + "#%d" % len(self.clients)] = c
        return c

    def frames(self):
        return {k: c.frames for k, c in self.clients.items()}


async def _run(script, zone=None, retainer=False):
    """The script on the JAX node, then on the port's; their frames."""
    out = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            node = JNode(zone=JZone(**zone) if zone else None)
            mcls, ret = JMessage, JRetainer
        else:
            node = PNode(zone=PZone(**zone) if zone else None,
                         matcher=MatcherConfig(device_min_filters=1),
                         device="cpu")
            mcls, ret = PMessage, PRetainer
        if retainer:
            node.modules.load(ret, {"index_device_threshold": 1})
        node.add_listener(port=0)
        await node.start()
        live = Live(node, mcls)
        try:
            await script(live)
        finally:
            for c in live.clients.values():
                c.writer.close()
                await c.closed.wait()
                await c.writer.wait_closed()
            await node.stop()
        out.append(live.frames())
    # the port's publishes went through the ingress batcher's device path
    return out, node.ingress.stats()["ingress.device_batches"]


def _check(script, device_batches=True, **kw):
    async def go():
        return await asyncio.wait_for(_run(script, **kw), LIMIT)

    (want, got), n_device = asyncio.run(go())
    assert (n_device > 0) == device_batches
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name
    assert sum(len(f) for f in want.values()) > 0


async def _qos_round_trips(lv):
    sub = await lv.client("sub").connect()
    pub = await lv.client("pub", version=5).connect()
    await sub.subscribe(("q/+", 2), "t/#")
    for qos in (0, 1, 2):
        await pub.publish("q/a", b"one%d" % qos, qos=qos)
        await sub.more(1 + (qos == 2))  # PUBLISH, and PUBREL at QoS 2
        await pub.publish("t/1", b"hello", qos=qos)
        await sub.more(1)
    await pub.publish("nobody", b"x", qos=1)  # v5: no matching subscribers
    await sub.send(im.build_pingreq())
    await sub.more(1)
    await sub.disconnect()
    await pub.disconnect()


async def _wildcard_sys_unsubscribe(lv):
    sub = await lv.client("subw").connect()
    pub = await lv.client("pubw").connect()
    await sub.subscribe("#", "u/t")
    await pub.publish("any/topic", b"x")
    await sub.more(1)
    lv.node.publish(lv.Message(topic="$SYS/heartbeat", payload=b"no"))
    await pub.publish("plain", b"yes")
    await sub.more(1)  # the $SYS message did not arrive before it
    await sub.unsubscribe("#")
    await pub.publish("u/t", b"1", qos=1)
    await sub.more(1)
    await sub.unsubscribe("u/t")
    await pub.publish("u/t", b"2", qos=1)
    await sub.subscribe("barrier")
    await pub.publish("barrier", b"b")
    await sub.more(1)


async def _shared(lv):
    a = await lv.client("wa").connect()
    b = await lv.client("wb").connect()
    p = await lv.client("wp").connect()
    await a.subscribe(("$share/g/work", 1))
    await b.subscribe(("$share/g/work", 1))
    for i in range(6):
        await p.publish("work", b"%d" % i, qos=1)
    await a.until(2 + 3)
    await b.until(2 + 3)


async def _takeover_offline_clean(lv):
    c1 = await lv.client("same", version=5, clean=False,
                         props={"Session-Expiry-Interval": 300}).connect()
    await c1.subscribe(("keep/me", 1))
    c2 = lv.client("same", version=5, clean=False,
                   props={"Session-Expiry-Interval": 300})
    await c2.connect()
    await c1.closed.wait()  # DISCONNECT 0x8E, then the close
    p = await lv.client("tp").connect()
    await p.publish("keep/me", b"alive", qos=1)
    await c2.more(1)
    # the offline queue of a persistent v4 session
    o1 = await lv.client("pers", clean=False).connect()
    await o1.subscribe(("off/line", 1))
    await o1.close()
    await lv.server_saw_close("pers")
    await p.publish("off/line", b"queued", qos=1)
    o2 = lv.client("pers", clean=False)
    await o2.connect(frames=2)  # CONNACK (session present), the message
    # a clean start discards it
    await o2.close()
    await lv.server_saw_close("pers")
    o3 = await lv.client("pers", clean=True).connect()
    await p.publish("off/line", b"gone", qos=1)
    await o3.subscribe("barrier")
    await p.publish("barrier", b"b")
    await o3.more(1)


async def _wills(lv):
    obs = await lv.client("obs").connect()
    await obs.subscribe(("wills/#", 1))
    will = {"topic": "wills/t", "payload": b"died", "qos": 1}
    w = await lv.client("willful", will=will).connect()
    await w.close()  # abrupt: the will fires
    await obs.more(1)
    polite = await lv.client("polite", will=dict(will, payload=b"no")) \
        .connect()
    await polite.disconnect()  # clean: no will
    v5 = await lv.client("v5w", version=5, will=dict(
        will, payload=b"rc4")).connect()
    await v5.disconnect(rc=0x04)  # a client's DISCONNECT: no will either
    await obs.publish("wills/end", b"barrier", qos=1, acks=2)


async def _aliases_and_downgrade(lv):
    sub = await lv.client("als", version=5,
                          props={"Topic-Alias-Maximum": 2}).connect()
    await sub.subscribe(("ali/#", 1), ("d/t", 0))
    p = await lv.client("alp", version=5).connect()
    for topic, alias in (("ali/x", 4), ("", 4), ("ali/y", 5), ("", 5),
                         ("ali/z", None), ("ali/x", None)):
        props = {"Topic-Alias": alias} if alias else None
        await p.publish(topic, b"a", qos=1, props=props)
        await sub.more(1)
    await p.publish("d/t", b"x", qos=2)
    await sub.more(1)  # downgraded to QoS 0
    bad = await lv.client("bad", version=5).connect()
    await bad.send(im.build_publish("", b"x", version=5,
                                    props={"Topic-Alias": 9}))
    await bad.closed.wait()  # DISCONNECT protocol error, then the close


async def _retained(lv):
    p = await lv.client("rp").connect()
    for i in range(6):
        await p.publish(f"r/{i % 2}/{i}", b"v%d" % i, qos=1 + i % 2,
                        retain=True)
    await p.publish("r/1/1", b"", retain=True)  # deletes r/1/1
    s = await lv.client("rs", version=5).connect()
    await s.subscribe(("r/+/#", 1), extra=5)
    t = await lv.client("rt").connect()
    await t.subscribe(("r/0/4", 2), extra=1)  # stored at QoS 1
    await p.publish("r/0/9", b"live", qos=1, retain=True)
    await s.more(1)


async def _mountpoint(lv):
    c = await lv.client("cli1").connect()
    await c.subscribe(("up/+", 1), ("$queue/t", 1))
    await c.publish("up/x", b"ours", qos=1, acks=2)  # PUBACK + delivery
    await c.publish("t", b"job", qos=1, acks=2)


async def _error_connack(lv):
    c = lv.client("denied")
    await c.open()
    await c.send(im.build_connect("denied"))
    await c.closed.wait()
    r = lv.client("first")
    await r.open()
    await r.send(im.build_pingreq())  # CONNECT must come first
    await r.closed.wait()


@pytest.mark.parametrize("script", [
    _qos_round_trips, _wildcard_sys_unsubscribe, _shared,
    _takeover_offline_clean, _wills, _aliases_and_downgrade],
    ids=lambda f: f.__name__.strip("_"))
def test_live_frames_equal_jax_node(script):
    _check(script)


def test_retained_on_subscribe_equal_jax_node():
    _check(_retained, retainer=True)


def test_mountpoint_equal_jax_node():
    _check(_mountpoint, zone={"name": "mp", "mountpoint": "dev/%c/"})


def test_error_connack_equal_jax_node():
    _check(_error_connack, device_batches=False,
           zone={"name": "noauth", "allow_anonymous": False})
