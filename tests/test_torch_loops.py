"""The port's multi-loop front door (``emqx_tpu_torch.loops``,
``Node(loops=n)``) against its single-loop node and the JAX package's.

The parity workload of tests/test_frontdoor_loops.py — QoS 0 fan-out,
QoS 1/2 per-subscriber frames, a subscription identifier, a shared
group and a retained publish, over live loopback sockets — runs on a
JAX ``Node`` and on port ``Node(device="cpu")``s at ``loops`` 1, 2 and
4. What each client received (topic, payload, QoS, retain, DUP, packet
id, properties) and the shared group's total must be equal: the port
at 2 and 4 loops to the port at one loop, and that to the JAX
package's node; the message and delivery counters, the port at 2 and 4
loops to the port at one loop (a slow host can raise the JAX node's
overload alarm, whose ``$SYS`` publish counts). Exact equality
everywhere.

The port's node routes with the device path (``device_min_filters=0``;
the JAX node at its defaults, on its host trie, so that no batch waits
on a first compile):
the ingress batcher's begin, off-loop fetch and chunked finish over the
plain twins of kernels B1 and B2; a retained SUBSCRIBE accepted by a
peer loop replays there through B3's plain twin. The ring's own
invariants are held as in the JAX suite (handoffs at most one a peer
loop a batch, deterministic round-robin placement, no on-loop serialize
for eligible traffic, the cross-loop takeover), and tests/test_chaos.py's
multi-loop cases run on the port: a dead loop healed with its wills
fired, a dropped handoff bounded and counted, a takeover of a session
on a stalled loop timing out into a fresh session. Each test runs under
its own ``asyncio.wait_for`` limit.
"""

import asyncio
import functools
import threading
import time

import pytest

from emqx_tpu.broker import DispatchConfig as JDispatchConfig
from emqx_tpu.config import ConfigError as JConfigError
from emqx_tpu.config import parse_config as jparse_config
from emqx_tpu.modules.retainer import RetainerModule as JRetainer
from emqx_tpu.mqtt import constants as C
from emqx_tpu.node import Node as JNode
from emqx_tpu_torch import faults as pfaults
from emqx_tpu_torch.broker import DispatchConfig as PDispatchConfig
from emqx_tpu_torch.config import ConfigError as PConfigError
from emqx_tpu_torch.config import parse_config as pparse_config
from emqx_tpu_torch.modules import retainer as pretainer
from emqx_tpu_torch.modules.retainer import RetainerModule as PRetainer
from emqx_tpu_torch.node import Node as PNode
from emqx_tpu_torch.router import MatcherConfig as PMatcherConfig
from emqx_tpu_torch.types import Message as PMessage

from mqtt_client import TestClient

LIMIT = 60.0

#: metric keys whose deltas depend on timing (wakeup coalescing; the
#: handoff counts scale with how publishes landed in batch ticks): left
#: out of the equality, the xloop ones asserted on their own
_TIMING_KEYS = ("delivery.wakeups", "delivery.xloop.handoffs",
                "delivery.xloop.deliveries")


def port_node(loops=1, **kw):
    kw.setdefault("matcher", PMatcherConfig(device_min_filters=0))
    return PNode(device="cpu", boot_listeners=False, loops=loops, **kw)


def jax_node(loops=1, **kw):
    """The JAX package's node at its matcher defaults: these few filters
    match on its host trie, so no batch waits on a first compile (the
    deliveries are the device path's, and the port's node is held to
    them)."""
    return JNode(boot_listeners=False, loops=loops, **kw)


class running:
    """``async with running(node) as port``: a listener on port 0,
    started; stopped on the way out."""

    def __init__(self, node):
        self.node = node

    async def __aenter__(self):
        self.node.add_listener(port=0)
        await self.node.start()
        return self.node.listeners[0].port

    async def __aexit__(self, *exc):
        await self.node.stop()


def within(coro_fn):
    """Run an async test body under the module's time limit."""
    @functools.wraps(coro_fn)
    async def run(*a, **kw):
        await asyncio.wait_for(coro_fn(*a, **kw), LIMIT)
    return run


async def _workload(node, loops):
    """The JAX suite's parity workload on ``node``; returns (what the
    clients got, the ring's counters)."""
    async with running(node) as port:
        a0 = TestClient("a0")                     # v4 qos0
        a1 = TestClient("a1")                     # v4 qos1
        a2 = TestClient("a2", version=C.MQTT_V5)  # v5 qos2
        a3 = TestClient("a3", version=C.MQTT_V5)  # v5 subid slow path
        a4 = TestClient("a4")                     # v4 qos1 literal
        g1 = TestClient("g1")                     # shared group
        g2 = TestClient("g2")
        pub = TestClient("wp")
        clients = [a0, a1, a2, a3, a4, g1, g2, pub]
        # sequential connects: deterministic round-robin placement
        for cli in clients:
            await cli.connect(port=port)
        await a0.subscribe("L/+", qos=0)
        await a1.subscribe("L/#", qos=1)
        await a2.subscribe("L/t", qos=2)
        await a3.subscribe("L/+", qos=1,
                           props={"Subscription-Identifier": 7})
        await a4.subscribe("L/t", qos=1)
        await g1.subscribe("$share/g/L/t", qos=1)
        await g2.subscribe("$share/g/L/t", qos=1)
        on_t = [a0, a1, a2, a3, a4]
        on_x = [a0, a1, a3]
        expect = {c: 0 for c in on_t}
        for i in range(3):
            await pub.publish("L/t", payload=b"q0-%d" % i, qos=0)
            for c in on_t:
                expect[c] += 1
        for i in range(4):
            await pub.publish("L/t", payload=b"q1-%d" % i, qos=1)
            for c in on_t:
                expect[c] += 1
        await pub.publish("L/x", payload=b"q1-x", qos=1)
        for c in on_x:
            expect[c] += 1
        for i in range(2):
            await pub.publish("L/t", payload=b"q2-%d" % i, qos=2)
            for c in on_t:
                expect[c] += 1
        await pub.publish("L/t", payload=b"rt", qos=1, retain=True)
        for c in on_t:
            expect[c] += 1
        got = []
        for cli in on_t:
            pkts = []
            for _ in range(expect[cli]):
                p = await cli.recv(timeout=5.0)
                pkts.append((p.topic, bytes(p.payload), p.qos, p.retain,
                             p.dup, p.packet_id,
                             dict(p.properties or {})))
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
                    if v and k.startswith(("messages.", "delivery.",
                                           "packets.publish"))
                    and k not in _TIMING_KEYS
                    and k != "delivery.serialize.onloop"})
        xstats = {
            "handoffs": node.metrics.val("delivery.xloop.handoffs"),
            "xdeliveries": node.metrics.val("delivery.xloop.deliveries"),
            "orphaned": node.metrics.val("delivery.xloop.orphaned"),
            "onloop": node.metrics.val("delivery.serialize.onloop"),
            "flushes": node.ingress.flushes,
        }
        for cli in clients:
            await cli.close()
        return got, xstats


_BASE = {}


async def _baseline():
    """The port's one-loop run and the JAX package's, once a module."""
    if not _BASE:
        port = await _workload(port_node(1), 1)
        jax = await _workload(jax_node(1, dispatch_config=JDispatchConfig()),
                              1)
        _BASE.update(port=port, jax=jax)
    return _BASE["port"], _BASE["jax"]


@pytest.mark.parametrize("loops", [2, 4])
@within
async def test_delivery_parity_vs_single_loop_and_jax(loops):
    (base, base_x), (jax, jax_x) = await _baseline()
    # the wire content and the shared total equal the JAX package's;
    # its counters are not compared: a slow host can raise the overload
    # alarm there, and the alarm's $SYS publish counts as a received
    # message
    assert base[:-1] == jax[:-1]
    assert base_x["handoffs"] == jax_x["handoffs"] == 0
    multi, multi_x = await _workload(
        port_node(loops, dispatch_config=PDispatchConfig()), loops)
    # wire content, pid sequences, delivery counts, counter deltas —
    # the same whatever loop each session landed on
    assert multi == base
    assert multi_x["xdeliveries"] > 0
    assert 0 < multi_x["handoffs"] <= multi_x["flushes"] * (loops - 1)
    # (the JAX node's host path serializes every delivery on the loop:
    # its count is not the device path's)
    assert multi_x["onloop"] == base_x["onloop"]
    assert multi_x["orphaned"] == 0


@within
async def test_onloop_stays_zero_for_eligible_traffic_across_ring():
    node = port_node(2)
    async with running(node) as port:
        subs = [TestClient(f"z{i}") for i in range(4)]
        pub = TestClient("zp")
        for cli in subs + [pub]:
            await cli.connect(port=port)
        for cli in subs:
            await cli.subscribe("z/+", qos=1)
        for i in range(6):
            await pub.publish("z/t", payload=b"%d" % i, qos=1)
        for cli in subs:
            for _ in range(6):
                await cli.recv(timeout=5.0)
        assert node.metrics.val("delivery.serialize.onloop") == 0
        assert node.metrics.val("delivery.xloop.deliveries") > 0
        for cli in subs + [pub]:
            await cli.close()


@within
async def test_round_robin_placement_is_deterministic():
    node = port_node(3)
    async with running(node) as port:
        clients = [TestClient(f"rr{i}") for i in range(7)]
        for cli in clients:
            await cli.connect(port=port)
        # conn k lands on loop k % 3: 7 conns -> [3, 2, 2]
        assert node.listeners[0].loop_connections() == [3, 2, 2]
        node.tick()
        assert [node.stats.getstat(f"loop.{i}.connections")
                for i in range(3)] == [3, 2, 2]
        for cli in clients:
            await cli.close()
        for _ in range(100):
            if node.listeners[0].loop_connections() == [0, 0, 0]:
                break
            await asyncio.sleep(0.02)
        assert node.listeners[0].loop_connections() == [0, 0, 0]


async def _cross_loop_takeover(node):
    async with running(node) as port:
        tk1 = TestClient("tk", version=C.MQTT_V5, clean_start=False,
                         properties={"Session-Expiry-Interval": 300})
        await tk1.connect(port=port)          # conn 1 -> loop 0
        await tk1.subscribe("tk/t", qos=1)
        pub = TestClient("tkp")
        await pub.connect(port=port)          # conn 2 -> loop 1
        await pub.publish("tk/t", payload=b"before", qos=1)
        p = await tk1.recv(timeout=5.0)
        assert node.listeners[0].loop_connections() == [1, 1]
        filler = TestClient("fill")
        await filler.connect(port=port)       # conn 3 -> loop 0
        tk2 = TestClient("tk", version=C.MQTT_V5, clean_start=False,
                         properties={"Session-Expiry-Interval": 300})
        await tk2.connect(port=port)          # conn 4 -> loop 1 (!)
        d = await asyncio.wait_for(tk1.acks.get(), 5.0)
        await pub.publish("tk/t", payload=b"after", qos=1)
        p2 = await tk2.recv(timeout=5.0)
        out = (p.payload, tk2.connack.session_present,
               node.metrics.val("session.takeovered"),
               getattr(d, "reason_code", None), p2.payload,
               p2.packet_id > p.packet_id)
        for cli in (tk1, tk2, pub, filler):
            await cli.close()
        return out


@within
async def test_cross_loop_takeover():
    """A reconnect accepted by a DIFFERENT loop takes the live session
    over (marshalled onto the old owning loop), its packet ids go on,
    and later deliveries reach the new owning loop — as on the JAX
    package's two-loop node."""
    got = await _cross_loop_takeover(port_node(2))
    assert got == (b"before", True, 1, 0x8E, b"after", True)
    assert got == await _cross_loop_takeover(jax_node(2))


@within
async def test_loops1_is_the_single_loop_build():
    node = port_node(1)
    async with running(node) as port:
        assert node.loop_group is None
        assert node.broker.loop_group is None
        lst = node.listeners[0]
        assert lst._accept_task is None and lst._server is not None
        assert node.metrics._lock is None
        assert node.ingress.accepts_threadsafe() is False
        c = TestClient("one")
        await c.connect(port=port)
        await c.subscribe("o/t", qos=0)
        await c.publish("o/t", payload=b"hi")
        assert (await c.recv(timeout=5.0)).payload == b"hi"
        assert node.metrics.val("delivery.xloop.handoffs") == 0
        await c.close()


@pytest.mark.parametrize("raw", [{"node": {"loops": 0}},
                                 {"node": {"loops": True}},
                                 {"node": {"loops": 1.5}}])
def test_loops_validation(raw):
    with pytest.raises(JConfigError) as je:
        jparse_config(raw)
    with pytest.raises(PConfigError) as pe:
        pparse_config(raw)
    assert str(pe.value) == str(je.value)
    for bad in (0, True, -1):
        with pytest.raises(ValueError):
            PNode(device="cpu", boot_listeners=False, loops=bad)
    assert pparse_config({"node": {"loops": 4}}).loops == 4


async def _peer_replay(node, Retainer, Message):
    """A retained SUBSCRIBE accepted by loop 1 replays there."""
    mod = node.modules.load(Retainer)
    if hasattr(mod, "index_device_threshold"):
        mod.index_device_threshold = 1   # B3's path, not the host scan
    for i in range(12):
        node.broker.publish(Message(topic=f"rp/{i % 3}/d{i}",
                                    payload=b"v%d" % i,
                                    flags={"retain": True}))
    async with running(node) as port:
        filler = TestClient("rp-fill")
        await filler.connect(port=port)     # conn 1 -> loop 0
        sub = TestClient("rp-sub")
        await sub.connect(port=port)        # conn 2 -> loop 1
        await sub.subscribe("rp/1/+", qos=0)
        got = []
        for _ in range(4):
            p = await sub.recv(timeout=5.0)
            got.append((p.topic, bytes(p.payload), p.retain))
        for cli in (filler, sub):
            await cli.close()
        return sorted(got)


@within
async def test_retained_replay_on_a_peer_loop(monkeypatch):
    """The retained replay of a SUBSCRIBE on loop 1 runs on loop 1's
    thread through B3's entry point (its plain twin on the CPU), and
    replays what the JAX package's two-loop node replays."""
    seen = []
    real = pretainer.match_names_auto

    def recorded(*a):
        seen.append(threading.current_thread().name)
        return real(*a)

    monkeypatch.setattr(pretainer, "match_names_auto", recorded)
    got = await _peer_replay(port_node(2), PRetainer, PMessage)
    from emqx_tpu.types import Message as JMessage
    want = await _peer_replay(jax_node(2), JRetainer, JMessage)
    assert got == want and len(got) == 4
    assert seen == ["frontdoor-loop-1"]


# -- tests/test_chaos.py's multi-loop cases, on the port ---------------------


@within
async def test_dead_loop_heal_closes_connections_and_fires_wills():
    node = port_node(2)
    async with running(node) as port:
        obs = TestClient("obs")          # first connect -> loop 0
        await obs.connect(port=port)
        await obs.subscribe("wills/#", qos=1)
        doomed = TestClient("doomed", will_flag=True, will_qos=1,
                            will_topic="wills/loop",
                            will_payload=b"loop died")
        await doomed.connect(port=port)  # second connect -> loop 1
        lg = node.loop_group
        assert node.listeners[0].loop_connections()[1] == 1
        lg.crash(1)
        deadline = time.time() + 5
        while lg.dead_peer_indices() == [] and time.time() < deadline:
            await asyncio.sleep(0.02)
        # the monitor's heal sweep routes around the dead loop and
        # closes its connections so the will fires
        node.overload.tick(0.0)
        msg = await obs.recv()
        assert msg.topic == "wills/loop" and msg.payload == b"loop died"
        assert node.metrics.val("overload.heal.loop") == 1
        assert 1 in lg._dead
        assert any(a.name == "frontdoor_loop_1_dead"
                   for a in node.alarms.get_alarms("activated"))
        # the node still serves through loop 0
        pub = TestClient("after")
        await pub.connect(port=port)
        await pub.publish("wills/after", payload=b"alive", qos=1)
        msg = await obs.recv()
        assert msg.payload == b"alive"
        await pub.close()
        await obs.close()
        await doomed.close()


@within
async def test_xloop_handoff_drop_is_bounded_and_counted():
    node = port_node(2)
    node.broker.XLOOP_JOIN_TIMEOUT = 0.5
    async with running(node) as port:
        filler = TestClient("filler")    # -> loop 0
        await filler.connect(port=port)
        sub = TestClient("xsub")         # -> loop 1 (cross-loop)
        await sub.connect(port=port)
        await sub.subscribe("xh/t", qos=1)
        pub = TestClient("xpub")         # -> loop 0
        await pub.connect(port=port)
        try:
            with pfaults.injected("xloop.handoff", times=1):
                t0 = time.perf_counter()
                # the PUBACK waits on the bounded join, then arrives
                await pub.publish("xh/t", payload=b"lost", qos=1,
                                  timeout=5.0)
                assert time.perf_counter() - t0 < 4.0
        finally:
            pfaults.clear()
        assert node.metrics.val("delivery.xloop.orphaned") >= 1
        await pub.publish("xh/t", payload=b"found", qos=1)
        msg = await sub.recv()
        assert msg.payload == b"found"
        for cli in (filler, sub, pub):
            await cli.close()


@within
async def test_takeover_timeout_on_stalled_owner_loop():
    node = port_node(2)
    node.cm.XLOOP_CALL_TIMEOUT = 0.4
    async with running(node) as port:
        filler = TestClient("filler2")   # -> loop 0
        await filler.connect(port=port)
        victim = TestClient("dup", clean_start=False)  # -> loop 1
        ack = await victim.connect(port=port)
        assert ack.reason_code == 0
        node.loop_group.stall(1, 1.5)
        await asyncio.sleep(0.05)  # let the stall land on the loop
        again = TestClient("dup", clean_start=False)   # -> loop 0
        t0 = time.perf_counter()
        ack = await again.connect(port=port, timeout=5.0)
        assert time.perf_counter() - t0 < 1.2
        assert ack.reason_code == 0 and not ack.session_present
        assert node.metrics.val("overload.takeover.timeout") == 1
        await again.subscribe("tk/t", qos=1)
        pub = TestClient("tkpub")
        await pub.connect(port=port)
        await pub.publish("tk/t", payload=b"fresh", qos=1)
        msg = await again.recv()
        assert msg.payload == b"fresh"
        await asyncio.sleep(1.3)  # let the stall drain before the stop
        for cli in (filler, victim, again, pub):
            await cli.close()


def test_orphaned_counter_on_home_loop_gone_publish():
    node = port_node(1)

    class DeadLG:
        def on_home_thread(self):
            return False

        def post(self, idx, cb, *args):
            raise RuntimeError("loop closed")

    node.broker.loop_group = DeadLG()
    node.broker.ingress = None
    assert node.broker.publish(PMessage(topic="gone/t", payload=b"x")) == 0
    assert node.metrics.val("delivery.xloop.orphaned") == 1


def test_counters_exact_under_thread_contention():
    """The counters peer loops share stay exact under contention: the
    launch counts (B3 launches from peer-loop threads) and a multi-loop
    node's metrics, 16 threads on a shortened switch interval."""
    import sys

    from emqx_tpu_torch.metrics import Metrics
    from emqx_tpu_torch.ops import _build

    m = Metrics()
    m.enable_threadsafe()
    saved = dict(_build.LAUNCHES)
    _build.reset_launches()
    n_threads, n = 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                _build.count_launch("retained_match")
                m.inc("delivery.xloop.deliveries")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert _build.LAUNCHES["retained_match"] == n_threads * n
        assert m.val("delivery.xloop.deliveries") == n_threads * n
    finally:
        sys.setswitchinterval(interval)
        _build.LAUNCHES.update(saved)
