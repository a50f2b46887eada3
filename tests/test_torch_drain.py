"""The port's graceful drain (``emqx_tpu_torch.drain``) against the JAX
package's: the CONNECT redirect, paced redirect waves, the custody
hand-off, the redirecting stop, and a rolling restart.

Every case of ``tests/test_drain.py`` but the two flapping ones (the
port has no ``flapping.py`` yet) runs the same operations on JAX nodes
and on port nodes (``device="cpu"``), each with a TCP listener on
loopback and the same MQTT clients (``tests/mqtt_client.py``). The
``ctl drain`` calls become ``node.drain.start(...)`` / ``.stop()``
(the port has no ``ctl`` yet). Each keeps the original test's
assertions, and the two runs must give the same CONNACK and DISCONNECT
reason codes and Server-References, the same counters, the same
custody digests and holders, and the same alarm edges.
"""

import asyncio
import concurrent.futures
import os
import threading
import time

import pytest

from emqx_tpu.mqtt import constants as C
from emqx_tpu.mqtt import reason_codes as RC
from emqx_tpu.mqtt.packet import PubAck
from emqx_tpu.mqtt.packet import Publish as Pub
from test_torch_repl_pkgs import (JAX, PORT, active_alarms, await_, both_async,
                             clear_faults, steady_cfg)

from tests.mqtt_client import TestClient


@pytest.fixture(autouse=True)
def _clean_faults():
    clear_faults()
    yield
    clear_faults()


async def _mk_node(P, name, d, cookie, peers=(), zone=None, drain_kw=None,
                   durable=True, join_port=None, cluster_kw=None, port=0,
                   cluster_port=0):
    """One started node with a TCP listener and a socket cluster
    transport; ``peers`` are the durability standbys by node name.
    Fixed ``port``/``cluster_port`` let a restart rebind the same
    addresses, as a production rolling restart does."""
    dur = None
    if durable:
        dur = P.Dur(enabled=True, dir=str(d / name), fsync=False,
                    standbys=tuple(peers), ack_quorum=1 if peers else 0,
                    quorum_timeout_ms=500.0, repl_ack_timeout_s=2.0)
    node = P.Node(name, durability=dur, drain=P.Drain(**(drain_kw or {})))
    node.add_listener(port=port, zone=zone)
    node.enable_cluster(port=cluster_port, cookie=cookie,
                        config=steady_cfg(P, **{
                            "anti_entropy_interval_s": 1.0,
                            "call_timeout_s": 3.0, **(cluster_kw or {})}))
    await node.start()
    if join_port is not None:
        await asyncio.get_running_loop().run_in_executor(
            None, node.cluster.join_remote, "127.0.0.1", join_port)
    return node


async def _stop_all(*nodes):
    for node in nodes:
        try:
            await node.stop()
        except Exception:
            pass


def _pkt(pkt):
    """A CONNACK's or DISCONNECT's comparable fields."""
    return (getattr(pkt, "type", None), pkt.reason_code,
            (pkt.properties or {}).get("Server-Reference"))


# -- CONNECT gate ---------------------------------------------------------

async def _rejects(P, d):
    node = P.Node("emqx_tpu@127.0.0.1")
    node.add_listener(port=0)
    await node.start()
    try:
        node.drain.start(ref="10.0.0.9:1883")
        assert node.node_state == 1
        edges = [active_alarms(node)]
        assert "node_draining" in edges[0]
        node.stats.tick()
        state = node.stats.getstat("node.state")
        port = node.listeners[0].port
        c5 = TestClient("drv5", version=C.MQTT_V5)
        await c5.connect(port=port)
        assert c5.connack.reason_code == RC.USE_ANOTHER_SERVER
        assert c5.connack.properties.get("Server-Reference") \
            == "10.0.0.9:1883"
        c4 = TestClient("drv4", version=C.MQTT_V4)
        await c4.connect(port=port)
        assert c4.connack.reason_code == 3  # server unavailable
        assert node.metrics.val("drain.rejected.connects") == 2
        node.drain.stop()
        assert node.node_state == 0
        edges.append(active_alarms(node))
        assert "node_draining" not in edges[1]
        ok = TestClient("drv5b", version=C.MQTT_V5)
        await ok.connect(port=port)
        assert ok.connack.reason_code == RC.SUCCESS
        await ok.close()
        return {"v5": _pkt(c5.connack), "v4": _pkt(c4.connack),
                "ok": _pkt(ok.connack), "edges": edges, "state": state,
                "rejected": node.metrics.val("drain.rejected.connects")}
    finally:
        await _stop_all(node)


async def test_drain_rejects_new_connects(tmp_path):
    """DRAINING refuses new CONNECTs: v5 gets 0x9C Use-Another-Server +
    Server-Reference, v3.1.1 the server-unavailable compat code; the
    node.state gauge and the node_draining alarm flip."""
    out = await both_async(_rejects, tmp_path)
    assert out["state"] == 1


# -- redirect waves -------------------------------------------------------

async def _wave(P, d):
    node = P.Node("emqx_tpu@127.0.0.1",
                  drain=P.Drain(wave_interval_s=0.05))
    node.add_listener(port=0)
    await node.start()
    published = []
    node.hooks.add("message.publish",
                   lambda msg: published.append(msg.topic))
    try:
        c = TestClient(
            "will5", version=C.MQTT_V5, clean_start=False,
            properties={"Session-Expiry-Interval": 300},
            will_topic="wills/t", will_payload=b"dead")
        await c.connect(port=node.listeners[0].port)
        await c.subscribe("keep/me", qos=1)
        node.drain.start(ref="peer:1883")
        pkt = await asyncio.wait_for(c.acks.get(), 10)
        assert getattr(pkt, "type", None) == C.DISCONNECT
        assert pkt.reason_code == RC.USE_ANOTHER_SERVER
        assert pkt.properties.get("Server-Reference") == "peer:1883"
        await await_(lambda: "will5" in node.cm._detached, 10,
                     "session did not detach")
        sess = node.cm._detached["will5"][0]
        assert "keep/me" in sess.subscriptions
        assert "wills/t" not in published, "drain redirect fired the will"
        await await_(lambda: node.metrics.val("drain.redirects") == 1,
                     10, "redirect not counted")
        await await_(lambda: node.drain.time_to_empty_s is not None,
                     10, "drain never emptied")
        info = node.drain.info()
        return {"disconnect": _pkt(pkt), "subs": sorted(sess.subscriptions),
                "will_fired": "wills/t" in published,
                "redirected": info["redirected"], "state": info["state"],
                "handed_off": info["handed_off"]}
    finally:
        node.drain.stop()
        await _stop_all(node)


async def test_drain_redirect_wave_v5_and_will_suppressed(tmp_path):
    """A live v5 client is redirected with DISCONNECT 0x9C +
    Server-Reference; its will does NOT fire (custody hand-off, the cm
    takeover contract) and its persistent session detaches intact."""
    await both_async(_wave, tmp_path)


async def _budget(P, d):
    n0 = await _mk_node(P, "bw0", d, f"ck-bw-{P.name}", durable=False)
    n1 = await _mk_node(P, "bw1", d, f"ck-bw-{P.name}", durable=False,
                        join_port=n0.cluster.transport.port)
    try:
        await await_(lambda: len(n0.cluster.members) == 2, 10,
                     "join did not converge")
        c = TestClient("bwc", version=C.MQTT_V5)
        await c.connect(port=n0.listeners[0].port)
        # the target reports CRITICAL: waves must defer
        n1.overload.cfg.clear_ticks = 10 ** 6  # hold the level
        n1.overload.level = 2
        n0.drain.cfg.wave_interval_s = 0.05
        n0.drain.start(target="bw1")
        await await_(
            lambda: n0.metrics.val("drain.waves.deferred") >= 2, 10,
            "waves did not defer against a critical target")
        redirected_while_critical = n0.metrics.val("drain.redirects")
        assert redirected_while_critical == 0
        assert not c.reader.at_eof()
        # the target recovers: the held wave proceeds
        n1.overload.level = 0
        await await_(lambda: n0.metrics.val("drain.redirects") == 1,
                     10, "wave did not resume after recovery")
        pkt = await asyncio.wait_for(c.acks.get(), 10)
        return {"while_critical": redirected_while_critical,
                "after": n0.metrics.val("drain.redirects"),
                "disconnect": _pkt(pkt)}
    finally:
        n0.drain.stop()
        await _stop_all(n0, n1)


async def test_drain_wave_budget_adapts_to_target_overload(tmp_path):
    """Wave pacing: the disconnect budget probes the receiving peer's
    overload level — CRITICAL defers the whole wave, recovery lets it
    proceed."""
    out = await both_async(_budget, tmp_path)
    assert out["disconnect"] == (C.DISCONNECT, RC.USE_ANOTHER_SERVER,
                                 "bw1")


# -- v3.1.1 clients -------------------------------------------------------

async def _v311(P, d):
    ck = f"ck-v3-{P.name}"
    n0 = await _mk_node(P, "v30", d, ck, peers=("v31",),
                        drain_kw={"wave_interval_s": 0.05})
    n1 = await _mk_node(P, "v31", d, ck,
                        join_port=n0.cluster.transport.port)
    try:
        await await_(lambda: len(n0.cluster.members) == 2, 10,
                     "join did not converge")
        c = TestClient("v3c", version=C.MQTT_V4, clean_start=False)
        await c.connect(port=n0.listeners[0].port)
        await c.subscribe("v3/t", qos=1)
        n0.drain.start(target="v31")
        # plain close: EOF, no DISCONNECT packet on the wire
        await await_(lambda: c.reader.at_eof(), 10,
                     "v3 client was not closed")
        assert c.acks.empty()
        # custody hand-off completes before the reconnect
        await await_(lambda: n0.drain.time_to_empty_s is not None,
                     15, "drain did not finish")
        assert n0.drain.handoff_ok is True
        # a QoS1 publish while the client is away queues in the handed
        # session on the PEER
        n1.broker.publish(P.Message(topic="v3/t", payload=b"queued",
                                    qos=1))
        c2 = TestClient("v3c", version=C.MQTT_V4, clean_start=False)
        await c2.connect(port=n1.listeners[0].port)
        assert c2.connack.session_present is True
        m = await c2.recv(10)
        assert m.topic == "v3/t" and m.payload == b"queued"
        await c2.close()
        return {"present": c2.connack.session_present,
                "got": (m.topic, bytes(m.payload)),
                "handed_off": n0.drain.handed_off,
                "handoff_ok": n0.drain.handoff_ok}
    finally:
        n0.drain.stop()
        await _stop_all(n0, n1)


async def test_drain_v311_reconnects_on_peer_session_intact(tmp_path):
    """v3.1.1 has no server DISCONNECT / Server-Reference: a drained v4
    client sees a plain close, reconnects to the peer, and finds its
    session through the cluster registry — subscription state and
    queued QoS1 messages intact."""
    await both_async(_v311, tmp_path)


# -- custody hand-off -----------------------------------------------------

async def _handoff(P, d):
    ck = f"ck-hc-{P.name}"
    n0 = await _mk_node(P, "hc0", d, ck, peers=("hc1",))
    n1 = await _mk_node(P, "hc1", d, ck,
                        join_port=n0.cluster.transport.port)
    try:
        await await_(lambda: len(n0.cluster.members) == 2, 10,
                     "join did not converge")
        cids = [f"dev{i}" for i in range(5)]
        for i, cid in enumerate(cids):
            s = P.Session(cid, broker=n0.broker, clean_start=False)
            n0.durability.session_opened(s, 300.0)
            s.subscribe(f"fleet/{i}/+", P.SubOpts(qos=1))
            n0.cm._detached[cid] = (s, time.time(), 300.0)
            n0.cluster.client_up(cid)
        n0.broker.publish(P.Message(topic="fleet/1/x", payload=b"m1",
                                    qos=1))
        n0.durability.on_batch()
        pre = P.sessions_digest(n0, cids)
        n0.drain.start(target="hc1")
        await await_(lambda: n0.drain.time_to_empty_s is not None,
                     20, "drain did not finish")
        assert n0.drain.handoff_ok is True
        assert n0.drain.handed_off == 5
        assert n0.metrics.val("drain.handoff.sessions") == 5
        # digest-exact on the target, byte-for-byte
        got = P.sessions_digest(n1, cids)
        assert got == pre
        # exactly one holder + registry custody on both members
        assert not any(c in n0.cm._detached for c in cids)
        assert all(c in n1.cm._detached for c in cids)
        for cl in (n0.cluster, n1.cluster):
            assert all(cl._registry.get(c) == "hc1" for c in cids)
        # routes moved: target owns them, the drained node does not
        assert n1.router.route_refs("fleet/1/+", "hc1") == 1
        assert n0.router.route_refs("fleet/1/+", "hc0") == 0
        # the journal agrees: a recovery of the drained node's dir
        # resurrects NO handed session
        await n0.stop()
        n0b = P.Node("hc0", durability=P.Dur(
            enabled=True, dir=str(d / "hc0"), fsync=False))
        n0b.durability.recover()
        assert not n0b.cm._detached
        n0b.durability.wal.close()
        return {"digest": got, "handed_off": n0.drain.handed_off,
                "holders": sorted(c for c in cids
                                  if c in n1.cm._detached)}
    finally:
        await _stop_all(n0, n1)


async def test_drain_handoff_custody_digest_exact(tmp_path):
    """The voluntary zero-RPO failover: detached persistent sessions
    (subscriptions + queued QoS1 state) hand to the target through the
    replication machinery — digest-verified, registry repointed, exactly
    one holder left, routes remapped, and the local journal records the
    closes so a restart resurrects nothing stale."""
    await both_async(_handoff, tmp_path)


# -- graceful stop with a drain target ------------------------------------

async def _stop_target(P, d):
    node = P.Node("emqx_tpu@127.0.0.1",
                  drain=P.Drain(target="peer-b",
                                server_ref="10.1.1.2:1883"))
    node.add_listener(port=0)
    await node.start()
    published = []
    node.hooks.add("message.publish",
                   lambda msg: published.append(msg.topic))
    c = TestClient(
        "stopc", version=C.MQTT_V5, clean_start=False,
        properties={"Session-Expiry-Interval": 300},
        will_topic="wills/stop", will_payload=b"dead")
    await c.connect(port=node.listeners[0].port)
    await node.stop()
    pkt = await asyncio.wait_for(c.acks.get(), 10)
    assert getattr(pkt, "type", None) == C.DISCONNECT
    assert pkt.reason_code == RC.USE_ANOTHER_SERVER
    assert pkt.properties.get("Server-Reference") == "10.1.1.2:1883"
    assert "wills/stop" not in published, \
        "drain-target stop fired the will"
    return {"disconnect": _pkt(pkt),
            "will_fired": "wills/stop" in published}


async def test_node_stop_with_drain_target_redirects(tmp_path):
    """Node.stop with a configured drain target sends v5 clients
    DISCONNECT 0x9C + Server-Reference (not 0x8B) and suppresses wills
    — the listener close is itself a redirect."""
    await both_async(_stop_target, tmp_path)


async def _stop_no_target(P, d):
    node = P.Node("emqx_tpu@127.0.0.1", durability=P.Dur(
        enabled=True, dir=str(d / "d8b"), fsync=False))
    node.add_listener(port=0)
    await node.start()
    c = TestClient("c8b", version=C.MQTT_V5)
    await c.connect(port=node.listeners[0].port)
    await node.stop()
    pkt = await asyncio.wait_for(c.acks.get(), 10)
    assert getattr(pkt, "type", None) == C.DISCONNECT
    assert pkt.reason_code == RC.SERVER_SHUTTING_DOWN
    return {"disconnect": _pkt(pkt)}


async def test_node_stop_without_target_keeps_0x8b(tmp_path):
    """The durable graceful stop is unchanged: no drain target -> 0x8B
    Server-Shutting-Down."""
    await both_async(_stop_no_target, tmp_path)


# -- config + validation --------------------------------------------------

@pytest.mark.parametrize("kw", [dict(wave_size=0), dict(wave_interval_s=0),
                                dict(handoff_timeout_s=0),
                                dict(sigterm_grace_s=0)])
def test_drain_config_validation(kw):
    with pytest.raises(ValueError) as je:
        JAX.Drain(**kw)
    with pytest.raises(ValueError) as pe:
        PORT.Drain(**kw)
    assert str(pe.value) == str(je.value)
    assert PORT.Drain.RELOADABLE == JAX.Drain.RELOADABLE
    cfg = PORT.Drain(wave_size=5, on_sigterm=True)
    assert cfg.wave_size == 5 and cfg.on_sigterm


def test_drain_start_needs_valid_target():
    for P in (JAX, PORT):
        node = P.Node("emqx_tpu@127.0.0.1")
        with pytest.raises(ValueError):
            # no running loop
            node.drain.start()


# -- the rolling restart --------------------------------------------------

class _NodeHost:
    """One broker node on its OWN event loop + thread — the shape a
    production deployment has (one loop per broker process). On one
    shared loop, a cross-node session pull from inside a CONNECT
    handler deadlocks against the target's owner-loop dispatch until
    the call timeout."""

    def __init__(self) -> None:
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    async def run(self, coro, timeout=60.0):
        """Await ``coro`` on this host's loop from the test loop."""
        return await asyncio.wait_for(
            asyncio.wrap_future(
                asyncio.run_coroutine_threadsafe(coro, self.loop)),
            timeout)

    def call(self, fn, timeout=30.0):
        """Run sync ``fn()`` on this host's loop; return its result."""
        fut: concurrent.futures.Future = concurrent.futures.Future()

        def _go():
            try:
                fut.set_result(fn())
            except BaseException as e:
                fut.set_exception(e)

        self.loop.call_soon_threadsafe(_go)
        return fut.result(timeout)

    def close(self) -> None:
        try:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(2.0)
        except Exception:
            pass


async def _rolling(P, d):
    """A 3-node quorum-replicated cluster restarted node by node —
    drain to the next peer, stop, boot fresh from disk, rejoin — under
    live durable QoS1 traffic: nothing lost, every repeated delivery
    flagged DUP, one holder of the subscriber's session, the five
    replicated planes byte-equal after the last rejoin."""
    cookie = f"ck-roll-{P.name}"
    names = ["rr0", "rr1", "rr2"]
    peers = {n: tuple(x for x in names if x != n) for n in names}
    drain_kw = {"wave_interval_s": 0.1, "handoff_timeout_s": 20.0}
    # a starvation-tolerant detector: a node restart can stall every
    # thread of this one process for hundreds of ms
    cluster_kw = {"heartbeat_interval_s": 0.2, "heartbeat_timeout_s": 1.0,
                  "suspect_after": 2, "down_after": 25, "ok_after": 1}
    hosts = {n: _NodeHost() for n in names}
    nodes = {}
    nodes["rr0"] = await hosts["rr0"].run(_mk_node(
        P, "rr0", d, cookie, peers=peers["rr0"], drain_kw=drain_kw,
        cluster_kw=cluster_kw))
    for n in names[1:]:
        nodes[n] = await hosts[n].run(_mk_node(
            P, n, d, cookie, peers=peers[n], drain_kw=drain_kw,
            cluster_kw=cluster_kw,
            join_port=nodes["rr0"].cluster.transport.port))
    ports = {n: nodes[n].listeners[0].port for n in names}
    total = int(os.environ.get("ROLLING_MSGS", "60"))
    sent, got, seen = [], [], set()
    dup_violations, session_losses = [], []
    roll_done = asyncio.Event()
    pub_done = asyncio.Event()
    sub_ready = asyncio.Event()

    async def _connect(cid, name):
        c = TestClient(cid, version=C.MQTT_V4, clean_start=False)
        await c.connect(port=ports[name], timeout=10.0)
        return c

    async def _reconnect(cid, avoid):
        for _ in range(150):
            for name in names:
                if name == avoid:
                    continue
                try:
                    c = await _connect(cid, name)
                    if c.connack.reason_code == 0:
                        if not c.connack.session_present:
                            session_losses.append((cid, name))
                        return c, name
                    await c.close()
                except (ConnectionError, OSError, asyncio.TimeoutError,
                        AssertionError):
                    pass
            await asyncio.sleep(0.2)
        raise AssertionError(f"{cid} could not reconnect anywhere")

    async def subscriber():
        home = "rr0"
        c = await _connect("roll-sub", home)
        await c.subscribe("roll/t", qos=1)
        sub_ready.set()
        stall = 0
        while not (pub_done.is_set() and sent and len(seen) >= len(sent)):
            try:
                m = await asyncio.wait_for(c.inbox.get(), 0.3)
                stall = 0
            except asyncio.TimeoutError:
                stall += 1
                if c.reader.at_eof() or (c._task is not None
                                         and c._task.done()):
                    c, home = await _reconnect("roll-sub", home)
                    stall = 0
                elif stall >= 15:
                    # a persistent stall on a seemingly-live link:
                    # reconnect-and-resume, as a real client's
                    # keepalive logic does; a message the broker LOST
                    # cannot come back this way
                    await c.close()
                    c, home = await _reconnect("roll-sub", None)
                    stall = 0
                continue
            seq = int(m.payload)
            if seq in seen:
                if not m.dup:
                    dup_violations.append(seq)
                continue
            seen.add(seq)
            got.append(seq)
        await c.close()

    async def publisher():
        await sub_ready.wait()
        home = "rr2"
        c = await _connect("roll-pub", home)
        seq = 0
        while not (roll_done.is_set() and seq >= total):
            sent.append(seq)
            while True:
                try:
                    pid = c.next_pkt_id()
                    await c.send(Pub(topic="roll/t",
                                     payload=str(seq).encode(), qos=1,
                                     packet_id=pid))
                    acked = False
                    while True:
                        ack = await asyncio.wait_for(c.acks.get(), 5.0)
                        if isinstance(ack, PubAck) \
                                and ack.type == C.PUBACK \
                                and ack.packet_id == pid:
                            acked = True
                            break
                        if getattr(ack, "type", None) == C.DISCONNECT:
                            break  # redirect: republish on the next node
                    if acked:
                        break
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    pass
                c, home = await _reconnect("roll-pub", home)
            seq += 1
            await asyncio.sleep(0.02)
        pub_done.set()
        await c.close()

    sub_task = asyncio.create_task(subscriber())
    pub_task = asyncio.create_task(publisher())
    try:
        await asyncio.wait_for(sub_ready.wait(), 20)
        await await_(lambda: len(seen) >= 5, 20,
                     "no traffic before the roll")
        for i, name in enumerate(names):
            target = names[(i + 1) % 3]
            node = nodes[name]
            hosts[name].call(
                lambda n=node, t=target: n.drain.start(target=t))
            await await_(lambda: node.drain.time_to_empty_s is not None,
                         60, f"drain of {name} did not finish")
            cport = node.cluster.transport.port
            await hosts[name].run(node.stop())
            hosts[name].close()
            # the upgrade restart: same name, same disk, same ports
            hosts[name] = _NodeHost()
            fresh = await hosts[name].run(_mk_node(
                P, name, d, cookie, peers=peers[name],
                drain_kw=drain_kw, cluster_kw=cluster_kw,
                port=ports[name], cluster_port=cport,
                join_port=nodes[target].cluster.transport.port))
            nodes[name] = fresh
            ports[name] = fresh.listeners[0].port
            await await_(lambda: all(len(nodes[x].cluster.members) == 3
                                     for x in names), 30,
                         f"membership did not re-converge after {name}")
            await await_(lambda: any("roll-sub" in nodes[x].cm._channels
                                     for x in names)
                         and any("roll-pub" in nodes[x].cm._channels
                                 for x in names), 30,
                         f"clients did not re-home after {name}")
        roll_done.set()
        await asyncio.wait_for(pub_task, 120)
        try:
            await asyncio.wait_for(sub_task, 60)
        except asyncio.TimeoutError:
            sub_task.cancel()  # messages missing: the asserts name them
        assert not session_losses, session_losses
        lost = sorted(set(sent) - set(got))
        assert not lost, f"lost {lost[:10]}"
        assert not dup_violations, dup_violations[:10]
        holders = [n for n in names
                   if "roll-sub" in nodes[n].cm._detached
                   or "roll-sub" in nodes[n].cm._channels]
        assert len(holders) == 1, holders

        def _converged():
            digs = [nodes[n].cluster.plane_digests() for n in names]
            return all(x == digs[0] for x in digs[1:])

        await await_(_converged, 30,
                     "plane digests did not converge after the roll")
        return {"lost": lost, "dup_violations": dup_violations,
                "session_losses": session_losses, "holders": len(holders),
                "drained": 3}
    finally:
        for t in (sub_task, pub_task):
            t.cancel()
        for name in names:
            try:
                await hosts[name].run(nodes[name].stop(), timeout=20)
            except Exception:
                pass
            hosts[name].close()


async def test_rolling_restart_3node(tmp_path):
    """The rolling-restart proof: drain → stop → restart from disk →
    rejoin, node by node, under live durable QoS1 traffic — zero lost,
    zero non-DUP duplicates, one holder, converged planes, in both
    packages. The JAX package's rolling restart is a known intermittent
    under load (ROADMAP, reference caveats: a reconnect handed a fresh
    session), so its side may run twice; the port's runs once."""
    await both_async(_rolling, tmp_path, reference_tries=2)
