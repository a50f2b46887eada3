"""The port's socket transport (``emqx_tpu_torch.cluster_net``) between
OS processes, and its frames against the JAX package's.

The cases of ``tests/test_cluster_net.py`` on port nodes: a child
process (a port node on the CPU, ``device="cpu"``) joins over TCP,
routes replicate both ways, publishes forward across the wire, and the
child's exit purges its routes; a wrong cookie is refused; a
persistent session (with a queued message) moves to this process by a
cross-node takeover, MQTT clients on both sides; retained stores and
deletes cross the wire; a cast buffered just before ``close()`` still
lands. The same ``(op, args)`` frames to the same bytes through both
packages' ``_send_frame``, the replication operations' (a resync
snapshot, a shipped journal range, a failback chunk) among them.
"""

import asyncio
import os
import subprocess
import sys
import time

import pytest

import indie_mqtt as im
from emqx_tpu import cluster_net as jnet
from emqx_tpu.types import Message as JMessage
from emqx_tpu.types import SubOpts as JSubOpts
from emqx_tpu_torch import cluster_net as pnet
from emqx_tpu_torch.cluster import Cluster
from emqx_tpu_torch.cluster_net import SocketTransport
from emqx_tpu_torch.node import Node
from emqx_tpu_torch.types import Message
from emqx_tpu_torch.types import SubOpts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import asyncio, sys
from emqx_tpu_torch.node import Node
from emqx_tpu_torch.cluster import Cluster
from emqx_tpu_torch.cluster_net import SocketTransport
from emqx_tpu_torch.modules.retainer import RetainerModule
from emqx_tpu_torch.types import Message


class Sub:
    def deliver(self, topic, msg):
        print(f"GOT {topic} {msg.payload.decode()}", flush=True)


async def main():
    cookie, name, listen = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
    n = Node(name=name, device="cpu", boot_listeners=False)
    if listen:
        n.add_listener(port=0)
    await n.start()
    ret = n.modules.load(RetainerModule)
    tr = SocketTransport(name, cookie=cookie)
    tr.serve()
    cl = Cluster(n, transport=tr)
    n.broker.subscribe(Sub(), "x/+")
    mqtt = n.listeners[0].port if listen else 0
    print(f"READY {tr.port} {mqtt}", flush=True)
    loop = asyncio.get_running_loop()
    reader = asyncio.StreamReader()
    await loop.connect_read_pipe(
        lambda: asyncio.StreamReaderProtocol(reader), sys.stdin)
    while True:
        line = await reader.readline()
        if not line:
            break
        parts = line.decode().split()
        if parts[0] == "PUB":
            n.broker.publish(
                Message(topic=parts[1], payload=parts[2].encode()))
        elif parts[0] == "RETAINED?":
            keys = ",".join(sorted(t for t, _ in ret.entries()))
            print(f"RETAINED {keys or '-'}", flush=True)
        elif parts[0] == "QUIT":
            break
    await n.stop()
    tr.close()


asyncio.run(main())
"""


class Recorder:
    def __init__(self):
        self.got = asyncio.Queue()

    def deliver(self, topic, msg):
        self.got.put_nowait((topic, msg.payload))


def _spawn_child(cookie, name="nodeB", listen=False):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-c", CHILD, cookie, name, "1" if listen else "0"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, env=env, cwd=REPO)


async def _read_line(proc, prefix, timeout=90.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while True:
        line = await asyncio.wait_for(
            loop.run_in_executor(None, proc.stdout.readline),
            max(0.1, deadline - loop.time()))
        if not line:
            raise AssertionError(f"child closed stdout awaiting {prefix}")
        text = line.decode().strip()
        if text.startswith(prefix):
            return text


def _send(proc, line: bytes) -> None:
    proc.stdin.write(line)
    proc.stdin.flush()


async def _node_with_cluster(name, cookie, listen=False, retainer=False):
    n = Node(name=name, device="cpu", boot_listeners=False)
    if listen:
        n.add_listener(port=0)
    await n.start()
    if retainer:
        from emqx_tpu_torch.modules.retainer import RetainerModule

        n.modules.load(RetainerModule)
    tr = SocketTransport(name, cookie=cookie)
    tr.serve()
    return n, tr, Cluster(n, transport=tr)


def test_two_process_cluster_replicate_forward_nodedown():
    async def main():
        proc = _spawn_child("secret-1")
        try:
            ready = await _read_line(proc, "READY")
            peer_port = int(ready.split()[1])
            a, tr, cl = await _node_with_cluster("nodeA", "secret-1")
            cl.join_remote("127.0.0.1", peer_port)
            assert sorted(cl.members) == ["nodeA", "nodeB"]
            await asyncio.sleep(0.5)
            assert a.router.has_dest("x/+", "nodeB"), a.router.topics()

            # A -> B forward: publish here, B's subscriber prints
            a.broker.publish(Message(topic="x/9", payload=b"ping"))
            assert await _read_line(proc, "GOT") == "GOT x/+ ping"
            assert a.metrics.val("messages.forward") == 1

            # B -> A forward: subscribe here AFTER the join (live
            # replication, not just the join sync)
            rec = Recorder()
            a.broker.subscribe(rec, "y/#")
            await asyncio.sleep(0.5)  # route_add cast propagation
            _send(proc, b"PUB y/2 pong\n")
            topic, payload = await asyncio.wait_for(rec.got.get(), 30)
            assert (topic, payload) == ("y/#", b"pong")

            # nodedown: child exits -> link EOF -> probe -> purge
            _send(proc, b"QUIT\n")
            proc.wait(timeout=30)
            deadline = asyncio.get_running_loop().time() + 15
            while a.router.has_dest("x/+", "nodeB"):
                assert asyncio.get_running_loop().time() < deadline, \
                    "nodedown purge never happened"
                await asyncio.sleep(0.25)
            assert cl.members == ["nodeA"]
            assert not a.router.has_route("x/+")
            await a.stop()
        finally:
            if proc.poll() is None:
                proc.kill()
    asyncio.run(main())


def test_cookie_mismatch_rejected():
    async def main():
        proc = _spawn_child("right-cookie")
        try:
            ready = await _read_line(proc, "READY")
            peer_port = int(ready.split()[1])
            tr = SocketTransport("nodeX", cookie="wrong-cookie")
            tr.serve()
            with pytest.raises(ConnectionError):
                tr.call_addr(("127.0.0.1", peer_port), "cluster_info")
            tr.close()
        finally:
            if proc.poll() is None:
                proc.kill()
    asyncio.run(main())


def test_cross_process_session_takeover():
    """A persistent session made on the child node (with a queued
    message) moves to this process: the takeover call carries it over
    the socket as data (``Session.to_wire``), the client reconnecting
    here gets session-present and the queued message, and the route
    of its subscription points at this node on both."""
    async def main():
        proc = _spawn_child("secret-2", name="nodeB2", listen=True)
        try:
            ready = await _read_line(proc, "READY")
            peer_cl, peer_mqtt = (int(x) for x in ready.split()[1:3])
            a, tr, cl = await _node_with_cluster("nodeA2", "secret-2",
                                                 listen=True)
            cl.join_remote("127.0.0.1", peer_cl)

            c1 = im.IndieClient("mover", version=5, clean=True,
                                props={"Session-Expiry-Interval": 7200})
            await c1.connect(port=peer_mqtt)
            await c1.subscribe(("tk/t", 1))
            await c1.disconnect()
            deadline = asyncio.get_running_loop().time() + 30
            while not a.router.has_dest("tk/t", "nodeB2"):
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.1)
            _send(proc, b"PUB tk/t queued-on-b\n")
            while cl.locate_client("mover") != "nodeB2":
                assert asyncio.get_running_loop().time() < deadline, \
                    "registry entry never replicated"
                await asyncio.sleep(0.2)
            await asyncio.sleep(0.5)  # let the queued PUB land too

            c2 = im.IndieClient("mover", version=5, clean=False,
                                props={"Session-Expiry-Interval": 7200})
            ack = await c2.connect(port=a.listeners[0].port, timeout=30)
            assert ack.session_present, "session not found via registry"
            m = await c2.recv(30)
            assert m.payload == b"queued-on-b"
            assert [r.dest for r in a.router.lookup_routes("tk/t")] \
                == ["nodeA2"]
            assert cl.locate_client("mover") == "nodeA2"
            await c2.disconnect()
            _send(proc, b"QUIT\n")
            proc.wait(timeout=30)
            await a.stop()
        finally:
            if proc.poll() is None:
                proc.kill()
    asyncio.run(main())


async def test_retained_replicates_over_socket_transport():
    """A retain on this node lands in the child's store over the wire,
    and a delete clears it."""
    proc = _spawn_child("retain-net")
    try:
        ready = await _read_line(proc, "READY")
        child_port = int(ready.split()[1])
        n, tr, cl = await _node_with_cluster("nodeA", "retain-net",
                                             retainer=True)
        cl.join_remote("127.0.0.1", child_port)
        n.broker.publish(Message(topic="keep/me", payload=b"v",
                                 flags={"retain": True}))
        await asyncio.sleep(0.5)
        _send(proc, b"RETAINED?\n")
        assert await _read_line(proc, "RETAINED") == "RETAINED keep/me"
        n.broker.publish(Message(topic="keep/me", payload=b"",
                                 flags={"retain": True}))
        await asyncio.sleep(0.5)
        _send(proc, b"RETAINED?\n")
        assert await _read_line(proc, "RETAINED") == "RETAINED -"
        _send(proc, b"QUIT\n")
        await n.stop()
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def test_buffered_cast_survives_immediate_close():
    """A cast buffered just before ``close()`` (leave()'s nodedown
    announcement rides the cast buffer) still lands: the shutdown runs
    one bounded best-effort flush before its task sweep."""
    got = []

    class FakeCluster:
        def handle_rpc(self, op, *args):
            got.append((op, args))
            return True

    a = SocketTransport("a", cookie="k")
    b = SocketTransport("b", cookie="k")
    try:
        a.serve()
        hb, pb = b.serve()
        b.cluster = FakeCluster()
        a.register_peer("b", hb, pb)
        a.cast("b", "nodedown", "a")
        a.close()  # immediately: the buffered cast must still land
        deadline = time.time() + 3
        while not got and time.time() < deadline:
            time.sleep(0.05)
        assert got and got[0][0] == "nodedown", got
    finally:
        a.close()
        b.close()


class _Capture:
    """An asyncio StreamWriter's write/drain, recording the bytes."""

    def __init__(self):
        self.data = bytearray()

    def write(self, b):
        self.data += b

    async def drain(self):
        return None


def _frames(Msg, Opts):
    msg = Msg(topic="a/b", payload=b"\x00\xffp", qos=1, from_="c1",
              flags={"retain": True}, headers={"k": [1, 2.5, None]},
              id=b"0123456789abcdef", timestamp=1700000000.25)
    # a session's wire state, as Session.to_wire gives it
    sd = {"client_id": "c1", "clean_start": False,
          "expiry_interval": 300.0, "next_pkt_id": 4,
          "subscriptions": {"a/+": Opts(qos=1),
                            "$share/g/s/#": Opts(qos=2, share="g")},
          "inflight": [(2, msg, 1700000003.0)], "awaiting_rel": {3: 1.5},
          "mqueue": [(0.0, [msg])]}
    return [
        ("cast", 0, ("forward", ("a/+", msg))),
        ("cast", 0, ("route_add", ("a/#", ("g", "n1")))),
        ("call", 1, ("set_members_net", (["n0", "n1"],
                                         {"n1": ("127.0.0.1", 4370)}))),
        ("call", 1, ("shared_weight", ("g", "w/+", "n0", 3))),
        ("reply", 1, {"want": ["routes"], "merged": {"bans": "x"}}),
        ("cast", 0, ("retain_sync", ([("r/1", msg)], [("r/2", 17.5)]))),
        ("hello", 0, ("n0", "cookie", True)),
        ("call", 1, ("opts", (Opts(qos=2, nl=1, share="g"),
                              frozenset({1}), {3}))),
        # replicated durability: a resync snapshot, a shipped journal
        # range and a failback chunk
        ("call", 2, ("repl_hello", ("n0", {
            "sessions": [("c1", None, sd), ("c2", 1700000001.5, sd)],
            "retained": [("r/1", msg)], "tombstones": [("r/2", 17.5)],
            "routes": [("a/+", "n0", 2), ("a/#", ("g", "n0"), 1)],
            "standbys": ["n1", "n2"]}, 7))),
        ("call", 3, ("repl_ship", ("n0", 7, [
            ("route", "a/+", "n0", 3), ("route", "s/#", ("g", "n0"), 0),
            ("retain", "r/1", msg, 1700000000.25),
            ("retain", "r/2", None, 1700000002.0),
            ("sess.state", "c1", 1700000001.5, sd),
            ("sess.sub", "c1", "b/#", Opts(qos=1)),
            ("sess.unsub", "c1", "a/+"), ("sess.close", "c2")]))),
        ("call", 4, ("repl_failback", ("n1", {
            "sessions": [("c1", 1700000001.5, sd)], "final": True,
            "keep": ["c3"], "closed": []}))),
    ]


@pytest.mark.parametrize("i", range(11))
def test_frames_are_byte_equal_across_packages(i):
    """The same ``(kind, req, (op, args))`` through both packages'
    ``_send_frame``: the same length prefix and payload bytes, and the
    port decodes the JAX frame back to the value it sent."""
    async def one(mod, frame):
        w = _Capture()
        await mod._send_frame(w, frame)
        return bytes(w.data)

    want = asyncio.run(one(jnet, _frames(JMessage, JSubOpts)[i]))
    frame = _frames(Message, SubOpts)[i]
    got = asyncio.run(one(pnet, frame))
    assert got == want

    async def back():
        r = asyncio.StreamReader()
        r.feed_data(want)
        r.feed_eof()
        return await pnet._recv_frame(r)

    dec = asyncio.run(back())
    if i in (0, 5, 8, 9, 10):  # Message has no __eq__: compare fields
        assert pnet.wire.dumps(dec) == pnet.wire.dumps(frame)
    elif i == 7:
        assert pnet.wire.dumps(dec) == pnet.wire.dumps(frame)
    else:
        assert dec == frame
