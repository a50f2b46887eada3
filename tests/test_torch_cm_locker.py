"""The port's distributed per-clientid lock (``emqx_tpu_torch.cm_locker``,
emqx_cm_locker / ekka_locker quorum) against the JAX package's: the
cases of ``tests/test_cm_locker.py`` — the grant table's answers step
by step in both packages, the quorum acquire/release, racing session
opens in one process, and two OS processes (port nodes on the CPU)
racing one clientid over the socket transport, then the peer killed.
"""

import asyncio
import os
import subprocess
import sys
import threading
import time

import emqx_tpu.cm_locker as JM
import emqx_tpu_torch.cm_locker as PM
from emqx_tpu.cluster import Cluster as JCluster
from emqx_tpu.cluster import LocalTransport as JLocal
from emqx_tpu.node import Node as JNode
from emqx_tpu_torch.cluster import Cluster as PCluster
from emqx_tpu_torch.cluster import LocalTransport as PLocal
from emqx_tpu_torch.node import Node as PNode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = (lambda name: JNode(name=name, boot_listeners=False), JCluster,
       JLocal, JM)
PORT = (lambda name: PNode(name=name, device="cpu"), PCluster, PLocal, PM)


class FakeChan:
    def __init__(self, cid):
        self.client_id = cid
        self.killed = False

    def kick(self, discard=False):
        self.killed = True

    def takeover_begin(self):
        return None

    def takeover_end(self, rc):
        self.killed = True


def _mk_cluster(pkg, n=2):
    mk_node, cluster, local, _ = pkg
    transport = local()
    nodes = [mk_node(f"n{i}") for i in range(n)]
    clusters = [cluster(node, transport) for node in nodes]
    for c in clusters[1:]:
        clusters[0].join(c)
    return nodes, clusters


def _grant_steps(pkg):
    _, (ca, cb) = _mk_cluster(pkg, 2)
    lk = ca.locker
    out = [lk.grant("c1", "n0"), lk.grant("c1", "n0"),
           lk.grant("c1", "n1")]
    lk.release_local("c1", "n1")         # wrong owner: no-op
    out.append(lk.grant("c1", "n1"))
    lk.release_local("c1", "n0")
    out.append(lk.grant("c1", "n1"))     # free now
    # lease expiry frees an abandoned grant
    with lk._lock:
        owner, _ = lk._table["c1"]
        lk._table["c1"] = (owner, time.time() - 1)
    out += [lk.grant("c1", "n0"), lk.sweep()]
    # a dead node's grants drop on nodedown (monitored-lock cleanup)
    out += [lk.grant("c2", "n1"), lk.drop_owner("n1"),
            lk.grant("c2", "n0")]
    out.append(sorted((c, o) for c, (o, _e) in lk.info().items()))
    return out


def test_locker_grant_reentrant_and_lease():
    got = _grant_steps(PORT)
    assert got == _grant_steps(JAX)
    assert got == [True, True, False, False, True, True, 0, True, 1, True,
                   [("c1", "n0"), ("c2", "n0")]]


def _quorum_steps(pkg):
    mod = pkg[3]
    _, (ca, cb) = _mk_cluster(pkg, 2)
    out = [ca.locker.acquire("q1")]
    old = mod.ACQUIRE_TIMEOUT
    mod.ACQUIRE_TIMEOUT = 0.3
    try:
        out.append(cb.locker.acquire("q1"))  # held by n0: bounded, False
    finally:
        mod.ACQUIRE_TIMEOUT = old
    ca.locker.release("q1")
    out.append(cb.locker.acquire("q1"))
    cb.locker.release("q1")
    out.append(sorted(ca.locker.info()) + sorted(cb.locker.info()))
    return out


def test_locker_quorum_acquire_release():
    got = _quorum_steps(PORT)
    assert got == _quorum_steps(JAX)
    assert got == [True, False, True, []]


def _race(pkg):
    """Two nodes race clean-start opens for one clientid from
    concurrent threads; after both complete exactly ONE live channel
    exists cluster-wide, and it was never killed."""
    (n0, n1), _ = _mk_cluster(pkg, 2)
    for round_ in range(5):
        ts = [threading.Thread(
            target=lambda n=n: n.cm.open_session("dup", True,
                                                 FakeChan("dup")))
            for n in (n0, n1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        live = [n for n in (n0, n1)
                if n.cm.lookup_channel("dup") is not None]
        assert len(live) == 1, (round_, [n.name for n in live])
        assert not live[0].cm.lookup_channel("dup").killed
        live[0].cm.discard_session("dup")
    return [n.cm.lookup_channel("dup") for n in (n0, n1)]


def test_inprocess_race_exactly_one_session_survives():
    assert _race(PORT) == _race(JAX) == [None, None]


CHILD = r"""
import asyncio, sys
from emqx_tpu_torch.node import Node
from emqx_tpu_torch.cluster import Cluster
from emqx_tpu_torch.cluster_net import SocketTransport


class FakeChan:
    def __init__(self, cid):
        self.client_id = cid
        self.killed = False

    def kick(self, discard=False):
        self.killed = True

    def takeover_begin(self):
        return None

    def takeover_end(self, rc):
        self.killed = True


async def main():
    cookie = sys.argv[1]
    n = Node(name="nodeB", device="cpu")
    await n.start()
    tr = SocketTransport("nodeB", cookie=cookie)
    tr.serve()
    cl = Cluster(n, transport=tr)
    print(f"READY {tr.port}", flush=True)
    loop = asyncio.get_running_loop()
    reader = asyncio.StreamReader()
    await loop.connect_read_pipe(
        lambda: asyncio.StreamReaderProtocol(reader), sys.stdin)
    while True:
        line = await reader.readline()
        if not line:
            break
        parts = line.decode().split()
        if parts[0] == "OPEN":
            cid = parts[1]
            def _open():
                n.cm.open_session(cid, True, FakeChan(cid))
                print(f"OPENED {cid}", flush=True)
            # open on a worker thread: the RPCs inside must not
            # deadlock against this loop serving inbound RPCs
            await loop.run_in_executor(None, _open)
        elif parts[0] == "HAVE?":
            chan = n.cm.lookup_channel(parts[1])
            print(f"HAVE {'yes' if chan is not None else 'no'}",
                  flush=True)
        elif parts[0] == "QUIT":
            break
    await n.stop()
    tr.close()


asyncio.run(main())
"""


def _spawn_child(cookie):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-c", CHILD, cookie],
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


def test_two_process_race_and_link_loss():
    """Two OS processes, each a port node on the CPU, race one
    clientid: exactly one session survives; then the peer dies (link
    loss) and the survivor can still open the clientid in bounded time
    (quorum over the shrunk LIVE membership)."""
    from emqx_tpu_torch.cluster_net import SocketTransport

    async def main():
        proc = _spawn_child("lock-cookie")
        try:
            ready = await _read_line(proc, "READY")
            peer_port = int(ready.split()[1])

            a = PNode(name="nodeA", device="cpu")
            await a.start()
            tr = SocketTransport("nodeA", cookie="lock-cookie")
            tr.serve()
            cl = PCluster(a, transport=tr)
            cl.join_remote("127.0.0.1", peer_port)
            assert sorted(cl.members) == ["nodeA", "nodeB"]

            loop = asyncio.get_running_loop()
            proc.stdin.write(b"OPEN dup\n")
            proc.stdin.flush()
            chan = FakeChan("dup")
            await loop.run_in_executor(
                None, lambda: a.cm.open_session("dup", True, chan))
            await _read_line(proc, "OPENED")
            await asyncio.sleep(0.5)  # registry casts settle

            proc.stdin.write(b"HAVE? dup\n")
            proc.stdin.flush()
            child_has = (await _read_line(proc, "HAVE")) == "HAVE yes"
            parent_has = a.cm.lookup_channel("dup") is not None
            assert child_has != parent_has, (
                "exactly one session must survive",
                child_has, parent_has)

            # link loss: kill the peer outright; the survivor must
            # still open the clientid in bounded time (unreachable
            # peer -> nodedown -> quorum over the live membership)
            proc.kill()
            proc.wait(timeout=15)
            t0 = time.monotonic()
            chan2 = FakeChan("dup")
            await loop.run_in_executor(
                None, lambda: a.cm.open_session("dup", True, chan2))
            assert time.monotonic() - t0 < 10.0
            assert a.cm.lookup_channel("dup") is chan2
            assert cl.members == ["nodeA"]

            await a.stop()
            tr.close()
        finally:
            if proc.poll() is None:
                proc.kill()

    asyncio.run(main())
