"""Both packages' replicated-durability and drain surfaces, for the
scenarios of ``tests/test_torch_replication.py``,
``tests/test_torch_replication_group.py`` and ``tests/test_torch_drain.py``
(this module holds no test of its own).

A scenario takes a :class:`Pkg` and a directory, runs on that package's
nodes (the port's on ``device="cpu"``) and returns what the two
packages must agree on: digests, counts, reason codes, alarm edges.
:func:`both` runs it on the JAX package, then on the port, and asserts
the two observations equal.

Every cluster here runs :func:`steady_cfg`: heartbeats every 0.1 s
with the drain bench's 2 s ping deadline and suspicion after 4 misses
(``emqx_tpu/bench_live.py:976-979``), so a loaded host does not flap a
live peer, and a peer whose transport closed is declared down after 8
refused pings (under a second).
"""

from __future__ import annotations

import asyncio
import time

from emqx_tpu import checkpoint as jck
from emqx_tpu import faults as jf
from emqx_tpu.cluster import Cluster as JCluster
from emqx_tpu.cluster import ClusterConfig as JClusterConfig
from emqx_tpu.cluster_net import SocketTransport as JTransport
from emqx_tpu.drain import DrainConfig as JDrain
from emqx_tpu.durability import DurabilityConfig as JDur
from emqx_tpu.modules.retainer import RetainerModule as JRetainer
from emqx_tpu.node import Node as JNode
from emqx_tpu.replication import durable_digest as j_durable_digest
from emqx_tpu.replication import sessions_digest as j_sessions_digest
from emqx_tpu.session import Session as JSession
from emqx_tpu.types import Message as JMessage
from emqx_tpu.types import SubOpts as JSubOpts
from emqx_tpu_torch import checkpoint as pck
from emqx_tpu_torch import faults as pf
from emqx_tpu_torch.cluster import Cluster as PCluster
from emqx_tpu_torch.cluster import ClusterConfig as PClusterConfig
from emqx_tpu_torch.cluster_net import SocketTransport as PTransport
from emqx_tpu_torch.drain import DrainConfig as PDrain
from emqx_tpu_torch.durability import DurabilityConfig as PDur
from emqx_tpu_torch.modules.retainer import RetainerModule as PRetainer
from emqx_tpu_torch.node import Node as PNode
from emqx_tpu_torch.replication import durable_digest as p_durable_digest
from emqx_tpu_torch.replication import sessions_digest as p_sessions_digest
from emqx_tpu_torch.session import Session as PSession
from emqx_tpu_torch.types import Message as PMessage
from emqx_tpu_torch.types import SubOpts as PSubOpts


class Pkg:
    """One package's vocabulary for the scenarios."""

    def __init__(self, name, **kw) -> None:
        self.name = name
        self.__dict__.update(kw)

    def Node(self, name, **kw):
        if self.name == "jax":
            return JNode(name=name, boot_listeners=False, **kw)
        return PNode(name=name, device="cpu", **kw)


JAX = Pkg("jax", Cluster=JCluster, ClusterConfig=JClusterConfig,
          Transport=JTransport, Drain=JDrain, Dur=JDur,
          Retainer=JRetainer, Session=JSession, Message=JMessage,
          SubOpts=JSubOpts, faults=jf, checkpoint=jck,
          durable_digest=j_durable_digest,
          sessions_digest=j_sessions_digest)
PORT = Pkg("port", Cluster=PCluster, ClusterConfig=PClusterConfig,
           Transport=PTransport, Drain=PDrain, Dur=PDur,
           Retainer=PRetainer, Session=PSession, Message=PMessage,
           SubOpts=PSubOpts, faults=pf, checkpoint=pck,
           durable_digest=p_durable_digest,
           sessions_digest=p_sessions_digest)


def clear_faults() -> None:
    for f in (jf, pf):
        f.clear()
        f.set_master(True)
        f.drain_injected()


def both(scenario, tmp_path, *args):
    """Run ``scenario(pkg, dir, *args)`` on the JAX package, then on
    the port (each in a directory of its own, faults cleared around
    each run); the two observations must be equal."""
    out = {}
    for P in (JAX, PORT):
        clear_faults()
        d = tmp_path / P.name
        d.mkdir()
        try:
            out[P.name] = scenario(P, d, *args)
        finally:
            clear_faults()
    assert out["port"] == out["jax"]
    return out["port"]


async def both_async(scenario, tmp_path, *args, reference_tries=1):
    """:func:`both` for an ``async`` scenario. ``reference_tries`` > 1
    runs the JAX package's side again, in a fresh directory, when it
    fails (for a scenario whose JAX test is a known intermittent); the
    port's side runs once."""
    out = {}
    for P in (JAX, PORT):
        tries = reference_tries if P is JAX else 1
        for k in range(tries):
            clear_faults()
            d = tmp_path / f"{P.name}{k or ''}"
            d.mkdir()
            try:
                out[P.name] = await scenario(P, d, *args)
                break
            except AssertionError:
                if k == tries - 1:
                    raise
            finally:
                clear_faults()
    assert out["port"] == out["jax"]
    return out["port"]


def steady_cfg(P, **kw):
    """The clusters' ``ClusterConfig`` (see the module docstring)."""
    base = dict(heartbeat_interval_s=0.1, heartbeat_timeout_s=2.0,
                suspect_after=4, down_after=8, ok_after=1,
                anti_entropy_interval_s=30.0, call_timeout_s=5.0,
                redial_backoff_s=0.1, redial_backoff_max_s=0.5)
    base.update(kw)
    return P.ClusterConfig(**base)


def wait(pred, timeout=30.0, msg="condition not met in time"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    raise AssertionError(msg)


def wait_soft(pred, timeout=10.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


async def await_(pred, timeout=20.0, msg="condition not met in time"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        await asyncio.sleep(0.02)
    raise AssertionError(msg)


class Chan:
    """Minimal channel holder: the cm registry (and so snapshots and
    digests) sees the session as live."""

    def __init__(self, s) -> None:
        self.session = s
        self.client_id = s.client_id


def durable_session(P, node, cid, expiry=300.0):
    s = P.Session(cid, broker=node.broker, clean_start=False)
    node.durability.session_opened(s, expiry)
    node.cm.register_channel(cid, Chan(s))
    return s


def populate(P, n0):
    """The canonical durable workload of the JAX package's tests: a
    durable session with plain + shared subs and unacked QoS1 inflight,
    retained set + clear."""
    M, O = P.Message, P.SubOpts
    s = durable_session(P, n0, "dev1")
    s.subscribe("fleet/+/state", O(qos=1))
    s.subscribe("$share/g/fleet/cmd", O(qos=2))
    n0.broker.publish(M(topic="fleet/1/state", payload=b"up", qos=1,
                        flags={"retain": True}))
    n0.broker.publish(M(topic="fleet/2/state", payload=b"x",
                        flags={"retain": True}))
    n0.broker.publish(M(topic="fleet/2/state", payload=b"",
                        flags={"retain": True}))  # tombstone
    n0.broker.publish(M(topic="fleet/9/state", payload=b"q", qos=1))
    n0.durability.on_batch()
    return s


def synced(node) -> bool:
    r = node.replication
    return r.state == "replicating" and r.acked_seq >= r.offered_seq


def wait_synced(nodes, timeout=40.0, msg="shippers never resynced"):
    """Wait until every node's shipper fully acked, ticking each node's
    journal flush while polling — the stand-in for the flush timer a
    started Node runs."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        for n in nodes:
            d = getattr(n, "durability", None)
            if d is not None and d.wal is not None:
                d.on_batch()
        if all(synced(n) for n in nodes):
            return
        time.sleep(0.1)
    raise AssertionError(msg)


def active_alarms(node) -> list:
    return sorted(a.name for a in node.alarms.get_alarms("activated"))


def counts(node) -> dict:
    """Sessions (live + detached), routes and retained messages a node
    holds."""
    ret = node.modules._loaded.get("retainer")
    return {"sessions": len(node.cm._detached) + len(node.cm._channels),
            "routes": sum(len(d) for d in
                          node.router.route_table().values()),
            "retained": len(ret._store) if ret is not None else 0}


def boot(P, name, dcfg, cookie, ccfg):
    """A node with the retainer, recovered when durable, on a socket
    transport (its chaos faults scoped to the peers a test names) and
    a configured ``Cluster``."""
    node = P.Node(name, durability=dcfg)
    node.modules.load(P.Retainer)
    if node.durability is not None:
        node.durability.recover()
    tr = P.Transport(name, cookie=cookie, config=ccfg)
    tr.fault_peers = set()
    tr.serve()
    cl = P.Cluster(node, transport=tr, config=ccfg)
    return node, tr, cl


def teardown(nodes, trs, cls) -> None:
    for node in nodes:
        d = getattr(node, "durability", None)
        if d is not None and d.wal is not None:
            try:
                d.wal.close()
            except Exception:
                pass
    for cl in cls:
        try:
            cl.close()
        except Exception:
            pass
    for tr in trs:
        try:
            tr.close()
        except Exception:
            pass


def cut(P, trs, names, a, b) -> None:
    """Sever the link between nodes ``a`` and ``b`` both ways."""
    trs[a].fault_peers = set(trs[a].fault_peers or ()) | {names[b]}
    trs[b].fault_peers = set(trs[b].fault_peers or ()) | {names[a]}
    P.faults.set_master(True)
    P.faults.arm("net.partition", times=0)


def heal_links(P, trs) -> None:
    P.faults.disarm("net.partition")
    for tr in trs:
        tr.fault_peers = set()
