"""The port's partition-tolerant cluster: failure detector, auto-heal,
anti-entropy — the cases of ``tests/test_cluster_heal.py`` that need
neither ``config.py`` nor ``ctl.py``, on port nodes (``device="cpu"``).

Multi-node-in-one-process over real sockets: each node gets its own
``SocketTransport`` (a private IO thread). The port's fault registry
(``emqx_tpu_torch.faults``) is scoped per transport through
``fault_peers``/``fault_local``, so a partition severs exactly the links
a scenario names. The heal matrix holds the healed port cluster's
``plane_digests()`` against a never-partitioned JAX cluster that ran
the same operations: the four non-ban planes, and the ban plane empty
on both (the port has no ban table until ``banned.py``).
"""

import time

import pytest

from emqx_tpu.cluster import Cluster as JCluster
from emqx_tpu.cluster_net import SocketTransport as JSocketTransport
from emqx_tpu.modules.retainer import RetainerModule as JRetainer
from emqx_tpu.node import Node as JNode
from emqx_tpu.types import Message as JMessage
from emqx_tpu_torch import faults
from emqx_tpu_torch.cluster import (Cluster, ClusterConfig,
                                    PeerUnavailableError)
from emqx_tpu_torch.cluster_net import SocketTransport
from emqx_tpu_torch.modules.retainer import RetainerModule
from emqx_tpu_torch.node import Node
from emqx_tpu_torch.types import Message

#: a current, fixed timestamp base: retained LWW and tombstones are
#: timestamp-ordered, so comparing against the JAX cluster needs the
#: SAME timestamps in both — and current ones, or the retainer sweeps
#: the tombstones
TS = float(int(time.time()))


def _fast_cfg(**kw) -> ClusterConfig:
    base = dict(heartbeat_interval_s=0.1, heartbeat_timeout_s=0.5,
                suspect_after=1, down_after=3, ok_after=1,
                anti_entropy_interval_s=0.5, call_timeout_s=2.0,
                redial_backoff_s=0.1, redial_backoff_max_s=0.5)
    base.update(kw)
    return ClusterConfig(**base)


class Sub:
    def __init__(self, cid):
        self.client_id = cid
        self.inbox = []

    def deliver(self, t, m):
        self.inbox.append((t, m))


#: (Node, SocketTransport, Cluster, RetainerModule, Message) per package
PORT = (lambda name: Node(name=name, device="cpu"), SocketTransport,
        Cluster, RetainerModule, Message)
JAX = (lambda name: JNode(name=name, boot_listeners=False),
       JSocketTransport, JCluster, JRetainer, JMessage)


def _mk_net(n, config, cookie, retainer=False, pkg=PORT):
    mk_node, transport, cluster, ret, _msg = pkg
    nodes, trs, cls = [], [], []
    for i in range(n):
        node = mk_node(f"hn{i}")
        if retainer:
            node.modules.load(ret)
        tr = transport(f"hn{i}", cookie=cookie, config=config)
        tr.serve()
        cl = cluster(node, transport=tr, config=config)
        nodes.append(node)
        trs.append(tr)
        cls.append(cl)
    for i in range(1, n):
        cls[i].join_remote("127.0.0.1", trs[0].port)
    return nodes, trs, cls


def _teardown(trs, cls):
    for cl in cls:
        cl.close()
    for tr in trs:
        tr.close()


def _wait(pred, timeout=20.0, msg="condition not met in time"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(msg)


def _partition(trs, side_a, side_b):
    """Sever every link between the two index sets, both ways."""
    for i in side_a:
        trs[i].fault_peers = {f"hn{j}" for j in side_b}
    for j in side_b:
        trs[j].fault_peers = {f"hn{i}" for i in side_a}
    faults.set_master(True)
    faults.arm("net.partition", times=0)


def _converged(clusters):
    digests = [cl.plane_digests() for cl in clusters]
    return all(d == digests[0] for d in digests[1:])


# -- failure detector ------------------------------------------------------


def test_wedged_peer_declared_down_then_autoheals():
    """A wedged-but-connected peer (TCP up, frames swallowed — the
    ``peer.wedge`` point) is declared down within the detector window;
    un-wedging triggers the reappearance probe → auto-heal → membership
    and routes re-merge with no manual rejoin."""
    cfg = _fast_cfg()
    nodes, trs, cls = _mk_net(2, cfg, "wedge-heal")
    try:
        s = Sub("w1")
        nodes[1].broker.subscribe(s, "wedge/+")
        _wait(lambda: nodes[0].router.has_dest("wedge/+", "hn1"),
              5, "route never replicated")
        # wedge ONLY hn1's inbound loop: the failure is asymmetric —
        # exactly what EOF detection misses
        trs[0].fault_local = False
        faults.set_master(True)
        t0 = time.time()
        faults.arm("peer.wedge", times=0)
        try:
            _wait(lambda: cls[0].members == ["hn0"], 10,
                  "wedged peer never declared down")
            assert time.time() - t0 < 8.0
            assert trs[0].peer_state("hn1") == "down"
            _wait(lambda: not nodes[0].router.has_dest(
                "wedge/+", "hn1"), 5, "down peer's routes not purged")
        finally:
            faults.disarm("peer.wedge")
        _wait(lambda: sorted(cls[0].members) == ["hn0", "hn1"]
              and nodes[0].router.has_dest("wedge/+", "hn1"), 15,
              "auto-heal never reconverged the wedged peer")
        _wait(lambda: _converged(cls), 10,
              "digests did not converge after heal")
    finally:
        faults.clear()
        _teardown(trs, cls)


def test_transient_blip_suspect_parks_nothing_purged():
    """A link blip shorter than the down window only demotes the peer
    to suspect: membership and routes stay, casts park in the buffer,
    and recovery flushes them — nothing is purged on suspicion."""
    cfg = _fast_cfg(down_after=1000)  # suspect is a stable state
    nodes, trs, cls = _mk_net(2, cfg, "blip")
    try:
        s = Sub("b1")
        nodes[1].broker.subscribe(s, "blip/pre")
        _wait(lambda: nodes[0].router.has_dest("blip/pre", "hn1"), 5)
        _partition(trs, [0], [1])
        try:
            _wait(lambda: trs[0].peer_state("hn1") == "suspect", 10,
                  "blip never became suspect")
            assert sorted(cls[0].members) == ["hn0", "hn1"]
            assert nodes[0].router.has_dest("blip/pre", "hn1")
            s0 = Sub("b0")
            nodes[0].broker.subscribe(s0, "blip/during")
            time.sleep(0.3)
            assert not nodes[1].router.has_dest("blip/during", "hn0")
        finally:
            faults.disarm("net.partition")
        _wait(lambda: trs[0].peer_state("hn1") == "ok", 10,
              "suspect never recovered to ok")
        _wait(lambda: nodes[1].router.has_dest("blip/during", "hn0"),
              10, "parked cast never flushed after recovery")
        assert sorted(cls[0].members) == ["hn0", "hn1"]
    finally:
        faults.clear()
        _teardown(trs, cls)


def test_suspect_fast_fail_and_degraded_locker_quorum():
    """No broker path blocks ``call_timeout`` on a suspect peer:
    transport calls raise PeerUnavailableError without touching the
    wire, and the CM locker's quorum proceeds degraded instead of
    stalling a CONNECT."""
    cfg = _fast_cfg(down_after=1000)
    nodes, trs, cls = _mk_net(2, cfg, "fastfail")
    try:
        _partition(trs, [0], [1])
        try:
            _wait(lambda: trs[0].peer_state("hn1") == "suspect", 10)
            t0 = time.time()
            with pytest.raises(PeerUnavailableError):
                trs[0].call("hn1", "ping")
            assert time.time() - t0 < 1.0, "fast-fail touched the wire"
            t0 = time.time()
            assert cls[0].locker.acquire("ff-client") is True
            assert time.time() - t0 < 2.0
            cls[0].locker.release_local("ff-client", "hn0")
            drained = cls[0].drain_counters()
            assert drained.get("locker.degraded", 0) >= 1
            assert drained.get("rpc.fastfail", 0) >= 1
            assert drained.get("hb.suspects", 0) >= 1
        finally:
            faults.disarm("net.partition")
    finally:
        faults.clear()
        _teardown(trs, cls)


def test_bounded_call_on_wedged_peer():
    """With the detector on, a call into a wedged peer is bounded by
    the per-peer deadline even while the peer still counts as ok — and
    the deadline cancels the coroutine, so a second call does not
    inherit a wedged link lock."""
    cfg = _fast_cfg(heartbeat_interval_s=5.0, suspect_after=1000,
                    down_after=2000, call_timeout_s=1.0)
    nodes, trs, cls = _mk_net(2, cfg, "bounded")
    try:
        trs[0].fault_local = False
        faults.set_master(True)
        faults.arm("peer.wedge", times=0)
        try:
            for _ in range(2):
                t0 = time.time()
                with pytest.raises(ConnectionError):
                    trs[0].call("hn1", "ping")
                assert time.time() - t0 < 3.0
        finally:
            faults.disarm("peer.wedge")
    finally:
        faults.clear()
        _teardown(trs, cls)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_heartbeat_waiting_for_the_link_leaves_a_slow_call_alone(pkg):
    """A call its peer answers slowly holds the link; a heartbeat that
    times out waiting for the link has sent nothing. The JAX package
    drops the link there all the same, under the call, which then
    fails: so an anti-entropy sync slower than the heartbeat timeout
    never completes, and a cast burst on a link dropped so can be lost
    (ROADMAP queue C). The port drops a link only under its lock, once
    its own frame went out unanswered: the call returns."""
    cfg = _fast_cfg(heartbeat_interval_s=0.05, heartbeat_timeout_s=0.1,
                    suspect_after=100, down_after=200,
                    anti_entropy_interval_s=0, call_timeout_s=5.0)
    nodes, trs, cls = _mk_net(2, cfg, "hb-lock",
                              pkg=PORT if pkg == "port" else JAX)
    try:
        answer = cls[1].handle_rpc

        def slow(op, *args):
            if op == "cluster_info":
                time.sleep(0.5)
            return answer(op, *args)

        cls[1].handle_rpc = slow
        if pkg == "jax":
            with pytest.raises(ConnectionError):
                trs[0].call("hn1", "cluster_info")
        else:
            assert trs[0].call("hn1", "cluster_info")["name"] == "hn1"
    finally:
        _teardown(trs, cls)


# -- anti-entropy ----------------------------------------------------------


def test_net_drop_loss_repaired_by_anti_entropy():
    """``net.drop`` discards a claimed cast burst as if sent: the loss
    is counted, and one anti-entropy sync repairs it."""
    cfg = _fast_cfg(heartbeat_interval_s=1.0,
                    anti_entropy_interval_s=0)  # manual sync below
    nodes, trs, cls = _mk_net(2, cfg, "drop")
    try:
        trs[1].fault_peers = set()  # only hn0's outbound drops
        trs[0].fault_peers = {"hn1"}
        faults.set_master(True)
        faults.arm("net.drop", times=1)
        s = Sub("d0")
        nodes[0].broker.subscribe(s, "drop/lost")
        time.sleep(0.5)
        assert not nodes[1].router.has_dest("drop/lost", "hn0"), \
            "cast was not dropped — arm raced a call drain"
        assert cls[0].drain_counters().get("forward.dropped", 0) == 1
        assert cls[0].anti_entropy_sync("hn1") >= 1
        assert nodes[1].router.has_dest("drop/lost", "hn0")
        assert _converged(cls)
        assert cls[0].anti_entropy_sync("hn1") == 0
    finally:
        faults.clear()
        _teardown(trs, cls)


def test_net_delay_inflates_rtt_without_loss():
    """``net.delay`` stalls frames to a peer, losing nothing: the peer
    stays ``ok`` while the heartbeat RTT inflates by about the delay."""
    cfg = _fast_cfg(heartbeat_interval_s=0.1, heartbeat_timeout_s=2.0,
                    suspect_after=3)
    nodes, trs, cls = _mk_net(2, cfg, "dly")
    try:
        _wait(lambda: trs[0].health_info()
              .get("hn1", {}).get("rtt_ms") is not None,
              msg="no heartbeat RTT before arming")
        trs[1].fault_peers = set()
        trs[0].fault_peers = {"hn1"}
        faults.set_master(True)
        faults.arm("net.delay", times=0, delay_ms=250.0)
        _wait(lambda: (trs[0].health_info()["hn1"]["rtt_ms"] or 0)
              >= 200.0, msg="delay never showed up in heartbeat RTT")
        assert trs[0].peer_state("hn1") == "ok"
        faults.disarm("net.delay")
        _wait(lambda: (trs[0].health_info()["hn1"]["rtt_ms"] or 1e9)
              < 200.0, msg="RTT never recovered after disarm")
        assert trs[0].peer_state("hn1") == "ok"
    finally:
        faults.clear()
        _teardown(trs, cls)


def test_cast_buffer_full_drop_is_counted():
    """The cast-buffer-full shed counts into ``forward.dropped``."""
    tr = SocketTransport("solo", cookie="full")
    try:
        tr.serve()
        tr.register_peer("ghost", "127.0.0.1", 1)  # nothing listens
        tr._CAST_BUF_MAX = 64
        tr.cast("ghost", "forward", "f", "x" * 64)  # fills the buffer
        tr.cast("ghost", "forward", "f", "y")       # shed + counted
        assert tr.drain_counters().get("forward.dropped", 0) == 1
    finally:
        tr.close()


# -- the heal matrix -------------------------------------------------------


def _apply_phase1(pkg, nodes, cls, subs):
    """Pre-partition state on every plane the port carries."""
    Msg = pkg[4]
    n0, n1, n2 = nodes
    subs["a"] = Sub("pa")
    n0.broker.subscribe(subs["a"], "heal/a/#")
    subs["b"] = Sub("pb")
    n1.broker.subscribe(subs["b"], "heal/b/+")
    subs["c"] = Sub("pc")
    n2.broker.subscribe(subs["c"], "heal/c")
    subs["s"] = Sub("ps")
    n2.broker.subscribe(subs["s"], "$share/g/heal/s")
    cls[1].client_up("c-base-1")
    cls[2].client_up("c-base-2")
    n0.broker.publish(Msg(topic="keep/x", payload=b"v1",
                          flags={"retain": True}, timestamp=TS))


def _apply_phase2(pkg, nodes, cls, subs):
    """Route/registry/weight/retained churn — DURING the partition on
    the port cluster, partition-free on the JAX one."""
    Msg = pkg[4]
    n0, n1, n2 = nodes
    subs["d"] = Sub("pd")
    n0.broker.subscribe(subs["d"], "heal/d/#")
    n1.broker.unsubscribe(subs["b"], "heal/b/+")  # stale-delete repair
    cls[0].client_up("c-major")
    n0.broker.publish(Msg(topic="keep/y", payload=b"v2",
                          flags={"retain": True}, timestamp=TS + 1))
    n0.broker.publish(Msg(topic="keep/x", payload=b"",
                          flags={"retain": True},
                          timestamp=TS + 2))  # delete + tombstone
    subs["e"] = Sub("pe")
    n2.broker.subscribe(subs["e"], "heal/e/+")
    subs["t"] = Sub("pt")
    n2.broker.subscribe(subs["t"], "$share/g2/heal/t")
    cls[2].client_up("c-minor")


def test_partition_heal_converges_all_planes_vs_oracle():
    """A 3-node port cluster partitions {hn0,hn1} | {hn2} during churn
    on BOTH sides, heals, and every replicated plane (routes, registry,
    shared weights, retained + tombstones; bans empty) reconverges to
    the digests a never-partitioned JAX cluster computes for the same
    operations — with no manual rejoin."""
    cfg = _fast_cfg()
    nodes, trs, cls = _mk_net(3, cfg, "matrix", retainer=True)
    from emqx_tpu.cluster import ClusterConfig as JConfig

    jcfg = JConfig(**{f: getattr(cfg, f)
                      for f in cfg.__dataclass_fields__})
    onodes, otrs, ocls = _mk_net(3, jcfg, "oracle", retainer=True,
                                 pkg=JAX)
    subs, osubs = {}, {}
    try:
        _apply_phase1(PORT, nodes, cls, subs)
        _apply_phase1(JAX, onodes, ocls, osubs)
        _wait(lambda: _converged(cls) and _converged(ocls), 20,
              "pre-partition state never converged")
        assert cls[0].plane_digests() == ocls[0].plane_digests()

        _partition(trs, [0, 1], [2])
        try:
            _wait(lambda: cls[0].members == ["hn0", "hn1"]
                  and cls[2].members == ["hn2"], 15,
                  "partition never detected")
            _apply_phase2(PORT, nodes, cls, subs)
            _apply_phase2(JAX, onodes, ocls, osubs)
            time.sleep(0.5)
            assert cls[0].plane_digests() != cls[2].plane_digests()
        finally:
            faults.disarm("net.partition")

        _wait(lambda: all(sorted(c.members) == ["hn0", "hn1", "hn2"]
                          for c in cls), 30,
              "membership never re-merged after heal")
        _wait(lambda: _converged(cls), 30,
              "plane digests never converged after heal")
        _wait(lambda: _converged(ocls), 20,
              "the JAX cluster never converged")
        healed = cls[0].plane_digests()
        oracle = ocls[0].plane_digests()
        assert healed == oracle, (healed, oracle)
        assert healed["bans"] == Cluster._digest([])
        for n in nodes:
            ret = n.modules._loaded["retainer"]
            assert "keep/x" not in ret._store
            assert "keep/y" in ret._store
            assert n.router.has_dest("heal/e/+", "hn2")
            assert not n.router.has_dest("heal/b/+", "hn1")
        total = {}
        for c in cls:
            for k, v in c.drain_counters().items():
                total[k] = total.get(k, 0) + v
        assert total.get("heal.rejoins", 0) >= 1
        assert total.get("hb.downs", 0) >= 1
        assert total.get("hb.reappears", 0) >= 1
    finally:
        faults.clear()
        _teardown(trs, cls)
        _teardown(otrs, ocls)


# -- the EOF-only build ------------------------------------------------------


def test_detector_off_is_legacy_build():
    """``detector = false`` (and no config at all) is the EOF-only
    failure story: no heartbeat task, no heal worker, no suspect state,
    no fast-fail — and a wedged-but-connected peer is never declared
    down."""
    cfg = ClusterConfig(detector=False)
    nodes, trs, cls = _mk_net(2, cfg, "legacy")
    try:
        assert trs[0]._hb_enabled is False
        assert cls[0]._heal_thread is None
        assert trs[0].peer_state("hn1") == "ok"
        assert trs[0].health_info() == {}
        trs[0].fault_local = False
        faults.set_master(True)
        faults.arm("peer.wedge", times=0)
        try:
            time.sleep(1.5)
            assert sorted(cls[0].members) == ["hn0", "hn1"]
        finally:
            faults.disarm("peer.wedge")
    finally:
        faults.clear()
        _teardown(trs, cls)


def test_no_config_transport_has_no_detector():
    tr = SocketTransport("lone", cookie="none")
    try:
        tr.serve()
        assert tr._hb_enabled is False
        assert tr.peer_state("whoever") == "ok"
    finally:
        tr.close()


# -- observability ---------------------------------------------------------


def test_stats_tick_surfaces_cluster_health():
    """The stats flush publishes the membership and health gauges and
    folds the counters (the JAX node's rows, without ``ctl``)."""
    cfg = _fast_cfg(anti_entropy_interval_s=0)
    nodes, trs, cls = _mk_net(2, cfg, "obs")
    try:
        assert nodes[0].cluster is cls[0]
        _wait(lambda: trs[0].health_info().get("hn1", {})
              .get("rtt_ms") is not None, 10, "no heartbeat RTT recorded")
        nodes[0].stats.tick()
        st = nodes[0].stats
        assert st.getstat("cluster.members.count") == 2
        assert st.getstat("cluster.member.state") == 0
        assert st.getstat("cluster.hb.rtt_ms") > 0
        assert st.getstat("cluster.member.hn1.state") == 0
        assert nodes[0].metrics.val("cluster.hb.suspects") == 0
    finally:
        faults.clear()
        _teardown(trs, cls)


def test_forward_drop_alarm_via_stats_tick():
    """``cluster.forward.dropped`` raises the ``cluster_forward_dropped``
    alarm on the tick that observes new drops and clears it on the
    first quiet tick."""
    cfg = _fast_cfg(anti_entropy_interval_s=0)
    nodes, trs, cls = _mk_net(2, cfg, "alarm")
    try:
        trs[0]._count("forward.dropped", 3)
        nodes[0].stats.tick()
        active = {a.name for a in nodes[0].alarms.get_alarms("activated")}
        assert "cluster_forward_dropped" in active
        assert nodes[0].metrics.val("cluster.forward.dropped") == 3
        nodes[0].stats.tick()  # quiet tick clears
        active = {a.name for a in nodes[0].alarms.get_alarms("activated")}
        assert "cluster_forward_dropped" not in active
    finally:
        faults.clear()
        _teardown(trs, cls)
