"""The port's replicated durability (``emqx_tpu_torch.replication``)
against the JAX package's: journal shipping, the warm standby,
failover.

Every case of ``tests/test_replication.py`` runs the same seeded
operations on two JAX nodes and on two port nodes (``device="cpu"``),
each pair clustered over its package's ``SocketTransport`` on loopback
in this process. Each keeps the original test's assertions, and the
two runs must give the same replica contents, the same
``durable_digest`` after promotion (byte-exact, RPO = 0 for acked
records), the same counts, link states and alarm edges. The
``ctl durability`` reads become ``durability.info()["replication"]``
(the port has no ``ctl`` yet). A mixed pair — a JAX primary shipping
to a port standby that promotes — shows the wire data-only and
byte-compatible.
"""

import pytest

from emqx_tpu.cluster import Cluster as JCluster
from emqx_tpu.cluster_net import SocketTransport as JTransport
from emqx_tpu.durability import DurabilityConfig as JDur
from emqx_tpu.modules.retainer import RetainerModule as JRetainer
from emqx_tpu.node import Node as JNode
from emqx_tpu.replication import durable_digest as j_durable_digest
from emqx_tpu.session import Session as JSession
from emqx_tpu.types import Message as JMessage
from emqx_tpu.types import SubOpts as JSubOpts
from emqx_tpu_torch.cluster import Cluster as PCluster
from emqx_tpu_torch.cluster_net import SocketTransport as PTransport
from emqx_tpu_torch.modules.retainer import RetainerModule as PRetainer
from emqx_tpu_torch.node import Node as PNode
from emqx_tpu_torch.replication import durable_digest as p_durable_digest
from test_torch_repl_pkgs import (JAX, PORT, active_alarms, boot, both,
                             clear_faults, counts, durable_session,
                             populate, steady_cfg, synced, teardown, wait)


@pytest.fixture(autouse=True)
def _clean_faults():
    clear_faults()
    yield
    clear_faults()


def _mk_pair(P, d, cookie, dur0_kw=None, dur1=False):
    """Two socket-clustered nodes; rn0 is a durable primary shipping
    to rn1. Returns (nodes, transports, clusters)."""
    cfg = steady_cfg(P)
    nodes, trs, cls = [], [], []
    for i in range(2):
        dkw = None
        if i == 0:
            dkw = dict(enabled=True, dir=str(d / f"d{i}"), fsync=False,
                       standby="rn1", wal_shards=2,
                       repl_ack_timeout_s=2.0)
            dkw.update(dur0_kw or {})
        elif dur1:
            dkw = dict(enabled=True, dir=str(d / f"d{i}"), fsync=False)
        node, tr, cl = boot(P, f"rn{i}", P.Dur(**dkw) if dkw else None,
                            cookie, cfg)
        nodes.append(node)
        trs.append(tr)
        cls.append(cl)
    cls[1].join_remote("127.0.0.1", trs[0].port)
    return nodes, trs, cls


def _kill_primary(nodes, trs):
    """kill -9 analogue for the clustered primary: drop its durability
    hooks and sever its transport so the peer's detector declares it
    down."""
    nodes[0].broker.durability = None
    nodes[0].cm.durability = None
    trs[0].close()


def _replica(rep):
    with rep.lock:
        return {"sessions": sorted(rep.sessions),
                "retained": sorted(rep.retained),
                "tombs": sorted(rep.tombs),
                "routes": sorted(rep.routes.items(), key=repr),
                "promoted": rep.promoted, "clean": rep.clean}


# -- shipping --------------------------------------------------------------


def _ship_and_ack(P, d):
    nodes, trs, cls = _mk_pair(P, d, f"rep-ship-{P.name}")
    try:
        populate(P, nodes[0])
        wait(lambda: synced(nodes[0]), msg="journal never acked")
        rep = nodes[1].replication.replicas["rn0"]
        assert rep.sessions and "dev1" in rep.sessions
        assert "fleet/1/state" in rep.retained
        assert "fleet/2/state" in rep.tombs
        assert any(k[0] == "fleet/+/state" for k in rep.routes)
        assert not rep.promoted
        r = nodes[0].replication
        assert r.info()["role"] == "primary"
        assert r.lag() == (0, 0)
        assert r.counters["repl.resyncs"] == 1  # the initial hello
        return {"replica": _replica(rep), "lag": r.lag(),
                "offered": r.offered_seq, "acked": r.acked_seq,
                "resyncs": r.counters["repl.resyncs"]}
    finally:
        teardown(nodes, trs, cls)


def test_ship_and_ack_reach_warm_replica(tmp_path):
    both(_ship_and_ack, tmp_path)


def _incremental(P, d):
    nodes, trs, cls = _mk_pair(P, d, f"rep-inc-{P.name}")
    try:
        populate(P, nodes[0])
        wait(lambda: synced(nodes[0]), msg="initial sync")
        resyncs = nodes[0].replication.counters["repl.resyncs"]
        s2 = durable_session(P, nodes[0], "dev2")
        s2.subscribe("late/+", P.SubOpts(qos=1))
        nodes[0].broker.publish(P.Message(
            topic="late/r", payload=b"v", flags={"retain": True}))
        nodes[0].durability.on_batch()
        wait(lambda: synced(nodes[0]), msg="incremental sync")
        rep = nodes[1].replication.replicas["rn0"]
        assert "dev2" in rep.sessions
        assert "late/r" in rep.retained
        assert nodes[0].replication.counters["repl.resyncs"] == resyncs
        return {"replica": _replica(rep), "resyncs": resyncs,
                "offered": nodes[0].replication.offered_seq}
    finally:
        teardown(nodes, trs, cls)


def test_incremental_ship_after_hello(tmp_path):
    """Records journaled after the initial snapshot ship as the
    incremental stream (no re-hello)."""
    both(_incremental, tmp_path)


# -- failover --------------------------------------------------------------


def _promote(P, d):
    nodes, trs, cls = _mk_pair(P, d, f"rep-promote-{P.name}")
    try:
        s = populate(P, nodes[0])
        assert len(s.inflight) == 2
        wait(lambda: synced(nodes[0]), msg="sync before kill")
        r = nodes[0].replication
        acked_at_kill = r.acked_seq
        assert acked_at_kill == r.offered_seq  # RPO = 0 premise
        # the digest compares the session DETACHED on both sides
        nodes[0].cm._detached["dev1"] = (s, 0, 300.0)
        want = P.durable_digest(nodes[0])
        del nodes[0].cm._detached["dev1"]
        _kill_primary(nodes, trs)
        wait(lambda: nodes[1].replication.replicas["rn0"].promoted,
             msg="standby never promoted")
        rep = nodes[1].replication.replicas["rn0"]
        assert rep.applied_seq >= acked_at_kill  # nothing acked lost
        assert "dev1" in nodes[1].cm._detached
        got = P.durable_digest(nodes[1])
        assert got == want, "promoted state diverged from primary"
        s2 = nodes[1].cm._detached["dev1"][0]
        assert len(s2.inflight) == 2
        assert nodes[1].router.route_refs(
            "fleet/+/state", nodes[1].broker.node) == 1
        lp = nodes[1].replication.last_promotion
        assert lp["primary"] == "rn0" and lp["failover_s"] < 5.0
        assert lp["sessions"] == 1
        nodes[1].stats.tick()
        return {"digest": got,
                "rpo_records": acked_at_kill - min(rep.applied_seq,
                                                   acked_at_kill),
                "counts": counts(nodes[1]),
                "promotion": {k: lp[k] for k in ("primary", "sessions",
                                                 "routes", "retained",
                                                 "clean")},
                "alarms": active_alarms(nodes[1]),
                "promotions": nodes[1].metrics.val(
                    "durability.repl.promotions")}
    finally:
        teardown(nodes, trs, cls)


def test_promote_on_primary_down_byte_exact_rpo_zero(tmp_path):
    """The headline property: primary dies, standby promotes — durable
    planes digest-equal to the primary's pre-kill state (routes
    remapped to the standby), RPO = 0 for acked records; the same
    digest in both packages."""
    out = both(_promote, tmp_path)
    assert out["rpo_records"] == 0
    assert out["alarms"] == ["standby_promoted"]


def _double(P, d):
    nodes, trs, cls = _mk_pair(P, d, f"rep-double-{P.name}", dur1=True)
    try:
        populate(P, nodes[0])
        wait(lambda: synced(nodes[0]), msg="sync before kill")
        _kill_primary(nodes, trs)
        wait(lambda: nodes[1].replication.replicas["rn0"].promoted,
             msg="standby never promoted")
        want = P.durable_digest(nodes[1])
        # crash the promoted standby (no graceful path)…
        nodes[1].broker.durability = None
        nodes[1].cm.durability = None
        nodes[1].durability.wal.close()
        nodes[1].durability = None
        # …and recover a fresh incarnation from its directory
        n2 = P.Node("rn1", durability=P.Dur(
            enabled=True, dir=str(d / "d1"), fsync=False))
        n2.modules.load(P.Retainer)
        n2.durability.recover()
        assert "dev1" in n2.cm._detached
        got = P.durable_digest(n2)
        assert got == want
        n2.durability.wal.close()
        return {"digest": got, "counts": counts(n2)}
    finally:
        teardown(nodes, trs, cls)


def test_promoted_standby_journals_and_survives_its_own_crash(tmp_path):
    """Double recovery on the promoted side: a standby with its own
    durability checkpoints the adopted state, so ITS crash right after
    failover recovers the inherited sessions exactly."""
    both(_double, tmp_path)


# -- degradation + resync --------------------------------------------------


def _fallback(P, d):
    nodes, trs, cls = _mk_pair(P, d, f"rep-fallback-{P.name}")
    try:
        populate(P, nodes[0])
        wait(lambda: synced(nodes[0]), msg="initial sync")
        resyncs0 = nodes[0].replication.counters["repl.resyncs"]
        trs[0].fault_peers = {"rn1"}
        trs[1].fault_peers = {"rn0"}
        P.faults.set_master(True)
        P.faults.arm("net.partition", times=0)
        s2 = durable_session(P, nodes[0], "dev2")
        s2.subscribe("cut/+", P.SubOpts(qos=1))
        nodes[0].durability.on_batch()
        wait(lambda: nodes[0].replication.state == "local_only",
             msg="shipper never degraded")
        # local durability is unaffected: the journal has the records
        assert nodes[0].durability.wal.records > 0
        lagged = nodes[0].replication.lag()[0] > 0
        assert lagged
        P.faults.disarm("net.partition")
        wait(lambda: synced(nodes[0]), timeout=30.0,
             msg="shipper never resynced")
        rep = nodes[1].replication.replicas["rn0"]
        assert "dev2" in rep.sessions
        assert nodes[0].replication.counters["repl.resyncs"] >= resyncs0
        return {"replica": _replica(rep), "lagged": lagged,
                "lag": nodes[0].replication.lag()}
    finally:
        teardown(nodes, trs, cls)


def test_suspect_standby_falls_back_local_only_then_resyncs(tmp_path):
    """An unreachable standby drops the shipper to local-only (local
    durability unaffected); when the peer heals, shipping resyncs and
    lag returns to zero."""
    both(_fallback, tmp_path)


def _ship_fault(P, d):
    nodes, trs, cls = _mk_pair(P, d, f"rep-fault-{P.name}")
    r = None
    try:
        populate(P, nodes[0])
        wait(lambda: synced(nodes[0]), msg="initial sync")
        r = nodes[0].replication
        errors0 = r.counters["repl.ship_errors"]
        with P.faults.injected("repl.ship", times=1):
            s2 = durable_session(P, nodes[0], "dev2")
            s2.subscribe("drop/+", P.SubOpts(qos=1))
            nodes[0].durability.on_batch()
            wait(lambda: r.counters["repl.ship_errors"] > errors0,
                 msg="drop never fired")
        wait(lambda: synced(nodes[0]), msg="post-drop resync")
        assert "dev2" in nodes[1].replication.replicas["rn0"].sessions
        with P.faults.injected("repl.ship", action="stall", times=1,
                               delay_ms=50):
            s3 = durable_session(P, nodes[0], "dev3")
            s3.subscribe("slow/+", P.SubOpts(qos=1))
            nodes[0].durability.on_batch()
            wait(lambda: synced(nodes[0]), msg="stalled ship")
        rep = nodes[1].replication.replicas["rn0"]
        assert "dev3" in rep.sessions
        return {"replica": _replica(rep),
                "ship_errors": r.counters["repl.ship_errors"] - errors0}
    finally:
        teardown(nodes, trs, cls)


def test_repl_ship_fault_point_drop_and_stall(tmp_path):
    """The repl.ship fault point: drop discards the ship call (the
    shipper degrades, then resyncs when disarmed); stall only delays
    it."""
    assert both(_ship_fault, tmp_path)["ship_errors"] == 1


# -- graceful shutdown hand-off -------------------------------------------


def _bye(P, d):
    nodes, trs, cls = _mk_pair(P, d, f"rep-bye-{P.name}")
    try:
        populate(P, nodes[0])
        wait(lambda: synced(nodes[0]), msg="initial sync")
        # tail records the shutdown must hand off (never on_batch'd)
        s2 = durable_session(P, nodes[0], "tail")
        s2.subscribe("tail/+", P.SubOpts(qos=1))
        nodes[0].durability.shutdown()
        rep = nodes[1].replication.replicas["rn0"]
        assert rep.clean
        assert "tail" in rep.sessions
        r = nodes[0].replication
        assert r.acked_seq >= r.offered_seq
        m = P.checkpoint.read_manifest(str(d / "d0"))
        assert m["clean_shutdown"]
        return {"replica": _replica(rep), "clean": m["clean_shutdown"]}
    finally:
        teardown(nodes, trs, cls)


def test_graceful_shutdown_ships_tail_and_stamps_clean(tmp_path):
    """A graceful shutdown on a replicating primary: the journal tail
    ships, the standby acks it, the replica is stamped clean, and the
    final checkpoint carries clean_shutdown — failback never replays a
    torn tail."""
    both(_bye, tmp_path)


# -- observability ---------------------------------------------------------


def _obs(P, d):
    nodes, trs, cls = _mk_pair(
        P, d, f"rep-obs-{P.name}",
        dur0_kw=dict(repl_lag_alarm_records=3, repl_lag_clear_records=0))
    edges = []
    try:
        populate(P, nodes[0])
        wait(lambda: synced(nodes[0]), msg="initial sync")
        blk = nodes[0].durability.info()["replication"]
        assert blk["role"] == "primary" and blk["standby"] == "rn1"
        assert blk["acked_seq"] == blk["offered_seq"]
        assert blk["lag_records"] == 0
        assert blk["last_ack_age_s"] is not None
        # standby side: the warm replica shows in its info too
        sb = nodes[1].replication.info()["standby_for"]["rn0"]
        assert sb["sessions"] >= 1
        nodes[0].stats.tick()
        assert nodes[0].metrics.val("durability.repl.shipped") > 0
        assert nodes[0].metrics.val("durability.repl.acked") > 0
        assert nodes[0].stats.all()["durability.repl.lag_records"] == 0
        edges.append(active_alarms(nodes[0]))
        # wedge the standby and outrun the tiny lag bound → alarm
        trs[0].fault_peers = {"rn1"}
        trs[1].fault_peers = {"rn0"}
        P.faults.set_master(True)
        P.faults.arm("net.partition", times=0)
        s2 = durable_session(P, nodes[0], "lagger")
        for i in range(6):
            s2.subscribe(f"lag/{i}", P.SubOpts(qos=1))
        nodes[0].durability.on_batch()
        wait(lambda: nodes[0].replication.state == "local_only",
             msg="never degraded")
        nodes[0].stats.tick()
        assert "replication_lagging" in active_alarms(nodes[0])
        edges.append(active_alarms(nodes[0]))
        # heal → resync → lag back under the clear bound → alarm off
        P.faults.disarm("net.partition")
        wait(lambda: synced(nodes[0]), timeout=30.0,
             msg="never resynced")
        nodes[0].stats.tick()
        assert "replication_lagging" not in active_alarms(nodes[0])
        edges.append(active_alarms(nodes[0]))
        return {"edges": edges, "standby": blk["standby"],
                "state": nodes[0].replication.state,
                "replica_sessions": sb["sessions"]}
    finally:
        teardown(nodes, trs, cls)


def test_ctl_metrics_and_lag_alarm_hysteresis(tmp_path):
    out = both(_obs, tmp_path)
    assert out["edges"] == [[], ["replication_lagging"], []]


def _no_standby(P, d):
    nodes, trs, cls = _mk_pair(P, d, f"rep-off-{P.name}",
                               dur0_kw=dict(standby=""))
    try:
        assert nodes[0].replication._thread is None
        assert nodes[0].durability.repl is None
        populate(P, nodes[0])
        assert nodes[1].replication.replicas == {}
        # a stray ship to a node with no replica answers resync, not an
        # error
        reply = cls[1].handle_rpc("repl_ship", "ghost", 1, [])
        assert reply["resync"]
        return {"reply": reply, "info": nodes[0].replication.info()}
    finally:
        teardown(nodes, trs, cls)


def test_no_standby_config_builds_no_shipper(tmp_path):
    """Replication is opt-in: without a configured standby the cluster
    attaches only the (inert) replica-hosting manager."""
    both(_no_standby, tmp_path)


@pytest.mark.parametrize("kw", [
    dict(repl_lag_alarm_records=1, repl_lag_clear_records=2),
    dict(repl_queue_max_records=0),
    dict(repl_ack_timeout_s=0)])
def test_config_rejects_bad_repl_knobs(kw):
    with pytest.raises(ValueError) as je:
        JAX.Dur(enabled=True, **kw)
    with pytest.raises(ValueError) as pe:
        PORT.Dur(enabled=True, **kw)
    assert str(pe.value) == str(je.value)


# -- a mixed pair: a JAX primary, a port standby --------------------------


def test_jax_primary_ships_to_a_port_standby_that_promotes(tmp_path):
    """The journal stream and its snapshot are data on the wire, byte
    for byte the same in both packages: a JAX primary ships to a port
    standby, dies, and the port node promotes to the JAX primary's
    pre-kill digest."""
    cookie = "rep-mixed"
    cfg_j, cfg_p = steady_cfg(JAX), steady_cfg(PORT)
    jn = JNode(name="mx0", boot_listeners=False, durability=JDur(
        enabled=True, dir=str(tmp_path / "d0"), fsync=False,
        standby="mx1", repl_ack_timeout_s=2.0))
    jn.modules.load(JRetainer)
    jn.durability.recover()
    jtr = JTransport("mx0", cookie=cookie, config=cfg_j)
    jtr.serve()
    jcl = JCluster(jn, transport=jtr, config=cfg_j)
    pn = PNode(name="mx1", device="cpu")
    pn.modules.load(PRetainer)
    ptr = PTransport("mx1", cookie=cookie, config=cfg_p)
    ptr.serve()
    pcl = PCluster(pn, transport=ptr, config=cfg_p)
    try:
        pcl.join_remote("127.0.0.1", jtr.port)
        wait(lambda: sorted(jcl.members) == sorted(pcl.members)
             == ["mx0", "mx1"], msg="the mixed pair never joined")
        s = JSession("dev1", broker=jn.broker, clean_start=False)
        jn.durability.session_opened(s, 300.0)

        class _C:
            session, client_id = s, "dev1"

        jn.cm.register_channel("dev1", _C())
        s.subscribe("fleet/+/state", JSubOpts(qos=1))
        s.subscribe("$share/g/fleet/cmd", JSubOpts(qos=2))
        jn.broker.publish(JMessage(topic="fleet/1/state", payload=b"up",
                                   qos=1, flags={"retain": True}))
        jn.broker.publish(JMessage(topic="fleet/9/state", payload=b"q",
                                   qos=1))
        jn.durability.on_batch()
        r = jn.replication
        wait(lambda: r.state == "replicating"
             and r.acked_seq >= r.offered_seq, msg="never acked")
        jn.cm._detached["dev1"] = (s, 0, 300.0)
        want = j_durable_digest(jn)
        del jn.cm._detached["dev1"]
        jn.broker.durability = None
        jn.cm.durability = None
        jtr.close()
        rep = pn.replication.replicas["mx0"]
        wait(lambda: rep.promoted, msg="the port standby never promoted")
        assert rep.applied_seq >= r.acked_seq
        assert p_durable_digest(pn) == want
        assert len(pn.cm._detached["dev1"][0].inflight) == 2
        assert pn.router.route_refs("fleet/+/state", "mx1") == 1
    finally:
        if jn.durability is not None and jn.durability.wal is not None:
            jn.durability.wal.close()
        for x in (jcl, pcl, jtr, ptr):
            x.close()
