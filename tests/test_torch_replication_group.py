"""The port's replication groups against the JAX package's: fan-out to
several standbys, the ack quorum, promotion arbitration, FAILBACK, and
the kill-anything soak.

Every case of ``tests/test_replication_group.py`` but the ``slow``
soak runs the same seeded operations on JAX nodes and on port nodes
(``device="cpu"``), each group clustered over its package's
``SocketTransport`` on loopback in this process. Each keeps the
original test's assertions, and the two runs must give the same
replica contents, the same ``durable_digest`` after promotion and
after failback, the same counts, quorum counters and alarm edges.
Failback runs at one session here, and at 500 in
``test_failback_at_500_sessions_digest_exact`` (a size the JAX package
completes on this harness).
"""

import os
import random
import time

import pytest

from test_torch_repl_pkgs import (active_alarms, boot, both, clear_faults,
                             counts, cut, durable_session, heal_links,
                             populate, steady_cfg, synced, teardown, wait,
                             wait_soft, wait_synced)


@pytest.fixture(autouse=True)
def _clean_faults():
    clear_faults()
    yield
    clear_faults()


def _dur_cfg(P, d, i, names, ack_quorum, quorum_timeout_ms, extra=None):
    me = names[i]
    others = [x for x in names if x != me]
    kw = dict(enabled=True, dir=str(d / f"d{i}"), fsync=False,
              standbys=others, ack_quorum=ack_quorum,
              quorum_timeout_ms=quorum_timeout_ms, wal_shards=2,
              repl_ack_timeout_s=2.0)
    kw.update(extra or {})
    return P.Dur(**kw)


def _mk_group(P, d, cookie, n=3, durable="all", ack_quorum=0,
              quorum_timeout_ms=400.0, extra_dur=None, cluster_kw=None):
    """n socket-clustered nodes. ``durable="all"``: every node is a
    durable primary fanning its journal to every other member (the
    symmetric quorum group); ``"first"``: only node 0 is durable,
    shipping to all the others (the directed fan-out shape)."""
    ccfg = steady_cfg(P, **{"anti_entropy_interval_s": 1.0,
                            **(cluster_kw or {})})
    names = [f"rg{i}" for i in range(n)]
    nodes, trs, cls = [], [], []
    for i, name in enumerate(names):
        dcfg = None
        if durable == "all" or i == 0:
            dcfg = _dur_cfg(P, d, i, names, ack_quorum,
                            quorum_timeout_ms, extra_dur)
        node, tr, cl = boot(P, name, dcfg, cookie, ccfg)
        nodes.append(node)
        trs.append(tr)
        cls.append(cl)
    for i in range(1, n):
        cls[i].join_remote("127.0.0.1", trs[0].port)
    return names, nodes, trs, cls, ccfg


def _kill(nodes, trs, cls, i):
    """kill -9 analogue: sever durability hooks (no more journaling, no
    graceful tail ship), stop the node's cluster threads, drop its
    transport so peers' detectors declare it down. The journal
    directory keeps only what was flushed — exactly a crash."""
    nodes[i].broker.durability = None
    nodes[i].cm.durability = None
    cls[i].close()
    trs[i].close()


def _restart(P, d, names, i, cookie, ccfg, ack_quorum, quorum_timeout_ms,
             join_port, extra_dur=None):
    """Fresh incarnation of a killed node: recover from its journal
    directory, rejoin through a survivor."""
    dcfg = _dur_cfg(P, d, i, names, ack_quorum, quorum_timeout_ms,
                    extra_dur)
    node, tr, cl = boot(P, names[i], dcfg, cookie, ccfg)
    cl.join_remote("127.0.0.1", join_port)
    return node, tr, cl


def _replica(rep):
    with rep.lock:
        return {"sessions": sorted(rep.sessions),
                "retained": sorted(rep.retained),
                "tombs": sorted(rep.tombs),
                "routes": sorted(rep.routes.items(), key=repr),
                "peers": list(rep.peers), "promoted": rep.promoted}


# -- fan-out ---------------------------------------------------------------


def _fanout(P, d):
    names, nodes, trs, cls, _ = _mk_group(P, d, f"grp-fan-{P.name}",
                                          durable="first")
    try:
        populate(P, nodes[0])
        wait(lambda: synced(nodes[0]), msg="fan-out never synced")
        reps = []
        for i in (1, 2):
            rep = nodes[i].replication.replicas["rg0"]
            assert "dev1" in rep.sessions
            assert "fleet/1/state" in rep.retained
            assert "fleet/2/state" in rep.tombs
            assert rep.peers == ["rg1", "rg2"]
            assert not rep.promoted
            reps.append(_replica(rep))
        r = nodes[0].replication
        info = r.info()
        assert set(info["standbys"]) == {"rg1", "rg2"}
        assert all(p["state"] == "replicating"
                   for p in info["standbys"].values())
        assert r.lag() == (0, 0)
        assert info["ack_quorum"] == 0
        assert info["quorum_acked_seq"] >= info["offered_seq"] - 1
        return {"replicas": reps, "offered": info["offered_seq"],
                "quorum_acked": info["quorum_acked_seq"]}
    finally:
        teardown(nodes, trs, cls)


def test_fanout_ships_to_all_standbys(tmp_path):
    both(_fanout, tmp_path)


def _one_dead(P, d):
    names, nodes, trs, cls, _ = _mk_group(P, d, f"grp-deg-{P.name}",
                                          durable="first")
    try:
        populate(P, nodes[0])
        wait(lambda: synced(nodes[0]), msg="initial sync")
        cut(P, trs, names, 0, 1)
        s2 = durable_session(P, nodes[0], "dev2")
        s2.subscribe("late/+", P.SubOpts(qos=1))
        nodes[0].durability.on_batch()
        r = nodes[0].replication
        wait(lambda: r.peers["rg2"].acked_seq >= r.offered_seq
             and r.peers["rg1"].state == "local_only",
             msg="sibling never kept shipping")
        assert r.state == "partial"
        assert "dev2" in nodes[2].replication.replicas["rg0"].sessions
        assert "dev2" not in nodes[1].replication.replicas["rg0"].sessions
        heal_links(P, trs)
        wait_synced([nodes[0]], msg="cut standby never resynced")
        assert "dev2" in nodes[1].replication.replicas["rg0"].sessions
        return {"replicas": [_replica(nodes[i].replication
                                      .replicas["rg0"]) for i in (1, 2)],
                "state": r.state}
    finally:
        teardown(nodes, trs, cls)


def test_one_dead_standby_degrades_only_its_link(tmp_path):
    """A cut standby goes local-only; the healthy sibling keeps
    replicating (aggregate state 'partial'), and the cut one resyncs on
    heal."""
    both(_one_dead, tmp_path)


# -- quorum ----------------------------------------------------------------


def _q0(P, d):
    names, nodes, trs, cls, _ = _mk_group(P, d, f"grp-q0-{P.name}",
                                          durable="first", ack_quorum=0)
    try:
        populate(P, nodes[0])
        wait(lambda: synced(nodes[0]), msg="initial sync")
        cut(P, trs, names, 0, 1)
        cut(P, trs, names, 0, 2)
        s2 = durable_session(P, nodes[0], "async")
        s2.subscribe("a/+", P.SubOpts(qos=1))
        t0 = time.perf_counter()
        nodes[0].durability.on_batch()
        took = time.perf_counter() - t0
        assert took < 0.1, f"async commit blocked {took:.3f}s"
        r = nodes[0].replication
        assert r.counters["repl.quorum.waits"] == 0
        assert r.counters["repl.quorum.timeouts"] == 0
        return {"waits": r.counters["repl.quorum.waits"],
                "timeouts": r.counters["repl.quorum.timeouts"]}
    finally:
        teardown(nodes, trs, cls)


def test_ack_quorum_zero_never_blocks(tmp_path):
    """The async pin: with every standby unreachable, ack_quorum=0
    group commits return without any quorum wait."""
    both(_q0, tmp_path)


def _q1(P, d):
    names, nodes, trs, cls, _ = _mk_group(
        P, d, f"grp-q1-{P.name}", durable="first", ack_quorum=1,
        quorum_timeout_ms=200.0)
    edges = []
    try:
        populate(P, nodes[0])
        wait(lambda: synced(nodes[0]), msg="initial sync")
        cut(P, trs, names, 0, 1)
        cut(P, trs, names, 0, 2)
        s2 = durable_session(P, nodes[0], "qdev")
        s2.subscribe("q/+", P.SubOpts(qos=1))
        t0 = time.perf_counter()
        nodes[0].durability.on_batch()
        took = time.perf_counter() - t0
        assert took >= 0.15, f"quorum commit returned in {took:.3f}s"
        assert took < 2.0, "quorum wait not bounded"
        r = nodes[0].replication
        assert r.counters["repl.quorum.timeouts"] >= 1
        nodes[0].stats.tick()
        assert "repl_quorum_degraded" in active_alarms(nodes[0])
        edges.append(active_alarms(nodes[0]))
        assert r.info()["quorum_degraded"]
        heal_links(P, trs)
        wait_synced([nodes[0]], msg="never resynced after heal")
        nodes[0].stats.tick()
        assert "repl_quorum_degraded" not in active_alarms(nodes[0])
        edges.append(active_alarms(nodes[0]))
        assert r.counters["repl.quorum.waits"] >= 1
        nodes[0].stats.tick()
        assert nodes[0].metrics.val("durability.repl.quorum.timeouts") >= 1
        return {"edges": edges, "degraded": r.info()["quorum_degraded"]}
    finally:
        teardown(nodes, trs, cls)


def test_quorum_wait_blocks_bounded_then_degrades(tmp_path):
    """ack_quorum=1 with every standby cut: the group commit blocks the
    bounded window, times out (counter), raises the repl_quorum_degraded
    alarm — and clears it once the quorum catches back up after
    heal."""
    out = both(_q1, tmp_path)
    assert out["edges"] == [["repl_quorum_degraded"], []]


def _k2(P, d, victim):
    names, nodes, trs, cls, _ = _mk_group(
        P, d, f"grp-k{victim}-{P.name}", durable="first", ack_quorum=2)
    try:
        s = populate(P, nodes[0])
        wait(lambda: synced(nodes[0]), msg="sync before kill")
        r = nodes[0].replication
        assert r.quorum_acked_seq() >= r.offered_seq
        acked = r.offered_seq
        nodes[0].cm._detached["dev1"] = (s, 0, 600.0)
        want = P.durable_digest(nodes[0])
        del nodes[0].cm._detached["dev1"]
        _kill(nodes, trs, cls, victim)
        if victim == 0:
            # one (and only one) standby promotes — deterministic
            # arbitration: equal applied offsets, first name wins
            wait(lambda: nodes[1].replication.replicas["rg0"].promoted,
                 msg="no standby promoted")
            time.sleep(0.5)
            assert not nodes[2].replication.replicas["rg0"].promoted
            assert P.durable_digest(nodes[1]) == want
            assert nodes[1].replication.replicas["rg0"] \
                .applied_seq >= acked
            promoted = [i for i in (1, 2) if nodes[i].replication
                        .replicas["rg0"].promoted]
        else:
            other = 2 if victim == 1 else 1
            nodes[0].cm._detached["dev1"] = (s, 0, 600.0)
            assert P.durable_digest(nodes[0]) == want
            del nodes[0].cm._detached["dev1"]
            rep = nodes[other].replication.replicas["rg0"]
            assert rep.applied_seq >= acked
            assert "dev1" in rep.sessions
            promoted = []
        return {"digest": want, "promoted": promoted}
    finally:
        teardown(nodes, trs, cls)


@pytest.mark.parametrize("victim", [0, 1, 2])
def test_quorum_acked_survives_any_single_node_loss(tmp_path, victim):
    """The K-1 survival property at K=2: every record is acked by BOTH
    standbys before the kill, so losing any one node — the primary or
    either standby — leaves the full digest-exact state reachable on the
    survivors."""
    both(_k2, tmp_path, victim)


def _arbitration(P, d):
    names, nodes, trs, cls, _ = _mk_group(P, d, f"grp-arb-{P.name}",
                                          durable="first")
    try:
        populate(P, nodes[0])
        wait(lambda: synced(nodes[0]), msg="initial sync")
        # rg1 (the name-order favourite) missed the tail: wind its
        # replica back the way a dropped last batch leaves it
        rep1 = nodes[1].replication.replicas["rg0"]
        with rep1.lock:
            rep1.applied_seq -= 2
            rep1.sessions.pop("dev1", None)
        _kill(nodes, trs, cls, 0)
        wait(lambda: nodes[2].replication.replicas["rg0"].promoted,
             msg="full replica never promoted")
        time.sleep(0.5)
        assert not nodes[1].replication.replicas["rg0"].promoted
        assert "dev1" in nodes[2].cm._detached
        return {"digest": P.durable_digest(nodes[2]),
                "counts": counts(nodes[2])}
    finally:
        teardown(nodes, trs, cls)


def test_promotion_arbitration_highest_applied_wins(tmp_path):
    """A standby that missed the tail (lower applied offset) defers to
    the one that has it, regardless of name order."""
    both(_arbitration, tmp_path)


# -- failback --------------------------------------------------------------


def _cycle(P, d, n_sessions=1, durable="all"):
    cookie = f"grp-fb{n_sessions}-{P.name}"
    names, nodes, trs, cls, ccfg = _mk_group(
        P, d, cookie, n=2, durable=durable,
        cluster_kw=dict(anti_entropy_interval_s=0.5))
    try:
        populate(P, nodes[0])
        # the rest of the fleet: persistent sessions with a filter of
        # their own each, as the JAX failover bench's
        # (bench.py:2571-2577): the failback hand-off's chunked
        # transfer
        for i in range(1, n_sessions):
            s = durable_session(P, nodes[0], f"fl{i:04d}", expiry=600.0)
            s.subscribe(f"fb/{i}/+", P.SubOpts(qos=1))
        nodes[0].durability.on_batch()
        wait(lambda: synced(nodes[0]), msg="initial sync")
        _kill(nodes, trs, cls, 0)
        wait(lambda: nodes[1].replication.replicas["rg0"].promoted,
             msg="standby never promoted")
        assert "dev1" in nodes[1].cm._detached
        promoted_digest = P.durable_digest(nodes[1])
        # post-promotion churn the failback must carry home: a QoS1
        # publish queues into the adopted detached session's mqueue,
        # and a retained change lands in the replicated plane
        nodes[1].broker.publish(P.Message(
            topic="fleet/5/state", payload=b"pp", qos=1))
        nodes[1].broker.publish(P.Message(
            topic="fleet/7/state", payload=b"rr", qos=1,
            flags={"retain": True}))
        want = P.durable_digest(nodes[1])
        fb0 = nodes[1].replication.counters["repl.failbacks"]
        node0b, tr0b, cl0b = _restart(P, d, names, 0, cookie, ccfg, 0,
                                      400.0, trs[1].port)
        nodes[0], trs[0], cls[0] = node0b, tr0b, cl0b
        wait(lambda: not nodes[1].replication.replicas["rg0"].promoted,
             timeout=40, msg="standby never demoted")
        assert nodes[1].replication.counters["repl.failbacks"] == fb0 + 1
        wait_synced([node0b], msg="primary never resynced post-failback")
        # sessions handed over: home again, gone from the standby — and
        # never attached anywhere (no session-present storm)
        assert "dev1" in node0b.cm._detached
        assert "dev1" not in nodes[1].cm._detached
        assert "dev1" not in nodes[1].cm._channels
        s0 = node0b.cm._detached["dev1"][0]
        assert any(m.topic == "fleet/5/state"
                   for _p, q in s0.mqueue.snapshot() for m in q)
        # byte-exact convergence (retained rides anti-entropy)
        wait(lambda: P.durable_digest(node0b) == want, timeout=40,
             msg="failback digest never converged")
        # the standby holds none of the handed routes: its refcounts
        # came back exact
        handed_refs = {f: d2 for f, d2 in
                       nodes[1].router.route_table().items()
                       if any(x == "rg1" or (isinstance(x, tuple)
                                             and x[1] == "rg1")
                              for x in d2)}
        assert not handed_refs, handed_refs
        assert "standby_promoted" not in active_alarms(nodes[1])
        fb = nodes[1].replication.last_failback
        out = {"promoted_digest": promoted_digest, "digest": want,
               "failback": {k: fb[k] for k in ("primary", "sessions",
                                               "kept", "closed")},
               "counts": [counts(nodes[0]), counts(nodes[1])]}
        if n_sessions == 1:
            # …and the original dying AGAIN re-promotes from the
            # re-staged replica
            _kill(nodes, trs, cls, 0)
            wait(lambda: nodes[1].replication.replicas["rg0"].promoted,
                 timeout=40, msg="standby never re-promoted")
            assert "dev1" in nodes[1].cm._detached
            out["repromoted"] = P.durable_digest(nodes[1])
        return out
    finally:
        teardown(nodes, trs, cls)


def test_failover_failback_refailover_cycle(tmp_path):
    """The full cycle: primary dies → standby promotes; primary
    restarts from its own (stale) disk → the promoted standby ships the
    post-promotion state back, hands the sessions over without a
    session-present storm, demotes, and the pair converges
    digest-byte-exact; the primary dying AGAIN re-promotes the standby
    from the re-staged replica."""
    out = both(_cycle, tmp_path)
    assert out["failback"]["sessions"] == 1


def test_failback_at_500_sessions_digest_exact(tmp_path):
    """Failback at 500 sessions (two hand-off chunks of 256), in the
    JAX failover bench's shape (only the primary durable, a filter a
    session): the restored primary's digest equals the promoted
    standby's pre-failback digest, and the standby holds none of the
    handed routes — in both packages."""
    out = both(_cycle, tmp_path, 500, "first")
    assert out["failback"]["sessions"] == 500
    assert out["counts"][0]["sessions"] == 500
    assert out["counts"][1]["sessions"] == 0


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_failback_keeps_shared_filter_refcounts_exact(tmp_path, pkg):
    """Fault C.4: a session handed away drops its route refs once. 20
    sessions share two filters; after failover and failback the
    restored primary must hold one ref per session. The JAX package
    drops each handed session's refs twice (``detach_subscriber``'s
    unsubscribe, then ``_drop_local_session``'s own delete), so each
    filter ends with 1 ref for its 10 sessions: a later unsubscribe
    removes the route under the 9 still subscribed."""
    from test_torch_repl_pkgs import JAX, PORT

    P = JAX if pkg == "jax" else PORT
    cookie = f"grp-c4-{P.name}"
    names, nodes, trs, cls, ccfg = _mk_group(
        P, tmp_path, cookie, n=2, durable="first",
        cluster_kw=dict(anti_entropy_interval_s=0.5))
    try:
        for i in range(20):
            s = durable_session(P, nodes[0], f"sh{i:02d}", expiry=600.0)
            s.subscribe(f"shared/{i % 2}/+", P.SubOpts(qos=1))
        nodes[0].durability.on_batch()
        wait(lambda: synced(nodes[0]), msg="initial sync")
        _kill(nodes, trs, cls, 0)
        wait(lambda: nodes[1].replication.replicas["rg0"].promoted,
             msg="standby never promoted")
        assert nodes[1].router.route_refs("shared/0/+", "rg1") == 10
        want = P.durable_digest(nodes[1])
        node0b, tr0b, cl0b = _restart(P, tmp_path, names, 0, cookie,
                                      ccfg, 0, 400.0, trs[1].port)
        nodes[0], trs[0], cls[0] = node0b, tr0b, cl0b
        wait(lambda: not nodes[1].replication.replicas["rg0"].promoted,
             timeout=40, msg="standby never demoted")
        assert len(node0b.cm._detached) == 20
        refs = [node0b.router.route_refs(f"shared/{k}/+", "rg0")
                for k in (0, 1)]
        if pkg == "jax":
            assert refs == [1, 1]  # the reference's fault, pinned
            assert P.durable_digest(node0b) != want
        else:
            assert refs == [10, 10]
            wait(lambda: P.durable_digest(node0b) == want, timeout=20,
                 msg="failback digest never converged")
    finally:
        teardown(nodes, trs, cls)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_promoted_standby_hello_leaves_handed_sessions_alone(tmp_path,
                                                             pkg):
    """Fault C.5: in a symmetric group the promoted standby rg1 also
    ships its own journal to rg0. A hello rg1 sends while it is
    handing rg0's sessions back claims them, and rg0 drops every
    detached copy a hello claims (the stale-duplicate cleanup) — the
    sessions the hand-off just gave back; rg1's finalize then drops
    its own. Driven deterministically: rg1's hand-off frozen by
    ``repl.failback``, rg0 adopts a chunk, the join's registry push
    lands after it, then rg1 hellos. The JAX package loses the
    sessions; the port's rg0 keeps the sessions rg1 handed it."""
    from test_torch_repl_pkgs import JAX, PORT

    P = JAX if pkg == "jax" else PORT
    cookie = f"grp-c5-{P.name}"
    names, nodes, trs, cls, ccfg = _mk_group(
        P, tmp_path, cookie, n=2, durable="all",
        cluster_kw=dict(anti_entropy_interval_s=0.5))
    try:
        for i in range(8):
            s = durable_session(P, nodes[0], f"hb{i}", expiry=600.0)
            s.subscribe(f"hb/{i}/+", P.SubOpts(qos=1))
        nodes[0].durability.on_batch()
        wait(lambda: synced(nodes[0]), msg="initial sync")
        _kill(nodes, trs, cls, 0)
        r1 = nodes[1].replication
        wait(lambda: r1.replicas["rg0"].promoted,
             msg="standby never promoted")
        P.faults.set_master(True)
        P.faults.arm("repl.failback", times=0)
        node0b, tr0b, cl0b = _restart(P, tmp_path, names, 0, cookie,
                                      ccfg, 0, 400.0, trs[1].port)
        nodes[0], trs[0], cls[0] = node0b, tr0b, cl0b
        cids = sorted(r1.replicas["rg0"].adopted_all)
        handed = [(c, float(nodes[1].cm._detached[c][1]),
                   nodes[1].cm._detached[c][0].to_wire()) for c in cids]
        node0b.replication.handle_failback(
            "rg1", {"sessions": handed, "final": False})
        assert all(c in node0b.cm._detached for c in cids)
        cl0b.handle_rpc("registry_sync", "rg1", cids)
        wait(lambda: "rg0" in r1.peers and "rg0" in cls[1].members,
             msg="rg0 never rejoined")
        with r1._ship_lock:
            r1.peers["rg0"].need_hello = True
            assert r1._hello(r1.peers["rg0"])
        assert r1.replicas["rg0"].promoted
        kept = [c for c in cids if c in node0b.cm._detached]
        if pkg == "jax":
            assert kept == []  # the reference's fault, pinned
        else:
            assert kept == cids
    finally:
        teardown(nodes, trs, cls)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_primary_holds_its_hello_while_the_standby_hands_back(tmp_path,
                                                              pkg):
    """A restarted primary whose standby answered ``failback_pending``
    holds its next hello for ``FAILBACK_HELLO_HOLD_S`` (the final chunk
    re-arms it at once): a hello snapshots every session. The JAX
    package re-snapshots at every ship pass, i.e. at every journal
    flush — 2 s of flushes every 20 ms (the failover bench's resync
    wait) send tens of full snapshots while the hand-off runs."""
    from test_torch_repl_pkgs import JAX, PORT

    P = JAX if pkg == "jax" else PORT
    cookie = f"grp-hold-{P.name}"
    names, nodes, trs, cls, ccfg = _mk_group(
        P, tmp_path, cookie, n=2, durable="first",
        cluster_kw=dict(anti_entropy_interval_s=30.0))
    try:
        populate(P, nodes[0])
        wait(lambda: synced(nodes[0]), msg="initial sync")
        _kill(nodes, trs, cls, 0)
        wait(lambda: nodes[1].replication.replicas["rg0"].promoted,
             msg="standby never promoted")
        # the standby's hand-off stays frozen: every hello is answered
        # failback_pending
        P.faults.set_master(True)
        P.faults.arm("repl.failback", times=0)
        node0b, tr0b, cl0b = _restart(P, tmp_path, names, 0, cookie,
                                      ccfg, 0, 400.0, trs[1].port)
        nodes[0], trs[0], cls[0] = node0b, tr0b, cl0b
        r0 = node0b.replication
        hellos = []
        orig = r0._hello

        def counted(peer):
            hellos.append(time.monotonic())
            return orig(peer)

        r0._hello = counted
        wait(lambda: hellos, msg="the primary never said hello")
        t_end = time.monotonic() + 2.0
        while time.monotonic() < t_end:
            node0b.durability.on_batch()
            time.sleep(0.02)
        assert nodes[1].replication.replicas["rg0"].promoted
        if pkg == "jax":
            assert len(hellos) >= 10, len(hellos)
        else:
            assert len(hellos) <= 3, len(hellos)
    finally:
        teardown(nodes, trs, cls)


def _fb_abort(P, d):
    cookie = f"grp-fbf-{P.name}"
    names, nodes, trs, cls, ccfg = _mk_group(
        P, d, cookie, n=2, durable="all",
        cluster_kw=dict(anti_entropy_interval_s=0.5))
    try:
        populate(P, nodes[0])
        wait(lambda: synced(nodes[0]), msg="initial sync")
        _kill(nodes, trs, cls, 0)
        wait(lambda: nodes[1].replication.replicas["rg0"].promoted,
             msg="standby never promoted")
        P.faults.set_master(True)
        P.faults.arm("repl.failback", times=1)
        node0b, tr0b, cl0b = _restart(P, d, names, 0, cookie, ccfg, 0,
                                      400.0, trs[1].port)
        nodes[0], trs[0], cls[0] = node0b, tr0b, cl0b
        r1 = nodes[1].replication
        wait(lambda: r1.counters["repl.failback_errors"] >= 1,
             msg="failback drop never fired")
        assert r1.replicas["rg0"].promoted
        assert "dev1" in nodes[1].cm._detached
        # disarmed: the primary's hello keeps retrying and the next
        # hand-off lands
        wait(lambda: not r1.replicas["rg0"].promoted, timeout=40,
             msg="failback never retried after the drop")
        assert "dev1" in node0b.cm._detached
        return {"errors": r1.counters["repl.failback_errors"],
                "failbacks": r1.counters["repl.failbacks"]}
    finally:
        teardown(nodes, trs, cls)


def test_failback_aborts_on_drop_and_retries(tmp_path):
    """The repl.failback fault point: the hand-off call drops — the
    standby stays promoted and authoritative — then succeeds on the
    primary's next hello once disarmed."""
    both(_fb_abort, tmp_path)


def _fb_crash(P, d):
    cookie = f"grp-fbc-{P.name}"
    names, nodes, trs, cls, ccfg = _mk_group(
        P, d, cookie, n=2, durable="all",
        cluster_kw=dict(anti_entropy_interval_s=0.5))
    try:
        populate(P, nodes[0])
        wait(lambda: synced(nodes[0]), msg="initial sync")
        _kill(nodes, trs, cls, 0)
        wait(lambda: nodes[1].replication.replicas["rg0"].promoted,
             msg="standby never promoted")
        # freeze the standby's own hand-off so WE drive the window: the
        # primary applies, the standby never finalizes
        P.faults.set_master(True)
        P.faults.arm("repl.failback", times=0)
        node0b, tr0b, cl0b = _restart(P, d, names, 0, cookie, ccfg, 0,
                                      400.0, trs[1].port)
        nodes[0], trs[0], cls[0] = node0b, tr0b, cl0b
        # the join's registry push from the promoted rg1 (dev1 -> rg1)
        # lands before the apply below, whose client_up then places
        # dev1 on rg0: the registry the test's premise reads (a push
        # landing after the apply is fault C.5's window)
        wait(lambda: cl0b._registry.get("dev1") == "rg1",
             msg="the join's registry push never landed")
        rep = nodes[1].replication.replicas["rg0"]
        handed = []
        for cid in sorted(rep.adopted_all):
            ent = nodes[1].cm._detached.get(cid)
            if ent is not None:
                handed.append((cid, float(ent[1]), ent[0].to_wire()))
        assert handed
        reply = node0b.replication.handle_failback(
            "rg1", {"sessions": handed, "final": True,
                    "keep": [], "closed": []})
        assert reply["applied"] == len(handed)
        assert "dev1" in node0b.cm._detached
        # the standby crashes pre-finalize and recovers: its own
        # checkpoint resurrects the handed sessions a second time
        _kill(nodes, trs, cls, 1)
        clear_faults()
        node1b, tr1b, cl1b = _restart(P, d, names, 1, cookie, ccfg, 0,
                                      400.0, tr0b.port)
        nodes[1], trs[1], cls[1] = node1b, tr1b, cl1b
        assert "dev1" in node1b.cm._detached  # the stale duplicate
        # the primary's hello reclaims it (the registry places dev1 on
        # rg0 / nowhere): duplicate dropped, refs and all
        wait(lambda: "dev1" not in node1b.cm._detached, timeout=40,
             msg="stale duplicate never reclaimed")
        assert "dev1" in node0b.cm._detached
        wait_synced([node0b],
                    msg="pair never resynced after double recovery")
        wait(lambda: cls[0].plane_digests() == cls[1].plane_digests(),
             timeout=40, msg="planes never converged after double "
                             "recovery")
        return {"applied": reply["applied"],
                "digest": P.durable_digest(node0b),
                "counts": [counts(node0b), counts(node1b)]}
    finally:
        teardown(nodes, trs, cls)


def test_standby_crash_during_failback_double_recovery(tmp_path):
    """The standby dies between the primary's apply and its own
    finalize: both sides recover holding detached copies; the primary's
    next hello reclaims the standby's unregistered stale duplicates and
    the pair converges with the primary authoritative."""
    both(_fb_crash, tmp_path)


def _load(P, d):
    names, nodes, trs, cls, _ = _mk_group(P, d, f"grp-load-{P.name}",
                                          n=2, durable="all")
    try:
        populate(P, nodes[0])
        own = durable_session(P, nodes[1], "own1")
        own.subscribe("own/+", P.SubOpts(qos=0))
        nodes[1].durability.on_batch()
        wait(lambda: synced(nodes[0]), msg="initial sync")
        # pre-promotion: traffic matching the REPLICA's subs must not
        # be intercepted by the warm state
        nodes[1].broker.publish(P.Message(
            topic="fleet/3/state", payload=b"warm", qos=1))
        assert "dev1" not in nodes[1].cm._detached
        sent = 0
        for i in range(20):
            nodes[1].broker.publish(P.Message(
                topic=f"own/{i}", payload=b"x", qos=0))
            sent += 1
            if i == 9:
                _kill(nodes, trs, cls, 0)
        wait(lambda: nodes[1].replication.replicas["rg0"].promoted,
             msg="standby never promoted")
        for i in range(20, 30):
            nodes[1].broker.publish(P.Message(
                topic=f"own/{i}", payload=b"x", qos=0))
            sent += 1
        got = [m.topic for _pid, m in own.drain_outbox()]
        assert len(got) == sent, (len(got), sent)
        assert all(t.startswith("own/") for t in got)
        # the adopted session queued only ITS topics — and did queue
        # the post-promotion fleet publish
        nodes[1].broker.publish(P.Message(
            topic="fleet/4/state", payload=b"post", qos=1))
        s0 = nodes[1].cm._detached["dev1"][0]
        qt = [m.topic for _p, q in s0.mqueue.snapshot() for m in q]
        assert "fleet/4/state" in qt
        assert not any(t.startswith("own/") for t in qt)
        return {"got": got, "queued": qt}
    finally:
        teardown(nodes, trs, cls)


def test_promotion_under_load_no_crosstalk(tmp_path):
    """The standby serves its OWN live traffic while promoting: its
    live subscriber sees every one of its messages across the promotion
    (delivery parity), the warm replica never intercepts live traffic
    pre-promotion, and post-promotion the adopted sessions queue only
    their own topics (no cross-talk)."""
    both(_load, tmp_path)


# -- config / surfaces ------------------------------------------------------


GROUP_KW = [dict(standby="a", standbys=["b"]),
            dict(standbys=["a", "a"]),
            dict(standbys=["a"], ack_quorum=2),
            dict(ack_quorum=1), dict(ack_quorum=-1),
            dict(standbys=["a"], quorum_timeout_ms=0)]


def test_config_group_knobs_and_legacy_equivalence():
    from test_torch_repl_pkgs import JAX, PORT

    for P in (JAX, PORT):
        assert P.Dur(enabled=True, standby="a").standby_list == ("a",)
        assert P.Dur(enabled=True, standbys=["a"]).standby_list == ("a",)
        assert P.Dur(enabled=True).standby_list == ()
    for kw in GROUP_KW:
        with pytest.raises(ValueError) as je:
            JAX.Dur(enabled=True, **kw)
        with pytest.raises(ValueError) as pe:
            PORT.Dur(enabled=True, **kw)
        assert str(pe.value) == str(je.value), kw


def _surfaces(P, d):
    names, nodes, trs, cls, _ = _mk_group(
        P, d, f"grp-ctl-{P.name}", durable="first", ack_quorum=1)
    try:
        populate(P, nodes[0])
        wait(lambda: synced(nodes[0]), msg="initial sync")
        blk = nodes[0].durability.info()["replication"]
        assert blk["role"] == "primary"
        assert set(blk["standbys"]) == {"rg1", "rg2"}
        for ent in blk["standbys"].values():
            assert ent["state"] == "replicating"
            assert ent["acked_seq"] == blk["offered_seq"]
        assert blk["ack_quorum"] == 1
        assert blk["quorum_acked_seq"] >= blk["offered_seq"]
        assert blk["quorum_degraded"] is False
        rep = nodes[1].replication.info()["standby_for"]["rg0"]
        assert rep["peers"] == ["rg1", "rg2"]
        nodes[0].stats.tick()
        assert nodes[0].metrics.val("durability.repl.shipped") > 0
        return {k: blk[k] for k in ("role", "state", "standby",
                                    "ack_quorum", "offered_seq",
                                    "acked_seq", "quorum_acked_seq",
                                    "quorum_degraded", "lag_records")}
    finally:
        teardown(nodes, trs, cls)


def test_ctl_shows_group_topology_and_quorum(tmp_path):
    both(_surfaces, tmp_path)


# -- the replication soak ---------------------------------------------------


class _Soak:
    """Seeded kill-anything scheduler over a 3-node symmetric quorum
    group: every node is a durable primary fanning to the other two
    with ack_quorum=1. Each round drives quorum-acked traffic, disrupts
    (kill a node / cut a link / nothing), drives more traffic on the
    survivors, heals everything, and asserts that no quorum-acked
    record was lost and every plane converged."""

    def __init__(self, P, d, cookie, seed):
        self.P = P
        self.d = d
        self.cookie = cookie
        self.rng = random.Random(seed)
        self.names, self.nodes, self.trs, self.cls, self.ccfg = _mk_group(
            P, d, cookie, n=3, durable="all", ack_quorum=1,
            quorum_timeout_ms=500.0,
            cluster_kw=dict(anti_entropy_interval_s=0.5))
        self.alive = [True, True, True]
        self.oracle_sessions = {}   # cid -> home node name
        self.oracle_retained = {}   # topic -> payload
        self.seq = 0
        self.schedule = []

    def live_idx(self):
        return [i for i in range(3) if self.alive[i]]

    def traffic(self, i):
        """One quorum-acked burst on node i; recorded in the oracle
        only once the quorum watermark covers it."""
        node = self.nodes[i]
        self.seq += 1
        k = self.seq
        cid = f"c{k}"
        s = durable_session(self.P, node, cid)
        s.subscribe(f"t/{k}/+", self.P.SubOpts(qos=1))
        payload = b"v%d" % k
        node.broker.publish(self.P.Message(
            topic=f"r/{k}", payload=payload, qos=1,
            flags={"retain": True}))
        node.durability.on_batch()
        r = node.replication
        if wait_soft(lambda: r.quorum_acked_seq() >= r.offered_seq,
                     timeout=15):
            self.oracle_sessions[cid] = self.names[i]
            self.oracle_retained[f"r/{k}"] = payload

    def kill(self, i):
        node = self.nodes[i]
        held = [c for c in self.oracle_sessions
                if c in node.cm._detached or c in node.cm._channels]
        _kill(self.nodes, self.trs, self.cls, i)
        self.alive[i] = False
        survivors = self.live_idx()
        dead = self.names[i]
        wait(lambda: all(dead not in self.cls[j].members
                         for j in survivors),
             timeout=30, msg=f"{dead} never declared down")
        if held:
            def promoted():
                return [j for j in survivors
                        if self.nodes[j].replication.replicas.get(dead)
                        and self.nodes[j].replication.replicas[dead]
                        .promoted]

            wait(lambda: promoted(), timeout=30,
                 msg=f"no standby promoted for {dead}")
            assert len(promoted()) == 1, \
                f"dual promotion for {dead}: {promoted()}"

    def heal(self):
        heal_links(self.P, self.trs)
        for i in range(3):
            if not self.alive[i]:
                join = self.trs[self.live_idx()[0]].port
                node, tr, cl = _restart(self.P, self.d, self.names, i,
                                        self.cookie, self.ccfg, 1, 500.0,
                                        join)
                self.nodes[i], self.trs[i], self.cls[i] = node, tr, cl
                self.alive[i] = True
        wait(lambda: all(sorted(self.cls[i].members) == sorted(self.names)
                         for i in range(3)), timeout=60,
             msg="membership never re-merged")
        wait(lambda: all(not rep.promoted for i in range(3)
                         for rep in self.nodes[i].replication
                         .replicas.values()),
             timeout=60, msg="a promoted replica never failed back")
        wait_synced(self.nodes, timeout=90)
        wait(lambda: self.cls[0].plane_digests()
             == self.cls[1].plane_digests()
             == self.cls[2].plane_digests(),
             timeout=60, msg="plane digests never converged")

    def verify(self):
        """After every heal: no quorum-acked record lost — exactly ONE
        live holder of every quorum-acked session, the converged
        registry pointing at it; every retained entry on every
        member."""
        for cid in self.oracle_sessions:
            holders = [self.names[i] for i in range(3)
                       if cid in self.nodes[i].cm._detached
                       or cid in self.nodes[i].cm._channels]
            assert holders, f"quorum-acked session {cid} lost"
            assert len(holders) == 1, \
                f"session {cid} double-owned by {holders}"
            owner = self.cls[0]._registry.get(cid)
            if owner is not None:
                assert owner == holders[0], \
                    f"registry places {cid} on {owner}, held by " \
                    f"{holders[0]}"
        for i in range(3):
            ret = self.nodes[i].modules._loaded["retainer"]
            for topic, payload in self.oracle_retained.items():
                m = ret._store.get(topic)
                assert m is not None, \
                    f"retained {topic} lost on {self.names[i]}"
                assert bytes(m.payload) == payload

    def round(self, k):
        live = self.live_idx()
        self.traffic(self.rng.choice(live))
        # rounds 0/1 are scripted: a full failover→failback→
        # re-failover cycle on rg0; after that, kill anything
        if k in (0, 1):
            action = ("kill", 0)
        else:
            action = self.rng.choice(
                [("kill", 0), ("kill", 1), ("kill", 2),
                 ("cut", (0, 1)), ("cut", (0, 2)), ("cut", (1, 2)),
                 ("none", None)])
        self.schedule.append(action)
        if action[0] == "kill":
            self.kill(action[1])
        elif action[0] == "cut":
            a, b = action[1]
            cut(self.P, self.trs, self.names, a, b)
            time.sleep(1.0)  # let the detectors react
        for _ in range(2):
            self.traffic(self.rng.choice(self.live_idx()))
        self.heal()
        self.verify()

    def run(self, rounds):
        try:
            for k in range(rounds):
                self.round(k)
        finally:
            clear_faults()
            teardown(self.nodes, self.trs, self.cls)
        return {"rounds": rounds, "schedule": self.schedule,
                "sessions": len(self.oracle_sessions),
                "retained": len(self.oracle_retained)}


def _soak(P, d, seed, rounds):
    out = _Soak(P, d, f"soak-smoke-{seed}-{P.name}", seed).run(rounds)
    assert out["sessions"] >= rounds  # the oracle actually grew
    return {"rounds": out["rounds"], "schedule": out["schedule"]}


def test_chaos_soak_smoke(tmp_path):
    """The soak smoke: fixed seed, bounded rounds — the first two rounds
    alone cover a full failover→failback→re-failover cycle; the rest
    kill/cut at random, the same schedule in both packages."""
    seed = int(os.environ.get("SOAK_SEED", "1337"))
    rounds = int(os.environ.get("SOAK_ROUNDS", "4"))
    both(_soak, tmp_path, seed, rounds)
