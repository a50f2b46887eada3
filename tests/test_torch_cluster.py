"""The port's cluster (``emqx_tpu_torch.cluster``) against the JAX
package's, over the in-process ``LocalTransport``.

Every case of ``tests/test_cluster.py`` runs the same operations on a
JAX cluster and on a port cluster
(``device="cpu"``): each keeps the original test's assertions, and the
two runs must give the same deliveries (filter, topic, payload, QoS per
subscriber), the same publish results, the same ``messages.forward``
on every node and the same ``plane_digests()`` — across the two
packages, not only across the members. A parametrised case adds a
remote-only filter on the device path: the publishing node's walk (B1's
plain twin on the CPU) matches it, it has no fan-out row, and it
forwards. The ban plane's cases compare the rules with only whether a
ban is permanent of their expiry (the two runs are moments apart), and
add an anti-entropy repair of a diverged ``bans`` plane.
"""

import time

import pytest

from emqx_tpu.cluster import Cluster as JCluster
from emqx_tpu.cluster import LocalTransport as JLocal
from emqx_tpu.modules.retainer import RetainerModule as JRetainer
from emqx_tpu.node import Node as JNode
from emqx_tpu.router import MatcherConfig as JMatcher
from emqx_tpu.types import Message as JMessage
from emqx_tpu.types import SubOpts as JSubOpts
from emqx_tpu_torch.cluster import Cluster as PCluster
from emqx_tpu_torch.cluster import LocalTransport as PLocal
from emqx_tpu_torch.modules.retainer import RetainerModule as PRetainer
from emqx_tpu_torch.node import Node as PNode
from emqx_tpu_torch.router import MatcherConfig as PMatcher
from emqx_tpu_torch.types import Message as PMessage
from emqx_tpu_torch.types import SubOpts as PSubOpts

#: a current, fixed timestamp base: the retained plane's digest carries
#: message timestamps, so both packages' messages must carry the same
#: ones — recent, or the retainer sweeps their tombstones
TS = float(int(time.time()))


class _Pkg:
    """One package's cluster vocabulary, and the messages it made (each
    with the next fixed timestamp)."""

    def __init__(self, node, cluster, transport, message, subopts,
                 retainer, matcher):
        self._node = node
        self.Cluster = cluster
        self.LocalTransport = transport
        self._message = message
        self.SubOpts = subopts
        self.Retainer = retainer
        self.Matcher = matcher
        self._n = 0

    def Node(self, name, **kw):
        return self._node(name, **kw)

    def msg(self, topic, payload=b"", **kw):
        self._n += 1
        kw.setdefault("timestamp", TS + self._n)
        return self._message(topic=topic, payload=payload, **kw)


def _jax():
    return _Pkg(lambda name, **kw: JNode(name=name, boot_listeners=False,
                                         **kw),
                JCluster, JLocal, JMessage, JSubOpts, JRetainer, JMatcher)


def _port():
    return _Pkg(lambda name, **kw: PNode(name=name, device="cpu", **kw),
                PCluster, PLocal, PMessage, PSubOpts, PRetainer, PMatcher)


class Q:
    def __init__(self, cid="q"):
        self.client_id = cid
        self.inbox = []

    def deliver(self, t, m):
        self.inbox.append((t, m))


def _mk_cluster(P, n=2, **kw):
    transport = P.LocalTransport()
    nodes = [P.Node(f"n{i}", **kw) for i in range(n)]
    clusters = [P.Cluster(node, transport) for node in nodes]
    for c in clusters[1:]:
        clusters[0].join(c)
        for other in clusters[1:]:
            if other is not c:
                c.join(other)
    return nodes, clusters


def _inbox(q):
    return [(t, m.topic, bytes(m.payload), m.qos) for t, m in q.inbox]


def _obs(nodes, clusters, subs, results=()):
    """What both packages must agree on."""
    return {
        "inboxes": {k: _inbox(q) for k, q in subs.items()},
        "results": list(results),
        "forward": [n.metrics.val("messages.forward") for n in nodes],
        "digests": [c.plane_digests() for c in clusters],
    }


def _both(scenario, *args):
    """Run ``scenario`` on a JAX cluster and a port cluster; their
    observations must be equal."""
    want = scenario(_jax(), *args)
    got = scenario(_port(), *args)
    assert got == want
    return got


# -- the cases of tests/test_cluster.py ----------------------------------


def _route_replication(P):
    (n0, n1), cls = _mk_cluster(P, 2)
    s = Q()
    n0.broker.subscribe(s, "rep/+")
    assert n0.router.has_route("rep/+")
    assert n1.router.has_route("rep/+")
    [filters] = n1.router.match_filters(["rep/x"])
    assert [r.dest for f in filters
            for r in n1.router.lookup_routes(f)] == ["n0"]
    mid = [c.plane_digests() for c in cls]
    n0.broker.unsubscribe(s, "rep/+")
    assert not n1.router.has_route("rep/+")
    return _obs((n0, n1), cls, {"s": s}, [mid])


def test_route_replication():
    _both(_route_replication)


def _cross_node_forwarding(P):
    (n0, n1), cls = _mk_cluster(P, 2)
    s0, s1 = Q("on0"), Q("on1")
    n0.broker.subscribe(s0, "t/#")
    n1.broker.subscribe(s1, "t/#")
    delivered = n1.broker.publish(P.msg("t/1", b"x"))
    assert delivered == 1  # local count (remote async)
    assert len(s1.inbox) == 1
    assert len(s0.inbox) == 1
    assert s0.inbox[0][1].payload == b"x"
    return _obs((n0, n1), cls, {"s0": s0, "s1": s1}, [delivered])


def test_cross_node_forwarding():
    _both(_cross_node_forwarding)


def _forward_count_is_per_filter_node(P):
    (n0, n1), cls = _mk_cluster(P, 2)
    s0 = Q()
    n0.broker.subscribe(s0, "a/#")
    n0.broker.subscribe(s0, "a/b")
    r = n1.broker.publish(P.msg("a/b"))
    assert len(s0.inbox) == 2
    assert n1.metrics.val("messages.forward") == 2
    return _obs((n0, n1), cls, {"s0": s0}, [r])


def test_forward_count_is_per_filter_node():
    _both(_forward_count_is_per_filter_node)


def _shared_sub_across_nodes(P):
    (n0, n1), cls = _mk_cluster(P, 2)
    s0 = Q("w0")
    n0.broker.subscribe(s0, "$share/g/jobs")
    r = n1.broker.publish(P.msg("jobs", b"j"))
    assert len(s0.inbox) == 1
    return _obs((n0, n1), cls, {"s0": s0}, [r])


def test_shared_sub_across_nodes():
    _both(_shared_sub_across_nodes)


def _shared_group_spanning_nodes_delivers_once(P):
    (n0, n1), cls = _mk_cluster(P, 2)
    s0, s1 = Q("w0"), Q("w1")
    n0.broker.subscribe(s0, "$share/g/jobs")
    n1.broker.subscribe(s1, "$share/g/jobs")
    res = [n1.broker.publish(P.msg("jobs")) for _ in range(6)]
    assert len(s0.inbox) + len(s1.inbox) == 6
    assert len(s0.inbox) == 3 and len(s1.inbox) == 3
    return _obs((n0, n1), cls, {"s0": s0, "s1": s1}, res)


def test_shared_group_spanning_nodes_delivers_once():
    _both(_shared_group_spanning_nodes_delivers_once)


def _join_is_transitive(P):
    transport = P.LocalTransport()
    a, b, c = (P.Node(x) for x in "abc")
    ca, cb, cc = (P.Cluster(n, transport) for n in (a, b, c))
    cb.join(cc)
    s = Q()
    c.broker.subscribe(s, "t/2")
    ca.join(cb)
    assert sorted(cc.members) == ["a", "b", "c"]
    assert sorted(ca.members) == ["a", "b", "c"]
    assert a.router.has_route("t/2")
    r = a.broker.publish(P.msg("t/2"))
    assert len(s.inbox) == 1
    s2 = Q()
    c.broker.subscribe(s2, "t/3")
    assert a.router.has_route("t/3")
    return _obs((a, b, c), (ca, cb, cc), {"s": s, "s2": s2}, [r])


def test_join_is_transitive():
    _both(_join_is_transitive)


def _leave_purges_both_directions(P):
    (n0, n1), (c0, c1) = _mk_cluster(P, 2)
    s0, s1 = Q(), Q()
    n0.broker.subscribe(s0, "mine/#")
    n1.broker.subscribe(s1, "theirs/#")
    c0.leave()
    assert not n1.router.has_route("mine/#")
    assert not n0.router.has_route("theirs/#")
    r = n0.broker.publish(P.msg("theirs/x"))
    assert s1.inbox == []
    return _obs((n0, n1), (c0, c1), {"s0": s0, "s1": s1}, [r])


def test_leave_purges_both_directions():
    _both(_leave_purges_both_directions)


def _refcounted_local_subs_replicate_once(P):
    (n0, n1), cls = _mk_cluster(P, 2)
    s1, s2 = Q("a"), Q("b")
    n0.broker.subscribe(s1, "rc/t")
    n0.broker.subscribe(s2, "rc/t")
    assert n1.router.has_route("rc/t")
    n0.broker.unsubscribe(s1, "rc/t")
    assert n1.router.has_route("rc/t")
    mid = [c.plane_digests() for c in cls]
    n0.broker.unsubscribe(s2, "rc/t")
    assert not n1.router.has_route("rc/t")
    return _obs((n0, n1), cls, {}, [mid])


def test_refcounted_local_subs_replicate_once():
    _both(_refcounted_local_subs_replicate_once)


def _tracer_isolated_between_nodes(P):
    (n0, n1), cls = _mk_cluster(P, 2)
    sink = n0.tracer.start_trace("topic", "x/#")
    r1 = n1.broker.publish(P.msg("x/1"))
    assert sink == []
    r0 = n0.broker.publish(P.msg("x/1"))
    assert len(sink) == 1
    n0.tracer.stop_trace("topic", "x/#")
    return _obs((n0, n1), cls, {}, [r1, r0, len(sink)])


def test_tracer_isolated_between_nodes():
    _both(_tracer_isolated_between_nodes)


def _nodedown_cleanup(P):
    (n0, n1), (c0, c1) = _mk_cluster(P, 2)
    s0 = Q()
    n0.broker.subscribe(s0, "gone/+")
    assert n1.router.has_route("gone/+")
    c1.handle_nodedown("n0")
    assert not n1.router.has_route("gone/+")
    r = n1.broker.publish(P.msg("gone/x"))
    assert r == 0
    assert "n0" not in c1.members
    return _obs((n0, n1), (c0, c1), {"s0": s0}, [r])


def test_nodedown_cleanup():
    _both(_nodedown_cleanup)


def _leave_broadcasts_nodedown(P):
    (n0, n1), (c0, c1) = _mk_cluster(P, 2)
    s0 = Q()
    n0.broker.subscribe(s0, "bye/#")
    c0.leave()
    assert not n1.router.has_route("bye/#")
    return _obs((n0, n1), (c0, c1), {"s0": s0})


def test_leave_broadcasts_nodedown():
    _both(_leave_broadcasts_nodedown)


def _three_node_replication(P):
    (n0, n1, n2), cls = _mk_cluster(P, 3)
    s = Q()
    n2.broker.subscribe(s, "three/+")
    assert n0.router.has_route("three/+")
    assert n1.router.has_route("three/+")
    r = n0.broker.publish(P.msg("three/x"))
    assert len(s.inbox) == 1
    return _obs((n0, n1, n2), cls, {"s": s}, [r])


def test_three_node_replication():
    _both(_three_node_replication)


def _join_syncs_existing_routes(P):
    transport = P.LocalTransport()
    a, b = P.Node("a"), P.Node("b")
    ca, cb = P.Cluster(a, transport), P.Cluster(b, transport)
    s = Q()
    a.broker.subscribe(s, "pre/existing")
    ca.join(cb)
    assert b.router.has_route("pre/existing")
    r = b.broker.publish(P.msg("pre/existing"))
    assert len(s.inbox) == 1
    return _obs((a, b), (ca, cb), {"s": s}, [r])


def test_join_syncs_existing_routes():
    _both(_join_syncs_existing_routes)


# -- clientid registry + cross-node takeover --------------------------------


def _registry_replicates_client_location(P):
    (n0, n1), clusters = _mk_cluster(P, 2)
    sess, present = n0.cm.open_session("c1", True, channel=object())
    assert not present
    assert clusters[0].locate_client("c1") == "n0"
    assert clusters[1].locate_client("c1") == "n0"
    return _obs((n0, n1), clusters, {})


def test_registry_replicates_client_location():
    _both(_registry_replicates_client_location)


def _cross_node_takeover_moves_session_and_subs(P):
    (n0, n1), clusters = _mk_cluster(P, 2)
    chan0 = object()
    sess, _ = n0.cm.open_session("mv", True, channel=chan0)
    sess.subscribe("mv/t", P.SubOpts(qos=1))
    n0.cm.connection_closed("mv", chan0, sess, 300)
    r = n0.broker.publish(P.msg("mv/t", b"away", qos=1))
    sess2, present = n1.cm.open_session("mv", False, channel=object())
    assert present and sess2 is sess
    assert "mv/t" in sess2.subscriptions
    assert clusters[0].locate_client("mv") == "n1"
    assert clusters[1].locate_client("mv") == "n1"
    assert sess2 not in n0.broker.subscribers("mv/t")
    assert sess2 in n1.broker.subscribers("mv/t")
    sess2.replay()
    payloads = [m.payload for pid, m in sess2.drain_outbox()
                if hasattr(m, "payload")]
    assert b"away" in payloads
    # the routes moved with the session, on both nodes
    routes = [sorted(map(repr, (x.dest for x in
                                n.router.lookup_routes("mv/t"))))
              for n in (n0, n1)]
    assert routes == [["'n1'"], ["'n1'"]]
    return _obs((n0, n1), clusters, {}, [r, sorted(payloads), routes])


def test_cross_node_takeover_moves_session_and_subs():
    _both(_cross_node_takeover_moves_session_and_subs)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_takeover_leaves_a_shared_filter_route_in_place(pkg):
    """Fault C.4 on the takeover path: two detached sessions on n0 hold
    ``sh/+``; n1 takes one over. n0 must keep one route ref for the
    other, which still gets n0's publishes. The JAX package drops the
    moved session's ref twice (``_local_takeover``'s own delete, then
    ``detach_subscriber``'s unsubscribe): n0's route goes, and the
    session left there misses the message."""
    P = _jax() if pkg == "jax" else _port()
    (n0, n1), clusters = _mk_cluster(P, 2)
    stay = None
    for cid in ("mover", "stayer"):
        ch = object()
        sess, _ = n0.cm.open_session(cid, True, channel=ch)
        sess.subscribe("sh/+", P.SubOpts(qos=1))
        n0.cm.connection_closed(cid, ch, sess, 300)
        stay = sess
    assert n0.router.route_refs("sh/+", "n0") == 2
    moved, present = n1.cm.open_session("mover", False, channel=object())
    assert present and "sh/+" in moved.subscriptions
    n0.broker.publish(P.msg("sh/x", b"after", qos=1))
    stay.replay()
    got = [m.payload for _pid, m in stay.drain_outbox()
           if hasattr(m, "payload")]
    if pkg == "jax":
        # the reference's fault, pinned
        assert n0.router.route_refs("sh/+", "n0") == 0
        assert got == []
    else:
        assert n0.router.route_refs("sh/+", "n0") == 1
        assert got == [b"after"]


def _cross_node_clean_start_discards_remote_session(P):
    (n0, n1), clusters = _mk_cluster(P, 2)
    chan0 = object()
    sess, _ = n0.cm.open_session("cs", True, channel=chan0)
    sess.subscribe("cs/t", None)
    n0.cm.connection_closed("cs", chan0, sess, 300)
    assert n0.cm.session_count() == 1
    sess2, present = n1.cm.open_session("cs", True, channel=object())
    assert not present and sess2 is not sess
    assert "cs" not in n0.cm._detached
    assert clusters[1].locate_client("cs") == "n1"
    return _obs((n0, n1), clusters, {})


def test_cross_node_clean_start_discards_remote_session():
    _both(_cross_node_clean_start_discards_remote_session)


def _nodedown_purges_registry(P):
    (n0, n1), clusters = _mk_cluster(P, 2)
    n0.cm.open_session("gone", True, channel=object())
    assert clusters[1].locate_client("gone") == "n0"
    clusters[1].handle_nodedown("n0")
    assert clusters[1].locate_client("gone") is None
    return _obs((n0, n1), clusters, {})


def test_nodedown_purges_registry():
    _both(_nodedown_purges_registry)


def _shared_group_weighted_by_member_count(P):
    (n0, n1), cls = _mk_cluster(P, 2)
    heavy = [Q(f"h{i}") for i in range(3)]
    for s in heavy:
        n0.broker.subscribe(s, "$share/g/work")
    light = Q("l0")
    n1.broker.subscribe(light, "$share/g/work")
    res = [n1.broker.publish(P.msg("work")) for _ in range(40)]
    n0_total = sum(len(s.inbox) for s in heavy)
    assert n0_total + len(light.inbox) == 40
    assert n0_total == 30, (n0_total, len(light.inbox))
    assert all(len(s.inbox) == 10 for s in heavy)
    subs = {f"h{i}": s for i, s in enumerate(heavy)}
    subs["l0"] = light
    return _obs((n0, n1), cls, subs, res)


def test_shared_group_weighted_by_member_count():
    _both(_shared_group_weighted_by_member_count)


def _shared_weight_updates_on_unsubscribe(P):
    (n0, n1), cls = _mk_cluster(P, 2)
    a, b = Q("a"), Q("b")
    n0.broker.subscribe(a, "$share/g/w2")
    n0.broker.subscribe(b, "$share/g/w2")
    c = Q("c")
    n1.broker.subscribe(c, "$share/g/w2")
    n0.broker.unsubscribe(b, "$share/g/w2")
    res = [n1.broker.publish(P.msg("w2")) for _ in range(10)]
    assert len(a.inbox) == 5 and len(c.inbox) == 5, \
        (len(a.inbox), len(b.inbox), len(c.inbox))
    return _obs((n0, n1), cls, {"a": a, "b": b, "c": c}, res)


def test_shared_weight_updates_on_unsubscribe():
    _both(_shared_weight_updates_on_unsubscribe)


def _partition_heal_rejoin_resyncs_routes(P):
    (n0, n1), (c0, c1) = _mk_cluster(P, 2)
    transport = c0.transport
    s0, s1 = Q(), Q()
    n0.broker.subscribe(s0, "part/a")
    n1.broker.subscribe(s1, "part/b")
    transport.unregister("n0")
    transport.unregister("n1")
    s0b, s1b = Q(), Q()
    n0.broker.subscribe(s0b, "part/during0")
    n1.broker.subscribe(s1b, "part/during1")
    assert not n1.router.has_route("part/a")
    assert not n0.router.has_route("part/b")
    assert not n1.router.has_route("part/during0")
    assert not n0.router.has_route("part/during1")
    split = [c.plane_digests() for c in (c0, c1)]
    transport.register("n0", c0)
    transport.register("n1", c1)
    c1.join(c0)
    for router, flt in [(n1.router, "part/a"),
                        (n1.router, "part/during0"),
                        (n0.router, "part/b"),
                        (n0.router, "part/during1")]:
        assert router.has_route(flt), flt
    res = [n1.broker.publish(P.msg("part/a")),
           n1.broker.publish(P.msg("part/during0")),
           n0.broker.publish(P.msg("part/b")),
           n0.broker.publish(P.msg("part/during1"))]
    for q in (s0, s0b, s1, s1b):
        assert len(q.inbox) == 1
    assert c0.plane_digests() == c1.plane_digests()
    return _obs((n0, n1), (c0, c1),
                {"s0": s0, "s0b": s0b, "s1": s1, "s1b": s1b}, [res, split])


def test_partition_heal_rejoin_resyncs_routes():
    _both(_partition_heal_rejoin_resyncs_routes)


def _nodedown_mid_forward_no_crash(P):
    (n0, n1), (c0, c1) = _mk_cluster(P, 2)
    s1 = Q()
    n1.broker.subscribe(s1, "dying/+")
    c0.transport.unregister("n1")
    n = n0.broker.publish(P.msg("dying/x"))
    assert n == 0
    assert s1.inbox == []
    return _obs((n0, n1), (c0, c1), {"s1": s1}, [n])


def test_nodedown_mid_forward_no_crash():
    _both(_nodedown_mid_forward_no_crash)


def _retained_store_replicates_cluster_wide(P):
    (n0, n1), (c0, c1) = _mk_cluster(P, 2)
    n0.modules.load(P.Retainer)
    r1 = n1.modules.load(P.Retainer)
    n0.broker.publish(P.msg("ret/x", b"v", flags={"retain": True}))
    assert r1._store["ret/x"].payload == b"v"
    n0.broker.publish(P.msg("ret/x", b"", flags={"retain": True}))
    assert "ret/x" not in r1._store
    n0.broker.publish(P.msg("ret/y", b"w", flags={"retain": True}))
    n2 = P.Node("n2")
    c2 = P.Cluster(n2, c0.transport)
    r2 = n2.modules.load(P.Retainer)
    c2.join(c0)
    assert r2._store["ret/y"].payload == b"w"
    for c in (c1, c2):
        assert c.plane_digests() == c0.plane_digests()
    return _obs((n0, n1, n2), (c0, c1, c2), {},
                [sorted(r2._store), sorted(r2.tombstones())])


def test_retained_store_replicates_cluster_wide():
    _both(_retained_store_replicates_cluster_wide)


# -- a remote-only filter on the device path --------------------------------


def _remote_only_filter(P, key):
    """``key`` is subscribed on n0 only; n1 publishes on its device
    path (``device_min_filters=1``; the walk's plain twin on the CPU):
    the walk matches the filter, the filter has no fan-out row on n1,
    and n1 forwards one message per (n0, filter)."""
    (n0, n1), cls = _mk_cluster(P, 2,
                                matcher=P.Matcher(device_min_filters=1))
    s0, s1 = Q("r0"), Q("r1")
    n0.broker.subscribe(s0, key)
    n1.broker.subscribe(s1, "loc/+")  # n1's own, local filter
    flt = key.split("/", 2)[2] if key.startswith("$share/") else key
    b = n1.broker
    assert b.router.use_device_now()
    pb = b.publish_begin([P.msg("ro/x/y" if key.endswith("#")
                                else "ro/x", b"p", qos=1),
                          P.msg("loc/z", b"q")])
    b.publish_fetch(pb)
    fid = b.router.filter_id(flt)
    assert fid is not None
    urow = pb.inv[0]
    matched = list(pb.ids_packed[pb.m_ptr[urow]:pb.m_ptr[urow + 1]])
    assert fid in matched, (fid, matched)
    assert not pb.ovf[urow]
    # no fan-out row: n1 holds no subscriber of it
    assert b.subscribers(flt) == [] and not b.helper.members(flt)
    res = b.publish_finish(pb)
    assert len(s0.inbox) == 1 and len(s1.inbox) == 1
    fwd = n1.metrics.val("messages.forward")
    assert fwd == (0 if key.startswith("$share/") else 1)
    return _obs((n0, n1), cls, {"s0": s0, "s1": s1}, [res])


@pytest.mark.parametrize("key", ["ro/+", "ro/#", "ro/x", "$share/g/ro/x"])
def test_remote_only_filter_is_walked_and_forwarded(key):
    _both(_remote_only_filter, key)


def test_port_cluster_replication_agent_and_ban_plane_equal_jax():
    """Every cluster member carries the replication manager (no
    standby configured: no shipper), whose operations answer as the
    JAX package's do; the ban plane's ``ban_add``/``ban_del`` receives
    and ``bans`` digest equal a JAX node's holding the same bans (a
    receive installs without re-broadcasting)."""
    from emqx_tpu_torch.replication import ReplicationManager

    P, J = _port(), _jax()
    (pn0, pn1), (pc0, _) = _mk_cluster(P, 2)
    (jn0, jn1), (jc0, _) = _mk_cluster(J, 2)
    assert isinstance(pc0.replication, ReplicationManager)
    assert pn0.replication is pc0.replication
    assert pc0.replication._thread is None
    for c in (pc0, jc0):
        # a stray ship to a node with no replica answers resync
        assert c.handle_rpc("repl_ship", "ghost", 1, []) == \
            {"resync": True, "applied": 0}
        assert c.handle_rpc("repl_replica_info", "ghost") == \
            {"exists": False}
        assert c.handle_rpc("repl_bye", "ghost", True) is None
    assert pc0.handle_rpc("drain_digest", ["nobody"]) == \
        jc0.handle_rpc("drain_digest", ["nobody"])
    until = time.time() + 600.0
    for c, peer in ((pc0, pn1), (jc0, jn1)):
        c.handle_rpc("ban_add", "clientid", "evil", "op", "r", None, True)
        c.handle_rpc("ban_add", "username", "u", "op", "", until, False)
        c.handle_rpc("ban_add", "peerhost", "10.1.1.1", "op", "", None,
                     True)
        c.handle_rpc("ban_del", "peerhost", "10.1.1.1")
        # a receive applies locally and never re-broadcasts
        assert peer.broker.banned.info() == []
    assert pc0._plane_entries("bans", None) == \
        jc0._plane_entries("bans", None)
    assert len(pc0._plane_entries("bans", None)) == 2
    assert pc0.plane_digests()["bans"] == jc0.plane_digests()["bans"]
    assert pn0.banned.check(clientid="evil") and \
        not pn0.banned.check(peerhost="10.1.1.1")
    assert pc0.handle_rpc("overload_level") == 0


# -- the ban plane: the cases of tests/test_cluster.py:290-368 --------------

def _rules(banned):
    """The table's rules, comparable across packages: of ``until`` only
    whether the ban is permanent."""
    return sorted((r.who, r.by, r.reason, r.until is None)
                  for r in banned.info())


def _ban_replication(P):
    (n0, n1), (c0, c1) = _mk_cluster(P, 2)
    n0.broker.banned.create("clientid", "evil", duration=600)
    out = [n1.broker.banned.check(clientid="evil")]
    n1.broker.banned.delete("clientid", "evil")
    out.append(n0.broker.banned.check(clientid="evil"))
    # join sync: a third node learns existing bans
    n0.broker.banned.create("peerhost", "10.0.0.9")
    n2 = P.Node("n2")
    c2 = P.Cluster(n2, c0.transport)
    c0.join(c2)
    out.append(n2.broker.banned.check(peerhost="10.0.0.9"))
    assert out == [True, False, True]
    digests = [c.plane_digests()["bans"] for c in (c0, c1, c2)]
    assert len(set(digests)) == 1
    return out, digests, [_rules(n.broker.banned) for n in (n0, n1, n2)]


def test_ban_replication_cluster_wide():
    """A ban created on one node rejects connections on every node; the
    delete lifts it everywhere; a new joiner receives the table."""
    _both(_ban_replication)


def _ban_merge(P, Banned):
    b = Banned()
    b.create("clientid", "x")          # permanent
    b.apply("clientid", "x", "peer", "", time.time() + 5)  # shorter
    out = [b.look_up("clientid", "x").until is None]
    b.apply("clientid", "x", "peer", "", time.time() - 5)  # expired
    out.append(b.look_up("clientid", "x").until is None)
    b2 = Banned()
    b2.create("clientid", "y", duration=5)
    b2.apply("clientid", "y", "peer", "", None)  # longer (forever)
    out.append(b2.look_up("clientid", "y").until is None)
    # a join-sync install of an absent rule, and an expired one skipped
    b2.apply("clientid", "z", "peer", "r", time.time() + 60)
    b2.apply("clientid", "gone", "peer", "", time.time() - 1)
    out += [_rules(b), _rules(b2)]
    assert out[:3] == [True, True, True]
    return out


def test_ban_merge_longer_ban_wins():
    """Join-sync never lets a stale short ban clobber a permanent one
    (apply() merges longest-wins; expired rules never install)."""
    from emqx_tpu.banned import Banned as JBanned
    from emqx_tpu_torch.banned import Banned as PBanned

    assert _ban_merge(_port(), PBanned) == _ban_merge(_jax(), JBanned)


def _live_ban_overwrite(P):
    (n0, n1), (c0, c1) = _mk_cluster(P, 2)
    n0.broker.banned.create("clientid", "z")            # permanent
    first = n1.broker.banned.look_up("clientid", "z").until is None
    n1.broker.banned.create("clientid", "z", duration=60)  # shorten
    r0 = n0.broker.banned.look_up("clientid", "z")
    r1 = n1.broker.banned.look_up("clientid", "z")
    assert first
    assert r0.until is not None and r1.until is not None
    assert abs(r0.until - r1.until) < 1.0  # convergent
    assert c0.plane_digests()["bans"] == c1.plane_digests()["bans"]
    return first, _rules(n0.broker.banned), _rules(n1.broker.banned)


def test_live_ban_create_overwrites_cluster_wide():
    """A live create replaces the rule everywhere (an operator
    shortening a permanent ban wins), while join-sync merges."""
    _both(_live_ban_overwrite)


def _flapping_no_downgrade(P, Flapping, FlappingConfig):
    """In a cluster: a permanent operator ban on n1 replicates to n0,
    where a flapping client's short auto-ban must not replace it,
    locally or on n1."""
    (n0, n1), (c0, c1) = _mk_cluster(P, 2)
    n1.broker.banned.create("clientid", "vip-banned")  # operator
    f = Flapping(banned=n0.broker.banned,
                 config=FlappingConfig(max_count=2, window=60, ban_time=5))
    for _ in range(3):
        f.disconnected("vip-banned", "1.2.3.4")
    f.disconnected("other", "1.2.3.4")
    f.disconnected("other", "1.2.3.4")  # auto-banned, replicated
    out = [_rules(n.broker.banned) for n in (n0, n1)]
    for n in (n0, n1):
        rule = n.broker.banned.look_up("clientid", "vip-banned")
        assert rule is not None and rule.until is None
        assert n.broker.banned.look_up("clientid", "other").by == \
            "flapping"
    return out


def test_flapping_ban_never_downgrades_operator_ban():
    from emqx_tpu.flapping import Flapping as JF
    from emqx_tpu.flapping import FlappingConfig as JFC
    from emqx_tpu_torch.flapping import Flapping as PF
    from emqx_tpu_torch.flapping import FlappingConfig as PFC

    assert _flapping_no_downgrade(_port(), PF, PFC) == \
        _flapping_no_downgrade(_jax(), JF, JFC)


def test_ban_apply_expired_overwrite_deletes():
    """An overwrite that expired in transit DELETES (the originator's
    table has expired it too), not a no-op; a merge of it is one."""
    from emqx_tpu.banned import Banned as JBanned
    from emqx_tpu_torch.banned import Banned as PBanned

    out = []
    for Banned in (JBanned, PBanned):
        b = Banned()
        b.create("clientid", "q")  # permanent
        b.create("clientid", "keep")
        b.apply("clientid", "q", "op", "", time.time() - 1, overwrite=True)
        b.apply("clientid", "keep", "op", "", time.time() - 1)
        assert b.look_up("clientid", "q") is None
        out.append(_rules(b))
    assert out[0] == out[1] == [(("clientid", "keep"), "admin", "", True)]


def _ban_anti_entropy(P):
    """A diverged ``bans`` plane (installs that skipped the broadcast,
    as a lost cast leaves it) is repaired by one anti-entropy sync,
    both ways, longest-ban-wins; a second sync finds nothing."""
    (n0, n1), (c0, c1) = _mk_cluster(P, 2)
    c0._orig_ban_create("clientid", "only-n0")          # permanent
    c1._orig_ban_create("username", "only-n1")
    c1._orig_ban_create("clientid", "only-n0", duration=30)  # shorter
    before = [c.plane_digests()["bans"] for c in (c0, c1)]
    assert before[0] != before[1]
    repaired = c0.anti_entropy_sync("n1")
    after = [c.plane_digests()["bans"] for c in (c0, c1)]
    assert after[0] == after[1]
    assert c0.anti_entropy_sync("n1") == 0
    for n in (n0, n1):
        assert n.broker.banned.look_up("clientid", "only-n0").until is None
        assert n.broker.banned.check(username="only-n1")
    return repaired > 0, after, [_rules(n.broker.banned) for n in (n0, n1)]


def test_anti_entropy_repairs_a_diverged_ban_plane():
    out = _both(_ban_anti_entropy)
    assert out[0]
