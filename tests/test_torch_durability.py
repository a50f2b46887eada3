"""The port's durability layer against the JAX package's: journal,
atomic checkpoints and kill -9 recovery, on whole nodes.

Each scenario runs the same durable workload on a JAX ``Node`` and on
a port ``Node(device="cpu")`` with ``RetainerModule``, each over its
own directory, crashes both the same way (the kill -9 analogue of the
JAX package's tests: durability detached from broker, cm and node,
then a stop without the graceful path), recovers fresh nodes from the
directories and compares ``state_model``s: the route table, the
retained store and every resurrected session's subscriptions,
inflight window, mqueue, awaiting-rel and packet id. Tolerance: exact
everywhere — the port's model equals the JAX package's, and each
equals what the workload left durable. The matrix arms ``wal.append``,
``wal.fsync`` and ``checkpoint.rename`` in both registries. A
directory written by one package is recovered by the other.
"""

import asyncio
import os

import pytest

import indie_mqtt as im
from emqx_tpu import checkpoint as jck
from emqx_tpu import faults as jf
from emqx_tpu import wal as jwal
from emqx_tpu import wire as jwire
from emqx_tpu.durability import DurabilityConfig as JConfig
from emqx_tpu.node import Node as JNode
from emqx_tpu.session import Session as JSession
from emqx_tpu.types import Message as JMessage
from emqx_tpu.types import SubOpts as JSubOpts
from emqx_tpu_torch import checkpoint as pck
from emqx_tpu_torch import faults as pf
from emqx_tpu_torch import wal as pwal
from emqx_tpu_torch import wire as pwire
from emqx_tpu_torch.channel import Channel
from emqx_tpu_torch.durability import DurabilityConfig as PConfig
from emqx_tpu_torch.modules import retainer as pretainer
from emqx_tpu_torch.modules.retainer import RetainerModule
from emqx_tpu_torch.mqtt import packet as PP
from emqx_tpu_torch.node import Node as PNode
from emqx_tpu_torch.session import Session as PSession
from emqx_tpu_torch.types import Message as PMessage
from emqx_tpu_torch.types import SubOpts as PSubOpts


class Pkg:
    """One package's durability surface, for scenarios run on both."""

    def __init__(self, name, Config, Session, Message, SubOpts, faults,
                 ck, wal, wire):
        self.name = name
        self.Config, self.Session = Config, Session
        self.Message, self.SubOpts = Message, SubOpts
        self.faults, self.ck, self.wal, self.wire = faults, ck, wal, wire

    def node(self, d, **kw):
        kw.setdefault("fsync", False)
        cfg = self.Config(enabled=True, dir=str(d), **kw)
        if self.name == "jax":
            return JNode(boot_listeners=False, load_default_modules=True,
                         durability=cfg)
        n = PNode(device="cpu", durability=cfg)
        n.modules.load(RetainerModule)
        return n


JAX = Pkg("jax", JConfig, JSession, JMessage, JSubOpts, jf, jck, jwal,
          jwire)
PORT = Pkg("port", PConfig, PSession, PMessage, PSubOpts, pf, pck,
           pwal, pwire)


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in (jf, pf):
        f.clear()
        f.set_master(True)
        f.drain_injected()  # an earlier file's firings in this process
    try:
        yield
    finally:
        for f in (jf, pf):
            f.clear()
            f.set_master(True)


async def crash(node):
    """kill -9 analogue: tear the node down WITHOUT the graceful
    durability path — no final checkpoint, no detach records; only
    what already reached the journal survives."""
    node.broker.durability = None
    node.cm.durability = None
    node.durability = None
    await node.stop()


class _Chan:
    """Minimal channel holder so the cm registry (and therefore
    checkpoint snapshots) see the session as live."""

    def __init__(self, s):
        self.session = s
        self.client_id = s.client_id


def durable_session(pkg, node, cid, expiry=300.0):
    s = pkg.Session(cid, broker=node.broker, clean_start=False)
    node.durability.session_opened(s, expiry)
    node.cm.register_channel(cid, _Chan(s))
    return s


def state_model(node):
    """Comparable durable-state fingerprint of a node (either
    package)."""
    sessions = {}
    for cid, (s, _ts, _exp) in node.cm._detached.items():
        sessions[cid] = {
            "subs": {k: (o.qos, o.nl, o.share)
                     for k, o in s.subscriptions.items()},
            "inflight": sorted(
                (pid, (v[0] if isinstance(v[0], str)
                       else (v[0].topic, bytes(v[0].payload))))
                for pid, v in s.inflight.to_list()),
            "mqueue": [(m.topic, bytes(m.payload))
                       for _p, q in s.mqueue.snapshot() for m in q],
            "awaiting_rel": sorted(s.awaiting_rel),
            "next_pkt_id": s.next_pkt_id,
        }
    ret = node.modules._loaded.get("retainer")
    retained = {t: bytes(m.payload)
                for t, m in (ret._store.items() if ret else ())}
    return {"routes": node.router.route_table(),
            "retained": retained, "sessions": sessions}


def expect(node, cids):
    """The node's state model with ``cids`` compared as detached (as
    recovery resurrects them)."""
    for cid in cids:
        chan = node.cm._channels[cid]
        node.cm._detached[cid] = (chan.session, 0, 300.0)
    want = state_model(node)
    for cid in cids:
        del node.cm._detached[cid]
    return want


# -- the kill matrix ------------------------------------------------------

SCENARIOS = ["clean", "before_flush", "torn_tail",
             "fsync_error_recovers", "mid_checkpoint",
             "stale_journal_ignored"]


async def kill_matrix(pkg, d, scenario):
    n = pkg.node(d)
    await n.start()
    M, O = pkg.Message, pkg.SubOpts
    s = durable_session(pkg, n, "m1")
    s.subscribe("w/+", O(qos=1))
    n.broker.publish(M(topic="w/1", payload=b"a", qos=1,
                       flags={"retain": True}))
    n.durability.on_batch()
    if scenario != "clean":
        s.subscribe("w2/#", O(qos=1))
        n.broker.publish(M(topic="r/2", payload=b"b",
                           flags={"retain": True}))
    if scenario == "torn_tail":
        with pkg.faults.injected("wal.append", times=1):
            n.durability.on_batch()
    elif scenario == "fsync_error_recovers":
        with pkg.faults.injected("wal.fsync", times=1):
            n.durability.on_batch()
        assert n.durability.wal.degraded
        n.durability.wal._retry_at = 0.0
        n.durability.on_batch()
        assert not n.durability.wal.degraded
    elif scenario == "mid_checkpoint":
        n.durability.on_batch()
        with pkg.faults.injected("checkpoint.rename", times=1):
            out = n.durability.checkpoint_now()
        assert "error" in out
        assert n.durability.counters["checkpoint.errors"] == 1
    elif scenario == "stale_journal_ignored":
        n.durability.on_batch()
        n.durability.checkpoint_now()
        w = pkg.wal.Wal(os.path.join(str(d), "journal-0.wal"),
                        fsync=False)
        w.append(("route", "stale/#", n.broker.node, 9))
        w.flush()
        w.close()
    if scenario in ("before_flush", "torn_tail"):
        # the phase-2 records never reached disk
        s.unsubscribe("w2/#")
        ret = n.modules._loaded.get("retainer")
        ret._restoring = True
        ret._pop("r/2")
        ret._restoring = False
    want = expect(n, ["m1"])
    await crash(n)
    n2 = pkg.node(d)
    await n2.start()
    got = state_model(n2)
    rec = dict(n2.durability.last_recovery)
    torn_alarm = any(a.name == "journal_torn_tail"
                     for a in n2.alarms.get_alarms("activated"))
    await n2.stop()
    return want, got, rec, torn_alarm


@pytest.mark.parametrize("scenario", SCENARIOS)
async def test_kill_matrix_equal_state_models(tmp_path, scenario):
    jwant, jgot, jrec, jalarm = await kill_matrix(
        JAX, tmp_path / "jax", scenario)
    pwant, pgot, prec, palarm = await kill_matrix(
        PORT, tmp_path / "port", scenario)
    assert pgot == pwant
    assert jgot == jwant
    assert pgot == jgot and pwant == jwant
    for key in ("torn_journals", "sessions", "pruned_refs",
                "replayed_records", "retained", "routes", "journals"):
        assert prec[key] == jrec[key], key
    assert (palarm, prec["torn_journals"]) == (jalarm, jrec["torn_journals"])
    assert palarm == (scenario == "torn_tail")


# -- the full crash round trip, orphan pruning ----------------------------

class Clean:
    """A non-durable subscriber: its refs die with the process."""

    def __init__(self, cid):
        self.client_id = cid

    def deliver(self, f, m):
        pass


async def round_trip(pkg, d):
    n = pkg.node(d)
    await n.start()
    M, O = pkg.Message, pkg.SubOpts
    live = durable_session(pkg, n, "live")
    live.subscribe("fleet/+/state", O(qos=1))
    live.subscribe("$share/g/fleet/cmd", O(qos=2))
    det = durable_session(pkg, n, "away")
    det.subscribe("fleet/9/state", O(qos=1))
    del n.cm._channels["away"]
    n.cm._detached["away"] = (det, 1e18, 300.0)
    det.connected = False
    n.durability.session_detached(det)
    for i in range(3):
        n.broker.subscribe(Clean(f"clean{i}"), "fleet/+/state")
    n.broker.subscribe(Clean("solo"), "solo/#")
    n.broker.publish(M(topic="fleet/1/state", payload=b"up", qos=1,
                       flags={"retain": True}))
    n.broker.publish(M(topic="fleet/2/state", payload=b"x",
                       flags={"retain": True}))
    n.broker.publish(M(topic="fleet/2/state", payload=b"",
                       flags={"retain": True}))
    n.broker.publish(M(topic="fleet/9/state", payload=b"q", qos=1))
    live.record_awaiting_rel(7)
    assert len(live.inflight) == 2
    n.durability.on_batch()
    want = expect(n, ["live"])
    # the clean subscribers' refs are pruned by recovery
    want["routes"]["fleet/+/state"][n.broker.node] -= 3
    del want["routes"]["solo/#"]
    await crash(n)
    n2 = pkg.node(d)
    await n2.start()
    got = state_model(n2)
    rec = dict(n2.durability.last_recovery)
    ret = n2.modules._loaded.get("retainer")
    tomb = "fleet/2/state" in ret._tombstones
    m = sorted(n2.router.match_filters(["fleet/5/state"])[0])
    await n2.stop()
    return want, got, rec, tomb, m


async def test_crash_round_trip_prunes_orphan_routes(tmp_path):
    jout = await round_trip(JAX, tmp_path / "jax")
    pout = await round_trip(PORT, tmp_path / "port")
    pwant, pgot, prec, ptomb, pm = pout
    assert pgot == pwant
    assert pgot == jout[1] and pwant == jout[0]
    assert prec["sessions"] == 2 and prec["pruned_refs"] == 4
    assert prec["pruned_refs"] == jout[2]["pruned_refs"]
    assert not prec["degraded"]
    assert ptomb and jout[3]
    assert pm == jout[4] == ["fleet/+/state"]


async def test_double_recovery_is_idempotent(tmp_path):
    models = {}
    for pkg in (JAX, PORT):
        d = tmp_path / pkg.name
        n = pkg.node(d)
        await n.start()
        s = durable_session(pkg, n, "c1")
        s.subscribe("a/+", pkg.SubOpts(qos=1))
        s.subscribe("a/+", pkg.SubOpts(qos=2))
        n.broker.publish(pkg.Message(topic="a/x", payload=b"r", qos=1,
                                     flags={"retain": True}))
        n.durability.on_batch()
        want = expect(n, ["c1"])
        await crash(n)
        got = []
        for _ in range(2):
            n2 = pkg.node(d)
            await n2.start()
            got.append(state_model(n2))
            await crash(n2)
        assert got == [want, want]
        models[pkg.name] = want
    assert models["port"] == models["jax"]


# -- a durable node stopped and started again ---------------------------

async def restart_then_crash(pkg, d, restart=True):
    """Graceful stop, start again, more durable work, then kill -9:
    the restarted node journals that work and recovery brings it
    back. ``restart=False`` does the same work on a node that runs
    throughout."""
    n = pkg.node(d)
    await n.start()
    M, O = pkg.Message, pkg.SubOpts
    s = durable_session(pkg, n, "rs")
    s.subscribe("r/+", O(qos=1))
    n.broker.publish(M(topic="r/1", payload=b"a", flags={"retain": True}))
    n.durability.on_batch()
    if restart:
        await n.stop()
    # made while the node is stopped: kept for the next segment
    s.subscribe("stopped/#", O(qos=1))
    if restart:
        await n.start()
    s.subscribe("again/+", O(qos=1))
    n.broker.publish(M(topic="again/x", payload=b"b", qos=1,
                       flags={"retain": True}))
    n.broker.publish(M(topic="r/1", payload=b"", flags={"retain": True}))
    n.durability.on_batch()
    folded = None
    if pkg is PORT:
        n.tick()
        folded = n.metrics.val("wal.appends")
    want = expect(n, ["rs"])
    await crash(n)
    n2 = pkg.node(d)
    await n2.start()
    got = state_model(n2)
    rec = dict(n2.durability.last_recovery)
    await n2.stop()
    return want, got, rec, folded


async def test_restarted_node_journals_and_recovers_equal(tmp_path):
    """The JAX package's start() runs its recovery again over the
    live state; a later crash there loses what was subscribed while
    stopped and after the restart. The reference is therefore the
    JAX node that did the same work without the restart."""
    jwant, jgot, _, _ = await restart_then_crash(
        JAX, tmp_path / "jax", restart=False)
    pwant, pgot, prec, folded = await restart_then_crash(
        PORT, tmp_path / "port")
    assert pgot == pwant == jwant == jgot
    assert set(pgot["sessions"]["rs"]["subs"]) == {
        "r/+", "stopped/#", "again/+"}
    assert pgot["retained"] == {"again/x": b"b"}
    assert prec["replayed_records"] > 0 and not prec["degraded"]
    # the closed journal's appends stay counted after the restart
    assert folded >= 7


# -- incremental delta chains ---------------------------------------------

async def delta_chain(pkg, d):
    n = pkg.node(d, checkpoint_full_every=3)
    await n.start()
    O = pkg.SubOpts
    s = durable_session(pkg, n, "big")
    for i in range(40):
        s.subscribe(f"tbl/{i}", O(qos=1))
    n.durability.on_batch()
    kinds = [n.durability.checkpoint_now(full=True)["kind"]]
    blobs = []
    for i in range(5):
        s.subscribe(f"churn/{i}", O(qos=1))
        n.broker.publish(pkg.Message(topic=f"churn/r{i}", payload=b"v",
                                     flags={"retain": True}, id=i,
                                     timestamp=float(i)))
        n.durability.on_batch()
        out = n.durability.checkpoint_now()
        kinds.append(out["kind"])
        if out["kind"] == "delta":
            blob = pkg.ck.load_state(os.path.join(
                str(d), f"delta-{out['generation']}.bin"))
            blobs.append(sorted(
                pkg.wire.dumps(r) for r in blob["records"]
                if r[0] != "sess.state"))
    # a journal tail on top of the chain
    s.subscribe("tail/x", O(qos=1))
    n.durability.on_batch()
    m = pkg.ck.read_manifest(str(d))
    want = expect(n, ["big"])
    await crash(n)
    n2 = pkg.node(d, checkpoint_full_every=3)
    await n2.start()
    got = state_model(n2)
    rec = dict(n2.durability.last_recovery)
    await n2.stop()
    return kinds, blobs, m["deltas"], want, got, rec


async def test_incremental_delta_chains_equal(tmp_path):
    jk, jb, jd, jwant, jgot, jrec = await delta_chain(JAX,
                                                      tmp_path / "jax")
    pk, pb, pd, pwant, pgot, prec = await delta_chain(PORT,
                                                      tmp_path / "port")
    assert pk == jk == ["full", "delta", "delta", "full", "delta",
                        "delta"]
    assert pb == jb and len(pb) == 4
    assert pd == jd
    assert pgot == pwant == jwant == jgot
    assert prec["replayed_records"] == jrec["replayed_records"] > 0


async def test_recovery_reads_base_delta_chain_and_journal_tail(
        tmp_path):
    for pkg in (JAX, PORT):
        d = tmp_path / pkg.name
        n = pkg.node(d)
        await n.start()
        s = durable_session(pkg, n, "c")
        for i in range(20):
            s.subscribe(f"base/{i}", pkg.SubOpts(qos=1))
        n.durability.on_batch()
        n.durability.checkpoint_now(full=True)
        s.subscribe("delta/1", pkg.SubOpts(qos=1))
        n.durability.on_batch()
        assert n.durability.checkpoint_now()["kind"] == "delta"
        s.subscribe("tail/1", pkg.SubOpts(qos=1))
        s.unsubscribe("base/3")
        n.durability.on_batch()
        want = expect(n, ["c"])
        await crash(n)
        n2 = pkg.node(d)
        await n2.start()
        rec = n2.durability.last_recovery
        assert rec["delta_records"] >= 2 and rec["replayed_records"] >= 3
        assert state_model(n2) == want
        await n2.stop()


# -- a directory written by one package, recovered by the other -----------

async def write_dir(pkg, d):
    n = pkg.node(d)
    await n.start()
    M, O = pkg.Message, pkg.SubOpts
    s = durable_session(pkg, n, "x1")
    s.subscribe("cross/+", O(qos=1))
    s.subscribe("$share/grp/cross/#", O(qos=1))
    n.broker.subscribe(Clean("c"), "cross/+")
    n.broker.publish(M(topic="cross/r", payload=b"keep", qos=1,
                       flags={"retain": True}))
    n.durability.on_batch()
    n.durability.checkpoint_now(full=True)
    s.subscribe("cross/delta", O(qos=1))
    n.durability.on_batch()
    n.durability.checkpoint_now()
    n.broker.publish(M(topic="cross/tail", payload=b"t",
                       flags={"retain": True}))
    n.broker.publish(M(topic="cross/q", payload=b"q", qos=1))
    n.durability.on_batch()
    want = expect(n, ["x1"])
    want["routes"]["cross/+"][n.broker.node] -= 1
    await crash(n)
    return want


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-to-port", "port-to-jax"])
async def test_directory_recovers_across_packages(tmp_path, writer,
                                                  reader):
    d = tmp_path / "dur"
    want = await write_dir(writer, d)
    n2 = reader.node(d)
    await n2.start()
    assert state_model(n2) == want
    rec = n2.durability.last_recovery
    assert rec["sessions"] == 1 and rec["pruned_refs"] == 1
    assert not rec["degraded"]
    await n2.stop()


# -- session-present and DUP redelivery through the sans-IO channel -------

async def test_resume_after_crash_session_present_and_dup(tmp_path):
    d = tmp_path / "dur"
    n = PORT.node(d)
    await n.start()
    ch = Channel(n.broker, n.cm)
    ack = ch.handle_in(PP.Connect(
        proto_ver=5, client_id="dev", clean_start=True,
        properties={"Session-Expiry-Interval": 300}))
    assert ack[0].reason_code == 0
    ch.handle_in(PP.Subscribe(packet_id=1, topic_filters=[
        ("d/t", {"qos": 1})]))
    for i in range(3):
        n.broker.publish(PMessage(topic="d/t", payload=str(i).encode(),
                                  qos=1))
    sent = [p for p in ch.handle_deliver() if p.type == PP.C.PUBLISH]
    assert len(sent) == 3 and not any(p.dup for p in sent)
    n.durability.on_batch()  # the batch flush a crash can't outrun
    await crash(n)

    n2 = PORT.node(d)
    await n2.start()
    assert "dev" in n2.cm._detached
    ch2 = Channel(n2.broker, n2.cm)
    ack = ch2.handle_in(PP.Connect(
        proto_ver=5, client_id="dev", clean_start=False,
        properties={"Session-Expiry-Interval": 300}))
    assert ack[0].session_present
    got = [p for p in ack[1:] + ch2.handle_deliver()
           if p.type == PP.C.PUBLISH]
    assert sorted(p.payload for p in got) == [b"0", b"1", b"2"]
    assert all(p.dup and p.qos == 1 for p in got)
    await n2.stop()


async def test_a_flush_before_the_outbox_drains_keeps_redelivery_exact(
        tmp_path):
    """A journal flush between a delivery and its drain to the
    transport (a batch's close publishing the ``slow_publish`` alarm
    flushes, or the next batch's fetch on the executor): the snapshot
    holds the outbox, so the drain must re-dirty the session, or a
    recovery sends those packets again beside the DUP redelivery of
    the inflight window (the JAX package's session does not, and
    recovers 6 PUBLISHes here)."""
    d = tmp_path / "dur"
    n = PORT.node(d)
    await n.start()
    ch = Channel(n.broker, n.cm)
    ch.handle_in(PP.Connect(
        proto_ver=5, client_id="dev", clean_start=True,
        properties={"Session-Expiry-Interval": 300}))
    ch.handle_in(PP.Subscribe(packet_id=1, topic_filters=[
        ("d/t", {"qos": 1})]))
    n.broker.publish_batch([PMessage(topic="d/t", payload=str(i).encode(),
                                     qos=1) for i in range(3)])
    n.durability.on_batch()  # the snapshot holds the undrained outbox
    sent = [p for p in ch.handle_deliver() if p.type == PP.C.PUBLISH]
    assert len(sent) == 3 and ch.session in n.durability._dirty
    n.durability.on_batch()
    await crash(n)

    n2 = PORT.node(d)
    await n2.start()
    ch2 = Channel(n2.broker, n2.cm)
    ack = ch2.handle_in(PP.Connect(
        proto_ver=5, client_id="dev", clean_start=False,
        properties={"Session-Expiry-Interval": 300}))
    assert ack[0].session_present
    got = [p for p in ack[1:] + ch2.handle_deliver()
           if p.type == PP.C.PUBLISH]
    assert sorted(p.payload for p in got) == [b"0", b"1", b"2"]
    assert all(p.dup and p.qos == 1 for p in got)
    # the recovered session's drain re-dirties it too (its snapshot
    # was the recovered one)
    await n2.stop()


async def test_graceful_stop_sends_0x8b_and_recovers_clean(tmp_path):
    d = tmp_path / "dur"
    n = PORT.node(d)
    lst = n.add_listener(port=0)
    await n.start()
    cli = im.IndieClient("gs", version=5, clean=True,
                         props={"Session-Expiry-Interval": 300})
    await cli.connect(port=lst.port)
    await cli.subscribe(("g/t", 1))
    stop = asyncio.create_task(n.stop())
    pkt = await asyncio.wait_for(cli.acks.get(), 30)
    assert pkt.ptype == im.DISCONNECT and pkt.rc == 0x8B
    await stop
    await cli.close()
    m = pck.read_manifest(str(d))
    assert m["clean_shutdown"] and m["deltas"] == []
    n2 = PORT.node(d)
    await n2.start()
    rec = n2.durability.last_recovery
    assert rec["replayed_records"] == 0 and rec["sessions"] == 1
    assert "gs" in n2.cm._detached
    await n2.stop()


# -- retained restore, then replay through B3's plain twin ----------------

async def test_retained_restore_then_replay_through_b3_twin(tmp_path,
                                                            monkeypatch):
    d = tmp_path / "dur"
    n = PORT.node(d)
    await n.start()
    names = [f"s{i % 7}/g{i % 3}/d{i}/state" for i in range(60)]
    for i, t in enumerate(names):
        n.broker.publish(PMessage(topic=t, payload=bytes([i]),
                                  flags={"retain": True}))
    n.broker.publish(PMessage(topic=names[0], payload=b"",
                              flags={"retain": True}))  # a delete
    n.durability.on_batch()
    await crash(n)
    n2 = PORT.node(d)
    await n2.start()
    ret = n2.modules._loaded["retainer"]
    assert sorted(ret._store) == sorted(names[1:])
    assert names[0] in ret._tombstones
    calls = []
    real = pretainer.match_names_auto

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(pretainer, "match_names_auto", counted)
    ret.index_device_threshold = 0
    ch = Channel(n2.broker, n2.cm)
    ch.handle_in(PP.Connect(proto_ver=5, client_id="r",
                            clean_start=True))
    ch.handle_in(PP.Subscribe(packet_id=1, topic_filters=[
        ("s1/+/#", {"qos": 0}), ("+/g2/+/state", {"qos": 0})]))
    await asyncio.sleep(0)  # the burst's replay flushes at tick end
    got = sorted(p.topic for p in ch.handle_deliver()
                 if p.type == PP.C.PUBLISH)
    # one delivery a (filter, stored name) pair
    want = sorted([t for t in names[1:] if t.startswith("s1/")]
                  + [t for t in names[1:] if t.split("/")[1] == "g2"])
    assert got == want and calls
    assert ret._index.fallbacks == 0
    await n2.stop()


# -- disabled mode, refusals ----------------------------------------------

async def test_disabled_builds_nothing(tmp_path):
    d = tmp_path / "off"
    n = PNode(device="cpu",
              durability=PConfig(enabled=False, dir=str(d)))
    assert n.durability is None
    assert n.broker.durability is None and n.cm.durability is None
    await n.start()
    s = PSession("c", broker=n.broker)
    s.subscribe("a/b", PSubOpts(qos=1))
    assert n.broker.publish(PMessage(topic="a/b", qos=1)) == 1
    assert s._dur is None and not s.durable
    await n.stop()
    n.tick()
    assert not d.exists()
    for m in ("wal.appends", "wal.fsyncs", "checkpoint.saves",
              "recovery.replayed"):
        assert n.metrics.val(m) == 0
    assert PNode(device="cpu").durability is None


@pytest.mark.parametrize("kw", [{"standby": "peer@host"},
                                {"standbys": ("a@h", "b@h")},
                                {"standbys": ("a@h",), "ack_quorum": 1}])
def test_standby_refused_until_journal_shipping(kw):
    """The port ships the journal (replication.py): it takes the
    replication group the JAX package takes, with equal values."""
    j = JConfig(enabled=True, **kw)
    p = PConfig(enabled=True, **kw)
    assert p.standby_list == j.standby_list
    assert (p.standby, p.standbys, p.ack_quorum) == \
        (j.standby, j.standbys, j.ack_quorum)
    assert PConfig.RELOADABLE == JConfig.RELOADABLE


@pytest.mark.parametrize("kw", [{"flush_interval_ms": 0},
                                {"checkpoint_interval_s": 0},
                                {"checkpoint_min_records": 0},
                                {"wal_shards": -1},
                                {"group_commit_window_ms": -1},
                                {"checkpoint_full_every": 0},
                                {"ack_quorum": -1},
                                {"standbys": "peer"}])
def test_config_checks_equal(kw):
    with pytest.raises(ValueError) as je:
        JConfig(**kw)
    with pytest.raises(ValueError) as pe:
        PConfig(**kw)
    assert str(pe.value) == str(je.value)
    assert PConfig.RELOADABLE == JConfig.RELOADABLE


#: the JAX package's journal-shipping knobs, each with a value it
#: takes; the port takes the same
SHIPPING = {"quorum_timeout_ms": 100.0, "repl_ack_timeout_s": 1.0,
            "repl_lag_alarm_records": 200_000, "repl_lag_clear_records": 5,
            "repl_queue_max_records": 1000}


@pytest.mark.parametrize("name", sorted(SHIPPING))
def test_shipping_knobs_wait_for_journal_shipping(name):
    """Each shipping knob is a field of the port's config, with the
    JAX default, the value set, and live-reloadable as in the JAX
    package."""
    j = JConfig(enabled=True, **{name: SHIPPING[name]})
    p = PConfig(enabled=True, **{name: SHIPPING[name]})
    assert getattr(p, name) == getattr(j, name) == SHIPPING[name]
    assert getattr(PConfig(), name) == getattr(JConfig(), name)
    assert (name in PConfig.RELOADABLE) == (name in JConfig.RELOADABLE)


async def test_metrics_fold_alarms_and_gauges(tmp_path):
    n = PORT.node(tmp_path / "dur")
    await n.start()
    s = durable_session(PORT, n, "a1")
    with pf.injected("wal.fsync", times=1):
        s.subscribe("x/+", PSubOpts(qos=1))
        n.durability.on_batch()
    n.tick()
    assert any(a.name == "wal_write_failed"
               for a in n.alarms.get_alarms("activated"))
    assert n.metrics.val("wal.fsync_errors") == 1
    n.durability.wal._retry_at = 0.0
    n.durability.on_batch()
    n.tick()
    assert not any(a.name == "wal_write_failed"
                   for a in n.alarms.get_alarms("activated"))
    assert n.metrics.val("wal.appends") >= 3
    assert n.metrics.val("checkpoint.saves") >= 1
    assert n.metrics.val("wal.group.commits") >= 1
    assert n.stats.getstat("journal.records") >= 1
    assert n.stats.getstat("durability.generation") >= 1
    await n.stop()


@pytest.mark.parametrize("shards", [2, 4])
async def test_sharded_journal_recovers_equal(tmp_path, shards):
    models = []
    for pkg in (JAX, PORT):
        d = tmp_path / pkg.name
        n = pkg.node(d, wal_shards=shards)
        await n.start()
        assert n.durability.wal.n == shards
        s = durable_session(pkg, n, "sh1")
        for i in range(12):
            s.subscribe(f"sh/{i}/+", pkg.SubOpts(qos=1))
        n.broker.publish(pkg.Message(topic="sh/1/r", payload=b"k",
                                     flags={"retain": True}))
        n.durability.on_batch()
        want = expect(n, ["sh1"])
        await crash(n)
        n2 = pkg.node(d, wal_shards=shards)
        await n2.start()
        assert state_model(n2) == want
        models.append(want)
        await n2.stop()
        names = sorted(f for f in os.listdir(d)
                       if f.startswith("journal-"))
        assert len(names) == shards
    assert models[0] == models[1]
