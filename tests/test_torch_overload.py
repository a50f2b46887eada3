"""The port's overload protection against the JAX package's: the
device-path breaker's state machine, the monitor's levels and alarms,
and the shedding and self-healing they drive.

``DeviceBreaker``: the same scripts of allow/record calls run against
the JAX breaker and the port's, op by op, with equal states, return
values, counters and alarms after every op. The monitor: the same
lag and queue samples give equal levels, transitions and alarm
levels on a JAX ``Node`` and a port ``Node(device="cpu")``. The
CONNECT refusal at critical is held frame for frame against the JAX
channel (``tests/test_torch_channel.py``'s ``Pair``). The live-socket
cases (saturation shed, executor death, socket reset with the will,
overload on and off) run the port's node over loopback with the
independent codec of ``tests/indie_mqtt.py``; the on/off parity run
also runs on a JAX node, whose wire content must be the same. Both
fault registries are cleared around every test.
"""

import asyncio
import dataclasses
import threading
import time

import pytest

import indie_mqtt as im
from emqx_tpu import faults as jf
from emqx_tpu.alarm import AlarmManager as JAlarms
from emqx_tpu.metrics import Metrics as JMetrics
from emqx_tpu.node import Node as JNode
from emqx_tpu.overload import DeviceBreaker as JBreaker
from emqx_tpu.overload import OverloadConfig as JConfig
from emqx_tpu.overload import OverloadMonitor as JMonitor
from emqx_tpu.router import MatcherConfig as JMatcherConfig
from emqx_tpu.session import Session as JSession
from emqx_tpu.types import Message as JMessage
from emqx_tpu_torch import faults as pf
from emqx_tpu_torch.alarm import AlarmManager
from emqx_tpu_torch.metrics import Metrics
from emqx_tpu_torch.node import Node
from emqx_tpu_torch.overload import (CRITICAL, OK, WARN, DeviceBreaker,
                                     OverloadConfig, OverloadMonitor)
from emqx_tpu_torch.router import MatcherConfig
from emqx_tpu_torch.session import Session
from emqx_tpu_torch.types import Message
from test_torch_channel import Pair, _connect

LIMIT = 60.0


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in (jf, pf):
        f.clear()
        f.set_master(True)
    try:
        yield
    finally:
        for f in (jf, pf):
            f.clear()
            f.set_master(True)


def _active(alarms):
    return sorted(a.name for a in alarms.get_alarms("activated"))


# -- DeviceBreaker in lockstep ----------------------------------------------

#: op scripts: ("fail",), ("ok", elapsed_s), ("allow",), ("sleep", s),
#: ("rebuild",), ("done",)
SCRIPTS = {
    "trip_then_probe_closes": [
        ("fail",), ("fail",), ("allow",), ("fail",), ("allow",),
        ("sleep", 0.06), ("allow",), ("allow",), ("ok", 0.0),
        ("allow",)],
    "probe_fails_reopens": [
        ("fail",), ("fail",), ("fail",), ("sleep", 0.06), ("allow",),
        ("fail",), ("allow",), ("sleep", 0.06), ("allow",), ("ok", 0.0)],
    "success_resets_the_count": [
        ("fail",), ("fail",), ("ok", 0.0), ("fail",), ("fail",),
        ("allow",), ("ok", 0.0), ("allow",)],
    "stale_success_keeps_open": [
        ("fail",), ("fail",), ("fail",), ("ok", 0.0), ("allow",),
        ("sleep", 0.06), ("allow",), ("ok", 0.0)],
    "rebuilding_admits_no_probe": [
        ("fail",), ("fail",), ("fail",), ("rebuild",), ("sleep", 0.06),
        ("allow",), ("ok", 0.0), ("done",), ("allow",), ("allow",),
        ("ok", 0.0), ("rebuild",)],
    "slow_success_is_a_failure": [
        ("ok", 0.5), ("ok", 0.01), ("ok", 0.5), ("ok", 0.5), ("ok", 0.5),
        ("allow",), ("sleep", 0.06), ("allow",), ("ok", 0.01)],
}


def _op(br, op):
    kind = op[0]
    if kind == "fail":
        return br.record_failure()
    if kind == "ok":
        return br.record_success(op[1])
    if kind == "allow":
        return br.allow_device()
    if kind == "rebuild":
        return br.enter_rebuilding()
    if kind == "done":
        return br.rebuild_complete()
    raise ValueError(op)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_breaker_script_in_lockstep_with_jax(name):
    jm, pm = JMetrics(), Metrics()
    ja, pa = JAlarms(), AlarmManager()
    kw = dict(failures=3, cooldown_s=0.05, slow_ms=100.0)
    jb = JBreaker(jm, alarms=ja, **kw)
    pb = DeviceBreaker(pm, alarms=pa, **kw)
    for i, op in enumerate(SCRIPTS[name]):
        if op[0] == "sleep":
            time.sleep(op[1])
            continue
        assert _op(pb, op) == _op(jb, op), (i, op)
        assert (pb.state, pb.failures, pb._probing) == \
            (jb.state, jb.failures, jb._probing), (i, op)
        assert _active(pa) == _active(ja), (i, op)
        info = {k: v for k, v in pb.info().items() if k != "open_for_s"}
        assert info == {k: v for k, v in jb.info().items()
                        if k != "open_for_s"}, (i, op)
    for k in ("breaker.failures", "breaker.trips", "breaker.probes"):
        assert pm.val(k) == jm.val(k), k
    assert pm.val("breaker.trips") >= 1 or name == "success_resets_the_count"


def test_half_open_admits_exactly_one_probe():
    """Concurrent batches in the half-open window: one probe only."""
    br = DeviceBreaker(Metrics(), failures=1, cooldown_s=0.05)
    br.record_failure()
    time.sleep(0.06)
    barrier = threading.Barrier(8)
    results = []

    def probe():
        barrier.wait()
        results.append(br.allow_device())

    ts = [threading.Thread(target=probe) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
        assert not t.is_alive()
    assert sum(results) == 1
    assert br.state == DeviceBreaker.HALF_OPEN
    assert br.metrics.val("breaker.probes") == 1


# -- OverloadConfig ---------------------------------------------------------


def test_overload_config_defaults_equal_the_jax_package():
    assert dataclasses.asdict(OverloadConfig()) == \
        dataclasses.asdict(JConfig())
    assert OverloadConfig.RELOADABLE == JConfig.RELOADABLE
    assert OverloadConfig().enabled and OverloadConfig().breaker \
        and OverloadConfig().breaker_rebuild


@pytest.mark.parametrize("kw", [
    dict(interval_s=0), dict(lag_warn_ms=100, lag_critical_ms=10),
    dict(queue_warn=9.0), dict(clear_ticks=0),
    dict(critical_hiwater_div=0), dict(force_shutdown_queue_len=-1),
    dict(ingress_wait_timeout_s=-1.0), dict(breaker_failures=0),
    dict(breaker_cooldown_s=0.0), dict(rebuild_backoff_s=0.0),
    dict(sentinel_timeout_s=-1.0), dict(breaker_slow_ms=5.0),
])
def test_overload_config_checks_equal_the_jax_package(kw):
    def outcome(cls):
        try:
            return dataclasses.asdict(cls(**kw))
        except ValueError as e:
            return str(e)

    assert outcome(OverloadConfig) == outcome(JConfig)


# -- the monitor --------------------------------------------------------------


def _nodes(**ocfg):
    jn = JNode(boot_listeners=False, overload=JConfig(**ocfg))
    pn = Node(device="cpu", overload=OverloadConfig(**ocfg))
    return jn, pn


@pytest.mark.parametrize("lags", [
    [10.0, 80.0, 900.0, 0.0, 0.0, 0.0, 300.0, 0.0, 0.0],
    [0.0, 600.0, 20.0, 60.0, 0.0, 1000.0, 1000.0, 0.0, 49.0, 0.0, 0.0],
])
def test_monitor_levels_hysteresis_and_alarm_equal_jax(lags):
    jn, pn = _nodes(lag_warn_ms=50, lag_critical_ms=500, clear_ticks=2)
    for lag in lags:
        assert pn.overload.tick(lag) == jn.overload.tick(lag), lag
        assert pn.overload.reject_connects() == \
            jn.overload.reject_connects()
        pa = {a.name: a.details.get("level")
              for a in pn.alarms.get_alarms("activated")}
        ja = {a.name: a.details.get("level")
              for a in jn.alarms.get_alarms("activated")}
        assert pa == ja, lag
    assert pn.metrics.val("overload.transitions") == \
        jn.metrics.val("overload.transitions") > 0


def test_queue_depth_drives_level_and_ingress_pressure():
    jn, pn = _nodes(queue_warn=2.0, queue_critical=4.0, clear_ticks=1)
    for node in (jn, pn):
        ing, ov = node.ingress, node.overload
        hw = ing.queue_hiwater
        ing._pending.extend([(None, None)] * (hw * 4))
        assert ov.tick(0.0) == CRITICAL
        # critical divides the effective high-water mark
        del ing._pending[hw:]
        assert ing.backlogged()
        del ing._pending[hw // 8:]
        assert ing.backlogged() is (hw // 8 >= max(1, hw // 4))
        ing._pending.clear()
        assert ov.tick(0.0) == OK
        assert not ing.backlogged()
        ing._pending.extend([(None, None)] * (hw * 2))
        assert ov.tick(0.0) == WARN
        ing._pending.clear()
    assert pn.metrics.val("overload.transitions") == \
        jn.metrics.val("overload.transitions") == 3


def test_warn_sheds_qos0_at_mqueue_pressure_like_jax():
    jn, pn = _nodes()
    out = []
    for node, scls, mcls in ((jn, JSession, JMessage),
                             (pn, Session, Message)):
        sess = scls("shed", broker=node.broker, max_mqueue_len=8,
                    mqueue_store_qos0=True)
        sess.connected = False
        for i in range(6):
            sess.enqueue(mcls(topic="q/t", payload=b"%d" % i, qos=0))
        node.overload.level = WARN
        sess.enqueue(mcls(topic="q/t", payload=b"shed", qos=0))
        sess.enqueue(mcls(topic="q/t", payload=b"keep", qos=1))
        node.overload.level = OK
        sess.enqueue(mcls(topic="q/t", payload=b"ok", qos=0))
        out.append((len(sess.mqueue),
                    node.metrics.val("overload.shed.qos0"),
                    node.metrics.val("delivery.dropped")))
    assert out[0] == out[1] == (8, 1, 1)


@pytest.mark.parametrize("ver", [3, 4, 5])
def test_critical_connect_refusal_bytes_equal_jax(ver):
    pr = Pair()
    pr.jb.overload = JMonitor(None, JConfig())
    pr.pb.overload = OverloadMonitor(None, OverloadConfig())
    pr.jb.overload.level = pr.pb.overload.level = CRITICAL
    pr.open("c")
    pr.step("c", _connect(ver, "busy"))   # asserts equal bytes
    j, p = pr.chans["c"]
    assert j.closed and p.closed
    assert pr.pb.metrics.val("overload.shed.connect") == \
        pr.jb.metrics.val("overload.shed.connect") == 1
    # below critical the next CONNECT is served
    pr.jb.overload.level = pr.pb.overload.level = WARN
    pr.open("d")
    pr.step("d", _connect(ver, "fine"))
    assert pr.chans["d"][1].session is not None


@pytest.mark.parametrize("ver", [4, 5])
def test_session_unavailable_refusal_is_counted_like_jax(ver, monkeypatch):
    from emqx_tpu.cm import SessionUnavailableError as JUnavailable
    from emqx_tpu_torch.cm import SessionUnavailableError as PUnavailable

    pr = Pair()

    def refuse(exc):
        def open_session(*_a, **_k):
            raise exc("held", "other@node")
        return open_session

    monkeypatch.setattr(pr.jcm, "open_session", refuse(JUnavailable))
    monkeypatch.setattr(pr.pcm, "open_session", refuse(PUnavailable))
    pr.open("c")
    pr.step("c", _connect(ver, "held"))
    assert pr.pb.metrics.val("overload.shed.connect") == \
        pr.jb.metrics.val("overload.shed.connect") == 1


def test_force_shutdown_policy_kills_the_oom_session():
    node = Node(device="cpu",
                overload=OverloadConfig(force_shutdown_queue_len=5))

    class Chan:
        def __init__(self, sess):
            self.session = sess
            self.client_id = sess.client_id
            self.kicked = False

        def kick(self, discard=False):
            self.kicked = True

    sess = Session("oom", broker=node.broker, max_mqueue_len=0,
                   mqueue_store_qos0=True)
    sess.connected = False
    for i in range(10):
        sess.enqueue(Message(topic="o/t", payload=b"%d" % i, qos=1))
    chan = Chan(sess)
    node.cm.register_channel("oom", chan)
    node.overload.tick(0.0)
    assert chan.kicked
    assert node.metrics.val("overload.force_shutdown") == 1
    assert node.cm.lookup_channel("oom") is None


def test_flatten_crash_alarms_backoff_then_retries():
    node = Node(device="cpu", matcher=MatcherConfig(
        device_min_filters=0, delta_max_filters=4))
    r = node.router
    for i in range(3):
        r.add_route(f"fl/{i}")
    r.match_ids(["fl/0"])  # build the automaton (delta live)
    with pf.injected("compaction.flatten", times=1):
        for i in range(3, 12):
            r.add_route(f"fl/{i}")
        deadline = time.monotonic() + 10
        while r._compact_failures == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
    assert r._compact_failures == 1
    assert sorted(r.host_match("fl/7")) == ["fl/7"]
    node.overload.tick(0.0)        # the monitor's heal sweep alarms it
    assert "router_compaction_failed" in _active(node.alarms)
    assert node.metrics.val("overload.heal.flatten") == 1
    r.retry_compaction()           # inside the backoff: nothing
    assert r._compact_failures == 1
    r._compact_backoff_until = 0.0
    node.overload.tick(0.0)        # the heal sweep re-kicks it
    deadline = time.monotonic() + 10
    while (r._compacting or r._compact_failures) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    assert r._compact_failures == 0
    node.tick()
    assert "router_compaction_failed" not in _active(node.alarms)


async def test_stopping_the_node_ends_the_shedding():
    """The port's Node may publish after a stop and start again: a
    level the monitor set must not outlive its task."""
    node = Node(device="cpu", boot_listeners=False, overload=OverloadConfig(
        lag_warn_ms=50, lag_critical_ms=500))
    await node.start()
    assert node.overload.tick(900.0) == CRITICAL
    assert node.ingress._pressure_div == 4
    await node.stop()
    assert node.overload.level == OK and not node.overload.reject_connects()
    assert node.ingress._pressure_div == 1
    assert "overload" not in _active(node.alarms)
    assert node.metrics.val("overload.transitions") == 2
    await node.start()   # the monitor runs again, from ok
    assert any(not t.done() for t in node._bg_tasks)
    await node.stop()


def test_overload_off_builds_nothing():
    node = Node(device="cpu", overload=OverloadConfig(enabled=False))
    assert node.overload is None
    assert node.broker.overload is None and node.broker.breaker is None
    assert node.ingress.submit_wait_timeout == 0.0
    node.tick()
    assert node.stats.getstat("overload.level") == 0
    on = Node(device="cpu", overload=OverloadConfig(breaker_rebuild=False))
    assert on.broker.breaker is not None
    assert on.broker.breaker.recovery is None
    assert on.ingress.submit_wait_timeout == 30.0


# -- live sockets -------------------------------------------------------------


async def _started(node):
    node.add_listener(port=0)
    await node.start()
    return node.listeners[0].port


async def _gone(node, cid, timeout=5.0):
    deadline = time.monotonic() + timeout
    while node.cm.lookup_channel(cid) is not None \
            and time.monotonic() < deadline:
        await asyncio.sleep(0.02)
    return node.cm.lookup_channel(cid) is None


async def test_ingress_saturation_sheds_publisher_after_bounded_wait():
    node = Node(device="cpu")
    port = await _started(node)
    try:
        node.ingress.submit_wait_timeout = 0.3
        pub = im.IndieClient("satpub")
        await pub.connect(port=port)
        with pf.injected("ingress.saturate", times=0):
            await pub.publish("sat/t", payload=b"x", qos=0)
            assert await _gone(node, "satpub")
        assert node.metrics.val("overload.shed.ingress_timeout") == 1
        assert "ingress_saturated" in _active(node.alarms)
        # with the saturation gone the monitor clears the alarm
        node.overload.tick(0.0)
        assert "ingress_saturated" not in _active(node.alarms)
        await pub.close()
    finally:
        await node.stop()


async def test_executor_death_self_heals():
    node = Node(device="cpu", matcher=MatcherConfig(device_min_filters=0))
    port = await _started(node)
    try:
        sub, pub = im.IndieClient("exsub"), im.IndieClient("expub")
        await sub.connect(port=port)
        await pub.connect(port=port)
        await sub.subscribe(("ex/t", 1))
        # warm: the fetch pool is created by the first device batch
        await pub.publish("ex/t", payload=b"warm", qos=1)
        assert (await sub.recv()).payload == b"warm"
        with pf.injected("executor.death", times=1):
            await pub.publish("ex/t", payload=b"survives", qos=1)
        assert (await sub.recv()).payload == b"survives"
        assert node.metrics.val("overload.heal.executor") == 1
        assert node.ingress.device_batches == 2
        for c in (sub, pub):
            await c.close()
    finally:
        await node.stop()


async def test_socket_reset_mid_flush_closes_cleanly_and_fires_will():
    node = Node(device="cpu")
    port = await _started(node)
    try:
        obs = im.IndieClient("robs")
        await obs.connect(port=port)
        await obs.subscribe(("wills/reset", 1))
        vic = im.IndieClient("rvic", will=dict(
            topic="wills/reset", payload=b"reset", qos=1))
        await vic.connect(port=port)
        await vic.subscribe("rs/t")
        # the next flush anywhere is the victim's delivery flush
        with pf.injected("socket.reset", times=1):
            node.broker.publish(Message(topic="rs/t", payload=b"x"))
            assert await _gone(node, "rvic")
        assert (await obs.recv()).payload == b"reset"  # the will
        node.broker.publish(Message(topic="wills/reset", payload=b"after"))
        assert (await obs.recv()).payload == b"after"
        for c in (obs, vic):
            await c.close()
    finally:
        await node.stop()


async def _parity_workload(node):
    """Mixed-QoS fan-out over the wire: each client's received
    (topic, payload, qos, packet id) tuples."""
    port = await _started(node)
    try:
        a = im.IndieClient("pa")
        b = im.IndieClient("pb", version=5)
        pub = im.IndieClient("pp")
        for c in (a, b, pub):
            await c.connect(port=port)
        await a.subscribe(("par/+", 1))
        await b.subscribe(("par/t", 2))
        for i in range(3):
            await pub.publish("par/t", payload=b"m%d" % i, qos=1)
        await pub.publish("par/x", payload=b"x", qos=0)
        got = []
        for c, want in ((a, 4), (b, 3)):
            pkts = []
            for _ in range(want):
                p = await c.recv()
                pkts.append((p.topic, bytes(p.payload), p.qos, p.pkt_id))
            got.append(sorted(pkts, key=lambda t: t[1]))
        for c in (a, b, pub):
            await c.close()
        return got
    finally:
        await node.stop()


def _delta_metrics(node):
    return {k: v for k, v in node.metrics.all().items()
            if v and k.startswith(("messages.", "delivery.", "overload.",
                                   "breaker.", "faults."))}


async def test_overload_on_off_delivery_parity():
    """The default overload config in the OK state against
    ``enabled=False`` on the port, and the JAX node at its default:
    the same wire content, and on the port the same counters — the
    layer is invisible until something breaks."""
    async def run(node):
        return await asyncio.wait_for(_parity_workload(node), LIMIT)

    on = Node(device="cpu", matcher=MatcherConfig(device_min_filters=0))
    off = Node(device="cpu", matcher=MatcherConfig(device_min_filters=0),
               overload=OverloadConfig(enabled=False))
    ref = JNode(boot_listeners=False,
                matcher=JMatcherConfig(device_min_filters=0))
    on_wire, off_wire, ref_wire = [await run(n) for n in (on, off, ref)]
    assert on_wire == off_wire == ref_wire
    assert _delta_metrics(on) == _delta_metrics(off)
    assert on.ingress.device_batches > 0
