"""The port's sampled tracing (``emqx_tpu_torch/tracing.py`` and its
seams in the ingress batcher, the broker and the channel's egress
flush) against the JAX package's, on the CPU.

Sampling, stamping, the span rings, ``SlowSubs`` and the export are
held against the JAX package's classes on the same inputs, made from a
seed with numpy; the seams against the JAX broker's on the same
batches (the stages each sampled message gets); and a live port node
over loopback closes every sampled message's chain, ingress to the
subscriber's flush. Deliveries at ``sample_rate = 0`` are the untraced
build's, byte for byte.

The port's stage intervals: a sampled batch under the ingress batcher
records each telemetry stage as an interval on the thread that ran
it, none at ``sample_rate = 0``; ``ctl profile stop`` lays them, and
the full collections, over the profiler's trace on its own clock, so
the aten ops a batch's ``pack`` ran fall inside its ``pack`` interval.
"""

import asyncio
import gc
import json
import threading
import time

import numpy as np
import pytest

from emqx_tpu import tracing as jtr
from emqx_tpu.alarm import AlarmManager as JAlarms
from emqx_tpu.broker import Broker as JBroker
from emqx_tpu.metrics import Metrics as JMetrics
from emqx_tpu.router import MatcherConfig as JMatcherConfig
from emqx_tpu.router import Router as JRouter
from emqx_tpu.types import Message as JMessage
from emqx_tpu_torch import tracing as ptr
from emqx_tpu_torch.alarm import AlarmManager as PAlarms
from emqx_tpu_torch.broker import Broker as PBroker
from emqx_tpu_torch.metrics import Metrics as PMetrics
from emqx_tpu_torch.router import MatcherConfig as PMatcherConfig
from emqx_tpu_torch.types import Message as PMessage
from mqtt_client import TestClient


class Q:
    def __init__(self, client_id="c"):
        self.client_id = client_id
        self.inbox = []

    def deliver(self, topic, msg):
        self.inbox.append((topic, msg.topic, bytes(msg.payload),
                           "_trace" in msg.headers))


def test_config_defaults_are_the_jax_packages():
    jc, pc = jtr.TracingConfig(), ptr.TracingConfig()
    assert vars(jc) == vars(pc)
    assert pc.enabled and pc.sample_rate == 0.0
    assert ptr.TracingConfig.RELOADABLE == jtr.TracingConfig.RELOADABLE
    assert ptr.TRACE_HEADER == jtr.TRACE_HEADER


@pytest.mark.parametrize("rate", [0.01, 0.1, 0.5])
def test_the_same_message_ids_are_sampled(rate):
    rng = np.random.default_rng(int(rate * 1000))
    ids = [int(x) for x in rng.integers(0, 2**63 - 1, size=20000)]
    ids += list(range(1, 5001))
    jt = jtr.Tracing(jtr.TracingConfig(sample_rate=rate))
    pt = ptr.Tracing(ptr.TracingConfig(sample_rate=rate))
    got = [pt.sampled(i) for i in ids]
    assert got == [jt.sampled(i) for i in ids]
    share = sum(got) / len(got)
    assert abs(share - rate) < max(0.01, rate * 0.2)
    assert pt.active and jt.active


def test_stamping_is_idempotent_and_off_at_rate_zero():
    pt = ptr.Tracing(ptr.TracingConfig(sample_rate=1.0), node="n1")
    m = PMessage(topic="a")
    ctx = pt.stamp(m)
    assert ctx["tid"] == m.id and ctx["node"] == "n1"
    assert pt.stamp(m) is ctx and m.headers["_trace"] is ctx
    carried = PMessage(topic="b", headers={"_trace": {"tid": 7, "t0": 1.0}})
    assert pt.stamp(carried) == {"tid": 7, "t0": 1.0}
    off = ptr.Tracing()
    m2 = PMessage(topic="c")
    assert not off.active and off.stamp(m2) is None
    assert "_trace" not in m2.headers
    dis = ptr.Tracing(ptr.TracingConfig(enabled=False, sample_rate=1.0))
    assert not dis.active


@pytest.mark.parametrize("cap,n", [(4, 10), (16, 16), (8, 3)])
def test_a_ring_overflow_is_counted(cap, n):
    out = []
    for mod, M in ((jtr, JMetrics), (ptr, PMetrics)):
        metrics = M()
        t = mod.Tracing(mod.TracingConfig(sample_rate=1.0, ring_size=cap),
                        metrics=metrics)
        tb = t.batch_begin([{"tid": 1, "t0": 0.0}])
        for _ in range(n - 1):
            t.span_mark(tb, "match", tb.t0p)
        assert t.drain_tick() == min(cap, n)
        out.append((metrics.val("tracing.spans"),
                    metrics.val("tracing.dropped"), t.dropped_total,
                    t.spans_total))
        assert t.drain_tick() == 0  # deltas: nothing twice
        assert metrics.val("tracing.dropped") == max(0, n - cap)
    assert out[0] == out[1]


def _flush_spans(seed, n_clients=40, n=600):
    rng = np.random.default_rng(seed)
    cids = [f"c{i}" for i in range(n_clients)]
    return [(cids[int(rng.integers(0, n_clients))],
             float(rng.lognormal(5.0, 1.2))) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slow_subs_ranking_ewma_and_expiry_equal(seed):
    spans = _flush_spans(seed)
    rows = []
    for mod, A, M in ((jtr, JAlarms, JMetrics), (ptr, PAlarms, PMetrics)):
        alarms, metrics = A(node="t"), M()
        cfg = mod.TracingConfig(sample_rate=1.0, slow_subs_top=5,
                                slow_subs_threshold_ms=200.0,
                                slow_subs_alarm_ticks=2)
        t = mod.Tracing(cfg, metrics=metrics, alarms=alarms)
        ring = t._ring()
        for i, (cid, lat) in enumerate(spans):
            ring.put(((i,), "flush", 1000.0 + i, lat, {"clientid": cid}))
            if i % 150 == 149:
                t.drain_tick()
        top = [r[:4] for r in t.slow.top()]
        now = max(e[3] for e in t.slow.clients.values())
        alarm_seq = []
        for k in range(3):
            t.slow.tick(now + k)
            alarm_seq.append(sorted(a.name for a in
                                    alarms.get_alarms("activated")))
        t.slow.tick(now + cfg.slow_subs_expiry_s + 1)  # everyone expires
        rows.append((top, alarm_seq, len(t.slow.clients),
                     metrics.val("slow_subs.flushes"),
                     metrics.val("slow_subs.breaches"),
                     [a.name for a in alarms.get_alarms("deactivated")]))
    assert rows[0] == rows[1]
    assert rows[1][0] and rows[1][2] == 0
    assert rows[1][3] == len(spans)


def test_slow_subs_table_is_bounded():
    for mod in (jtr, ptr):
        t = mod.Tracing(mod.TracingConfig(slow_subs_top=2))
        for i in range(200):
            t.slow.fold(f"c{i}", float(i), 10.0)
        t.slow.tick(10.0)
        assert len(t.slow.clients) == 64
        assert t.slow.top(1)[0][0] == "c199"


# -- the broker's seams: the same batches through both packages ------------

def _batches(seed):
    rng = np.random.default_rng(seed)
    topics = [f"s/{int(x)}/a" for x in rng.integers(0, 6, size=48)]
    return [topics[i:i + 12] for i in range(0, 48, 12)]


def _stages_by_message(tracing, msgs):
    tracing.drain_tick()
    index = {m.id: k for k, m in enumerate(msgs)}
    per = [[] for _ in msgs]
    for tids, stage, _t0, dur, _extra, _writer in tracing._export:
        assert dur >= 0.0
        for tid in tids:
            if tid in index:
                per[index[tid]].append(stage)
    return [sorted(x) for x in per]


@pytest.mark.parametrize("mk", [
    {},                                                  # host regime
    {"device_min_filters": 0},                           # cache split
    {"device_min_filters": 0, "match_cache": False},
    {"device_min_filters": 0, "active_k": 1},            # overflow rows
])
def test_batch_seams_give_each_message_the_same_stages(mk):
    mk = dict(mk, use_native=False)
    got = []
    for B, R, MC, M, mod in (
            (JBroker, JRouter, JMatcherConfig, JMessage, jtr),
            (PBroker, None, PMatcherConfig, PMessage, ptr)):
        b = (B(router=R(MC(**mk), node="n1"), node="n1") if R is not None
             else B(config=MC(**mk), node="n1", device="cpu"))
        t = mod.Tracing(mod.TracingConfig(sample_rate=1.0), node="n1")
        b.tracing = t
        subs = [Q("x"), Q("y")]
        b.subscribe(subs[0], "s/+/a")
        b.subscribe(subs[1], "s/1/#")
        msgs, res = [], []
        for batch in _batches(4):
            ms = [M(topic=tp, payload=b"p") for tp in batch]
            msgs += ms
            res.append(b.publish_batch(ms))
        got.append((res, _stages_by_message(t, msgs),
                    [s.inbox for s in subs]))
    assert got[0] == got[1]
    assert all({"match", "dispatch", "publish", "ingress"} <= set(st)
               for st in got[1][1])


@pytest.mark.parametrize("device", [False, True])
def test_deliveries_byte_identical_at_sample_rate_zero(device):
    mk = {"use_native": False}
    if device:
        mk["device_min_filters"] = 0
    streams = []
    for tracing in (None, ptr.Tracing(), ptr.Tracing(
            ptr.TracingConfig(enabled=False, sample_rate=0.5))):
        b = PBroker(config=PMatcherConfig(**mk), node="n1", device="cpu")
        b.tracing = tracing
        q = Q()
        b.subscribe(q, "s/+/a")
        for batch in _batches(2):
            b.publish_batch([PMessage(topic=tp, payload=b"%d" % i)
                             for i, tp in enumerate(batch)])
        streams.append(q.inbox)
        if tracing is not None:
            assert tracing.drain_tick() == 0
    assert streams[0] == streams[1] == streams[2]
    assert not any(traced for *_r, traced in streams[0])


# -- export and the loop profiler ---------------------------------------------

def test_export_writes_chrome_trace_json_that_loads(tmp_path):
    docs = []
    for mod in (jtr, ptr):
        t = mod.Tracing(mod.TracingConfig(sample_rate=1.0), node="n1")
        tb = t.batch_begin([{"tid": 5, "t0": 100.0},
                            {"tid": 9, "t0": 100.5}])
        t.mark_match(tb, tb.t0p)
        t.span_abs(tb, "xloop", tb.t0p, 0.25)
        t.close_batch(tb)
        t.flush_mark({"tid": 5, "t0": 100.0}, "sub1")
        t.flush_mark({"bad": 1}, "sub2")  # no tid: ignored
        t.drain_tick()
        path = tmp_path / f"{mod.__name__}.json"
        n = t.export(str(path))
        doc = json.load(open(path))
        assert n == len(doc["traceEvents"])
        docs.append(doc)
    shape = [sorted((e["name"], e["ph"], e["args"].get("trace"))
                    for e in d["traceEvents"] if e["ph"] == "X")
             for d in docs]
    assert shape[0] == shape[1]
    assert docs[1]["otherData"]["spans"] == docs[0]["otherData"]["spans"]


def test_export_writes_wall_clock_timestamps(tmp_path):
    t = ptr.Tracing(ptr.TracingConfig(sample_rate=1.0), node="n1")
    now = time.time()
    tb = t.batch_begin([{"tid": 5, "t0": now}])
    t.interval(tb, "pack", tb.t0p, tb.t0p + 0.002)
    t.close_batch(tb)
    t.drain_tick()
    path = tmp_path / "t.json"
    t.export(str(path))
    evs = [e for e in json.load(open(path))["traceEvents"]
           if e["ph"] == "X"]
    assert evs and all(abs(e["ts"] / 1e6 - now) < 60.0 for e in evs)
    pack = [e for e in evs if e["cat"] == "stage"]
    assert [e["name"] for e in pack] == ["pack"]
    assert pack[0]["dur"] == pytest.approx(2000.0, abs=0.01)
    assert pack[0]["args"]["batch"] == "5"
    # the interval is data as well, on the wall clock
    (stage, writer, os_tid, t0, t1, args), = t.intervals()
    assert stage == "pack" and writer == "MainThread" and os_tid > 0
    assert t1 - t0 == pytest.approx(0.002, abs=1e-6)
    assert args == {"batch": 5}


def test_loop_profiler_samples_the_main_thread():
    import time

    prof = ptr.LoopProfiler(interval_ms=1.0)
    assert prof.start() and not prof.start()
    t0 = time.monotonic()
    while prof.samples < 5 and time.monotonic() - t0 < 5:
        sum(range(10000))
    assert prof.stop() and not prof.stop()
    assert prof.samples >= 5
    assert any(line.startswith("MainThread;")
               for line in prof.collapsed().splitlines())
    prof.reset()
    assert prof.samples == 0 and prof.collapsed() == ""


# -- a live node: ingress to the subscriber's flush -------------------------

async def test_live_node_closes_every_sampled_chain():
    from emqx_tpu_torch.node import Node
    from emqx_tpu_torch.tracing import TracingConfig

    node = Node(name="trc@test", device="cpu",
                tracing=TracingConfig(sample_rate=1.0))
    lst = node.add_listener(port=0)
    await node.start()
    try:
        sub = TestClient("sub")
        await sub.connect(port=lst.port)
        await sub.subscribe("t/+", qos=1)
        pub = TestClient("pub")
        await pub.connect(port=lst.port)
        for i in range(6):
            await pub.publish(f"t/{i % 3}", b"%d" % i, qos=1)
        got = [await sub.recv() for _ in range(6)]
        assert sorted(p.payload for p in got) == \
            sorted(b"%d" % i for i in range(6))
        await pub.publish("nobody/here", b"x", qos=1)
        node.stats.tick()  # the stats flush drains the rings
        by_tid = {}
        for tids, stage, *_r in node.tracing._export:
            for tid in tids:
                by_tid.setdefault(tid, set()).add(stage)
        full = {"ingress", "match", "dispatch", "publish", "flush"}
        chains = sorted(by_tid.values(), key=len)
        assert len(chains) == 7
        assert sum(1 for c in chains if c >= full) == 6
        assert chains[0] >= full - {"flush"}
        rows = node.tracing.slow.top()
        assert [r[0] for r in rows] == ["sub"] and rows[0][3] == 6
        assert node.metrics.val("slow_subs.flushes") == 6
        assert node.stats.getstat("slow_subs.tracked") == 1
        await sub.close()
        await pub.close()
    finally:
        await node.stop()


# -- stage intervals under the ingress batcher -------------------------------

PLAIN = dict(match_cache=False, delta=False, use_native=False,
             device_min_filters=1)


def _traced_node(rate):
    from emqx_tpu_torch.node import Node
    from emqx_tpu_torch.tracing import TracingConfig

    node = Node(matcher=PMatcherConfig(**PLAIN), batch_size=8,
                device="cpu", boot_listeners=False,
                tracing=TracingConfig(sample_rate=rate))
    subs = [Q(f"q{i}") for i in range(3)]
    node.broker.subscribe(subs[0], "s/+/a")
    node.broker.subscribe(subs[1], "s/1/#")
    node.broker.subscribe(subs[2], "s/#")
    node.broker.publish_batch([PMessage(topic="warm/up")])
    return node, subs


async def _burst(node, n, collect_at=None):
    ing = node.ingress
    futs = []
    for i in range(n):
        futs.append(ing.submit(PMessage(topic=f"s/{i % 5}/a",
                                        payload=b"%d" % i)))
        if i == collect_at:
            await asyncio.sleep(0)
            gc.collect(2)
    res = await asyncio.gather(*futs)
    await ing.drain()
    return list(res)


def test_no_interval_at_sample_rate_zero_and_deliveries_identical():
    got = []
    for rate in (0.0, 1.0):
        node, subs = _traced_node(rate)
        res = asyncio.run(asyncio.wait_for(_burst(node, 60), 60))
        node.tracing.collect()
        ivs = node.tracing.intervals()
        if rate == 0.0:
            assert ivs == [] and node.tracing.spans_total == 0
        else:
            stages = {iv[0] for iv in ivs}
            assert {"queue", "begin_host", "pack", "fetch_wait", "fetch",
                    "order_wait", "dispatch", "ack"} <= stages, stages
            threads = {iv[0]: iv[1] for iv in ivs}
            assert threads["fetch"].startswith("ingress-fetch")
            assert threads["pack"] == threads["ack"] == "MainThread"
        got.append((res, [[x[:3] for x in q.inbox] for q in subs]))
    assert got[0] == got[1]


def test_a_collection_under_the_ring_lock_on_a_ringless_thread_returns():
    """A full collection that starts inside ``Tracing.collect``'s
    locked section, on a thread with no ring yet, records its ``gc``
    interval on that thread (the collector hook registers the ring
    under the same lock) and the thread goes on."""
    node, _subs = _traced_node(1.0)
    trc = node.tracing

    class Collecting(list):
        # the copy of the rings under the lock allocates: a full
        # collection may start there
        def __iter__(self):
            gc.collect(2)
            return super().__iter__()

    trc._rings = Collecting(trc._rings)
    done = []

    def run():
        trc.collect()
        done.append(threading.current_thread().name)

    th = threading.Thread(target=run, name="ringless", daemon=True)
    node.sys_mon.install_gc_hook()
    try:
        th.start()
        th.join(10)
    finally:
        node.sys_mon.remove_gc_hook()
    assert done == ["ringless"]
    assert any(iv[0] == "gc" and iv[1] == "ringless"
               for iv in trc.intervals())


def test_profile_stop_lines_the_stages_up_with_the_aten_ops(tmp_path,
                                                           monkeypatch):
    """The aten ops each ``pack_matches`` call ran (marked by the test)
    fall inside the ``pack`` interval, or a re-pack's ``fetch``, that
    the merged trace holds for the same thread, within 0.2 ms; a full
    collection in the window has its own row."""
    from torch.profiler import record_function

    import emqx_tpu_torch.broker as broker_mod

    node, _subs = _traced_node(1.0)
    pack = broker_mod.pack_matches

    def marked(*a, **kw):
        with record_function("test.pack_matches"):
            return pack(*a, **kw)

    monkeypatch.setattr(broker_mod, "pack_matches", marked)
    node.sys_mon.install_gc_hook()
    try:
        out = node.ctl.run(["profile", "start", str(tmp_path)])
        assert "tracing to" in out
        asyncio.run(asyncio.wait_for(_burst(node, 60, collect_at=30), 60))
        out = node.ctl.run(["profile", "stop"])
    finally:
        node.sys_mon.remove_gc_hook()
    assert out.startswith("trace written to")
    doc = json.load(open(tmp_path / "trace.json"))
    evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    stages = [e for e in evs if e.get("cat") == "stage"]
    marks = [e for e in evs if e["name"] == "test.pack_matches"]
    assert marks and stages
    tol = 200.0  # microseconds

    def inside(m, names):
        return any(iv["name"] in names
                   and iv["args"]["os_tid"] == m["tid"]
                   and iv["ts"] - tol <= m["ts"]
                   and m["ts"] + m["dur"] <= iv["ts"] + iv["dur"] + tol
                   for iv in stages)

    assert all(inside(m, ("pack", "fetch")) for m in marks)
    assert sum(inside(m, ("pack",)) for m in marks) >= 5
    # the aten ops the marked calls ran lie inside the same interval
    ops = [e for e in evs if e.get("cat") == "cpu_op"
           and any(m["tid"] == e["tid"] and m["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= m["ts"] + m["dur"]
                   for m in marks)]
    assert ops and all(inside(e, ("pack", "fetch")) for e in ops)
    # the stages on rows of their own, named by thread and kind
    rows = {e["args"]["name"] for e in doc["traceEvents"]
            if e.get("ph") == "M" and e.get("name") == "thread_name"
            and e["tid"] >= (1 << 32)}
    assert {"MainThread stages", "MainThread waits", "MainThread gc"} <= \
        rows, rows
    assert any(r.startswith("ingress-fetch") for r in rows)
    assert any(e["name"] == "gc" for e in stages)
