"""The port node's stats flush, ``$SYS`` heartbeat and Prometheus
endpoint (``emqx_tpu_torch/stats.py``, ``node.py``'s
``_update_stats``, ``sys_topics.py``, ``modules/prometheus.py``)
against the JAX package's, on the CPU.

A JAX ``Node`` and a port ``Node(device="cpu")`` take the same
subscriptions and batches, made from a seed with numpy; their
``Stats.all``, the ``$SYS`` topics of one heartbeat and the gauges of a
scrape over loopback are compared exactly (timings aside).
"""

import asyncio
import json

import numpy as np
import pytest

from emqx_tpu import faults as jf
from emqx_tpu import metrics as jm
from emqx_tpu import stats as js
from emqx_tpu import telemetry as jt
from emqx_tpu.modules.prometheus import PrometheusModule as JProm
from emqx_tpu.modules.prometheus import prom_name as j_prom_name
from emqx_tpu.modules.prometheus import render as j_render
from emqx_tpu.node import Node as JNode
from emqx_tpu.router import MatcherConfig as JMatcherConfig
from emqx_tpu.types import Message as JMessage
from emqx_tpu_torch import faults as pf
from emqx_tpu_torch import metrics as pm
from emqx_tpu_torch import stats as ps
from emqx_tpu_torch import telemetry as pt
from emqx_tpu_torch.modules.prometheus import PrometheusModule as PProm
from emqx_tpu_torch.modules.prometheus import prom_name, render
from emqx_tpu_torch.node import Node as PNode
from emqx_tpu_torch.router import MatcherConfig as PMatcherConfig
from emqx_tpu_torch.types import Message as PMessage


class Q:
    def __init__(self, client_id="c"):
        self.client_id = client_id
        self.inbox = []

    def deliver(self, topic, msg):
        self.inbox.append((msg.topic, bytes(msg.payload)))


def _workload(seed, n=40):
    rng = np.random.default_rng(seed)
    filters = []
    for i in range(n):
        a, b = int(rng.integers(0, 6)), int(rng.integers(0, 6))
        filters.append(("f/+/%d" % b) if i % 3 == 0 else
                       ("f/%d/#" % a) if i % 3 == 1 else f"f/{a}/{b}")
    topics = [f"f/{int(x)}/{int(y)}"
              for x, y in rng.integers(0, 6, size=(60, 2))]
    return filters, [topics[i:i + 15] for i in range(0, 60, 15)]


def _nodes(matcher_kw, seed=0, **node_kw):
    """A JAX node and a port node with the same subscriptions, after
    the same publish batches. Returns both, JAX first."""
    # the fault registries are process-wide: a test that ran earlier in
    # this process may have left injections for the next flush to fold
    jf.drain_injected()
    pf.drain_injected()
    tel = dict(slow_threshold_ms=1e9)  # no timing-dependent slow count
    j = JNode(name="obs@test", boot_listeners=False,
              matcher=JMatcherConfig(**matcher_kw),
              telemetry=jt.TelemetryConfig(**tel), **node_kw)
    p = PNode(name="obs@test", device="cpu",
              matcher=PMatcherConfig(**matcher_kw),
              telemetry=pt.TelemetryConfig(**tel), **node_kw)
    filters, batches = _workload(seed)
    for node, M in ((j, JMessage), (p, PMessage)):
        subs = [Q(f"c{i}") for i in range(len(filters) // 2)]
        for i, f in enumerate(filters):
            node.subscribe(subs[i % len(subs)], f)
            if i % 7 == 0:
                node.subscribe(subs[(i + 1) % len(subs)], f"$share/g/{f}")
        for b in batches:
            node.broker.publish_batch([M(topic=t, payload=b"x") for t in b])
        node.unsubscribe(subs[0], filters[0])
    return j, p


def test_the_key_tables_are_the_jax_packages():
    assert ps.STATS_KEYS == js.STATS_KEYS
    assert pm.GAUGE_METRICS == jm.GAUGE_METRICS
    assert set(jm.TRACING_METRICS) <= set(pm.NAMES)
    s = ps.Stats()
    s.setstat("x.count", 3, "x.max")
    s.setstat("x.count", 1, "x.max")
    assert s.getstat("x.max") == 3
    s.delstat("x.count")
    s.delstat("never.there")
    assert "x.count" not in s.all() and s.getstat("x.count") == 0


MATCHERS = {
    "host": {"use_native": False},
    "device_cache": {"use_native": False, "device_min_filters": 0},
    "device_plain": {"use_native": False, "device_min_filters": 0,
                     "match_cache": False, "delta": False},
    "native": {"device_min_filters": 0},
}


@pytest.mark.parametrize("kind", sorted(MATCHERS))
def test_stats_all_after_the_flush_equal(kind):
    j, p = _nodes(MATCHERS[kind], seed=sorted(MATCHERS).index(kind))
    j.stats.tick()
    p.stats.tick()
    assert p.stats.all() == j.stats.all()
    assert p.stats.getstat("subscriptions.count") > 0
    assert p.stats.getstat("publish.spans.count") == 4
    for name in pm.NAMES:
        assert p.metrics.val(name) == j.metrics.val(name), name
    # the flush folds deltas: a second tick moves no counter
    before = p.metrics.all()
    p.stats.tick()
    assert p.metrics.all() == before


def test_node_tick_is_the_stats_flush():
    _j, p = _nodes(MATCHERS["device_cache"])
    assert p.metrics.val("cache.match.miss") == 0  # not folded yet
    p.tick()
    assert p.metrics.val("cache.match.miss") > 0
    assert p.stats.getstat("routes.count") > 0


def test_quarantine_watch_alarms_at_the_same_tick():
    kw = {"use_native": False, "device_min_filters": 0,
          "host_reclaim_pending": 2, "delta_max_filters": 10**6}
    seqs = []
    for N, M, MC in ((JNode, JMessage, JMatcherConfig),
                     (PNode, PMessage, PMatcherConfig)):
        extra = {} if N is PNode else {"boot_listeners": False}
        if N is PNode:
            extra["device"] = "cpu"
        node = N(name="q@test", matcher=MC(**kw), **extra)
        s = Q()
        for i in range(40):
            node.subscribe(s, f"q/{i}")
        node.broker.publish_batch([M(topic="q/1")])
        seq = []
        for k in range(6):
            for i in range(3 * k, 3 * k + 3):
                node.unsubscribe(s, f"q/{i}")
            node.stats.tick()
            seq.append((node.stats.getstat("router.ids.quarantined.count"),
                        [a.name for a in
                         node.alarms.get_alarms("activated")]))
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert ["router_ids_quarantined"] in [a for _q, a in seqs[1]]


# -- the $SYS heartbeat -------------------------------------------------------

#: topics whose value is a clock reading or a description of the build
VOLATILE = ("uptime", "datetime", "sysdescr", "stats/loop.0.lag_ms")


def _heartbeat(node):
    box = Q("sys")
    node.broker.subscribe(box, "$SYS/brokers/#")
    node.sys.heartbeat()
    return dict(box.inbox)


@pytest.mark.parametrize("kind", ["host", "device_cache"])
def test_one_heartbeat_publishes_the_same_sys_topics(kind):
    j, p = _nodes(MATCHERS[kind])
    jsys, psys = _heartbeat(j), _heartbeat(p)
    assert set(psys) == set(jsys)
    pre = "$SYS/brokers/obs@test/"
    assert psys["$SYS/brokers"] == b"obs@test"
    for topic, val in psys.items():
        suffix = topic[len(pre):]
        if suffix in VOLATILE:
            continue
        if suffix == "telemetry/stages":
            def counts(v):
                return {k: s["count"] for k, s in json.loads(v).items()}
            assert counts(val) == counts(jsys[topic])
            continue
        assert val == jsys[topic], topic
    assert pre + "metrics/messages.publish" in psys
    assert pre + "stats/subscriptions.count" in psys
    assert json.loads(psys[pre + "slow_subs"]) == []


async def test_the_node_runs_the_heartbeat_every_sys_interval():
    node = PNode(name="hb@test", device="cpu", sys_interval=0.05)
    box = Q("sys")
    node.broker.subscribe(box, "$SYS/brokers")
    await node.start()
    try:
        for _ in range(1000):
            if len(box.inbox) >= 2:
                break
            await asyncio.sleep(0.01)
        assert len(box.inbox) >= 2
    finally:
        await node.stop()
    assert PNode(device="cpu").sys.interval == 60.0


# -- Prometheus ---------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_gives_the_same_exposition_text(seed):
    rng = np.random.default_rng(seed)
    metrics = {n: int(rng.integers(0, 10**6)) for n in pm.NAMES}
    metrics["retained.count"] = 7
    stats = {k: int(rng.integers(0, 1000)) for k in ps.STATS_KEYS}
    stats["cluster.hb.rtt_ms"] = 0.125  # a sub-unit float gauge
    jtel, ptel = jt.Telemetry(), pt.Telemetry()
    for x in rng.lognormal(0.0, 2.0, size=500):
        stage = jt.STAGES[int(rng.integers(0, len(jt.STAGES)))]
        jtel.hists[stage].observe(float(x))
        ptel.hists[stage].observe(float(x))
    assert ptel.histograms() == jtel.histograms()
    text = render(metrics, stats, ptel.histograms())
    assert text == j_render(metrics, stats, jtel.histograms())
    assert "# TYPE emqx_retained_count gauge" in text.splitlines()
    assert all(prom_name(k) == j_prom_name(k) for k in metrics)


async def _scrape(port, path="/metrics"):
    r, w = await asyncio.open_connection("127.0.0.1", port)
    w.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
    await w.drain()
    data = await r.read()
    w.close()
    head, _, body = data.partition(b"\r\n\r\n")
    return head.split(b"\r\n")[0], body.decode()


def _values(body):
    out = {}
    for line in body.splitlines():
        if line and not line.startswith("#"):
            name, val = line.rsplit(" ", 1)
            out[name] = float(val)
    return out


async def test_a_scrape_over_loopback_serves_the_registries():
    j, p = _nodes(MATCHERS["device_cache"])
    got = []
    for node, Prom in ((j, JProm), (p, PProm)):
        await node.start()
        try:
            mod = node.modules.load(Prom, {"port": 0})
            for _ in range(200):
                if mod.port:
                    break
                await asyncio.sleep(0.01)
            status, body = await _scrape(mod.port)
            assert status == b"HTTP/1.1 200 OK"
            status404, _ = await _scrape(mod.port, "/other")
            assert status404 == b"HTTP/1.1 404 Not Found"
            got.append(_values(body))
        finally:
            await node.stop()
    jv, pv = got
    want = sum(len(s) for s in p.broker._subscriptions.values())
    assert pv["emqx_subscriptions_count"] == want > 0
    for key in ps.STATS_KEYS:
        if key != "loop.0.lag_ms":
            assert pv[prom_name(key)] == jv[prom_name(key)], key
    for stage in pt.STAGES:
        fam = f"emqx_tpu_publish_stage_{stage}_ms_count"
        assert pv[fam] == jv[fam], fam
    assert pv["emqx_tpu_publish_stage_end_to_end_ms_count"] == 4
    for name in pm.NAMES:
        assert pv[prom_name(name)] == jv[prom_name(name)], name


# -- the node's defaults -------------------------------------------------------

async def test_the_node_is_observable_by_default():
    import gc

    from emqx_tpu.zone import Zone as JZone
    from emqx_tpu_torch.zone import Zone as PZone

    node = PNode(device="cpu")
    assert node.telemetry.enabled and node.broker.telemetry is node.telemetry
    assert node.router.telemetry is node.telemetry
    assert node.broker.tracing is node.tracing
    assert node.tracing.config.sample_rate == 0.0
    assert node.broker.tracer is node.tracer
    assert node.telemetry.tracer is node.tracer
    assert PZone().force_gc_policy == JZone().force_gc_policy \
        == (16000, 16 * 1024 * 1024)
    assert node.global_gc.interval == 15 * 60.0
    hooks = lambda: sum(1 for cb in gc.callbacks  # noqa: E731
                        if getattr(cb, "__self__", None) is node.sys_mon)
    for _ in range(2):
        await node.start()
        await asyncio.sleep(0)  # the monitors' tasks start
        assert hooks() == 1
        assert len([t for t in node._bg_tasks if not t.done()]) >= 6
        await node.stop()
        assert hooks() == 0 and not node._bg_tasks
        node.stats.tick()
        assert node.stats.getstat("node.state") == 2  # stopping
