"""The port's publish-path telemetry (``emqx_tpu_torch/telemetry.py``,
the broker's and router's span seams, ``profiling.py``'s
``KernelTimer`` and ``tracer.py``) against the JAX package's, on the
CPU.

The same inputs, made from a seed with numpy, go through both
packages. Timing values are never compared: histogram math on equal
samples, span tags, the set of stages a batch stamps, the deliveries,
and the slow log and alarm under a scripted clock are compared exactly.
The port's own stages (``telemetry.PORT_STAGES``) and its spans'
``gc_ms`` tag are left out of those comparisons and tested on their
own: the full collections, CPU against wall, and the rebuilds.
"""

import gc

import json
import logging
import time
from collections import Counter

import numpy as np
import pytest
import torch

from emqx_tpu import telemetry as jt
from emqx_tpu.alarm import AlarmManager as JAlarms
from emqx_tpu.broker import Broker as JBroker
from emqx_tpu.broker import DispatchConfig as JDispatch
from emqx_tpu.profiling import KernelTimer as JKernelTimer
from emqx_tpu.router import MatcherConfig as JMatcherConfig
from emqx_tpu.router import Router as JRouter
from emqx_tpu.tracer import Tracer as JTracer
from emqx_tpu.types import Message as JMessage
from emqx_tpu_torch import profiling
from emqx_tpu_torch import telemetry as pt
from emqx_tpu_torch.alarm import AlarmManager as PAlarms
from emqx_tpu_torch.broker import Broker as PBroker
from emqx_tpu_torch.broker import DispatchConfig as PDispatch
from emqx_tpu_torch.router import MatcherConfig as PMatcherConfig
from emqx_tpu_torch.tracer import Tracer as PTracer
from emqx_tpu_torch.types import Message as PMessage


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Q:
    def __init__(self, client_id="c"):
        self.client_id = client_id
        self.inbox = []

    def deliver(self, topic, msg):
        self.inbox.append((topic, msg.topic, bytes(msg.payload), msg.qos))


# -- Histogram ------------------------------------------------------------


def test_stage_names_and_buckets_are_the_jax_packages():
    # the JAX package's stages, in order, then the port's
    assert pt.STAGES == jt.STAGES + pt.PORT_STAGES
    assert pt.PORT_STAGES == (
        "queue", "begin_host", "fetch_wait", "order_wait", "tail_yield",
        "ack", "gc", "fetch_cpu", "dispatch_cpu")
    assert pt.BUCKETS_MS == jt.BUCKETS_MS
    jc, pc = jt.TelemetryConfig(), pt.TelemetryConfig()
    assert vars(jc) == vars(pc)
    assert pc.enabled and pt.TelemetryConfig.RELOADABLE == \
        jt.TelemetryConfig.RELOADABLE


@pytest.mark.parametrize("seed,ring", [(0, 2048), (1, 64), (2, 8),
                                       (3, 4096)])
def test_histogram_equal_on_the_same_samples(seed, ring):
    rng = np.random.default_rng(seed)
    xs = list(rng.lognormal(mean=0.0, sigma=2.5, size=1500))
    # every bucket edge exactly, 0, and past the last bound
    xs += [float(b) for b in jt.BUCKETS_MS] + [0.0, 9999.0, 5000.0001]
    rng.shuffle(xs)
    jh, ph = jt.Histogram(ring), pt.Histogram(ring)
    for x in xs:
        jh.observe(float(x))
        ph.observe(float(x))
    assert ph.stats() == jh.stats()
    assert ph.snapshot() == jh.snapshot()
    for q in (50, 95, 99):
        assert ph.percentile(q) == jh.percentile(q)
    assert ph.counts == jh.counts and list(ph.ring) == list(jh.ring)
    ph.reset()
    assert ph.count == 0 and not ph.ring and ph.sum == 0.0


# -- span seams: the same batches through both brokers ---------------------

def _workload(seed, n_filters=24, n_batches=5, batch=12):
    """Filters over a small vocabulary (``+``, ``#``, a ``$share``
    group, literals) and Zipf-like batches with repeats."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(5)]
    filters = set()
    while len(filters) < n_filters:
        depth = int(rng.integers(1, 4))
        ws = [words[int(rng.integers(0, 5))] for _ in range(depth)]
        r = rng.random()
        if r < 0.3:
            ws[int(rng.integers(0, depth))] = "+"
        elif r < 0.45:
            ws.append("#")
        filters.add("/".join(ws))
    filters = sorted(filters)
    topics = ["/".join(words[int(rng.integers(0, 5))]
                       for _ in range(int(rng.integers(1, 4))))
              for _ in range(40)]
    p = 1.0 / np.arange(1, len(topics) + 1)
    batches = [[topics[int(i)] for i in rng.choice(
        len(topics), size=batch, p=p / p.sum())] for _ in range(n_batches)]
    return filters, batches


def _pair(mk, planner=True, **tel):
    tel.setdefault("slow_threshold_ms", 0.0)  # every batch recorded
    tel.setdefault("slow_alarm_after", 10**9)
    jb = JBroker(router=JRouter(JMatcherConfig(**mk), node="n1"),
                 node="n1", dispatch_config=JDispatch(planner=planner))
    pb = PBroker(config=PMatcherConfig(**mk), node="n1", device="cpu",
                 dispatch_config=PDispatch(planner=planner))
    jtel, ptel = jt.Telemetry(jt.TelemetryConfig(**tel)), \
        pt.Telemetry(pt.TelemetryConfig(**tel))
    jb.telemetry = jb.router.telemetry = jtel
    pb.telemetry = pb.router.telemetry = ptel
    return (jb, jtel), (pb, ptel)


def _subscribe(broker, filters):
    subs = [Q(f"c{i}") for i in range(len(filters))]
    for i, (s, f) in enumerate(zip(subs, filters)):
        broker.subscribe(s, f)
        if i % 5 == 0:
            broker.subscribe(s, f"$share/g/{f}")
    return subs


def _tags(rec):
    """A slow record's tags, and the stages it stamped (the JAX
    package's: the port's own stages and ``gc_ms`` tag left out)."""
    rec = dict(rec)
    stages = rec.pop("stages_ms")
    rec.pop("end_to_end_ms")
    rec.pop("ts")
    rec.pop("gc_ms", None)
    return rec, sorted(s for s in stages if s not in pt.PORT_STAGES)


#: matcher settings of each path (both packages take them)
PATHS = {
    "host": {},
    "device_cache": {"device_min_filters": 0},
    "device_nocache": {"device_min_filters": 0, "match_cache": False},
    "device_plain": {"device_min_filters": 0, "match_cache": False,
                     "delta": False},
    "device_overflow": {"device_min_filters": 0, "active_k": 1},
}


@pytest.mark.parametrize("planner", [True, False])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_equal_per_batch(path, planner):
    filters, batches = _workload(sorted(PATHS).index(path))
    (jb, jtel), (pb, ptel) = _pair(dict(PATHS[path], use_native=False),
                                   planner=planner)
    jsubs, psubs = _subscribe(jb, filters), _subscribe(pb, filters)
    for batch in batches + batches[:2]:
        jr = jb.publish_batch([JMessage(topic=t, payload=b"x")
                               for t in batch])
        pr = pb.publish_batch([PMessage(topic=t, payload=b"x")
                               for t in batch])
        assert pr == jr
    assert [s.inbox for s in psubs] == [s.inbox for s in jsubs]
    jrecs, precs = jtel.slow_records(), ptel.slow_records()
    assert len(precs) == len(jrecs) == len(batches) + 2
    assert ptel.spans_total == jtel.spans_total == len(precs)
    for jrec, prec in zip(jrecs, precs):
        assert _tags(prec) == _tags(jrec)
    want_path = "host" if path == "host" else "device"
    assert {r["path"] for r in precs} == {want_path}
    if path == "device_cache":
        assert any(r["cache_hit"] > 0 for r in precs)
    if path == "device_overflow":
        assert any(r["fallbacks"] > 0 for r in precs)
    for s in jt.STAGES:
        if s != "rebuild":
            assert ptel.hists[s].count == jtel.hists[s].count, s
    # the port also observes its inline rebuilds (the first flatten)
    assert ptel.hists["rebuild"].count >= jtel.hists["rebuild"].count
    # the port's stages of a batch published without the batcher (a
    # host batch delivers, and folds its span, inside the begin)
    n = len(precs)
    assert ptel.hists["dispatch_cpu"].count == n
    device = want_path == "device"
    for s in ("begin_host", "fetch_wait", "fetch_cpu"):
        assert ptel.hists[s].count == (n if device else 0), s
    for s in ("queue", "order_wait", "tail_yield", "ack", "gc"):
        assert ptel.hists[s].count == 0, s


@pytest.mark.parametrize("kind", ["rows", "groups", "host"])
def test_chunked_finish_closes_the_span_once(kind):
    mk = {"device_min_filters": 1024 if kind == "host" else 0,
          "match_cache": False, "use_native": False}
    (jb, jtel), (pb, ptel) = _pair(mk, planner=kind == "groups")
    for b in (jb, pb):
        b.subscribe(Q(), "t/+")
        b.subscribe(Q("d"), "t/#")
    out = []
    for b, M in ((jb, JMessage), (pb, PMessage)):
        msgs = [M(topic=f"t/{i}") for i in range(8)]
        p = b.publish_begin(msgs, defer_host=kind == "host")
        assert not p.done
        b.publish_fetch(p)
        if kind == "host":
            n, fn = len(p.live), b.publish_host_chunk
        elif kind == "groups":
            assert p.plan is not None
            n, fn = p.plan.n_groups, b.publish_finish_planned
        else:
            n, fn = len(p.live), b.publish_finish_chunk
        for lo in range(0, n, 3):
            fn(p, lo, min(lo + 3, n))
        out.append(p.results)
    assert out[0] == out[1] == [2] * 8
    for tel in (jtel, ptel):
        st = tel.stage_stats()
        assert tel.spans_total == 1
        assert st["end_to_end"]["count"] == 1
        assert st["dispatch"]["count"] == 1  # summed over the chunks
    assert _tags(ptel.slow_records()[0]) == _tags(jtel.slow_records()[0])


def test_vetoed_batch_closes_its_span_in_both():
    (jb, jtel), (pb, ptel) = _pair({"use_native": False})
    for b, M in ((jb, JMessage), (pb, PMessage)):
        b.hooks.add("message.publish",
                    lambda msg: msg.set_header("allow_publish", False))
        assert b.publish_batch([M(topic="t")]) == [0]
    assert ptel.spans_total == jtel.spans_total == 1
    assert _tags(ptel.slow_records()[0]) == _tags(jtel.slow_records()[0])


# -- telemetry off: the deliveries do not change --------------------------

def _run_workload(broker, M, filters, batches):
    subs = _subscribe(broker, filters)
    res = [broker.publish_batch([M(topic=t, payload=b"%d" % i)
                                 for i, t in enumerate(b)])
           for b in batches]
    return res, [s.inbox for s in subs]


@pytest.mark.parametrize("planner", [True, False])
@pytest.mark.parametrize("mk", [{"device_min_filters": 0},
                                {"device_min_filters": 0,
                                 "match_cache": False},
                                {}])
def test_deliveries_identical_with_telemetry_on_off_and_unwired(mk, planner):
    filters, batches = _workload(11)
    mk = dict(mk, use_native=False)
    runs = []
    for enabled in (True, False, None):
        b = PBroker(config=PMatcherConfig(**mk), node="n1", device="cpu",
                    dispatch_config=PDispatch(planner=planner))
        if enabled is not None:
            tel = pt.Telemetry(pt.TelemetryConfig(enabled=enabled))
            b.telemetry = b.router.telemetry = tel
        res, boxes = _run_workload(b, PMessage, filters, batches)
        runs.append((res, [list(x) for x in boxes]))
        if enabled is False:
            assert tel.spans_total == 0
            assert all(h.count == 0 for h in tel.hists.values())
            assert tel.begin(4) is None
            p = b.publish_begin([PMessage(topic="w0")])
            assert p.span is None
    assert runs[0] == runs[1] == runs[2]
    jb = JBroker(router=JRouter(JMatcherConfig(**mk), node="n1"),
                 node="n1", dispatch_config=JDispatch(planner=planner))
    assert _run_workload(jb, JMessage, filters, batches) == runs[0]


# -- the slow log and the sustained-breach alarm ---------------------------

class _Clock:
    """A scripted perf-counter: it moves only when a batch's publish
    hook advances it, so a batch's end-to-end time is exactly the
    script's, whatever else reads the clock."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_slow_log_and_alarm_fire_at_the_same_batch(monkeypatch, caplog):
    rng = np.random.default_rng(5)
    lat_ms = [float(x) for x in rng.choice([20.0, 150.0], size=40,
                                           p=[0.3, 0.7])]
    lat_ms[10:16] = [150.0] * 6  # one streak surely past slow_alarm_after
    jclock, pclock = _Clock(), _Clock()
    monkeypatch.setattr(jt, "_now", jclock)
    monkeypatch.setattr(pt, "_now", pclock)
    cfg = dict(slow_threshold_ms=100.0, slow_alarm_after=4)
    seqs = []
    for tel_mod, B, M, A, clock, logger in (
            (jt, JBroker, JMessage, JAlarms, jclock, "emqx_tpu.telemetry"),
            (pt, PBroker, PMessage, PAlarms, pclock,
             "emqx_tpu_torch.telemetry")):
        alarms = A(node="t@test")
        b = B(device="cpu") if B is PBroker else B()
        tel = tel_mod.Telemetry(tel_mod.TelemetryConfig(**cfg),
                                alarms=alarms)
        b.telemetry = b.router.telemetry = tel
        b.subscribe(Q(), "a/+")
        step = {"ms": 0.0}

        def advance(msg, clock=clock, step=step):
            clock.t += step["ms"] / 1000.0

        b.hooks.add("message.publish", advance)
        seq = []
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=logger):
            for ms in lat_ms:
                step["ms"] = ms / 2  # two messages a batch
                b.publish_batch([M(topic="a/1"), M(topic="a/2")])
                lines = [r.getMessage() for r in caplog.records
                         if r.name == logger]
                seq.append((tel.slow_total, tel._slow_streak,
                            sorted(a.name for a in
                                   alarms.get_alarms("activated")),
                            len(lines)))
        recs = [_tags(r) for r in tel.slow_records()]
        e2e = [r["end_to_end_ms"] for r in tel.slow_records()]
        seqs.append((seq, recs, e2e,
                     [a.name for a in alarms.get_alarms("deactivated")]))
    assert seqs[1] == seqs[0]
    seq = seqs[1][0]
    assert any(s[2] == ["slow_publish"] for s in seq)
    assert seq[-1][3] == sum(1 for x in lat_ms if x >= 100.0)


def test_slow_record_tees_through_the_tracer():
    sinks = []
    for T, tel_mod in ((JTracer, jt), (PTracer, pt)):
        tr = T()
        sink = tr.start_trace("topic", "hot/#")
        cold = T()
        sink2 = cold.start_trace("topic", "cold/#")
        for tracer in (tr, cold):
            tel = tel_mod.Telemetry(
                tel_mod.TelemetryConfig(slow_threshold_ms=0.0),
                tracer=tracer)
            sp = tel.begin(1)
            sp.topic = "hot/t"
            tel.finish(sp)
            tel.finish(sp)  # idempotent: folded once
            assert tel.spans_total == 1
        sinks.append((len(sink), len(sink2),
                      all("SLOW PUBLISH" in x for x in sink)))
    assert sinks[0] == sinks[1] == (1, 0, True)


def test_observe_stage_from_another_thread_takes_the_lock():
    import threading

    tel = pt.Telemetry()
    ts = [threading.Thread(target=lambda: [tel.observe_stage("rebuild", 1.0)
                                           for _ in range(500)])
          for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert tel.hists["rebuild"].count == 2000
    tel.observe_stage("no_such_stage", 1.0)  # ignored, as in JAX
    off = pt.Telemetry(pt.TelemetryConfig(enabled=False))
    off.observe_stage("rebuild", 1.0)
    assert off.hists["rebuild"].count == 0


def _wait_compaction(r):
    import time

    deadline = time.monotonic() + 20
    while (r._compacting or r._rebuild_inflight) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not r._compacting


def test_router_compaction_observes_the_rebuild_stage():
    """The off-lock compaction's whole duration lands in the rebuild
    stage, once per merge, and the first flatten (inline) once."""
    from emqx_tpu_torch.router import Router

    r = Router(PMatcherConfig(device_min_filters=0, delta_max_filters=4,
                              use_native=False), device="cpu")
    tel = pt.Telemetry()
    r.telemetry = tel
    for i in range(3):
        r.add_route(f"a/{i}")
    r.match_dispatch(["a/1"])  # the first flatten
    assert tel.hists["rebuild"].count == 1
    for i in range(6):
        r.add_route(f"b/{i}/+")
    _wait_compaction(r)
    merges = r.delta_info()["merges"]
    assert merges >= 1
    assert tel.hists["rebuild"].count == 1 + merges


def test_inline_rebuild_lands_once_in_the_rebuild_stage():
    from emqx_tpu_torch.router import Router

    r = Router(PMatcherConfig(device_min_filters=0, delta=False,
                              use_native=False), device="cpu")
    tel = pt.Telemetry()
    r.telemetry = tel
    for i in range(5):
        r.add_route(f"a/{i}/+")
    for k in (1, 2, 3):
        r.rebuild()
        assert tel.hists["rebuild"].count == k
        assert tel.hists["rebuild"].sum > 0.0
    off = pt.Telemetry(pt.TelemetryConfig(enabled=False))
    r.telemetry = off
    r.rebuild()
    assert off.hists["rebuild"].count == 0


def test_background_rebuild_lands_once_in_the_rebuild_stage(monkeypatch):
    """Outside delta mode the background compaction rebuilds inline
    under the lock: one ``rebuild`` sample, as a sync rebuild."""
    from emqx_tpu_torch.router import Router

    r = Router(PMatcherConfig(device_min_filters=0, delta=False,
                              use_native=False), device="cpu")
    tel = pt.Telemetry()
    r.telemetry = tel
    for i in range(5):
        r.add_route(f"a/{i}/+")
    r.match_dispatch(["a/1/x"])  # the first flatten, inline
    assert tel.hists["rebuild"].count == 1
    monkeypatch.setattr(r, "_needs_compaction_locked", lambda: True)
    built = r._rebuilds
    r._schedule_compaction()
    _wait_compaction(r)
    assert r._rebuilds == built + 1
    assert tel.hists["rebuild"].count == 2


# -- the port's stages: full collections, CPU against wall ----------------

def test_forced_full_collection_adds_one_gc_sample_and_the_spans_gc_ms():
    """A ``gc.collect(2)`` inside a batch (a publish hook) reaches the
    ``gc`` stage once through ``SysMon``'s one collector hook, and the
    batch's span carries its pause as ``gc_ms``; a younger collection
    adds nothing, and ``sysmon.long_gc`` still counts past its bound."""
    from emqx_tpu_torch.metrics import Metrics
    from emqx_tpu_torch.monitors import SysMon

    b = PBroker(config=PMatcherConfig(device_min_filters=0,
                                      use_native=False),
                node="n1", device="cpu")
    tel = pt.Telemetry(pt.TelemetryConfig(slow_threshold_ms=0.0,
                                          slow_alarm_after=10**9))
    b.telemetry = b.router.telemetry = tel
    b.subscribe(Q(), "g/+")
    metrics = Metrics()
    mon = SysMon(metrics=metrics, long_gc_ms=0.0)
    mon.telemetry = tel
    fire = {"n": 0}

    def collect(msg):
        if fire["n"] == 0:
            gc.collect(2)
            gc.collect(0)
        fire["n"] += 1

    b.hooks.add("message.publish", collect)
    was = gc.isenabled()
    gc.disable()  # no collection of the interpreter's own in between
    mon.install_gc_hook()
    try:
        b.publish_batch([PMessage(topic="g/1"), PMessage(topic="g/2")])
        b.publish_batch([PMessage(topic="g/3")])
    finally:
        mon.remove_gc_hook()
        if was:
            gc.enable()
    assert tel.hists["gc"].count == 1
    pause = tel.hists["gc"].sum
    assert pause > 0.0 and tel.gc_ms_total == pause
    first, second = tel.slow_records()
    assert first["gc_ms"] == round(pause, 3) and second["gc_ms"] == 0.0
    assert metrics.val("sysmon.long_gc") == 2  # both collections


@pytest.mark.parametrize("planner", [True, False])
def test_cpu_stages_never_exceed_their_wall_stages(planner, monkeypatch):
    """Each ``_cpu`` stage reads its clock inside its wall marks: a
    batch's reading is at most its wall stages' sum, plus the thread
    CPU clock's step for each read pair (a clock that advances in
    scheduler ticks may credit a short stage a whole tick)."""
    filters, batches = _workload(13)
    (_jb, _jt), (pb, ptel) = _pair(
        {"device_min_filters": 0, "use_native": False}, planner=planner)
    _subscribe(pb, filters)
    pairs = cpu_pairs(monkeypatch)
    for batch in batches * 3:
        pb.publish_batch([PMessage(topic=t, payload=b"x") for t in batch])
    assert len(ptel.slow_records()) == len(batches) * 3
    spans = {sp for sp, _stage in pairs}
    assert len(spans) == len(batches) * 3
    step = cpu_step_ms()
    for sp in spans:
        st = sp.stages
        wall = st["fetch"] + st.get("dispatch_plan", 0.0) + \
            st.get("serialize", 0.0)
        assert 0.0 <= st["fetch_cpu"] <= \
            wall + pairs[sp, "fetch_cpu"] * step + 1e-3, (st, step)
        assert 0.0 <= st["dispatch_cpu"] <= \
            st["dispatch"] + pairs[sp, "dispatch_cpu"] * step + 1e-3, \
            (st, step)


def cpu_step_ms() -> float:
    """The thread CPU clock's step, in ms: the most one pair of its
    reads can exceed the wall time between them by."""
    step = 0
    for _ in range(3):
        t0 = time.thread_time_ns()
        t1 = t0
        while t1 == t0:
            t1 = time.thread_time_ns()
        step = max(step, t1 - t0)
    return step / 1e6


def cpu_pairs(monkeypatch) -> Counter:
    """Counts, per span and ``_cpu`` stage, the thread-CPU read pairs
    the spans fold (each pair is one ``add_ms``)."""
    pairs: Counter = Counter()
    add_ms = pt.PublishSpan.add_ms

    def counted(self, stage, ms):
        if stage.endswith("_cpu"):
            pairs[self, stage] += 1
        add_ms(self, stage, ms)

    monkeypatch.setattr(pt.PublishSpan, "add_ms", counted)
    return pairs


# -- KernelTimer and the profiler trace -----------------------------------

def test_kernel_timer_equal_stats_and_cpu_outputs():
    jk, pk = JKernelTimer(), profiling.KernelTimer()
    rng = np.random.default_rng(3)
    for x in rng.exponential(2.0, size=300):
        jk.record("walk", float(x))
        pk.record("walk", float(x))
    assert pk.stats() == jk.stats()
    with pk.span("cpu") as done:
        done((torch.zeros(3), {"a": [torch.ones(2)]}))  # CPU: no wait
    with pk.span("nothing"):
        pass
    st = pk.stats()
    assert st["cpu"]["count"] == 1 and st["nothing"]["count"] == 1
    pk.reset()
    assert pk.stats() == {}


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        torch.ones(8).add_(1)
    doc = json.load(open(tmp_path / "t" / "trace.json"))
    assert doc["traceEvents"]


# -- the tracer --------------------------------------------------------------

class _BoomSink:
    def write(self, line):
        raise OSError("closed")


@pytest.mark.parametrize("T,M", [(JTracer, JMessage), (PTracer, PMessage)])
def test_trace_sink_failure_detaches_and_file_sinks_flush(T, M):
    tr = T()
    tr.start_trace("topic", "a/#", sink=_BoomSink())
    ok = tr.start_trace("topic", "a/b")
    tr.trace_publish(M(topic="a/b", payload=b"x"))
    assert tr.lookup_traces() == [("topic", "a/b")] and len(ok) == 1
    tr.trace_publish(M(topic="a/b", payload=b"y"))
    assert len(ok) == 2
    with pytest.raises(ValueError):
        tr.start_trace("topic", "a/b")

    class FileSink:
        lines, flushed = [], False

        def write(self, line):
            self.lines.append(line)

        def flush(self):
            self.flushed = True

    fs = FileSink()
    tr.start_trace("clientid", "c9", sink=fs)
    tr.trace_packet("RECV", "c9", "CONNECT")
    assert tr.stop_trace("clientid", "c9") and fs.flushed
    assert len(fs.lines) == 1 and not tr.stop_trace("clientid", "c9")
