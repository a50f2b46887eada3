"""One run of one cell: set-up, warm-up, the measured window, the check.

The window drives the port's served publish path below the socket: a
:class:`emqx_tpu_torch.node.Node` built as a deployment builds it (the
package's defaults, the configuration's batch size, no listener),
closed-loop QoS 1 publishers submitting through ``node.ingress`` on the
node's event loop, and sans-IO subscribers of the benchmark's own that
take deliveries through ``deliver_many`` (and ``deliver``) and log them.
Each publisher keeps the traffic's window of PUBLISHes in flight, as an
MQTT client with a receive maximum does, and sends the next one when an
acknowledgement resolves.

Set-up is everything before the first timed message: the deployment
and the first topics made from the seed, the node, the
``Broker.subscribe`` calls and the first automaton build, the
collector's pass over the set-up's objects, and the warm-up, in which
the same publishers run the cell's own traffic until
``warmup_msgs`` acknowledgements resolved. The window follows without
a pause, so the pipeline is full when it opens.

Of the deployment only the subscription list outlives set-up. After
the window, the messages still in flight are awaited (a minute at
most), the node stops, the peak device memory is read and the node is
freed; then the reference is built from the subscription list and
holds a sample of the window's messages to it (``reference.judge``).
A node that lacks an attribute the window reads is refused
(:class:`SeamMissing`), never read another way.
"""

from __future__ import annotations

import asyncio
import gc
import resource
import sys
import time
from array import array
from typing import Callable, Dict, List, Optional

import numpy as np

from benchmark import reference, trace
from benchmark.workload import CHUNK, Deployment, TopicStream, sample_rng

#: seconds the check waits past the window for the last acknowledgement
ACK_GRACE_S = 60.0


class SeamMissing(RuntimeError):
    """The program lacks an attribute the benchmark reads: the run is
    refused rather than read another way."""


def match_cache(node):
    """The node's match cache, whose counters and probes the window
    reads (``Router._match_cache_obj``)."""
    cache = getattr(node.router, "_match_cache_obj", None)
    if cache is None:
        raise SeamMissing("node.router._match_cache_obj (the match cache "
                          "whose hits, misses and walked topics the "
                          "benchmark reads) is missing")
    return cache


class Recorder:
    """Every delivery, in order: the subscriber's id and the message's
    id. A position in the log is a delivery's place in time."""

    __slots__ = ("sids", "mids")

    def __init__(self) -> None:
        self.sids = array("q")
        self.mids: List[int] = []


class Subscriber:
    """A sans-IO subscriber: it logs what it receives."""

    __slots__ = ("sid", "rec")

    def __init__(self, sid: int, rec: Recorder) -> None:
        self.sid = sid
        self.rec = rec

    def deliver_many(self, items) -> None:
        sids, mids, s = self.rec.sids, self.rec.mids, self.sid
        for it in items:
            sids.append(s)
            mids.append(it[1].id)

    def deliver(self, topic_filter, msg) -> None:
        self.rec.sids.append(self.sid)
        self.rec.mids.append(msg.id)


class Publishers:
    """Closed-loop QoS 1 publishers over one ``submit(msg) -> future``."""

    def __init__(self, submit, stream: TopicStream, traffic: dict,
                 rec: Recorder, seed: int, message_type) -> None:
        self.submit = submit
        self.stream = stream
        self.rec = rec
        self.Message = message_type
        self.n_pub = int(traffic["publishers"])
        self.inflight = int(traffic["inflight"])
        self.qos = int(traffic["qos"])
        self.retain = bool(traffic.get("retain", False))
        self.payload = np.random.default_rng([seed, 4]).bytes(
            int(traffic["payload_bytes"]))
        self.cids = [f"pub{p}" for p in range(self.n_pub)]
        self.next = 0
        self.t_sub = array("d")
        self.t_ack = array("d")
        self.res = array("q")
        self.pos = array("q")
        self.mids: List[int] = []
        # the message index of each pending acknowledgement, and one
        # callback a publisher
        self.index_of: Dict[object, int] = {}
        self.on_ack = [self._on_ack(p) for p in range(self.n_pub)]
        self.acked = 0
        self.outstanding = 0
        self.running = True
        self.warm_n = 0
        self.warm: Optional[asyncio.Event] = None
        self.idle: Optional[asyncio.Event] = None

    def start(self, warm_n: int) -> None:
        self.warm_n = warm_n
        self.warm = asyncio.Event()
        self.idle = asyncio.Event()
        for _ in range(self.inflight):
            for p in range(self.n_pub):
                self.send(p)

    def send(self, p: int) -> None:
        i = self.next
        self.next = i + 1
        st = self.stream
        msg = self.Message(topic=st.chunk(i // CHUNK)[i % CHUNK],
                           payload=self.payload, qos=self.qos,
                           from_=self.cids[p])
        if self.retain:
            msg.flags["retain"] = True
        self.mids.append(msg.id)
        self.t_ack.append(0.0)
        self.res.append(-1)
        self.pos.append(-1)
        self.outstanding += 1
        self.t_sub.append(time.perf_counter())
        fut = self.submit(msg)
        self.index_of[fut] = i
        fut.add_done_callback(self.on_ack[p])

    def _on_ack(self, p: int):
        def on_ack(fut) -> None:
            i = self.index_of.pop(fut)
            self.t_ack[i] = time.perf_counter()
            self.outstanding -= 1
            # a failed acknowledgement keeps res -1: the check counts it
            # among the unacknowledged
            if not fut.cancelled() and fut.exception() is None:
                self.res[i] = int(fut.result())
            self.pos[i] = len(self.rec.sids)
            self.acked += 1
            if self.acked == self.warm_n:
                self.warm.set()
            if self.running:
                self.send(p)
            elif self.outstanding == 0:
                self.idle.set()

        return on_ack


class RunData:
    """What the metric readers read (``metrics/<name>.py``)."""

    def __init__(self) -> None:
        self.cfg: dict = {}
        self.setup_s = 0.0
        self.subscribe_s = 0.0
        self.window_s = 0.0
        self.acked_in_window = 0
        self.latencies_ms = np.zeros(0)
        self.before: Dict[str, float] = {}
        self.after: Dict[str, float] = {}
        self.spans: List[dict] = []
        self.walked: List[str] = []
        self.batches: List[List[str]] = []
        self.trace: Optional[dict] = None
        self.reference: Optional[reference.Reference] = None
        self.n_subscribers = 0

    def delta(self, key: str) -> float:
        return self.after.get(key, 0.0) - self.before.get(key, 0.0)


def counters(node) -> Dict[str, float]:
    """The program's counters the readers difference over the window."""
    out: Dict[str, float] = {}
    ing = node.ingress
    out["ingress.device_batches"] = ing.device_batches
    out["ingress.device_msgs"] = ing.device_msgs
    st = match_cache(node).stats()
    out["cache.hit"] = st["hit"]
    out["cache.miss"] = st["miss"]
    tel = node.telemetry
    out["telemetry.spans"] = tel.spans_total
    for stage, h in tel.hists.items():
        out[f"telemetry.{stage}.sum_ms"] = h.sum
    return out


class Probes:
    """The traced run's records from the program's seams: each finished
    span's tags, the topics each device batch began with, and the
    topics the match cache sent to the walk."""

    def __init__(self) -> None:
        self.spans: List[dict] = []
        self.batches: List[List[str]] = []
        self.walked: List[str] = []
        self.on = False

    def install(self, node) -> None:
        tel = node.telemetry
        finish = tel.finish

        def finish_rec(span):
            if self.on and not span.closed:
                self.spans.append({
                    "path": span.path, "batch": span.batch,
                    "n_uniq": span.n_uniq, "fallbacks": span.fallbacks,
                    "cache_hit": span.cache_hit,
                    "cache_miss": span.cache_miss})
            return finish(span)

        tel.finish = finish_rec
        broker = node.broker
        begin = broker.publish_begin

        def begin_rec(msgs, *a, **kw):
            pb = begin(msgs, *a, **kw)
            if self.on and pb.n_uniq:
                self.batches.append(list(dict.fromkeys(
                    m.topic for _, m in pb.live)))
            return pb

        broker.publish_begin = begin_rec
        cache = match_cache(node)
        probe = cache.probe

        def probe_rec(topics, *a, **kw):
            p = probe(topics, *a, **kw)
            if self.on:
                self.walked += p.miss_topics
            return p

        cache.probe = probe_rec


def build_node(cfg: dict, device: str):
    from emqx_tpu_torch.node import Node

    ncfg = cfg.get("node", {})
    return Node(device=device, batch_size=int(ncfg.get("batch_size", 4096)),
                boot_listeners=False)


def subscribe_all(node, dep: Deployment, rec: Recorder):
    subs = [Subscriber(s, rec) for s in range(dep.n_subscribers)]
    sub = node.broker.subscribe
    for sid, f in dep.subscriptions():
        sub(subs[sid], f)
    node.router.automaton()
    return subs


def steal_ticks() -> int:
    """The host's stolen CPU ticks so far (``/proc/stat``), or -1."""
    try:
        with open("/proc/stat") as f:
            return int(f.readline().split()[8])
    except (OSError, IndexError, ValueError):
        return -1


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class FullCollections:
    """The interpreter's full collections: ``iv`` on the host clock,
    ``wall_ns`` on the wall clock (the trace's labels)."""

    def __init__(self) -> None:
        self.iv: List[tuple] = []
        self.wall_ns: List[tuple] = []
        self._t0 = None

    def __call__(self, phase, info) -> None:
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t0 = (time.perf_counter(), time.time_ns())
        elif self._t0 is not None:
            self.iv.append((self._t0[0], time.perf_counter()))
            self.wall_ns.append((self._t0[1], time.time_ns()))
            self._t0 = None

    def within(self, t0: float, t1: float):
        got = [(a, b) for a, b in self.iv if b > t0 and a < t1]
        return len(got), sum(min(b, t1) - max(a, t0) for a, b in got)


def cpu_clock() -> tuple:
    """This process's CPU seconds and involuntary context switches."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime, ru.ru_nivcsw


def run_cell(cfg: dict, traffic: dict, seed: int,
             seconds: float, traced: bool, t_process: float,
             device: str = "cuda",
             tamper: Optional[Callable] = None,
             build=build_node, message_type=None) -> dict:
    """One run; returns the run's numbers and its check.

    ``tamper(node)``, when given, runs once the node has started: the
    tests break the timed path with it. ``build(cfg, device)`` makes
    the node and ``message_type`` the messages (the control puts the
    reference and a message of its own in their place)."""
    if message_type is None:
        from emqx_tpu_torch.types import Message as message_type

    rd = RunData()
    rd.cfg = cfg
    marks = [("start", time.perf_counter())]
    dep = Deployment(cfg, seed)
    rd.n_subscribers = dep.n_subscribers
    stream = TopicStream(dep, traffic, seed)
    warm_n = int(traffic["warmup_msgs"])
    stream.prefill(warm_n + int(seconds * float(traffic["prefill_per_s"])))
    marks.append(("inputs", time.perf_counter()))
    rec = Recorder()
    node = build(cfg, device)
    marks.append(("node", time.perf_counter()))
    subs = subscribe_all(node, dep, rec)
    marks.append(("subscribe", time.perf_counter()))
    rd.subscribe_s = marks[-1][1] - marks[-2][1]
    log(f"[setup] {len(dep.subs)} subscriptions of "
        f"{dep.n_subscribers} subscribers over "
        f"{len(dep.draw_rows)} drawable filters")
    # the reference's input outlives the window; the rest of the
    # deployment goes before it
    subscriptions = (dep.sids, dep.subs)
    del dep
    gc.collect()
    full = FullCollections()
    gc.callbacks.append(full)
    if traced and device == "cuda":
        trace.warm_profiler()
    marks.append(("collect", time.perf_counter()))
    probes = Probes() if traced else None
    host = trace.HostStages() if traced else None
    win = trace.Window(device) if traced else None
    pubs = Publishers(None, stream, traffic, rec, seed, message_type)
    clock: Dict[str, float] = {}

    async def drive():
        await node.start()
        try:
            if tamper is not None:
                tamper(node)
            pubs.submit = node.ingress.submit
            pubs.start(warm_n)
            await pubs.warm.wait()
            marks.append(("warm-up", time.perf_counter()))
            if traced:
                probes.install(node)
                b = node.broker
                host.wrap(b, "publish_begin", "begin")
                host.wrap(b, "publish_fetch", "fetch")
                for name in ("publish_finish_planned",
                             "publish_finish_chunk", "publish_host_chunk"):
                    host.wrap(b, name, "dispatch")
                win.start()
            rd.before = counters(node)
            clock["d0"] = len(rec.sids)
            clock["cpu0"] = cpu_clock()
            clock["steal0"] = steal_ticks()
            clock["late0"] = stream.late_chunks
            clock["t0"] = time.perf_counter()
            clock["i0"] = pubs.next
            if traced:
                win.open()
                probes.on = True
            await asyncio.sleep(seconds)
            clock["t1"] = time.perf_counter()
            clock["i1"] = pubs.next
            clock["d1"] = len(rec.sids)
            clock["cpu1"] = cpu_clock()
            clock["steal1"] = steal_ticks()
            clock["late1"] = stream.late_chunks
            rd.after = counters(node)
            if traced:
                probes.on = False
                win.close()
            pubs.running = False
            if pubs.outstanding:
                try:
                    await asyncio.wait_for(pubs.idle.wait(), ACK_GRACE_S)
                except asyncio.TimeoutError:
                    log(f"[check] {pubs.outstanding} messages unacknowledged "
                        f"{ACK_GRACE_S:.0f} s after the window")
            if traced:
                win.stop()
        finally:
            pubs.running = False
            await node.stop()

    try:
        asyncio.run(drive())
    finally:
        gc.callbacks.remove(full)
    t0, t1 = clock["t0"], clock["t1"]
    n_gc, gc_s = full.within(t0, t1)
    hits, miss = rd.delta("cache.hit"), rd.delta("cache.miss")
    n_b = rd.delta("ingress.device_batches")
    log(f"[window] {t1 - t0:.3f} s; full collections in it {n_gc}, "
        f"{gc_s:.3f} s; in the run {len(full.iv)}; messages submitted "
        f"{clock['i1'] - clock['i0']}, deliveries "
        f"{clock['d1'] - clock['d0']}, device batches {n_b:.0f}, cache "
        f"hits {hits:.0f} of {hits + miss:.0f} probes; CPU s "
        f"{clock['cpu1'][0] - clock['cpu0'][0]:.3f}, involuntary switches "
        f"{clock['cpu1'][1] - clock['cpu0'][1]}, host steal ticks "
        f"{clock['steal1'] - clock['steal0']}; topic chunks made in the "
        f"window {clock['late1'] - clock['late0']}")
    rd.setup_s = t0 - t_process
    log("[setup] s: " + ", ".join(
        f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks, marks[1:]))
        + f"; before the harness {marks[0][1] - t_process:.3f}"
        + f"; in all {rd.setup_s:.3f}")
    rd.window_s = t1 - t0
    memory_peak = 0
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
        memory_peak = int(torch.cuda.max_memory_allocated())
    if traced:
        host.spans += [("gc", a, b) for a, b in full.wall_ns]
        rd.trace = win.reduce(host)
        rd.spans = probes.spans
        rd.batches = probes.batches
        rd.walked = probes.walked
        win = None
    # the program's state goes before the reference is built
    del node, subs
    gc.collect()
    if device == "cuda":
        import torch

        torch.cuda.empty_cache()
    t_sub = np.frombuffer(pubs.t_sub, dtype=np.float64)
    t_ack = np.frombuffer(pubs.t_ack, dtype=np.float64)
    res = np.frombuffer(pubs.res, dtype=np.int64)
    acked_in = (t_ack >= t0) & (t_ack < t1) & (res >= 0)
    rd.acked_in_window = int(acked_in.sum())
    rd.latencies_ms = (t_ack[acked_in] - t_sub[acked_in]) * 1000.0
    window = np.nonzero(((t_sub >= t0) & (t_sub < t1)) | acked_in)[0]
    unacked = int((res[window] < 0).sum())
    t = time.perf_counter()
    rd.reference = ref = reference.Reference(
        zip(subscriptions[0].tolist(), subscriptions[1]))
    checks, sampled = check(ref, pubs, rec, stream, window, seed,
                            int(traffic["check_sample"]),
                            int(cfg.get("fanout_threshold", 1024)))
    checks["unacked"] = unacked
    log(f"[check] {sampled} of {len(window)} messages of the window held "
        f"to the reference in {time.perf_counter() - t:.3f} s; "
        f"{len(rec.sids)} deliveries logged")
    return {"rd": rd, "checks": checks, "attempted": int(len(window)),
            "failed": unacked, "memory_peak": memory_peak}


def check(ref, pubs: Publishers, rec: Recorder, stream: TopicStream,
          window: np.ndarray, seed: int, k: int, threshold: int) -> dict:
    """A sample of the window's messages drawn from the seed, with every
    message of the window that matched a wide filter (the longest),
    held to the reference."""
    rng = sample_rng(seed)
    n = len(window)
    pick = set(window[rng.choice(n, size=min(k, n), replace=False)].tolist()) \
        if n else set()
    wide = reference.Matcher(ref.wide_filters(threshold))
    if wide.shapes:
        for i in window.tolist():
            if wide.match(stream.topic(i)):
                pick.add(i)
    want = {pubs.mids[i]: i for i in pick}
    got: Dict[int, list] = {}
    sids = rec.sids
    for pos, m in enumerate(rec.mids):
        i = want.get(m)
        if i is not None:
            got.setdefault(i, []).append((sids[pos], pos))
    acks = {i: (int(pubs.res[i]), int(pubs.pos[i])) for i in pick
            if pubs.res[i] >= 0}
    topics = {i: stream.topic(i) for i in pick}
    return reference.judge(ref, topics, acks, got), len(pick)
