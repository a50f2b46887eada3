"""End-to-end message tracing: sampled per-message spans, the
slow-subscriber ranking, and a per-loop sampling profiler (the port of
the JAX package's ``tracing.py``).

The third observability tier.
Counters say *how much*, the telemetry stage histograms say *where a
batch spent its time*; this layer follows ONE sampled message from
ingress to the subscriber flush and names the client (and the Python
frames) that made it slow — the reference's ``emqx_tracer`` +
``slow_subs`` + scheduler-sampling triad.

Design invariants:

  - **Sampling is deterministic** in the message id (a Knuth
    multiplicative hash against a threshold derived from
    ``[tracing] sample_rate``), so every node of a cluster agrees on
    which messages are traced without coordination.
  - The trace context is one small dict stamped into
    ``msg.headers["_trace"]``. It rides the existing header plumbing:
    the session ``_enrich`` shallow header copy shares it, so it
    reaches the subscriber's flush, and it is never serialized onto
    the MQTT wire (the codec reads only public fields).
    Retained messages can persist a stale context; a replayed
    retained delivery then shows up under its original trace id —
    accepted noise, not a correctness issue.
  - **Zero locks on the hot path.** Span records append to a
    per-thread ring (``threading.local``); each ring is written only
    by its owner thread and swapped out whole by the stats-tick
    drain (list replacement is atomic under the GIL). The only lock
    guards ring *registration* — once per thread, ever.
  - **One disabled-mode branch per seam.** Every instrumented seam
    hoists ``trc = broker.tracing`` / ``tb = pb.tbatch`` and does
    nothing further when tracing is off; at ``sample_rate = 0``
    no context is ever stamped, so wire output is byte-identical to
    the untraced build (pinned by tests/test_torch_tracing.py).
  - No device synchronization: this module imports no torch and reads
    only the host clock.
  - Rings are bounded: overflow drops the record and counts
    ``tracing.dropped`` — tracing never blocks or grows unbounded.

Span record (the ring element): ``(tids, stage, t0, dur_ms, extra)``
— ``tids`` a tuple of trace ids (batch stages carry every sampled
message of the batch), ``t0`` wall-clock seconds (cross-node
comparable), ``extra`` ``None`` or a small dict (flush spans carry
``clientid``). Stage names: ``ingress`` (submit → batch pickup),
``match`` (trie walk / device fetch), ``serialize`` (egress
pre-serialization), ``dispatch`` (plan → outbox enqueue), ``xloop``
(cross-loop delivery ring hand-off), ``publish`` (whole begin →
finish window), ``flush`` (stamp → connection flush, the
delivery-latency span slow_subs folds).

Stage intervals (the port's): while a batch is sampled, each of its
telemetry stages is also one record on the ring of the thread that ran
it, with no trace ids — ``((), stage, t0, dur_ms, args)``, ``args``
holding the batch's first trace id under ``batch`` — and
``monitors.SysMon`` records each full collection as a ``gc`` interval.
:meth:`Tracing.intervals` returns the retained ones as data, the export
writes them on rows of their own, and ``ctl profile stop`` lays them
over the profiler's trace (``profiling.stop_trace``).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from emqx_tpu_torch.concurrency import any_thread, bg_thread, owner_loop

_now = time.perf_counter

#: headers key carrying the trace context dict
TRACE_HEADER = "_trace"

#: the stage intervals that wait for another thread or task (their
#: own rows: other work of the same thread runs inside them);
#: collections get a row of their own as well, every other stage is
#: the thread's own work
WAIT_STAGES = frozenset({"queue", "fetch_wait", "order_wait",
                         "tail_yield"})

#: Knuth multiplicative hash constant (golden-ratio reciprocal)
_HASH_MULT = 0x9E3779B1
_HASH_MASK = 0xFFFFFFFF


@dataclasses.dataclass
class TracingConfig:
    """The ``[tracing]`` settings (the JAX package's defaults)."""

    enabled: bool = True
    # fraction of messages stamped with a trace context, by
    # deterministic hash of the message id. 0.0 = tracing fully off
    # (no context stamped, wire output byte-identical).
    sample_rate: float = 0.0
    # per-thread span ring capacity; overflow counts tracing.dropped
    ring_size: int = 4096
    # drained spans kept for :meth:`Tracing.export` (bounded)
    export_keep: int = 20000
    # slow_subs: per-clientid delivery-latency ranking
    slow_subs_enabled: bool = True
    slow_subs_top: int = 10
    slow_subs_threshold_ms: float = 500.0
    slow_subs_expiry_s: float = 300.0
    # consecutive stats ticks the worst ranked client must stay over
    # threshold before the `slow_subs` alarm activates
    slow_subs_alarm_ticks: int = 3
    # per-loop sampling profiler period
    profile_interval_ms: float = 10.0

    # knobs a live reload may change; ring sizes and enabled are
    # boot-only
    RELOADABLE = frozenset({
        "sample_rate", "slow_subs_top", "slow_subs_threshold_ms",
        "slow_subs_expiry_s", "slow_subs_alarm_ticks"})


class _SpanRing:
    """One thread's span buffer. Appended only by the owner thread;
    the drain (main loop) swaps ``buf`` wholesale — no lock, the
    list-attribute store is atomic under the GIL. ``dropped`` is
    cumulative; the drain folds deltas so a racing increment is
    counted next tick instead of lost."""

    __slots__ = ("name", "tid", "pthread", "cap", "buf", "dropped",
                 "drained_dropped")

    def __init__(self, name: str, cap: int) -> None:
        self.name = name
        # the thread as the profiler's trace names it: the OS thread
        # id (host ops), and the low 32 bits of the pthread id (the
        # CUDA runtime's records of threads other than the first)
        self.tid = threading.get_native_id()
        self.pthread = threading.get_ident() & 0xFFFFFFFF
        self.cap = cap
        self.buf: List[tuple] = []
        self.dropped = 0
        self.drained_dropped = 0

    def put(self, rec: tuple) -> None:
        if len(self.buf) >= self.cap:
            self.dropped += 1
            return
        self.buf.append(rec)


class _TraceBatch:
    """Trace state for one in-flight publish batch (rides
    ``PendingBatch.tbatch``). ``t0p``/``t0w`` anchor the perf-counter
    timeline to wall clock once per batch; ``t_mid`` marks the end of
    the match stage (start of dispatch)."""

    __slots__ = ("tids", "t0p", "t0w", "t_mid")

    def __init__(self, tids: Tuple[int, ...], t0p: float,
                 t0w: float) -> None:
        self.tids = tids
        self.t0p = t0p
        self.t0w = t0w
        self.t_mid: Optional[float] = None


class SlowSubs:
    """Per-clientid moving delivery-latency stats folded from flush
    spans: bounded top-N ranking with expiry and a sustained-breach
    alarm (the reference's ``emqx_slow_subs`` ETS ranking). Touched
    only from the drain (main loop) — no locking."""

    #: EWMA smoothing factor for the moving latency average
    ALPHA = 0.2

    def __init__(self, config: TracingConfig, alarms=None) -> None:
        self.config = config
        self.alarms = alarms
        # clientid -> [count, avg_ms (ewma), max_ms, last_seen_wall]
        self.clients: Dict[str, list] = {}
        self.breach_streak = 0
        # cumulative fold counters, read as deltas by the drain
        self.folded = 0
        self.breached = 0

    def fold(self, clientid: str, lat_ms: float, now_w: float) -> None:
        e = self.clients.get(clientid)
        if e is None:
            self.clients[clientid] = [1, lat_ms, lat_ms, now_w]
        else:
            e[0] += 1
            e[1] += (lat_ms - e[1]) * self.ALPHA
            if lat_ms > e[2]:
                e[2] = lat_ms
            e[3] = now_w
        self.folded += 1
        if lat_ms > self.config.slow_subs_threshold_ms:
            self.breached += 1

    def tick(self, now_w: float) -> None:
        """Stats-tick maintenance: expiry sweep, bound, alarm."""
        cfg = self.config
        cutoff = now_w - cfg.slow_subs_expiry_s
        stale = [cid for cid, e in self.clients.items() if e[3] < cutoff]
        for cid in stale:
            del self.clients[cid]
        # bound the table: a fan-in of unique clientids must not grow
        # it past a small multiple of the ranking window
        cap = max(64, cfg.slow_subs_top * 8)
        if len(self.clients) > cap:
            victims = sorted(self.clients.items(),
                             key=lambda kv: kv[1][1])
            for cid, _e in victims[:len(self.clients) - cap]:
                del self.clients[cid]
        rows = self.top(1)
        if rows and rows[0][1] > cfg.slow_subs_threshold_ms:
            self.breach_streak += 1
        else:
            self.breach_streak = 0
        if self.alarms is None:
            return
        if self.breach_streak >= cfg.slow_subs_alarm_ticks:
            cid, avg_ms = rows[0][0], rows[0][1]
            self.alarms.activate(
                "slow_subs",
                details={"clientid": cid,
                         "avg_ms": round(avg_ms, 3),
                         "threshold_ms": cfg.slow_subs_threshold_ms,
                         "ticks": self.breach_streak},
                message=(f"slow subscriber {cid}: avg delivery "
                         f"{avg_ms:.1f}ms over "
                         f"{cfg.slow_subs_threshold_ms:.0f}ms "
                         f"threshold for {self.breach_streak} ticks"))
        elif self.breach_streak == 0:
            self.alarms.deactivate("slow_subs")

    def top(self, n: Optional[int] = None) -> List[tuple]:
        """Ranking rows ``(clientid, avg_ms, max_ms, count,
        last_seen_wall)``, worst moving average first."""
        if n is None:
            n = self.config.slow_subs_top
        rows = [(cid, e[1], e[2], e[0], e[3])
                for cid, e in self.clients.items()]
        rows.sort(key=lambda r: r[1], reverse=True)
        return rows[:n]

    def reset(self) -> None:
        self.clients.clear()
        self.breach_streak = 0


class LoopProfiler:
    """Low-overhead continuous profiler over the front-door loop
    threads, the ingress executor, and the main loop: one sampler
    thread walks ``sys._current_frames()`` every ``interval_ms`` and
    folds matching threads' stacks into collapsed-stack counts
    (flamegraph.pl / speedscope input format). Never running unless
    started (:meth:`start`)."""

    #: profiled thread-name prefixes (MainThread matched exactly)
    PREFIXES = ("frontdoor-loop", "ingress-fetch")
    MAX_DEPTH = 64
    MAX_STACKS = 4096

    def __init__(self, interval_ms: float = 10.0) -> None:
        self.interval_ms = interval_ms
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()  # sampler vs. dump/reset
        self._counts: Dict[str, int] = {}
        self.samples = 0

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> bool:
        if self.running:
            return False
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name="loop-profiler", daemon=True)
        self._thread.start()
        return True

    def stop(self) -> bool:
        if not self.running:
            return False
        self._stop_evt.set()
        self._thread.join(2.0)
        self._thread = None
        return True

    @bg_thread
    def _run(self) -> None:
        interval = max(0.001, self.interval_ms / 1000.0)
        while not self._stop_evt.wait(interval):
            try:
                self._sample_once()
            except Exception:
                # a torn frame walk must never kill the sampler
                pass

    def _profiled(self, name: str) -> bool:
        return (name == "MainThread"
                or name.startswith(self.PREFIXES))

    def _sample_once(self) -> None:
        me = threading.get_ident()
        names = {t.ident: t.name for t in threading.enumerate()
                 if t.ident is not None and t.ident != me
                 and self._profiled(t.name)}
        frames = sys._current_frames()
        try:
            for ident, frame in frames.items():
                name = names.get(ident)
                if name is None:
                    continue
                stack = []
                f, depth = frame, 0
                while f is not None and depth < self.MAX_DEPTH:
                    co = f.f_code
                    stack.append(
                        f"{co.co_filename.rsplit('/', 1)[-1]}"
                        f":{co.co_name}")
                    f = f.f_back
                    depth += 1
                stack.reverse()
                key = name + ";" + ";".join(stack)
                with self._lock:
                    c = self._counts
                    if key in c or len(c) < self.MAX_STACKS:
                        c[key] = c.get(key, 0) + 1
                    else:
                        c["(other)"] = c.get("(other)", 0) + 1
                self.samples += 1
        finally:
            del frames  # drop the frame references promptly

    def collapsed(self, top: Optional[int] = None) -> str:
        """Folded-stack text: ``thread;frame;frame count`` per line,
        hottest first — flamegraph.pl-ready."""
        with self._lock:
            rows = sorted(self._counts.items(),
                          key=lambda kv: kv[1], reverse=True)
        if top is not None:
            rows = rows[:top]
        return "\n".join(f"{k} {v}" for k, v in rows)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
        self.samples = 0


class Tracing:
    """The node's tracing plane: sampling + stamping, per-thread span
    rings, the stats-tick drain, slow_subs, the loop profiler, and
    Chrome trace-event export. Always constructed on the node (like
    Telemetry), so ``node.tracing.config`` is there even when sampling
    is off."""

    def __init__(self, config: Optional[TracingConfig] = None,
                 metrics=None, alarms=None,
                 node: str = "local") -> None:
        self.config = config if config is not None else TracingConfig()
        self.metrics = metrics
        self.node = node
        self._local = threading.local()
        self._rings: List[_SpanRing] = []
        # ring registration only. Reentrant: a full collection can
        # start inside any allocation made under it, and the collector
        # hook's ``interval_at`` registers a ring for a thread that has
        # none (``monitors.SysMon``)
        self._reg_lock = threading.RLock()
        # drained spans held for export: (tids, stage, t0, dur, extra,
        # writer-thread name)
        self._export: List[tuple] = []
        self.slow = SlowSubs(self.config, alarms=alarms)
        self.profiler = LoopProfiler(self.config.profile_interval_ms)
        self.spans_total = 0
        self.dropped_total = 0
        self._slow_folded_seen = 0
        self._slow_breached_seen = 0
        # sampling threshold cache (sample_rate is reloadable)
        self._rate_cached = -1.0
        self._threshold = 0

    # -- sampling / stamping (any thread) -----------------------------

    @property
    def active(self) -> bool:
        cfg = self.config
        return cfg.enabled and cfg.sample_rate > 0.0

    def sampled(self, mid: int) -> bool:
        rate = self.config.sample_rate
        if rate != self._rate_cached:
            self._rate_cached = rate
            self._threshold = int(
                min(1.0, max(0.0, rate)) * (_HASH_MASK + 1))
        return ((mid * _HASH_MULT) & _HASH_MASK) < self._threshold

    @any_thread
    def stamp(self, msg) -> Optional[dict]:
        """Stamp a trace context on a sampled message (idempotent —
        a context that arrived with the message, e.g. over a cluster
        forward, is kept). Returns the context or ``None``."""
        ctx = msg.headers.get(TRACE_HEADER)
        if ctx is not None:
            return ctx
        if not self.sampled(msg.id):
            return None
        ctx = {"tid": msg.id, "t0": time.time(), "node": self.node}
        msg.headers[TRACE_HEADER] = ctx
        return ctx

    # -- span recording (owner thread of the calling seam) ------------

    def _ring(self) -> _SpanRing:
        r = getattr(self._local, "ring", None)
        if r is None:
            r = _SpanRing(threading.current_thread().name,
                          self.config.ring_size)
            self._local.ring = r
            with self._reg_lock:
                self._rings.append(r)
        return r

    @any_thread
    def batch_begin(self, ctxs: List[dict]) -> _TraceBatch:
        """Open the batch timeline for the sampled messages of one
        publish batch; records the ``ingress`` span (submit-stamp →
        batch pickup wait)."""
        t0p, t0w = _now(), time.time()
        tids = tuple(c["tid"] for c in ctxs)
        tb = _TraceBatch(tids, t0p, t0w)
        t_min = min(c["t0"] for c in ctxs)
        self._ring().put(
            (tids, "ingress", t_min, max(0.0, (t0w - t_min) * 1000.0),
             None))
        return tb

    @any_thread
    def span_mark(self, tb: _TraceBatch, stage: str,
                  t_start: float) -> None:
        """Record ``stage`` from perf-counter mark ``t_start`` to now
        for every sampled message of the batch."""
        dur = (_now() - t_start) * 1000.0
        t0w = tb.t0w + (t_start - tb.t0p)
        self._ring().put((tb.tids, stage, t0w, dur, None))

    @any_thread
    def mark_match(self, tb: _TraceBatch, t_start: float) -> None:
        """The match span; its end anchors the dispatch span."""
        self.span_mark(tb, "match", t_start)
        tb.t_mid = _now()

    @any_thread
    def span_abs(self, tb: _TraceBatch, stage: str, t_start: float,
                 dur_ms: float) -> None:
        """Record ``stage`` with an explicit duration (the xloop
        hand-off window is timed by the planner itself)."""
        t0w = tb.t0w + (t_start - tb.t0p)
        self._ring().put((tb.tids, stage, t0w, dur_ms, None))

    @any_thread
    def interval(self, tb: _TraceBatch, stage: str, t0: float, t1: float,
                 args: Optional[dict] = None) -> None:
        """One publish stage of a sampled batch, perf-counter ``t0``
        to ``t1``, on the calling thread's ring (no trace ids: one
        record a batch, the batch's first trace id in ``args``)."""
        a = {"batch": tb.tids[0]}
        if args:
            a.update(args)
        self._ring().put(((), stage, tb.t0w + (t0 - tb.t0p),
                          (t1 - t0) * 1000.0, a))

    @any_thread
    def interval_at(self, stage: str, t0w: float, dur_ms: float) -> None:
        """One interval from wall-clock ``t0w`` on the calling
        thread's ring (a full collection, which belongs to no
        batch)."""
        self._ring().put(((), stage, t0w, dur_ms, None))

    @any_thread
    def close_batch(self, tb: _TraceBatch) -> None:
        """Finish the batch: ``dispatch`` (match end → done) and
        ``publish`` (whole window) spans."""
        now_p = _now()
        t_mid = tb.t_mid if tb.t_mid is not None else tb.t0p
        self._ring().put(
            (tb.tids, "dispatch", tb.t0w + (t_mid - tb.t0p),
             (now_p - t_mid) * 1000.0, None))
        self._ring().put(
            (tb.tids, "publish", tb.t0w, (now_p - tb.t0p) * 1000.0,
             None))

    @any_thread
    def flush_mark(self, ctx: dict, clientid: str) -> None:
        """Record the egress-flush span for one traced delivery: the
        stamp → connection-flush window, i.e. the delivery latency
        slow_subs ranks this client by. Runs on the connection's
        owner loop; writes only that thread's ring."""
        try:
            tid, t0 = ctx["tid"], ctx["t0"]
        except (TypeError, KeyError):
            return
        lat = max(0.0, (time.time() - t0) * 1000.0)
        self._ring().put(
            ((tid,), "flush", t0, lat, {"clientid": clientid}))

    # -- drain (stats tick, main loop) --------------------------------

    @owner_loop
    def drain_tick(self, stats=None) -> int:
        """Swap every ring's buffer out, fold flush spans into
        slow_subs, bump counters, retain spans for export. The only
        cross-thread reads are the buffer swap (atomic store) and the
        cumulative dropped counters (delta-folded)."""
        cfg = self.config
        now_w = time.time()
        drained = self.collect(now_w)
        m = self.metrics
        if cfg.slow_subs_enabled:
            self.slow.tick(now_w)
            if m is not None:
                df = self.slow.folded - self._slow_folded_seen
                db = self.slow.breached - self._slow_breached_seen
                self._slow_folded_seen = self.slow.folded
                self._slow_breached_seen = self.slow.breached
                if df:
                    m.inc("slow_subs.flushes", df)
                if db:
                    m.inc("slow_subs.breaches", db)
        if stats is not None:
            stats.setstat("tracing.spans.pending", len(self._export))
            rows = self.slow.top(1)
            stats.setstat("slow_subs.tracked", len(self.slow.clients))
            stats.setstat("slow_subs.worst_ms",
                          round(rows[0][1], 3) if rows else 0)
        return drained

    @owner_loop
    def collect(self, now_w: Optional[float] = None) -> int:
        """The drain's ring swap alone (no slow_subs tick, no gauges):
        every ring's records into the retained spans, flush spans
        folded, the tracing counters bumped. ``ctl profile stop``
        takes it before reading :meth:`intervals`."""
        cfg = self.config
        if now_w is None:
            now_w = time.time()
        with self._reg_lock:
            rings = list(self._rings)
        drained = 0
        dropped = 0
        slow_on = cfg.slow_subs_enabled
        for ring in rings:
            buf = ring.buf
            if buf:
                ring.buf = []
                drained += len(buf)
                for rec in buf:
                    self._export.append(rec + (ring.name,))
                    if slow_on and rec[1] == "flush":
                        self.slow.fold(rec[4]["clientid"], rec[3],
                                       now_w)
            d = ring.dropped - ring.drained_dropped
            if d:
                ring.drained_dropped += d
                dropped += d
        if len(self._export) > cfg.export_keep:
            del self._export[:len(self._export) - cfg.export_keep]
        self.spans_total += drained
        self.dropped_total += dropped
        m = self.metrics
        if m is not None:
            if drained:
                m.inc("tracing.spans", drained)
            if dropped:
                m.inc("tracing.dropped", dropped)
        return drained

    def intervals(self) -> List[tuple]:
        """The retained stage intervals as data, in drain order:
        ``(stage, thread name, OS thread id, t0, t1, args)``, times
        in wall-clock seconds (:meth:`collect` first to include what
        the rings still hold)."""
        with self._reg_lock:
            tids = {r.name: r.tid for r in self._rings}
        return [(stage, writer, tids.get(writer, 0), t0,
                 t0 + dur_ms / 1000.0, extra)
                for ids, stage, t0, dur_ms, extra, writer in self._export
                if not ids]

    def interval_events(self, t_lo: float, t_hi: float, shift_us: float,
                        pid: int, tid_base: int) -> List[dict]:
        """Chrome trace events of the retained intervals that overlap
        wall-clock ``[t_lo, t_hi]``: ``ts`` is the wall clock in
        microseconds plus ``shift_us``; each thread's work, waits and
        collections on rows of their own (``tid_base`` up, named by
        ``M`` events), since a wait holds other work of its thread."""
        with self._reg_lock:
            ids = {r.name: (r.tid, r.pthread) for r in self._rings}
        rows: Dict[tuple, int] = {}
        events: List[dict] = []
        for tids, stage, t0, dur_ms, extra, writer in self._export:
            if tids or t0 + dur_ms / 1000.0 < t_lo or t0 > t_hi:
                continue
            kind = ("waits" if stage in WAIT_STAGES
                    else "gc" if stage == "gc" else "stages")
            row = rows.get((writer, kind))
            if row is None:
                row = rows[(writer, kind)] = tid_base + len(rows)
                events.append({"name": "thread_name", "ph": "M",
                               "pid": pid, "tid": row,
                               "args": {"name": f"{writer} {kind}"}})
            os_tid, pthread = ids.get(writer, (0, 0))
            args = {"thread": writer, "os_tid": os_tid,
                    "pthread": pthread}
            if extra:
                args.update(extra)
                if "batch" in args:
                    args["batch"] = format(args["batch"] & 0xFFFFFFFFFFFF,
                                           "x")
            events.append({"name": stage, "cat": "stage", "ph": "X",
                           "ts": round(t0 * 1e6 + shift_us, 3),
                           "dur": round(dur_ms * 1000.0, 3),
                           "pid": pid, "tid": row, "args": args})
        return events

    # -- export ---------------------------------------------------------

    def export(self, path: str) -> int:
        """Write the retained spans as Chrome trace-event JSON
        (``chrome://tracing`` / Perfetto loadable): one ``X`` event
        per (span, trace id), writer threads named via ``M`` metadata
        events, the stage intervals on rows of their own; ``ts`` is
        the wall clock in microseconds, so the file lines up with
        other traces of the same hosts. The loop profiler's hottest
        collapsed stacks ride in ``otherData`` so one artifact names
        both stage and frames."""
        spans = list(self._export)
        writers: Dict[str, int] = {}
        events: List[dict] = []
        for tids, stage, t0, dur_ms, extra, writer in spans:
            if not tids:
                continue  # a stage interval: interval_events below
            wid = writers.setdefault(writer, len(writers) + 1)
            for tid in tids:
                ev = {"name": stage, "cat": "emqx_tpu_torch", "ph": "X",
                      "ts": round(t0 * 1e6, 1),
                      "dur": round(dur_ms * 1000.0, 1),
                      "pid": 1, "tid": wid,
                      "args": {"trace": format(tid & 0xFFFFFFFFFFFF,
                                               "x")}}
                if extra:
                    ev["args"].update(extra)
                events.append(ev)
        for name, wid in writers.items():
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": wid, "args": {"name": name}})
        events += self.interval_events(float("-inf"), float("inf"), 0.0,
                                       1, len(writers) + 1)
        prof = self.profiler
        other: Dict[str, Any] = {"node": self.node,
                                 "spans": len(spans)}
        if prof.samples:
            other["profile_samples"] = prof.samples
            other["profile"] = prof.collapsed(top=40)
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": other}
        with open(path, "w") as f:
            json.dump(doc, f)
        return len(events)

    def reset(self) -> None:
        self._export.clear()
        self.slow.reset()
        self.spans_total = 0
