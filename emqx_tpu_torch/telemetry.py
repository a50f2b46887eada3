"""Publish-path pipeline telemetry: per-stage latency histograms,
per-batch span records, and the slow-publish log (the port of the JAX
package's ``telemetry.py``).

The reference broker attributes production latency with BEAM VM
introspection and system monitors (SURVEY §5 "Tracing/profiling",
``emqx_vm.erl``, long_gc/long_schedule); the publish path here is a
*pipeline* — host pre-work → device walk / match-cache gather →
fan-out/pack dispatch → ONE coalesced transfer → host delivery tail —
so the question is "which STAGE did this batch spend its time in".
This module answers it with:

  - :class:`Histogram` — fixed log-spaced latency buckets (Prometheus
    ``_bucket``/``_sum``/``_count`` exposition) plus a ring buffer of
    raw samples for exact p50/p95/p99 over the recent window
    (single-writer, like :class:`~emqx_tpu_torch.metrics.Metrics`);
  - :class:`PublishSpan` — one per :class:`~emqx_tpu_torch.broker
    .PendingBatch`, stamped through ``publish_begin`` →
    ``publish_fetch`` → ``publish_finish`` (and the host and chunked
    ingress variants), tagged with batch size, unique-topic count,
    cache hit/miss split, host-fallback count and the padding bucket;
  - :class:`Telemetry` — the per-node registry: folds finished spans
    into the stage histograms, keeps the last-N slow batches, emits
    the slow-publish log line (plus a tee through the
    :class:`~emqx_tpu_torch.tracer.Tracer`) and drives the
    sustained-breach :class:`~emqx_tpu_torch.alarm.AlarmManager` alarm.

Stage semantics (all host wall-clock, milliseconds):

  ``match``          the NFA walk's dispatch (device regime: encode,
                     the batch's copy to the card and the kernel
                     launch, NOT the kernel's execution — that
                     surfaces in ``fetch``); host regime: the actual
                     trie walk.
  ``cache_gather``   match-cache probe + row-merge dispatch
                     (cache-split batches only).
  ``pack``           fan-out + sparse-compaction dispatch.
  ``fetch``          the ONE coalesced device→host copy — the
                     synchronizing stage, so queued device execution
                     surfaces here. No NEW synchronization is added
                     anywhere: spans only read the clock at boundaries
                     the pipeline already crosses.
  ``dispatch_plan``  the dispatch planner's numpy grouping pass
                     (ops/dispatch_plan.py), right after the copy, on
                     the same (possibly executor) thread. Zero when
                     the planner is off or the batch fell back.
  ``serialize``      egress pre-serialization
                     (ops/dispatch_plan.preserialize_plan), right
                     after the plan, on the same thread. Zero when
                     ``DispatchConfig.preserialize`` is off or the
                     batch didn't plan.
  ``host_fallback``  overflow topics re-matched on the host trie
                     during the delivery tail (a subset of
                     ``dispatch``, recorded apart).
  ``dispatch``       the host delivery tail, summed over chunks.
  ``xloop``          the cross-loop delivery ring (first handoff
                     posted → last one reported back); absent on a
                     one-loop node.
  ``rebuild``        automaton compaction / re-flatten durations,
                     inline and background (observed directly, not a
                     span stage).
  ``end_to_end``     ``publish_begin`` entry → last delivery chunk.

The port's stages past the JAX package's, which close the rest of a
batch's life (on a device batch under the ingress batcher,
``begin_host`` + ``match`` + ``cache_gather`` + ``pack`` +
``fetch_wait`` + ``fetch`` + ``dispatch_plan`` + ``serialize`` +
``order_wait`` + ``dispatch`` + ``tail_yield`` + ``ack`` is the time
from ``publish_begin`` entry to the last acknowledgement set):

  ``queue``          mean, over the batch's messages, of
                     ``IngressBatcher.submit`` → ``publish_begin``
                     entry (loop).
  ``begin_host``     ``publish_begin`` outside ``match``,
                     ``cache_gather`` and ``pack``: hooks, veto,
                     metrics, dedup (loop).
  ``fetch_wait``     ``publish_begin`` return → ``publish_fetch``
                     entry: the executor's queue and the interpreter
                     lock (executor).
  ``order_wait``     ``publish_fetch`` return → the first delivery
                     chunk: the predecessor's tail and the loop's turn
                     (loop).
  ``tail_yield``     first delivery chunk → last chunk's end, less
                     the chunks' own time: the loop's other work
                     between chunks (loop).
  ``ack``            last chunk's end → the batch's acknowledgement
                     futures set; on a multi-loop node it holds the
                     cross-loop join (loop).
  ``gc``             each full (generation 2) collection's pause, from
                     ``monitors.SysMon``'s collector hook (any
                     thread, not a span stage); a span's ``gc_ms`` tag
                     is the collection time inside its life.
  ``fetch_cpu``      thread CPU time of ``fetch`` + ``dispatch_plan``
                     + ``serialize`` (executor).
  ``dispatch_cpu``   thread CPU time of the delivery chunks (loop).

The ingress batcher holds its batches' spans (``PublishSpan.held``):
the last chunk stamps ``end_to_end``'s end, and the batcher folds the
span once the acknowledgements are set. While tracing samples a batch
(``pb.tbatch``), each stage is also recorded as an interval on the
ring of the thread that ran it (:meth:`PublishSpan.interval`,
``tracing.Tracing.interval``).

Where the port's stages read differently from the TPU's: on CUDA the
host→device copies inside ``match`` (the encoded batch,
``Router._place``) and ``cache_gather`` (the cache's slot and row
indices, ``ops/match_cache.py``) are copies from pageable host memory,
which wait for the work already queued on the stream; a stage then
holds some device time queued before it. No sync is added or removed
to make it match.

Cost model: disabled (``TelemetryConfig(enabled=False)``) the broker
takes one predicate branch per batch and records nothing — the
deliveries are identical to the enabled run's (pinned by
tests/test_torch_telemetry.py). Enabled, the cost is a handful of
``perf_counter`` reads per batch, two thread-CPU clock reads per
stage that has a ``_cpu`` twin (each delivery chunk), and the ingress
batcher's one ``perf_counter`` read per submitted message (disabled,
one branch per message in its place). This module
imports no torch: it never touches a tensor.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional

log = logging.getLogger("emqx_tpu_torch.telemetry")

#: guards direct (cross-thread) stage observes — see
#: :meth:`Telemetry.observe_stage`; span folds stay lock-free
#: (single-writer on the event loop). Reentrant: the collector hook
#: observes ``gc`` on whichever thread a collection interrupts, which
#: may be inside an observe on this same lock
_observe_lock = threading.RLock()

#: the publish pipeline's stage names, in pipeline order (ctl and the
#: $SYS heartbeat render in this order; Prometheus sorts its own).
#: ``rebuild`` is the one non-span stage: automaton compaction /
#: re-flatten durations (inline and background), observed directly
#: via :meth:`Telemetry.observe_stage` — it shares the histogram
#: surfaces so a churn-driven rebuild storm shows up next to the
#: publish latencies it would otherwise silently explain
STAGES = ("match", "cache_gather", "pack", "fetch", "dispatch_plan",
          "serialize", "host_fallback", "dispatch", "xloop",
          "rebuild", "end_to_end",
          # the port's: the rest of a batch's life, the full
          # collections, and CPU against wall
          "queue", "begin_host", "fetch_wait", "order_wait",
          "tail_yield", "ack", "gc", "fetch_cpu", "dispatch_cpu")

#: the stages past the JAX package's (``STAGES`` ends with them)
PORT_STAGES = STAGES[11:]

#: fixed log-spaced bucket upper bounds, milliseconds (1-2.5-5 per
#: decade, 10µs..5s). Fixed — not adaptive — so scrapes from
#: different nodes/epochs aggregate; the raw-sample ring carries the
#: exact percentiles the coarse buckets can't.
BUCKETS_MS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
              10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
              2500.0, 5000.0)

_now = time.perf_counter
#: this thread's CPU clock (``fetch_cpu``, ``dispatch_cpu``)
cpu_ns = time.thread_time_ns


@dataclasses.dataclass
class TelemetryConfig:
    """The ``[telemetry]`` settings (the JAX package's defaults)."""

    enabled: bool = True
    #: end-to-end batch latency past this emits one slow-publish log
    #: line (and counts toward the sustained-breach alarm)
    slow_threshold_ms: float = 100.0
    #: per-stage raw-sample ring size (exact p50/p99 window)
    ring_size: int = 2048
    #: how many slow-batch records ``ctl telemetry slow`` keeps
    slow_log_size: int = 64
    #: consecutive slow batches before the AlarmManager alarm fires
    #: (one slow batch is a blip; a streak is a regime)
    slow_alarm_after: int = 10

    #: knobs read per span (a live reload may change them);
    #: ``enabled``/``ring_size``/``slow_log_size`` shape the
    #: histograms and the slow-record ring at build (not a dataclass
    #: field: unannotated)
    RELOADABLE = frozenset({"slow_threshold_ms", "slow_alarm_after"})


class Histogram:
    """One latency family: fixed log-bucket counts + sum/count for
    the Prometheus exposition, and a bounded ring of raw samples for
    exact recent percentiles. Single-writer (the event loop folds
    finished spans); plain ints/floats, no locks — same discipline as
    the Metrics counter array."""

    __slots__ = ("bounds", "counts", "sum", "count", "ring")

    def __init__(self, ring_size: int = 2048,
                 bounds=BUCKETS_MS) -> None:
        self.bounds = bounds
        self.counts = [0] * len(bounds)  # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0
        self.ring: deque = deque(maxlen=max(1, ring_size))

    def observe(self, ms: float) -> None:
        # linear scan beats bisect at 18 buckets, and the common case
        # (sub-ms stages) exits in the first few probes
        for i, b in enumerate(self.bounds):
            if ms <= b:
                self.counts[i] += 1
                break
        self.sum += ms
        self.count += 1
        self.ring.append(ms)

    def percentile(self, q: float) -> float:
        """Exact percentile over the raw-sample ring (0 when empty)."""
        if not self.ring:
            return 0.0
        xs = sorted(self.ring)
        # nearest-rank on the sorted window — matches numpy's
        # 'lower' interpolation within one sample
        idx = min(len(xs) - 1, int(q / 100.0 * len(xs)))
        return xs[idx]

    def snapshot(self) -> dict:
        """Prometheus-shaped view: CUMULATIVE ``(le, count)`` pairs
        (``+Inf`` is implicit — it equals ``count``), plus sum/count."""
        cum = []
        acc = 0
        for b, c in zip(self.bounds, self.counts):
            acc += c
            cum.append((b, acc))
        return {"buckets": cum, "sum": self.sum, "count": self.count}

    def stats(self) -> dict:
        return {
            "count": self.count,
            "p50_ms": self.percentile(50),
            "p95_ms": self.percentile(95),
            "p99_ms": self.percentile(99),
            "sum_ms": self.sum,
        }

    def reset(self) -> None:
        self.counts = [0] * len(self.bounds)
        self.sum = 0.0
        self.count = 0
        self.ring.clear()


class PublishSpan:
    """Per-batch stage stopwatch + tags. Created by
    :meth:`Telemetry.begin`, carried on ``PendingBatch.span``, closed
    by :meth:`Telemetry.finish` when the last delivery chunk lands.

    Writers hand off in pipeline order (begin on the event loop,
    fetch possibly on an executor thread, finish back on the loop) —
    the ingress pipeline sequences those with happens-before edges,
    so no stage field is ever written concurrently."""

    __slots__ = ("t0", "stages", "batch", "n_uniq", "bucket", "path",
                 "cache_hit", "cache_miss", "fallbacks", "topic",
                 "closed", "t_ready", "t_end", "held", "gc0", "gc_ms",
                 "trc", "tb")

    def __init__(self, batch: int) -> None:
        self.t0 = _now()
        self.stages: Dict[str, float] = {}
        self.batch = batch
        self.n_uniq = 0
        self.bucket = 0          # device padding bucket (0 = host)
        self.path = "device"     # device | host | mesh
        self.cache_hit = -1      # -1 = batch wasn't cache-split
        self.cache_miss = -1
        self.fallbacks = 0
        self.topic: Optional[str] = None  # sample (tracer tee)
        self.closed = False
        # the batch's hand-off marks: ``t_ready`` the end of its last
        # phase (begin, then fetch), ``t_end`` the last delivery
        # chunk's (0.0 until then)
        self.t_ready = 0.0
        self.t_end = 0.0
        # held by the ingress batcher, which folds the span after the
        # acknowledgements (the last chunk only stamps ``t_end``)
        self.held = False
        # the node's collection total at begin, and the collection
        # time inside the span's life (set when it folds)
        self.gc0 = 0.0
        self.gc_ms = 0.0
        # the tracing plane and trace batch while the batch is
        # sampled (then each stage is also an interval), else None
        self.trc = None
        self.tb = None

    @staticmethod
    def clock() -> float:
        return _now()

    def add(self, stage: str, t_start: float) -> float:
        """Accumulate ``now - t_start`` into a stage (chunked stages
        call this once per chunk) and return now, the stage's end."""
        now = _now()
        self.stages[stage] = self.stages.get(stage, 0.0) + \
            (now - t_start) * 1000.0
        if self.tb is not None:
            self.interval(stage, t_start, now)
        return now

    def add_ms(self, stage: str, ms: float) -> None:
        self.stages[stage] = self.stages.get(stage, 0.0) + ms

    def trace(self, trc, tb) -> None:
        """Record this batch's stages as intervals too (a sampled
        batch: ``tb`` is its ``tracing._TraceBatch``)."""
        self.trc = trc
        self.tb = tb

    def interval(self, stage: str, t0: float, t1: float,
                 args: Optional[dict] = None) -> None:
        """One interval of ``stage`` on the calling thread's ring
        (perf-counter ``t0``..``t1``); a sampled batch only."""
        self.trc.interval(self.tb, stage, t0, t1, args)

    def stamp_match(self, router, t_start: float) -> None:
        """Close the match-dispatch stage, splitting out the
        cache-gather share when the router's cache-split path left
        its per-dispatch info (set only while telemetry is enabled —
        see Router._match_dispatch_cached)."""
        now = _now()
        total = (now - t_start) * 1000.0
        info = router._last_dispatch
        gather = 0.0
        if info is not None:
            router._last_dispatch = None
            self.cache_hit = info["hit"]
            self.cache_miss = info["miss"]
            gather = min(total, info["cache_gather_ms"])
            self.add_ms("cache_gather", gather)
        self.add_ms("match", total - gather)
        if self.tb is not None:
            # one interval: the cache's probe and merge run inside the
            # match call, their share rides as an argument
            self.interval("match", t_start, now,
                          {"cache_gather_ms": gather} if info else None)

    def end_begin(self) -> None:
        """``publish_begin`` returns: its time outside ``match``,
        ``cache_gather`` and ``pack`` is ``begin_host``; the batch is
        ready for its fetch."""
        now = _now()
        st = self.stages
        inner = st.get("match", 0.0) + st.get("cache_gather", 0.0) + \
            st.get("pack", 0.0)
        self.add_ms("begin_host", (now - self.t0) * 1000.0 - inner)
        if self.tb is not None:
            # one interval for the whole begin: its stages' intervals
            # nest inside it on the thread's row
            self.interval("begin_host", self.t0, now)
        self.t_ready = now

    def record(self) -> dict:
        """The structured form (slow log / ctl telemetry slow)."""
        rec = {
            "batch": self.batch,
            "n_uniq": self.n_uniq,
            "path": self.path,
            "bucket": self.bucket,
            "fallbacks": self.fallbacks,
            "gc_ms": round(self.gc_ms, 3),
            "stages_ms": {k: round(v, 3)
                          for k, v in self.stages.items()},
        }
        if self.cache_hit >= 0:
            rec["cache_hit"] = self.cache_hit
            rec["cache_miss"] = self.cache_miss
        if self.topic is not None:
            rec["topic"] = self.topic
        return rec


class Telemetry:
    """Per-node telemetry registry (wired by Node onto broker +
    router + ``$SYS``). Histogram folds and the slow ring are
    single-writer — finished spans land on the event loop, the same
    place the Metrics counters mutate."""

    def __init__(self, config: Optional[TelemetryConfig] = None,
                 tracer=None, alarms=None,
                 node: str = "local") -> None:
        self.config = config or TelemetryConfig()
        self.tracer = tracer
        self.alarms = alarms
        self.node = node
        self.hists: Dict[str, Histogram] = {
            s: Histogram(self.config.ring_size) for s in STAGES}
        self.spans_total = 0
        self.slow_total = 0
        self._slow_streak = 0
        self._slow_ring: deque = deque(
            maxlen=max(1, self.config.slow_log_size))
        # milliseconds of full collections so far (the ``gc`` stage's
        # running sum, which the spans' ``gc_ms`` tags difference)
        self.gc_ms_total = 0.0

    @property
    def enabled(self) -> bool:
        return self.config.enabled

    # -- span lifecycle ---------------------------------------------------

    def begin(self, batch: int) -> Optional[PublishSpan]:
        """A new span, or None when disabled (the broker stores the
        None and every instrumented section reduces to one ``is not
        None`` branch — the near-zero disabled cost)."""
        if not self.config.enabled:
            return None
        sp = PublishSpan(batch)
        sp.gc0 = self.gc_ms_total
        return sp

    def finish(self, span: PublishSpan) -> None:
        """Fold a finished span into the stage histograms; slow-log /
        alarm on threshold breach. Idempotent (the chunked delivery
        tail and the one-shot finish can both reach the end).
        ``end_to_end`` ends at the last delivery chunk: ``span.t_end``
        where the batcher held the span, else now."""
        if span.closed:
            return
        span.closed = True
        e2e = ((span.t_end or _now()) - span.t0) * 1000.0
        span.stages["end_to_end"] = e2e
        span.gc_ms = self.gc_ms_total - span.gc0
        for stage, ms in span.stages.items():
            h = self.hists.get(stage)
            if h is not None:
                h.observe(ms)
        self.spans_total += 1
        if e2e >= self.config.slow_threshold_ms:
            self._slow(span, e2e)
        else:
            self._slow_streak = 0
            if self.alarms is not None:
                self.alarms.deactivate("slow_publish")

    def _slow(self, span: PublishSpan, e2e: float) -> None:
        self.slow_total += 1
        self._slow_streak += 1
        rec = span.record()
        rec["end_to_end_ms"] = round(e2e, 3)
        rec["ts"] = time.time()
        self._slow_ring.append(rec)
        # ONE structured line per slow batch — a saturated broker must
        # not drown its own logs, and the ring keeps the rest
        log.warning("slow publish batch: %s", json.dumps(rec))
        if self.tracer is not None:
            self.tracer.trace_slow_publish(rec)
        if (self.alarms is not None
                and self._slow_streak >= self.config.slow_alarm_after):
            self.alarms.activate(
                "slow_publish",
                details={"streak": self._slow_streak,
                         "threshold_ms": self.config.slow_threshold_ms,
                         "last": rec},
                message=(f"publish end-to-end latency over "
                         f"{self.config.slow_threshold_ms}ms for "
                         f"{self._slow_streak} consecutive batches"))

    def observe_stage(self, stage: str, ms: float) -> None:
        """Record one direct (non-span) stage sample — the rebuild
        histogram's entry point. Unlike span folds this may be called
        from the background compaction thread, so it takes a small
        lock (rebuilds are rare and ms-scale; the cost is noise)."""
        if not self.config.enabled:
            return
        h = self.hists.get(stage)
        if h is None:
            return
        with _observe_lock:
            h.observe(ms)

    def observe_gc(self, ms: float) -> None:
        """One full collection's pause (``monitors.SysMon``'s
        collector hook, on whichever thread collected): the ``gc``
        stage and the total the open spans' ``gc_ms`` difference.
        Collections never overlap, so the total has one writer."""
        self.gc_ms_total += ms
        self.observe_stage("gc", ms)

    # -- read surfaces ----------------------------------------------------

    def stage_stats(self) -> Dict[str, dict]:
        """Per-stage count/p50/p95/p99 from the sample rings — the
        ctl table and the $SYS heartbeat both read this."""
        return {s: self.hists[s].stats() for s in STAGES}

    def histograms(self) -> Dict[str, dict]:
        """Prometheus families: ``emqx_tpu_publish_stage_<stage>_ms``
        → cumulative-bucket snapshots (modules/prometheus.render)."""
        return {f"emqx_tpu_publish_stage_{s}_ms": self.hists[s].snapshot()
                for s in STAGES}

    def slow_records(self) -> List[dict]:
        """The last-N slow batches, oldest first."""
        return list(self._slow_ring)

    def reset(self) -> None:
        for h in self.hists.values():
            h.reset()
        self.spans_total = 0
        self.slow_total = 0
        self._slow_streak = 0
        self._slow_ring.clear()
