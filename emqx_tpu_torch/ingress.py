"""Ingress publish batcher: per-tick aggregation across connections.

The port of the JAX package's ``IngressBatcher``. The reference
ingests one message per connection-process receive; here batching is
the ingress design: every connection's PUBLISH lands in one shared
accumulator, and the whole batch goes through the broker's three-phase
batched publish — one device match (kernel B1), fan-out and bitmap OR
(kernel B2) for all messages that arrived in the same event-loop tick.
QoS1/2 acks (PUBACK/PUBREC) complete when the batch returns, so the
wire contract is unchanged.

Pipelining: ``publish_begin`` runs on the event loop and enqueues the
device work; ``publish_fetch`` (the one device→host copy and the
dispatch plan) runs on an executor thread while the loop keeps parsing
sockets. Both sides enqueue on the device's default stream, so the
copy follows the kernels the begin enqueued. Up to ``max_inflight``
batches overlap; delivery stays ordered: batch N+1's delivery tail
awaits batch N's.

Flush policy: a batch flushes when it reaches ``batch_size``, else on
the next event-loop iteration (``call_soon``), or after ``linger_ms``
when set (bigger device batches under light load, for latency). When
all ``max_inflight`` slots are busy, arrivals keep accumulating and
flush as a bigger batch, of at most ``batch_cap`` messages, when a
slot frees. The constructor's defaults are the JAX package's:
``max_inflight`` :data:`MAX_INFLIGHT`, ``batch_cap`` :data:`CAP_BATCHES`
× ``batch_size``, ``queue_hiwater`` one batch, ``finish_chunk``
:data:`FINISH_CHUNK`.

Telemetry: while it is on, each submit stamps the clock beside its
pending entry (0.0 while it is off);
the batcher holds the spans of the batches it completes and stamps the
stages between the broker's phases — ``queue`` (submit → begin, the
batch's mean), ``order_wait`` (fetch done → first delivery chunk),
``tail_yield`` (the loop's other work between chunks) and ``ack`` (last
chunk → futures set) — then folds the span (``telemetry.py``).

Callers without a running event loop (sync callers, sans-IO tests)
get ``None`` from :meth:`submit` and publish inline. On a multi-loop
node (:meth:`bind_multiloop`) several front-door loops feed the one
accumulator: appends take a lock, flushes run on the home loop (the
node's main loop, where every kernel of a publish batch is launched),
and each ack future resolves on its own loop.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from emqx_tpu_torch import faults
from emqx_tpu_torch.concurrency import any_thread, owner_loop, shared_state
from emqx_tpu_torch.device import resolve
from emqx_tpu_torch.types import Message

_now = time.perf_counter

log = logging.getLogger("emqx_tpu_torch.ingress")


#: default batches in flight at once (begun, not yet delivered)
MAX_INFLIGHT = 4
#: default largest batch one flush takes, in batch sizes
CAP_BATCHES = 4
#: default finished rows (or subscriber groups) between the delivery
#: tail's yields to the event loop
FINISH_CHUNK = 64


@shared_state(lock="_plock", attrs=("_pending",))
class IngressBatcher:
    def __init__(self, broker, batch_size: int = 256,
                 linger_ms: float = 0.0, max_inflight: int = MAX_INFLIGHT,
                 batch_cap: int = 0, queue_hiwater: int = 0,
                 finish_chunk: int = FINISH_CHUNK, device=None) -> None:
        # the batcher feeds the broker's device path: like every entry
        # point it runs on CUDA unless the caller asks for the CPU,
        # and on the broker's device
        dev = resolve(device)
        if dev != broker.device:
            raise ValueError(f"IngressBatcher on {dev} for a broker on "
                             f"{broker.device}")
        self.broker = broker
        self.batch_size = batch_size
        self.linger_ms = linger_ms
        self.max_inflight = max(1, max_inflight)
        # the largest batch one flush takes (0 = CAP_BATCHES batches)
        self.batch_cap = batch_cap or batch_size * CAP_BATCHES
        # accumulator high-water mark (0 = one batch): past it,
        # connections pause their read loops (wait_ready) until a flush
        # drains the backlog — the reference bounds per-connection
        # ingest with active_n (src/emqx_connection.erl:99); the
        # standing queue then lives in the publishers' TCP buffers
        self.queue_hiwater = queue_hiwater or batch_size
        # the delivery tail yields to the loop every this many units
        self.finish_chunk = max(1, finish_chunk)
        # (message, ack future or None, submit clock or 0.0 while
        # telemetry is off)
        self._pending: List[Tuple[Message, Optional[asyncio.Future],
                                  float]] = []
        self._handle = None
        self._inflight = 0
        self._chain: Optional[asyncio.Task] = None  # ordered delivery
        self._pool: Optional[ThreadPoolExecutor] = None
        self._ready: Optional[asyncio.Event] = None
        # multi-loop front door (Node.start → bind_multiloop): the
        # accumulator is then fed from several loop threads — appends
        # and takes go under _plock, flushes run on the home loop,
        # futures resolve on their own loops, and the backpressure
        # event is per loop. None/empty on a single-loop node
        self._plock: Optional[threading.Lock] = None
        self._home: Optional[asyncio.AbstractEventLoop] = None
        self._ready_multi: Dict[int, tuple] = {}
        # set_pressure's divisor of the high-water mark: the overload
        # monitor divides it at critical, so publisher read-pauses
        # engage earlier
        self._pressure_div = 1
        # bound on a publisher's wait_ready park (seconds; 0 =
        # unbounded), set from OverloadConfig.ingress_wait_timeout_s
        # by the Node; the connection sheds the publisher past it
        self.submit_wait_timeout = 0.0
        self.flushes = 0
        self.submitted = 0
        self.max_batch = 0
        self.max_queue = 0
        # batches that went to the device (not the host regime)
        self.device_batches = 0
        self.device_msgs = 0

    _DONE = object()  # sentinel: fire-and-forget submission accepted

    def bind_multiloop(self, loop_group) -> None:
        """Arm the thread-safe submission mode (the multi-loop front
        door): the accumulator's home is the loop group's main loop;
        peer-loop submits append under a lock and kick a flush over
        ``call_soon_threadsafe``."""
        self._home = loop_group.home
        if self._plock is None:
            self._plock = threading.Lock()

    def accepts_threadsafe(self) -> bool:
        return self._plock is not None

    def _executor(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.max_inflight,
                thread_name_prefix="ingress-fetch")
        return self._pool

    @any_thread
    def submit(self, msg: Message, want_result: bool = True):
        """Queue one message. With ``want_result`` the returned future
        resolves to the delivery count at flush; without (QoS0, wills)
        no future is created. ``None`` = no running loop, the caller
        must publish synchronously. On a multi-loop node the future
        belongs to the CALLER's loop (its ack flushes from there) while
        the batch always flushes on the home loop."""
        trc = self.broker.tracing
        if trc is not None and trc.active:
            # trace-context stamp at INGRESS: the context's t0 anchors
            # the ingress-wait span (submit → batch pickup); the
            # broker's stamp keeps it (idempotent; it mutates only the
            # message's own headers, so any loop may stamp)
            trc.stamp(msg)
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if self._plock is not None:
            return self._submit_threadsafe(msg, want_result, loop)
        if loop is None:
            return None
        fut = loop.create_future() if want_result else None
        tel = self.broker.telemetry
        self._pending.append(
            (msg, fut, _now() if tel is not None and tel.enabled else 0.0))
        self.submitted += 1
        self.max_queue = max(self.max_queue, len(self._pending))
        if len(self._pending) >= self.batch_size:
            self._flush()
        elif len(self._pending) == 1:
            if self.linger_ms > 0:
                self._handle = loop.call_later(self.linger_ms / 1000.0,
                                               self._flush)
            else:
                self._handle = loop.call_soon(self._flush)
        return fut if fut is not None else self._DONE

    @any_thread
    def _submit_threadsafe(self, msg: Message, want_result: bool, loop):
        """Multi-loop submit: append under the lock; flush decisions run
        on the home loop (kicked over ``call_soon_threadsafe`` from
        peer loops — at most one kick a tick, the coalescing the
        single-loop path gets from ``_handle``)."""
        if want_result and loop is None:
            return None  # a sync caller publishes inline, as before
        fut = loop.create_future() if want_result else None
        tel = self.broker.telemetry
        t = _now() if tel is not None and tel.enabled else 0.0
        with self._plock:
            self._pending.append((msg, fut, t))
            self.submitted += 1
            n = len(self._pending)
            if n > self.max_queue:
                self.max_queue = n
        home = self._home or loop
        if loop is home:
            if n >= self.batch_size:
                self._flush()
            elif n == 1:
                if self.linger_ms > 0:
                    self._handle = home.call_later(
                        self.linger_ms / 1000.0, self._flush)
                else:
                    self._handle = home.call_soon(self._flush)
        elif n == 1 or n >= self.batch_size:
            try:
                home.call_soon_threadsafe(self._remote_kick)
            except RuntimeError:
                pass  # the home loop is gone (shutdown race)
        return fut if fut is not None else self._DONE

    @owner_loop
    def _remote_kick(self) -> None:
        """A peer-loop submit's flush request, now ON the home loop: the
        kick itself is the next-tick callback, so an un-lingered
        accumulator flushes at once, and a lingering one arms its timer
        once."""
        if not self._pending:
            return
        if len(self._pending) >= self.batch_size:
            self._flush()
            return
        if self._handle is not None:
            return  # a flush is already scheduled
        if self.linger_ms > 0:
            self._handle = self._home.call_later(self.linger_ms / 1000.0,
                                                 self._flush)
        else:
            self._flush()

    @owner_loop
    def _take_pending(self, cap: int = 0):
        """Shared flush prologue: cancel the scheduled flush, take up to
        ``cap`` messages (0 = all) off the accumulator, bump the
        counters."""
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
        lock = self._plock
        if lock is not None:
            # multi-loop: peer loops append concurrently — the take
            # must be atomic with their appends
            with lock:
                if cap and len(self._pending) > cap:
                    pending = self._pending[:cap]
                    del self._pending[:cap]
                else:
                    pending, self._pending = self._pending, []
        elif cap and len(self._pending) > cap:
            pending = self._pending[:cap]
            del self._pending[:cap]
        else:
            pending, self._pending = self._pending, []
        if pending:
            self.flushes += 1
            self.max_batch = max(self.max_batch, len(pending))
        self._signal_ready()
        return pending

    # -- ingest backpressure ----------------------------------------------

    def backlogged(self) -> bool:
        """Accumulator at/over the high-water mark: connections should
        pause reading (the active_n analogue). At critical overload
        the effective mark shrinks (:meth:`set_pressure`)."""
        if faults.enabled and faults.fire("ingress.saturate"):
            return True
        hw = self.queue_hiwater
        if self._pressure_div > 1:
            hw = max(1, hw // self._pressure_div)
        return len(self._pending) >= hw

    def set_pressure(self, div: int) -> None:
        """The overload monitor's knob: divide the effective high-water
        mark by ``div`` (1 restores the configured mark)."""
        self._pressure_div = max(1, int(div))

    async def wait_ready(self, timeout: float = 0.0) -> bool:
        """Park until a flush takes the backlog below the mark. On a
        multi-loop node each loop parks on its OWN event (an asyncio
        event belongs to one loop; waking them crosses threads).
        ``timeout`` bounds the park (0 = wait forever): returns False
        if the backlog still stands when it expires — the caller sheds
        the publisher instead of letting it wedge its read loop."""
        deadline = (time.monotonic() + timeout) if timeout > 0 else None

        async def _wait(ev) -> bool:
            if deadline is None:
                await ev.wait()
                return True
            remain = deadline - time.monotonic()
            if remain <= 0:
                return False
            try:
                await asyncio.wait_for(ev.wait(), remain)
                return True
            except asyncio.TimeoutError:
                return False

        if self._plock is None:
            while self.backlogged():
                if self._ready is None or self._ready.is_set():
                    self._ready = asyncio.Event()
                if not await _wait(self._ready):
                    return False
            return True
        loop = asyncio.get_running_loop()
        key = id(loop)
        while self.backlogged():
            ent = self._ready_multi.get(key)
            if ent is None or ent[1].is_set():
                ent = (loop, asyncio.Event())
                self._ready_multi[key] = ent
            if not await _wait(ent[1]):
                return False
        return True

    def _signal_ready(self) -> None:
        if self.backlogged():
            return
        if self._ready is not None and not self._ready.is_set():
            self._ready.set()
        if self._ready_multi:
            # wake every parked loop on its own thread; a loop adding a
            # fresh event after this snapshot parks until the next
            # flush signals again
            waiters = list(self._ready_multi.values())
            self._ready_multi.clear()
            try:
                running = asyncio.get_running_loop()
            except RuntimeError:
                running = None
            for lp, ev in waiters:
                if lp is running:
                    ev.set()
                else:
                    try:
                        lp.call_soon_threadsafe(ev.set)
                    except RuntimeError:
                        pass

    @owner_loop
    def _flush(self) -> None:
        # a capped take can leave a backlog: keep flushing chunks
        # while pipeline slots are free
        while self._pending and self._inflight < self.max_inflight:
            pending = self._take_pending(cap=self.batch_cap)
            # while earlier batches are in flight, a host-regime batch
            # must not route (and no batch may resolve) ahead of them:
            # begin with deferred host routing, chain the completion
            chain_active = (self._chain is not None
                            and not self._chain.done())
            try:
                pb = self.broker.publish_begin(
                    [p[0] for p in pending], defer_host=chain_active)
            except Exception as e:
                log.exception("ingress batch publish failed")
                self._resolve_exc(pending, e)
                continue
            if pb.done and not chain_active:
                self._resolve(pending, pb.results)
                continue
            sp = pb.span
            if sp is not None:
                # the batch's span is folded by _complete, after its
                # acknowledgements; its queue wait is the mean submit
                # → begin of its messages (those submitted while
                # telemetry was on)
                sp.held = True
                stamps = [p[2] for p in pending if p[2]]
                if stamps:
                    t_sub = sum(stamps) / len(stamps)
                    sp.add_ms("queue", (sp.t0 - t_sub) * 1000.0)
                    if sp.tb is not None:
                        sp.interval("queue", t_sub, sp.t0,
                                    {"msgs": len(stamps)})
            if not pb.done and pb.host_topics is None:
                self.device_batches += 1
                self.device_msgs += len(pending)
            self._inflight += 1
            loop = asyncio.get_running_loop()
            prev = self._chain if chain_active else None
            self._chain = loop.create_task(
                self._complete(pb, pending, prev))

    @owner_loop
    async def _complete(self, pb, pending, prev) -> None:
        """Fetch off-loop, then deliver in batch order."""
        loop = asyncio.get_running_loop()
        sp = pb.span  # held: folded below, after the acknowledgements
        try:
            if not pb.done and pb.host_topics is None:
                if faults.enabled and self._pool is not None \
                        and faults.fire("executor.death"):
                    # injected: the fetch pool dies out from under
                    # this batch — the supervision below respawns it
                    self._pool.shutdown(wait=False)
                try:
                    await loop.run_in_executor(
                        self._executor(), self.broker.publish_fetch, pb)
                except RuntimeError as e:
                    if "shutdown" not in str(e):
                        raise
                    # the fetch executor is dead (shut down): respawn
                    # it and retry — asyncio supervision standing in
                    # for the OTP restart the reference gets
                    log.warning("ingress fetch executor dead (%s): "
                                "respawning", e)
                    self.broker.metrics.inc("overload.heal.executor")
                    self._pool = None
                    await loop.run_in_executor(
                        self._executor(), self.broker.publish_fetch, pb)
            if prev is not None:
                # ordered delivery across batches; a failed
                # predecessor already resolved its own futures
                try:
                    await asyncio.shield(prev)
                except Exception:
                    pass
            if sp is not None:
                # the predecessor's tail and the loop's turn; the
                # delivery window opens here
                t_first = sp.add("order_wait", sp.t_ready)
                busy0 = sp.stages.get("dispatch", 0.0) + \
                    sp.stages.get("match", 0.0)
            if pb.done:
                results = self.broker.publish_finish(pb)
            else:
                # stream the delivery tail: finish in chunks, yielding
                # between chunks so finished work's deliveries flush
                # to subscriber sockets while the rest still routes. A
                # planned batch chunks over subscriber groups (each
                # session still gets its whole batch in one
                # deliver_many), the others over live rows
                if pb.host_topics is not None:
                    chunk_fn = self.broker.publish_host_chunk
                    n_units = len(pb.live)
                elif pb.plan is not None:
                    chunk_fn = self.broker.publish_finish_planned
                    n_units = pb.plan.n_groups
                else:
                    chunk_fn = self.broker.publish_finish_chunk
                    n_units = len(pb.live)
                fc = self.finish_chunk
                for s in range(0, max(1, n_units), fc):
                    chunk_fn(pb, s, min(s + fc, n_units))
                    if s + fc < n_units:
                        if sp is not None and sp.tb is not None:
                            t_y = _now()
                            await asyncio.sleep(0)
                            sp.interval("tail_yield", t_y, _now())
                        else:
                            await asyncio.sleep(0)
                if sp is not None:
                    # the window less the chunks' own stages (a host
                    # batch's first chunk also walks the trie): the
                    # loop's other work between chunks
                    t_last = _now()
                    busy = sp.stages.get("dispatch", 0.0) + \
                        sp.stages.get("match", 0.0) - busy0
                    sp.add_ms("tail_yield",
                              (t_last - t_first) * 1000.0 - busy)
                if pb.plan is not None:
                    # multi-loop: the batch's fold — and so the ack
                    # futures below — waits for the cross-loop handoffs
                    # to report back, bounded like the sync join (a
                    # wedged or dead owning loop folds partial counts,
                    # the loss counted in delivery.xloop.orphaned).
                    # None on a single-loop node
                    ev = self.broker.xloop_event(pb)
                    if ev is not None:
                        try:
                            await asyncio.wait_for(
                                ev.wait(), self.broker.XLOOP_JOIN_TIMEOUT)
                        except asyncio.TimeoutError:
                            log.error(
                                "cross-loop delivery handoff incomplete "
                                "after %.0fs — folding partial counts",
                                self.broker.XLOOP_JOIN_TIMEOUT)
                        self.broker.xloop_fold(pb)
                pb.done = True
                results = pb.results
        except Exception as e:
            log.exception("ingress batch completion failed")
            self._resolve_exc(pending, e)
            if sp is not None and sp.t_end:
                self.broker.telemetry.finish(sp)  # it was delivered
            return
        finally:
            self._inflight -= 1
            if self._pending:
                # flushing here would resolve newer publishes ahead of
                # this batch's (MQTT-4.6.0 ack order): schedule it
                # after this completion instead
                loop.call_soon(self._flush)
        self._resolve(pending, results)
        if sp is not None:
            # a held span is a delivered batch's: t_last is set
            sp.add("ack", t_last)
            self.broker.telemetry.finish(sp)

    def _resolve(self, pending, results) -> None:
        xloop = self._plock is not None
        for (_, fut, _t), n in zip(pending, results):
            if fut is None or fut.done():
                continue
            if xloop:
                self._set_future(fut, n, None)
            else:
                fut.set_result(n)

    def _resolve_exc(self, pending, e) -> None:
        xloop = self._plock is not None
        for _, fut, _t in pending:
            if fut is None or fut.done():
                continue
            if xloop:
                self._set_future(fut, None, e)
            else:
                fut.set_exception(e)

    @staticmethod
    @any_thread
    def _set_future(fut, value, exc) -> None:
        """Resolve a submit future on ITS loop: a peer loop's future is
        never completed from the home thread (the ack callbacks hanging
        off it touch that loop's channel)."""
        floop = fut.get_loop()
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None

        def _do(f=fut, v=value, e=exc):
            if f.done():
                return
            if e is not None:
                f.set_exception(e)
            else:
                f.set_result(v)

        if floop is running:
            _do()
        else:
            try:
                floop.call_soon_threadsafe(_do)
            except RuntimeError:
                pass  # the owner loop is gone; QoS > 0 clients re-send

    def flush_now(self) -> None:
        """Drain whatever is pending synchronously (shutdown path and
        loop-less callers); in-flight batches are awaited by
        :meth:`drain`."""
        pending = self._take_pending()
        if not pending:
            return
        try:
            results = self.broker.publish_batch([p[0] for p in pending])
        except Exception as e:
            log.exception("ingress batch publish failed")
            self._resolve_exc(pending, e)
            return
        self._resolve(pending, results)

    async def drain(self) -> None:
        """Wait for every in-flight batch, then flush what queued
        behind them (node shutdown); accumulated messages are newer
        than in-flight ones, so this order keeps delivery order."""
        while True:
            chain = self._chain
            if chain is not None and not chain.done():
                try:
                    await chain
                except Exception:
                    pass
                continue
            if self._pending:
                self.flush_now()
                continue
            break
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def stats(self) -> dict:
        return {
            "ingress.submitted": self.submitted,
            "ingress.flushes": self.flushes,
            "ingress.max_batch": self.max_batch,
            "ingress.max_queue": self.max_queue,
            "ingress.inflight": self._inflight,
            "ingress.avg_batch": (
                round(self.submitted / self.flushes, 2)
                if self.flushes else 0.0),
            "ingress.device_batches": self.device_batches,
            "ingress.device_avg_batch": (
                round(self.device_msgs / self.device_batches, 2)
                if self.device_batches else 0.0),
        }
