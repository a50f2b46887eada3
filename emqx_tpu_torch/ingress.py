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
copy follows the kernels the begin enqueued. Up to ``MAX_INFLIGHT``
batches overlap; delivery stays ordered: batch N+1's delivery tail
awaits batch N's.

Flush policy: a batch flushes when it reaches ``batch_size``, else on
the next event-loop iteration (``call_soon``). When all
``MAX_INFLIGHT`` slots are busy, arrivals keep accumulating and flush
as a bigger batch, of at most ``batch_cap`` (``CAP_BATCHES`` ×
``batch_size``) messages, when a slot frees.

Callers without a running event loop (sync callers, sans-IO tests)
get ``None`` from :meth:`submit` and publish inline. Several front-door
loops feeding one batcher come with the multi-loop front door.
"""

from __future__ import annotations

import asyncio
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

from emqx_tpu_torch import faults
from emqx_tpu_torch.concurrency import owner_loop
from emqx_tpu_torch.device import resolve
from emqx_tpu_torch.types import Message

log = logging.getLogger("emqx_tpu_torch.ingress")


#: batches in flight at once (begun, not yet delivered)
MAX_INFLIGHT = 4
#: the largest batch one flush takes, in batch sizes
CAP_BATCHES = 4
#: the delivery tail yields to the event loop every this many finished
#: rows (or subscriber groups)
FINISH_CHUNK = 64


class IngressBatcher:
    def __init__(self, broker, batch_size: int = 256, device=None) -> None:
        # the batcher feeds the broker's device path: like every entry
        # point it runs on CUDA unless the caller asks for the CPU,
        # and on the broker's device
        dev = resolve(device)
        if dev != broker.device:
            raise ValueError(f"IngressBatcher on {dev} for a broker on "
                             f"{broker.device}")
        self.broker = broker
        self.batch_size = batch_size
        self.batch_cap = batch_size * CAP_BATCHES
        # accumulator high-water mark (one batch): past it, connections
        # pause their read loops (wait_ready) until a flush drains the
        # backlog — the reference bounds per-connection ingest with
        # active_n (src/emqx_connection.erl:99); the standing queue
        # then lives in the publishers' TCP buffers
        self.queue_hiwater = batch_size
        self._pending: List[Tuple[Message, Optional[asyncio.Future]]] = []
        self._handle = None
        self._inflight = 0
        self._chain: Optional[asyncio.Task] = None  # ordered delivery
        self._pool: Optional[ThreadPoolExecutor] = None
        self._ready: Optional[asyncio.Event] = None
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

    def _executor(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=MAX_INFLIGHT,
                thread_name_prefix="ingress-fetch")
        return self._pool

    @owner_loop
    def submit(self, msg: Message, want_result: bool = True):
        """Queue one message. With ``want_result`` the returned future
        resolves to the delivery count at flush; without (QoS0, wills)
        no future is created. ``None`` = no running loop, the caller
        must publish synchronously."""
        trc = self.broker.tracing
        if trc is not None and trc.active:
            # trace-context stamp at INGRESS: the context's t0 anchors
            # the ingress-wait span (submit → batch pickup); the
            # broker's stamp keeps it (idempotent)
            trc.stamp(msg)
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return None
        fut = loop.create_future() if want_result else None
        self._pending.append((msg, fut))
        self.submitted += 1
        self.max_queue = max(self.max_queue, len(self._pending))
        if len(self._pending) >= self.batch_size:
            self._flush()
        elif len(self._pending) == 1:
            self._handle = loop.call_soon(self._flush)
        return fut if fut is not None else self._DONE

    @owner_loop
    def _take_pending(self, cap: int = 0):
        """Shared flush prologue: cancel the scheduled flush, take up to
        ``cap`` messages (0 = all) off the accumulator, bump the
        counters."""
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
        if cap and len(self._pending) > cap:
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
        """Park until a flush takes the backlog below the mark.
        ``timeout`` bounds the park (0 = wait forever): returns False
        if the backlog still stands when it expires — the caller sheds
        the publisher instead of letting it wedge its read loop."""
        deadline = (time.monotonic() + timeout) if timeout > 0 else None
        while self.backlogged():
            if self._ready is None or self._ready.is_set():
                self._ready = asyncio.Event()
            if deadline is None:
                await self._ready.wait()
                continue
            remain = deadline - time.monotonic()
            if remain <= 0:
                return False
            try:
                await asyncio.wait_for(self._ready.wait(), remain)
            except asyncio.TimeoutError:
                return False
        return True

    def _signal_ready(self) -> None:
        if self.backlogged():
            return
        if self._ready is not None and not self._ready.is_set():
            self._ready.set()

    @owner_loop
    def _flush(self) -> None:
        # a capped take can leave a backlog: keep flushing chunks
        # while pipeline slots are free
        while self._pending and self._inflight < MAX_INFLIGHT:
            pending = self._take_pending(cap=self.batch_cap)
            # while earlier batches are in flight, a host-regime batch
            # must not route (and no batch may resolve) ahead of them:
            # begin with deferred host routing, chain the completion
            chain_active = (self._chain is not None
                            and not self._chain.done())
            try:
                pb = self.broker.publish_begin(
                    [m for m, _ in pending], defer_host=chain_active)
            except Exception as e:
                log.exception("ingress batch publish failed")
                self._resolve_exc(pending, e)
                continue
            if pb.done and not chain_active:
                self._resolve(pending, pb.results)
                continue
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
                for s in range(0, max(1, n_units), FINISH_CHUNK):
                    chunk_fn(pb, s, min(s + FINISH_CHUNK, n_units))
                    if s + FINISH_CHUNK < n_units:
                        await asyncio.sleep(0)
                pb.done = True
                results = pb.results
        except Exception as e:
            log.exception("ingress batch completion failed")
            self._resolve_exc(pending, e)
            return
        finally:
            self._inflight -= 1
            if self._pending:
                # flushing here would resolve newer publishes ahead of
                # this batch's (MQTT-4.6.0 ack order): schedule it
                # after this completion instead
                loop.call_soon(self._flush)
        self._resolve(pending, results)

    @staticmethod
    def _resolve(pending, results) -> None:
        for (_, fut), n in zip(pending, results):
            if fut is not None and not fut.done():
                fut.set_result(n)

    @staticmethod
    def _resolve_exc(pending, e) -> None:
        for _, fut in pending:
            if fut is not None and not fut.done():
                fut.set_exception(e)

    def flush_now(self) -> None:
        """Drain whatever is pending synchronously (shutdown path and
        loop-less callers); in-flight batches are awaited by
        :meth:`drain`."""
        pending = self._take_pending()
        if not pending:
            return
        try:
            results = self.broker.publish_batch([m for m, _ in pending])
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
