"""Retained-message store and subscribe-time replay.

The reference core delegates retained messages to the
``emqx_retainer`` plugin; the JAX package ships it as a built-in
module wired through the same two hookpoints, and this is its port:

  - ``'message.publish'``: a retained PUBLISH stores its message under
    the topic (an empty retained payload deletes — MQTT 3.3.1-6/-7);
    the message still routes normally.
  - ``'session.subscribed'``: a new subscription receives every stored
    message matching its filter with the retain flag SET (MQTT
    3.3.1-8) regardless of RAP, honouring Retain-Handling (0 = always,
    1 = only if the subscription did not exist, 2 = never — MQTT
    3.8.3.1), skipping shared subscriptions and expired messages.

A subscribe burst matches in one batched pass of kernel B3 over the
stored names (:class:`RetainIndex`, ``ops/retained_match.py``) and
delivers through one subscriber-grouped plan. Bounded: ``max_retained``
topics and ``max_payload`` bytes per message (drops are counted).

The index rides device-loss recovery (:meth:`RetainIndex.attach_router`)
and has the JAX module's own failure breaker: a failed device match is
served by the host scan, and after 3 in a row the device path stays
off until the router's device state is rebuilt. On a CUDA index a
failed B3 match raises instead: only a loss the router's recovery has
confirmed (its suspension) moves a match to the host. Every match the
host scan serves in the device's place is counted
(``retained.device.fallback``), and the third strike raises the
``retained_device_fallback`` alarm.

In a cluster the store is replicated (the reference plugin replicates
through Mnesia): every store and delete broadcasts through
``node.retain_replicate``, a peer's applies through
:meth:`RetainerModule.apply_remote` (arrival order live,
timestamp last-writer-wins with delete tombstones on a join or
anti-entropy sync), and a replicated message enters the receiving
node's :class:`RetainIndex`, so that node's replay matches it through
kernel B3. With durability on, stores and deletes journal and crash
recovery refills the store (:meth:`RetainerModule.restore_entries`).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from emqx_tpu_torch import topic as T
from emqx_tpu_torch.device import resolve
from emqx_tpu_torch.modules import Module
from emqx_tpu_torch.ops import _build
from emqx_tpu_torch.ops.dispatch_plan import DispatchPlan, preserialize_plan
from emqx_tpu_torch.ops.retained_match import PLUS_ID, match_names_auto
from emqx_tpu_torch.ops.tokenize import PAD, WordTable
from emqx_tpu_torch.session import Session
from emqx_tpu_torch.types import Message

log = logging.getLogger("emqx_tpu_torch.retainer")


class RetainIndex:
    """Reverse index over retained topic NAMES on the index's device.

    Stored names live as a host ``[cap, L]`` word-id matrix mirrored
    on the device; :meth:`match_many` encodes a whole subscribe burst
    as ``[F, L]`` and matches every filter against every stored name
    in one launch of kernel B3 (the plain version on the CPU).

    Rows are slot-allocated (free list); a deleted row gets
    ``n_words = 0``, which matches nothing. Names deeper than ``L``
    levels live in a host-matched side set. Below ``device_threshold``
    live rows matching is the host scan. On CUDA the kernel library is
    loaded when the index is built, so a build failure raises there.
    A failed device match raises on CUDA; elsewhere it is served by
    the host scan, and after 3 in a row the device path stays off
    (``_device_broken``). ``device_failures`` and ``fallbacks`` count
    failed matches and host scans in the device's place. With a router
    attached (:meth:`attach_router`) the index rides device-loss
    recovery: while the router's device is suspended it host-scans and
    drops its cached matrix (its buffers may be dead), and the
    suspension lifting (the rebuild completed) resets the breaker.
    """

    L = 16
    GROW = 1024

    def __init__(self, device=None) -> None:
        self.device = resolve(device)
        self._table = WordTable()
        self._word_refs: Dict[str, int] = {}
        self._cap = self.GROW
        self._ids = np.full((self._cap, self.L), PAD, dtype=np.int32)
        self._n = np.zeros(self._cap, dtype=np.int32)
        self._sys = np.zeros(self._cap, dtype=bool)
        self._row_topic: List[Optional[str]] = [None] * self._cap
        self._row_of: Dict[str, int] = {}
        self._free = list(range(self._cap - 1, -1, -1))
        self._deep: set = set()
        self._epoch = 0
        self._dev = None  # (epoch, cap, ids, n, sys) device cache
        self._dirty: set = set()  # rows mutated since _dev was built
        self._device_broken = 0  # consecutive failures; >=3 disables
        #: failed device matches and matches the host scan served in
        #: the device's place, since construction (never reset)
        self.device_failures = 0
        self.fallbacks = 0
        self._router = None  # devloss riding (attach_router)
        self._metrics = self._alarms = None
        #: a failed match raises instead of host-scanning (CUDA)
        self.strict = self.device.type == "cuda"
        self._suspended_seen = False
        self._last_batch = 0  # filters in the last device dispatch
        if self.device.type == "cuda":
            _build.library()  # a build failure raises at boot
        # store mutations run on the broker's loop while subscribe
        # bursts may match from other loops; the lock covers the
        # matrix and device-cache critical sections
        self._lock = threading.RLock()

    def __len__(self) -> int:
        return len(self._row_of) + len(self._deep)

    def attach_router(self, router, metrics=None, alarms=None) -> None:
        """Arm device-loss riding: the index holds its own device
        tensors outside ``Router.rebuild_device_state()``, so instead
        of being rebuilt it watches the router's suspension flag.
        ``metrics`` and ``alarms`` (the node's) receive the fallback
        counters and the third strike's alarm."""
        self._router = router
        self._metrics = metrics
        self._alarms = alarms
        if metrics is not None:
            metrics.new("retained.device.failures")
            metrics.new("retained.device.fallback")

    def add(self, topic: str) -> None:
        with self._lock:
            self._add_locked(topic)

    def _add_locked(self, topic: str) -> None:
        if topic in self._row_of or topic in self._deep:
            return  # overwrite of the same name: index unchanged
        ws = topic.split("/")
        if len(ws) > self.L:
            self._deep.add(topic)
            return
        if not self._free:
            self._grow()
        row = self._free.pop()
        for j, w in enumerate(ws):
            self._ids[row, j] = self._table.intern(w)
            self._word_refs[w] = self._word_refs.get(w, 0) + 1
        self._ids[row, len(ws):] = PAD
        self._n[row] = len(ws)
        self._sys[row] = ws[0].startswith("$")
        self._row_topic[row] = topic
        self._row_of[topic] = row
        self._touch(row)

    def remove(self, topic: str) -> None:
        with self._lock:
            self._remove_locked(topic)

    def _remove_locked(self, topic: str) -> None:
        if topic in self._deep:
            self._deep.discard(topic)
            return
        row = self._row_of.pop(topic, None)
        if row is None:
            return
        for w in topic.split("/"):
            left = self._word_refs.get(w, 0) - 1
            if left <= 0:
                self._word_refs.pop(w, None)
            else:
                self._word_refs[w] = left
        self._ids[row, :] = PAD
        self._n[row] = 0
        self._sys[row] = False
        self._row_topic[row] = None
        self._free.append(row)
        self._touch(row)
        # backstop only (loop-less library use): the periodic sweep
        # owns compaction; this inline trigger fires far later
        self._maybe_compact(backstop=True)

    def clear(self) -> None:
        wiring = (self._router, self._metrics, self._alarms)
        counts = (self.device_failures, self.fallbacks)
        self.__init__(self.device)
        self._router, self._metrics, self._alarms = wiring
        self.device_failures, self.fallbacks = counts

    def _touch(self, row: int) -> None:
        self._epoch += 1
        if self._dev is not None:
            self._dirty.add(row)

    def _compact_due(self, backstop: bool = False) -> bool:
        dead = len(self._table) - len(self._word_refs)
        live = len(self._word_refs)
        if backstop:
            return dead >= max(65536, 4 * max(live, 1))
        return dead >= max(4096, live)

    def _maybe_compact(self, backstop: bool = False) -> None:
        """Re-intern into a fresh WordTable when most interned words
        are dead — name churn must not grow the table forever.
        Synchronous; the periodic sweep prefers :meth:`compact_async`,
        which chunks the rebuild so the event loop never stalls."""
        if not self._compact_due(backstop):
            return
        table = WordTable()
        for row, topic in enumerate(self._row_topic):
            if topic is None:
                continue
            for j, w in enumerate(topic.split("/")):
                self._ids[row, j] = table.intern(w)
        self._table = table
        self._dev = None
        self._dirty.clear()
        self._epoch += 1

    async def compact_async(self, chunk: int = 4096) -> bool:
        """Cooperative compaction: rebuild the id matrix and table in
        row chunks, yielding between chunks; a store mutation during
        the rebuild aborts it (epoch guard) and the next sweep retries.
        Returns True when a swap happened."""
        if not self._compact_due():
            return False
        start_epoch = self._epoch
        table = WordTable()
        new_ids = np.full_like(self._ids, PAD)
        for base in range(0, self._cap, chunk):
            for row in range(base, min(base + chunk, self._cap)):
                topic = self._row_topic[row]
                if topic is None:
                    continue
                for j, w in enumerate(topic.split("/")):
                    new_ids[row, j] = table.intern(w)
            await asyncio.sleep(0)
            if self._epoch != start_epoch:
                return False
        with self._lock:
            if self._epoch != start_epoch:
                return False
            self._ids = new_ids
            self._table = table
            self._dev = None
            self._dirty.clear()
            self._epoch += 1
        return True

    def _grow(self) -> None:
        old = self._cap
        self._cap = old * 2
        for name, fill in (("_ids", PAD), ("_n", 0), ("_sys", False)):
            arr = getattr(self, name)
            shape = (self._cap,) + arr.shape[1:]
            new = np.full(shape, fill, dtype=arr.dtype)
            new[:old] = arr
            setattr(self, name, new)
        self._row_topic.extend([None] * old)
        self._free.extend(range(self._cap - 1, old - 1, -1))

    def match_many(self, filters: Sequence[str],
                   device_threshold: int = 4096) -> List[List[str]]:
        """Every filter of a subscribe burst against every stored name
        in one device match. Returns per-filter hit lists aligned with
        ``filters``, with exact host-oracle (``T.match``) parity,
        including the ``$``-root mask, the ``#`` depth relax and the
        deep (> L levels) side set, which is scanned per filter on the
        host either way."""
        if not filters:
            return []
        deep = self._deep
        deep_hits = ([[t for t in deep if T.match(t, f)] for f in filters]
                     if deep else [[] for _ in filters])
        with self._lock:
            if len(self._row_of) < device_threshold:
                return [self._host_scan(f, dh)
                        for f, dh in zip(filters, deep_hits)]
            if not self._device_ok():
                return self._fallback_scan(filters, deep_hits)
            try:
                hits = self._match_device_many(filters)
            except Exception:
                self.device_failures += 1
                if self._metrics is not None:
                    self._metrics.inc("retained.device.failures")
                if self.strict:
                    # the card's match is never moved to the host
                    # unless the router's recovery confirmed a loss
                    raise
                # failure breaker: a permanently failing backend must
                # not pay a failed launch and a stack trace on EVERY
                # wildcard subscribe
                self._device_broken += 1
                if self._device_broken >= 3:
                    log.exception(
                        "retain index device match failed %d times; "
                        "host scan from now on", self._device_broken)
                    if self._alarms is not None:
                        self._alarms.activate(
                            "retained_device_fallback",
                            details={"failures": self._device_broken},
                            message="retained match tripped to the "
                                    "host scan")
                else:
                    log.warning(
                        "retain index device match failed; "
                        "host fallback (%d/3)", self._device_broken)
                return self._fallback_scan(filters, deep_hits)
            self._reset_breaker()
            return [h + dh for h, dh in zip(hits, deep_hits)]

    def _fallback_scan(self, filters: Sequence[str],
                       deep_hits: List[List[str]]) -> List[List[str]]:
        """The host scan in the device's place: counted."""
        self.fallbacks += 1
        if self._metrics is not None:
            self._metrics.inc("retained.device.fallback")
        return [self._host_scan(f, dh) for f, dh in zip(filters, deep_hits)]

    def _reset_breaker(self) -> None:
        if self._device_broken >= 3 and self._alarms is not None:
            self._alarms.deactivate("retained_device_fallback")
        self._device_broken = 0

    def _host_scan(self, flt: str, deep_hits: List[str]) -> List[str]:
        return [t for t in self._row_of if T.match(t, flt)] + deep_hits

    def _device_ok(self) -> bool:
        """Device-path gate: the failure breaker, plus devloss riding
        when a router is attached — suspended means the device is
        mid-recovery (the cached matrix may reference a LOST backend:
        drop it, host-scan, and burn no breaker strikes on a doomed
        launch); the suspension lifting means the rebuild completed,
        so the breaker resets."""
        r = self._router
        if r is not None:
            if r.device_suspended():
                self._dev = None
                self._dirty.clear()
                self._suspended_seen = True
                return False
            if self._suspended_seen:
                self._suspended_seen = False
                self._reset_breaker()
        return self._device_broken < 3

    def device_info(self) -> dict:
        """Diagnostic snapshot: live and deep row counts, the device
        cache's state, the breaker and suspension state and the last
        launch's filter count."""
        r = self._router
        return {
            "rows": len(self._row_of),
            "deep": len(self._deep),
            "cap": self._cap,
            "epoch": self._epoch,
            "cached": self._dev is not None,
            "dirty_rows": len(self._dirty),
            "device_broken": self._device_broken,
            "device_failures": self.device_failures,
            "fallbacks": self.fallbacks,
            "suspended": bool(r is not None and r.device_suspended()),
            "last_batch": self._last_batch,
        }

    def _encode(self, filters: Sequence[str]):
        """``[Fp, L]`` filter words, ``[Fp]`` counts and ``#`` flags,
        the burst padded to a power of two (padding rows — fn = 0, no
        ``#`` — match nothing)."""
        F = len(filters)
        Fp = max(1, 1 << (F - 1).bit_length()) if F > 1 else 1
        fw = np.full((Fp, self.L), PAD, dtype=np.int32)
        fn = np.zeros(Fp, dtype=np.int32)
        hh = np.zeros(Fp, dtype=bool)
        for i, flt in enumerate(filters):
            ws = flt.split("/")
            if ws[-1] == "#":
                hh[i] = True
                ws = ws[:-1]
            if len(ws) > self.L:
                # deeper than any indexed name can be: a no-match row
                # (the deep side set covers such names)
                hh[i] = False
                continue
            fn[i] = len(ws)
            for j, w in enumerate(ws):
                # lookup, NOT intern: an unseen filter word (UNKNOWN =
                # -1) matches no stored id >= 0, and subscribe traffic
                # cannot grow the table
                fw[i, j] = PLUS_ID if w == "+" else self._table.lookup(w)
        return fw, fn, hh

    def _match_device_many(self, filters: Sequence[str]
                           ) -> List[List[str]]:
        F = len(filters)
        dev = self._device_arrays()
        fw, fn, hh = (torch.from_numpy(a).to(self.device)
                      for a in self._encode(filters))
        ok = match_names_auto(fw, fn, hh, dev[2], dev[3], dev[4])
        self._last_batch = F
        # only the hits cross to the host, as flat f * cap + row
        # indices in row-major order: per filter, ascending rows
        flat = torch.nonzero(ok[:F].reshape(-1)).reshape(-1).cpu().numpy()
        cap = ok.shape[1]
        cuts = np.searchsorted(flat, np.arange(1, F) * cap)
        rt = self._row_topic
        return [[rt[row] for row in (part % cap).tolist()
                 if rt[row] is not None]
                for part in np.split(flat, cuts)]

    def _device_arrays(self):
        dev = self._dev
        if dev is None or dev[0] != self._epoch or dev[1] != self._cap:
            if (dev is not None and dev[1] == self._cap
                    and len(self._dirty) <= 256):
                # interleaved store/subscribe traffic: patch the few
                # mutated rows instead of re-uploading the matrix. The
                # JAX package builds new arrays (.at[rows].set); here
                # the rows are written into the cached tensors in place
                rows = np.fromiter(self._dirty, dtype=np.int64)
                idx = torch.from_numpy(rows).to(self.device)
                for t, host in zip(dev[2:], (self._ids, self._n, self._sys)):
                    t[idx] = torch.from_numpy(host[rows]).to(self.device)
                dev = (self._epoch, self._cap) + dev[2:]
            else:
                dev = (self._epoch, self._cap) + tuple(
                    torch.from_numpy(a).to(self.device, copy=True)
                    for a in (self._ids, self._n, self._sys))
            self._dev = dev
            self._dirty.clear()
        return dev


class RetainerModule(Module):
    name = "retainer"

    #: stats ticks between expired-entry sweeps
    _GC_EVERY = 6

    def __init__(self, node) -> None:
        super().__init__(node)
        self._store: Dict[str, Message] = {}
        self._index = RetainIndex(node.device)
        self.index_device_threshold = 4096
        # delete tombstones (topic -> delete time): checkpoints carry
        # them, so a restore never resurrects a deleted message
        self._tombstones: Dict[str, float] = {}
        # durability: store/delete journal through node.durability;
        # True while crash recovery is refilling the store (those
        # mutations must not re-journal)
        self._restoring = False
        self.max_retained = 0
        self.max_payload = 0
        # replay accumulator: per-event-loop pending (session, filter,
        # subopts) triples; the first append on a loop schedules a
        # same-tick drain, so every session.subscribed firing of one
        # SUBACK burst lands in ONE batched index match + ONE plan
        self._pending: Dict[object, list] = {}
        self._replay_last_batch = 0
        self._gc_tick = 0
        self._sweep_task = None

    def load(self, env: dict) -> None:
        self.max_retained = int(env.get("max_retained", 1_000_000))
        self.max_payload = int(env.get("max_payload", 1 << 20))
        self.index_device_threshold = int(
            env.get("index_device_threshold", 4096))
        self.sweep_interval = float(env.get("sweep_interval", 60.0))
        self._kick_on_loop()
        for name in ("retained.count", "retained.dropped",
                     "retained.expired", "retained.replay.batches",
                     "retained.replay.messages"):
            self.node.metrics.new(name)
        # expired-retained GC on the stats tick: entries past
        # Message-Expiry leave the store and index even when nothing
        # subscribes to them again
        self.node.stats.register_update(self._on_stats_tick)
        # devloss riding: a suspended device host-scans and the
        # breaker resets once the rebuild completes
        self._index.attach_router(self.node.router, self.node.metrics,
                                  self.node.alarms)
        self.node.hooks.add("message.publish", self.on_publish,
                            priority=50)
        self.node.hooks.add("session.subscribed", self.on_subscribed,
                            priority=50)

    def _on_stats_tick(self, stats) -> None:
        self._gc_tick += 1
        if self._gc_tick >= self._GC_EVERY:
            self._gc_tick = 0
            self.sweep_expired()

    def on_loop_start(self) -> None:
        if self._sweep_task is None or self._sweep_task.done():
            self._sweep_task = asyncio.get_running_loop().create_task(
                self._sweep_loop())

    def on_loop_stop(self) -> None:
        if self._sweep_task is not None:
            self._sweep_task.cancel()
            self._sweep_task = None

    async def _sweep_loop(self) -> None:
        """Periodic expiry sweep plus cooperative index compaction,
        both off the publish hot path."""
        while True:
            await asyncio.sleep(self.sweep_interval)
            try:
                self.sweep_expired()
                await self._index.compact_async()
            except Exception:
                log.exception("retainer sweep failed")

    def unload(self) -> None:
        self.on_loop_stop()
        self.node.hooks.delete("message.publish", self.on_publish)
        self.node.hooks.delete("session.subscribed", self.on_subscribed)
        self._pending.clear()
        self._store.clear()
        self._index.clear()

    # every store mutation goes through these so the reverse index
    # stays in lockstep with the dict — and, with durability on, the
    # journal sees exactly the store's mutations
    def _put(self, topic: str, msg: Message) -> None:
        self._store[topic] = msg
        self._index.add(topic)
        if not self._restoring:
            dur = getattr(self.node, "durability", None)
            if dur is not None:
                dur.journal_retain(topic, msg, msg.timestamp)

    def _pop(self, topic: str):
        msg = self._store.pop(topic, None)
        if msg is not None:
            self._index.remove(topic)
            if not self._restoring:
                dur = getattr(self.node, "durability", None)
                if dur is not None:
                    dur.journal_retain(topic, None)
        return msg

    def restore_entries(self, items, tombstones=()) -> None:
        """Crash-recovery refill (durability.py): install recovered
        (topic, Message) pairs + delete tombstones without
        re-journaling, honoring expiry and the store bounds. The
        names reach kernel B3 through the index's one full upload at
        the first match, not a device write a topic."""
        self._restoring = True
        try:
            for topic, msg in items:
                if msg is None or msg.is_expired():
                    continue
                if self.max_retained \
                        and len(self._store) >= self.max_retained:
                    self.node.metrics.inc("retained.dropped")
                    continue
                if topic not in self._store:
                    self.node.metrics.inc("retained.count")
                self._put(topic, msg)
            for topic, ts in tombstones:
                self._tombstones[topic] = max(
                    self._tombstones.get(topic, 0.0), float(ts))
        finally:
            self._restoring = False

    # -- store maintenance -------------------------------------------------

    def on_publish(self, msg: Message):
        if not msg.flags.get("retain") or msg.topic.startswith("$SYS/"):
            return None
        if not msg.payload:
            if self._pop(msg.topic) is not None:
                self.node.metrics.dec("retained.count")
                # monotone: a delete never moves a tombstone backwards
                # (nor an ahead-clock peer's)
                self._tombstones[msg.topic] = max(
                    self._tombstones.get(msg.topic, 0.0), msg.timestamp)
                self._replicate(msg.topic, None, msg.timestamp)
            return None
        if len(msg.payload) > self.max_payload or (
                msg.topic not in self._store
                and len(self._store) >= self.max_retained):
            self.node.metrics.inc("retained.dropped")
            return None
        if msg.topic not in self._store:
            self.node.metrics.inc("retained.count")
        stored = msg.copy()
        # the broadcast wire cache is per-live-delivery state, not
        # part of the retained record
        stored.headers.pop("_wire", None)
        self._put(msg.topic, stored)
        self._replicate(msg.topic, stored)
        return None  # the message still routes normally

    def _replicate(self, topic: str, msg, ts: float = None) -> None:
        fn = getattr(self.node, "retain_replicate", None)
        if fn is not None:
            fn(topic, msg, ts)

    def apply_remote(self, topic: str, msg, sync: bool = False,
                     ts: float = None) -> None:
        """A peer's store/delete (idempotent, never re-broadcast).

        LIVE replication (``sync=False``) applies in arrival order —
        concurrent publishes race exactly as the reference's Mnesia
        writes do, and a node with a lagging clock must not have its
        updates silently dropped cluster-wide. JOIN sync
        (``sync=True``) is the anti-entropy path: last-WRITER-wins by
        message timestamp, respecting delete tombstones, so a
        rejoiner's stale snapshot can neither clobber newer values nor
        resurrect deletions."""
        if msg is None:
            if self._pop(topic) is not None:
                self.node.metrics.dec("retained.count")
            # the tombstone carries the DELETING message's origin
            # timestamp (not local wall-clock) so join-sync LWW stays
            # consistent under clock skew; monotone like apply_tombstone
            if ts is None:
                ts = time.time()
            self._tombstones[topic] = max(
                self._tombstones.get(topic, 0.0), ts)
            return
        if msg.is_expired():
            return
        if len(msg.payload) > self.max_payload:
            # the bound on_publish enforces — a peer with a larger
            # limit must not replicate oversize payloads into ours
            self.node.metrics.inc("retained.dropped")
            return
        if sync:
            tomb = self._tombstones.get(topic)
            if tomb is not None and tomb >= msg.timestamp:
                return
        cur = self._store.get(topic)
        if cur is not None:
            if not sync or msg.timestamp > cur.timestamp:
                self._put(topic, msg)
            return
        if len(self._store) >= self.max_retained:
            self.node.metrics.inc("retained.dropped")
            return
        self.node.metrics.inc("retained.count")
        self._put(topic, msg)

    def sweep_expired(self) -> int:
        """Drop expired entries (a matching subscribe also prunes them
        lazily; the stats-tick GC and the periodic sweep land here),
        and delete tombstones past their time to live."""
        dead = [t for t, m in self._store.items() if m.is_expired()]
        for t in dead:
            self._pop(t)
            self.node.metrics.dec("retained.count")
            self.node.metrics.inc("retained.expired")
        self._sweep_tombstones()
        return len(dead)

    def entries(self):
        """Live snapshot for a cluster join sync (expired swept first —
        a join must not resurrect dead entries)."""
        self.sweep_expired()
        return list(self._store.items())

    def tombstones(self):
        return list(self._tombstones.items())

    def apply_tombstone(self, topic: str, ts: float) -> None:
        """A peer's delete record (join sync): drop any locally stored
        message older than the deletion."""
        cur = self._store.get(topic)
        if cur is not None and cur.timestamp <= ts:
            self._pop(topic)
            self.node.metrics.dec("retained.count")
        prev = self._tombstones.get(topic, 0.0)
        self._tombstones[topic] = max(prev, ts)

    #: seconds a delete tombstone is kept
    _TOMBSTONE_TTL = 3600.0

    def _sweep_tombstones(self) -> None:
        cutoff = time.time() - self._TOMBSTONE_TTL
        for t in [t for t, ts in self._tombstones.items()
                  if ts < cutoff]:
            self._tombstones.pop(t, None)

    # -- delivery on subscribe ---------------------------------------------

    def on_subscribed(self, clientinfo: dict, flt: str,
                      subopts: dict) -> None:
        """Hook entry: Retain-Handling and the shared-sub skip are
        decided here; the match, expiry eviction and delivery plan are
        deferred one loop tick so a SUBSCRIBE burst coalesces into one
        batched replay (:meth:`_replay_flush`)."""
        if flt.startswith(("$share/", "$queue/")):
            return  # never to shared subscriptions
        rh = subopts.get("rh", 0)
        if rh == 2 or (rh == 1 and subopts.get("resub")):
            return
        chan = self.node.cm.lookup_channel(clientinfo.get("clientid", ""))
        if chan is None or not self._store:
            return
        session = chan.session
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if loop is None:
            # loop-less callers keep the synchronous semantics: a
            # one-item burst, flushed inline
            self._replay_flush([(session, flt, subopts)])
            return
        # the hook fires on the subscribing channel's loop and delivery
        # targets that loop's session, so pending lists are per loop
        pend = self._pending.get(loop)
        if pend is None:
            self._pending[loop] = pend = []
        pend.append((session, flt, subopts))
        if len(pend) == 1:
            # first item this tick: drain at the end of the current
            # loop iteration, so the whole burst lands in this batch
            loop.call_soon(self._replay_kick, loop)

    def _replay_kick(self, loop) -> None:
        # a failed flush raises into the loop's exception handler
        items = self._pending.pop(loop, None)
        if items:
            self._replay_flush(items)

    def _replay_flush(self, items: list) -> None:
        """One subscribe burst → one batched index match → one
        subscriber-grouped delivery plan: unique wildcard filters match
        in one device pass (:meth:`RetainIndex.match_many`), exact
        filters are a dict probe, every stored topic materializes ONE
        out-copy per burst (retain flag kept, expiry filtered here with
        lazy eviction), and each session takes its whole group in one
        ``deliver_many``. With ``dispatch_config.preserialize`` the
        burst's wire frames are built first, once per subscriber class
        and stored topic, over the burst's shared row copies. With
        ``dispatch_config.planner`` off, the per-delivery ``deliver``
        walk runs instead."""
        store = self._store
        if not store:
            return
        metrics = self.node.metrics
        flt_list: List[str] = []
        fidx: Dict[str, int] = {}
        for _sess, flt, _opts in items:
            if flt not in fidx:
                fidx[flt] = len(flt_list)
                flt_list.append(flt)
        wild = [f for f in flt_list if T.wildcard(f)]
        hits: Dict[str, List[str]] = {}
        if wild:
            hits.update(zip(wild, self._index.match_many(
                wild, device_threshold=self.index_device_threshold)))
        for f in flt_list:
            if f not in hits:
                hits[f] = [f] if f in store else []
        # burst-local message rows: ONE copy per stored topic however
        # many sessions/filters matched it
        row_of: Dict[str, int] = {}
        rows: List[Message] = []

        def row_for(topic: str) -> int:
            r = row_of.get(topic)
            if r is not None:
                return r
            msg = store.get(topic)
            if msg is None or msg.is_expired():
                if msg is not None:
                    self._pop(topic)
                    metrics.dec("retained.count")
                    metrics.inc("retained.expired")
                row_of[topic] = -1
                return -1
            out = msg.copy()
            # retained delivery keeps retain=1 (MQTT-3.3.1-8); the
            # 'retained' header tells the session's RAP logic so
            out.set_header("retained", True)
            row_of[topic] = r = len(rows)
            rows.append(out)
            return r

        sess_of: Dict[int, int] = {}
        sessions: List[Session] = []
        sids: List[int] = []
        fids: List[int] = []
        rids: List[int] = []
        opts_of: Dict[tuple, object] = {}
        for sess, flt, _opts in items:
            topics = hits.get(flt, ())
            if not topics:
                continue
            key = id(sess)
            sid = sess_of.get(key)
            if sid is None:
                sid = sess_of[key] = len(sessions)
                sessions.append(sess)
            fid = fidx[flt]
            # the session's own SubOpts object (the hook hands a dict)
            opts_of[(sid, fid)] = sess.subscriptions.get(flt)
            for t in topics:
                r = row_for(t)
                if r >= 0:
                    sids.append(sid)
                    fids.append(fid)
                    rids.append(r)
        if not sids:
            return
        metrics.inc("retained.replay.batches")
        metrics.inc("retained.replay.messages", len(sids))
        self._replay_last_batch = len(sids)
        cfg = self.node.broker.dispatch_config
        if not cfg.planner:
            # the per-delivery path
            for k in range(len(sids)):
                sessions[sids[k]].deliver(flt_list[fids[k]], rows[rids[k]])
            return
        plan = DispatchPlan(np.asarray(sids, np.int64),
                            np.asarray(fids, np.int64),
                            np.asarray(rids, np.int64))
        if cfg.preserialize:
            # the classes come from the sessions' real SubOpts
            subscribers: Dict[str, dict] = {}
            for (sid, fid), opts in opts_of.items():
                if opts is not None:
                    subscribers.setdefault(
                        flt_list[fid], {})[sessions[sid]] = opts
            preserialize_plan(plan, list(enumerate(rows)), flt_list,
                              subscribers, sessions.__getitem__)
        g_ptr = plan.g_ptr
        for g in range(plan.n_groups):
            sid = plan.g_sids[g]
            sess = sessions[sid]
            group = []
            for k in range(g_ptr[g], g_ptr[g + 1]):
                fid = plan.fids[k]
                group.append((flt_list[fid], rows[plan.rows[k]],
                              opts_of.get((sid, fid)), False))
            sess.deliver_many(group)

    def replay_info(self) -> dict:
        """Store and replay counters."""
        m = self.node.metrics
        return {
            "store": len(self._store),
            "dropped": m.val("retained.dropped"),
            "expired": m.val("retained.expired"),
            "replay_batches": m.val("retained.replay.batches"),
            "replay_messages": m.val("retained.replay.messages"),
            "replay_last_batch": self._replay_last_batch,
        }
