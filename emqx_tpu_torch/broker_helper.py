"""Subscriber-id registry + device fan-out tables.

The port of the JAX package's ``broker_helper.py`` (single device):
the reference's ``emqx_broker_helper`` assigns every subscriber a
dense integer id and splits a topic's subscriber set once it passes
1024 members (src/emqx_broker_helper.erl:55, 63-100). Here:

  - :class:`SubRegistry` assigns globally dense subscriber ids, so
    subscriber sets become integer arrays / bitmap rows a kernel can
    index;
  - :class:`FanoutManager` keeps the host map ``filter → {sids}`` and
    derives the two device tables the publish step uses — a CSR
    :class:`~emqx_tpu_torch.ops.fanout.FanoutTable` for small filters
    and bitmap rows (:class:`~emqx_tpu_torch.ops.bitmap.BitmapTable`)
    for filters past ``threshold`` — rebuilt lazily against the
    automaton's id-map snapshot and placed on the manager's device.

Capacities grow in powers of two and never shrink.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from emqx_tpu_torch.device import resolve
from emqx_tpu_torch.ops import convert
from emqx_tpu_torch.ops.bitmap import BitmapTable, build_bitmaps
from emqx_tpu_torch.ops.fanout import FanoutTable, build_fanout


class SubRegistry:
    """Dense subscriber ids with quarantined free-list reuse
    (emqx_broker_helper.erl:63-72 + emqx_sequence.erl semantics).

    A released id is NOT immediately reusable: device fan-out tables
    built earlier may still reference it, and handing it to a new
    subscriber would deliver the old subscriber's messages to the new
    one. Freed ids sit in a quarantine until :meth:`flush_free` —
    called by the fan-out manager right after it builds fresh tables
    (at which point no live table references the id; the reference
    sidesteps this with monotone emqx_sequence counters, at the cost
    of unbounded id growth)."""

    def __init__(self) -> None:
        self._by_sub: Dict[object, int] = {}
        self._by_id: List[Optional[object]] = []
        self._free: List[int] = []
        self._quarantine: List[int] = []

    def register(self, sub: object) -> int:
        sid = self._by_sub.get(sub)
        if sid is None:
            if not self._free and self._quarantine:
                # opportunistic aged reclaim keeps steady churn from
                # growing the table (round-4 leak)
                self.flush_free()
            if self._free:
                sid = self._free.pop()
                self._by_id[sid] = sub
            else:
                sid = len(self._by_id)
                self._by_id.append(sub)
            self._by_sub[sub] = sid
        return sid

    def sid(self, sub: object) -> Optional[int]:
        return self._by_sub.get(sub)

    def lookup(self, sid: int) -> Optional[object]:
        if 0 <= sid < len(self._by_id):
            return self._by_id[sid]
        return None

    #: quarantine dwell before a sid may recycle. Freed sids are
    #: resolved against the LIVE registry by the delivery tail, so a
    #: sid referenced by an in-flight pipelined device batch must not
    #: retranslate while that batch can still gather it — table swaps
    #: alone don't prove safety (up to max_inflight batches hold old
    #: tables). Batches live milliseconds; 5s covers any sane batch
    #: lifetime, and it also bounds the quarantine to the last 5s of
    #: churn (the round-4 leak fix). Defense in depth, not the sole
    #: guard: even a sid that DOES retranslate mid-batch is harmless,
    #: because Broker._deliver_one only delivers when the resolved
    #: sub is CURRENTLY subscribed to the matched filter — a stale
    #: slot either drops or reaches a legitimate subscriber.
    QUARANTINE_S = 5.0

    def release(self, sub: object) -> None:
        sid = self._by_sub.pop(sub, None)
        if sid is not None:
            self._by_id[sid] = None
            self._quarantine.append((sid, time.monotonic()))

    def flush_free(self) -> None:
        """Recycle quarantined ids older than :attr:`QUARANTINE_S`
        (entries are in release order, so the aged prefix suffices)."""
        cutoff = time.monotonic() - self.QUARANTINE_S
        i = 0
        for sid, ts in self._quarantine:
            if ts > cutoff:
                break
            self._free.append(sid)
            i += 1
        if i:
            del self._quarantine[:i]

    def capacity(self) -> int:
        return len(self._by_id)


class FanoutState:
    """One consistent device snapshot: CSR + bitmap tables whose
    filter axis is the automaton epoch's id map."""

    __slots__ = ("epoch", "version", "fan", "bm", "big_fids")

    def __init__(self, epoch: int, version: int,
                 fan: Optional[FanoutTable],
                 bm: Optional[BitmapTable],
                 big_fids: frozenset) -> None:
        self.epoch = epoch
        self.version = version
        self.fan = fan      # FanoutTable on the device (small filters)
        self.bm = bm        # BitmapTable on the device (big filters)
        self.big_fids = big_fids  # snapshot fids on the bitmap path


class FanoutManager:
    """Host truth for local subscriber sets + lazy device tables.

    ``subscribe``/``unsubscribe`` maintain ``filter → {sid}``;
    :meth:`state` returns the device tables for an automaton snapshot,
    rebuilding only when membership changed or the automaton epoch
    moved (filter ids are only meaningful per epoch).
    """

    def __init__(self, threshold: int = 1024, device=None):
        self.registry = SubRegistry()
        self.threshold = threshold
        self.device = resolve(device)
        self.rows: Dict[str, Set[int]] = {}
        self._lock = threading.RLock()
        self._version = 0
        self._state: Optional[FanoutState] = None
        # capacity retention (pow2, never shrinks → stable shapes)
        self._caps: Dict[str, Optional[int]] = {
            "filter": None, "entry": None, "row": None, "nsub": 1}

    # -- membership (called from Broker.subscribe/unsubscribe) ------------

    def subscribe(self, filter_: str, sub: object) -> int:
        with self._lock:
            sid = self.registry.register(sub)
            self.rows.setdefault(filter_, set()).add(sid)
            self._version += 1
            return sid

    def unsubscribe(self, filter_: str, sub: object) -> None:
        with self._lock:
            sid = self.registry.sid(sub)
            if sid is None:
                return
            row = self.rows.get(filter_)
            if row is not None:
                row.discard(sid)
                if not row:
                    del self.rows[filter_]
            self._version += 1

    def release(self, sub: object) -> None:
        """Drop the subscriber's id (after its last unsubscribe);
        recycling is time-gated (:attr:`SubRegistry.QUARANTINE_S`)."""
        with self._lock:
            self.registry.release(sub)
            self.registry.flush_free()

    def members(self, filter_: str) -> Set[int]:
        return self.rows.get(filter_, set())

    def members_sorted(self, filter_: Optional[str]) -> np.ndarray:
        """Sorted member-sid array, copied under the lock (the
        dispatch planner's bitmap attribution must not iterate the
        live, mutable set)."""
        with self._lock:
            row = self.rows.get(filter_) if filter_ is not None else None
            if not row:
                return np.empty(0, np.int64)
            return np.sort(np.fromiter(row, np.int64, len(row)))

    # -- device snapshot ---------------------------------------------------

    def state(self, epoch: int,
              id_map: Sequence[Optional[str]]) -> Optional[FanoutState]:
        """Device tables consistent with the automaton snapshot
        ``(epoch, id_map)``; ``None`` when there are no local
        subscribers (device fan-out has nothing to do)."""
        with self._lock:
            st = self._state
            if (st is not None and st.epoch == epoch
                    and st.version == self._version):
                return st
            if not self.rows:
                self._state = None
                self.registry.flush_free()
                return None
            small: Dict[int, List[int]] = {}
            big: Dict[int, Sequence[int]] = {}
            big_fids = set()
            for fid, f in enumerate(id_map):
                if f is None:
                    continue
                row = self.rows.get(f)
                if not row:
                    continue
                if len(row) > self.threshold:
                    big[fid] = sorted(row)
                    big_fids.add(fid)
                else:
                    small[fid] = sorted(row)
            n_filters = len(id_map)
            fan = bm = None
            if small or not big:
                fan = build_fanout(
                    small, n_filters,
                    filter_capacity=self._caps["filter"],
                    entry_capacity=self._caps["entry"])
                self._caps["filter"] = fan.row_ptr.shape[0] - 1
                self._caps["entry"] = fan.sub_ids.shape[0]
            if big:
                nsub = max(self._caps["nsub"], self.registry.capacity())
                bm = build_bitmaps(
                    big, n_filters, nsub,
                    row_capacity=self._caps["row"])
                self._caps["row"] = bm.bitmaps.shape[0]
                self._caps["nsub"] = nsub
            if fan is not None:
                fan = convert.fanout(fan, self.device)
            if bm is not None:
                bm = convert.bitmaps(bm, self.device)
            st = FanoutState(epoch, self._version, fan, bm,
                             frozenset(big_fids))
            self._state = st
            # the previous state (the last table referencing any
            # quarantined sid) is gone; freed ids may recycle now
            self.registry.flush_free()
            return st


def unpack_sids(row_words: np.ndarray) -> np.ndarray:
    """uint32 bitmap row → sorted int array of set bit positions
    (subscriber ids). Little-endian bit order matches
    :func:`~emqx_tpu_torch.ops.bitmap.build_bitmaps`."""
    bits = np.unpackbits(row_words.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits)
