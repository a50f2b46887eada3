"""Epoch-guarded device-resident publish match cache.

The port of the JAX package's ``ops/match_cache.py``. The publish hot loop re-walks every unique topic per batch, yet real
traffic repeats its topics (EMQX ships a host-side route cache in
front of ``emqx_router:match_routes/1`` for this reason). The cache
memoizes per-topic match rows in a fixed-shape device table, so a
repeat topic costs one gather instead of an NFA walk.

  - the device table is ``int32[slots, 1 + width]``: column 0 is a
    flag (:data:`_VALID`, :data:`_OVF` or :data:`_FOVF`), the rest
    the packed row (-1 padded): the matched-filter ids on one device,
    the concatenated ``(ids, subs, src)`` rows of the mesh's
    collective step on a mesh. Rows never move: the host owns a
    ``topic → slot`` index and a per-slot epoch *key*;
  - entries are **epoch-guarded**: the key stored at insert time must
    equal the probing key exactly, or the entry is a (counted) stale
    miss. The router bumps a revision on filter-set changes (one
    partition's, or the global one), rebuilds and capacity boosts;
  - **overflow topics are never served from the cache**: an
    overflowed miss row is stored as an invalid marker (ids all -1);
    a hit on it reports ``overflow`` and the caller re-matches on the
    host, as a fresh walk would have. The flag keeps which bound
    overflowed (the match's, or only the mesh's fan-out ``d``), so a
    hit reports ``movf`` as the walk did and the router's ``boost_k``
    and ``boost_d`` signals mean the same across cached batches;
  - the table is **copy-on-write**: :meth:`MatchCache.insert` clones
    it and scatters into the clone, so a probe's ``table`` (the
    snapshot its hits gather from) is never written — a batch still
    in flight cannot gather a row another batch's clock sweep
    reassigned. One clone is ``slots × (1 + width) × 4`` bytes.

The JAX package pads its scatters with out-of-range positions that
drop; here every index is built from the probe's host lists, so only
live entries reach a scatter, and the result is the same.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional, Sequence

import torch

__all__ = ["MatchCache"]

#: flag column values: _VALID = cached ids are the exact match set;
#: _OVF = the walk overflowed (host fallback, match-only bound);
#: _FOVF = overflow where the match side itself was fine (the mesh
#: fan-out d bound) — merged back into (ovf, movf)
_OVF, _VALID, _FOVF = 0, 1, 2


def _pow2(n: int, floor: int = 1) -> int:
    out = floor
    while out < n:
        out *= 2
    return out


def _index(vals: Sequence[int], device) -> torch.Tensor:
    return torch.tensor(list(vals), dtype=torch.int64).to(device)


def merge_rows(table: torch.Tensor, hit_slots: Sequence[int],
               hit_pos: Sequence[int], miss_rows: Optional[torch.Tensor],
               miss_ovf: Optional[torch.Tensor], miss_pos: Sequence[int],
               b_pad: int, miss_movf: Optional[torch.Tensor] = None):
    """Combined rows + overflow flags of one batch — the JAX package's
    ``_merge_jit``: hit rows gathered from the table snapshot and the
    fresh miss rows written to their positions of a ``[b_pad, width]``
    output; every other row stays -1 / False. Returns ``(rows, ovf,
    movf)``: ``ovf`` is any overflow, ``movf`` the match-only one (a
    miss without ``miss_movf`` has ``movf = ovf``, as on one device).
    ``miss_rows`` may be batch-padded: only its first
    ``len(miss_pos)`` rows are written."""
    dev = table.device
    width = table.shape[1] - 1
    out = torch.full((b_pad, width), -1, dtype=torch.int32, device=dev)
    ovf = torch.zeros((b_pad,), dtype=torch.bool, device=dev)
    movf = torch.zeros((b_pad,), dtype=torch.bool, device=dev)
    if len(hit_pos):
        hv = table.index_select(0, _index(hit_slots, dev))
        hp = _index(hit_pos, dev)
        out[hp] = hv[:, 1:]
        ovf[hp] = hv[:, 0] != _VALID
        movf[hp] = hv[:, 0] == _OVF
    n = len(miss_pos)
    if n:
        mp = _index(miss_pos, dev)
        mo = miss_ovf[:n]
        mm = mo if miss_movf is None else miss_movf[:n]
        out[mp] = miss_rows[:n].to(torch.int32)
        ovf[mp] = mo | mm
        movf[mp] = mm
    return out, ovf, movf


def insert_rows(table: torch.Tensor, slots: Sequence[int],
                rows: torch.Tensor, ovf: torch.Tensor,
                movf: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A NEW table: a clone of ``table`` with ``rows[i]`` written to
    slot ``slots[i]`` for the first ``len(slots)`` rows — the JAX
    package's ``_insert_jit``. Overflowed rows are stored as invalid
    markers (ids all -1), never as truncated results: flag ``_OVF``
    where the match overflowed (``movf``; ``ovf`` when not given),
    ``_FOVF`` where only the fan-out did. A slot listed twice keeps its
    last row (the clock sweep can hand one slot to two topics of a
    batch larger than the table)."""
    n = len(slots)
    last = {s: i for i, s in enumerate(slots)}
    movf = ovf if movf is None else movf
    rows, ovf, movf = rows[:n], ovf[:n], movf[:n]
    if len(last) < n:
        keep = _index(last.values(), rows.device)
        rows, ovf, movf = rows[keep], ovf[keep], movf[keep]
        slots = list(last)
    flag = torch.where(movf, _OVF, torch.where(ovf, _FOVF, _VALID))
    rows = torch.where((ovf | movf)[:, None], -1, rows.to(torch.int32))
    vals = torch.cat([flag.to(torch.int32)[:, None], rows], dim=1)
    new = table.clone()
    new[_index(slots, table.device)] = vals
    return new


class _Probe:
    """One batch's host-side split (returned by :meth:`MatchCache.
    probe`): hit/miss positions, assigned slots, the epoch key(s), and
    the device-table *snapshot* the hits must gather from (later
    inserts produce new tensors, so the snapshot can't be clobbered).
    ``miss_keys`` is the per-miss insert key."""

    __slots__ = ("table", "key", "hit_pos", "hit_slots", "miss_pos",
                 "miss_topics", "miss_slots", "miss_keys")

    def __init__(self, table, key) -> None:
        self.table = table
        self.key = key
        self.hit_pos: List[int] = []
        self.hit_slots: List[int] = []
        self.miss_pos: List[int] = []
        self.miss_topics: List[str] = []
        self.miss_slots: List[int] = []
        self.miss_keys: List[Any] = []


class MatchCache:
    """Fixed-shape device match-row cache with a host topic index.

    ``width`` is the packed row width (``max_matches`` on one device;
    the mesh cache concatenates ids, subs and src). Eviction is a
    clock sweep over the slot ring: allocation is O(1) per miss and a
    hot entry is displaced only once the ring wraps."""

    def __init__(self, slots: int, width: int, device) -> None:
        self.slots = _pow2(max(2, int(slots)))
        self.width = int(width)
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._table = None  # lazy: int32[slots, 1 + width]
        self._index: dict = {}                     # topic -> slot
        self._slot_topic: List[Optional[str]] = [None] * self.slots
        self._slot_key: List[Any] = [None] * self.slots
        self._clock = 0
        # cumulative counters (drain_stats hands out deltas)
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.stale = 0
        self._drained = {"hit": 0, "miss": 0, "insert": 0, "stale": 0}

    # -- host bookkeeping --------------------------------------------------

    def _table_now(self) -> torch.Tensor:
        if self._table is None:
            self._table = torch.full((self.slots, 1 + self.width), -1,
                                     dtype=torch.int32, device=self.device)
        return self._table

    def _alloc(self, topic: str) -> int:
        s = self._clock
        self._clock = (s + 1) % self.slots
        old = self._slot_topic[s]
        if old is not None:
            self._index.pop(old, None)
        self._slot_topic[s] = topic
        self._slot_key[s] = None  # pending until insert() lands
        self._index[topic] = s
        return s

    def probe(self, topics: Sequence[str], key,
              keys: Optional[Sequence[Any]] = None) -> _Probe:
        """Split a batch into hits (slot per topic, key matches) and
        misses (slot assigned now, marked pending — a crash before
        :meth:`insert` just leaves a permanent miss). ``keys``
        (parallel to ``topics``) overrides ``key`` per topic: the
        router's partitioned epochs."""
        with self._lock:
            p = _Probe(self._table_now(), key)
            for i, t in enumerate(topics):
                k = key if keys is None else keys[i]
                s = self._index.get(t)
                if s is not None and self._slot_key[s] == k:
                    p.hit_pos.append(i)
                    p.hit_slots.append(s)
                    continue
                if s is not None:
                    if self._slot_key[s] is not None:
                        self.stale += 1  # pending slots aren't stale
                    self._slot_key[s] = None
                else:
                    s = self._alloc(t)
                p.miss_pos.append(i)
                p.miss_topics.append(t)
                p.miss_slots.append(s)
                p.miss_keys.append(k)
            self.hits += len(p.hit_pos)
            self.misses += len(p.miss_pos)
            return p

    # -- device ops --------------------------------------------------------

    def insert(self, probe: _Probe, rows, ovf, movf=None) -> None:
        """Store the fresh walk results for ``probe``'s misses.

        ``rows`` is the (possibly batch-padded) ``[Mb, width]`` device
        result; rows past the real miss count are not written.
        ``ovf`` rows store invalid markers, never truncated ids;
        ``movf`` (the mesh) says which of them overflowed the match."""
        n = len(probe.miss_slots)
        if n == 0:
            return
        with self._lock:
            self._table = insert_rows(self._table_now(), probe.miss_slots,
                                      rows, ovf, movf)
            for s, t, k in zip(probe.miss_slots, probe.miss_topics,
                               probe.miss_keys):
                # skip slots another batch's clock sweep reassigned
                if self._slot_topic[s] == t:
                    self._slot_key[s] = k
            self.inserts += n

    def merge(self, b_pad: int, probe: _Probe, miss_rows=None,
              miss_ovf=None, miss_movf=None):
        """The batch's combined ``(rows[b_pad, width], ovf[b_pad],
        movf[b_pad])`` device tensors. Pass the miss walk outputs (or
        nothing when the batch fully hit)."""
        return merge_rows(probe.table, probe.hit_slots, probe.hit_pos,
                          miss_rows, miss_ovf,
                          probe.miss_pos if miss_rows is not None else (),
                          b_pad, miss_movf)

    # -- introspection -----------------------------------------------------

    def entries(self) -> int:
        return len(self._index)

    def stats(self) -> dict:
        """Cumulative counters (+ hit rate)."""
        total = self.hits + self.misses
        return {
            "hit": self.hits, "miss": self.misses,
            "insert": self.inserts, "stale": self.stale,
            "entries": self.entries(),
            "hit_rate": (self.hits / total) if total else 0.0,
        }

    def drain_stats(self) -> dict:
        """Counter deltas since the previous drain."""
        with self._lock:
            cur = {"hit": self.hits, "miss": self.misses,
                   "insert": self.inserts, "stale": self.stale}
            out = {k: cur[k] - self._drained[k] for k in cur}
            self._drained = cur
            return out
