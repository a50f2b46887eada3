"""O(delta) automaton maintenance: patch instead of re-flatten.

The port of the JAX package's ``ops/patch.py`` (single device). The
reference's trie insert/delete touches O(topic depth) rows
(src/emqx_trie.erl:82-116); here an insert or delete touches
O(depth) slots of the *compressed* walk tables
(:mod:`emqx_tpu_torch.ops.csr`):

  - a **host mirror** of the device tables (``wt`` edge-hash rows +
    ``node2`` state columns, numpy) is the patching authority;
  - ``insert``/``delete`` walk the filter's words through the mirror,
    following multi-word edges with exact chain comparison. A filter
    that diverges mid-chain **splits** the edge: the slot is
    rewritten to end at a new interior state and the chain remainder
    is re-inserted as its own edge;
  - every host mutation queues a device update; :meth:`AutoPatcher.
    apply_updates` replays the queue as torch scatters into **clones**
    of the two tensors kernel B1 reads (``wt``, ``node2``) and returns
    a new :class:`~emqx_tpu_torch.ops.convert.TorchAutomaton` —
    matchers holding the old one keep running (double buffering);
  - ``delete`` is a tombstone (terminal id cleared, path kept);
  - on a mesh each trie shard has its own patcher, and
    :func:`apply_stacked_multi` drains the dirty ones into their
    shards' placed tables;
  - hop accounting: a split lengthens one walk path, so the mirror
    bumps ``hops_for_level`` (clamped at the uncompressed bound
    ``d+1``); a stale bound makes the walk flag overflow (exact host
    re-match), never truncate.

The queue is deduplicated before the scatter (last write wins): a
CUDA ``index_put_`` with repeated indices writes in no fixed order.
The JAX package pads its fixed-size chunks with out-of-range indices
(``mode="drop"``) to bound XLA compiles; torch needs neither the
chunks nor the pads, so the scatter gets exactly the live entries.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from emqx_tpu_torch import topic as T
from emqx_tpu_torch.ops.csr import (CW_PAD, NARROW_SLOT, WIDE_SLOT,
                                    Automaton, hash_mix)

_MAX_EVICT = 64


class PatchOverflow(Exception):
    """Capacity exhausted or eviction bound hit: caller must
    re-flatten (with doubled capacity). ``kind`` is the structure
    that overflowed: "state" or "edge"."""

    def __init__(self, kind: str, msg: Optional[str] = None) -> None:
        super().__init__(msg or f"{kind} capacity")
        self.kind = kind


class AutoPatcher:
    """Host mirror + device-update queue for one automaton buffer
    generation. Recreated from each full flatten."""

    def __init__(self, auto: Automaton,
                 intern: Callable[[str], int]) -> None:
        # numpy copies = the patching authority (device tensors are
        # immutable snapshots of this state + queued updates)
        self.wt = np.array(auto.wt)
        self.node2 = np.array(auto.node2)
        self.hop = np.array(auto.v2_hop)
        self.depth = np.array(auto.v2_depth)
        self.hops_for_level = np.array(auto.hops_for_level)
        self.seed = np.uint32(np.asarray(auto.wt_seed)[0])
        self.slots = int(auto.wt_slots)
        self.take = int(auto.wt_take)
        self.sw = WIDE_SLOT if self.take > 1 else NARROW_SLOT
        self.n_states = int(auto.v2_states)
        self.n_edges = int(auto.v2_edges)
        self.s_cap = int(auto.node2.shape[0])
        self.nb = int(auto.wt.shape[0])
        # fill bound: same ≤50% discipline the builder sizes for
        self.e_cap = self.nb * self.slots // 2
        self.intern = intern
        self.tombstones = 0
        self.splits = 0
        self.hops_grown = False  # steps bound changed since flatten
        # host-fallback matches observed while the hop bound is stale
        # (a split bumps only the direct child's hop, so descendants'
        # values run one low and hops_for_level can under-grow; the
        # walk's residual-overflow flag keeps results exact, and these
        # fallbacks count toward compaction)
        self.hop_fallbacks = 0
        # a PatchOverflow mid-insert leaves a dangling prefix in the
        # mirror: the patcher marks itself broken and the owner
        # re-flattens (discarding mirror + queue) before any further
        # patch or apply
        self.broken = False
        # pending device updates
        self._col: List[Tuple[int, int, int]] = []  # (col, idx, val)
        self._slot: List[Tuple[int, int]] = []      # (bucket, slot)

    # -- host-mirror edge hash ops ----------------------------------------

    def _buckets(self, state: int, word: int) -> Tuple[int, int]:
        with np.errstate(over="ignore"):
            h1, h2 = hash_mix(np.array(state, np.int32),
                              np.array(word, np.int32), self.seed)
        mask = np.uint32(self.nb - 1)
        return int(h1 & mask), int(h2 & mask)

    def _slot_view(self, b: int, s: int) -> np.ndarray:
        return self.wt[b, s * self.sw:(s + 1) * self.sw]

    def _ht_find(self, state: int, word: int):
        """(bucket, slot) of the edge keyed (state, word); None if
        absent."""
        b1, b2 = self._buckets(state, word)
        for b in (b1, b2):
            for s in range(self.slots):
                v = self._slot_view(b, s)
                if v[0] == state and v[1] == word:
                    return b, s
        return None

    def _edge_fields(self, b: int, s: int):
        """(take, child, chain_words) of the slot. The chain words
        are COPIED — a split rewrites the slot and then reads the
        original tail, so a live view would alias the clobber."""
        v = self._slot_view(b, s)
        if self.take > 1:
            return int(v[2]), int(v[3]), v[4:4 + self.take - 1].copy()
        return 1, int(v[2]), v[:0]

    def _make_row(self, state: int, word: int, take: int, child: int,
                  cw) -> np.ndarray:
        row = np.full(self.sw, -1, np.int32)
        if self.take > 1:
            row[0], row[1], row[2], row[3] = state, word, take, child
            row[4:4 + self.take - 1] = CW_PAD
            if take > 1:
                row[4:4 + take - 1] = cw[:take - 1]
        else:
            row[0], row[1], row[2] = state, word, child
        return row

    def _write_slot(self, b: int, s: int, row: np.ndarray) -> None:
        self.wt[b, s * self.sw:(s + 1) * self.sw] = row
        self._slot.append((b, s))

    def _ht_insert(self, row: np.ndarray) -> None:
        """Place one edge row; cuckoo-evict on full buckets.
        Transactional: on failure every displaced edge is restored
        and PatchOverflow tells the caller to re-flatten."""
        if self.n_edges >= self.e_cap:
            raise PatchOverflow("edge")
        undo: List[Tuple[int, int, np.ndarray]] = []

        def place(b: int, s: int, r: np.ndarray) -> None:
            undo.append((b, s, self._slot_view(b, s).copy()))
            self._write_slot(b, s, r)

        cur = row
        cb, _ = self._buckets(int(cur[0]), int(cur[1]))
        for step in range(_MAX_EVICT):
            free = [s for s in range(self.slots)
                    if self._slot_view(cb, s)[0] < 0]
            if free:
                place(cb, free[0], cur)
                self.n_edges += 1
                return
            alt1, alt2 = self._buckets(int(cur[0]), int(cur[1]))
            other = alt2 if cb == alt1 else alt1
            if any(self._slot_view(other, s)[0] < 0
                   for s in range(self.slots)):
                cb = other
                continue
            victim = step % self.slots
            vrow = self._slot_view(cb, victim).copy()
            place(cb, victim, cur)
            cur = vrow
            a1, a2 = self._buckets(int(cur[0]), int(cur[1]))
            cb = a2 if cb == a1 else a1
        for b, s, r in reversed(undo):
            self.wt[b, s * self.sw:(s + 1) * self.sw] = r
            self._slot.append((b, s))
        raise PatchOverflow("edge", "eviction bound")

    # -- column / state ops ------------------------------------------------

    _PLUS, _HASHF, _ENDF = 0, 1, 2

    def _set_col(self, col: int, idx: int, val: int) -> None:
        self.node2[idx, col] = val
        self._col.append((col, idx, val))

    def _new_state(self, depth: int, hop: int) -> int:
        if self.n_states >= self.s_cap:
            raise PatchOverflow("state")
        sid = self.n_states
        self.n_states += 1
        self.hop[sid] = hop
        self.depth[sid] = depth
        self._note_hops(depth, hop)
        return sid

    def _note_hops(self, depth: int, hop: int) -> None:
        """Keep the step bound ≥ hop+1 for every batch depth ≥ depth
        (monotone array; clamped at the uncompressed bound d+1)."""
        hl = self.hops_for_level
        if depth >= len(hl):
            # past the old max depth the walk can always fall back to
            # one hop per extra level
            d_ext = np.arange(len(hl), depth + 1, dtype=np.int64)
            ext = np.minimum(int(hl[-1]) + (d_ext - (len(hl) - 1)),
                             d_ext + 1)
            hl = np.concatenate([hl, ext.astype(hl.dtype)])
            self.hops_for_level = hl
            self.hops_grown = True
        idx = np.arange(len(hl))
        want = np.where(idx >= depth, hop + 1, 0)
        grown = np.maximum(hl, np.minimum(want, idx + 1)).astype(hl.dtype)
        if not np.array_equal(grown, hl):
            self.hops_for_level = grown
            self.hops_grown = True

    def _bump_hops_from(self, depth: int) -> None:
        """A split made every path through depth ≥ ``depth`` one hop
        longer; bump the whole tail (clamped at d+1)."""
        hl = self.hops_for_level
        idx = np.arange(len(hl))
        grown = np.where(idx >= depth,
                         np.minimum(hl + 1, idx + 1), hl).astype(hl.dtype)
        if not np.array_equal(grown, hl):
            self.hops_for_level = grown
            self.hops_grown = True

    # -- public API --------------------------------------------------------

    def insert(self, filter_: str, fid: int) -> None:
        """Add ``filter_`` terminating with filter id ``fid``.

        Raises :class:`PatchOverflow` when a re-flatten is needed; a
        mid-walk overflow flips :attr:`broken`, and the patcher then
        refuses all further work until the owner re-flattens."""
        if self.broken:
            raise PatchOverflow("state", "patcher broken")
        words = T.words(filter_)
        state = 0
        i = 0
        try:
            while i < len(words):
                w = words[i]
                if w == T.HASH:  # '#' is a leaf collapsed into parent
                    self._set_col(self._HASHF, state, fid)
                    return
                if w == T.PLUS:
                    child = int(self.node2[state, self._PLUS])
                    if child < 0:
                        child = self._new_state(
                            i + 1, int(self.hop[state]) + 1)
                        self._set_col(self._PLUS, state, child)
                    state = child
                    i += 1
                    continue
                wid = self.intern(w)
                found = self._ht_find(state, wid)
                if found is None:
                    # fresh chain: consume the maximal literal run in
                    # compressed hops (exactly what a flatten builds)
                    run = 1
                    while (i + run < len(words)
                           and words[i + run] not in (T.PLUS, T.HASH)
                           and run < self.take):
                        run += 1
                    cw = np.array([self.intern(x)
                                   for x in words[i + 1:i + run]],
                                  np.int32)
                    child = self._new_state(
                        i + run, int(self.hop[state]) + 1)
                    self._ht_insert(self._make_row(
                        state, wid, run, child, cw))
                    state = child
                    i += run
                    continue
                b, s = found
                take_e, child_e, cw_e = self._edge_fields(b, s)
                # longest shared prefix of the edge's words vs ours
                match = 1
                while match < take_e:
                    j = i + match
                    if (j >= len(words)
                            or words[j] in (T.PLUS, T.HASH)
                            or self.intern(words[j]) != int(
                                cw_e[match - 1])):
                        break
                    match += 1
                if match == take_e:
                    state = child_e
                    i += take_e
                    continue
                # split: interior state at the divergence point
                mid = self._new_state(i + match,
                                      int(self.hop[state]) + 1)
                self._write_slot(b, s, self._make_row(
                    state, wid, match, mid, cw_e))
                self._ht_insert(self._make_row(
                    mid, int(cw_e[match - 1]), take_e - match,
                    child_e, cw_e[match:]))
                self.splits += 1
                # the old child (and its whole subtree) is now one hop
                # deeper; bump the bound tail rather than renumbering
                self.hop[child_e] += 1
                self._bump_hops_from(int(self.depth[mid]))
                state = mid
                i += match
            self._set_col(self._ENDF, state, fid)
        except PatchOverflow:
            self.broken = True
            raise

    def _walk(self, words) -> int:
        """Follow ``words`` through the mirror; -1 if the path is
        absent. Returns the terminal state id."""
        state = 0
        i = 0
        while i < len(words):
            w = words[i]
            if w == T.PLUS:
                state = int(self.node2[state, self._PLUS])
                if state < 0:
                    return -1
                i += 1
                continue
            found = self._ht_find(state, self.intern(w))
            if found is None:
                return -1
            take_e, child_e, cw_e = self._edge_fields(*found)
            for t in range(take_e - 1):
                j = i + 1 + t
                if (j >= len(words) or words[j] in (T.PLUS, T.HASH)
                        or self.intern(words[j]) != int(cw_e[t])):
                    return -1
            state = child_e
            i += take_e
        return state

    def delete(self, filter_: str) -> bool:
        """Tombstone ``filter_``'s terminal marker; the path stays
        (compacted by the next full flatten). False = not found."""
        if self.broken:
            raise PatchOverflow("state", "patcher broken")
        ws = T.words(filter_)
        if ws and ws[-1] == T.HASH:
            state = self._walk(ws[:-1])
            if state < 0 or int(self.node2[state, self._HASHF]) < 0:
                return False
            self._set_col(self._HASHF, state, -1)
        else:
            state = self._walk(ws)
            if state < 0 or int(self.node2[state, self._ENDF]) < 0:
                return False
            self._set_col(self._ENDF, state, -1)
        self.tombstones += 1
        return True

    def note_hop_fallbacks(self, n: int) -> None:
        """Record ``n`` host-fallback matches. Counted only while the
        hop bound has grown since the flatten (the stale-hop regime):
        overflow from an undersized active set is ``boost_k``'s
        problem, not a rebuild trigger."""
        if self.hops_grown:
            self.hop_fallbacks += n

    def needs_compaction(self, live_filters: int) -> bool:
        """Tombstones, accumulated splits, OR stale-hop host
        fallbacks dominate: the automaton is still correct, just
        wasteful/slower — rebuild off-stream."""
        bound = max(1024, live_filters)
        return self.tombstones > bound or self.splits > bound \
            or self.hop_fallbacks > bound

    # -- device replay -----------------------------------------------------

    @property
    def dirty(self) -> bool:
        return bool(self._col or self._slot)

    @property
    def queued(self) -> int:
        """Pending device updates (the router's drain-batch signal)."""
        return len(self._col) + len(self._slot)

    def apply_updates(self, auto):
        """Replay queued host mutations onto the device automaton
        ``auto`` (a :class:`~emqx_tpu_torch.ops.convert.TorchAutomaton`),
        returning a NEW one: each updated tensor is cloned, then
        scattered into (old buffers untouched — matchers holding them
        are safe; the caller swaps atomically)."""
        assert not self.broken, \
            "partial mutations must not reach the device (re-flatten)"
        if not self.dirty:
            return auto
        col, sl = self._drain_deduped()
        return apply_drained(auto, col, sl, self.sw)._replace(
            hops_for_level=self.hops_for_level.copy())

    def _drain_deduped(self):
        """Consume + dedup the raw queues, last write wins: repeated
        indices in one scatter apply in no fixed order on the device
        (a delete+re-add of the same filter, or a cuckoo slot written
        twice, could otherwise resurrect the stale value). Slot
        updates read the mirror's CURRENT row — later host writes to
        the same slot are naturally folded."""
        col, self._col = self._col, []
        sl, self._slot = self._slot, []
        col_d = {(c, idx): val for c, idx, val in col}
        sl_d = {}
        for b, s in sl:
            sl_d[(b, s)] = self._slot_view(b, s).copy()
        return ([(c, i, v) for (c, i), v in col_d.items()],
                [(b, s, row) for (b, s), row in sl_d.items()])


def apply_drained(auto, col, sl, sw: int):
    """Scatter one deduplicated drain into clones of ``auto``'s
    ``node2`` (``col``: ``(column, state, value)``) and ``wt`` (``sl``:
    ``(bucket, slot, row)``) — the JAX package's ``_apply_jit``. Every
    index is a live entry (no pads), and no index repeats, so the
    result is the same on the CPU and on the card. A tensor with no
    update is shared, not cloned: neither is ever written in place."""
    node2, wt = auto.node2, auto.wt
    if col:
        c = np.array(col, np.int64).reshape(-1, 3)
        node2 = node2.clone()
        node2[torch.from_numpy(c[:, 1]).to(node2.device),
              torch.from_numpy(c[:, 0]).to(node2.device)] = \
            torch.from_numpy(c[:, 2].astype(np.int32)).to(node2.device)
    if sl:
        b = torch.from_numpy(np.array([e[0] for e in sl], np.int64))
        s = torch.from_numpy(np.array([e[1] for e in sl], np.int64))
        rows = torch.from_numpy(np.stack([e[2] for e in sl]))
        wt = wt.clone()
        wt.view(wt.shape[0], -1, sw)[b.to(wt.device), s.to(wt.device)] = \
            rows.to(wt.device)
    return auto._replace(node2=node2, wt=wt)


def apply_stacked_multi(patchers, stacked):
    """Drain every listed ``(shard, patcher)``'s queue into the placed
    sharded automaton (``parallel.sharded.place_sharded``): shard t's
    tables on each of its devices get the drain as one scatter into a
    clone (:func:`apply_drained`), and a clean shard keeps its tensors.
    Returns a new ``ShardedAutomaton``; matchers holding the old one
    keep running."""
    from emqx_tpu_torch.parallel.sharded import Placed

    drains = {}
    for t, p in patchers:
        assert not p.broken, \
            "partial mutations must not reach the device (re-flatten)"
        drains[t] = (*p._drain_deduped(), p.sw)
    if not drains:
        return stacked
    wt, node2 = {}, {}
    for key, x in stacked.wt.parts.items():
        y = stacked.node2.parts[key]
        if key[0] in drains:
            col, sl, sw = drains[key[0]]
            cell = apply_drained(_Tables(x, y), col, sl, sw)
            x, y = cell.wt, cell.node2
        wt[key], node2[key] = x, y
    old = stacked.wt
    return stacked._replace(
        wt=Placed(old.mesh, "trie", wt, old.shape),
        node2=Placed(old.mesh, "trie", node2, stacked.node2.shape))


class _Tables:
    """The two tensors a drain writes, in the shape
    :func:`apply_drained` takes."""

    __slots__ = ("wt", "node2")

    def __init__(self, wt, node2) -> None:
        self.wt = wt
        self.node2 = node2

    def _replace(self, wt, node2):
        return _Tables(wt, node2)
