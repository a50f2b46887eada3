"""Online delta automaton: route churn without touching the main walk
tables.

The port of the JAX package's ``ops/delta.py`` (single device). Route
**adds** batch into a small *side automaton* walked alongside the main
tables (two-probe, terminal-id union); **deletes** become a post-match
tombstone-id mask. The main tables stay unchanged between compactions,
so a route op costs milliseconds and the main walk never decays:

  - inserts patch the side automaton's own
    :class:`~emqx_tpu_torch.ops.patch.AutoPatcher` mirror — the
    copy-on-write apply touches kilobytes, not the main tables;
  - the side automaton is always **narrow** (take ≡ 1): no chains,
    so no splits and no hop decay; it re-flattens from its own small
    trie in milliseconds when its capacity doubles;
  - deletes never touch an automaton: the fid lands in a tombstone
    set, placed as a device mask that ``-1``\\ s the merged match ids
    (the id→filter map's ``None`` stays the host-side backstop).

The side walk is :func:`~emqx_tpu_torch.ops.walk_cuda.match_batch_auto`
— kernel B1 on CUDA tensors, the plain walk on CPU tensors — over the
batch the main walk already encoded. A background compaction in the
``Router`` folds the delta into the main tables; the ordered mutation
**log** replays whatever landed mid-flatten into a fresh delta
(:meth:`DeltaAutomaton.split_after`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from emqx_tpu_torch import topic as T
from emqx_tpu_torch.oracle import TrieOracle
from emqx_tpu_torch.ops import convert
from emqx_tpu_torch.ops.csr import build_automaton, finalize_automaton
from emqx_tpu_torch.ops.patch import AutoPatcher, PatchOverflow
from emqx_tpu_torch.ops.walk_cuda import match_batch_auto


class _InternTable:
    """Adapter giving :func:`build_automaton` the one method it uses
    (``intern``) over the router's word table — the delta MUST share
    the main automaton's word ids (both walks consume the same encoded
    batch)."""

    __slots__ = ("intern",)

    def __init__(self, intern: Callable[[str], int]) -> None:
        self.intern = intern


class DeltaSnapshot(NamedTuple):
    """One consistent, immutable view for lock-free matchers. ``auto``
    is None when there are no pending adds (tombstone-only delta);
    ``mask`` is None when there are no tombstones."""

    auto: Optional[convert.TorchAutomaton]  # walkable view (narrow)
    hops: Optional[np.ndarray]    # host hops_for_level of the view
    k: int                        # active-set lanes the delta walk needs
    mask: Optional[torch.Tensor]  # bool[cap] True = tombstoned fid
    version: int
    n_pending: int

    def steps_for(self, lb: int) -> int:
        hl = self.hops
        if hl is None or len(hl) == 0:
            return 1
        return int(hl[min(lb, len(hl) - 1)])


class DeltaAutomaton:
    """Pending route mutations relative to the last main flatten.

    All mutation methods are called under the router's lock (the
    word-table lock additionally guards interning); :meth:`snapshot`
    publishes an immutable view."""

    def __init__(self, intern: Callable[[str], int], device) -> None:
        self.intern = intern
        self.device = torch.device(device)
        self.trie = TrieOracle()          # pending adds, host authority
        self.fids: Dict[str, int] = {}    # pending filter → fid
        self.tombs: Set[int] = set()      # fids tombstoned in MAIN tables
        #: ordered mutation log — the replay seam the off-lock
        #: compaction splits at
        self.log: List[Tuple[str, str, int]] = []
        self.has_plus = False
        self.version = 0
        self._host_auto = None
        self._dev_auto: Optional[convert.TorchAutomaton] = None
        self._patcher: Optional[AutoPatcher] = None
        self._flatten_dirty = False   # side tables need a re-flatten
        self._grow = 1                # capacity growth on overflow
        self._mask_dirty = True
        self._mask_dev: Optional[torch.Tensor] = None
        self._mask_cap = 0
        self._snap: Optional[DeltaSnapshot] = None
        self._snap_key = None

    # -- mutation (under the router lock) ---------------------------------

    @property
    def n_pending(self) -> int:
        return len(self.fids)

    @property
    def n_tombstones(self) -> int:
        return len(self.tombs)

    def mark(self) -> int:
        """Current log position — compaction records it at freeze
        time; entries before it are folded into the flatten."""
        return len(self.log)

    def add(self, filter_: str, fid: int) -> None:
        self.trie.insert(filter_)
        self.fids[filter_] = fid
        self.log.append(("+", filter_, fid))
        if T.PLUS in T.words(filter_):
            self.has_plus = True
        self.version += 1
        if self._flatten_dirty or self._patcher is None:
            self._flatten_dirty = True
            return
        try:
            self._patcher.insert(filter_, fid)
        except PatchOverflow:
            # side tables are small: re-flatten them (ms) at the next
            # snapshot, with doubled capacity
            self._grow = 2
            self._flatten_dirty = True

    def delete(self, filter_: str, fid: int) -> None:
        """A route delete: retract a pending add, or tombstone a
        main-table fid."""
        self.log.append(("-", filter_, fid))
        self.version += 1
        if filter_ in self.fids:
            self.trie.delete(filter_)
            del self.fids[filter_]
            if not self._flatten_dirty and self._patcher is not None:
                try:
                    self._patcher.delete(filter_)
                except PatchOverflow:
                    self._flatten_dirty = True
            return
        self.tombs.add(fid)
        self._mask_dirty = True

    def split_after(self, mark: int) -> "Optional[DeltaAutomaton]":
        """A fresh delta holding only the mutations after ``mark`` —
        everything before it is in the new main tables. Replays with
        live semantics, so an add+delete pair inside the window
        cancels and a delete of a pre-mark add becomes a tombstone
        against the NEW tables."""
        fresh = DeltaAutomaton(self.intern, self.device)
        for op, f, fid in self.log[mark:]:
            if op == "+":
                fresh.add(f, fid)
            else:
                fresh.delete(f, fid)
        if not fresh.fids and not fresh.tombs:
            return None
        return fresh

    def needs_compaction(self, max_filters: int, live: int) -> bool:
        """Pending adds at the configured bound, or tombstones
        dominating the live set — fold into the main tables."""
        return (len(self.fids) >= max_filters
                or len(self.tombs) > max(1024, live))

    def invalidate_device(self) -> None:
        """Device-loss recovery: the staged device view — side walk
        tables, tombstone mask, cached snapshot — references a lost
        backend's buffers. Drop it all and mark it dirty; the next
        :meth:`snapshot` re-flattens the side trie and re-stages the
        mask on the device. The host structures (trie, fids, tombs,
        log) are untouched."""
        self._host_auto = None
        self._dev_auto = None
        self._patcher = None
        self._flatten_dirty = bool(self.fids)
        self._mask_dev = None
        self._mask_cap = 0
        self._mask_dirty = bool(self.tombs)
        self._snap = None
        self._snap_key = None

    # -- snapshot (side tables + tombstone mask) --------------------------

    def _flatten(self) -> None:
        cap = nb = None
        if self._host_auto is not None \
                and self._host_auto.node2 is not None:
            cap = self._host_auto.node2.shape[0] * self._grow
            nb = self._host_auto.wt.shape[0] * self._grow
        table = _InternTable(self.intern)
        base = build_automaton(self.trie, self.fids, table,
                               skip_hash=True)
        host = finalize_automaton(base, force_mode="narrow",
                                  state_capacity=cap, n_buckets=nb)
        self._host_auto = host
        self._dev_auto = convert.automaton(host, self.device)
        self._patcher = AutoPatcher(host, self.intern)
        self._flatten_dirty = False
        self._grow = 1

    def snapshot(self, id_cap: int, k_cap: int) -> DeltaSnapshot:
        """The current immutable view (cached by version; call under
        the router lock). ``id_cap`` sizes the tombstone mask (the
        id→filter map length); ``k_cap`` is the active-set capacity a
        wildcard-bearing delta walk gets."""
        key = (self.version, id_cap > self._mask_cap, k_cap)
        if self._snap is not None and self._snap_key == key \
                and not self._flatten_dirty and not self._mask_dirty \
                and (self._patcher is None or not self._patcher.dirty):
            return self._snap
        auto = hops = None
        if self.fids:
            if self._flatten_dirty or self._host_auto is None:
                self._flatten()
            elif self._patcher is not None and self._patcher.dirty:
                self._dev_auto = self._patcher.apply_updates(
                    self._dev_auto)
            auto = self._dev_auto
            hops = (self._patcher.hops_for_level
                    if self._patcher is not None
                    else self._host_auto.hops_for_level)
        if self.tombs:
            cap = self._mask_cap
            if cap < id_cap or cap == 0:
                cap = 16
                while cap < id_cap:
                    cap *= 2
            if self._mask_dirty or cap != self._mask_cap:
                m = np.zeros(cap, bool)
                m[np.fromiter(self.tombs, np.int64,
                              len(self.tombs))] = True
                self._mask_dev = torch.from_numpy(m).to(self.device)
                self._mask_cap = cap
                self._mask_dirty = False
            mask = self._mask_dev
        else:
            mask = None
        self._snap = DeltaSnapshot(
            auto=auto, hops=hops, k=(k_cap if self.has_plus else 1),
            mask=mask, version=self.version, n_pending=len(self.fids))
        self._snap_key = key
        return self._snap


# -- two-probe device merge -------------------------------------------------


def mask_ids(ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Post-match tombstone mask: ``-1`` every id whose mask bit is set
    — the JAX package's ``_mask_ids``, clamped lookup included (an id
    past the mask reads its last bit, as the reference's does)."""
    hit = mask[ids.clamp(0, mask.shape[0] - 1).to(torch.int64)]
    return torch.where((ids >= 0) & hit, -1, ids)


def union_packed(a: torch.Tensor, b: torch.Tensor, *, m: int):
    """Row-wise union of two packed id arrays into ``m`` slots — the
    JAX package's ``_union_packed``. Main and delta terminals are
    disjoint (a filter lives in exactly one), so union is packing;
    rows whose combined set exceeds ``m`` flag overflow (host
    fallback). Ids past slot ``m`` go to a spare column that is sliced
    off, so the scatter sees no out-of-range index."""
    cat = torch.cat([a, b], dim=1)
    valid = cat >= 0
    cnt = valid.sum(dim=1)
    pos = torch.cumsum(valid, dim=1) - 1
    idx = torch.where(valid & (pos < m), pos, m)
    out = torch.full((cat.shape[0], m + 1), -1, dtype=cat.dtype,
                     device=cat.device).scatter_(1, idx, cat)[:, :m]
    return out, cnt > m


def probe_raw(snap: DeltaSnapshot, word_ids, n_words, sys_mask,
              main_ids, main_ovf, *, m: int):
    """Two-probe merge for the RAW (``pack_ids=False``) dispatch: walk
    the side automaton over the already-encoded batch, CONCAT its raw
    emit slots onto the main walk's (downstream packing subsumes the
    union), OR the overflows, then tombstone-mask."""
    ids, ovf = main_ids, main_ovf
    if snap.auto is not None:
        res = match_batch_auto(
            snap.auto, word_ids, n_words, sys_mask, k=snap.k, m=m,
            pack_ids=False, steps=snap.steps_for(word_ids.shape[1]),
            slots=2, take=1)
        ids = torch.cat([ids, res.ids], dim=1)
        ovf = ovf | res.overflow
    if snap.mask is not None:
        ids = mask_ids(ids, snap.mask)
    return ids, ovf


def probe_packed(snap: DeltaSnapshot, word_ids, n_words, sys_mask,
                 main_ids, main_ovf, *, m: int):
    """Two-probe merge for the PACKED (``pack_ids=True``) dispatch —
    the match-cache miss walk: union into the fixed ``[B, m]`` row
    shape cache entries carry, then tombstone-mask."""
    ids, ovf = main_ids, main_ovf
    if snap.auto is not None:
        res = match_batch_auto(
            snap.auto, word_ids, n_words, sys_mask, k=snap.k, m=m,
            pack_ids=True, steps=snap.steps_for(word_ids.shape[1]),
            slots=2, take=1)
        ids, u_ovf = union_packed(ids, res.ids, m=m)
        ovf = ovf | res.overflow | u_ovf
    if snap.mask is not None:
        ids = mask_ids(ids, snap.mask)
    return ids, ovf
