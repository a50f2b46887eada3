"""The router: authoritative route state + the device matcher.

The port of the JAX package's single-device ``Router`` with its
defaults: routes are a host map ``filter → {dest: refcount}`` (the
reference's ``emqx_route`` bag, src/emqx_router.erl:113-133) over a
host trie, and the match side is the compressed automaton placed on
the router's torch device. The trie, its word table, the flatten and
the batch encoder run in C++ (``use_native=True``, the default:
:class:`~emqx_tpu_torch.ops.native.NativeEngine`, whose calls release
the GIL) or in Python (``use_native=False``:
:class:`~emqx_tpu_torch.oracle.TrieOracle`, :class:`WordTable` and
:func:`~emqx_tpu_torch.ops.csr.build_automaton`). Filter
ids are assigned exactly as the JAX package assigns them, so the same
subscribe order gives the same ids. A route add or delete never
re-flattens the table on the caller's thread:

  - **delta** (``delta=True``, the default; :mod:`.ops.delta`): adds
    land in a small side automaton walked alongside the main tables
    (kernel B1 twice a batch), deletes in a tombstone mask. Past
    ``delta_max_filters`` pending adds a background thread flattens
    the trie OFF the lock (the freeze protocol below) and swaps the
    new tables in under a short lock;
  - **patch in place** (``delta=False``; :mod:`.ops.patch`): an
    O(depth) patch of a host mirror of the main tables, drained into
    a copy-on-write clone of ``wt``/``node2`` once
    ``patch_drain_batch`` updates queue up;
  - **match cache** (``match_cache=True``, the default;
    :mod:`.ops.match_cache`): repeat topics are served from an
    epoch-guarded device table; only misses walk. A mutation bumps
    its partition's revision (a literal first level) or the global
    one, so stale rows are never served.

  - **mesh** (``mesh=make_mesh(n_data, n_trie)``; :mod:`.parallel`):
    the filter set splits over the mesh's trie shards by a stable hash,
    each shard flattened into its own tables with its own patcher, and
    a publish batch runs the collective step
    (:func:`~emqx_tpu_torch.parallel.sharded.publish_step`: kernel B1
    once per (data, trie) cell). The delta is off there, as in the JAX
    package: route churn patches its shard in place.

Matchers read one published snapshot reference and take no router
lock on the fast path. Topics the walk cannot finish (more than
``max_levels`` levels, an active set past k, lanes left after the last
hop) are flagged and re-matched exactly on the host trie — parity,
never truncation.
"""

from __future__ import annotations

import logging
import threading
import time
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from emqx_tpu_torch import faults
from emqx_tpu_torch import topic as T
from emqx_tpu_torch.device import resolve
from emqx_tpu_torch.oracle import TrieOracle
from emqx_tpu_torch.ops import convert
from emqx_tpu_torch.ops.csr import WIDE_SLOT, build_automaton
from emqx_tpu_torch.ops.match import depth_bucket
from emqx_tpu_torch.ops.patch import AutoPatcher, PatchOverflow
from emqx_tpu_torch.ops.tokenize import WordTable, encode_batch
from emqx_tpu_torch.ops.walk_cuda import match_batch_auto
from emqx_tpu_torch.profiling import timer as _ktimer
from emqx_tpu_torch.types import Route

log = logging.getLogger("emqx_tpu_torch.router")


@dataclass
class MatcherConfig:
    """The matcher knobs, with the JAX package's defaults."""

    max_levels: int = 16    # L — deeper topics go to the host trie
    active_k: int = 16      # NFA active-set capacity (overflow → host)
    max_matches: int = 64   # match output capacity
    min_batch: int = 8      # batch padding bucket floor (pow2 buckets)
    use_device: bool = True
    # filters with more subscribers than this fan out through bitmap
    # rows (the reference's ?SHARD=1024, emqx_broker_helper.erl:55)
    fanout_threshold: int = 1024
    fanout_mb: int = 16     # per-message big(bitmap)-filter slots
    # below this many live filters the broker matches on the host
    # trie: a device round trip only pays off at scale
    device_min_filters: int = 1024
    # host-regime quarantined-id bound before the stale automaton is
    # dropped and ids recycle (Router.reclaim_host_regime)
    host_reclaim_pending: int = 1024
    # packed-transfer budgets: expected matched filters / deliveries
    # per message and bitmap rows per batch (re-pack on overflow)
    pack_m: int = 8
    pack_q: int = 16
    pack_rows: int = 8
    # patch in place (delta=False): once this many device updates
    # are queued, the MUTATOR drains them into a copy-on-write clone
    # of the walk tables, so matchers rarely find a queue to drain
    patch_drain_batch: int = 256
    # publish match cache (ops/match_cache.py): repeat topics are
    # served from an epoch-guarded device table of
    # slots × (max_matches + 1) int32 (64K slots ≈ 17 MB); False
    # restores the uncached dispatch byte for byte
    match_cache: bool = True
    match_cache_slots: int = 65536
    # match-cache invalidation granularity: a filter mutation whose
    # first level is a literal bumps only that level's partition
    # revision; root wildcards bump the global one. Power of two;
    # 1 = whole-epoch invalidation
    cache_partitions: int = 64
    # delta automaton (ops/delta.py): adds go to a side automaton
    # walked beside the main tables, deletes to a tombstone mask, and
    # a background flatten folds them in off the lock. False restores
    # patch in place byte for byte
    delta: bool = True
    # pending delta adds that trigger the background compaction
    # (also bounds the side automaton's walk cost)
    delta_max_filters: int = 4096
    # the trie, word table, flatten and encoder in C++ (the host
    # library, built with g++ at first use). A failed build raises:
    # there is no silent fall back to the Python engine
    use_native: bool = True
    # a (data × trie) Mesh (parallel/mesh.py) shards the filter set over
    # the 'trie' axis and the publish batch over 'data'; matching goes
    # through parallel.sharded.publish_step. BASELINE config 5's path
    mesh: Optional[object] = None
    # per-message small-filter delivery slots of the mesh's gather: a
    # message past it host-dispatches, and filters with more members
    # than min(fanout_threshold, d) ride the bitmap path
    fanout_d: int = 128


def topic_partition(topic: str, parts: int) -> int:
    """Match-cache partition of a concrete topic: a stable hash of its
    first level (``parts`` is a power of two; crc32, not ``hash``, so
    the key is the same in every process)."""
    return zlib.crc32(topic.partition("/")[0].encode()) & (parts - 1)


def filter_partitions(filter_: str, parts: int) -> Optional[Tuple[int, ...]]:
    """Invalidation scope of a filter mutation under partitioned
    epochs: the partition indices to bump, or ``None`` when only a
    global bump is safe.

    A filter whose first level is a literal ``L`` can only change the
    match set of topics whose first level is ``L``, so bumping
    partition ``h(L)`` suffices; a root ``+`` or ``#`` → ``None``. A
    ``$share``/``$queue`` filter reaching the router verbatim bumps
    the partition of the level after the prefix *plus* the raw
    ``$share`` root; a malformed or wildcard-rooted inner filter
    falls back to ``None``."""
    root = filter_.partition("/")[0]
    if root == T.PLUS or root == T.HASH:
        return None
    p0 = zlib.crc32(root.encode()) & (parts - 1)
    if not filter_.startswith((T.SHARE_PREFIX, T.QUEUE_PREFIX)):
        return (p0,)
    try:
        inner, _opts = T.parse(filter_)
    except T.TopicError:
        return None
    iroot = inner.partition("/")[0]
    if iroot == T.PLUS or iroot == T.HASH:
        return None
    p1 = zlib.crc32(iroot.encode()) & (parts - 1)
    return (p0,) if p1 == p0 else (p0, p1)


class _FrozenIds:
    """The filter → id lookup of a frozen trie, read off the router
    lock while route ops run: the freeze-time id of a filter deleted
    since the freeze (``deleted``), else its live id."""

    __slots__ = ("live", "deleted")

    def __init__(self, live: Dict[str, int], deleted: Dict[str, int]):
        self.live = live
        self.deleted = deleted

    def __getitem__(self, filter_: str) -> int:
        fid = self.live.get(filter_)
        # the deleted map is read AFTER the live one: a delete records
        # the freeze-time id there before it drops the live entry, so
        # a delete (and re-add) racing this lookup is always seen
        fid = self.deleted.get(filter_, fid)
        if fid is None:
            raise KeyError(filter_)
        return fid


class Router:
    """Route table + device matcher (one per node)."""

    def __init__(self, config: Optional[MatcherConfig] = None,
                 node: str = "local", device=None) -> None:
        self.config = config or MatcherConfig()
        self.node = node
        mesh = self.config.mesh
        # on a mesh the router's own tensors (outputs, caches) live on
        # the mesh's home device
        self.device = resolve(device if device is not None or mesh is None
                              else mesh.home)
        if mesh is not None and self.device.type != mesh.home.type:
            raise ValueError(f"router device {self.device} is not of the "
                             f"mesh's kind ({mesh.home})")
        self._lock = threading.RLock()
        # word-table guard, finer than _lock: matchers take ONLY this
        # lock (around encode), so a long flatten under _lock never
        # stalls them. Order: _lock before _wt_lock, never the reverse
        self._wt_lock = threading.RLock()
        self._native = None
        if self.config.use_native:
            # one trie a trie shard on a mesh (the same stable shard_of
            # assignment as the Python builder)
            from emqx_tpu_torch.ops.native import (NativeEngine,
                                                   ShardedNativeEngine)

            self._native = (NativeEngine() if mesh is None else
                            ShardedNativeEngine(mesh.shape["trie"]))
        self._trie = TrieOracle() if self._native is None else None
        self._table = WordTable() if self._native is None else None
        # the engine's word-intern callable: the patcher and the delta
        # side automaton share the main word-id space
        self._intern = (self._native.intern if self._native is not None
                        else self._table.intern)
        # filter -> {dest: refcount}; bag semantics (emqx_route)
        self._routes: Dict[str, Dict[object, int]] = {}
        self._filter_ids: Dict[str, int] = {}
        self._id_to_filter: List[Optional[str]] = []
        # ids recycle only across rebuild generations: a freed id
        # waits in _pending_free until the next full flatten replaces
        # the published id map, so any map a matcher holds is
        # append-only + tombstone-only
        self._free_ids: List[int] = []
        self._pending_free: List[int] = []
        self._auto: Optional[convert.TorchAutomaton] = None
        # id→filter list the live automaton encodes: appended and
        # tombstoned in place, REPLACED (new object) on rebuild
        self._auto_map: List[Optional[str]] = []
        # (auto, map, epoch, cache_rev): one-reference read for
        # matchers (attribute assignment is atomic)
        self._published: Optional[tuple] = None
        self._dirty = True
        self._rebuilds = 0
        self._patches = 0
        # vocabulary revision: bumped when a filter INSERT completes
        # (inserts intern new words; the word table is append-only) —
        # a batch encoded at revision R is valid to dispatch only at R
        # (the mesh's pre-placed batches check it, item 13)
        self._mut_rev = 0
        # patch in place: host mirror of the live tables; None until
        # the first flatten and in delta mode. A mesh keeps ONE PATCHER
        # PER TRIE SHARD (a mutation patches exactly its shard's tables)
        self._patcher: Optional[AutoPatcher] = None
        self._shard_patchers: List[AutoPatcher] = []
        self._sharded_caps = {"state": None, "nb": None}
        self._dummy_fan = None    # publish_step's fan when only matching
        self._grow = {"state": 1, "edge": 1}  # rebuild growth factors
        # static walk parameters of the LIVE tables (host values):
        # slot layout, max take, step bounds, and whether any '+'
        # edge exists (no '+' ⇒ the active set is ≤ 1 lane, so k = 1)
        self._walk_meta = {"slots": 2, "take": 1, "hops": None,
                           "has_plus": True}
        # level-compression facts of the LIVE tables
        self._compaction = {"mode": "narrow", "chains": 0,
                            "fused_edges": 0, "ratio": 0}
        # level-bucket shapes live dispatches used: the devloss
        # re-warm replays each (Broker.warm_device_path)
        self._seen_levels: set = set()
        # lost backend (devloss.py): every match takes the host trie
        # until rebuild_device_state publishes fresh tables
        self._device_suspended = False
        self._compacting = False  # background compaction in flight
        # a background flatten that raised arms an exponential backoff
        # before the next attempt; on_bg_error(exc|None) reports the
        # outcome — it may run ON the compaction thread, so the
        # callback must only store
        self._compact_failures = 0
        self._compact_backoff_until = 0.0
        self.on_bg_error = None
        # learned active-set boost (overflow storms double k, ≤ 64);
        # _d_boost is the same for the mesh gather's delivery slots
        self._k_boost = 0
        self._d_boost = 0
        # the mesh step's device counters (int32 scalars, drained by the
        # stats flush: the host copy waits until then)
        self._dev_stats: deque = deque(maxlen=65536)
        # match cache: _cache_rev is the GLOBAL epoch guard; _part_revs
        # scope literal-rooted filter mutations to one partition. Both
        # are bumped under _lock and read by probes BEFORE the
        # automaton snapshot, so a racing mutation can only make
        # entries look stale, never fresh
        P = self.config.cache_partitions
        if P < 1 or (P & (P - 1)):
            raise ValueError(
                f"cache_partitions must be a power of two >= 1, "
                f"got {P}")
        if self.config.delta_max_filters < 1:
            raise ValueError(
                f"delta_max_filters must be >= 1, "
                f"got {self.config.delta_max_filters}")
        self._cache_rev = 0
        self._part_revs: List[int] = [0] * P
        self._bump_global = 0
        self._bump_partition = 0
        self._bump_drained = (0, 0)
        self._match_cache_obj = None
        self._sharded_cache_obj = None
        self._sharded_cache_meta = None  # (T, m, d) the table is sized for
        # delta automaton: None = empty. _pub2 is the published
        # (main snapshot, delta snapshot, delta version, k_boost) pair
        # matchers read in ONE reference; _freeze is the trie defer
        # log active while an off-lock flatten reads the trie
        self._delta = None
        self._delta_ver = 0
        self._pub2: Optional[tuple] = None
        self._freeze: Optional[dict] = None
        self._rebuild_inflight = False
        # automaton.delta.* / automaton.rebuild.* counters
        self._delta_probes = 0
        self._delta_filters = 0
        self._delta_merges = 0
        self._rebuild_stall_ms = 0.0
        self._auto_drained = (0, 0, 0, 0, 0, 0)
        # publish-path telemetry (telemetry.Telemetry), wired by Node
        # beside broker.telemetry. When enabled, the cache-split
        # dispatch leaves its probe/merge share and hit/miss split in
        # _last_dispatch for the broker's span to take; compactions
        # observe the ``rebuild`` stage
        self.telemetry = None
        self._last_dispatch: Optional[dict] = None

    # -- trie and delta plumbing ------------------------------------------

    @property
    def _delta_active(self) -> bool:
        """Delta mode in effect: configured on and not on a mesh (the
        collective step has no two-probe seam; a mesh patches its
        shards in place). Read per call, so :meth:`set_delta` can flip
        it at runtime."""
        return self.config.delta and self.config.mesh is None

    def _ensure_delta(self):
        if self._delta is None:
            from emqx_tpu_torch.ops.delta import DeltaAutomaton

            # the side automaton shares the main word-id space: both
            # walks consume the same encoded batch
            self._delta = DeltaAutomaton(self._intern, self.device)
        return self._delta

    def _t_insert(self, filter_: str, fid: int) -> None:
        with self._wt_lock:  # interning mutates the word table
            if self._native is not None:
                self._native.insert(filter_, fid)
                return
            self._trie.insert(filter_)
            # pre-intern literal words so the flatten (which may run
            # on the compaction thread) never mutates the word table
            for w in T.words(filter_):
                if w not in (T.PLUS, T.HASH):
                    self._table.intern(w)

    def _t_delete(self, filter_: str) -> None:
        if self._native is not None:
            with self._wt_lock:  # the C++ delete resolves words by intern
                self._native.delete(filter_)
        else:
            self._trie.delete(filter_)

    def _t_match(self, topic: str) -> List[str]:
        """The trie's exact match (under the lock). The native trie
        keeps filter ids: a filter deleted under a freeze is still in
        it, and its id maps to ``None`` here."""
        if self._native is None:
            return self._trie.match(topic)
        id_to_filter = self._id_to_filter
        out = []
        for fid in self._native.match(topic).tolist():
            f = id_to_filter[fid] if fid < len(id_to_filter) else None
            if f is not None:
                out.append(f)
        return out

    # -- freeze protocol (off-lock compaction) ----------------------------
    #
    # While a background flatten reads the trie OFF-lock, the trie must
    # not be mutated. Route ops landing in that window defer into
    # _freeze: the ordered log replays into the trie at swap time, and
    # the small side trie/set compensate host matches meanwhile. Word
    # interning still happens at once, so concurrently encoded batches
    # resolve the new vocabulary (the native flatten never reads the
    # word table; the Python one finds every word pre-interned).

    def _t_insert_route(self, filter_: str, fid: int) -> None:
        fz = self._freeze
        if fz is None:
            self._t_insert(filter_, fid)
            return
        fz["log"].append(("+", filter_, fid))
        fz["adds"].insert(filter_)
        fz["add_fids"][filter_] = fid
        fz["dels"].discard(filter_)
        with self._wt_lock:
            for w in T.words(filter_):
                if w not in (T.PLUS, T.HASH):
                    self._intern(w)

    def _t_delete_route(self, filter_: str, fid: int) -> None:
        fz = self._freeze
        if fz is None:
            self._t_delete(filter_)
            return
        fz["log"].append(("-", filter_, fid))
        if filter_ in fz["add_fids"]:
            fz["adds"].delete(filter_)
            del fz["add_fids"][filter_]
        else:
            fz["dels"].add(filter_)
            # the frozen Python trie still holds the filter: its
            # flatten reads the id from here once _filter_ids dropped
            # it (the native trie stores the id itself)
            fz["del_fids"].setdefault(filter_, fid)

    def _unfreeze_locked(self) -> None:
        """Replay the deferred trie mutations in order and lift the
        freeze (under the lock, after the flatten is done with the
        trie)."""
        fz = self._freeze
        if fz is None:
            return
        self._freeze = None
        self._rebuild_inflight = False
        for op, f, fid in fz["log"]:
            if op == "+":
                self._t_insert(f, fid)
            else:
                self._t_delete(f)

    def _host_match_locked(self, topic: str) -> List[str]:
        """The trie's exact match plus the freeze-window compensation:
        while an off-lock flatten holds the trie frozen, deferred adds
        come from the freeze side-trie and deferred deletes are
        subtracted (the native engine's are already dropped by the id
        map's ``None``). Exact at every instant."""
        out = self._t_match(topic)
        fz = self._freeze
        if fz is not None:
            if self._native is None and fz["dels"]:
                out = [f for f in out if f not in fz["dels"]]
            if fz["add_fids"]:
                seen = set(out)
                out = out + [f for f in fz["adds"].match(topic)
                             if f not in seen]
        return out

    # -- route table mutation (emqx_router:do_add_route/delete_route) ----

    def _assign_id(self, filter_: str) -> int:
        fid = self._filter_ids.get(filter_)
        if fid is None:
            if self._free_ids:
                fid = self._free_ids.pop()
                self._id_to_filter[fid] = filter_
            else:
                fid = len(self._id_to_filter)
                self._id_to_filter.append(filter_)
            self._filter_ids[filter_] = fid
        return fid

    def _bump_cache_rev(self, filter_: Optional[str] = None) -> None:
        """Invalidate cached match rows a mutation can affect (under
        the lock): ``None``, a filter whose scope can't be narrowed,
        or ``cache_partitions = 1`` bumps the global revision; a
        literal-rooted filter bumps only its partition(s)."""
        if filter_ is not None and self.config.cache_partitions > 1:
            parts = filter_partitions(filter_,
                                      self.config.cache_partitions)
            if parts is not None:
                for p in parts:
                    self._part_revs[p] += 1
                self._bump_partition += 1
                return
        self._cache_rev += 1
        self._bump_global += 1

    def add_route(self, filter_: str, dest: object = None) -> int:
        """Add a route; returns the filter's dense id. ``dest`` is this
        node or a ``(group, node)`` shared route on it: this port runs
        one node, and a route to another node raises ``ValueError``."""
        dest = self.node if dest is None else dest
        node = dest[1] if isinstance(dest, tuple) else dest
        if node != self.node:
            raise ValueError(f"route {filter_!r} -> {dest!r}: this port "
                             f"routes to its own node {self.node!r} only")
        with self._lock:
            dests = self._routes.get(filter_)
            fid = self._assign_id(filter_)
            if dests is None:
                dests = {}
                self._routes[filter_] = dests
                self._t_insert_route(filter_, fid)
                if self._delta_active and self._auto is not None \
                        and not self._dirty:
                    # the main tables stay unchanged: the add lands in
                    # the side automaton walked beside them
                    self._delta_add_locked(filter_, fid)
                else:
                    self._patch_insert(filter_, fid)
                # bump AFTER the insert interned its words: a batch
                # encoded concurrently then reads the OLD revision and
                # looks stale — never the reverse
                self._mut_rev += 1
                self._bump_cache_rev(filter_)
            dests[dest] = dests.get(dest, 0) + 1
            return fid

    def _delta_add_locked(self, filter_: str, fid: int) -> None:
        d = self._ensure_delta()
        with self._wt_lock:  # side-patcher insert interns new words
            d.add(filter_, fid)
        self._map_set(fid, filter_)
        self._delta_ver += 1
        self._delta_filters += 1
        if d.n_pending >= self.config.delta_max_filters:
            self._maybe_compact_locked()

    def _delta_delete_locked(self, filter_: str, fid: int) -> None:
        d = self._ensure_delta()
        with self._wt_lock:  # retracting a pending add walks words
            d.delete(filter_, fid)
        self._map_set(fid, None)
        self._delta_ver += 1
        if d.needs_compaction(self.config.delta_max_filters,
                              len(self._filter_ids)):
            self._maybe_compact_locked()

    def _maybe_compact_locked(self) -> None:
        if not self._compacting and not self._dirty \
                and self._needs_compaction_locked():
            self._schedule_compaction()

    def _patcher_for(self, filter_: str) -> Optional[AutoPatcher]:
        """The patcher owning ``filter_`` (its shard's on a mesh, the
        single mirror otherwise); None = no live patcher."""
        if self.config.mesh is not None:
            if not self._shard_patchers:
                return None
            from emqx_tpu_torch.parallel.sharded import shard_of

            return self._shard_patchers[
                shard_of(filter_, len(self._shard_patchers))]
        return self._patcher

    def _shard_live_estimate(self) -> int:
        """Per-shard live-filter estimate (a shard's compaction
        threshold compares its tombstones against ITS share of the
        filter set, not the global count)."""
        n = len(self._shard_patchers)
        return len(self._filter_ids) // n if n else len(self._filter_ids)

    def _patch_insert(self, filter_: str, fid: int) -> None:
        """O(depth) patch of the live automaton; falls back to a full
        rebuild flag on capacity overflow (under the lock)."""
        # a '+' edge revokes the k=1 fast path BEFORE the patch can
        # reach any matcher
        if not self._walk_meta["has_plus"] and T.PLUS in T.words(filter_):
            self._walk_meta["has_plus"] = True
        p = None if self._dirty else self._patcher_for(filter_)
        if p is None:
            self._dirty = True
            return
        try:
            with self._wt_lock:  # patcher.insert interns new words
                p.insert(filter_, fid)
            self._map_set(fid, filter_)
            self._patches += 1
            self._drain_if_backlogged()
        except PatchOverflow as e:
            # the patcher may hold a dangling partial insert (broken
            # flag set); _dirty forces a re-flatten before any apply
            self._grow[e.kind] = 2
            self._dirty = True

    def _patch_delete(self, filter_: str, fid: int) -> None:
        p = None if self._dirty else self._patcher_for(filter_)
        if p is None:
            self._dirty = True
            return
        with self._wt_lock:  # delete's word walk may intern
            p.delete(filter_)
        self._map_set(fid, None)
        self._patches += 1
        self._drain_if_backlogged()
        live = (self._shard_live_estimate()
                if self.config.mesh is not None
                else len(self._filter_ids))
        if p.needs_compaction(live):
            # tombstones dominate; the tombstoned automaton is still
            # correct, so compaction runs on a background thread
            self._schedule_compaction()

    def _drain_if_backlogged(self) -> None:
        """Apply queued device patches once the backlog reaches the
        drain batch — on the MUTATOR's thread, under the lock it
        already holds, so the published snapshot stays hot for
        lock-free matchers."""
        if self._dirty or self._auto is None:
            return
        q = 0
        if self._patcher is not None:
            q = self._patcher.queued
        elif self._shard_patchers:
            q = max(p.queued for p in self._shard_patchers)
        if q >= self.config.patch_drain_batch:
            self._apply_patches_locked()

    def _map_set(self, fid: int, filter_: Optional[str]) -> None:
        while fid >= len(self._auto_map):
            self._auto_map.append(None)
        self._auto_map[fid] = filter_

    def delete_route(self, filter_: str, dest: object = None) -> None:
        dest = self.node if dest is None else dest
        with self._lock:
            dests = self._routes.get(filter_)
            if dests is None or dest not in dests:
                return
            dests[dest] -= 1
            if dests[dest] <= 0:
                del dests[dest]
            if not dests:
                # no revision bump: the word table is append-only, so
                # removing a filter never invalidates an encoding
                del self._routes[filter_]
                self._drop_filter_locked(filter_)

    def _drop_filter_locked(self, filter_: str) -> None:
        """The last route for ``filter_`` went away: tombstone it out
        of the matcher (delta tombstone mask or patch in place) and
        retire its id (under the lock, AFTER removing it from
        ``_routes``)."""
        self._t_delete_route(filter_, self._filter_ids[filter_])
        fid = self._filter_ids.pop(filter_)
        self._id_to_filter[fid] = None
        self._retire_id(fid)
        if self._delta_active and self._auto is not None \
                and not self._dirty:
            self._delta_delete_locked(filter_, fid)
        else:
            self._patch_delete(filter_, fid)
        # cached rows may hold this fid — only rows of topics the
        # filter matched, all inside its partition
        self._bump_cache_rev(filter_)

    def _retire_id(self, fid: int) -> None:
        """Freed filter id → quarantine until the next flatten, or
        immediate recycle when no automaton was ever built."""
        if self._auto is None:
            self._free_ids.append(fid)
        else:
            self._pending_free.append(fid)

    def has_route(self, filter_: str) -> bool:
        return filter_ in self._routes

    def lookup_routes(self, filter_: str) -> List[Route]:
        dests = self._routes.get(filter_, {})
        return [Route(filter_, d) for d in dests]

    def has_routes(self) -> bool:
        """O(1) emptiness probe (checkpoint restore needs a fresh
        router)."""
        return bool(self._routes)

    def has_dest(self, filter_: str, dest: object) -> bool:
        return dest in self._routes.get(filter_, ())

    def filter_id(self, filter_: str) -> Optional[int]:
        return self._filter_ids.get(filter_)

    # -- durability seams (wal.py / durability.py) ------------------------

    def route_refs(self, filter_: str, dest: object) -> int:
        """Current refcount for ``(filter, dest)`` — the absolute
        value the journal records after every route mutation, so a
        doubly-replayed record is idempotent."""
        with self._lock:
            return self._routes.get(filter_, {}).get(dest, 0)

    def route_table(self) -> Dict[str, Dict[object, int]]:
        """Consistent copy of the full (filter → dest → refs) table
        (recovery's orphan-ref pruning pass reads it)."""
        with self._lock:
            return {f: dict(d) for f, d in self._routes.items()}

    def set_route_refs(self, filter_: str, dest: object,
                       refs: int) -> None:
        """Drive ``(filter, dest)`` to an absolute refcount — journal
        replay's idempotent apply (the lock is reentrant; add/delete
        keep every automaton/delta/cache side effect)."""
        with self._lock:
            cur = self._routes.get(filter_, {}).get(dest, 0)
            for _ in range(refs - cur):
                self.add_route(filter_, dest=dest)
            for _ in range(cur - refs):
                self.delete_route(filter_, dest=dest)

    def stats(self) -> Dict[str, int]:
        return {
            "routes.count": sum(len(d) for d in self._routes.values()),
            "topics.count": len(self._routes),
            "rebuilds": self._rebuilds,
            "patches": self._patches,
        }

    # -- automaton lifecycle ---------------------------------------------

    def rebuild(self):
        """Flatten the trie into a fresh automaton on the device (the
        previous one stays live for concurrent matchers until the
        swap). While an off-lock compaction flatten is in flight the
        trie is frozen — that compaction IS the rebuild, so return the
        live automaton instead of racing it."""
        with self._lock:
            if self._freeze is not None:
                return self._auto
            return self._rebuild_locked()

    def _flatten_caps(self):
        """Capacity floors of the next flatten: the live tables' rows
        and buckets times the growth a PatchOverflow requested, so
        shapes stay stable across rebuilds."""
        prev = self._auto
        if prev is None:
            return None, None
        return (prev.node2.shape[0] * self._grow["state"],
                prev.wt.shape[0] * self._grow["edge"])

    def _rebuild_locked(self):
        t0 = time.perf_counter()
        try:
            return self._rebuild_flatten_locked()
        finally:
            _ktimer.record("automaton.rebuild",
                           (time.perf_counter() - t0) * 1000.0)

    def _rebuild_flatten_locked(self):
        if self.config.mesh is not None:
            return self._rebuild_sharded_locked()
        cap_s2, nb = self._flatten_caps()
        if self._native is not None:
            host_auto = self._native.flatten(v2_state_capacity=cap_s2,
                                             n_buckets=nb)
        else:
            host_auto = build_automaton(
                self._trie, self._filter_ids, self._table,
                v2_state_capacity=cap_s2, v2_n_buckets=nb)
        self._install_walk_meta(host_auto)
        auto = convert.automaton(host_auto, self.device)
        if self._delta_active:
            # delta mode keeps no main-table mirror; the trie had
            # every mutation applied, so this flatten folds the delta
            self._patcher = None
            self._delta = None
            self._delta_ver += 1
        else:
            self._patcher = AutoPatcher(host_auto, self._intern)
        self._auto = auto
        self._auto_map = list(self._id_to_filter)  # NEW object: old
        # snapshots freeze, so quarantined ids may recycle now
        self._free_ids.extend(self._pending_free)
        self._pending_free.clear()
        self._dirty = False
        self._grow = {"state": 1, "edge": 1}
        self._rebuilds += 1
        self._bump_cache_rev()  # fresh id map: quarantined ids recycle
        self._published = (auto, self._auto_map, self._rebuilds,
                           self._cache_rev)
        self._publish_pair_locked()
        return auto

    def _rebuild_sharded_locked(self):
        """Flatten the filter set into per-shard automatons stacked over
        the mesh's trie axis (parallel/sharded.py), place them, and seed
        one :class:`AutoPatcher` per shard, so route churn patches only
        the affected shard's tables (the shard assignment is a stable
        filter hash: a mutation never reshuffles other shards)."""
        from emqx_tpu_torch.parallel.sharded import (
            ShardedFanout, build_sharded, place_sharded, shard_filters)

        mesh = self.config.mesh
        n_trie = mesh.shape["trie"]
        caps = self._sharded_caps
        grow_s = caps["state"] * self._grow["state"] \
            if caps["state"] else None
        grow_nb = caps["nb"] * self._grow["edge"] if caps["nb"] else None
        if self._native is not None:
            host_auto, parts = self._native.flatten_sharded(
                state_capacity=grow_s, n_buckets=grow_nb)
        else:
            shards = shard_filters(sorted(self._routes), n_trie)
            host_auto, parts = build_sharded(
                shards, self._filter_ids, self._table,
                state_capacity=grow_s, n_buckets=grow_nb,
                return_parts=True)
        caps["state"] = parts[0].node2.shape[0]
        caps["nb"] = parts[0].wt.shape[0]
        self._install_walk_meta(parts[0], parts=parts)
        auto = place_sharded(mesh, host_auto)
        self._shard_patchers = [AutoPatcher(p, self._intern) for p in parts]
        if self._dummy_fan is None:
            # publish_step's fan input when the caller only matches
            # (with_fanout=False): minimal, never read
            self._dummy_fan = place_sharded(mesh, ShardedFanout(
                row_ptr=np.zeros((n_trie, 2), np.int32),
                sub_ids=np.full((n_trie, 1), -1, np.int32),
                row_pairs=np.zeros((n_trie, 1, 2), np.int32)))
        self._auto = auto
        self._auto_map = list(self._id_to_filter)
        self._free_ids.extend(self._pending_free)
        self._pending_free.clear()
        self._patcher = None
        self._dirty = False
        self._grow = {"state": 1, "edge": 1}
        self._rebuilds += 1
        self._bump_cache_rev()  # fresh id map: quarantined ids recycle
        self._published = (auto, self._auto_map, self._rebuilds,
                           self._cache_rev)
        self._publish_pair_locked()
        return auto

    def _install_walk_meta(self, host_auto, parts=None) -> None:
        """Record the live tables' static walk parameters and their
        level-compression facts (under the lock). ``parts`` = the
        per-shard host automatons on a mesh."""
        pool = parts if parts is not None else [host_auto]
        self._walk_meta = {
            "slots": int(host_auto.wt_slots),
            "take": int(host_auto.wt_take),
            "hops": np.array(host_auto.hops_for_level),
            "has_plus": any(
                bool((np.asarray(p.node2)[:max(p.v2_states, 1), 0] >= 0)
                     .any()) for p in pool),
        }
        chains = fused = 0
        if int(host_auto.wt_take) > 1:
            for p in pool:
                wt = np.asarray(p.wt).reshape(-1, WIDE_SLOT)
                takes = wt[wt[:, 0] >= 0, 2]
                chains += int((takes > 1).sum())
                fused += int((takes - 1).sum())
        hops = self._walk_meta["hops"]
        levels = len(hops)
        deepest = int(hops[-1]) if levels else 0
        self._compaction = {
            "mode": "wide" if int(host_auto.wt_take) > 1 else "narrow",
            "chains": chains,
            "fused_edges": fused,
            "ratio": (1000 * (levels - deepest)) // levels
            if levels else 0,
        }

    def _steps_for(self, lb: int) -> int:
        """Scan-step bound for a batch sliced to ``lb`` levels — read
        from the live patcher (it grows the bound when a patch deepens
        a walk path) or the rebuild-time snapshot; on a mesh, the
        deepest shard's."""
        if self._shard_patchers:
            return max(
                int(p.hops_for_level[min(lb, len(p.hops_for_level) - 1)])
                for p in self._shard_patchers)
        p = self._patcher
        hl = (p.hops_for_level if p is not None
              else self._walk_meta["hops"])
        if hl is None:
            return lb + 1
        return int(hl[min(lb, len(hl) - 1)])

    def observed_levels(self) -> List[int]:
        """Level-bucket shapes live dispatches have used — the devloss
        re-warm's level axis."""
        return sorted(self._seen_levels)

    def _walk_kw(self, lb: int) -> dict:
        """Static kernel kwargs for the live tables at batch depth
        ``lb``."""
        self._seen_levels.add(int(lb))  # one set add; the re-warm reads it
        m = self._walk_meta
        return {"steps": self._steps_for(lb), "slots": m["slots"],
                "take": m["take"]}

    def _patchers_dirty(self) -> bool:
        """Does a live patcher hold queued device updates?"""
        if self._patcher is not None and self._patcher.dirty:
            return True
        return any(p.dirty for p in self._shard_patchers)

    def _needs_compaction_locked(self) -> bool:
        if self._delta_active and self._delta is not None \
                and self._auto is not None:
            return self._delta.needs_compaction(
                self.config.delta_max_filters, len(self._filter_ids))
        if self._patcher is not None:
            return self._patcher.needs_compaction(len(self._filter_ids))
        if self._shard_patchers:
            per = self._shard_live_estimate()
            return any(p.needs_compaction(per)
                       for p in self._shard_patchers)
        return False

    def _apply_patches_locked(self) -> None:
        """Drain every dirty patcher's queue into a fresh device
        automaton and publish it (under the lock). On a mesh each dirty
        shard scatters into its own placed tables."""
        if self._patcher is not None:
            self._auto = self._patcher.apply_updates(self._auto)
        else:
            from emqx_tpu_torch.ops.patch import apply_stacked_multi

            dirty = [(t, p) for t, p in enumerate(self._shard_patchers)
                     if p.dirty]
            if dirty:
                self._auto = apply_stacked_multi(dirty, self._auto)
        self._published = (self._auto, self._auto_map,
                           self._rebuilds, self._cache_rev)

    def _schedule_compaction(self) -> None:
        if self._compacting:
            return
        if self._compact_failures \
                and time.monotonic() < self._compact_backoff_until:
            # a recent compaction crashed: hold the retry until the
            # backoff elapses (correctness never depends on the
            # flatten, only memory and latency headroom do)
            return
        self._compacting = True
        offlock = self._delta_active

        def _bg():
            try:
                if offlock:
                    # delta mode: flatten OFF-lock with the freeze
                    # protocol — route ops and matchers never wait on
                    # the multi-second build
                    self._compact_offlock()
                else:
                    with self._lock:
                        # a sync rebuild may have beaten us to it
                        if not self._dirty \
                                and self._needs_compaction_locked():
                            # drain queued patches FIRST, so matchers
                            # arriving during the flatten stay on the
                            # lock-free fast path
                            if self._patchers_dirty():
                                self._apply_patches_locked()
                            self._rebuild_locked()
                self._compact_failures = 0
                cb = self.on_bg_error
                if cb is not None:
                    cb(None)
            except Exception as e:
                # the compaction thread must not die silently: the
                # crash arms a backoff-retry and reaches on_bg_error
                # (the freeze path already unfroze on its own)
                log.exception("background compaction crashed")
                self._compact_failures += 1
                self._compact_backoff_until = time.monotonic() + min(
                    2.0 ** self._compact_failures, 60.0)
                cb = self.on_bg_error
                if cb is not None:
                    cb(e)
            finally:
                self._compacting = False

        threading.Thread(target=_bg, daemon=True,
                         name="router-compaction").start()

    def retry_compaction(self) -> None:
        """Re-attempt a crashed background compaction once its backoff
        elapsed (the node's housekeeping tick calls it) — without
        this, a traffic lull after the crash would leave the rebuild
        pending until the next route op."""
        if not self._compact_failures or self._compacting \
                or time.monotonic() < self._compact_backoff_until:
            return
        with self._lock:
            need = self._auto is not None \
                and self._needs_compaction_locked()
        if need:
            self._schedule_compaction()

    def _flatten_main(self, cap_s2, nb):
        """Flatten the trie into a fresh host automaton — the ONLY
        long step of a compaction, and (under the freeze protocol) the
        only one that runs off-lock. Split out so tests can interpose
        a slow build. The native flatten is one C++ call that releases
        the GIL; the Python one holds it throughout.

        Under the freeze the trie is the freeze-time filter set. The
        native trie keeps each filter's id. For the Python trie
        ``_filter_ids`` is live: a filter deleted mid-flatten is gone
        from it, and its id comes from the freeze's ``del_fids``
        instead (the JAX package's Python-engine flatten raises
        ``KeyError`` there and its compaction fails)."""
        if faults.enabled:
            faults.fire("compaction.flatten")
        if self._native is not None:
            return self._native.flatten(v2_state_capacity=cap_s2,
                                        n_buckets=nb)
        fz = self._freeze
        ids = self._filter_ids if fz is None \
            else _FrozenIds(self._filter_ids, fz["del_fids"])
        return build_automaton(
            self._trie, ids, self._table,
            v2_state_capacity=cap_s2, v2_n_buckets=nb)

    def _compact_offlock(self) -> None:
        """Delta-mode background compaction: freeze the trie + mark
        the delta log under a SHORT lock, flatten OFF-lock (concurrent
        route ops defer into the freeze log and the next delta
        generation, concurrent matchers keep the published pair),
        then swap + replay under another short lock.
        ``automaton.rebuild.stall_ms`` counts the lock holds; the whole
        compaction is the telemetry's ``rebuild`` stage."""
        t_begin = time.perf_counter()
        with self._lock:
            t0 = time.perf_counter()
            if self._dirty or self._auto is None \
                    or not self._delta_active \
                    or not self._needs_compaction_locked():
                return
            self._freeze = {"log": [], "adds": TrieOracle(),
                            "add_fids": {}, "dels": set(),
                            "del_fids": {}}
            self._rebuild_inflight = True
            mark = self._delta.mark() if self._delta is not None else 0
            n_pend = len(self._pending_free)
            cap_s2, nb = self._flatten_caps()
            stall = time.perf_counter() - t0
        try:
            t_fl = time.perf_counter()
            host_auto = self._flatten_main(cap_s2, nb)
            # the upload runs on this thread, on the default stream
            auto = convert.automaton(host_auto, self.device)
            _ktimer.record("automaton.rebuild",
                           (time.perf_counter() - t_fl) * 1000.0)
        except BaseException:
            with self._lock:
                self._unfreeze_locked()
            raise
        with self._lock:
            t1 = time.perf_counter()
            self._install_walk_meta(host_auto)
            self._auto = auto
            self._patcher = None  # delta mode: no main-table mirror
            self._auto_map = list(self._id_to_filter)
            # recycle ONLY ids quarantined before the freeze: an id
            # freed DURING the flatten may still be emitted by the new
            # tables (its path was in the snapshot) — it waits a
            # generation
            self._free_ids.extend(self._pending_free[:n_pend])
            del self._pending_free[:n_pend]
            self._dirty = False
            self._grow = {"state": 1, "edge": 1}
            self._rebuilds += 1
            self._bump_cache_rev()
            self._published = (auto, self._auto_map, self._rebuilds,
                               self._cache_rev)
            # fold: log entries before the mark are in the new tables;
            # the rest replay into a fresh delta generation
            if self._delta is not None:
                self._delta = self._delta.split_after(mark)
            self._delta_ver += 1
            self._delta_merges += 1
            self._unfreeze_locked()
            self._publish_pair_locked()
            stall += time.perf_counter() - t1
        self._rebuild_stall_ms += stall * 1000.0
        tel = self.telemetry
        if tel is not None and tel.enabled:
            tel.observe_stage(
                "rebuild", (time.perf_counter() - t_begin) * 1000.0)

    def automaton(self) -> tuple:
        """``(automaton, id→filter snapshot, epoch)`` — a consistent
        triple. The epoch (rebuild counter) keys the fan-out tables to
        this snapshot's id space. The fast path is one lock-free
        reference read; the lock is taken only to flatten (first
        build, or a capacity overflow) or to drain queued patches."""
        return self.snapshot_cached()[:3]

    def snapshot_cached(self) -> tuple:
        """:meth:`automaton` plus the snapshot's cache revision,
        stamped at publish time under the lock."""
        pub = self._published
        if pub is not None and not self._dirty \
                and not self._patchers_dirty():
            return pub
        with self._lock:
            return self._sync_locked()

    def _sync_locked(self) -> tuple:
        """Bring the published snapshot current (under the lock). The
        dirty check comes FIRST: a broken patcher's partial queue is
        discarded by the rebuild before it could ever be applied. A
        frozen trie defers the rebuild to that compaction's swap."""
        if self._dirty or self._auto is None:
            if self._freeze is None:
                self._rebuild_locked()
        elif self._patchers_dirty():
            self._apply_patches_locked()
        return self._published

    # -- published (main, delta) pair -------------------------------------

    def _publish_pair_locked(self) -> None:
        """Re-publish the (main snapshot, delta snapshot, version,
        k_boost) tuple matchers read in one reference (under the lock,
        after a main swap or, lazily from the match path, after delta
        mutations)."""
        if not self._delta_active:
            self._pub2 = None
            return
        main = self._published
        if main is not None and main[3] != self._cache_rev:
            # re-stamp the main snapshot's cache revision: in delta
            # mode a mutation never dirties the main tables, so the
            # snapshot would otherwise keep its flatten-time revision
            # and globally bumped cache entries would probe as fresh
            main = (main[0], main[1], main[2], self._cache_rev)
            self._published = main
        d = self._delta
        snap = None
        if d is not None and (d.n_pending or d.tombs):
            k_cap = max(self.config.active_k, self._k_boost)
            with self._wt_lock:  # a deferred-build flatten may intern
                snap = d.snapshot(len(self._id_to_filter), k_cap)
        self._pub2 = (main, snap, self._delta_ver, self._k_boost)

    def _snapshot_pair(self):
        """Consistent ``((auto, id_map, epoch, rev), delta_snap)`` for
        the two-probe match path: one reference read, or the lock to
        refresh a stale delta snapshot (milliseconds) or build the
        first automaton."""
        pair = self._pub2
        if pair is not None and not self._dirty \
                and pair[0] is self._published \
                and pair[2] == self._delta_ver \
                and pair[3] == self._k_boost:
            return pair[0], pair[1]
        with self._lock:
            self._sync_locked()
            self._publish_pair_locked()
            pair = self._pub2
            return pair[0], pair[1]

    # -- matching (emqx_router:match_routes/1) ----------------------------

    def host_match(self, topic: str) -> List[str]:
        """Host-side exact match (the overflow re-match path)."""
        with self._lock:
            return self._host_match_locked(topic)

    def use_device_now(self) -> bool:
        """Device matching pays a fixed round trip, so it runs only
        past ``device_min_filters`` live filters (and never with
        ``use_device=False``, nor while the device is suspended)."""
        cfg = self.config
        if not cfg.use_device or not self._routes:
            return False
        if self._device_suspended:
            # lost backend: every published device snapshot points at
            # dead buffers — host trie until the rebuild publishes
            # fresh tables (devloss.py)
            return False
        if cfg.mesh is not None:
            # a configured mesh is an explicit opt-in to sharded device
            # matching: no threshold
            return True
        return len(self._filter_ids) >= cfg.device_min_filters

    def reclaim_host_regime(self) -> None:
        """Called by the publish path when it chose the HOST regime:
        if a previously published automaton's id quarantine has grown
        past ``host_reclaim_pending``, drop the automaton (the next
        device use re-flattens from scratch) and drain the ids.

        The bound is hysteresis: a filter count oscillating around
        ``device_min_filters`` must not pay a full re-flatten per
        crossing, and without any reclaim a broker that crossed the
        threshold once and fell back would pin ``_pending_free``
        forever. In-flight matchers hold their own snapshot
        references, and recycling only mutates the live list."""
        if self._auto is None or \
                len(self._pending_free) <= self.config.host_reclaim_pending:
            return
        with self._lock:
            if self._auto is None or len(self._pending_free) <= \
                    self.config.host_reclaim_pending:
                return
            if self._freeze is not None:
                # an off-lock compaction flatten is mid-flight; its
                # swap recycles the quarantine anyway
                return
            self._auto = None
            self._published = None
            self._patcher = None
            self._shard_patchers = []
            # the delta's pending adds and deletes are all in the trie
            # (mutations apply immediately outside a freeze), so the
            # next flatten re-derives them
            self._delta = None
            self._delta_ver += 1
            self._pub2 = None
            self._dirty = True  # next device use must re-flatten
            self._free_ids.extend(self._pending_free)
            self._pending_free.clear()
            self._bump_cache_rev()  # drained ids may recycle

    # -- device-loss recovery (devloss.py) --------------------------------

    def suspend_device(self) -> None:
        """Lost-backend classification, step 0: route every match
        through the host trie until :meth:`rebuild_device_state`
        publishes fresh tables. One attribute write — matchers that
        would have read dead device buffers (publish dispatch,
        retained replay, ``match_filters``) take the exact host path
        instead."""
        self._device_suspended = True
        log.error("device matching suspended: backend lost — host "
                  "trie serves until the rebuild publishes")

    def device_suspended(self) -> bool:
        return self._device_suspended

    def match_filters_host(self, topics: Sequence[str]) -> List[List[str]]:
        """Host-only batch match — the breaker's exact fallback. It
        never consults the device, whatever ``use_device_now()`` says:
        an open or rebuilding breaker means the device is suspect."""
        if not topics:
            return []
        with self._lock:
            return [self._host_match_locked(t) for t in topics]

    def _quarantine_locked(self) -> None:
        """Drop every published reference to the lost backend's
        device state (under the lock, device already suspended): the
        published (main, delta) snapshots, the match cache (its
        gathers would read dead buffers — cold start) and the delta's
        staged device view. The host structures — trie, route table,
        word table, filter ids — are untouched: they are what the
        rebuild reads."""
        self._published = None
        self._pub2 = None
        self._match_cache_obj = None
        self._sharded_cache_obj = None
        self._sharded_cache_meta = None
        self._dummy_fan = None
        if self._delta is not None:
            self._delta.invalidate_device()
        self._bump_cache_rev()

    def rebuild_device_state(self) -> dict:
        """Device-loss recovery (devloss.DeviceRecovery): quarantine
        the dead published snapshot and rebuild ALL device-resident
        state from the host structures — the trie re-flattens to fresh
        tables on the router's device, the delta side automaton and
        tombstone mask re-stage, and the match cache starts cold under
        a global epoch bump, so no stale cached row can serve.

        Delta mode reuses the off-lock freeze protocol: the flatten
        runs OFF the router lock, so route ops arriving mid-rebuild
        complete in milliseconds (into the freeze log and the next
        delta generation) and host matches stay exact. Without delta
        the rebuild holds the lock, and route ops wait for the
        flatten.

        Raises when the fresh placement fails (backend still dead, or
        dead again mid-rebuild) — the recovery loop retries with
        backoff. On success the suspension lifts."""
        # claim the compaction slot: a background flatten may be
        # mid-flight against the dead device — wait it out (its own
        # error handling arms the compaction backoff)
        deadline = time.monotonic() + 120.0
        while True:
            with self._lock:
                if not self._compacting and self._freeze is None:
                    self._compacting = True
                    break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    "device-state rebuild: background compaction "
                    "would not yield")
            time.sleep(0.01)
        t0 = time.perf_counter()
        try:
            if faults.enabled:
                faults.fire("device.lost")
            with self._lock:
                offlock = (self._delta_active and self._auto is not None
                           and not self._dirty)
            if offlock:
                self._rebuild_devloss_offlock()
            else:
                with self._lock:
                    self._quarantine_locked()
                    self._dirty = True
                    self._rebuild_locked()
                    self._device_suspended = False
        finally:
            self._compacting = False
        return {"rebuild_s": time.perf_counter() - t0,
                "epoch": self._rebuilds,
                "filters": len(self._filter_ids)}

    def _rebuild_devloss_offlock(self) -> None:
        """The delta-mode rebuild body: freeze + quarantine under a
        short lock, flatten off-lock, place fresh tables, swap +
        replay under another short lock — :meth:`_compact_offlock`'s
        protocol with the quarantine folded into the freeze window
        (route ops landing mid-rebuild go to the freeze log AND the
        live delta, so the swap's ``split_after`` re-stages them
        against the fresh id map exactly as a compaction would)."""
        with self._lock:
            self._quarantine_locked()
            self._freeze = {"log": [], "adds": TrieOracle(),
                            "add_fids": {}, "dels": set(),
                            "del_fids": {}}
            self._rebuild_inflight = True
            mark = self._delta.mark() if self._delta is not None else 0
            n_pend = len(self._pending_free)
            cap_s2, nb = self._flatten_caps()
        try:
            host_auto = self._flatten_main(cap_s2, nb)
            if faults.enabled:
                faults.fire("device.lost")
            auto = convert.automaton(host_auto, self.device)
        except BaseException:
            with self._lock:
                self._unfreeze_locked()
            raise
        with self._lock:
            self._install_walk_meta(host_auto)
            self._auto = auto
            self._patcher = None  # delta mode: no main-table mirror
            self._auto_map = list(self._id_to_filter)
            # recycle ONLY ids quarantined before the freeze (the
            # compaction rule: an id freed mid-flatten waits a
            # generation)
            self._free_ids.extend(self._pending_free[:n_pend])
            del self._pending_free[:n_pend]
            self._dirty = False
            self._grow = {"state": 1, "edge": 1}
            self._rebuilds += 1
            self._bump_cache_rev()
            self._published = (auto, self._auto_map, self._rebuilds,
                               self._cache_rev)
            if self._delta is not None:
                self._delta = self._delta.split_after(mark)
            self._delta_ver += 1
            self._unfreeze_locked()
            self._publish_pair_locked()
            self._device_suspended = False

    def _bucket(self, n: int) -> int:
        bucket = self.config.min_batch
        while bucket < n:
            bucket *= 2
        return bucket

    def _encode_padded(self, topics: Sequence[str]):
        """Pad to a power-of-two bucket with ``"\\x00/pad"``, encode
        (under the word-table lock) and slice to the batch's depth:
        host arrays ``(ids, n, sysm)``."""
        padded = list(topics) + \
            ["\x00/pad"] * (self._bucket(len(topics)) - len(topics))
        with self._wt_lock:
            if self._native is not None:
                ids, n, sysm = self._native.encode_batch(
                    padded, self.config.max_levels)
            else:
                ids, n, sysm = encode_batch(self._table, padded,
                                            self.config.max_levels)
        ids, n = depth_bucket(ids, n)
        return ids, n, sysm

    def _place(self, ids, n, sysm):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in (ids, n, sysm))

    def walk_inputs(self, topics: Sequence[str]):
        """The main walk's inputs for a topic batch, as the uncached
        dispatch builds them: ``((word_ids, n_words, sys_mask) on the
        device, walk kwargs)`` for the live tables (call after
        :meth:`automaton`)."""
        ids, n, sysm = self._encode_padded(topics)
        kw = {"k": self.effective_k(), "m": self.config.max_matches,
              "pack_ids": False, **self._walk_kw(ids.shape[1])}
        return self._place(ids, n, sysm), kw

    def match_dispatch(self, topics: Sequence[str]):
        """Device match of a topic batch, with no device→host sync.

        Returns ``(ids, ovf, id_map, epoch)``: id rows ``[B_pad, W]``
        and overflow flags ``[B_pad]`` on the device, plus the
        snapshot that gives the ids meaning. With the match cache the
        rows are packed (``W = max_matches``); without it they are the
        walk's raw emit slots (``W = steps·2k``), with the delta
        walk's raw emits concatenated after them when a delta is
        pending. The walks are
        :func:`~emqx_tpu_torch.ops.walk_cuda.match_batch_auto` —
        kernel B1 on CUDA."""
        cfg = self.config
        if cfg.mesh is not None:
            return self._match_dispatch_sharded(topics)
        cache = self._match_cache()
        if cache is not None:
            return self._match_dispatch_cached(topics, cache)
        dsnap = None
        if self._delta_active:
            main, dsnap = self._snapshot_pair()
            auto, id_map, epoch = main[:3]
        else:
            auto, id_map, epoch = self.automaton()
        ids, n, sysm = self._encode_padded(topics)
        args = self._place(ids, n, sysm)
        res = match_batch_auto(auto, *args, k=self.effective_k(),
                               m=cfg.max_matches, pack_ids=False,
                               **self._walk_kw(ids.shape[1]))
        out_ids, out_ovf = res.ids, res.overflow
        if dsnap is not None:
            # two-probe: union the side automaton's raw emits and
            # tombstone-mask deleted fids
            from emqx_tpu_torch.ops.delta import probe_raw

            self._delta_probes += 1
            out_ids, out_ovf = probe_raw(dsnap, *args, out_ids, out_ovf,
                                         m=cfg.max_matches)
        return out_ids, out_ovf, id_map, epoch

    # -- publish match cache (ops/match_cache.py) -------------------------

    def _match_cache(self):
        """The publish match cache, built lazily (None = disabled)."""
        cfg = self.config
        if not cfg.match_cache or cfg.match_cache_slots <= 0:
            return None
        if self._match_cache_obj is None:
            from emqx_tpu_torch.ops.match_cache import MatchCache

            self._match_cache_obj = MatchCache(
                cfg.match_cache_slots, cfg.max_matches, self.device)
        return self._match_cache_obj

    def _match_dispatch_cached(self, topics: Sequence[str], cache):
        """Cache-split device match: probe the epoch-guarded cache,
        walk ONLY the misses (``pack_ids=True``), insert their rows
        and merge one ``[B_pad, max_matches]`` id array. Same contract
        as the uncached dispatch: all device values, no sync.

        Ordering: ``k_boost`` and the partition revisions are read
        BEFORE the automaton snapshot, so a racing mutation can only
        make fresh results look stale (re-walked, safe) — never stale
        results look fresh."""
        cfg = self.config
        k_boost = self._k_boost
        part_snap = (tuple(self._part_revs)
                     if cfg.cache_partitions > 1 else None)
        dsnap = None
        if self._delta_active:
            main, dsnap = self._snapshot_pair()
            auto, id_map, epoch, rev = main
        else:
            auto, id_map, epoch, rev = self.snapshot_cached()
        key = (epoch, rev, k_boost)
        keys = None
        if part_snap is not None:
            mask = cfg.cache_partitions - 1
            keys = [key + (part_snap[zlib.crc32(
                t.partition("/")[0].encode()) & mask],)
                for t in topics]
        bucket = self._bucket(len(topics))
        tel = self.telemetry
        timed = tel is not None and tel.enabled
        t0 = time.perf_counter() if timed else 0.0
        probe = cache.probe(topics, key, keys)
        t1 = time.perf_counter() if timed else 0.0
        miss_rows = miss_ovf = None
        if probe.miss_topics:
            ids, n, sysm = self._encode_padded(probe.miss_topics)
            args = self._place(ids, n, sysm)
            res = match_batch_auto(auto, *args, k=self.effective_k(),
                                   m=cfg.max_matches, pack_ids=True,
                                   **self._walk_kw(ids.shape[1]))
            miss_rows, miss_ovf = res.ids, res.overflow
            if dsnap is not None:
                # two-probe: fold the side automaton and tombstone
                # mask into the rows the cache stores — a later delta
                # mutation bumps the revision, so they never serve
                # stale
                from emqx_tpu_torch.ops.delta import probe_packed

                self._delta_probes += 1
                miss_rows, miss_ovf = probe_packed(
                    dsnap, *args, miss_rows, miss_ovf, m=cfg.max_matches)
            cache.insert(probe, miss_rows, miss_ovf)
        t2 = time.perf_counter() if timed else 0.0
        ids_dev, ovf_dev, _movf = cache.merge(bucket, probe, miss_rows,
                                              miss_ovf)
        if timed:
            # probe (host hash walk) + merge (row-gather dispatch) =
            # the cache_gather share of this dispatch; the rest
            # (encode, miss walk, insert) is the match share
            self._last_dispatch = {
                "hit": len(probe.hit_pos),
                "miss": len(probe.miss_topics),
                "cache_gather_ms": ((t1 - t0) + (
                    time.perf_counter() - t2)) * 1000.0,
            }
        return ids_dev, ovf_dev, id_map, epoch

    def drain_cache_stats(self) -> Dict[str, int]:
        """Match-cache counter deltas since the last drain (hit, miss,
        insert, stale) plus the epoch-bump split (``bump.global`` /
        ``bump.partition``) — folded into Metrics under the
        ``cache.match.`` prefix."""
        out: Dict[str, int] = {}
        for c in (self._match_cache_obj, self._sharded_cache_obj):
            if c is None:
                continue
            for k2, v in c.drain_stats().items():
                out[k2] = out.get(k2, 0) + v
        cfg = self.config
        if cfg.match_cache and cfg.match_cache_slots > 0:
            g, p = self._bump_global, self._bump_partition
            out["bump.global"] = g - self._bump_drained[0]
            out["bump.partition"] = p - self._bump_drained[1]
            self._bump_drained = (g, p)
        return out

    def cache_bump_totals(self) -> Dict[str, int]:
        """Cumulative epoch-bump split (not deltas)."""
        return {"global": self._bump_global,
                "partition": self._bump_partition}

    def cache_entries(self) -> int:
        """Live entries across the publish match caches (gauge)."""
        return sum(c.entries() for c in
                   (self._match_cache_obj, self._sharded_cache_obj)
                   if c is not None)

    def cache_partitions_live(self) -> int:
        """Partition epoch keys in effect: 0 = cache disabled, 1 =
        whole-epoch, else ``cache_partitions``."""
        cfg = self.config
        if not cfg.match_cache or cfg.match_cache_slots <= 0:
            return 0
        return cfg.cache_partitions

    def effective_k(self) -> int:
        """Active-set capacity: configured + learned boost, or 1 when
        the live automaton has no ``+`` edge at all."""
        if not self._walk_meta["has_plus"]:
            return max(1, self._k_boost)
        return max(self.config.active_k, self._k_boost)

    def boost_k(self, cap: int = 64) -> bool:
        """Double the effective active-set capacity (≤ ``cap``) when a
        batch's overflow rate shows k undersizes the workload."""
        with self._lock:
            k = self.effective_k()
            if k >= cap:
                return False
            self._k_boost = min(k * 2, cap)
            return True

    def effective_d(self) -> int:
        """Configured per-topic fan-out slots of the mesh gather plus
        any learned boost (learned like k, from fan-only overflow)."""
        return max(self.config.fanout_d, self._d_boost)

    def boost_d(self, cap: int = 1024) -> bool:
        """Double the mesh gather's per-topic delivery slots (≤ ``cap``)
        when a batch's FAN-ONLY overflow rate shows ``d`` undersizes
        the live fan-out (exact host fallback in the meantime, as with
        :meth:`boost_k`)."""
        with self._lock:
            d = self.effective_d()
            if d >= cap:
                return False
            self._d_boost = min(d * 2, cap)
            return True

    def note_match_fallbacks(self, n: int) -> None:
        """The publish path re-matched ``n`` topics on the host. In
        the stale-hop regime (a patch split deepened walk paths past
        the mirror's hop accounting) those fallbacks are the signal
        the automaton needs a compacting rebuild: forward the count to
        the live patcher and schedule compaction once it dominates."""
        if n <= 0:
            return
        with self._lock:
            pool = ([self._patcher] if self._patcher is not None
                    else self._shard_patchers)
            for p in pool:
                p.note_hop_fallbacks(n)
            if pool and not self._dirty and not self._compacting \
                    and self._needs_compaction_locked():
                self._schedule_compaction()

    def set_delta(self, enabled: bool) -> None:
        """Flip delta mode at runtime: wait out any background
        compaction, then one synchronous rebuild folds whatever the
        outgoing mode had pending and re-publishes under the new
        mode."""
        while self._compacting:
            time.sleep(0.005)
        with self._lock:
            self.config.delta = bool(enabled)
            if self._auto is not None and self._freeze is None:
                self._rebuild_locked()
            else:
                self._publish_pair_locked()

    def drain_automaton_stats(self) -> Dict[str, int]:
        """Delta/rebuild counter deltas since the last drain — folded
        into Metrics under the ``automaton.`` prefix."""
        comp = self._compaction
        cur = (self._delta_probes, self._delta_filters,
               self._delta_merges, int(self._rebuild_stall_ms),
               comp["fused_edges"], comp["chains"])
        prev = self._auto_drained
        self._auto_drained = cur
        return {
            "delta.probes": cur[0] - prev[0],
            "delta.filters": cur[1] - prev[1],
            "delta.merges": cur[2] - prev[2],
            "rebuild.stall_ms": cur[3] - prev[3],
            # table-state gauges carried as deltas (a rebuild may
            # shrink them)
            "compaction.fused_edges": cur[4] - prev[4],
            "compaction.chains": cur[5] - prev[5],
        }

    def walk_info(self) -> Dict[str, object]:
        """Live walk facts: the variant a dispatch runs now (``cuda``,
        kernel B1, or ``torch``, its plain twin on the CPU) and the
        level-compression snapshot of the live tables (mode, fused
        chains, permille of deepest-walk steps saved)."""
        variant = "cuda" if self.device.type == "cuda" else "torch"
        return {"variant": variant, **self._compaction}

    def quarantined_ids(self) -> int:
        """Freed filter ids quarantined until the next flatten (the
        ``router.ids.quarantined`` gauge: sustained growth without a
        rebuild means churn is outpacing compaction)."""
        return len(self._pending_free)

    def delta_info(self) -> Dict[str, object]:
        """Live delta-automaton state (cumulative counters)."""
        d = self._delta
        return {
            "active": self._delta_active,
            "pending": d.n_pending if d is not None else 0,
            "tombstones": d.n_tombstones if d is not None else 0,
            "probes": self._delta_probes,
            "filters": self._delta_filters,
            "merges": self._delta_merges,
            "rebuild_stall_ms": round(self._rebuild_stall_ms, 3),
            "rebuild_inflight": self._rebuild_inflight,
        }

    def match_ids(self, topics: Sequence[str]):
        """Device match of a topic batch in snapshot-id space.

        Returns ``(ids_dev, ids_np, ovf_np, id_map, epoch)``:
        ``ids_dev`` is the device id array, ``ids_np``/``ovf_np`` host
        copies sliced to ``len(topics)``, and ``(id_map, epoch)`` the
        snapshot that gives the ids meaning. Rows with ``ovf_np`` set
        exceeded a kernel bound — resolve them via :meth:`host_match`."""
        B = len(topics)
        ids_dev, ovf_dev, id_map, epoch = self.match_dispatch(topics)
        # on a mesh: the collective step's [B_pad, T·m] ids
        ids_np = ids_dev[:B].cpu().numpy()
        ovf_np = ovf_dev[:B].cpu().numpy()
        return ids_dev, ids_np, ovf_np, id_map, epoch

    # -- the mesh (parallel/sharded.py) ----------------------------------

    def _match_dispatch_sharded(self, topics: Sequence[str]):
        """Mesh match dispatch: the batch splits over the mesh's
        ``data`` axis, each trie shard matches its slice, and the match
        ids concatenate over ``trie``; no device→host sync (the
        :meth:`match_dispatch` contract, ids ``[B_pad, T·m]``)."""
        all_ids, _subs, _src, ovf, _movf, id_map, epoch = \
            self._dispatch_sharded(topics, fan=None)
        return all_ids, ovf, id_map, epoch

    def publish_dispatch_sharded(self, topics: Sequence[str],
                                 fan_provider, placed=None):
        """The mesh publish dispatch: match AND fan-out in one
        collective step (``parallel.sharded.publish_step`` with the
        per-shard fan tables).

        ``fan_provider(epoch, id_map) -> ShardedFanoutState | None``
        supplies fan tables (CSR + big-filter bitmaps) consistent with
        the automaton snapshot (the broker's FanoutManager). ``placed``
        (from :meth:`encode_place_sharded`) skips the host encode and
        the copy to the devices. Returns ``(ids [B_pad, T·m],
        subs [B_pad, T·d], src [B_pad, T·d], bm [(union, has_big, bovf)
        | None], ovf [B_pad], movf [B_pad], id_map, epoch, big_fids)``
        — ``movf`` is the match-only overflow (the ``boost_k`` signal;
        a fan-out overflow must not grow k); no device→host sync.

        With the match cache on (and no big-filter bitmaps live),
        repeat topics skip the collective step: their cached (ids,
        subs, src) rows gather from the device and only the misses
        walk. A pre-``placed`` batch bypasses the cache."""
        if placed is None and topics is not None:
            out = self._sharded_dispatch_cached(topics, fan_provider)
            if out is not None:
                return out
        return self._dispatch_sharded(topics, fan=fan_provider,
                                      with_big=True, placed=placed)

    def _sharded_cache_for(self, n_trie: int, d: int):
        """The mesh publish cache, sized for the CURRENT (T, m, d) row
        widths — a ``boost_d`` regrows it (its entries were keyed to
        the old d anyway)."""
        from emqx_tpu_torch.ops.match_cache import MatchCache

        cfg = self.config
        meta = (n_trie, cfg.max_matches, d)
        if self._sharded_cache_obj is None \
                or self._sharded_cache_meta != meta:
            width = n_trie * cfg.max_matches + 2 * n_trie * d
            self._sharded_cache_obj = MatchCache(
                cfg.match_cache_slots, width, self.device)
            self._sharded_cache_meta = meta
        return self._sharded_cache_obj

    def _sharded_dispatch_cached(self, topics: Sequence[str],
                                 fan_provider):
        """Cache-split mesh publish dispatch, or None when the cache
        does not apply (disabled, no fan state, or big-filter bitmaps
        live: a union row is ``W`` words, past any per-entry budget).

        One entry is a topic's concatenated (match ids [T·m], gathered
        subs [T·d], src [T·d]) rows — everything the collective step
        produces for it but the per-step counters (``device.*`` counts
        WALKED topics only; the hit counters carry the rest)."""
        cfg = self.config
        if not cfg.match_cache or cfg.match_cache_slots <= 0:
            return None
        boosts = (self._k_boost, self._d_boost)
        # partition revisions read BEFORE the automaton snapshot (the
        # single-device path's stale-not-fresh ordering)
        part_snap = (tuple(self._part_revs)
                     if cfg.cache_partitions > 1 else None)
        auto, id_map, epoch, rev = self.snapshot_cached()
        st = fan_provider(epoch, id_map)
        if st is None or st.fan is None or st.bm is not None \
                or st.big_fids:
            return None
        d = self.effective_d()
        n_trie = cfg.mesh.shape["trie"]
        cache = self._sharded_cache_for(n_trie, d)
        key = (epoch, rev, boosts, st.version)
        keys = None
        if part_snap is not None:
            mask = cfg.cache_partitions - 1
            keys = [key + (part_snap[zlib.crc32(
                t.partition("/")[0].encode()) & mask],)
                for t in topics]
        bucket = self._mesh_bucket(len(topics))
        tel = self.telemetry
        timed = tel is not None and tel.enabled
        t0 = time.perf_counter() if timed else 0.0
        probe = cache.probe(topics, key, keys)
        t1 = time.perf_counter() if timed else 0.0
        miss_rows = miss_ovf = miss_movf = None
        if probe.miss_topics:
            (m_ids, m_subs, m_src, m_bm, m_ovf, m_movf, m_map,
             m_epoch, m_big) = self._dispatch_sharded(
                probe.miss_topics, fan=lambda e, im: st, with_big=True)
            if m_bm is not None or m_big or m_subs is None \
                    or m_epoch != epoch:
                # the snapshot moved (or big filters appeared) while
                # we split: abandon the cached path for this batch —
                # the pending miss slots stay keyless (a permanent
                # miss), and the caller runs the uncached dispatch
                return None
            miss_rows = torch.cat([m_ids, m_subs, m_src], dim=1)
            miss_ovf, miss_movf = m_ovf, m_movf
            cache.insert(probe, miss_rows, miss_ovf, miss_movf)
        t2 = time.perf_counter() if timed else 0.0
        merged, ovf, movf = cache.merge(bucket, probe, miss_rows,
                                        miss_ovf, miss_movf)
        mw = n_trie * cfg.max_matches
        dw = n_trie * d
        ids = merged[:, :mw]
        subs = merged[:, mw:mw + dw]
        src = merged[:, mw + dw:]
        if timed:
            self._last_dispatch = {
                "hit": len(probe.hit_pos),
                "miss": len(probe.miss_topics),
                "cache_gather_ms": ((t1 - t0) + (
                    time.perf_counter() - t2)) * 1000.0,
            }
        return (ids, subs, src, None, ovf, movf, id_map, epoch,
                frozenset())

    def _mesh_bucket(self, n: int) -> int:
        """A power-of-two batch bucket that splits evenly over the
        mesh's data axis."""
        bucket = self.config.min_batch * self.config.mesh.shape["data"]
        while bucket < n:
            bucket *= 2
        return bucket

    def encode_place_sharded(self, topics: Sequence[str]):
        """Host half of the mesh dispatch: encode a topic batch (padded
        to a bucket that splits evenly over the data axis, sliced to
        its depth) and place it on the mesh. Returns ``(ids, n, sysm,
        rev)``, ``rev`` being the route-table mutation revision the
        batch was encoded at — :meth:`publish_dispatch_sharded`
        re-encodes when routes changed in between (a filter added after
        the encode may intern words the stale encoding mapped to the
        unknown sentinel: its matches would silently miss)."""
        from emqx_tpu_torch.parallel.sharded import place_batch

        cfg = self.config
        # read BEFORE encoding: a mutation racing the encode makes the
        # batch look stale (re-encoded at dispatch) — never the reverse
        rev = self._mut_rev
        B = len(topics)
        padded = list(topics) + ["\x00/pad"] * (self._mesh_bucket(B) - B)
        with self._wt_lock:
            if self._native is not None:
                ids, n, sysm = self._native.encode_batch(padded,
                                                         cfg.max_levels)
            else:
                ids, n, sysm = encode_batch(self._table, padded,
                                            cfg.max_levels)
        ids, n = depth_bucket(ids, n)
        return (*place_batch(cfg.mesh, ids, n, sysm), rev)

    def _dispatch_sharded(self, topics: Sequence[str], fan=None,
                          with_big: bool = False, placed=None):
        from emqx_tpu_torch.parallel.sharded import publish_step

        cfg = self.config
        auto, id_map, epoch = self.automaton()
        big_fids = frozenset()
        fan_tables = None
        bmt = None
        if fan is not None:
            st = fan(epoch, id_map)
            if st is not None:
                fan_tables = st.fan
                bmt = st.bm
                big_fids = st.big_fids
        if placed is not None:
            ids, n, sysm, rev = placed
            if rev != self._mut_rev:
                # routes changed since the batch was encoded: re-encode
                # from the original topics (correct; it costs the copy
                # the caller tried to hide)
                if topics is None:
                    raise ValueError(
                        "stale placed batch (routes changed since "
                        "encode) and no topics to re-encode from")
                ids, n, sysm, _ = self.encode_place_sharded(topics)
        else:
            ids, n, sysm, _ = self.encode_place_sharded(topics)
        use_fan = fan_tables is not None
        all_ids, subs, src, bm, ovf, movf, stats = publish_step(
            cfg.mesh, auto, fan_tables if use_fan else self._dummy_fan,
            ids, n, sysm, bmt, k=self.effective_k(), m=cfg.max_matches,
            d=self.effective_d() if use_fan else 8,
            mb=cfg.fanout_mb, with_fanout=use_fan,
            **self._walk_kw(int(ids.shape[-1])))
        self._dev_stats.append(stats)
        if with_big:
            return (all_ids, subs if use_fan else None,
                    src if use_fan else None, bm, ovf, movf, id_map,
                    epoch, big_fids)
        return all_ids, subs, src, ovf, movf, id_map, epoch

    def drain_device_stats(self) -> Dict[str, int]:
        """Sum and clear the mesh steps' device counters (one host copy
        per pending step — the periodic stats flush calls it, not the
        publish path)."""
        out = {"matches": 0, "deliveries": 0, "overflows": 0}
        while self._dev_stats:
            st = self._dev_stats.popleft()
            for k in out:
                out[k] += int(st[k])
        return out

    def match_filters(self, topics: Sequence[str]) -> List[List[str]]:
        """Batch: matched filter list per topic (device + exact host
        re-match of overflowed rows)."""
        if not topics:
            return []
        if not self.use_device_now():
            return self.match_filters_host(topics)
        _, mid, ovf, id_map, _ = self.match_ids(topics)
        out: List[List[str]] = []
        for i in range(len(topics)):
            if ovf[i]:
                out.append(self.host_match(topics[i]))
            else:
                row = [id_map[j] for j in mid[i] if j >= 0]
                out.append([f for f in row if f is not None])
        return out
