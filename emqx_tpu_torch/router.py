"""The router: authoritative route state + the device matcher.

The port of the JAX package's ``Router`` on its plain single-device
path (``match_cache=False``, ``delta=False``, no mesh): routes are a
host map ``filter → {dest: refcount}`` (the reference's
``emqx_route`` bag, src/emqx_router.erl:113-133) over a host
:class:`~emqx_tpu_torch.oracle.TrieOracle`, and the match side is the
compressed automaton placed on the router's torch device. Any route
change that adds or drops a filter marks the automaton dirty; the next
match re-flattens it in full (no incremental patcher in this port
yet). Filter ids are assigned exactly as the JAX package assigns them,
so the same subscribe order gives the same ids.

Topics the walk cannot finish (more than ``max_levels`` levels, an
active set past k, lanes left after the last hop) are flagged and
re-matched exactly on the host trie — parity, never truncation.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from emqx_tpu_torch import topic as T
from emqx_tpu_torch.device import resolve
from emqx_tpu_torch.oracle import TrieOracle
from emqx_tpu_torch.ops import convert
from emqx_tpu_torch.ops.csr import build_automaton
from emqx_tpu_torch.ops.match import depth_bucket
from emqx_tpu_torch.ops.tokenize import WordTable, encode_batch
from emqx_tpu_torch.ops.walk_cuda import match_batch_auto
from emqx_tpu_torch.types import Route


@dataclass
class MatcherConfig:
    """The matcher knobs this path reads, with the JAX package's
    defaults."""

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
    # packed-transfer budgets: expected matched filters / deliveries
    # per message and bitmap rows per batch (re-pack on overflow)
    pack_m: int = 8
    pack_q: int = 16
    pack_rows: int = 8


class Router:
    """Route table + device matcher (one per node)."""

    def __init__(self, config: Optional[MatcherConfig] = None,
                 node: str = "local", device=None) -> None:
        self.config = config or MatcherConfig()
        self.node = node
        self.device = resolve(device)
        self._lock = threading.RLock()
        self._trie = TrieOracle()
        self._table = WordTable()
        # filter -> {dest: refcount}; bag semantics (emqx_route)
        self._routes: Dict[str, Dict[object, int]] = {}
        self._filter_ids: Dict[str, int] = {}
        self._id_to_filter: List[Optional[str]] = []
        # a freed id waits in _pending_free until the next flatten
        # replaces the published id map (immediate reuse when no
        # automaton was ever built)
        self._free_ids: List[int] = []
        self._pending_free: List[int] = []
        # (node2 rows, wt buckets) of the live tables: a rebuild keeps
        # them as floors, so shapes stay stable across rebuilds
        self._caps = (None, None)
        self._auto = None        # TorchAutomaton on self.device
        self._auto_map: List[Optional[str]] = []
        self._dirty = True
        self._rebuilds = 0
        # static walk parameters of the live tables; no '+' edge at
        # all ⇒ the active set is provably ≤ 1 lane, so k = 1
        self._walk_meta = {"slots": 2, "take": 1, "hops": None,
                           "has_plus": True}
        # learned active-set boost (overflow storms double k, ≤ 64)
        self._k_boost = 0

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
                self._trie.insert(filter_)
                for w in T.words(filter_):
                    if w not in (T.PLUS, T.HASH):
                        self._table.intern(w)
                self._dirty = True
            dests[dest] = dests.get(dest, 0) + 1
            return fid

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
                del self._routes[filter_]
                self._trie.delete(filter_)
                fid = self._filter_ids.pop(filter_)
                self._id_to_filter[fid] = None
                if self._auto is None:
                    self._free_ids.append(fid)
                else:
                    self._pending_free.append(fid)
                self._dirty = True

    def has_route(self, filter_: str) -> bool:
        return filter_ in self._routes

    def lookup_routes(self, filter_: str) -> List[Route]:
        dests = self._routes.get(filter_, {})
        return [Route(filter_, d) for d in dests]

    def filter_id(self, filter_: str) -> Optional[int]:
        return self._filter_ids.get(filter_)

    # -- automaton lifecycle ---------------------------------------------

    def rebuild(self):
        """Flatten the trie into a fresh automaton on the device."""
        with self._lock:
            host_auto = build_automaton(
                self._trie, self._filter_ids, self._table,
                v2_state_capacity=self._caps[0], v2_n_buckets=self._caps[1])
            self._walk_meta = {
                "slots": int(host_auto.wt_slots),
                "take": int(host_auto.wt_take),
                "hops": np.array(host_auto.hops_for_level),
                "has_plus": bool(
                    (host_auto.node2[:max(host_auto.v2_states, 1), 0] >= 0)
                    .any()),
            }
            self._caps = (host_auto.node2.shape[0], host_auto.wt.shape[0])
            self._auto = convert.automaton(host_auto, self.device)
            self._auto_map = list(self._id_to_filter)  # a NEW object
            self._free_ids.extend(self._pending_free)
            self._pending_free.clear()
            self._dirty = False
            self._rebuilds += 1
            return self._auto

    def automaton(self) -> tuple:
        """(automaton, id→filter snapshot, epoch); re-flattens first
        when a route change left the automaton dirty. The epoch (the
        rebuild counter) keys the fan-out tables to this id space."""
        with self._lock:
            if self._dirty or self._auto is None:
                self.rebuild()
            return self._auto, self._auto_map, self._rebuilds

    def _steps_for(self, lb: int) -> int:
        hl = self._walk_meta["hops"]
        if hl is None:
            return lb + 1
        return int(hl[min(lb, len(hl) - 1)])

    # -- matching (emqx_router:match_routes/1) ----------------------------

    def host_match(self, topic: str) -> List[str]:
        """Host-side exact match (the overflow re-match path)."""
        with self._lock:
            return self._trie.match(topic)

    def use_device_now(self) -> bool:
        """Device matching pays a fixed round trip, so it runs only
        past ``device_min_filters`` live filters (and never with
        ``use_device=False``)."""
        cfg = self.config
        if not cfg.use_device or not self._routes:
            return False
        return len(self._filter_ids) >= cfg.device_min_filters

    def match_filters_host(self, topics: Sequence[str]) -> List[List[str]]:
        """Host-only batch match."""
        with self._lock:
            return [self._trie.match(t) for t in topics]

    def walk_inputs(self, topics: Sequence[str]):
        """The walk's inputs for a topic batch: pad to a power-of-two
        bucket with ``"\x00/pad"``, encode, slice to the batch's depth
        and place on the device. Returns ``((word_ids, n_words,
        sys_mask), walk kwargs)`` for the live tables (call after
        :meth:`automaton`)."""
        cfg = self.config
        bucket = cfg.min_batch
        while bucket < len(topics):
            bucket *= 2
        padded = list(topics) + ["\x00/pad"] * (bucket - len(topics))
        ids, n, sysm = encode_batch(self._table, padded, cfg.max_levels)
        ids, n = depth_bucket(ids, n)
        args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in (ids, n, sysm))
        m = self._walk_meta
        kw = {"k": self.effective_k(), "m": cfg.max_matches,
              "pack_ids": False, "steps": self._steps_for(ids.shape[1]),
              "slots": m["slots"], "take": m["take"]}
        return args, kw

    def match_dispatch(self, topics: Sequence[str]):
        """Device match of a topic batch, with no device→host sync:
        the walk (:func:`~emqx_tpu_torch.ops.walk_cuda.match_batch_auto`
        — kernel B1 on CUDA) over :meth:`walk_inputs` with
        ``pack_ids=False``. Returns ``(ids, ovf, id_map, epoch)``: raw
        emit slots ``[B_pad, steps*2k]`` and overflow flags ``[B_pad]``
        on the device, plus the snapshot that gives the ids meaning."""
        auto, id_map, epoch = self.automaton()
        args, kw = self.walk_inputs(topics)
        res = match_batch_auto(auto, *args, **kw)
        return res.ids, res.overflow, id_map, epoch

    def match_filters(self, topics: Sequence[str]) -> List[List[str]]:
        """Batch: matched filter list per topic (device + exact host
        re-match of overflowed rows)."""
        if not topics:
            return []
        if not self.use_device_now():
            return self.match_filters_host(topics)
        B = len(topics)
        ids_d, ovf_d, id_map, _ = self.match_dispatch(topics)
        ids = ids_d[:B].cpu().numpy()
        ovf = ovf_d[:B].cpu().numpy()
        out: List[List[str]] = []
        for i in range(B):
            if ovf[i]:
                out.append(self.host_match(topics[i]))
            else:
                row = [id_map[j] for j in ids[i] if j >= 0]
                out.append([f for f in row if f is not None])
        return out

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

    def note_match_fallbacks(self, n: int) -> None:
        """The publish path re-matched ``n`` topics on the host. The
        JAX package forwards this to its incremental patcher's
        compaction trigger; this port re-flattens on every route
        change, so its walk bounds are always exact and there is
        nothing to schedule."""
