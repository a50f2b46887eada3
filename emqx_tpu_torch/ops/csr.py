"""Flatten the subscription trie into device walk tables.

The reference stores the trie as two Mnesia tables — edges keyed by
``{node_id, word}`` and nodes carrying the terminal topic
(src/emqx_trie.erl:53-74, include/emqx.hrl:96-113). For the TPU the
trie becomes a static automaton in HBM, built in two passes:

1. **Flatten** (:func:`build_automaton`): BFS over the host trie into
   CSR arrays (``row_ptr``/``edge_word``/``edge_child``) plus dense
   per-state columns (``plus_child``/``hash_filter``/``end_filter``).
   This is the rebuild artifact — the walk never reads it.

2. **Compress + pack** (:func:`compress_automaton` /
   :func:`attach_walk_tables`): single-child literal chains are
   collapsed into multi-word edges (up to ``max_take`` words per hop,
   the chain words stored *inline* in the edge row and verified
   exactly — parity never rests on a hash), states are renumbered to
   the surviving set, and edges land in a bucketed 2-choice hash
   table ``wt`` whose row width is chosen for the TPU gather unit:

     - **narrow** rows (2 slots × 4 ints = 32 B) when the trie is
       shallow — measured ~5.6 ns/row on v5e;
     - **wide** rows (4 slots × 16 ints = 256 B) when chains are deep
       — the 64-int row rides XLA's fast wide-gather path (~10 ns/row)
       while widths 12–48 sit in a 23–53 ns/row dead zone.

   A 16-level literal chain that cost 16 serial walk steps in the
   uncompressed automaton (the round-4 ``hash_1m_deep`` 0.197×
   finding; reference cost model src/emqx_trie.erl:161-186) becomes
   ≤ 3 hops.

State 0 is the root. Arrays are padded to pow2 capacity so
incremental rebuilds keep static shapes; padded rows are empty.

This is the port's own copy of the JAX package's numpy builder
(``emqx_tpu/ops/csr.py``), byte-identical in output; the walk reads
only ``wt``/``wt_seed``/``node2``, which :mod:`.convert` places on the
torch device.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np

from emqx_tpu_torch import topic as T
from emqx_tpu_torch.oracle import TrieOracle, _Node
from emqx_tpu_torch.ops.tokenize import WordTable

_WORD_PAD = np.int32(2**31 - 1)

#: chain-word pad inside a wide slot (never a word id, UNKNOWN or PAD)
CW_PAD = -3

#: slot layouts: [state, word, child, pad] (narrow) /
#: [state, word, take, child, cw0..cw6, pad×5] (wide)
NARROW_SLOT = 4
WIDE_SLOT = 16
NARROW_SLOTS = 2
WIDE_SLOTS = 4

#: max words one wide edge consumes (1 key word + 7 inline chain words)
MAX_TAKE = 8


class Automaton(NamedTuple):
    """Trie automaton: CSR flatten artifact + compiled walk tables.

    The v1 CSR arrays (``row_ptr``/``edge_word``/``edge_child`` and
    the dense state columns) are the flatten output in *original*
    state ids — the input to compression and the thing rebuilds
    produce. The walk reads only the v2 tables (renumbered,
    chain-compressed ids):

      - ``wt`` — bucketed 2-choice edge hash rows (layout above);
      - ``node2`` — ``[S2_cap, 4]`` per-state ``plus|hashf|endf|-1``;
      - ``hops_for_level[d]`` — scan steps needed for topics of ≤ d
        words (static per compile; grows only via deep patches);
      - ``v2_hop``/``v2_depth`` — host-only per-state hop/depth used
        by the patcher's hop accounting (stripped before device_put).

    ``wt_slots``/``wt_take`` are python ints (static at trace time —
    callers read them from the HOST automaton, never through jit).
    """

    row_ptr: np.ndarray      # int32[S_cap + 1]
    edge_word: np.ndarray    # int32[E_cap], sorted within each row
    edge_child: np.ndarray   # int32[E_cap]
    plus_child: np.ndarray   # int32[S_cap]
    hash_filter: np.ndarray  # int32[S_cap]
    end_filter: np.ndarray   # int32[S_cap]
    n_states: int            # live v1 states (root included)
    n_edges: int             # live v1 literal edges
    wt: np.ndarray | None = None            # int32[NB, slots*SW]
    wt_seed: np.ndarray | None = None       # uint32[1]
    node2: np.ndarray | None = None         # int32[S2_cap, 4]
    hops_for_level: np.ndarray | None = None  # int32[maxdepth + 1]
    v2_hop: np.ndarray | None = None        # int16[S2_cap] host-only
    v2_depth: np.ndarray | None = None      # int16[S2_cap] host-only
    v2_states: int = 0
    v2_edges: int = 0
    wt_slots: int = 0        # 2 = narrow, 4 = wide
    wt_take: int = 1         # max words per literal hop (R)


class V2Edges(NamedTuple):
    """Compressed edge list in v2 state ids (compression output, hash
    placement input — the seam the sharded builder splits on)."""

    src: np.ndarray    # int32[E2]
    word: np.ndarray   # int32[E2] first word (the hash key word)
    take: np.ndarray   # int32[E2] words consumed (1..MAX_TAKE)
    child: np.ndarray  # int32[E2]
    cw: np.ndarray     # int32[E2, MAX_TAKE-1] inline chain words


def capacity_for(n: int, cap: int | None = None) -> int:
    """Next power-of-two capacity ≥ n (min 16), honoring a floor."""
    c = 16
    while c < n:
        c *= 2
    if cap is not None and cap > c:
        c = cap
    return c


_capacity = capacity_for


def build_automaton(
    trie: TrieOracle,
    filter_ids: Dict[str, int],
    table: WordTable,
    state_capacity: int | None = None,
    edge_capacity: int | None = None,
    skip_hash: bool = False,
    v2_state_capacity: int | None = None,
    v2_n_buckets: int | None = None,
) -> Automaton:
    """Flatten ``trie`` and (unless ``skip_hash``) build walk tables.

    ``filter_ids`` maps every inserted filter to its dense route id
    (assigned by the router); ``table`` interns filter words. ``#``
    child nodes are collapsed (never walked into); ``+`` children are
    ordinary states. ``skip_hash=True`` returns the bare flatten —
    the sharded builder compresses each shard with shared capacities
    (parallel/sharded.py) before packing.
    """
    # BFS assigning dense state ids; root = 0.
    states: list[_Node] = [trie.root]
    index: dict[int, int] = {id(trie.root): 0}
    edges_per_state: list[list[tuple[int, int]]] = []  # (word_id, child)
    plus: list[int] = []
    hashf: list[int] = []
    endf: list[int] = []

    i = 0
    while i < len(states):
        node = states[i]
        i += 1
        lits: list[tuple[int, int]] = []
        p = -1
        h = -1
        for w, child in node.children.items():
            if w == T.HASH:
                if child.filter is not None:
                    h = filter_ids[child.filter]
                continue
            sid = index.get(id(child))
            if sid is None:
                sid = len(states)
                index[id(child)] = sid
                states.append(child)
            if w == T.PLUS:
                p = sid
            else:
                lits.append((table.intern(w), sid))
        lits.sort()
        edges_per_state.append(lits)
        plus.append(p)
        hashf.append(h)
        endf.append(-1 if node.filter is None else filter_ids[node.filter])

    S = len(states)
    E = sum(len(e) for e in edges_per_state)
    S_cap = _capacity(S, state_capacity)
    E_cap = _capacity(E + 1, edge_capacity)

    row_ptr = np.full((S_cap + 1,), E, dtype=np.int32)
    edge_word = np.full((E_cap,), _WORD_PAD, dtype=np.int32)
    edge_child = np.full((E_cap,), -1, dtype=np.int32)
    plus_child = np.full((S_cap,), -1, dtype=np.int32)
    hash_filter = np.full((S_cap,), -1, dtype=np.int32)
    end_filter = np.full((S_cap,), -1, dtype=np.int32)

    pos = 0
    for s in range(S):
        row_ptr[s] = pos
        for wid, child in edges_per_state[s]:
            edge_word[pos] = wid
            edge_child[pos] = child
            pos += 1
    row_ptr[S:] = pos  # live-end and padded rows all point at E

    plus_child[:S] = plus
    hash_filter[:S] = hashf
    end_filter[:S] = endf

    auto = Automaton(
        row_ptr=row_ptr,
        edge_word=edge_word,
        edge_child=edge_child,
        plus_child=plus_child,
        hash_filter=hash_filter,
        end_filter=end_filter,
        n_states=S,
        n_edges=E,
    )
    if skip_hash:
        return auto
    return finalize_automaton(
        auto, state_capacity=v2_state_capacity,
        n_buckets=v2_n_buckets)


def finalize_automaton(
    auto: Automaton,
    *,
    max_take: int = MAX_TAKE,
    force_mode: str | None = None,
    state_capacity: int | None = None,
    edge_capacity: int | None = None,
    n_buckets: int | None = None,
) -> Automaton:
    """Compress + pack in one step (the single-chip build path)."""
    auto, edges = compress_automaton(
        auto, max_take=max_take, force_mode=force_mode,
        state_capacity=state_capacity, edge_capacity=edge_capacity)
    return attach_walk_tables(auto, edges, n_buckets=n_buckets)


# -- compression -----------------------------------------------------------


def _csr_depths(rp, ec, plus, S):
    """Per-state depth via level-synchronous BFS (vectorized)."""
    depth = np.full(S, -1, np.int32)
    depth[0] = 0
    frontier = np.array([0], dtype=np.int64)
    d = 0
    while frontier.size:
        d += 1
        starts = rp[frontier].astype(np.int64)
        ends = rp[frontier + 1].astype(np.int64)
        counts = ends - starts
        total = int(counts.sum())
        if total:
            # flat CSR indices of every frontier edge
            offs = np.repeat(starts, counts) + (
                np.arange(total) - np.repeat(
                    np.cumsum(counts) - counts, counts))
            kids = ec[offs].astype(np.int64)
        else:
            kids = np.empty(0, np.int64)
        pc = plus[frontier]
        kids = np.concatenate([kids, pc[pc >= 0].astype(np.int64)])
        depth[kids] = d
        frontier = kids
    return depth


def _csr_edge_indices(rp, frontier):
    """(flat edge indices, repeated sources) of ``frontier``'s rows."""
    starts = rp[frontier].astype(np.int64)
    counts = (rp[frontier + 1] - rp[frontier]).astype(np.int64)
    total = int(counts.sum())
    if not total:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    offs = np.repeat(starts, counts) + (
        np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts))
    return offs, np.repeat(frontier, counts)


def compress_automaton(
    auto: Automaton,
    *,
    max_take: int = MAX_TAKE,
    force_mode: str | None = None,
    state_capacity: int | None = None,
    edge_capacity: int | None = None,
) -> tuple[Automaton, V2Edges]:
    """Collapse single-child literal chains and renumber states.

    A state is a *chain interior* when it has exactly one literal
    child and no ``+`` child, no ``#`` terminal and no end terminal —
    the same structural fact the reference's per-level ETS walk pays
    one read for (src/emqx_trie.erl:161-186); here the walk skips it
    entirely. Interiors are absorbed into the incoming edge (its
    ``take`` grows, the skipped words land in ``cw``); everything
    else is materialized and renumbered in hop-BFS order.

    Mode: **wide** when compression shortens the deepest walk by ≥ 2
    scan steps (deep-hierarchy tries), else **narrow** (``take ≡ 1``,
    no window machinery in the kernel — shallow tries pay nothing for
    a feature they can't use). ``force_mode`` pins it for tests.
    """
    S, E = auto.n_states, auto.n_edges
    rp = np.asarray(auto.row_ptr[:S + 1], np.int64)
    ew = np.asarray(auto.edge_word)
    ec = np.asarray(auto.edge_child)
    plus = np.asarray(auto.plus_child[:S])
    hashf = np.asarray(auto.hash_filter[:S])
    endf = np.asarray(auto.end_filter[:S])
    deg = np.diff(rp)

    depth = _csr_depths(rp, ec, plus, S)
    maxdepth = int(depth.max()) if S > 1 else 0

    elig = (deg == 1) & (plus < 0) & (hashf < 0) & (endf < 0)
    elig[0] = False

    # links[s] = skippable single-edge hops below s (0 if not elig)
    links = np.zeros(S, np.int32)
    for d in range(maxdepth, 0, -1):
        idx = np.nonzero((depth == d) & elig)[0]
        if idx.size:
            kids = ec[rp[idx]]
            links[idx] = 1 + links[kids]

    R = max_take
    # hop-BFS over the compressed graph: discover materialized states
    # and emit one compressed edge per (materialized src, literal edge)
    hop = np.full(S, -1, np.int16)
    hop[0] = 0
    order = [np.array([0], np.int64)]  # materialized, discovery order
    e_src, e_word, e_take, e_child = [], [], [], []
    e_cw = []
    frontier = np.array([0], np.int64)
    while frontier.size:
        eidx, src = _csr_edge_indices(rp, frontier)
        nxt_parts = []
        if eidx.size:
            w = ew[eidx]
            c = ec[eidx].astype(np.int64)
            j = np.minimum(links[c], R - 1).astype(np.int64)
            cw = np.full((len(c), R - 1), CW_PAD, np.int32)
            cur = c.copy()
            for i in range(R - 1):
                m = i < j
                if not m.any():
                    break
                e0 = rp[cur[m]]
                cw[m, i] = ew[e0]
                cur[m] = ec[e0]
            land = cur
            hop[land] = hop[src] + 1
            e_src.append(src)
            e_word.append(w)
            e_take.append((1 + j).astype(np.int32))
            e_child.append(land)
            e_cw.append(cw)
            nxt_parts.append(land)
        pc = plus[frontier]
        pm = pc >= 0
        if pm.any():
            pk = pc[pm].astype(np.int64)
            hop[pk] = hop[frontier[pm]] + 1
            nxt_parts.append(pk)
        frontier = (np.concatenate(nxt_parts) if nxt_parts
                    else np.empty(0, np.int64))
        if frontier.size:
            order.append(frontier)

    mat = np.concatenate(order)
    S2 = len(mat)
    newid = np.full(S, -1, np.int32)
    newid[mat] = np.arange(S2, dtype=np.int32)

    hops_full = np.zeros(maxdepth + 1, np.int32)
    md = depth[mat].astype(np.int64)
    mh = hop[mat].astype(np.int64)
    np.maximum.at(hops_full, md, mh + 1)
    hops_full = np.maximum.accumulate(hops_full)
    hops_full = np.maximum(hops_full, 1)

    mode = force_mode
    if mode is None:
        # wide only when compression actually shortens the walk: the
        # narrow kernel skips the window/level machinery entirely
        saved = (maxdepth + 1) - int(hops_full[maxdepth])
        mode = "wide" if saved >= 2 else "narrow"
    # the wide kernel packs (state << 5 | level) into one int32 lane:
    # state ids past 2^26 or depths past 31 don't fit — such tries
    # (far beyond any configured max_levels / 10M-sub scale) walk
    # narrow, which carries no packed level
    if mode == "wide" and (S2 >= (1 << 26) or maxdepth > 31):
        mode = "narrow"

    if mode == "narrow":
        # no chain skipping: identity renumbering, take ≡ 1 (the
        # flatten's BFS order is already dense)
        S2 = S
        S2_cap = _capacity(S2, state_capacity)
        node2 = np.full((S2_cap, 4), -1, np.int32)
        node2[:S, 0] = plus
        node2[:S, 1] = hashf
        node2[:S, 2] = endf
        v2_hop = np.full(S2_cap, -1, np.int16)
        v2_hop[:S] = depth.astype(np.int16)
        v2_depth = np.full(S2_cap, -1, np.int16)
        v2_depth[:S] = depth.astype(np.int16)
        eidx, src = _csr_edge_indices(rp, np.arange(S, dtype=np.int64))
        edges = V2Edges(
            src=src.astype(np.int32), word=ew[eidx].astype(np.int32),
            take=np.ones(len(src), np.int32),
            child=ec[eidx].astype(np.int32),
            cw=np.full((len(src), R - 1), CW_PAD, np.int32))
        return auto._replace(
            node2=node2,
            hops_for_level=np.arange(1, maxdepth + 2, dtype=np.int32),
            v2_hop=v2_hop, v2_depth=v2_depth,
            v2_states=S2, v2_edges=len(src),
            wt_slots=NARROW_SLOTS, wt_take=1,
        ), edges

    src = np.concatenate(e_src) if e_src else np.empty(0, np.int64)
    edges = V2Edges(
        src=newid[src].astype(np.int32),
        word=(np.concatenate(e_word) if e_word
              else np.empty(0, np.int32)).astype(np.int32),
        take=(np.concatenate(e_take) if e_take
              else np.empty(0, np.int32)),
        child=newid[np.concatenate(e_child)].astype(np.int32)
        if e_child else np.empty(0, np.int32),
        cw=(np.concatenate(e_cw) if e_cw
            else np.empty((0, R - 1), np.int32)),
    )
    S2_cap = _capacity(S2, state_capacity)
    node2 = np.full((S2_cap, 4), -1, np.int32)
    pc = plus[mat]
    node2[:S2, 0] = np.where(pc >= 0, newid[np.maximum(pc, 0)], -1)
    node2[:S2, 1] = hashf[mat]
    node2[:S2, 2] = endf[mat]
    v2_hop = np.full(S2_cap, -1, np.int16)
    v2_hop[:S2] = hop[mat]
    v2_depth = np.full(S2_cap, -1, np.int16)
    v2_depth[:S2] = depth[mat].astype(np.int16)
    return auto._replace(
        node2=node2, hops_for_level=hops_full,
        v2_hop=v2_hop, v2_depth=v2_depth,
        v2_states=S2, v2_edges=len(edges.src),
        wt_slots=WIDE_SLOTS, wt_take=R,
    ), edges


# -- bucketed 2-choice edge hash ------------------------------------------


def hash_mix(state, word, seed):
    """The (state, word) → (h1, h2) mix — uint32 wraparound arithmetic,
    written so numpy (build) and jnp (match kernel) agree bit-for-bit."""
    s = state.astype("uint32")
    w = word.astype("uint32")
    h = s * np.uint32(0x9E3779B9) + w * np.uint32(0x85EBCA6B) + seed
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x7FEB352D)
    h = h ^ (h >> np.uint32(15))
    h2 = h * np.uint32(0x846CA68B)
    h2 = h2 ^ (h2 >> np.uint32(16))
    return h, h2


def buckets_for_capacity(edge_capacity: int, slots: int) -> int:
    """Bucket count giving ≤ 0.5 fill at full edge capacity (pow2)."""
    nb = 4
    while nb * slots < 2 * edge_capacity:
        nb *= 2
    return nb


def _greedy_place(b, avail, fill, order_keys):
    """Vectorized capacity-bounded placement of keys into buckets ``b``
    (one pass). Returns (placed_key_idx, bucket, slot, leftover_idx)."""
    order = np.argsort(b, kind="stable")
    bs = b[order]
    rank = np.arange(len(bs)) - np.searchsorted(bs, bs)
    slot = fill[bs] + rank
    ok = slot < avail
    return order_keys[order[ok]], bs[ok], slot[ok], order_keys[order[~ok]]


def place_edges(
    states: np.ndarray,
    words: np.ndarray,
    n_buckets: int,
    slots: int,
    max_seeds: int = 32,
):
    """Cuckoo placement of (state, word) keys into ``n_buckets`` ×
    ``slots``. Returns ``(bucket[E], slot[E], seed)``.

    Two vectorized greedy passes (first-choice bucket, then second)
    place ~all keys; the tail is fixed with bounded cuckoo evictions.
    On pathological seeds the whole build retries with the next seed
    (keys are unique, so success at ≤ 50% fill is essentially
    certain)."""
    E = len(states)
    mask = np.uint32(n_buckets - 1)
    for seed_i in range(max_seeds):
        seed = np.uint32(0xA5A5A5A5 + 0x9E37 * seed_i)
        out_b = np.full(E, -1, np.int64)
        out_s = np.full(E, -1, np.int64)
        if E == 0:
            return out_b, out_s, np.array([seed], dtype=np.uint32)
        h1, h2 = hash_mix(states, words, seed)
        b1 = (h1 & mask).astype(np.int64)
        b2 = (h2 & mask).astype(np.int64)
        fill = np.zeros((n_buckets,), dtype=np.int64)
        occ = np.full((n_buckets, slots), -1, np.int64)  # edge index

        keys = np.arange(E, dtype=np.int64)
        pk, pb, ps, left = _greedy_place(b1, slots, fill, keys)
        np.add.at(fill, pb, 1)
        out_b[pk], out_s[pk] = pb, ps
        occ[pb, ps] = pk
        if len(left):
            pk, pb, ps, left = _greedy_place(b2[left], slots, fill, left)
            np.add.at(fill, pb, 1)
            out_b[pk], out_s[pk] = pb, ps
            occ[pb, ps] = pk

        ok = True
        for k in left:
            ck = int(k)
            cb = int(b1[ck])
            for step in range(500):
                row = occ[cb]
                free = np.nonzero(row < 0)[0]
                if len(free):
                    occ[cb, free[0]] = ck
                    out_b[ck], out_s[ck] = cb, free[0]
                    break
                victim = step % slots
                vk = int(occ[cb, victim])
                occ[cb, victim] = ck
                out_b[ck], out_s[ck] = cb, victim
                ck = vk
                alt1, alt2 = int(b1[ck]), int(b2[ck])
                cb = alt2 if cb == alt1 else alt1
            else:
                ok = False
                break
        if ok:
            return out_b, out_s, np.array([seed], dtype=np.uint32)
    raise RuntimeError("edge-hash build failed for all seeds")


def pack_slot_rows(edges: V2Edges, bucket, slot, n_buckets: int,
                   slots: int, take_max: int) -> np.ndarray:
    """Scatter the placed edges into the flat ``wt`` row array."""
    sw = NARROW_SLOT if take_max == 1 else WIDE_SLOT
    wt = np.full((n_buckets, slots * sw), -1, np.int32)
    base = slot * sw
    if take_max == 1:
        wt[bucket, base + 0] = edges.src
        wt[bucket, base + 1] = edges.word
        wt[bucket, base + 2] = edges.child
    else:
        wt[bucket, base + 0] = edges.src
        wt[bucket, base + 1] = edges.word
        wt[bucket, base + 2] = edges.take
        wt[bucket, base + 3] = edges.child
        for i in range(take_max - 1):
            wt[bucket, base + 4 + i] = edges.cw[:, i]
    return wt


def attach_walk_tables(
    auto: Automaton,
    edges: V2Edges,
    n_buckets: int | None = None,
    edge_capacity: int | None = None,
) -> Automaton:
    """Build ``wt`` from a compressed edge list (bucket count derived
    from edge capacity unless given — sharded builds pass a shared
    count so stacked shards agree on shapes)."""
    slots = auto.wt_slots
    e_cap = _capacity(len(edges.src) + 1, edge_capacity)
    need = buckets_for_capacity(e_cap, slots)
    # a caller-provided count is a retention FLOOR (shape stability
    # across rebuilds), never a shrink below what the live edge set
    # needs at ≤50% fill
    n_buckets = need if n_buckets is None else max(n_buckets, need)
    bucket, slot, seed = place_edges(
        edges.src, edges.word, n_buckets, slots)
    wt = pack_slot_rows(edges, bucket, slot, n_buckets, slots,
                        auto.wt_take)
    return auto._replace(wt=wt, wt_seed=seed)
