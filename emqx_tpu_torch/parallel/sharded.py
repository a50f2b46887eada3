"""Sharded automaton + the collective publish step.

The port of the JAX package's ``parallel/sharded.py``:

  - the filter set is partitioned by a stable hash into T *trie
    shards*; each shard is flattened into its own automaton whose
    tables carry GLOBAL filter ids, padded to common capacities and
    stacked along a leading shard axis (the host builders below are
    the JAX package's numpy code, copied, and give the same arrays);
  - :func:`place_sharded` puts shard t's tables on the devices of trie
    column t, and :func:`place_batch` data shard i's rows on the
    devices of data row i — a device a column or row names twice holds
    its part once;
  - :func:`publish_step` runs every cell (i, t): data shard i walks
    shard t's automaton (:func:`~emqx_tpu_torch.ops.walk_cuda.
    match_batch_auto` — kernel B1 on CUDA tensors, the plain walk on
    CPU tensors; the JAX mesh runs the lax walk there), gathers its
    shard's subscribers and ORs its shard's big-filter bitmap rows
    (kernel B2's dense entry point on CUDA). The collectives are torch
    ops over the cells' results: the match ids, subscribers and
    sources concatenate over ``trie``, the unions OR over ``trie``, the
    counters sum over the mesh;
  - a 1×1 mesh runs the one cell alone with identity collectives, as
    the JAX package's plain-jit fast path does.

The outputs equal the JAX function's global arrays byte for byte
(bitmap unions as int32 holding the uint32 bits, as everywhere in the
port), assembled on the mesh's home device. There is no ``shard_map``,
so ``shard_map_available`` has no counterpart, and no single controller
across processes: each process runs its own cells, and only the
``data`` sums cross processes (``torch.distributed.all_reduce``). Rows
of data shards another process runs come back as -1 / False / 0. The
loop over cells is plain Python on tensors: cells on one device run
one after the other on its stream.
"""

from __future__ import annotations

import functools
import zlib
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from emqx_tpu_torch.oracle import TrieOracle
from emqx_tpu_torch.ops.bitmap import (BitmapTable, or_bitmaps_cuda,
                                       or_bitmaps_ref, rows_for_matches)
from emqx_tpu_torch.ops.csr import Automaton, build_automaton
from emqx_tpu_torch.ops.fanout import (FanoutTable, build_fanout,
                                       gather_subscribers_src, pick_shared)
from emqx_tpu_torch.ops.tokenize import WordTable
from emqx_tpu_torch.ops.walk_cuda import match_batch_auto


class ShardedAutomaton(NamedTuple):
    """T stacked walk tables; leading axis is the trie-shard axis.

    Only the fields the walk reads are stacked (the CSR flatten
    artifacts stay host-side with the per-shard patchers). All shards
    share the bucket count, state capacity, slot layout and step
    bound."""

    wt: object        # int32[T, NB, slots*SW]
    wt_seed: object   # uint32[T, 1]
    node2: object     # int32[T, S2_cap, 4]


class ShardedFanout(NamedTuple):
    row_ptr: object  # [T, F_cap+1] — filter-id -> local sub rows
    sub_ids: object  # [T, N_cap]
    row_pairs: object = None  # [T, F_cap, 2] packed pairs


class ShardedBitmaps(NamedTuple):
    """Per-trie-shard subscriber bitmaps for big (> d) filters: a
    filter's bitmap row lives in ITS shard (the same stable assignment
    as the automaton), so device memory for huge subscriber sets
    scales with the mesh instead of replicating."""

    bitmaps: object  # uint32[T, R_cap, W]
    big_row: object  # int32[T, F_cap] — global fid -> local row | -1


def build_sharded_bitmaps(
    rows_per_shard: Sequence[Dict[int, Sequence[int]]],
    num_filters: int,
    n_subs: int,
    row_capacity: int | None = None,
) -> ShardedBitmaps:
    from emqx_tpu_torch.ops.bitmap import build_bitmaps

    r_cap = max(1, max(len(r) for r in rows_per_shard))
    if row_capacity is not None:
        r_cap = max(r_cap, row_capacity)
    tables = [build_bitmaps(rows, num_filters, n_subs,
                            row_capacity=r_cap)
              for rows in rows_per_shard]
    return ShardedBitmaps(
        bitmaps=np.stack([t.bitmaps for t in tables]),
        big_row=np.stack([t.big_row for t in tables]))


def shard_of(filter_: str, n_shards: int) -> int:
    """STABLE filter→shard assignment (crc32 + avalanche finalizer,
    not Python's salted hash): a filter keeps its shard across route
    churn and across processes, so a mutation touches exactly one
    shard's automaton. The murmur-style finalizer matters: CRC32 is
    linear, so near-identical filter names (``a/x`` vs ``a/+``) keep
    correlated low bits and ``crc % 2^k`` would collapse structured
    name families into one shard."""
    h = zlib.crc32(filter_.encode("utf-8"))
    h ^= h >> 16
    h = (h * 0x7FEB352D) & 0xFFFFFFFF
    h ^= h >> 15
    h = (h * 0x846CA68B) & 0xFFFFFFFF
    h ^= h >> 16
    return h % n_shards


def shard_filters(filters: Sequence[str], n_shards: int) -> List[List[str]]:
    """Partition by :func:`shard_of` (uniform in expectation; stable
    under mutation)."""
    shards: List[List[str]] = [[] for _ in range(n_shards)]
    for f in filters:
        shards[shard_of(f, n_shards)].append(f)
    return shards


def finalize_parts(
    autos: Sequence[Automaton],
    state_capacity: int | None = None,
    n_buckets: int | None = None,
) -> List[Automaton]:
    """Compress + pack per-shard flattened automatons with SHARED
    shapes (state capacity, bucket count, slot layout, step bound):
    one walk configuration serves every shard. The mode is voted — if
    any shard's trie is deep enough to want wide rows, all shards use
    them (wide is correct for shallow tries, just wider gathers)."""
    from emqx_tpu_torch.ops.csr import (attach_walk_tables,
                                        buckets_for_capacity, capacity_for,
                                        compress_automaton)

    comp = [compress_automaton(a) for a in autos]
    if len({c[0].wt_slots for c in comp}) > 1:
        comp = [compress_automaton(a, force_mode="wide") for a in autos]
        if len({c[0].wt_slots for c in comp}) > 1:
            # a shard hit compress_automaton's wide-mode guard (states
            # ≥ 2^26 or depth > 31) and stayed narrow despite the
            # force — mixed row widths cannot stack, so demote EVERY
            # shard to narrow (correct for any trie, just unskipped)
            comp = [compress_automaton(a, force_mode="narrow")
                    for a in autos]
    assert len({c[0].wt_slots for c in comp}) == 1, \
        "per-shard walk tables must agree on slot layout"
    s2_cap = max(c[0].node2.shape[0] for c in comp)
    if state_capacity is not None:
        s2_cap = max(s2_cap, state_capacity)
    e2_cap = capacity_for(max(len(c[1].src) for c in comp) + 1)
    slots = comp[0][0].wt_slots
    nb = buckets_for_capacity(e2_cap, slots)
    if n_buckets is not None:
        nb = max(nb, n_buckets)
    # one merged step bound: every shard walks for the max hop depth
    # (per-shard patchers keep accounting on the merged array, so a
    # deep patch on one shard grows the shared bound)
    hlen = max(len(c[0].hops_for_level) for c in comp)
    merged = np.zeros(hlen, np.int32)
    for a, _ in comp:
        hl = a.hops_for_level
        ext = np.concatenate(
            [hl, np.minimum(int(hl[-1]) + np.arange(1, hlen - len(hl) + 1),
                            np.arange(len(hl), hlen) + 1)]) \
            if len(hl) < hlen else hl
        merged = np.maximum(merged, ext.astype(np.int32))
    parts = []
    for a, edges in comp:
        a = _pad_v2(a, s2_cap)
        a = a._replace(hops_for_level=merged.copy())
        parts.append(attach_walk_tables(a, edges, n_buckets=nb))
    return parts


def _pad_v2(a: Automaton, s2_cap: int) -> Automaton:
    """Grow the v2 state-indexed arrays to a shared capacity."""
    def pad2(arr, fill):
        if arr.shape[0] == s2_cap:
            return arr
        out = np.full((s2_cap,) + arr.shape[1:], fill, dtype=arr.dtype)
        out[: arr.shape[0]] = arr
        return out

    return a._replace(node2=pad2(a.node2, -1),
                      v2_hop=pad2(a.v2_hop, -1),
                      v2_depth=pad2(a.v2_depth, -1))


def build_sharded(
    filter_shards: Sequence[Sequence[str]],
    filter_ids: Dict[str, int],
    table: WordTable,
    state_capacity: int | None = None,
    n_buckets: int | None = None,
    return_parts: bool = False,
) -> ShardedAutomaton:
    """Build one automaton per shard (global filter ids), compress with
    shared shapes, and stack (host arrays).

    ``state_capacity``/``n_buckets`` are retention floors (the router
    passes its previous caps so rebuilds keep shapes stable).
    ``return_parts=True`` also returns the per-shard HOST automatons:
    they seed the per-shard :class:`~emqx_tpu_torch.ops.patch.
    AutoPatcher` mirrors."""
    autos = []
    for shard in filter_shards:
        trie = TrieOracle()
        for f in shard:
            trie.insert(f)
        autos.append(build_automaton(trie, filter_ids, table,
                                     skip_hash=True))
    parts = finalize_parts(autos, state_capacity=state_capacity,
                           n_buckets=n_buckets)
    stacked = _stack_sharded(parts)
    if return_parts:
        return stacked, parts
    return stacked


def _stack_sharded(parts: Sequence[Automaton]) -> ShardedAutomaton:
    return ShardedAutomaton(
        wt=np.stack([a.wt for a in parts]),
        wt_seed=np.stack([a.wt_seed for a in parts]),
        node2=np.stack([a.node2 for a in parts]),
    )


def build_sharded_fanout(
    rows_per_shard: Sequence[Dict[int, Sequence[int]]],
    num_filters: int,
    filter_capacity: int | None = None,
    entry_capacity: int | None = None,
) -> ShardedFanout:
    fans = [build_fanout(rows, num_filters) for rows in rows_per_shard]
    f_cap = max(f.row_ptr.shape[0] - 1 for f in fans)
    e_cap = max(f.sub_ids.shape[0] for f in fans)
    if filter_capacity is not None:
        f_cap = max(f_cap, filter_capacity)
    if entry_capacity is not None:
        e_cap = max(e_cap, entry_capacity)
    fans = [
        build_fanout(rows, num_filters, filter_capacity=f_cap,
                     entry_capacity=e_cap)
        for rows in rows_per_shard
    ]
    return ShardedFanout(
        row_ptr=np.stack([f.row_ptr for f in fans]),
        sub_ids=np.stack([f.sub_ids for f in fans]),
        row_pairs=np.stack([f.row_pairs for f in fans]),
    )


# -- placement --------------------------------------------------------------


def _put(a, device) -> torch.Tensor:
    """An int32 (uint32 bits) or bool array as a tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype not in (np.int32, np.bool_):
        a = a.astype(np.int32)
    return torch.from_numpy(a).to(device)


class Placed:
    """One array split over a mesh axis: part ``s`` (trie shard s of a
    stacked table, or data shard s of a batch) on every distinct device
    of the mesh's slice ``s`` along ``axis`` that this process runs.
    ``parts`` maps ``(s, device)`` to the tensor; ``shape`` is the
    global one."""

    __slots__ = ("mesh", "axis", "parts", "shape")

    def __init__(self, mesh, axis: str, parts: dict, shape) -> None:
        self.mesh = mesh
        self.axis = axis
        self.parts = parts
        self.shape = tuple(shape)

    def cell(self, i: int, t: int) -> torch.Tensor:
        """The part cell ``(i, t)`` reads."""
        s = t if self.axis == "trie" else i
        return self.parts[(s, self.mesh.devices[i][t])]

    def numpy(self) -> np.ndarray:
        """The global array gathered to the host (tests; every part must
        be on this process)."""
        n = self.mesh.shape[self.axis]
        first = {}
        for (s, _dev), x in self.parts.items():
            first.setdefault(s, x)
        if len(first) != n:
            raise ValueError("parts of other processes are not here")
        out = [first[s].cpu().numpy() for s in range(n)]
        return np.stack(out) if self.axis == "trie" \
            else np.concatenate(out)


def _place(mesh, axis: str, arr) -> Placed:
    n = mesh.shape[axis]
    parts = {}
    if axis == "data" and arr.shape[0] % n:
        raise ValueError(f"batch of {arr.shape[0]} rows does not split "
                         f"over {n} data shards")
    b = arr.shape[0] // n if axis == "data" else 1
    for i, t, dev in mesh.cells():
        s = t if axis == "trie" else i
        if (s, dev) not in parts:
            parts[(s, dev)] = _put(arr[s] if axis == "trie"
                                   else arr[s * b:(s + 1) * b], dev)
    return Placed(mesh, axis, parts, arr.shape)


def place_sharded(mesh, sharded: NamedTuple):
    """Put stacked shard arrays onto the mesh: shard t on the devices
    of trie column t, replicated over ``data`` (once per device)."""
    return type(sharded)(*[None if x is None else _place(mesh, "trie", x)
                           for x in sharded])


def place_batch(mesh, word_ids, n_words, sys_mask):
    """Put an encoded batch onto the mesh: data shard i's rows on the
    devices of data row i, replicated over ``trie`` (once per
    device)."""
    return (_place(mesh, "data", word_ids), _place(mesh, "data", n_words),
            _place(mesh, "data", sys_mask))


class _CellAuto(NamedTuple):
    """One cell's walkable view of a sharded automaton."""

    wt: torch.Tensor
    wt_seed: torch.Tensor
    node2: torch.Tensor


def _cell_auto(auto: ShardedAutomaton, i: int, t: int) -> _CellAuto:
    return _CellAuto(wt=auto.wt.cell(i, t), wt_seed=auto.wt_seed.cell(i, t),
                     node2=auto.node2.cell(i, t))


def _cell_fan(fan: ShardedFanout, i: int, t: int) -> FanoutTable:
    return FanoutTable(fan.row_ptr.cell(i, t), fan.sub_ids.cell(i, t), 0, 0,
                       row_pairs=(None if fan.row_pairs is None
                                  else fan.row_pairs.cell(i, t)))


# -- collectives ------------------------------------------------------------

def popcount_sum(x: torch.Tensor) -> torch.Tensor:
    """Total set bits of an int32 tensor, as an int32 scalar (the JAX
    package's ``sum(population_count(x))``): the SWAR count of each
    word in int32 arithmetic, which wraps (every mask clears the bits
    an arithmetic shift copies in), with one temporary of ``x``'s size
    beside the result (a ``[4,096, 32,768]`` union is 512 MiB)."""
    y = (x >> 1) & 0x55555555
    y.neg_().add_(x)                        # 2-bit counts
    z = (y >> 2) & 0x33333333
    y.bitwise_and_(0x33333333).add_(z)      # 4-bit counts
    del z
    y.add_(y >> 4).bitwise_and_(0x0F0F0F0F)  # 8-bit counts
    y.mul_(0x01010101).bitwise_right_shift_(24)
    return y.sum(dtype=torch.int32)


def _reduce(op, parts, dev):
    return functools.reduce(op, [p.to(dev) for p in parts])


class _NullAxes:
    """Collective ops on a 1×1 mesh: identities."""

    @staticmethod
    def ag_tiled(parts, dev):
        return parts[0]

    @staticmethod
    def or_over_trie(parts, dev):
        return parts[0]

    @staticmethod
    def any_over_trie(parts, dev):
        return parts[0]

    @staticmethod
    def sum_over_mesh(vals, dev):
        return vals[0]

    @staticmethod
    def sum_over_data(vals, dev):
        return vals[0]


class _MeshAxes:
    """Collective ops over the cells' results: ``parts`` is one data
    row's per-trie-shard values (in trie order), ``vals`` every local
    cell's (or row's) scalar; ``dev`` is where the result lands. Sums
    whose axis crosses processes finish with one ``all_reduce``
    (:meth:`cross`)."""

    def __init__(self, mesh) -> None:
        self.mesh = mesh

    @staticmethod
    def ag_tiled(parts, dev):
        return torch.cat([p.to(dev) for p in parts], dim=1)

    @staticmethod
    def or_over_trie(parts, dev):
        return _reduce(torch.bitwise_or, parts, dev)

    @staticmethod
    def any_over_trie(parts, dev):
        return _reduce(torch.logical_or, parts, dev)

    @staticmethod
    def sum_over_mesh(vals, dev):
        return _reduce(torch.add, vals, dev)

    sum_over_data = sum_over_mesh

    def cross(self, stats: dict) -> dict:
        """Sum the per-process counters over every process (the
        ``data`` axis across processes), in one collective."""
        if self.mesh.n_processes == 1:
            return stats
        import torch.distributed as dist

        keys = list(stats)
        buf = torch.stack([stats[k] for k in keys])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        return {k: buf[j] for j, k in enumerate(keys)}


def _or_bitmaps_auto(bitmaps, rows):
    """The dense union: kernel B2 (a null slot map) on CUDA tensors,
    its plain version on CPU tensors."""
    if bitmaps.is_cuda:
        return or_bitmaps_cuda(bitmaps, rows)
    return or_bitmaps_ref(bitmaps, rows)


def publish_step(
    mesh,
    auto: ShardedAutomaton,
    fan: ShardedFanout,
    word_ids,              # [B, L] (Placed over 'data', or a host array)
    n_words,               # [B]
    sys_mask,              # [B]
    bmt: ShardedBitmaps | None = None,
    *,
    k: int = 64,
    m: int = 128,
    d: int = 128,
    mb: int = 16,
    with_fanout: bool = True,
    steps: int | None = None,
    slots: int = 2,
    take: int = 1,
):
    """The full collective publish step.

    Returns ``(match_ids [B, T*m], sub_ids [B, T*d], src_ids [B, T*d],
    bm [(union [B, W], has_big [B], bovf [B]) | None],
    overflow [B], match_overflow [B], stats)``:

    - ``src_ids`` carries the source filter id per gathered subscriber
      slot (the delivery tail resolves per-subscription options by
      matched filter);
    - with a :class:`ShardedBitmaps` table, each trie shard ORs its
      matched big filters' bitmap rows and the per-topic unions
      OR-combine over ``trie`` — ``bovf`` flags topics matching more
      than ``mb`` big filters on some shard (host fallback);
    - per-row ``overflow`` marks topics whose match or fan-out exceeded
      a bound on ANY trie shard (resolved host-side), while
      ``match_overflow`` isolates the match (active-set/m) bound — the
      only overflow a ``boost_k`` grow can help with. ``stats`` is a
      dict of mesh-summed int32 counters (matches, deliveries,
      overflows) — the device metric accumulator.

    ``auto``, ``fan`` and ``bmt`` come from :func:`place_sharded`; the
    batch from :func:`place_batch` (host arrays are placed here).
    """
    if not isinstance(word_ids, Placed):
        word_ids, n_words, sys_mask = place_batch(mesh, word_ids, n_words,
                                                  sys_mask)
    with_bitmap = bmt is not None
    single = mesh.shape["data"] == 1 and mesh.shape["trie"] == 1
    C = _NullAxes if single else _MeshAxes(mesh)
    n_trie = mesh.shape["trie"]
    out_dev = mesh.home

    def local(i, t, dev):
        """Cell ``(i, t)``: data shard i against trie shard t."""
        ids = word_ids.cell(i, t)
        res = match_batch_auto(_cell_auto(auto, i, t), ids,
                               n_words.cell(i, t), sys_mask.cell(i, t),
                               k=k, m=m, steps=steps, slots=slots,
                               take=take)
        b = ids.shape[0]
        if with_fanout:
            subs, src, dcount, dovf = gather_subscribers_src(
                _cell_fan(fan, i, t), res.ids, d=d)
        else:
            subs = torch.zeros((b, d), dtype=torch.int32, device=dev)
            src = torch.full((b, d), -1, dtype=torch.int32, device=dev)
            dcount = torch.zeros((b,), dtype=torch.int32, device=dev)
            dovf = torch.zeros((b,), dtype=torch.bool, device=dev)
        cell = {"res": res, "subs": subs, "src": src, "dcount": dcount,
                "dovf": dovf}
        if with_bitmap:
            bt = BitmapTable(bmt.bitmaps.cell(i, t), bmt.big_row.cell(i, t),
                             0, 0)
            rows_b, b_ovf = rows_for_matches(bt, res.ids, mb=mb)
            cell["union"] = _or_bitmaps_auto(bt.bitmaps, rows_b)
            cell["has_big"] = (rows_b >= 0).any(dim=1)
            cell["bovf"] = b_ovf
        return cell

    rows = {}
    counts, big = [], []
    for i in mesh.local_data():
        dev = mesh.devices[i][0]
        cells = [local(i, t, mesh.devices[i][t]) for t in range(n_trie)]

        def over(key, op, cells=cells, dev=dev):
            return op([c[key] for c in cells], dev)

        r = {"ids": C.ag_tiled([c["res"].ids for c in cells], dev),
             "subs": over("subs", C.ag_tiled),
             "src": over("src", C.ag_tiled)}
        if with_bitmap:
            r["union"] = over("union", C.or_over_trie)
            r["has_big"] = over("has_big", C.any_over_trie)
            r["bovf"] = over("bovf", C.any_over_trie)
            # the OR-reduced union is the same on every trie shard: it
            # counts once per data row (a trie sum would count each big
            # delivery T times)
            big.append(popcount_sum(r["union"]))
        r["movf"] = C.any_over_trie([c["res"].overflow for c in cells], dev)
        r["ovf"] = r["movf"] | over("dovf", C.any_over_trie)
        for c in cells:
            counts.append((c["res"].count.sum(dtype=torch.int32),
                           c["dcount"].sum(dtype=torch.int32),
                           (c["res"].overflow | c["dovf"]).sum(
                               dtype=torch.int32)))
        rows[i] = r
    deliv = C.sum_over_mesh([c[1] for c in counts], out_dev)
    if with_bitmap:
        deliv = deliv + C.sum_over_data(big, out_dev)
    stats = {
        "matches": C.sum_over_mesh([c[0] for c in counts], out_dev),
        "deliveries": deliv,
        "overflows": C.sum_over_mesh([c[2] for c in counts], out_dev),
    }
    if not single:
        stats = C.cross(stats)
    out = {key: _assemble(mesh, rows, key, out_dev)
           for key in next(iter(rows.values()))}
    bm_out = ((out["union"], out["has_big"], out["bovf"])
              if with_bitmap else None)
    return (out["ids"], out["subs"], out["src"], bm_out, out["ovf"],
            out["movf"], stats)


def _assemble(mesh, rows: dict, key: str, dev) -> torch.Tensor:
    """The global ``[B, ...]`` array of one output: the data rows this
    process ran, in order, on ``dev``; rows another process runs are
    -1 (ids), 0 (unions) or False (flags)."""
    n_data = mesh.shape["data"]
    if len(rows) == n_data:
        parts = [rows[i][key] for i in range(n_data)]
        return parts[0] if n_data == 1 else \
            torch.cat([p.to(dev) for p in parts])
    like = next(iter(rows.values()))[key]
    fill = 0 if key == "union" else (False if like.dtype == torch.bool
                                     else -1)
    parts = [rows[i][key].to(dev) if i in rows
             else torch.full_like(like, fill, device=dev)
             for i in range(n_data)]
    return torch.cat(parts)


def shared_pick_step(
    mesh,
    auto: ShardedAutomaton,
    gfan: ShardedFanout,     # per-shard GROUP membership CSR
    word_ids,                # [B, L]
    n_words,
    sys_mask,
    seeds,                   # int32[B] per-message pick seed
    *,
    k: int = 16,
    m: int = 32,
    steps: int | None = None,
    slots: int = 2,
    take: int = 1,
):
    """Mesh ``$share`` dispatch: match + the device hash-strategy member
    pick (src/emqx_shared_sub.erl:229-275) in one collective step. Each
    trie shard picks members for ITS groups' matches (``gfan`` rows
    live with their filter's shard); the picks concatenate over
    ``trie``.

    Returns ``(picks [B, T*m], match_ids [B, T*m], overflow [B])``;
    picks are subscriber ids aligned with ``match_ids`` slots (-1 =
    slot empty or group not on that shard). Round-robin/sticky keep
    host state and stay host-side, as on one device."""
    if not isinstance(word_ids, Placed):
        word_ids, n_words, sys_mask = place_batch(mesh, word_ids, n_words,
                                                  sys_mask)
    seeds = seeds if isinstance(seeds, Placed) \
        else _place(mesh, "data", seeds)
    C = _MeshAxes(mesh)
    rows = {}
    for i in mesh.local_data():
        dev = mesh.devices[i][0]
        picks, ids, ovf = [], [], []
        for t in range(mesh.shape["trie"]):
            res = match_batch_auto(_cell_auto(auto, i, t),
                                   word_ids.cell(i, t), n_words.cell(i, t),
                                   sys_mask.cell(i, t), k=k, m=m,
                                   steps=steps, slots=slots, take=take)
            picks.append(pick_shared(_cell_fan(gfan, i, t), res.ids,
                                     seeds.cell(i, t)))
            ids.append(res.ids)
            ovf.append(res.overflow)
        rows[i] = {"picks": C.ag_tiled(picks, dev),
                   "ids": C.ag_tiled(ids, dev),
                   "ovf": C.any_over_trie(ovf, dev)}
    return tuple(_assemble(mesh, rows, key, mesh.home)
                 for key in ("picks", "ids", "ovf"))
