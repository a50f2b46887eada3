"""Device subscriber fan-out: matched filter ids → subscriber ids.

The port of the JAX package's ``ops/fanout.py``: subscriber ids per
filter live in a CSR table on the device, and :func:`expand_packed`
expands the packed match ids into packed deliveries — gather work
proportional to actual matches and deliveries (the single-device
path). The mesh's collective step gathers per trie shard into a
dense ``[B, d]`` slot array (:func:`gather_subscribers_src`) and picks
shared-group members on the device (:func:`pick_shared`).
``build_fanout`` is the JAX package's numpy builder, copied; the rest
is torch ops (the drop-mode ``.at[].max`` becomes
``scatter_reduce(..., "amax")`` over a spare slot that is sliced off,
``lax.cummax`` becomes ``torch.cummax``, the compare-sum row search
``torch.searchsorted``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

from emqx_tpu_torch.ops.csr import capacity_for


class FanoutTable(NamedTuple):
    row_ptr: object  # int32[F_cap + 1] (numpy on the host, tensor on device)
    sub_ids: object  # int32[N_cap]
    n_filters: int
    n_entries: int
    # packed (start, end) pairs: one row gather per matched filter
    row_pairs: object = None  # int32[F_cap, 2]


def build_fanout(
    rows: Dict[int, Sequence[int]],
    num_filters: int,
    filter_capacity: int | None = None,
    entry_capacity: int | None = None,
) -> FanoutTable:
    """CSR from ``{filter_id: [subscriber ids]}`` (numpy, host)."""
    total = sum(len(v) for v in rows.values())
    f_cap = capacity_for(num_filters, filter_capacity)
    e_cap = capacity_for(total + 1, entry_capacity)
    row_ptr = np.zeros((f_cap + 1,), dtype=np.int32)
    sub_ids = np.full((e_cap,), -1, dtype=np.int32)
    pos = 0
    for fid in range(num_filters):
        row_ptr[fid] = pos
        for s in rows.get(fid, ()):
            sub_ids[pos] = s
            pos += 1
    row_ptr[num_filters:] = pos
    pairs = np.stack([row_ptr[:-1], row_ptr[1:]], axis=1)
    return FanoutTable(row_ptr, sub_ids, num_filters, total, pairs)


def _max_at(n: int, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``zeros(n).at[idx].max(vals, mode="drop")``: indices ≥ n drop
    into a spare slot."""
    out = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)
    idx = torch.where(idx < n, idx, n).to(torch.int64)
    return out.scatter_reduce_(0, idx, vals, "amax")[:n]


def expand_packed(fan: FanoutTable, m_ptr: torch.Tensor,
                  packed_ids: torch.Tensor, *, q: int):
    """Sparse CSR expansion: packed matched ids → packed deliveries.

    Returns ``(f_ptr[B+1], subs[q], src[q], total)`` — ``total`` > q
    means the budget overflowed (re-expand with the next bucket). Ids
    at or past the table's filter capacity contribute nothing (they
    drop, never clamp onto another filter's row)."""
    B = m_ptr.shape[0] - 1
    P = packed_ids.shape[0]
    dev = packed_ids.device
    in_range = (packed_ids >= 0) & (packed_ids < fan.row_ptr.shape[0] - 1)
    safe = torch.where(in_range, packed_ids, 0)
    pairs = fan.row_pairs[safe]                       # [P, 2]
    starts = pairs[:, 0]
    lens = torch.where(in_range, pairs[:, 1] - pairs[:, 0], 0)
    cume = torch.cumsum(lens, 0, dtype=torch.int32)
    total = cume[-1]
    cums = cume - lens                                # exclusive offsets
    pidx = torch.arange(P, dtype=torch.int32, device=dev)
    # slot → match: each non-empty match's index at its first output
    # slot, then a running max fills the runs
    marker = _max_at(q, torch.where(lens > 0, cums, q), pidx)
    row = torch.cummax(marker, 0).values.to(torch.int64)
    local = torch.stack([starts, cums, packed_ids.to(torch.int32)], dim=1)
    g = local[row]                                    # [q, 3]
    slots = torch.arange(q, dtype=torch.int32, device=dev)
    idx = torch.clamp(g[:, 0] + (slots - g[:, 1]), 0,
                      fan.sub_ids.shape[0] - 1).to(torch.int64)
    valid = slots < torch.clamp(total, max=q)
    subs = torch.where(valid, fan.sub_ids[idx], -1)
    src = torch.where(valid, g[:, 2], -1)
    # per-topic delivery counts → f_ptr: match → topic via the same
    # marker trick over m_ptr, then a segment add
    tmarker = _max_at(P, torch.clamp(m_ptr[:B], 0, P),
                      torch.arange(B, dtype=torch.int32, device=dev))
    t_of_p = torch.cummax(tmarker, 0).values.to(torch.int64)
    counts = torch.zeros(B, dtype=torch.int32, device=dev).scatter_add_(
        0, t_of_p, lens)
    f_ptr = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                       torch.cumsum(counts, 0, dtype=torch.int32)])
    return f_ptr, subs, src, total


def _rows_of(fan: FanoutTable, match_ids: torch.Tensor):
    """``(in_range, starts, lens)`` of every matched id's CSR row; ids
    at or past the table's filter capacity (patched into the automaton
    after the table was built) get length 0 — never clamped onto
    another filter's row."""
    in_range = (match_ids >= 0) & (match_ids < fan.row_ptr.shape[0] - 1)
    safe = torch.where(in_range, match_ids, 0).to(torch.int64)
    if fan.row_pairs is not None:
        pairs = fan.row_pairs[safe]                   # one [.., 2] gather
        starts = pairs[..., 0]
        lens = torch.where(in_range, pairs[..., 1] - starts, 0)
    else:
        starts = fan.row_ptr[safe]
        lens = torch.where(in_range, fan.row_ptr[safe + 1] - starts, 0)
    return in_range, starts, lens


def pick_shared(fan: FanoutTable, match_ids: torch.Tensor,
                seed: torch.Tensor) -> torch.Tensor:
    """One member per matched shared-group filter — the device form of
    the reference's ``hash`` dispatch strategy
    (src/emqx_shared_sub.erl:229-275): member = seed mod group size,
    read out of the group-membership CSR. ``match_ids`` int32[B, M]
    (-1 padded), ``seed`` int32[B]; returns int32[B, M] subscriber ids
    (-1 where no pick)."""
    in_range, starts, lens = _rows_of(fan, match_ids)
    valid = in_range & (lens > 0)
    s = seed.to(starts.dtype)[:, None]
    # Python-style modulo, as jnp's: the pick stays in [0, len)
    idx = starts + torch.where(valid, s % torch.clamp(lens, min=1), 0)
    idx = torch.clamp(idx, 0, fan.sub_ids.shape[0] - 1).to(torch.int64)
    return torch.where(valid, fan.sub_ids[idx], -1)


def gather_subscribers_src(fan: FanoutTable, match_ids: torch.Tensor, *,
                           d: int = 1024):
    """Subscriber ids of every matched filter, ``d`` slots a topic, with
    the *source filter id* per slot — the broker's delivery tail needs
    the matched filter to resolve per-subscription options (the
    reference dispatches per ``{Topic, SubPid}`` pair,
    src/emqx_broker.erl:298).

    Returns ``(subs[B, d], src[B, d], count[B], overflow[B])``: both
    ``subs`` and ``src`` -1 padded, ``count`` the true total and
    ``overflow`` ``count > d``."""
    B, M = match_ids.shape
    dev = match_ids.device
    _in, starts, lens = _rows_of(fan, match_ids)
    cum = torch.cumsum(lens, dim=1, dtype=torch.int32)      # [B, M]
    total = cum[:, -1]
    slots = torch.arange(d, dtype=torch.int32, device=dev)
    # slot → matched row: the count of rows whose running end is at or
    # before the slot (cum is non-decreasing)
    row = torch.searchsorted(cum, slots.expand(B, d).contiguous(),
                             right=True)
    row = torch.clamp(row, max=M - 1)
    local = torch.stack([cum, lens.to(torch.int32), starts.to(torch.int32),
                         match_ids.to(torch.int32)], dim=2)  # [B, M, 4]
    g = torch.gather(local, 1, row[..., None].expand(B, d, 4))
    idx = g[..., 2] + (slots - (g[..., 0] - g[..., 1]))
    idx = torch.clamp(idx, 0, fan.sub_ids.shape[0] - 1).to(torch.int64)
    valid = slots < torch.clamp(total, max=d)[:, None]
    subs = torch.where(valid, fan.sub_ids[idx], -1)
    src = torch.where(valid, g[..., 3], -1)
    return subs, src, total, total > d
