"""Device subscriber fan-out: matched filter ids → subscriber ids.

The port of the JAX package's ``ops/fanout.py`` main-path pieces:
subscriber ids per filter live in a CSR table on the device, and
:func:`expand_packed` expands the packed match ids into packed
deliveries — gather work proportional to actual matches and
deliveries. ``build_fanout`` is the JAX package's numpy builder,
copied; the expansion is torch ops (the drop-mode ``.at[].max``
becomes ``scatter_reduce(..., "amax")`` over a spare slot that is
sliced off, ``lax.cummax`` becomes ``torch.cummax``).
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
