"""Device-side compaction of match + fan-out results for transfer.

Torch ops mirroring the JAX package's ``ops/pack.py``: the publish
path ends with ONE device→host copy, so the sparse match and fan-out
results are packed into CSR-style buffers sized by a power-of-two
*budget* — a cumulative sum assigns each valid element its slot, and
elements past the budget drop. The JAX drop-mode ``.at[].set`` becomes
index filtering: a small 1-D pack writes its dropped elements into a
spare slot that is sliced off, and the wide union rows are gathered
through a map of their source rows. The true totals (``m_ptr[-1]``,
``f_ptr[-1]``, the bitmap-row total) tell the caller to re-pack with
a bigger budget.
"""

from __future__ import annotations

import torch


def mask_pad_rows(ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Blank the batch's padding rows (row index ≥ ``n_rows``) to -1:
    wildcards match the pad topic, and those phantom rows must not
    reach the fan-out, the pack or the learned budgets."""
    row = torch.arange(ids.shape[0], device=ids.device)
    return torch.where((row < n_rows)[:, None], ids, -1)


def mask_pad_flags(flags: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Clear per-row bool flags on the batch's padding rows."""
    row = torch.arange(flags.shape[0], device=flags.device)
    return flags & (row < n_rows)


def budget_for(n_rows: int, per_row: int, floor: int = 64) -> int:
    """Power-of-two packed-buffer budget for ``n_rows`` rows at an
    expected ``per_row`` average occupancy."""
    need = max(floor, n_rows * per_row)
    out = floor
    while out < need:
        out *= 2
    return out


def _scatter_drop(n: int, pos: torch.Tensor, keep: torch.Tensor,
                  vals: torch.Tensor, fill) -> torch.Tensor:
    """``full(n, fill)`` with ``vals[keep]`` written at ``pos[keep]``;
    positions ≥ n drop (the JAX drop-mode scatter). Dropped elements
    land in one spare slot that is sliced off, so the op needs no
    device→host sync."""
    out = torch.full((n + 1,) + tuple(vals.shape[1:]), fill,
                     dtype=vals.dtype, device=vals.device)
    out[torch.where(keep & (pos < n), pos, n)] = vals
    return out[:n]


def _row_ptr(cnt: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros(1, dtype=torch.int32, device=cnt.device),
                      torch.cumsum(cnt, 0, dtype=torch.int32)])


def pack_matches(ids: torch.Tensor, *, pm: int):
    """Compact ``ids[B, M]`` (-1 padded) into ``(m_ptr[B+1],
    packed_ids[pm])``; ``m_ptr[-1]`` is the true total — past ``pm``
    the tail dropped and the caller re-packs."""
    flat = ids.reshape(-1)
    valid = flat >= 0
    m_ptr = _row_ptr((ids >= 0).sum(dim=1, dtype=torch.int32))
    pos = torch.cumsum(valid, 0) - 1
    return m_ptr, _scatter_drop(pm, pos, valid, flat.to(torch.int32), -1)


def bundle_i32(*parts: torch.Tensor) -> torch.Tensor:
    """Concatenate the packed outputs into ONE int32 vector, so the
    publish path's fetch is exactly one device→host copy (bools
    widen; bitmap rows are already int32 bits)."""
    return torch.cat([p.reshape(-1).to(torch.int32) for p in parts])


def pack_union_rows(union: torch.Tensor, has_big: torch.Tensor, *,
                    pr: int):
    """Compact the bitmap-union rows: only rows with ``has_big`` set
    are materialized. Returns ``(sel[B], rows[pr, W], total)`` —
    ``sel[b]`` is message ``b``'s packed row (-1 = none) and
    ``total`` > ``pr`` signals budget overflow.

    The packed slots' source rows are scattered into a map of ``pr``
    entries (-1 = empty) and the rows gathered through it, so the op
    moves ``pr`` rows of the union, not all ``B``, with no sync."""
    hb = has_big.to(torch.int32)
    pos = torch.cumsum(hb, 0) - 1
    sel = torch.where(has_big, pos, -1).to(torch.int32)
    src = _scatter_drop(pr, pos, has_big,
                        torch.arange(union.shape[0], device=union.device), -1)
    rows = union.index_select(0, src.clamp(min=0))
    rows.masked_fill_((src < 0)[:, None], 0)
    return sel, rows, hb.sum(dtype=torch.int32)
