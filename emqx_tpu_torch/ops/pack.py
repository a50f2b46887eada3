"""Device-side compaction of match + fan-out results for transfer.

Torch ops mirroring the JAX package's ``ops/pack.py``: the publish
path ends with ONE device→host copy, so the sparse match and fan-out
results are packed into CSR-style buffers sized by a power-of-two
*budget* — a cumulative sum assigns each valid element its slot, and
elements past the budget drop. The JAX drop-mode ``.at[].set`` becomes
index filtering: a small 1-D pack writes its dropped elements into a
spare slot that is sliced off, and the wide union rows go through a
map of their source rows. The true totals (``m_ptr[-1]``,
``f_ptr[-1]``, the bitmap-row total) tell the caller to re-pack with
a bigger budget.

The bitmap union is packed before it is computed: :func:`union_slots`
maps each of the ``pr`` packed rows to its source topic, and kernel B2
(``csrc/bitmap_or.cu``, replacing the Pallas
``emqx_tpu/ops/bitmap.py::_or_kernel_dma``) ORs just those rows in one
launch. What bounds it at the main path's shapes is that launch's
latency, not bytes (about 1-2 MiB), so the design drops the dense
``[B, W]`` union (512 MiB a 4,096-topic batch at W = 32,768) and its
gather rather than pipelining the copies. The dense union has a
kernel of its own (B4, ``csrc/bitmap_or_dense.cu``), which the device
mesh runs; :func:`pack_union_rows` packs its rows there and keeps the
dense composition, the JAX package's function, for the tests and the
old-route comparison.
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


def pack_fanout(subs: torch.Tensor, src: torch.Tensor, *, pq: int):
    """Compact the mesh's gathered ``(subs, src)[B, d]`` pair (the same
    -1 slots in both) into one CSR triple ``(f_ptr[B+1],
    packed_subs[pq], packed_src[pq])``, with :func:`pack_matches`'
    overflow contract (``f_ptr[-1]`` past ``pq`` → re-pack)."""
    flat_subs = subs.reshape(-1)
    valid = flat_subs >= 0
    f_ptr = _row_ptr((subs >= 0).sum(dim=1, dtype=torch.int32))
    pos = torch.cumsum(valid, 0) - 1
    return (f_ptr,
            _scatter_drop(pq, pos, valid, flat_subs.to(torch.int32), -1),
            _scatter_drop(pq, pos, valid,
                          src.reshape(-1).to(torch.int32), -1))


def bundle_i32(*parts: torch.Tensor) -> torch.Tensor:
    """Concatenate the packed outputs into ONE int32 vector, so the
    publish path's fetch is exactly one device→host copy (bools
    widen; bitmap rows are already int32 bits)."""
    return torch.cat([p.reshape(-1).to(torch.int32) for p in parts])


def union_slots(has_big: torch.Tensor, pr: int):
    """The packed-slot map of the bitmap-union rows: only rows with
    ``has_big`` set are materialized. Returns ``(sel[B], src[pr],
    total)`` — ``sel[b]`` is message ``b``'s packed row (-1 = none),
    ``src[p]`` the message packed at row ``p`` (-1 = empty, int32),
    and ``total`` > ``pr`` signals budget overflow (the rows past
    ``pr`` dropped). A cumsum and a scatter over B elements, no
    sync."""
    hb = has_big.to(torch.int32)
    pos = torch.cumsum(hb, 0) - 1
    sel = torch.where(has_big, pos, -1).to(torch.int32)
    src = _scatter_drop(pr, pos, has_big,
                        torch.arange(has_big.shape[0], dtype=torch.int32,
                                     device=has_big.device), -1)
    return sel, src, hb.sum(dtype=torch.int32)


def pack_union_rows(union: torch.Tensor, has_big: torch.Tensor, *,
                    pr: int):
    """Compact a dense bitmap union ``[B, W]``: :func:`union_slots`,
    then a gather of the ``pr`` packed rows. Returns ``(sel[B],
    rows[pr, W], total)``, the JAX package's ``pack_union_rows``. The
    publish path never builds the dense union: kernel B2 ORs the packed
    rows directly (``bitmap.or_union_rows_auto``)."""
    sel, src, total = union_slots(has_big, pr)
    rows = union.index_select(0, src.clamp(min=0))
    rows.masked_fill_((src < 0)[:, None], 0)
    return sel, rows, total
