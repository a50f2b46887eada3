"""Subscriber-bitmap fan-out for huge-fan-out filters (kernel B2).

Filters past the fan-out threshold keep their subscriber set as a
bitmap row (bit i = subscriber id i); a publish batch's fan-out is the
OR of its matched rows:

    out[b, :] = OR over m of bitmaps[rows[b, m], :]   (rows < 0 skipped)

``words_for`` / ``build_bitmaps`` are the JAX package's numpy
builders, copied. :func:`or_bitmaps_ref` is the plain PyTorch version;
:func:`or_bitmaps_cuda` launches the hand-written CUDA kernel
(``csrc/bitmap_or.cu``), which replaces the Pallas
``emqx_tpu/ops/bitmap.py::_or_kernel_dma``. :func:`or_bitmaps_auto`
picks by the device of the tensors it is given: CUDA tensors launch
the kernel (or raise), CPU tensors run the plain version.

Rows are held as ``int32`` on the torch side: OR ignores sign, and
torch's ``uint32`` lacks most CPU ops.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch

from emqx_tpu_torch.ops import _build
from emqx_tpu_torch.ops.csr import capacity_for

_DEFAULT_TILE = 2048  # words per row tile of the JAX layout (min width)


class BitmapTable(NamedTuple):
    """Per-filter subscriber bitmaps for 'big' filters.

    ``big_row[fid]`` maps a filter id to its bitmap row (-1 = small or
    unknown filter → CSR path)."""

    bitmaps: object  # uint32[R_cap, W] on the host, int32 bits on device
    big_row: object  # int32[F_cap]
    n_rows: int
    n_subs: int


def words_for(n_subs: int, tile: int = _DEFAULT_TILE) -> int:
    """Row width in uint32 words: next power of two ≥ the bit count
    (min one tile)."""
    w = (n_subs + 31) // 32
    out = max(tile, 1024)
    while out < w:
        out *= 2
    return out


def build_bitmaps(
    rows: Dict[int, Sequence[int]],
    num_filters: int,
    n_subs: int,
    row_capacity: int | None = None,
    tile: int = _DEFAULT_TILE,
) -> BitmapTable:
    """Pack ``{filter_id: [subscriber ids]}`` into bitmap rows (host)."""
    W = words_for(n_subs, tile)
    f_cap = capacity_for(num_filters)
    r_cap = capacity_for(max(1, len(rows)), row_capacity)
    bitmaps = np.zeros((r_cap, W), dtype=np.uint32)
    big_row = np.full((f_cap,), -1, dtype=np.int32)
    for r, (fid, subs) in enumerate(sorted(rows.items())):
        big_row[fid] = r
        ids = np.asarray(list(subs), dtype=np.int64)
        np.bitwise_or.at(bitmaps[r], ids // 32,
                         np.uint32(1) << (ids % 32).astype(np.uint32))
    return BitmapTable(bitmaps=bitmaps, big_row=big_row,
                       n_rows=len(rows), n_subs=n_subs)


def rows_for_matches(table: BitmapTable, match_ids: torch.Tensor,
                     mb: int = 16):
    """Translate matched filter ids ``[B, M]`` to bitmap rows
    ``[B, mb]`` (-1 padded, packed to the front; small filters drop
    out) plus a per-topic overflow flag (more than ``mb`` big
    matches). Ids at or past the table's filter capacity have no row:
    they drop, never clamp onto another filter's bitmap."""
    B = match_ids.shape[0]
    in_range = (match_ids >= 0) & (match_ids < table.big_row.shape[0])
    safe = torch.where(in_range, match_ids, 0).to(torch.int64)
    rows = torch.where(in_range, table.big_row[safe], -1)
    valid = rows >= 0
    pos = torch.cumsum(valid, dim=1) - 1
    idx = torch.where(valid, torch.clamp(pos, max=mb), mb)
    out = torch.full((B, mb + 1), -1, dtype=torch.int32,
                     device=match_ids.device).scatter_(
        1, idx, rows.to(torch.int32))[:, :mb]
    return out, valid.sum(dim=1) > mb


def or_bitmaps_ref(bitmaps: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The plain version: OR of bitmap rows per topic, one gather per
    row slot (the JAX package's ``or_bitmaps_xla``)."""
    B = rows.shape[0]
    acc = torch.zeros((B, bitmaps.shape[1]), dtype=bitmaps.dtype,
                      device=bitmaps.device)
    for m in range(rows.shape[1]):
        r = rows[:, m].to(torch.int64)
        acc |= torch.where((r >= 0)[:, None],
                           bitmaps[torch.clamp(r, min=0)], 0)
    return acc


def or_bitmaps_cuda(bitmaps: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Launch kernel B2: ``out[b] = OR bitmaps[rows[b, m]]`` for
    ``rows[b, m] >= 0``; ``bitmaps`` int32[R, W] with W a multiple of
    4 words, ``rows`` int32[B, mb]. Raises on anything the kernel does
    not take, or when the launch fails."""
    if not (bitmaps.is_cuda and rows.is_cuda) \
            or bitmaps.device != rows.device:
        raise ValueError("or_bitmaps_cuda: tensors must share one CUDA "
                         "device")
    if bitmaps.dtype != torch.int32 or rows.dtype != torch.int32:
        raise TypeError("or_bitmaps_cuda: int32 bitmaps and rows")
    R, W = bitmaps.shape
    B, mb = rows.shape
    if W % 4:
        raise ValueError(f"or_bitmaps_cuda: W={W} is not a multiple of 4")
    bitmaps = bitmaps.contiguous()
    rows = rows.contiguous()
    out = torch.empty((B, W), dtype=torch.int32, device=bitmaps.device)
    if B == 0:
        return out
    if bitmaps.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("or_bitmaps_cuda: rows must be 16-byte aligned")
    lib = _build.library()
    stream = torch.cuda.current_stream(bitmaps.device).cuda_stream
    rc = lib.emqx_bitmap_or(
        ctypes.c_void_p(bitmaps.data_ptr()), ctypes.c_void_p(rows.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), B, mb, W, R,
        ctypes.c_void_p(stream))
    _build.check(lib, rc, "bitmap_or")
    _build.LAUNCHES["bitmap_or"] += 1
    return out


def or_bitmaps_auto(bitmaps: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Kernel B2 on CUDA tensors, the plain version on CPU tensors."""
    if bitmaps.is_cuda:
        return or_bitmaps_cuda(bitmaps, rows)
    return or_bitmaps_ref(bitmaps, rows)
