"""Subscriber-bitmap fan-out for huge-fan-out filters (kernel B2).

Filters past the fan-out threshold keep their subscriber set as a
bitmap row (bit i = subscriber id i); a publish batch's fan-out is the
OR of its matched rows:

    out[b, :] = OR over m of bitmaps[rows[b, m], :]   (rows < 0 skipped)

``words_for`` / ``build_bitmaps`` are the JAX package's numpy
builders, copied. The publish path needs only the union rows of the
topics that matched a big filter, packed into a budget of ``pr`` rows
(``pack.union_slots`` gives the slot map ``src``).
:func:`or_union_rows_cuda` launches the hand-written CUDA kernel
(``csrc/bitmap_or.cu``, which replaces the Pallas
``emqx_tpu/ops/bitmap.py::_or_kernel_dma``) over those ``pr`` rows
only: one launch and no ``[B, W]`` union, since at the main path's
1-2 MiB a launch's latency, not bytes, bounds it.
:func:`or_union_rows_ref` is its plain version, equal to the JAX
package's ``pack_union_rows(or_bitmaps(...))`` composition.
:func:`or_union_rows_auto` picks by the device of the tensors it is
given: CUDA tensors launch the kernel (or raise), CPU tensors run the
plain version. The same kernel with a null slot map computes the dense
union: :func:`or_bitmaps_cuda`, whose plain version is
:func:`or_bitmaps_ref`.

:func:`or_bitmaps` is the entry point of the JAX package's BlockSpec
twin ``_or_kernel`` (kernel B4): the dense function under a stricter
contract (W a multiple of 1,024 words). On Hopper the two TPU
schedules are one kernel, so it launches the B2 kernel.

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
_TILE2D = 1024       # words per (8, 128) block of B4's layout
_MAX_BLK = 64        # (8, 128) blocks per B4 program


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


def _launch(bitmaps: torch.Tensor, rows: torch.Tensor,
            src: torch.Tensor | None, name: str) -> torch.Tensor:
    """One launch of kernel B2 over ``P`` output rows: ``src[p]`` (or
    ``p`` when ``src`` is None) names each row's topic. Raises on
    anything the kernel does not take, or when the launch fails."""
    tensors = (bitmaps, rows) + (() if src is None else (src,))
    if any(not t.is_cuda or t.device != bitmaps.device for t in tensors):
        raise ValueError(f"{name}: tensors must share one CUDA device")
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError(f"{name}: int32 bitmaps, rows and slot map")
    R, W = bitmaps.shape
    B, mb = rows.shape
    if W % 4:
        raise ValueError(f"{name}: W={W} is not a multiple of 4")
    if src is not None and src.dim() != 1:
        raise ValueError(f"{name}: the slot map must be 1-D")
    P = B if src is None else src.shape[0]
    bitmaps = bitmaps.contiguous()
    rows = rows.contiguous()
    src = None if src is None else src.contiguous()
    out = torch.empty((P, W), dtype=torch.int32, device=bitmaps.device)
    if P == 0:
        return out
    if bitmaps.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be 16-byte aligned")
    lib = _build.library()
    stream = torch.cuda.current_stream(bitmaps.device).cuda_stream
    rc = lib.emqx_bitmap_or(
        ctypes.c_void_p(bitmaps.data_ptr()), ctypes.c_void_p(rows.data_ptr()),
        ctypes.c_void_p(None if src is None else src.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), P, B, mb, W, R,
        ctypes.c_void_p(stream))
    _build.check(lib, rc, "bitmap_or")
    _build.LAUNCHES["bitmap_or"] += 1
    return out


def or_bitmaps_cuda(bitmaps: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Launch kernel B2 over every topic (a null slot map): the dense
    ``out[b] = OR bitmaps[rows[b, m]]`` for ``rows[b, m] >= 0``;
    ``bitmaps`` int32[R, W] with W a multiple of 4 words, ``rows``
    int32[B, mb]."""
    return _launch(bitmaps, rows, None, "or_bitmaps_cuda")


def or_union_rows_ref(bitmaps: torch.Tensor, rows: torch.Tensor,
                      src: torch.Tensor) -> torch.Tensor:
    """The plain version of the packed union: ``out[p]`` is the OR of
    topic ``src[p]``'s bitmap rows, zero where ``src[p] < 0``."""
    out = or_bitmaps_ref(bitmaps, rows[src.clamp(min=0).long()])
    return out.masked_fill_((src < 0)[:, None], 0)


def or_union_rows_cuda(bitmaps: torch.Tensor, rows: torch.Tensor,
                       src: torch.Tensor) -> torch.Tensor:
    """Launch kernel B2 over the packed rows only: ``out[p] = OR
    bitmaps[rows[src[p], m]]`` for ``rows[src[p], m] >= 0``, zero where
    ``src[p] < 0``; ``src`` int32[pr] from ``pack.union_slots``."""
    return _launch(bitmaps, rows, src, "or_union_rows_cuda")


def or_union_rows_auto(bitmaps: torch.Tensor, rows: torch.Tensor,
                       src: torch.Tensor) -> torch.Tensor:
    """Kernel B2 on CUDA tensors, the plain version on CPU tensors."""
    if bitmaps.is_cuda:
        return or_union_rows_cuda(bitmaps, rows, src)
    return or_union_rows_ref(bitmaps, rows, src)


def or_bitmaps(bitmaps: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Kernel B4's entry point: ``out[b] = OR bitmaps[rows[b, m]]`` for
    ``rows[b, m] >= 0``; ``bitmaps`` int32[R, W] with W a multiple of
    1,024 words, and of 65,536 when wider than that, as B4's 64-block
    programs need (``words_for`` widths always are); ``rows``
    int32[B, mb].
    CUDA tensors launch the B2 kernel, CPU tensors run
    :func:`or_bitmaps_ref`."""
    W = bitmaps.shape[1]
    wt = W // _TILE2D
    if W % _TILE2D or (wt > _MAX_BLK and wt % _MAX_BLK):
        raise ValueError(f"or_bitmaps: W={W} is not a multiple of "
                         f"{_TILE2D} words in {_MAX_BLK}-block programs")
    if not bitmaps.is_cuda:
        return or_bitmaps_ref(bitmaps, rows)
    out = or_bitmaps_cuda(bitmaps, rows)
    _build.LAUNCHES["or_bitmaps"] += 1
    return out
