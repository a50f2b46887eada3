"""Carry host tables across to the port's torch tensors.

The builders (the port's own copies, or the JAX package's — both are
numpy) produce host ``Automaton`` / ``FanoutTable`` / ``BitmapTable``
records. These functions place exactly what the device side reads:

  - an automaton's walk tables ``wt``, ``wt_seed`` and ``node2`` go to
    the device; ``wt_slots``, ``wt_take`` and ``hops_for_level`` stay
    host values (they size the kernel launch, never a device read);
  - fan-out CSR arrays and bitmap rows go to the device whole.

Bitmaps and the hash seed are stored as ``int32`` holding the
``uint32`` bits: an OR does not care about sign, the walk kernel
reads the seed as ``uint32``, and the fetched bundle needs no bitcast.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from emqx_tpu_torch.ops.bitmap import BitmapTable
from emqx_tpu_torch.ops.fanout import FanoutTable


class TorchAutomaton(NamedTuple):
    """The walkable subset of an automaton, on a torch device."""

    wt: torch.Tensor          # int32[NB, slots*SW]
    wt_seed: torch.Tensor     # int32[1] — the uint32 seed's bits
    node2: torch.Tensor       # int32[S2_cap, 4]
    wt_slots: int             # 2 = narrow, 4 = wide
    wt_take: int              # max words per literal hop
    hops_for_level: np.ndarray  # host int32[maxdepth + 1]


def _i32(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False)).to(device)


def automaton(auto, device) -> TorchAutomaton:
    """Place a host automaton's walk tables on ``device``."""
    return TorchAutomaton(
        wt=_i32(auto.wt, device),
        wt_seed=_i32(np.asarray(auto.wt_seed, np.uint32), device),
        node2=_i32(auto.node2, device),
        wt_slots=int(auto.wt_slots),
        wt_take=int(auto.wt_take),
        hops_for_level=np.asarray(auto.hops_for_level, np.int32),
    )


def fanout(table, device) -> FanoutTable:
    """Place a host fan-out CSR table on ``device``."""
    return FanoutTable(
        row_ptr=_i32(table.row_ptr, device),
        sub_ids=_i32(table.sub_ids, device),
        n_filters=int(table.n_filters),
        n_entries=int(table.n_entries),
        row_pairs=_i32(table.row_pairs, device),
    )


def bitmaps(table, device) -> BitmapTable:
    """Place a host bitmap table on ``device`` (rows as int32 bits)."""
    return BitmapTable(
        bitmaps=_i32(table.bitmaps, device),
        big_row=_i32(table.big_row, device),
        n_rows=int(table.n_rows),
        n_subs=int(table.n_subs),
    )
