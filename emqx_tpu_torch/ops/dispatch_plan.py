"""Batch dispatch planner: subscriber-grouped delivery tail.

The packed device results (CSR subscriber slots + bitmap union rows,
ops/pack.py) used to be walked one ``(filter, subscriber)`` pair at a
time through ``Broker._route_packed`` → ``_deliver_one`` →
``Session.deliver`` — one registry lookup, one subopts dict fetch and
one notify wakeup **per delivery**. At live fan-outs that Python walk
is the whole publish tail (BENCH ``live_socket_throughput``); the
reference's own hot loop 2 is the same walk (``emqx_broker:dispatch/2``,
src/emqx_broker.erl:283-309), and its ``emqx_batch.erl``
accumulate-then-flush idea applies to the tail as much as to ingress.

This module (the port's copy of the JAX package's numpy planner)
builds the whole batch's delivery plan with numpy on the
**already-fetched** packed arrays — no broker state, no device work:

  1. expand the CSR slices ``(f_ptr, subs_packed, src_packed)`` per
     live message (vectorized repeat/arange arithmetic, one scatter);
  2. append the bitmap-path deliveries (union-row set bits, attributed
     to their matched big filters);
  3. stable-argsort the ``(sub_id, fid, row)`` triples **by
     subscriber** and cut group boundaries.

Stability is the correctness keystone: triples are laid out in the
legacy walk order (row-major; CSR slots then bitmap bits within a
row), so after the stable sort every subscriber's deliveries are in
exactly the order the per-delivery walk would have produced — the
grouped enqueue is a permutation **across** subscribers only, which no
connection can observe. The broker then resolves each subscriber's
session once per batch, hands it its whole group in one
``deliver_many`` call, and fires one notify wakeup per connection per
batch.

A batch with any match/bitmap capacity overflow row plans as ``None``
and takes the legacy per-delivery path unchanged (overflow rows host-
re-match mid-walk; interleaving that with grouped delivery would
reorder a subscriber's stream). Overflow self-corrects via boost_k /
pack-budget growth, so steady state always plans.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from emqx_tpu_torch.broker_helper import unpack_sids


class DispatchPlan:
    """One batch's subscriber-grouped delivery order.

    Per-delivery sequences (all length ``n_deliveries``, sorted so
    each subscriber's deliveries are contiguous and in legacy walk
    order). The grouping math is numpy; the stored fields are plain
    Python lists because the delivery loop consumes them one element
    at a time, and list indexing + int dict hashing beat numpy
    scalar access several-fold there:

      - ``fids``  matched filter id (automaton snapshot id)
      - ``rows``  live-row index into ``PendingBatch.live``

    Groups: ``g_ptr[g]:g_ptr[g+1]`` slices group ``g``; ``g_sids[g]``
    is its subscriber id. ``n_groups`` is the chunking unit the
    ingress yields between (one group = one session's whole batch).
    """

    __slots__ = ("fids", "rows", "g_ptr", "g_sids", "n_deliveries")

    def __init__(self, sids: np.ndarray, fids: np.ndarray,
                 rows: np.ndarray) -> None:
        self.n_deliveries = int(sids.shape[0])
        if self.n_deliveries:
            order = np.argsort(sids, kind="stable")
            sids = sids[order]
            self.fids = fids[order].tolist()
            self.rows = rows[order].tolist()
            cuts = np.flatnonzero(sids[1:] != sids[:-1]) + 1
            self.g_ptr = np.concatenate(
                ([0], cuts, [self.n_deliveries])).tolist()
            self.g_sids = sids[np.concatenate(([0], cuts))].tolist()
        else:
            self.fids = self.rows = []
            self.g_ptr = [0]
            self.g_sids = []

    @property
    def n_groups(self) -> int:
        return len(self.g_sids)


def big_rows_for(ids_packed: Sequence[int], m_ptr: np.ndarray,
                 sel: np.ndarray, rows_packed: np.ndarray,
                 urows: Sequence[int], big_set: frozenset,
                 members_of) -> Dict[int, List[Tuple[int, np.ndarray]]]:
    """Per-unique-row bitmap deliveries: ``urow -> [(fid, sids)]``.

    ``members_of(fid) -> sorted int64 array`` attributes a union
    row's set bits when several big filters matched the same topic
    (the union OR'd their rows together); with a single matched big
    filter every set bit is its delivery, no membership test — the
    exact split ``Broker._deliver_big`` makes per message, hoisted to
    once per unique topic."""
    out: Dict[int, List[Tuple[int, np.ndarray]]] = {}
    if sel is None or not big_set:
        return out
    for urow in urows:
        if sel[urow] < 0:
            continue
        row_ids = ids_packed[m_ptr[urow]:m_ptr[urow + 1]]
        matched = [j for j in row_ids if j in big_set]
        if not matched:
            continue
        sids = unpack_sids(rows_packed[sel[urow]]).astype(np.int64)
        if len(matched) == 1:
            out[urow] = [(matched[0], sids)]
            continue
        parts: List[Tuple[int, np.ndarray]] = []
        for fid in matched:
            members = members_of(fid)
            parts.append((fid, sids[np.isin(sids, members,
                                            assume_unique=True)]))
        out[urow] = parts
    return out


def build_plan(inv: Sequence[int], n_uniq: int,
               ovf: np.ndarray, bovf: Optional[np.ndarray],
               f_ptr: Optional[np.ndarray],
               subs_packed: Optional[np.ndarray],
               src_packed: Optional[np.ndarray],
               big_by_urow: Dict[int, List[Tuple[int, np.ndarray]]],
               ) -> Optional[DispatchPlan]:
    """The numpy grouping pass. ``None`` = batch not plannable (a
    capacity-overflow row needs the legacy mid-walk host fallback).

    ``inv`` maps live rows to unique-topic rows; ``ovf``/``bovf`` are
    the fetched per-unique-row overflow flags; the CSR triple comes
    straight from the fetched pack (numpy, NOT the legacy ``tolist``
    copies); ``big_by_urow`` from :func:`big_rows_for`.
    """
    n_live = len(inv)
    if n_uniq and bool(ovf[:n_uniq].any()):
        return None
    if bovf is not None and n_uniq and bool(bovf[:n_uniq].any()):
        return None
    u = np.asarray(inv, dtype=np.int64)
    if f_ptr is not None:
        fp = np.asarray(f_ptr, dtype=np.int64)
        start = fp[u]
        cnt = fp[u + 1] - start
    else:
        start = cnt = np.zeros(n_live, np.int64)
    bm_cnt = np.zeros(n_live, np.int64)
    if big_by_urow:
        totals = {urow: sum(len(s) for _, s in parts)
                  for urow, parts in big_by_urow.items()}
        for r, urow in enumerate(inv):
            t = totals.get(urow)
            if t:
                bm_cnt[r] = t
    row_tot = cnt + bm_cnt
    out_ptr = np.concatenate(([0], np.cumsum(row_tot)))
    total = int(out_ptr[-1])
    sids = np.empty(total, np.int64)
    fids = np.empty(total, np.int64)
    rows = np.empty(total, np.int64)
    n_csr = int(cnt.sum())
    if n_csr:
        cum = np.concatenate(([0], np.cumsum(cnt)))
        ar = np.arange(n_csr)
        intra = ar - np.repeat(cum[:-1], cnt)
        src_idx = intra + np.repeat(start, cnt)
        dst = intra + np.repeat(out_ptr[:-1], cnt)
        sids[dst] = np.asarray(subs_packed, np.int64)[src_idx]
        fids[dst] = np.asarray(src_packed, np.int64)[src_idx]
        rows[dst] = np.repeat(np.arange(n_live), cnt)
    if big_by_urow:
        for r, urow in enumerate(inv):
            parts = big_by_urow.get(urow)
            if not parts:
                continue
            off = int(out_ptr[r] + cnt[r])
            for fid, part in parts:
                n = len(part)
                sids[off:off + n] = part
                fids[off:off + n] = fid
                rows[off:off + n] = r
                off += n
    return DispatchPlan(sids, fids, rows)
