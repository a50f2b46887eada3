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

:func:`preserialize_plan` then primes the batch's wire images on the
same thread (the egress pre-serialization: one shared QoS 0 frame, or
one packet-id template, per subscriber class and message), so the
event loop's delivery tail copies bytes instead of serializing.

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
from emqx_tpu_torch.mqtt.constants import MQTT_V5
from emqx_tpu_torch.mqtt.frame import publish_template
from emqx_tpu_torch.mqtt.frame import serialize as wire_serialize
from emqx_tpu_torch.mqtt.packet import Publish, from_message


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


#: ftab memo sentinel — a filter whose subscriber table resolved to
#: None must not be re-resolved per delivery
_NO_FTAB = object()


def preserialize_plan(plan: "DispatchPlan",
                      live: Sequence[Tuple[int, object]],
                      id_map: Sequence[Optional[str]],
                      subscribers: Dict[str, dict],
                      lookup) -> int:
    """Egress pre-serialization: collect the plan's distinct
    subscriber-filter classes, then prime each live message's wire
    caches BEFORE the finish tail runs:

      - QoS0 broadcast deliveries share one serialized frame per
        (proto_ver, flags variant) through the message's ``_wire``
        dict — built here instead of lazily on-loop by
        ``Channel._wire_cached``;
      - QoS1/2 deliveries get a packet-id-placeholder template per
        (proto_ver, effective qos, retain, dup) in ``_wiretpl``
        (:func:`~emqx_tpu_torch.mqtt.frame.publish_template`): the
        pid is always 2 bytes at a fixed offset, so the loop-side tail
        is a ``bytearray`` copy + 2-byte patch per subscriber.

    Per-session rewrites the template cannot carry — shared-group
    redispatch state, Subscription-Identifier, the Message-Expiry
    countdown — are detected here and skipped; those deliveries take
    the existing per-delivery serialize path unchanged.

    Runs wherever :meth:`~emqx_tpu_torch.broker.Broker.publish_fetch`
    runs (possibly an ingress executor thread): every broker read is a
    plain dict get (GIL-atomic, same discipline as the plan build's
    member snapshot), the session hints (``proto_ver`` /
    ``wire_fast_hint``) are stamped once at CONNECT, and the primed
    caches are best-effort — a variant the finish tail needs but
    doesn't find simply builds on-loop (counted by
    ``delivery.serialize.onloop``). Returns the number of frames
    built."""
    # Pass 1 — subscriber-filter CLASSES. The wire variant a delivery
    # needs is fully determined by (proto_ver, upgrade_qos, granted
    # qos, rap) plus the message's own flags, so instead of walking
    # every (subscriber, delivery) pair — O(deliveries) Python work
    # per batch — collect the distinct classes over the plan's
    # (group, fid) pairs and build per (class, message) in pass 2.
    # Variants dedupe by cache key, so a class that happens not to
    # touch a message over-builds a frame at worst (harmless); every
    # ACTUAL delivery's variant is covered. The delivery walk itself
    # shrinks to a fid-change probe per slot.
    classes: Dict[tuple, None] = {}
    g_ptr = plan.g_ptr
    fids = plan.fids
    ftab_of: Dict[int, object] = {}
    for g in range(plan.n_groups):
        sub = lookup(plan.g_sids[g])
        if sub is None:
            continue
        ver = getattr(sub, "proto_ver", None)
        if ver is None or not getattr(sub, "wire_fast_hint", False):
            continue
        upgrade = getattr(sub, "upgrade_qos", False)
        last_fid = -1          # within a group the same fid repeats
        seen: Optional[set] = None   # row-major — catch runs cheaply
        for k in range(g_ptr[g], g_ptr[g + 1]):
            fid = fids[k]
            if fid == last_fid:
                continue
            last_fid = fid
            if seen is None:
                seen = set()
            elif fid in seen:
                continue
            seen.add(fid)
            ftab = ftab_of.get(fid)
            if ftab is None:
                flt = id_map[fid]
                ftab = (subscribers.get(flt) or _NO_FTAB) \
                    if flt is not None else _NO_FTAB
                ftab_of[fid] = ftab
            opts = ftab.get(sub) if ftab is not _NO_FTAB else None
            if opts is None or opts.share is not None \
                    or opts.subid is not None:
                continue  # per-session rewrites: slow path
            classes[(ver, upgrade, opts.qos, opts.rap)] = None
    if not classes:
        return 0
    # Pass 2 — build per (class, live message): O(classes × batch)
    # serializes, each shared by every subscriber of that variant.
    built = 0
    class_list = list(classes)
    for _i, msg in live:
        headers = msg.headers
        props = headers.get("properties")
        if props and ("Message-Expiry-Interval" in props
                      or "Subscription-Identifier" in props):
            continue  # per-delivery countdown / per-session subid
        flags = msg.flags
        mqos = msg.qos
        retain = flags.get("retain", False)
        dup = flags.get("dup", False)
        retained = bool(headers.get("retained"))
        wire = tpl = None
        for ver, upgrade, oqos, rap in class_list:
            qos = max(oqos, mqos) if upgrade else min(oqos, mqos)
            if qos == 0:
                if mqos == 0 and not retain:
                    # broadcast fast path: the ORIGINAL message is
                    # shared, its own flags key the image
                    key = (ver, 0, retain, dup)
                else:
                    # downgraded-to-QoS0 enriched copy: _enrich
                    # clears retain unless rap/retained; the qos-in-
                    # key rule keeps it apart from any QoS>0 frame
                    key = (ver, 0,
                           retain and bool(rap or retained), dup)
                if wire is None:
                    wire = headers.get("_wire")
                    if wire is None:
                        wire = headers["_wire"] = {}
                if key not in wire:
                    pub = from_message(None, msg)
                    pub.qos = 0
                    pub.retain = key[2]
                    if ver != MQTT_V5:
                        pub.properties = {}
                    wire[key] = wire_serialize(pub, ver)
                    built += 1
                continue
            key = (ver, qos,
                   retain and bool(rap or retained), dup)
            if tpl is None:
                tpl = headers.get("_wiretpl")
                if tpl is None:
                    tpl = headers["_wiretpl"] = {}
            if key not in tpl:
                pub = Publish(
                    dup=dup, qos=qos, retain=key[2], topic=msg.topic,
                    packet_id=0,
                    properties=dict(props)
                    if (ver == MQTT_V5 and props) else {},
                    payload=msg.payload)
                tpl[key] = publish_template(pub, ver)
                built += 1
    return built


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
