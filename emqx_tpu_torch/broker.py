"""The PubSub core: subscription tables, publish entry, dispatch.

The port of the JAX package's ``Broker`` on its plain single-device
path. Mirrors ``src/emqx_broker.erl``: ``subscribe/3`` (127-136),
``publish/1`` (200-210, with the 'message.publish' hook veto),
``dispatch/2`` (283-309) and ``subscriber_down/1`` (331-348).

A publish batch runs in three phases, as in the JAX package:

  1. :meth:`Broker.publish_begin` — hooks and metrics, then the host
     regime (few filters) or the device path: dedup the topics, walk
     them (kernel B1 through :meth:`Router.match_dispatch`), pack the
     matches, expand the small-filter fan-out, OR the big filters'
     bitmap rows (kernel B2) and pack those rows — no device→host sync;
  2. :meth:`Broker.publish_fetch` — ONE device→host copy of everything
     packed, with a re-pack at the next power-of-two budget when a
     total overflowed and the adaptive k boost;
  3. :meth:`Broker.publish_finish` — the host delivery tail: the
     subscriber-grouped plan, or the per-row walk when a row overflowed
     (that row is re-matched exactly on the host).

Subscribers are any objects with ``deliver(topic_filter, msg)``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from emqx_tpu_torch import topic as T
from emqx_tpu_torch.broker_helper import FanoutManager, unpack_sids
from emqx_tpu_torch.hooks import Hooks
from emqx_tpu_torch.metrics import Metrics
from emqx_tpu_torch.ops.bitmap import or_bitmaps_auto, rows_for_matches
from emqx_tpu_torch.ops.dispatch_plan import big_rows_for, build_plan
from emqx_tpu_torch.ops.fanout import expand_packed
from emqx_tpu_torch.ops.pack import (budget_for, bundle_i32, mask_pad_rows,
                                     pack_matches, pack_union_rows)
from emqx_tpu_torch.router import MatcherConfig, Router
from emqx_tpu_torch.shared_sub import SharedSub
from emqx_tpu_torch.types import Message, SubOpts
from emqx_tpu_torch.utils.batch import dedup_topics

log = logging.getLogger("emqx_tpu_torch.broker")


@dataclasses.dataclass
class DispatchConfig:
    """The publish delivery tail.

    ``planner`` groups the fetched deliveries by subscriber (one
    resolve and one ``deliver_many`` per subscriber per batch); False
    keeps the per-(filter, subscriber) walk. ``preserialize`` (egress
    wire images) needs the front door, which this port does not carry
    yet: True raises rather than being ignored."""

    planner: bool = True
    preserialize: bool = False

    def __post_init__(self) -> None:
        if self.preserialize:
            raise ValueError("DispatchConfig.preserialize needs the front "
                             "door, which emqx_tpu_torch does not port yet")


class _PlanState:
    """Per-batch routing state the planned tail shares between its
    prologue and its group deliveries."""

    __slots__ = ("row_local", "row_fast", "ftabs", "counts")


class PendingBatch:
    """An in-flight batched publish (see :meth:`Broker.publish_begin`).

    ``done`` short-circuits: the host regime and an all-vetoed batch
    compute ``results`` inside ``publish_begin``. Fields ending in
    ``_d`` are device tensors; :meth:`Broker.publish_fetch` fills the
    host copies."""

    __slots__ = (
        "done", "results", "live", "inv", "n_uniq", "plan", "plan_state",
        "id_map", "epoch", "st", "ids_dev", "ovf_dev", "pm", "pq",
        "m_ptr_d", "ids_packed_d", "f_ptr_d", "subs_packed_d",
        "src_packed_d", "bovf_d", "sel_d", "rows_packed_d", "bm_total_d",
        "m_ptr", "ids_packed", "ovf", "f_ptr", "subs_packed", "src_packed",
        "bovf", "sel", "rows_packed",
    )

    def __init__(self) -> None:
        self.done = False
        self.results: List[int] = []
        self.live: List[Tuple[int, Message]] = []
        self.inv: Optional[List[int]] = None
        self.n_uniq = 0
        self.plan = None
        self.plan_state = None
        self.st = None
        self.ids_dev = self.ovf_dev = None
        self.m_ptr_d = self.ids_packed_d = None
        self.f_ptr_d = self.subs_packed_d = self.src_packed_d = None
        self.bovf_d = self.sel_d = self.rows_packed_d = None
        self.bm_total_d = None
        self.f_ptr = self.subs_packed = self.src_packed = None
        self.bovf = self.sel = self.rows_packed = None


class Broker:
    def __init__(
        self,
        router: Optional[Router] = None,
        hooks: Optional[Hooks] = None,
        metrics: Optional[Metrics] = None,
        shared: Optional[SharedSub] = None,
        node: str = "local",
        config: Optional[MatcherConfig] = None,
        dispatch_config: Optional[DispatchConfig] = None,
        device=None,
    ) -> None:
        self.node = node
        self.dispatch_config = dispatch_config or DispatchConfig()
        self.router = router or Router(config=config, node=node,
                                       device=device)
        self.device = self.router.device
        self.hooks = hooks or Hooks()
        self.metrics = metrics or Metrics()
        self.shared = shared or SharedSub()
        # subscriber-id registry + device fan-out tables
        self.helper = FanoutManager(
            threshold=self.router.config.fanout_threshold,
            device=self.device)
        # filter -> {subscriber: SubOpts}   (emqx_subscriber / emqx_suboption)
        self._subscribers: Dict[str, Dict[object, SubOpts]] = {}
        # subscriber -> {filter: SubOpts}   (emqx_subscription)
        self._subscriptions: Dict[object, Dict[str, SubOpts]] = {}
        self._route_lock = threading.RLock()
        # learned packed-transfer budgets per batch bucket
        self._pack_budgets: Dict[int, List[int]] = {}

    # -- subscribe / unsubscribe (emqx_broker.erl:127-196) ----------------

    def subscribe(self, sub: object, topic_filter: str,
                  opts: Optional[SubOpts] = None) -> SubOpts:
        """Subscribe ``sub`` to ``topic_filter`` (may carry a
        ``$share/<group>/`` prefix)."""
        T.validate(topic_filter, "filter")
        flt, popts = T.parse(topic_filter)
        opts = opts or SubOpts()
        if "share" in popts:
            opts.share = popts["share"]
        with self._route_lock:
            subs = self._subscriptions.setdefault(sub, {})
            resub = topic_filter in subs
            subs[topic_filter] = opts
            if opts.share is not None:
                if not resub:
                    self.shared.subscribe(opts.share, flt, sub)
                    self.router.add_route(flt, dest=(opts.share, self.node))
            else:
                self._subscribers.setdefault(flt, {})[sub] = opts
                if not resub:
                    self.helper.subscribe(flt, sub)
                    self.router.add_route(flt, dest=self.node)
        return opts

    def unsubscribe(self, sub: object, topic_filter: str) -> bool:
        flt, popts = T.parse(topic_filter)
        with self._route_lock:
            subs = self._subscriptions.get(sub)
            if subs is None or topic_filter not in subs:
                return False
            opts = subs.pop(topic_filter)
            if not subs:
                del self._subscriptions[sub]
            share = popts.get("share", opts.share)
            if share is not None:
                self.shared.unsubscribe(share, flt, sub)
                self.router.delete_route(flt, dest=(share, self.node))
            else:
                ftab = self._subscribers.get(flt)
                if ftab is not None:
                    ftab.pop(sub, None)
                    if not ftab:
                        del self._subscribers[flt]
                self.helper.unsubscribe(flt, sub)
                self.router.delete_route(flt, dest=self.node)
            if sub not in self._subscriptions:
                self.helper.release(sub)
        return True

    def subscriber_down(self, sub: object) -> None:
        """Drop all of a dead subscriber's subscriptions
        (emqx_broker.erl:331-348)."""
        with self._route_lock:
            for key in list(self._subscriptions.get(sub, {})):
                self.unsubscribe(sub, key)
            self.shared.subscriber_down(sub)

    def subscribers(self, topic_filter: str) -> List[object]:
        return list(self._subscribers.get(topic_filter, ()))

    def subscriptions(self, sub: object) -> Dict[str, SubOpts]:
        return dict(self._subscriptions.get(sub, {}))

    # -- publish (emqx_broker.erl:200-309) --------------------------------

    def publish(self, msg: Message) -> int:
        """Publish one message; returns its delivery count."""
        return self.publish_batch([msg])[0]

    def publish_batch(self, msgs: Sequence[Message]) -> List[int]:
        """Batch publish: begin (match + fan-out + pack on the device),
        fetch (one copy), finish (host delivery tail)."""
        pb = self.publish_begin(msgs)
        if pb.done:
            return pb.results
        self.publish_fetch(pb)
        return self.publish_finish(pb)

    def publish_begin(self, msgs: Sequence[Message]) -> PendingBatch:
        """Phase 1 — hooks, veto and metrics, then the host regime or
        the device dispatch (no sync)."""
        pb = PendingBatch()
        pb.results = [0] * len(msgs)
        for i, msg in enumerate(msgs):
            self.metrics.inc_msg(msg)
            out = self.hooks.run_fold("message.publish", (), msg)
            if out is None or out.get_header("allow_publish") is False:
                self.metrics.inc("messages.dropped")
                self.hooks.run("message.dropped",
                               (out if out is not None else msg, "vetoed"))
                continue
            self.metrics.inc("messages.publish")
            if out.flags.get("retain"):
                self.metrics.inc("messages.retained")
            pb.live.append((i, out))
        if not pb.live:
            pb.done = True
            return pb
        topics = [m.topic for _, m in pb.live]
        if not self.router.use_device_now():
            return self._begin_host(pb, topics)
        return self._begin_device(pb, topics, self.router.config)

    def _begin_host(self, pb: PendingBatch, topics: List[str]) -> PendingBatch:
        """The host regime: one trie walk per unique topic, routed
        now."""
        uniq, inv = dedup_topics(topics)
        pb.n_uniq = len(uniq)
        matched = self.router.match_filters_host(uniq)
        for row, (i, msg) in enumerate(pb.live):
            filters = matched[inv[row]]
            if not filters:
                self._drop_no_subs(msg)
                continue
            pb.results[i] = self._route(filters, msg)
        pb.done = True
        return pb

    def _bitmap_union(self, pb: PendingBatch, cfg, pr: int) -> None:
        """Big-filter fan-out: matched ids → bitmap rows → OR (kernel
        B2 on CUDA) → packed union rows."""
        rows_d, pb.bovf_d = rows_for_matches(
            pb.st.bm, pb.ids_dev, mb=cfg.fanout_mb)
        union_d = or_bitmaps_auto(pb.st.bm.bitmaps, rows_d)
        has_big = (rows_d >= 0).any(dim=1)
        pb.sel_d, pb.rows_packed_d, pb.bm_total_d = pack_union_rows(
            union_d, has_big, pr=pr)

    def _begin_device(self, pb: PendingBatch, topics: List[str],
                      cfg) -> PendingBatch:
        """Device match (HOT LOOP 1) → device fan-out (HOT LOOP 2) →
        pack, all queued without a sync. Duplicate topics collapse to
        one device row; the tail expands per message via ``inv``."""
        uniq, pb.inv = dedup_topics(topics)
        pb.n_uniq = len(uniq)
        pb.ids_dev, pb.ovf_dev, pb.id_map, pb.epoch = \
            self.router.match_dispatch(uniq)
        # phantom pad-row matches (wildcards match the pad topic) must
        # not reach the fan-out, the pack or the learned budgets
        pb.ids_dev = mask_pad_rows(pb.ids_dev, len(uniq))
        pb.st = self.helper.state(pb.epoch, pb.id_map)
        bucket = pb.ids_dev.shape[0]
        budgets = self._pack_budgets.setdefault(
            bucket, [budget_for(bucket, cfg.pack_m),
                     budget_for(bucket, cfg.pack_q),
                     max(1, cfg.pack_rows)])
        pb.pm = budgets[0]
        pb.m_ptr_d, pb.ids_packed_d = pack_matches(pb.ids_dev, pm=pb.pm)
        st = pb.st
        if st is not None and st.fan is not None:
            pb.pq = budgets[1]
            pb.f_ptr_d, pb.subs_packed_d, pb.src_packed_d, _tot = \
                expand_packed(st.fan, pb.m_ptr_d, pb.ids_packed_d, q=pb.pq)
        if st is not None and st.bm is not None:
            self._bitmap_union(pb, cfg, budgets[2])
        return pb

    def fetch_parts(self, pb: PendingBatch) -> list:
        """The device tensors one fetch bundles, in bundle order."""
        parts = [pb.m_ptr_d, pb.ids_packed_d, pb.ovf_dev]
        if pb.f_ptr_d is not None:
            parts += [pb.f_ptr_d, pb.subs_packed_d, pb.src_packed_d]
        if pb.sel_d is not None:
            parts += [pb.sel_d, pb.rows_packed_d, pb.bm_total_d, pb.bovf_d]
        return parts

    def publish_fetch(self, pb: PendingBatch) -> None:
        """Phase 2 — the one device→host copy."""
        if pb.done:
            return
        self._fetch_device(pb)

    def _fetch_device(self, pb: PendingBatch) -> None:
        """The fetch body: on a packed-budget overflow, re-pack with
        the next power-of-two bucket (the dense arrays are still on the
        device) and remember the grown budget for the bucket."""
        cfg = self.router.config
        Bp = pb.ids_dev.shape[0]
        budgets = self._pack_budgets.get(Bp)
        while True:
            # ONE device buffer → ONE transfer
            buf = bundle_i32(*self.fetch_parts(pb)).cpu().numpy()
            off = 0

            def take(n):
                nonlocal off
                out = buf[off:off + n]
                off += n
                return out

            m_ptr = take(Bp + 1)
            ids_packed = take(pb.pm)
            ovf = take(Bp).astype(bool)
            if pb.f_ptr_d is not None:
                f_ptr = take(Bp + 1)
                subs_p = take(pb.pq)
                src_p = take(pb.pq)
            else:
                f_ptr = subs_p = src_p = None
            if pb.sel_d is not None:
                pr, W = pb.rows_packed_d.shape
                sel = take(Bp)
                rows_p = take(pr * W).view(np.uint32).reshape(pr, W)
                bm_total = int(take(1)[0])
                bovf = take(Bp).astype(bool)
            else:
                sel = rows_p = bm_total = bovf = None
            # budget overflow → re-pack with the next bucket
            retry = False
            m_repacked = False
            if int(m_ptr[-1]) > pb.pm:
                while pb.pm < int(m_ptr[-1]):
                    pb.pm *= 2
                if budgets is not None:
                    budgets[0] = max(budgets[0], pb.pm)
                pb.m_ptr_d, pb.ids_packed_d = pack_matches(
                    pb.ids_dev, pm=pb.pm)
                m_repacked = True
                retry = True
            if f_ptr is not None and (m_repacked
                                      or int(f_ptr[-1]) > pb.pq):
                # a truncated match pack also truncates the expansion
                while pb.pq < int(f_ptr[-1]):
                    pb.pq *= 2
                if budgets is not None:
                    budgets[1] = max(budgets[1], pb.pq)
                pb.f_ptr_d, pb.subs_packed_d, pb.src_packed_d, _t = \
                    expand_packed(pb.st.fan, pb.m_ptr_d, pb.ids_packed_d,
                                  q=pb.pq)
                retry = True
            if bm_total is not None and bm_total > pb.rows_packed_d.shape[0]:
                pr = pb.rows_packed_d.shape[0]
                while pr < bm_total:
                    pr *= 2
                if budgets is not None:
                    budgets[2] = max(budgets[2], pr)
                self._bitmap_union(pb, cfg, pr)
                retry = True
            if retry:
                continue
            # adaptive capacity: > 1/8 of the unique topics overflowed
            # the match bound → k undersizes the workload; grow it for
            # the NEXT batch (this one has its exact host re-match)
            n_u = max(1, pb.n_uniq)
            n_fb = int(ovf[:n_u].sum())
            if n_fb:
                self.router.note_match_fallbacks(n_fb)
            if n_fb * 8 > n_u:
                self.router.boost_k()
            pb.m_ptr = m_ptr
            # slice to true occupancy before the per-element list
            # conversion — the budget tail is dead -1 padding
            pb.ids_packed = ids_packed[:int(m_ptr[-1])].tolist()
            pb.ovf = ovf
            pb.f_ptr = f_ptr
            if subs_p is not None:
                occ = int(f_ptr[-1])
                subs_occ = subs_p[:occ]
                src_occ = src_p[:occ]
            else:
                subs_occ = src_occ = None
            pb.sel = sel
            pb.rows_packed = rows_p
            pb.bovf = bovf
            if self.dispatch_config.planner:
                pb.plan = self._build_plan(pb, subs_occ, src_occ)
            if pb.plan is not None:
                pb.subs_packed = subs_occ
                pb.src_packed = src_occ
            elif subs_occ is not None:
                pb.subs_packed = subs_occ.tolist()
                pb.src_packed = src_occ.tolist()
            return

    def _build_plan(self, pb: PendingBatch, subs_packed, src_packed):
        """The batch's subscriber-grouped dispatch plan
        (ops/dispatch_plan.py); ``None`` when an overflow row needs
        the per-row tail."""
        n_u = pb.n_uniq
        if n_u and bool(pb.ovf[:n_u].any()):
            return None
        if pb.bovf is not None and n_u and bool(pb.bovf[:n_u].any()):
            return None
        big_set = pb.st.big_fids if pb.st is not None else frozenset()
        big_map: Dict[int, list] = {}
        if pb.sel is not None and big_set:
            id_map = pb.id_map
            big_map = big_rows_for(
                pb.ids_packed, pb.m_ptr, pb.sel, pb.rows_packed,
                sorted(set(pb.inv)), big_set,
                lambda fid: self.helper.members_sorted(id_map[fid]))
        return build_plan(pb.inv, n_u, pb.ovf, pb.bovf, pb.f_ptr,
                          subs_packed, src_packed, big_map)

    def publish_finish(self, pb: PendingBatch) -> List[int]:
        """Phase 3 — the host delivery tail over the packed results."""
        if pb.done:
            return pb.results
        if pb.plan is not None:
            self._finish_planned(pb)
        else:
            self._finish_rows(pb)
        pb.done = True
        return pb.results

    # -- the planned tail ---------------------------------------------------

    def _plan_prologue(self, pb: PendingBatch) -> _PlanState:
        """Classify every matched filter id once (local / shared), then
        walk the live rows doing the per-message work the plan cannot
        carry: no-subscriber drops and shared-group picks. Local
        delivery is the plan's."""
        ps = _PlanState()
        n_live = len(pb.live)
        ps.row_local = bytearray(n_live)
        ps.row_fast = bytearray(n_live)
        ps.counts = [None] * n_live
        ps.ftabs = {}
        id_map = pb.id_map
        m_ptr = pb.m_ptr
        ids_packed = pb.ids_packed
        route_of: Dict[int, tuple] = {}
        for r in range(n_live):
            i, msg = pb.live[r]
            urow = pb.inv[r]
            seen_filter = False
            local = False
            n = 0
            for j in ids_packed[m_ptr[urow]:m_ptr[urow + 1]]:
                if j < 0:
                    continue  # pad slot: id_map[-1] would alias
                info = route_of.get(j)
                if info is None:
                    flt = id_map[j]
                    if flt is None:
                        info = (None, False, ())
                    else:
                        loc = False
                        groups: List[str] = []
                        for route in self.router.lookup_routes(flt):
                            if isinstance(route.dest, tuple):
                                groups.append(route.dest[0])
                            else:
                                loc = True
                        ps.ftabs[j] = self._subscribers.get(flt)
                        info = (flt, loc, tuple(groups))
                    route_of[j] = info
                flt, loc, groups = info
                if flt is None:
                    continue
                seen_filter = True
                local = local or loc
                for group in groups:
                    n += self.shared.dispatch(group, flt, msg)
            if not seen_filter:
                self._drop_no_subs(msg)
                continue
            pb.results[i] = n
            if local:
                ps.row_local[r] = 1
            if msg.qos == 0 and not msg.flags.get("retain"):
                ps.row_fast[r] = 1
        return ps

    def _finish_planned(self, pb: PendingBatch) -> None:
        """Deliver every subscriber group, then fold the per-(message,
        filter) counts into metrics, hooks and results."""
        ps = pb.plan_state = self._plan_prologue(pb)
        counts = ps.counts
        for g in range(pb.plan.n_groups):
            for r, flt in self._deliver_plan_group(pb, ps, g):
                d = counts[r]
                if d is None:
                    d = counts[r] = {}
                d[flt] = d.get(flt, 0) + 1
        for r, (i, msg) in enumerate(pb.live):
            d = counts[r]
            if not d:
                continue
            n = 0
            for cnt in d.values():
                n += cnt
                self.metrics.inc("messages.delivered", cnt)
                self.hooks.run("message.delivered", (msg, cnt))
            pb.results[i] += n

    def _deliver_plan_group(self, pb: PendingBatch, ps: _PlanState,
                            g: int):
        """Deliver one plan group — one subscriber's whole batch: one
        resolve, one ``deliver_many`` (or per-delivery ``deliver`` for
        plain subscriber objects). Returns the delivered
        ``(row, filter)`` pairs."""
        plan = pb.plan
        sub = self.helper.registry.lookup(plan.g_sids[g])
        if sub is None:
            return ()  # unsubscribed since the tables were built
        id_map = pb.id_map
        sub_cid = getattr(sub, "client_id", None)
        upgrade = getattr(sub, "upgrade_qos", False)
        items: List[tuple] = []
        accepted: List[tuple] = []
        for kk in range(plan.g_ptr[g], plan.g_ptr[g + 1]):
            r = plan.rows[kk]
            if not ps.row_local[r]:
                continue
            fid = plan.fids[kk]
            ftab = ps.ftabs.get(fid)
            if ftab is None:
                continue
            opts = ftab.get(sub)
            if opts is None:
                continue
            i, msg = pb.live[r]
            if opts.nl and sub_cid == msg.from_:
                self.metrics.inc("delivery.dropped")
                self.metrics.inc("delivery.dropped.no_local")
                continue
            flt = id_map[fid]
            fast = bool(ps.row_fast[r]) and opts.share is None \
                and not opts.nl and opts.subid is None \
                and (opts.qos == 0 or not upgrade)
            items.append((flt, msg, opts, fast))
            accepted.append((r, flt))
        if not items:
            return ()
        dm = getattr(sub, "deliver_many", None)
        if dm is not None:
            try:
                dm(items)
            except Exception:
                log.exception("deliver_many to %r failed", sub)
                return ()
            return accepted
        delivered: List[tuple] = []
        for (flt, msg, _o, _f), rf in zip(items, accepted):
            try:
                sub.deliver(flt, msg)
                delivered.append(rf)
            except Exception:
                log.exception("deliver to %r failed", sub)
        return delivered

    # -- the per-row tail ---------------------------------------------------

    def _finish_rows(self, pb: PendingBatch) -> None:
        """Deliver row by row; a row whose match overflowed is
        re-matched exactly on the host trie (parity, no truncation)."""
        m_ptr = pb.m_ptr
        for row in range(len(pb.live)):
            i, msg = pb.live[row]
            urow = pb.inv[row]  # packed results are per UNIQUE topic
            if pb.ovf[urow]:
                filters = self.router.host_match(msg.topic)
                if not filters:
                    self._drop_no_subs(msg)
                else:
                    pb.results[i] = self._route(filters, msg)
                continue
            # pad slots (-1) must never resolve through the id map
            row_ids = [j for j in pb.ids_packed[m_ptr[urow]:m_ptr[urow + 1]]
                       if j >= 0]
            filters = [pb.id_map[j] for j in row_ids]
            filters = [f for f in filters if f is not None]
            if not filters:
                self._drop_no_subs(msg)
                continue
            pb.results[i] = self._route_packed(urow, row_ids, filters,
                                               msg, pb)

    def _drop_no_subs(self, msg: Message) -> None:
        self.metrics.inc("messages.dropped")
        self.metrics.inc("messages.dropped.no_subscribers")
        self.hooks.run("message.dropped", (msg, "no_subscribers"))

    def _route(self, filters: List[str], msg: Message,
               local_deliver=None) -> int:
        """Fan a matched message out to local subscribers and shared
        groups (route/2). Every route is this node's: the router
        refuses others. ``local_deliver(local_filters) -> int``
        overrides the local step (the device fan-out tail plugs in
        here)."""
        n = 0
        shared: List[Tuple[str, str]] = []
        local: List[str] = []
        for flt in filters:
            for route in self.router.lookup_routes(flt):
                if isinstance(route.dest, tuple):  # (group, node)
                    shared.append((route.dest[0], flt))
                else:
                    local.append(flt)
        if local:
            if local_deliver is not None:
                n += local_deliver(local)
            else:
                for flt in local:
                    n += self.dispatch(flt, msg)
        for group, flt in shared:
            n += self.shared.dispatch(group, flt, msg)
        return n

    def _route_packed(self, row: int, row_ids: List[int],
                      filters: List[str], msg: Message,
                      pb: PendingBatch) -> int:
        """Route one matched message with local delivery from the
        packed device fan-out (CSR sub-id slots + bitmap union rows)."""
        def local_deliver(local_filters: List[str]) -> int:
            overflowed = (pb.bovf is not None and pb.bovf[row]) \
                or (pb.st is None and pb.f_ptr is None)
            if overflowed:
                # per-message capacity exceeded: host dispatch loop
                return sum(self.dispatch(flt, msg) for flt in local_filters)
            n = 0
            per_filter: Dict[str, int] = {}
            id_map = pb.id_map
            lookup = self.helper.registry.lookup
            if pb.f_ptr is not None:
                for kk in range(pb.f_ptr[row], pb.f_ptr[row + 1]):
                    if pb.src_packed[kk] < 0:
                        continue  # pad slot: never index with -1
                    flt = id_map[pb.src_packed[kk]]
                    sub = lookup(pb.subs_packed[kk])
                    if sub is not None and flt is not None:
                        d = self._deliver_one(flt, sub, msg)
                        if d:
                            per_filter[flt] = per_filter.get(flt, 0) + d
            big_set = pb.st.big_fids if pb.st is not None else frozenset()
            if pb.sel is not None and pb.sel[row] >= 0 and big_set:
                self._deliver_big(row, row_ids, msg, pb, per_filter,
                                  big_set)
            for flt, cnt in per_filter.items():
                n += cnt
                self.metrics.inc("messages.delivered", cnt)
                self.hooks.run("message.delivered", (msg, cnt))
            return n

        return self._route(filters, msg, local_deliver=local_deliver)

    def _deliver_big(self, row: int, row_ids: List[int], msg: Message,
                     pb: PendingBatch, per_filter: Dict[str, int],
                     big_set: frozenset) -> None:
        """Deliver a message's bitmap-path (> threshold) fan-out by
        walking the set bits of its OR'd union row; with several
        matched big filters each (filter, member) pair delivers
        separately."""
        matched_big = [j for j in row_ids if j in big_set]
        if not matched_big:
            return
        id_map = pb.id_map
        sids = unpack_sids(pb.rows_packed[pb.sel[row]])
        lookup = self.helper.registry.lookup
        if len(matched_big) == 1:
            flt = id_map[matched_big[0]]
            ftab = self._subscribers.get(flt)
            for sid in sids:
                sub = lookup(int(sid))
                if sub is not None:
                    d = self._deliver_one(flt, sub, msg, ftab)
                    if d:
                        per_filter[flt] = per_filter.get(flt, 0) + d
            return
        rows_by_fid = [(id_map[fid], self.helper.members(id_map[fid]),
                        self._subscribers.get(id_map[fid]))
                       for fid in matched_big]
        for sid in sids:
            isid = int(sid)
            sub = lookup(isid)
            if sub is None:
                continue
            for flt, members, ftab in rows_by_fid:
                if isid in members:
                    d = self._deliver_one(flt, sub, msg, ftab)
                    if d:
                        per_filter[flt] = per_filter.get(flt, 0) + d

    def _deliver_one(self, topic_filter: str, sub: object,
                     msg: Message, ftab: Optional[dict] = None) -> int:
        """One (filter, subscriber) delivery with the no-local check;
        the deliver carries the *subscribed filter*
        (emqx_broker.erl:298)."""
        if ftab is None:
            ftab = self._subscribers.get(topic_filter)
        opts = ftab.get(sub) if ftab else None
        if opts is None:
            return 0  # unsubscribed since the tables were built
        if opts.nl and getattr(sub, "client_id", None) == msg.from_:
            self.metrics.inc("delivery.dropped")
            self.metrics.inc("delivery.dropped.no_local")
            return 0
        try:
            sub.deliver(topic_filter, msg)
            return 1
        except Exception:
            log.exception("deliver to %r failed", sub)
            return 0

    def dispatch(self, topic_filter: str, msg: Message) -> int:
        """Deliver to every local subscriber of ``topic_filter``
        (emqx_broker.erl:283-309) — the host dispatch loop."""
        ftab = self._subscribers.get(topic_filter)
        if not ftab:
            return 0
        n = 0
        for sub in list(ftab):
            n += self._deliver_one(topic_filter, sub, msg, ftab)
        if n:
            self.metrics.inc("messages.delivered", n)
            self.hooks.run("message.delivered", (msg, n))
        return n
