"""The PubSub core: subscription tables, publish entry, dispatch.

The port of the JAX package's ``Broker``. Mirrors ``src/emqx_broker.erl``: ``subscribe/3`` (127-136),
``publish/1`` (200-210, with the 'message.publish' hook veto),
``dispatch/2`` (283-309) and ``subscriber_down/1`` (331-348).

A publish batch runs in three phases, as in the JAX package:

  1. :meth:`Broker.publish_begin` — hooks and metrics, then the host
     regime (few filters) or the device path: dedup the topics, walk
     them (kernel B1 through :meth:`Router.match_dispatch`), pack the
     matches, expand the small-filter fan-out, OR the big filters'
     bitmap rows (kernel B2) and pack those rows — no device→host sync;
     On a mesh (``MatcherConfig.mesh``) the match and the fan-out are
     one collective step (:meth:`Router.publish_dispatch_sharded`:
     B1 once per (data, trie) cell, the per-shard subscriber gather,
     kernel B2's dense union per cell with big filters), then the
     dense results pack for the copy;
  2. :meth:`Broker.publish_fetch` — ONE device→host copy of everything
     packed, with a re-pack at the next power-of-two budget when a
     total overflowed and the adaptive k boost;
  3. :meth:`Broker.publish_finish` — the host delivery tail: the
     subscriber-grouped plan, or the per-row walk when a row overflowed
     (that row is re-matched exactly on the host). The ingress batcher
     streams the same tail in chunks (:meth:`publish_finish_planned`
     over subscriber groups, :meth:`publish_finish_chunk` and
     :meth:`publish_host_chunk` over rows), yielding to the event loop
     between them; chunked or whole, the deliveries are the same.

With a :class:`~emqx_tpu_torch.overload.DeviceBreaker` attached (the
``Node`` attaches one by default), a begin or fetch that raises is
recorded and its batch is served exactly from the host trie; an open
breaker sends every batch there (``breaker.fallback.batches``) until a
half-open probe closes it. A ``Broker`` on CUDA loads (building if
need be) its kernel library when it is constructed, so a build failure
raises here and is never served from the host.

With telemetry wired (the ``Node`` wires it, on by default) every
batch carries a :class:`~emqx_tpu_torch.telemetry.PublishSpan` from
``publish_begin`` to its last delivery chunk, which closes it once;
with tracing at a sample rate above 0, the sampled messages of a batch
carry a trace batch along the same seams (``tracing.py``).

In a cluster (``cluster.py``) a matched filter may route to other
nodes: every node's automaton holds the whole cluster's filters, the
delivery tail forwards one message per remote (node, filter) through
:attr:`Broker.forwarder` and picks one node per shared group through
:attr:`Broker.shared_router`.

Subscribers are any objects with ``deliver(topic_filter, msg)``.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from emqx_tpu_torch import faults
from emqx_tpu_torch import topic as T
from emqx_tpu_torch.broker_helper import FanoutManager, unpack_sids
from emqx_tpu_torch.hooks import Hooks
from emqx_tpu_torch.metrics import Metrics
from emqx_tpu_torch.ops import _build
from emqx_tpu_torch.ops.bitmap import or_union_rows_auto, rows_for_matches
from emqx_tpu_torch.ops.dispatch_plan import (big_rows_for, build_plan,
                                              preserialize_plan)
from emqx_tpu_torch.ops.fanout import expand_packed
from emqx_tpu_torch.ops.pack import (budget_for, bundle_i32, mask_pad_flags,
                                     mask_pad_rows, pack_fanout,
                                     pack_matches, pack_union_rows,
                                     union_slots)
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
    pre-serialization): after the plan is built, on the same (possibly
    executor) fetch thread, QoS 0 shared wire images and QoS 1/2
    packet-id templates are built per (message, proto_ver, flags
    variant), so the event loop's delivery tail patches two packet-id
    bytes into a copy instead of serializing each frame. False gives
    the on-loop per-delivery serialization, with the same bytes. No
    effect when the planner is off (there is no plan to walk)."""

    planner: bool = True
    preserialize: bool = True


class _PlanState:
    """Per-batch routing state the planned tail shares between its
    prologue and its group deliveries."""

    __slots__ = ("row_local", "row_fast", "ftabs", "counts")


class PendingBatch:
    """An in-flight batched publish (see :meth:`Broker.publish_begin`).

    ``done`` short-circuits: the host regime and an all-vetoed batch
    compute ``results`` inside ``publish_begin``. Fields ending in
    ``_d`` are device tensors; :meth:`Broker.publish_fetch` fills the
    host copies. ``host_only`` marks a batch the breaker sent to the
    host trie (open breaker, or a failed begin or fetch): it is
    matched there whatever ``use_device_now()`` says. A mesh batch keeps
    its dense gathered ``(subs, src)`` and bitmap union for a re-pack,
    the big-filter ids the gather left out (``sh_big``) and the
    match-only overflow (``movf``: the ``boost_k`` signal — a fan-out
    overflow must not grow k)."""

    __slots__ = (
        "done", "results", "live", "inv", "n_uniq", "plan", "plan_state",
        "span", "tbatch",
        "host_topics", "host_matched", "host_inv", "host_only",
        "id_map", "epoch", "st", "ids_dev", "ovf_dev", "pm", "pq",
        "m_ptr_d", "ids_packed_d", "f_ptr_d", "subs_packed_d",
        "src_packed_d", "bovf_d", "sel_d", "rows_packed_d", "bm_total_d",
        "m_ptr", "ids_packed", "ovf", "f_ptr", "subs_packed", "src_packed",
        "bovf", "sel", "rows_packed",
        "subs_dense_d", "src_dense_d", "union_dense_d", "has_big_d",
        "sh_big", "movf_d", "movf",
    )

    def __init__(self) -> None:
        self.done = False
        # telemetry span (telemetry.PublishSpan | None): None is the
        # disabled path — every instrumented section guards on it with
        # one branch and reads no clock
        self.span = None
        # trace batch (tracing._TraceBatch | None): set only when the
        # batch carries sampled messages; the same one-branch rule
        self.tbatch = None
        self.results: List[int] = []
        self.live: List[Tuple[int, Message]] = []
        self.inv: Optional[List[int]] = None
        self.n_uniq = 0
        self.plan = None
        self.plan_state = None
        # a host-regime batch whose routing waits for the finish
        # (publish_begin(defer_host=True)): its topics, then the trie
        # walk's result and inverse index, made on the first chunk
        self.host_topics: Optional[List[str]] = None
        self.host_matched = None
        self.host_inv = None
        self.host_only = False
        self.st = None
        self.ids_dev = self.ovf_dev = None
        self.m_ptr_d = self.ids_packed_d = None
        self.f_ptr_d = self.subs_packed_d = self.src_packed_d = None
        self.bovf_d = self.sel_d = self.rows_packed_d = None
        self.bm_total_d = None
        self.f_ptr = self.subs_packed = self.src_packed = None
        self.bovf = self.sel = self.rows_packed = None
        self.subs_dense_d = self.src_dense_d = None
        self.union_dense_d = self.has_big_d = None
        self.sh_big: frozenset = frozenset()
        self.movf_d = self.movf = None


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
        if self.device.type == "cuda":
            # build (or load) the kernel library at boot: a build
            # failure raises out of the constructor, before any
            # breaker exists, and is never served from the host
            _build.library()
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
        # the node's ingress batcher (ingress.py), set by Node: the
        # channel hands it every PUBLISH, and wills go through it
        self.ingress = None
        # pluggable cross-node forwarder (emqx_rpc seam), set by the
        # cluster: ``forwarder(node, filter, msg)``; None = one node
        self.forwarder = None
        # cluster-wide shared-group router: (group, flt, nodes, msg)
        # -> local delivery count; None = one node (local pick)
        self.shared_router = None
        # overload protection (overload.py), wired by Node: the
        # monitor (the channel and session consult it), the
        # device-path breaker and the alarms. None = no guard runs
        self.overload = None
        self.breaker = None
        self.alarms = None
        # durability layer (durability.py), wired by Node when enabled:
        # route mutations journal an absolute refcount record,
        # durable-session subscriptions journal alongside, and
        # publish_fetch flushes the batched journal from the executor
        # thread. None = one attribute test per site
        self.durability = None
        # observability, wired by Node: the per-topic trace log
        # (tracer.py), the publish-path spans (telemetry.py) and the
        # sampled per-message tracing (tracing.py). None = no seam
        # records anything
        self.tracer = None
        self.telemetry = None
        self.tracing = None

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
                dest = (opts.share, self.node)
                if not resub:
                    self.shared.subscribe(opts.share, flt, sub)
                    self.router.add_route(flt, dest=dest)
            else:
                dest = self.node
                self._subscribers.setdefault(flt, {})[sub] = opts
                if not resub:
                    self.helper.subscribe(flt, sub)
                    self.router.add_route(flt, dest=dest)
            d = self.durability
            if d is not None:
                d.journal_subscribe(sub, topic_filter, flt, dest,
                                    opts, resub)
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
                dest = (share, self.node)
                self.shared.unsubscribe(share, flt, sub)
                self.router.delete_route(flt, dest=dest)
            else:
                dest = self.node
                ftab = self._subscribers.get(flt)
                if ftab is not None:
                    ftab.pop(sub, None)
                    if not ftab:
                        del self._subscribers[flt]
                self.helper.unsubscribe(flt, sub)
                self.router.delete_route(flt, dest=dest)
            if sub not in self._subscriptions:
                self.helper.release(sub)
            d = self.durability
            if d is not None:
                d.journal_unsubscribe(sub, topic_filter, flt, dest)
        return True

    def subscriber_down(self, sub: object) -> None:
        """Drop all of a dead subscriber's subscriptions
        (emqx_broker.erl:331-348); a session's unacked shared-group
        messages go to the surviving members (the reference's
        shared-sub redispatch, emqx_shared_sub.erl:131-227)."""
        with self._route_lock:
            for key in list(self._subscriptions.get(sub, {})):
                self.unsubscribe(sub, key)
            self.shared.subscriber_down(sub)
        pending = getattr(sub, "take_shared_pending", None)  # a Session
        if pending is not None:
            for group, flt, orig, was_sent in pending():
                # never mutate the shared original; DUP is decided per
                # delivery in Session._enrich, after the survivor's QoS
                # downgrade
                msg = orig.copy()
                if was_sent:
                    msg.set_header("redispatch", True)
                nodes = [r.dest[1] for r in self.router.lookup_routes(flt)
                         if isinstance(r.dest, tuple) and r.dest[0] == group]
                if self.shared_router is not None and nodes:
                    # surviving members may live on other nodes
                    n = self.shared_router(group, flt, nodes, msg)
                else:
                    n = self.shared.dispatch(group, flt, msg)
                if n:
                    self.metrics.inc("messages.redispatched")

    def detach_subscriber(self, sub: object) -> None:
        """Remove a subscriber's table entries WITHOUT the death-path
        side effects (no shared redispatch): the session is being
        handed to another node's broker, which resubscribes it."""
        with self._route_lock:
            for key in list(self._subscriptions.get(sub, {})):
                self.unsubscribe(sub, key)
            self.shared.subscriber_down(sub)

    def restore_subscription(self, sub: object, topic_filter: str,
                             opts: Optional[SubOpts] = None) -> None:
        """Crash-recovery resubscribe (durability.py): rebuild the
        subscriber/fan-out/shared tables for a resurrected persistent
        session WITHOUT bumping the router — its route refs were
        already restored from the checkpoint + journal, and a second
        ``add_route`` here would leave a stale route behind on the
        session's eventual unsubscribe. Adds the route only if the
        restored table lacks it (self-healing a journal gap)."""
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
                dest = (opts.share, self.node)
                if not resub:
                    self.shared.subscribe(opts.share, flt, sub)
            else:
                dest = self.node
                self._subscribers.setdefault(flt, {})[sub] = opts
                if not resub:
                    self.helper.subscribe(flt, sub)
            if not self.router.has_dest(flt, dest):
                self.router.add_route(flt, dest=dest)

    def subscribers(self, topic_filter: str) -> List[object]:
        return list(self._subscribers.get(topic_filter, ()))

    def subscriptions(self, sub: object) -> Dict[str, SubOpts]:
        return dict(self._subscriptions.get(sub, {}))

    # -- publish (emqx_broker.erl:200-309) --------------------------------

    def publish(self, msg: Message) -> int:
        """Publish one message; returns its delivery count."""
        return self.publish_batch([msg])[0]

    def publish_will(self, msg: Message) -> None:
        """Will dispatch (channel teardown, delayed-will expiry,
        clean-start fires): through the ingress batcher whenever it is
        taking submissions, so a mass-disconnect wave coalesces its
        wills into the batcher's device batches; nobody awaits a
        will's delivery count. Without a running batcher (sync
        callers, the shutdown tail) it publishes directly."""
        ing = self.ingress
        if ing is not None and ing.submit(msg, want_result=False) \
                is not None:
            self.metrics.inc("wills.batched")
            return
        self.metrics.inc("wills.direct")
        self.publish(msg)

    def publish_batch(self, msgs: Sequence[Message]) -> List[int]:
        """Batch publish: begin (match + fan-out + pack on the device),
        fetch (one copy), finish (host delivery tail)."""
        pb = self.publish_begin(msgs)
        if pb.done:
            return pb.results
        self.publish_fetch(pb)
        return self.publish_finish(pb)

    def publish_begin(self, msgs: Sequence[Message],
                      defer_host: bool = False) -> PendingBatch:
        """Phase 1 — hooks, veto and metrics, then the host regime or
        the device dispatch (no sync).

        ``defer_host`` postpones a host-regime batch's routing to the
        finish (``pb.done`` stays False): the ingress batcher uses it
        while earlier batches are in flight, so a host batch cannot
        deliver ahead of them."""
        pb = PendingBatch()
        tel = self.telemetry
        if tel is not None and tel.enabled:
            pb.span = tel.begin(len(msgs))
        sp = pb.span
        trc = self.tracing
        tracing_on = trc is not None and trc.active
        tctxs = None
        pb.results = [0] * len(msgs)
        for i, msg in enumerate(msgs):
            self.metrics.inc_msg(msg)
            if self.tracer is not None:
                self.tracer.trace_publish(msg)
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
            if tracing_on:
                # idempotent: a context stamped at ingress submit is
                # kept as it is
                ctx = trc.stamp(out)
                if ctx is not None:
                    if tctxs is None:
                        tctxs = []
                    tctxs.append(ctx)
        if not pb.live:
            pb.done = True
            self._span_finish(pb)
            return pb
        if tctxs is not None:
            pb.tbatch = trc.batch_begin(tctxs)
        if sp is not None:
            sp.topic = pb.live[0][1].topic
        topics = [m.topic for _, m in pb.live]
        if not self.router.use_device_now():
            # host regime: let the router shed a stale automaton's id
            # quarantine once it has grown past its bound
            self.router.reclaim_host_regime()
            return self._begin_host(pb, topics, defer_host)
        br = self.breaker
        if br is not None and not br.allow_device() and br.diverts():
            # breaker OPEN: exact host-trie matching until a half-open
            # probe closes it. The automaton is kept — the probe rides
            # it straight back
            self.metrics.inc("breaker.fallback.batches")
            return self._begin_host(pb, topics, defer_host,
                                    host_only=True)
        try:
            return self._begin_device(pb, topics, self.router.config)
        except Exception as e:
            if br is None:
                raise
            # the device dispatch died (a failed launch, an injected
            # fault): record it for the breaker and serve THIS batch
            # exactly from the host trie — on a strict (CUDA) breaker
            # only an injected fault; a real failure raises
            injected = isinstance(e, faults.FaultInjected)
            br.record_failure(injected=injected)
            if br.strict and not injected:
                raise
            log.exception("device publish dispatch failed — host-trie "
                          "fallback for this batch")
            return self._begin_host(pb, topics, defer_host,
                                    host_only=True)

    def _begin_host(self, pb: PendingBatch, topics: List[str],
                    defer_host: bool,
                    host_only: bool = False) -> PendingBatch:
        """The host tail of ``publish_begin``: the host regime, an
        open breaker, or a failed device dispatch (``host_only``)."""
        pb.host_only = host_only
        pb.host_topics = topics
        if pb.span is not None:
            pb.span.path = "host"
        if not defer_host:
            self.publish_host_chunk(pb, 0, len(pb.live))
            pb.done = True
        return pb

    def _bitmap_union(self, pb: PendingBatch, cfg, pr: int) -> None:
        """Big-filter fan-out: matched ids → bitmap rows → the packed
        slots → the OR of just the ``pr`` packed rows (one kernel B2
        launch on CUDA; no dense ``[B, W]`` union)."""
        rows_d, pb.bovf_d = rows_for_matches(
            pb.st.bm, pb.ids_dev, mb=cfg.fanout_mb)
        has_big = (rows_d >= 0).any(dim=1)
        pb.sel_d, src, pb.bm_total_d = union_slots(has_big, pr)
        pb.rows_packed_d = or_union_rows_auto(pb.st.bm.bitmaps, rows_d, src)

    def _begin_device(self, pb: PendingBatch, topics: List[str],
                      cfg) -> PendingBatch:
        """Device match (HOT LOOP 1) → device fan-out (HOT LOOP 2) →
        pack, all queued without a sync. Duplicate topics collapse to
        one device row; the tail expands per message via ``inv``."""
        sp = pb.span
        if faults.enabled:
            faults.fire("device.walk")
            faults.fire("device.lost")
        uniq, pb.inv = dedup_topics(topics)
        pb.n_uniq = len(uniq)
        if sp is not None:
            sp.n_uniq = pb.n_uniq
        if cfg.mesh is not None:
            return self._publish_begin_mesh(pb, uniq, cfg)
        t_m = sp.clock() if sp is not None else 0.0
        pb.ids_dev, pb.ovf_dev, pb.id_map, pb.epoch = \
            self.router.match_dispatch(uniq)
        if sp is not None:
            # closes the match stage; the router's cache-split path
            # (telemetry-gated) left the cache_gather share to split
            sp.stamp_match(self.router, t_m)
            t_p = sp.clock()
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
        if sp is not None:
            sp.bucket = bucket
            sp.add("pack", t_p)
        return pb

    def _publish_begin_mesh(self, pb: PendingBatch, uniq: List[str],
                            cfg) -> PendingBatch:
        """Mesh publish dispatch: ONE collective step does the match,
        the per-shard subscriber gather and the gathers over ``trie``
        (``publish_step(with_fanout=True)`` with the FanoutManager's
        per-shard tables); the dense gathered (subs, src) then pack on
        the device for the one copy. Filters too big for the ``d``
        bound deliver through the bitmap rows (``pb.sh_big``). Repeat
        topics hit the router's mesh match cache."""
        def fan_provider(epoch, id_map):
            return self.helper.sharded_state(
                epoch, id_map, cfg.mesh, self.router.effective_d())

        sp = pb.span
        if sp is not None:
            sp.path = "mesh"
            t_m = sp.clock()
        (pb.ids_dev, subs_d, src_d, bm, pb.ovf_dev, pb.movf_d,
         pb.id_map, pb.epoch, pb.sh_big) = \
            self.router.publish_dispatch_sharded(uniq, fan_provider)
        if sp is not None:
            # the collective step's dispatch (match, gather, the
            # gathers over trie); the cache-split path leaves its
            # gather share as the single-device one does
            sp.stamp_match(self.router, t_m)
            t_p = sp.clock()
        n_uniq = pb.n_uniq
        pb.ids_dev = mask_pad_rows(pb.ids_dev, n_uniq)
        bucket = pb.ids_dev.shape[0]
        budgets = self._pack_budgets.setdefault(
            bucket, [budget_for(bucket, cfg.pack_m),
                     budget_for(bucket, cfg.pack_q),
                     max(1, cfg.pack_rows)])
        pb.pm = budgets[0]
        pb.m_ptr_d, pb.ids_packed_d = pack_matches(pb.ids_dev, pm=pb.pm)
        if subs_d is not None:
            # phantom pad-row deliveries masked like the match ids
            pb.subs_dense_d = mask_pad_rows(subs_d, n_uniq)
            pb.src_dense_d = mask_pad_rows(src_d, n_uniq)
            pb.pq = budgets[1]
            pb.f_ptr_d, pb.subs_packed_d, pb.src_packed_d = \
                pack_fanout(pb.subs_dense_d, pb.src_dense_d, pq=pb.pq)
        if bm is not None:
            # big-filter unions (per-shard OR, then the OR over trie):
            # pack only the rows that matched a big filter
            union_d, has_big_d, pb.bovf_d = bm
            pb.union_dense_d = union_d
            pb.has_big_d = mask_pad_flags(has_big_d, n_uniq)
            pb.sel_d, pb.rows_packed_d, pb.bm_total_d = pack_union_rows(
                union_d, pb.has_big_d, pr=budgets[2])
        if sp is not None:
            sp.bucket = bucket
            sp.add("pack", t_p)
        return pb

    def fetch_parts(self, pb: PendingBatch) -> list:
        """The device tensors one fetch bundles, in bundle order."""
        parts = [pb.m_ptr_d, pb.ids_packed_d, pb.ovf_dev]
        if pb.movf_d is not None:
            parts.append(pb.movf_d)
        if pb.f_ptr_d is not None:
            parts += [pb.f_ptr_d, pb.subs_packed_d, pb.src_packed_d]
        if pb.sel_d is not None:
            parts += [pb.sel_d, pb.rows_packed_d, pb.bm_total_d, pb.bovf_d]
        return parts

    def publish_fetch(self, pb: PendingBatch) -> None:
        """Phase 2 — the one device→host copy (a deferred host batch
        has nothing to fetch).

        The ingress batcher runs it on an executor thread while
        :meth:`publish_begin` runs on the event loop's: both enqueue on
        the device's default stream (neither side enters a stream
        context), so the copy here is ordered after every kernel the
        begin enqueued. A kernel fault surfaces here, at the copy.

        With a breaker attached a failed (or, past ``breaker_slow_ms``,
        stalled) fetch is recorded and a failed one turns into a
        host-only batch: the finish re-matches every live topic on the
        host trie, so nothing is delivered wrong or lost. A strict
        (CUDA) breaker does so only for an injected fault; a real
        failure is recorded and raised.

        With durability on, the batched journal flush runs at the end,
        whatever the batch took: one fsync a batch, on this thread."""
        try:
            if pb.done or pb.host_topics is not None:
                return
            br = self.breaker
            if br is None:
                self._fetch_device(pb)
                return
            t0 = time.perf_counter()
            try:
                self._fetch_device(pb)
            except Exception as e:
                injected = isinstance(e, faults.FaultInjected)
                br.record_failure(injected=injected)
                if br.strict and not injected:
                    raise
                log.exception("device fetch failed — host-trie fallback "
                              "for this batch")
                pb.plan = None
                pb.host_topics = [m.topic for _, m in pb.live]
                pb.host_matched = None
                pb.host_only = True
                return
            br.record_success(time.perf_counter() - t0)
        finally:
            d = self.durability
            if d is not None:
                # the previous batch's dirty session states + any
                # buffered route/retain records hit disk with ONE
                # fsync here, off the event loop
                d.on_batch()

    def _fetch_device(self, pb: PendingBatch) -> None:
        """The fetch body: on a packed-budget overflow, re-pack with
        the next power-of-two bucket (the dense arrays are still on the
        device) and remember the grown budget for the bucket."""
        if faults.enabled:
            faults.fire("device.fetch")
            faults.fire("device.lost")
        sp = pb.span
        if sp is not None:
            # the synchronizing stage: device work queued by the begin
            # surfaces as copy wait here (no sync added — the copy
            # already waits)
            t_f = sp.clock()
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
            movf = take(Bp).astype(bool) if pb.movf_d is not None \
                else None
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
            mesh_fan = pb.subs_dense_d is not None
            if f_ptr is not None and ((m_repacked and not mesh_fan)
                                      or int(f_ptr[-1]) > pb.pq):
                # a truncated match pack also truncates the expansion
                # (one device only: the mesh packs its fan-out from the
                # dense gathered arrays, apart from the match pack)
                while pb.pq < int(f_ptr[-1]):
                    pb.pq *= 2
                if budgets is not None:
                    budgets[1] = max(budgets[1], pb.pq)
                if mesh_fan:
                    pb.f_ptr_d, pb.subs_packed_d, pb.src_packed_d = \
                        pack_fanout(pb.subs_dense_d, pb.src_dense_d,
                                    pq=pb.pq)
                else:
                    pb.f_ptr_d, pb.subs_packed_d, pb.src_packed_d, _t = \
                        expand_packed(pb.st.fan, pb.m_ptr_d,
                                      pb.ids_packed_d, q=pb.pq)
                retry = True
            if bm_total is not None and bm_total > pb.rows_packed_d.shape[0]:
                pr = pb.rows_packed_d.shape[0]
                while pr < bm_total:
                    pr *= 2
                if budgets is not None:
                    budgets[2] = max(budgets[2], pr)
                if pb.union_dense_d is not None:
                    # mesh: the collective union is still on the device
                    pb.sel_d, pb.rows_packed_d, pb.bm_total_d = \
                        pack_union_rows(pb.union_dense_d, pb.has_big_d,
                                        pr=pr)
                else:
                    self._bitmap_union(pb, cfg, pr)
                retry = True
            if retry:
                continue
            # adaptive capacity: > 1/8 of the unique topics overflowed
            # the match bound → k undersizes the workload; grow it for
            # the NEXT batch (this one has its exact host re-match). On
            # the mesh the combined ovf includes the fan-out d bound,
            # which k cannot fix: only the match-only flag boosts k
            n_u = max(1, pb.n_uniq)
            k_ovf = movf if movf is not None else ovf
            n_fb = int(ovf[:n_u].sum())
            if n_fb:
                self.router.note_match_fallbacks(n_fb)
            if int(k_ovf[:n_u].sum()) * 8 > n_u:
                self.router.boost_k()
            if movf is not None:
                # fan-ONLY overflow (mesh): d undersizes the live
                # fan-out — grow d, not k
                f_ovf = ovf[:n_u] & ~movf[:n_u]
                if int(f_ovf.sum()) * 8 > n_u:
                    self.router.boost_d()
            pb.movf = movf
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
            if sp is not None:
                sp.fallbacks = n_fb
                sp.add("fetch", t_f)
            tb = pb.tbatch
            if tb is not None:
                # device regime: walk, fan-out and the copy, timed from
                # the batch's begin (the dispatch was asynchronous)
                self.tracing.mark_match(tb, tb.t0p)
            if self.dispatch_config.planner:
                t_pl = sp.clock() if sp is not None else 0.0
                pb.plan = self._build_plan(pb, subs_occ, src_occ)
                if sp is not None:
                    sp.add("dispatch_plan", t_pl)
                if pb.plan is not None \
                        and self.dispatch_config.preserialize:
                    # prime the messages' shared wire images and pid
                    # templates here — off the event loop when fetch
                    # runs on the ingress executor
                    if sp is not None:
                        t_s = sp.clock()
                    else:
                        t_s = time.perf_counter() \
                            if tb is not None else 0.0
                    preserialize_plan(pb.plan, pb.live, pb.id_map,
                                      self._subscribers,
                                      self.helper.registry.lookup)
                    if sp is not None:
                        sp.add("serialize", t_s)
                    if tb is not None:
                        self.tracing.span_mark(tb, "serialize", t_s)
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
        big_set = pb.st.big_fids if pb.st is not None else pb.sh_big
        big_map: Dict[int, list] = {}
        if pb.sel is not None and big_set:
            id_map = pb.id_map
            big_map = big_rows_for(
                pb.ids_packed, pb.m_ptr, pb.sel, pb.rows_packed,
                sorted(set(pb.inv)), big_set,
                lambda fid: self.helper.members_sorted(id_map[fid]))
        return build_plan(pb.inv, n_u, pb.ovf, pb.bovf, pb.f_ptr,
                          subs_packed, src_packed, big_map)

    def warm_device_path(self) -> int:
        """Device-loss recovery, step 3 (devloss.py): run the real
        dispatch → fetch chain once per observed batch shape on the
        recovery thread, so the first live batch after recovery does
        not pay the cold start (the match cache's, and the fan-out
        tables' rebuild at the new epoch). Drives
        :meth:`_begin_device`/:meth:`_fetch_device` over NUL-rooted
        topics (``ops/warmup.py``) that no filter matches — nothing
        delivers, no hook or message metric fires. Returns the number
        of warm batches."""
        from emqx_tpu_torch.ops.warmup import warm_plan

        cfg = self.router.config
        warmed = 0
        for _bucket, topics in warm_plan(
                list(self._pack_budgets), cfg.min_batch,
                levels=self.router.observed_levels()):
            pb = PendingBatch()
            pb.results = [0] * len(topics)
            pb.live = [(i, Message(topic=t, payload=b""))
                       for i, t in enumerate(topics)]
            self._begin_device(pb, topics, cfg)
            self._fetch_device(pb)
            warmed += 1
        return warmed

    def publish_finish(self, pb: PendingBatch) -> List[int]:
        """Phase 3 — the host delivery tail over the packed results,
        in one piece."""
        if pb.done:
            return pb.results
        if pb.host_topics is not None:
            self.publish_host_chunk(pb, 0, len(pb.live))
        elif pb.plan is not None:
            self.publish_finish_planned(pb, 0, pb.plan.n_groups)
        else:
            self.publish_finish_chunk(pb, 0, len(pb.live))
        pb.done = True
        return pb.results

    # -- the planned tail ---------------------------------------------------

    def _plan_prologue(self, pb: PendingBatch) -> _PlanState:
        """Classify every matched filter id once (local / shared /
        remote), then walk the live rows doing the per-message work the
        plan cannot carry: no-subscriber drops, shared-group picks and
        remote forwards (one ``forwarder(node, filter, msg)`` per remote
        (node, filter)). Local delivery is the plan's."""
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
                        info = (None, False, (), ())
                    else:
                        loc = False
                        sh: Dict[str, List[str]] = {}
                        rem: Dict[object, bool] = {}
                        for route in self.router.lookup_routes(flt):
                            dest = route.dest
                            if isinstance(dest, tuple):
                                sh.setdefault(dest[0], []).append(dest[1])
                            elif dest == self.node:
                                loc = True
                            else:
                                rem[dest] = True
                        ps.ftabs[j] = self._subscribers.get(flt)
                        info = (flt, loc, tuple(sh.items()), tuple(rem))
                    route_of[j] = info
                flt, loc, sh_items, rem_nodes = info
                if flt is None:
                    continue
                seen_filter = True
                local = local or loc
                for group, nodes in sh_items:
                    if self.shared_router is not None:
                        # cluster: ONE delivery per group, all nodes
                        n += self.shared_router(group, flt, nodes, msg)
                    elif self.node in nodes:
                        n += self.shared.dispatch(group, flt, msg)
                for nd in rem_nodes:
                    if self.forwarder is not None:
                        self.forwarder(nd, flt, msg)
                        self.metrics.inc("messages.forward")
            if not seen_filter:
                self._drop_no_subs(msg)
                continue
            pb.results[i] = n
            if local:
                ps.row_local[r] = 1
            if msg.qos == 0 and not msg.flags.get("retain"):
                ps.row_fast[r] = 1
        return ps

    def publish_finish_planned(self, pb: PendingBatch, gstart: int,
                               gstop: int) -> None:
        """Deliver subscriber groups ``[gstart, gstop)`` of a planned
        batch; every session still gets its whole batch in one
        ``deliver_many``. The first chunk runs the routing prologue;
        the chunk that reaches the last group folds the per-(message,
        filter) counts into metrics, hooks and results, and closes the
        batch's span."""
        sp = pb.span
        if sp is not None:
            t_d = sp.clock()
        if gstart == 0:
            pb.plan_state = self._plan_prologue(pb)
        ps = pb.plan_state
        counts = ps.counts
        n_groups = pb.plan.n_groups
        for g in range(gstart, min(gstop, n_groups)):
            for r, flt in self._deliver_plan_group(pb, ps, g):
                d = counts[r]
                if d is None:
                    d = counts[r] = {}
                d[flt] = d.get(flt, 0) + 1
        folded = gstop >= n_groups
        if folded:
            self._plan_fold(pb, ps)
        if sp is not None:
            sp.add("dispatch", t_d)
        if folded:
            self._span_finish(pb)

    def _span_finish(self, pb: PendingBatch) -> None:
        """Close a batch's telemetry span and trace batch, once (a
        no-op when both are off, or already closed)."""
        if pb.span is not None:
            self.telemetry.finish(pb.span)
            pb.span = None
        if pb.tbatch is not None:
            self.tracing.close_batch(pb.tbatch)
            pb.tbatch = None

    def _plan_fold(self, pb: PendingBatch, ps: _PlanState) -> None:
        counts = ps.counts
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
            if "_wire" not in msg.headers:
                # the shared wire-image cache, as _deliver_one primes
                msg.headers["_wire"] = {}
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

    def publish_host_chunk(self, pb: PendingBatch, start: int,
                           stop: int) -> None:
        """Route rows ``[start, stop)`` of a host-regime batch. The
        one trie walk over the batch's unique topics runs on the first
        chunk and is kept on the batch. It is always the host trie's
        (``match_filters_host``), so a ``host_only`` batch never
        re-enters the device. The last chunk closes the batch's span."""
        sp = pb.span
        tb = pb.tbatch
        if pb.host_matched is None:
            if sp is not None:
                t_m = sp.clock()
            elif tb is not None:
                t_m = time.perf_counter()
            uniq, pb.host_inv = dedup_topics(pb.host_topics)
            pb.n_uniq = len(uniq)
            pb.host_matched = self.router.match_filters_host(uniq)
            if sp is not None:
                sp.n_uniq = pb.n_uniq
                sp.add("match", t_m)  # host regime: the actual trie walk
            if tb is not None:
                self.tracing.mark_match(tb, t_m)
        if sp is not None:
            t_d = sp.clock()
        for row in range(start, stop):
            i, msg = pb.live[row]
            filters = pb.host_matched[pb.host_inv[row]]
            if not filters:
                self._drop_no_subs(msg)
                continue
            pb.results[i] = self._route(filters, msg)
        if sp is not None:
            sp.add("dispatch", t_d)
        if stop >= len(pb.live):
            self._span_finish(pb)

    def publish_finish_chunk(self, pb: PendingBatch, start: int,
                             stop: int) -> None:
        """Deliver rows ``[start, stop)`` of a fetched batch without a
        plan; a row whose match overflowed is re-matched exactly on
        the host trie (parity, no truncation). The last chunk closes the
        batch's span."""
        m_ptr = pb.m_ptr
        sp = pb.span
        if sp is not None:
            t_d = sp.clock()
        for row in range(start, stop):
            i, msg = pb.live[row]
            urow = pb.inv[row]  # packed results are per UNIQUE topic
            if pb.ovf[urow]:
                t_fb = sp.clock() if sp is not None else 0.0
                filters = self.router.host_match(msg.topic)
                if not filters:
                    self._drop_no_subs(msg)
                else:
                    pb.results[i] = self._route(filters, msg)
                if sp is not None:
                    # a subset of dispatch time, split out so the
                    # host re-match's cost is attributable on its own
                    sp.add("host_fallback", t_fb)
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
        if sp is not None:
            sp.add("dispatch", t_d)
        if stop >= len(pb.live):
            self._span_finish(pb)

    def _drop_no_subs(self, msg: Message) -> None:
        self.metrics.inc("messages.dropped")
        self.metrics.inc("messages.dropped.no_subscribers")
        self.hooks.run("message.dropped", (msg, "no_subscribers"))

    def _route(self, filters: List[str], msg: Message,
               local_deliver=None) -> int:
        """Fan a matched message out to local subscribers, shared
        groups and remote nodes (route/2 + aggre/1 + forward/4).
        ``local_deliver(local_filters) -> int`` overrides the local
        step (the device fan-out tail plugs in here). Shared and remote
        destinations resolve on the host: they are per-group and
        per-node picks, not per-subscriber."""
        n = 0
        remote: set = set()  # (node, filter) — aggre/1 dedup
        shared: Dict[Tuple[str, str], List[str]] = {}  # (group,flt)->nodes
        local: List[str] = []
        for flt in filters:
            for route in self.router.lookup_routes(flt):
                dest = route.dest
                if isinstance(dest, tuple):  # (group, node) shared route
                    shared.setdefault((dest[0], flt), []).append(dest[1])
                elif dest == self.node:
                    local.append(flt)
                else:
                    remote.add((dest, flt))
        if local:
            if local_deliver is not None:
                n += local_deliver(local)
            else:
                for flt in local:
                    n += self.dispatch(flt, msg)
        for (group, flt), nodes in shared.items():
            if self.shared_router is not None:
                # cluster: ONE delivery per group across all nodes
                n += self.shared_router(group, flt, nodes, msg)
            elif self.node in nodes:
                n += self.shared.dispatch(group, flt, msg)
        for node, flt in remote:
            if self.forwarder is not None:
                # the remote node dispatches by the matched filter — no
                # re-match there (emqx_broker:forward/4 :266-281)
                self.forwarder(node, flt, msg)
                self.metrics.inc("messages.forward")
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
            big_set = pb.st.big_fids if pb.st is not None else pb.sh_big
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
        separately. On the mesh the union rows come from the per-shard
        OR and the OR over ``trie``, and the big set is ``pb.sh_big``."""
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
        if "_wire" not in msg.headers:
            # shared wire-image cache: Session._enrich either returns
            # this very object (fast path) or copies headers SHALLOWLY,
            # so delivering sessions share this inner dict and reuse
            # one serialized QoS 0 frame (Channel.handle_deliver)
            # instead of serializing per subscriber. Message.copy()
            # copies nested dicts: a copy gets a private cache
            msg.headers["_wire"] = {}
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
