"""Per-client session state machine: subscriptions, QoS flows,
delivery window, message queue.

The port of the JAX package's ``Session`` (``src/emqx_session.erl``,
#session record :96-124). Covers:

  - subscribe/unsubscribe with max_subscriptions quota (:238-276)
  - inbound publish with QoS2 awaiting_rel two-phase flow (:281-301)
  - outbound delivery: subopts enrichment (qos min/upgrade, nl, rap,
    subid :505-530), packet-id assignment, inflight window with
    mqueue overflow (:419-457); ``deliver_many`` is the dispatch
    planner's grouped enqueue
  - puback/pubrec/pubrel/pubcomp (:314-376) with dequeue-on-ack
  - retry with dup flag + delivery expiry (:543-577)
  - awaiting_rel expiry (:582-599)
  - takeover/resume/replay (:606-629)
  - ``to_wire``/``from_wire``: the pure-data snapshot the durability
    journal and checkpoints carry (``emqx_tpu_torch.wire``), and the
    ``_mark_dirty`` seam that tells the journal a session's window
    changed

A Session is also a broker subscriber: ``deliver(filter, msg)``
enriches + windows the message and appends ready-to-send publishes to
``outbox`` for the channel/connection to drain.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from emqx_tpu_torch import topic as T
from emqx_tpu_torch.concurrency import owner_loop
from emqx_tpu_torch.inflight import Inflight
from emqx_tpu_torch.mqueue import MQueue
from emqx_tpu_torch.types import QOS_0, QOS_2, Message, SubOpts

# reason codes used at the session boundary (mqtt/reason_codes has
# the full table)
RC_SUCCESS = 0x00
RC_NO_SUBSCRIPTION_EXISTED = 0x11
RC_PACKET_IDENTIFIER_IN_USE = 0x91
RC_PACKET_IDENTIFIER_NOT_FOUND = 0x92
RC_RECEIVE_MAXIMUM_EXCEEDED = 0x93
RC_QUOTA_EXCEEDED = 0x97

PUBREL_MARKER = "pubrel"


class SessionError(Exception):
    def __init__(self, rc: int):
        super().__init__(hex(rc))
        self.rc = rc


class Session:
    def __init__(
        self,
        client_id: str,
        broker=None,
        clean_start: bool = True,
        max_subscriptions: int = 0,
        max_inflight: int = 32,
        max_mqueue_len: int = 1000,
        mqueue_store_qos0: bool = False,
        mqueue_priorities: Optional[Dict[str, int]] = None,
        mqueue_default_priority: float = 0,
        upgrade_qos: bool = False,
        retry_interval: float = 30.0,
        max_awaiting_rel: int = 100,
        await_rel_timeout: float = 300.0,
        expiry_interval: float = 0.0,
    ) -> None:
        self.client_id = client_id
        self.broker = broker
        self.clean_start = clean_start
        self.created_at = time.time()
        self.subscriptions: Dict[str, SubOpts] = {}
        # reverse share-suffix map: bare filter -> the full
        # "$share/<g>/…" / "$queue/…" subscription key, so shared
        # deliveries resolve their subopts in one dict fetch instead
        # of a linear scan over every subscription (_enrich). First
        # subscription wins on a bare-filter collision, matching the
        # old scan's insertion-order pick.
        self._share_keys: Dict[str, str] = {}
        self.max_subscriptions = max_subscriptions
        self.upgrade_qos = upgrade_qos
        self.inflight = Inflight(max_inflight)
        self.mqueue = MQueue(max_mqueue_len, mqueue_store_qos0,
                             mqueue_priorities, mqueue_default_priority)
        self.next_pkt_id = 1
        self.retry_interval = retry_interval
        self.awaiting_rel: Dict[int, float] = {}
        self.max_awaiting_rel = max_awaiting_rel
        self.await_rel_timeout = await_rel_timeout
        self.expiry_interval = expiry_interval
        # (packet_id | None, Message) or (PUBREL_MARKER, packet_id)
        self.outbox: List[Tuple[Any, Any]] = []
        # wakeup hook: the owning connection sets this so broker-driven
        # deliveries flush to the socket (the BEAM's message-send wakeup
        # has no implicit analogue in asyncio)
        self.notify = None
        # False while the owner is disconnected (persistent session):
        # deliveries then enqueue instead of entering the send window
        # (the reference channel's `disconnected` state)
        self.connected = True
        # egress pre-serialization hints, stamped by the owning
        # channel at CONNECT (ops/dispatch_plan.preserialize_plan
        # reads them off-loop): the negotiated protocol version, and
        # whether the transport can take shared wire bytes at all
        # (wire_fast, no mountpoint, no outbound topic aliasing).
        # None/False = never pre-build for this subscriber
        self.proto_ver: Optional[int] = None
        self.wire_fast_hint = False
        # the event loop that owns this session's connection (a
        # multi-loop node): stamped by the channel at CONNECT, cleared
        # on detach. The delivery ring routes this session's planned
        # subscriber group to that loop, so its inflight window, mqueue
        # and outbox are only touched there. None = the main loop
        self.owner_loop = None
        # durability: True once the channel opened this session with a
        # session-expiry > 0 — its lifecycle, subscriptions and QoS1/2
        # window then journal through `_dur` (the node's
        # DurabilityManager). Both stay None/False on a non-durable
        # node: every `_mark_dirty` below is one attribute test
        self.durable = False
        self._dur = None
        # a snapshot (to_wire) holds the outbox's packets: once they
        # drain to the transport, that snapshot is stale and the
        # session needs a fresh one, or a recovery from it would send
        # them again beside the inflight window's DUP redelivery
        self._outbox_snapshot = False

    # -- info --------------------------------------------------------------

    def info(self) -> dict:
        return {
            "clientid": self.client_id,
            "clean_start": self.clean_start,
            "subscriptions_cnt": len(self.subscriptions),
            "inflight_cnt": len(self.inflight),
            "mqueue_len": len(self.mqueue),
            "mqueue_dropped": self.mqueue.dropped,
            "awaiting_rel_cnt": len(self.awaiting_rel),
            "next_pkt_id": self.next_pkt_id,
            "created_at": self.created_at,
        }

    # -- wire transfer (durability journal and checkpoints) ---------------

    def to_wire(self) -> dict:
        """Pure-data snapshot for the wire codec — every value is a
        scalar, container, Message or SubOpts; no live references
        (broker/notify are connection-local). A non-empty outbox
        marks the snapshot stale at the next :meth:`drain_outbox`: the
        flag is set before the outbox is read, so a drain racing this
        call from the owning loop re-dirties the session."""
        if self.outbox:
            self._outbox_snapshot = True
        return {
            "client_id": self.client_id,
            "clean_start": self.clean_start,
            "created_at": self.created_at,
            "subscriptions": dict(self.subscriptions),
            "max_subscriptions": self.max_subscriptions,
            "upgrade_qos": self.upgrade_qos,
            "max_inflight": self.inflight.max_size,
            "inflight": self.inflight.to_list(),
            "next_pkt_id": self.next_pkt_id,
            "retry_interval": self.retry_interval,
            "awaiting_rel": dict(self.awaiting_rel),
            "max_awaiting_rel": self.max_awaiting_rel,
            "await_rel_timeout": self.await_rel_timeout,
            "expiry_interval": self.expiry_interval,
            "outbox": list(self.outbox),
            "mq_max_len": self.mqueue.max_len,
            "mq_store_qos0": self.mqueue.store_qos0,
            "mq_priorities": self.mqueue.p_table,
            "mq_default_p": self.mqueue.default_p,
            "mq_dropped": self.mqueue.dropped,
            # per-priority FIFO order preserved
            "mq_items": self.mqueue.snapshot(),
        }

    @classmethod
    def from_wire(cls, d: dict) -> "Session":
        """Rebuild a session from :meth:`to_wire` data. The result is
        detached (no broker, not connected) — ``resume()`` attaches
        it."""
        s = cls(
            client_id=d["client_id"],
            clean_start=bool(d["clean_start"]),
            max_subscriptions=int(d["max_subscriptions"]),
            max_inflight=int(d["max_inflight"]),
            max_mqueue_len=int(d["mq_max_len"]),
            mqueue_store_qos0=bool(d["mq_store_qos0"]),
            mqueue_priorities=d["mq_priorities"],
            mqueue_default_priority=d["mq_default_p"],
            upgrade_qos=bool(d["upgrade_qos"]),
            retry_interval=d["retry_interval"],
            max_awaiting_rel=int(d["max_awaiting_rel"]),
            await_rel_timeout=d["await_rel_timeout"],
            expiry_interval=d["expiry_interval"],
        )
        s.created_at = d["created_at"]
        s.subscriptions = dict(d["subscriptions"])
        s._rebuild_share_keys()
        s.inflight.restore(d["inflight"])
        s.next_pkt_id = int(d["next_pkt_id"])
        s.awaiting_rel = dict(d["awaiting_rel"])
        s.outbox = list(d["outbox"])
        s._outbox_snapshot = bool(s.outbox)  # the snapshot holds them
        s.mqueue.dropped = int(d["mq_dropped"])
        s.mqueue.restore(d["mq_items"])
        s.connected = False
        return s

    def carry_queued(self, other: "Session") -> int:
        """Queue, after this session's own, each message of
        ``other``'s queue that this session holds nowhere (by message
        id): a hand-off's snapshot applied over the target's copy from
        an earlier chunk of the same hand-off keeps what live forwards
        queued there after the sender quiesced (fault C.9). Returns
        how many it queued."""
        held = {m.id for _pid, (m, _ts) in self.inflight.to_list()
                if isinstance(m, Message)}
        held.update(m.id for _p, msgs in self.mqueue.snapshot()
                    for m in msgs)
        held.update(m.id for pid, m in self.outbox
                    if pid != PUBREL_MARKER)
        n = 0
        for _p, msgs in other.mqueue.snapshot():
            for m in msgs:
                if m.id not in held:
                    held.add(m.id)
                    self.mqueue.push(m)
                    n += 1
        return n

    # -- SUBSCRIBE / UNSUBSCRIBE ------------------------------------------

    def subscribe(self, topic_filter: str,
                  opts: Optional[SubOpts] = None) -> None:
        is_new = topic_filter not in self.subscriptions
        if (is_new and self.max_subscriptions
                and len(self.subscriptions) >= self.max_subscriptions):
            raise SessionError(RC_QUOTA_EXCEEDED)
        opts = opts or SubOpts()
        if self.broker is not None:
            self.broker.subscribe(self, topic_filter, opts)
        self.subscriptions[topic_filter] = opts
        if opts.share is not None or topic_filter.startswith(
                ("$share/", "$queue/")):
            bare, _ = T.parse(topic_filter)
            self._share_keys.setdefault(bare, topic_filter)

    def unsubscribe(self, topic_filter: str) -> SubOpts:
        if topic_filter not in self.subscriptions:
            raise SessionError(RC_NO_SUBSCRIPTION_EXISTED)
        if self.broker is not None:
            self.broker.unsubscribe(self, topic_filter)
        opts = self.subscriptions.pop(topic_filter)
        if self._share_keys:
            bare, _ = T.parse(topic_filter)
            if self._share_keys.get(bare) == topic_filter:
                # another group may still cover the bare filter
                self._rebuild_share_keys()
        return opts

    def _rebuild_share_keys(self) -> None:
        keys: Dict[str, str] = {}
        for key, o in self.subscriptions.items():
            if o.share is not None or key.startswith(
                    ("$share/", "$queue/")):
                bare, _ = T.parse(key)
                keys.setdefault(bare, key)
        self._share_keys = keys

    # -- inbound PUBLISH (client -> broker) -------------------------------

    @owner_loop
    def publish(self, packet_id: Optional[int], msg: Message) -> int:
        """Returns the delivery count from the broker."""
        if msg.qos == QOS_2:
            self.check_awaiting_rel(packet_id)
            n = self.broker.publish(msg) if self.broker else 0
            self.record_awaiting_rel(packet_id)
            return n
        return self.broker.publish(msg) if self.broker else 0

    def check_awaiting_rel(self, packet_id: Optional[int]) -> None:
        """QoS2 receive-window checks, split from :meth:`publish` so
        the batched ingress path can validate synchronously while the
        broker call itself is deferred to the batch flush."""
        if (self.max_awaiting_rel
                and len(self.awaiting_rel) >= self.max_awaiting_rel):
            raise SessionError(RC_RECEIVE_MAXIMUM_EXCEEDED)
        if packet_id in self.awaiting_rel:
            raise SessionError(RC_PACKET_IDENTIFIER_IN_USE)

    def record_awaiting_rel(self, packet_id: Optional[int]) -> None:
        self.awaiting_rel[packet_id] = time.time()
        self._mark_dirty()

    @owner_loop
    def pubrel(self, packet_id: int) -> None:
        if packet_id not in self.awaiting_rel:
            raise SessionError(RC_PACKET_IDENTIFIER_NOT_FOUND)
        del self.awaiting_rel[packet_id]
        self._mark_dirty()

    # -- outbound acks (client acks our deliveries) -----------------------

    @owner_loop
    def puback(self, packet_id: int) -> Message:
        val = self.inflight.lookup(packet_id)
        if val is None:
            raise SessionError(RC_PACKET_IDENTIFIER_NOT_FOUND)
        msg, _ts = val
        if msg == PUBREL_MARKER:
            raise SessionError(RC_PACKET_IDENTIFIER_IN_USE)
        self.inflight.delete(packet_id)
        self.dequeue()
        self._mark_dirty()
        return msg

    def discard_delivery(self, packet_id: int) -> None:
        """Release an inflight slot for a PUBLISH the transport could
        not legally send (client Maximum-Packet-Size, MQTT-3.1.2-24:
        the message is 'discarded but treated as acknowledged') —
        without this the slot leaks and the retry timer re-drops the
        same message forever."""
        if self.inflight.lookup(packet_id) is not None:
            self.inflight.delete(packet_id)
            self.dequeue()
            self._mark_dirty()

    @owner_loop
    def pubrec(self, packet_id: int) -> Message:
        val = self.inflight.lookup(packet_id)
        if val is None:
            raise SessionError(RC_PACKET_IDENTIFIER_NOT_FOUND)
        msg, _ts = val
        if msg == PUBREL_MARKER:
            raise SessionError(RC_PACKET_IDENTIFIER_IN_USE)
        self.inflight.update(packet_id, (PUBREL_MARKER, time.time()))
        self._mark_dirty()
        return msg

    @owner_loop
    def pubcomp(self, packet_id: int) -> None:
        val = self.inflight.lookup(packet_id)
        if val is None:
            raise SessionError(RC_PACKET_IDENTIFIER_NOT_FOUND)
        if val[0] != PUBREL_MARKER:
            raise SessionError(RC_PACKET_IDENTIFIER_IN_USE)
        self.inflight.delete(packet_id)
        self.dequeue()
        self._mark_dirty()

    # -- outbound delivery (broker -> client) -----------------------------

    def _mark_dirty(self) -> None:
        """QoS1/2 window / mqueue / awaiting-rel state changed: tell
        the durability layer this session needs a journal snapshot at
        the next batched flush (ONE state record per flush however
        many transitions happened, so the hot path pays an attribute
        test here and serialization off the loop)."""
        d = self._dur
        if d is not None:
            d.mark_dirty(self)

    def deliver(self, topic_filter: str, msg: Message) -> None:
        """Broker subscriber protocol: enrich, window, queue."""
        m = self._enrich(topic_filter, msg)
        if not self.connected:
            self.enqueue(m)
            self._mark_dirty()
            return
        self._deliver_msg(m)
        if m.qos != QOS_0:
            # QoS0 to a live connection is transient by contract
            # (recovery may lose it) — only window/queue state
            # journals
            self._mark_dirty()
        if self.outbox and self.notify is not None:
            self.notify()

    @owner_loop
    def deliver_many(self, items: Iterable[tuple]) -> None:
        """Batched broker→client delivery — the dispatch planner's
        grouped enqueue. Each item is
        ``(topic_filter, msg, opts, fast)``: the broker already
        resolved this session's subopts from its own table (the same
        SubOpts object ``subscriptions`` holds, so the per-delivery
        dict fetch is hoisted out), and ``fast`` pre-classifies the
        QoS0/plain-subopts broadcast fast path per (row, filter)
        group. Everything enqueues, then ONE notify fires for the
        whole group — the batch-wide wakeup coalescing that turns
        N-deliveries-per-batch into one flush per connection."""
        now = None  # one inflight timestamp per delivery group
        dirty = False
        for flt, msg, opts, fast in items:
            if fast and self.connected:
                # the _enrich fast path, pre-decided: nothing to
                # rewrite, every session shares the same object
                self.outbox.append((None, msg))
                continue
            m = msg if fast else self._enrich(flt, msg, opts)
            if not self.connected:
                self.enqueue(m)
                dirty = True
            else:
                if now is None:
                    now = time.time()
                self._deliver_msg(m, now)
                dirty = dirty or m.qos != QOS_0
        if dirty:
            # one mark per delivery group, not per message — the
            # durability flush then writes ONE state record per batch
            self._mark_dirty()
        if self.outbox and self.notify is not None:
            self.notify()

    def _enrich(self, topic_filter: str, msg: Message,
                opts: Optional[SubOpts] = None) -> Message:
        if opts is None:
            opts = self.subscriptions.get(topic_filter)
        if (opts is not None and msg.qos == 0
                and not msg.flags.get("retain")
                and opts.share is None and not opts.nl
                and opts.subid is None
                and (opts.qos == 0 or not self.upgrade_qos)):
            # broadcast fast path: a QoS0, non-retained delivery with
            # plain subopts has NOTHING to rewrite — every session
            # shares the SAME message object; downstream treats it as
            # immutable
            return msg
        # look up the shared form too: the session keys by full
        # filter string; the reverse share-suffix map (maintained on
        # subscribe/unsubscribe) replaces the old linear scan over
        # every subscription
        if opts is None:
            key = self._share_keys.get(topic_filter)
            if key is not None:
                opts = self.subscriptions.get(key)
        m = Message(
            topic=msg.topic, payload=msg.payload, qos=msg.qos,
            from_=msg.from_, flags=dict(msg.flags),
            headers=dict(msg.headers), id=msg.id, timestamp=msg.timestamp)
        if opts is None:
            return m
        if self.upgrade_qos:
            m.qos = max(opts.qos, m.qos)
        else:
            m.qos = min(opts.qos, m.qos)
        if opts.nl:
            m.set_flag("nl")
        if not opts.rap and not m.get_header("retained", False):
            m.set_flag("retain", False)
        if opts.subid is not None:
            props = dict(m.get_header("properties") or {})
            props["Subscription-Identifier"] = opts.subid
            m.set_header("properties", props)
        if opts.share:
            # mark for group redispatch if this session dies before
            # acking (emqx_shared_sub redispatch protocol). The
            # *pre-enrichment* message rides along: redispatch must
            # hand the survivor the original, not this copy with our
            # subid/downgraded qos baked in
            m.set_header("shared", (opts.share, topic_filter, msg))
            if m.get_header("redispatch") and m.qos > 0:
                # retransmission of a possibly-seen message — DUP only
                # at QoS>0 after OUR downgrade (MQTT-3.3.1-2)
                m.set_flag("dup", True)
        return m

    def _deliver_msg(self, msg: Message,
                     now: Optional[float] = None) -> None:
        if msg.qos == QOS_0:
            self.outbox.append((None, msg))
            return
        if self.inflight.is_full():
            self.enqueue(msg)
            return
        pid = self._next_pkt_id()
        self.inflight.insert(
            pid, (msg, time.time() if now is None else now))
        self.outbox.append((pid, msg))

    @owner_loop
    def enqueue(self, msg: Message) -> None:
        if msg.qos == QOS_0 and self.broker is not None:
            ov = getattr(self.broker, "overload", None)
            if ov is not None and ov.shed_qos0(len(self.mqueue),
                                               self.mqueue.max_len):
                # overload shedding (warn+): QoS0 has no redelivery
                # contract — drop it at mqueue pressure so the
                # remaining queue capacity serves QoS>0
                self.broker.metrics.inc("delivery.dropped")
                self.broker.metrics.inc("overload.shed.qos0")
                return
        dropped = self.mqueue.push(msg)
        if dropped is not None and self.broker is not None:
            self.broker.metrics.inc("delivery.dropped")
            if msg.qos == QOS_0 and not self.mqueue.store_qos0:
                self.broker.metrics.inc("delivery.dropped.qos0_msg")
            else:
                self.broker.metrics.inc("delivery.dropped.queue_full")

    @owner_loop
    def dequeue(self) -> None:
        """Move queued messages into the freed inflight window
        (emqx_session:dequeue/1 :389-409)."""
        while not self.mqueue.is_empty() and not self.inflight.is_full():
            msg = self.mqueue.pop()
            if msg is None:
                break
            if msg.is_expired():
                if self.broker is not None:
                    self.broker.metrics.inc("delivery.dropped")
                    self.broker.metrics.inc("delivery.dropped.expired")
                continue
            self._deliver_msg(msg)

    def _next_pkt_id(self) -> int:
        # skip ids still awaited (wrap-around safety; reference wraps
        # at 0xFFFF and relies on window < 65535)
        for _ in range(0x10000):
            pid = self.next_pkt_id
            self.next_pkt_id = 1 if pid == 0xFFFF else pid + 1
            if pid not in self.inflight:
                return pid
        raise SessionError(RC_QUOTA_EXCEEDED)

    # -- timers -----------------------------------------------------------

    @owner_loop
    def retry(self, now: Optional[float] = None) -> float:
        """Re-send timed-out inflight entries (dup=true) / pubrels.
        Returns the next retry delay in seconds."""
        now = time.time() if now is None else now
        if self.inflight.is_empty():
            return self.retry_interval
        items = self.inflight.to_list(sort_key=lambda kv: kv[1][1])
        next_delay = self.retry_interval
        for pid, (msg, ts) in items:
            age = now - ts
            if age < self.retry_interval:
                next_delay = self.retry_interval - age
                break
            if msg == PUBREL_MARKER:
                self.inflight.update(pid, (PUBREL_MARKER, now))
                self.outbox.append((PUBREL_MARKER, pid))
            elif msg.is_expired():
                self.inflight.delete(pid)
                if self.broker is not None:
                    self.broker.metrics.inc("delivery.dropped")
                    self.broker.metrics.inc("delivery.dropped.expired")
            else:
                msg.set_flag("dup", True)
                self.inflight.update(pid, (msg, now))
                self.outbox.append((pid, msg))
        self._mark_dirty()  # retry stamped new timestamps/dup flags
        return next_delay

    def expire_awaiting_rel(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        expired = [pid for pid, ts in self.awaiting_rel.items()
                   if now - ts >= self.await_rel_timeout]
        for pid in expired:
            del self.awaiting_rel[pid]
        if expired and self.broker is not None:
            self.broker.metrics.inc("messages.dropped", len(expired))
            self.broker.metrics.inc("messages.dropped.expired", len(expired))

    # -- takeover / resume / replay (emqx_session:606-629) ----------------

    @owner_loop
    def take_shared_pending(self) -> List[Tuple[str, str, Message, bool]]:
        """Drain unacked/queued shared-group messages for redispatch
        when this session terminates: [(group, topic, original_msg,
        was_transmitted)]. QoS2 messages already PUBREC'd
        (PUBREL_MARKER) are past the point of redispatch, matching the
        reference's ack protocol."""
        out: List[Tuple[str, str, Message, bool]] = []
        for _pid, val in self.inflight.to_list():
            msg = val[0]
            if msg == PUBREL_MARKER or not isinstance(msg, Message):
                continue
            sh = msg.get_header("shared")
            if sh and not msg.is_expired():
                out.append((sh[0], sh[1], sh[2], True))
        kept: List[Message] = []
        while not self.mqueue.is_empty():
            msg = self.mqueue.pop()
            if msg is None:
                break
            sh = msg.get_header("shared")
            if sh:
                if not msg.is_expired():
                    out.append((sh[0], sh[1], sh[2], False))
                # expired shared messages drop here — they must not
                # re-occupy queue capacity in a handed-over session
            else:
                kept.append(msg)  # non-shared queued messages stay:
                # the session may be handed over, not destroyed
        for m in kept:
            self.mqueue.push(m)
        return out

    def takeover(self) -> None:
        """Old owner: detach from the broker, keep state for handoff."""
        if self.broker is not None:
            for topic_filter in self.subscriptions:
                self.broker.unsubscribe(self, topic_filter)

    def resume(self, broker) -> None:
        """New owner: reattach subscriptions to the (possibly new)
        broker."""
        self.broker = broker
        self.connected = True
        for topic_filter, opts in self.subscriptions.items():
            broker.subscribe(self, topic_filter, opts)
        if broker is not None:
            broker.metrics.inc("session.resumed")
            broker.hooks.run("session.resumed", (self.client_id, self.info()))

    @owner_loop
    def replay(self) -> None:
        """Re-emit all inflight entries (dup) then drain the queue."""
        for pid, (msg, _ts) in self.inflight.to_list(
                sort_key=lambda kv: kv[0]):
            if msg == PUBREL_MARKER:
                self.outbox.append((PUBREL_MARKER, pid))
            else:
                msg.set_flag("dup", True)
                self.outbox.append((pid, msg))
        self.dequeue()

    @owner_loop
    def drain_outbox(self) -> List[Tuple[Any, Any]]:
        out, self.outbox = self.outbox, []
        if out and self._outbox_snapshot:
            # a journal or checkpoint snapshot holds these packets:
            # the next flush must write the state without them
            self._outbox_snapshot = False
            self._mark_dirty()
        return out
