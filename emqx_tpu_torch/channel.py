"""The MQTT protocol state machine — sans-IO.

The port of the JAX package's ``Channel`` (``src/emqx_channel.erl``,
the reference's largest module): a pure-ish FSM over connection
state; the transport (:mod:`emqx_tpu_torch.connection`) feeds parsed
packets into :meth:`Channel.handle_in` and writes whatever packets
come back.

Pipelines follow the reference:
  - CONNECT: enrich conninfo → 'client.connect' hook → check proto →
    authenticate → open session (clean/resume via CM)
    → CONNACK (+v5 props) → 'client.connected' (:237-261, 433-450)
  - PUBLISH: topic-alias resolve → ACL → caps → session.publish →
    PUBACK/PUBREC (:293-298, 456-543)
  - SUBSCRIBE: 'client.subscribe' hook → per-filter ACL + caps →
    session/broker subscribe → SUBACK (:362-383)
  - deliver: session outbox → PUBLISH/PUBREL packets (:657-680)
  - timers: keepalive, retry, awaiting-rel expiry (:936-989)
  - will message published on abnormal close (:1539-1551)

A PUBLISH reaches the device through the ingress batcher
(:meth:`Channel._publish_batched` → :mod:`emqx_tpu_torch.ingress`) when
the transport and an event loop are there; a sans-IO caller publishes
synchronously. A draining node refuses a CONNECT with 0x9C
Use-Another-Server (and its Server-Reference on v5) and redirects a
live client with :meth:`Channel.drain_redirect`. Banned and flapping
checks and TLS certificate usernames come with their slices.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional, Tuple

from emqx_tpu_torch import topic as T
from emqx_tpu_torch.access_control import (DENY, PUB, SUB, AccessControl,
                                           ClientInfo)
from emqx_tpu_torch.acl_cache import AclCache
from emqx_tpu_torch.keepalive import Keepalive
from emqx_tpu_torch.limiter import TokenBucket
from emqx_tpu_torch.logger import set_metadata_clientid, set_metadata_peername
from emqx_tpu_torch.mountpoint import mount, replvar, unmount
from emqx_tpu_torch.mqtt import constants as C
from emqx_tpu_torch.mqtt import reason_codes as RC
from emqx_tpu_torch.mqtt.frame import publish_template as wire_template
from emqx_tpu_torch.mqtt.frame import serialize as wire_serialize
from emqx_tpu_torch.mqtt_caps import PUB_DROP_CODES, check_pub, check_sub
from emqx_tpu_torch.mqtt.packet import (Auth, Connack, Connect, Disconnect,
                                        PacketError, Packet, PubAck, Publish,
                                        Pingreq, Pingresp, Suback, Subscribe,
                                        Unsuback, Unsubscribe, check,
                                        to_message, from_message, will_msg)
from emqx_tpu_torch.cm import SessionUnavailableError
from emqx_tpu_torch.session import (PUBREL_MARKER, Session, SessionError)
from emqx_tpu_torch.types import Message, SubOpts
from emqx_tpu_torch.utils.base62 import encode as b62encode
from emqx_tpu_torch.utils.guid import new_guid
from emqx_tpu_torch.zone import Zone, get_zone

log = logging.getLogger("emqx_tpu_torch.channel")

# channel states
IDLE = "idle"
CONNECTING = "connecting"
CONNECTED = "connected"
DISCONNECTED = "disconnected"


class Channel:
    def __init__(self, broker, cm, zone: Optional[Zone] = None,
                 peername: Tuple[str, int] = ("127.0.0.1", 0),
                 listener: str = "tcp:default") -> None:
        self.broker = broker
        self.cm = cm
        self.zone = zone or get_zone()
        self.peername = peername
        self.listener = listener
        self.state = IDLE
        self.proto_ver = C.MQTT_V4
        self.client_id = ""
        self.username: Optional[str] = None
        self.clientinfo = ClientInfo()
        self.session: Optional[Session] = None
        self.keepalive: Optional[Keepalive] = None
        self.will: Optional[Message] = None
        self.acl_cache = AclCache()
        self.access = AccessControl(broker.hooks, self.zone,
                                    metrics=broker.metrics)
        self.alias_in: Dict[int, str] = {}   # v5 inbound topic aliases
        # v5 outbound aliases: per-connection, bounded by the
        # client's Topic-Alias-Maximum (src/emqx_channel.erl
        # topic alias out, :1244-1301)
        self.alias_out: Dict[str, int] = {}
        self.client_alias_max = 0
        self.client_max_packet: Optional[int] = None
        self.mountpoint: Optional[str] = None
        self.connected_at: Optional[float] = None
        self.disconnect_reason: Optional[str] = None
        self.expiry_interval = 0.0
        self.closed = False
        # set when the FSM wants the transport closed *after* the
        # packets it just returned are flushed (error CONNACK, v5
        # DISCONNECT with reason code)
        self.close_after_send = False
        # transport hooks: set by connection
        # the event loop that owns this channel's transport (stamped
        # by its connection; None for a sans-IO channel): the cm runs
        # a call from another thread there (the drain's waves)
        self.owner_loop = None
        self.on_close = None          # force-close the socket
        self.on_deliver = None        # new outbox items are ready
        self.send_oob = None          # out-of-band packet send (kick)
        # raw wire bytes welcome (set by the transport): handle_deliver
        # may then return pre-serialized frames — one QoS 0 frame
        # shared by every subscriber of a message, or a copy of a
        # QoS 1/2 template with the packet id patched in
        self.wire_fast = False
        # publish futures whose acks are still pending at the ingress
        # batcher — error-path acks queue behind them to preserve
        # MQTT-4.6.0 ack ordering
        self._pending_pubs: List = []
        # publish quota (reference: `quota` limiter field,
        # src/emqx_channel.erl:77,193 init'd from the zone's quota
        # policy): a token bucket drawn down by 1 + routed deliveries
        # per publish; exhaustion blocks the PUBLISH pipeline until
        # the refill instant (the reference's quota_timer)
        self._quota = (TokenBucket(*self.zone.quota_conn_messages)
                       if self.zone.quota_conn_messages else None)
        self._quota_blocked_until = 0.0

    # -- helpers ----------------------------------------------------------

    def _ack(self, ptype: int, pid: int, rc: int = RC.SUCCESS) -> PubAck:
        return PubAck(type=ptype, packet_id=pid, reason_code=rc)

    def _connack_error(self, rc5: int,
                       props: Optional[Dict[str, Any]] = None
                       ) -> List[Packet]:
        rc = rc5 if self.proto_ver == C.MQTT_V5 else RC.compat("connack", rc5)
        self.broker.metrics.inc("packets.connack.error")
        if rc5 in (RC.BAD_USERNAME_OR_PASSWORD, RC.NOT_AUTHORIZED):
            self.broker.metrics.inc("packets.connack.auth_error")
        # MQTT: the server MUST close the connection after an error
        # CONNACK — but the CONNACK has to reach the wire first
        self.disconnect_reason = RC.name(rc5)
        self._shutdown(close_transport=False)
        self.close_after_send = True
        self.broker.metrics.inc("packets.connack.sent")
        self.broker.metrics.inc("client.connack")
        if props and self.proto_ver == C.MQTT_V5:
            # e.g. Server-Reference on a draining node's 0x9C
            return [Connack(reason_code=rc, properties=props)]
        return [Connack(reason_code=rc)]

    # -- inbound ----------------------------------------------------------

    def handle_in(self, pkt: Packet) -> List[Packet]:
        """Feed one parsed packet; returns packets to send."""
        if self.closed:
            return []
        if self.state == IDLE and not isinstance(pkt, Connect):
            self.disconnect_reason = "protocol_error"
            self._shutdown()
            return []
        try:
            if isinstance(pkt, Connect):
                return self._in_connect(pkt)
            if isinstance(pkt, Publish):
                return self._in_publish(pkt)
            if isinstance(pkt, PubAck):
                return self._in_puback(pkt)
            if isinstance(pkt, Subscribe):
                return self._in_subscribe(pkt)
            if isinstance(pkt, Unsubscribe):
                return self._in_unsubscribe(pkt)
            if isinstance(pkt, Pingreq):
                self.broker.metrics.inc("packets.pingreq.received")
                self.broker.metrics.inc("packets.pingresp.sent")
                return [Pingresp()]
            if isinstance(pkt, Disconnect):
                return self._in_disconnect(pkt)
            if isinstance(pkt, Auth):
                self.broker.metrics.inc("packets.auth.received")
                # enhanced auth is negotiated by hook; no built-in
                # method: continue-authentication answered via the
                # 'client.enhanced_authenticate' fold when registered
                acc = self.broker.hooks.run_fold(
                    "client.enhanced_authenticate",
                    (dict(self.clientinfo), pkt.properties), None)
                if acc is not None:
                    self.broker.metrics.inc("packets.auth.sent")
                    return [Auth(reason_code=acc.get("rc", 0),
                                 properties=acc.get("properties", {}))]
                return []
        except SessionError as e:
            log.warning("session error: %s", e)
            return []
        return []

    # CONNECT ------------------------------------------------------------

    def _in_connect(self, pkt: Connect) -> List[Packet]:
        self.broker.metrics.inc("packets.connect.received")
        self.broker.metrics.inc("client.connect")
        if self.state != IDLE:
            # duplicate CONNECT is a protocol error
            self.disconnect_reason = "protocol_error"
            self._shutdown()
            return []
        self.state = CONNECTING
        self.proto_ver = pkt.proto_ver
        ov = getattr(self.broker, "overload", None)
        if ov is not None and ov.reject_connects():
            # critical overload: refuse new work at the front door
            # (ServerBusy; v3 clients see server-unavailable through
            # the compat map) — existing connections keep their service
            self.broker.metrics.inc("overload.shed.connect")
            return self._connack_error(RC.SERVER_BUSY)
        dr = getattr(self.broker, "draining", None)
        if dr is not None and dr.rejects_connects():
            # DRAINING (drain.py): new CONNECTs go to the drain target
            # — v5 gets 0x9C Use-Another-Server plus a
            # Server-Reference when one is configured, v3 the
            # server-unavailable compat code (there is no redirect on
            # its wire)
            self.broker.metrics.inc("drain.rejected.connects")
            ref = dr.server_ref()
            return self._connack_error(
                RC.USE_ANOTHER_SERVER,
                props={"Server-Reference": ref} if ref else None)
        username = pkt.username
        client_id = pkt.client_id
        if client_id == "":
            if not pkt.clean_start:
                # zero-byte clientid with clean_start=0 is invalid on
                # EVERY version — there is no session the client
                # could possibly resume (src/emqx_packet.erl:317-320,
                # issue#599; round-4 review: v5 was wrongly exempted)
                return self._connack_error(RC.CLIENT_IDENTIFIER_NOT_VALID)
            client_id = "emqx_tpu_" + b62encode(new_guid())[:20]
            assigned = True
        else:
            assigned = False
        if self.zone.use_username_as_clientid and username:
            # src/emqx_channel.erl:1383-1389 (before assignment so an
            # over-long username still hits the length check)
            client_id = username
            assigned = False
        if len(client_id) > self.zone.max_clientid_len:
            return self._connack_error(RC.CLIENT_IDENTIFIER_NOT_VALID)
        self.client_id = client_id
        self.username = username
        # every later log line from this task carries the client
        # context (src/emqx_channel.erl:1161-1162)
        set_metadata_clientid(client_id)
        set_metadata_peername(self.peername)
        self.clientinfo = ClientInfo(
            clientid=client_id, username=username,
            peerhost=self.peername[0], zone=self.zone.name,
            proto_ver=pkt.proto_ver, keepalive=pkt.keepalive,
            clean_start=pkt.clean_start, listener=self.listener,
            mountpoint=self.zone.mountpoint,
        )
        if pkt.is_bridge:
            # src/emqx_channel.erl:1132-1133 set_bridge_mode
            self.clientinfo["is_bridge"] = True
        self.broker.hooks.run("client.connect", (dict(self.clientinfo),))
        # auth
        auth = self.access.authenticate(self.clientinfo)
        if auth.get("auth_result") != "success":
            self.broker.hooks.run(
                "client.connack",
                (dict(self.clientinfo), "not_authorized"))
            return self._connack_error(RC.NOT_AUTHORIZED)
        if auth.get("anonymous"):
            self.broker.metrics.inc("client.auth.anonymous")
        self.clientinfo["is_superuser"] = auth.get("is_superuser", False)
        self.mountpoint = replvar(self.zone.mountpoint, client_id,
                                  username or "")
        # will message (kept until disconnect decides its fate)
        self.will = will_msg(pkt)
        if self.will is not None and self.mountpoint:
            self.will.topic = mount(self.mountpoint, self.will.topic)
        # session expiry (v5 property or zone default for v3 persistent)
        if pkt.proto_ver == C.MQTT_V5:
            self.expiry_interval = pkt.properties.get(
                "Session-Expiry-Interval", 0)
        else:
            self.expiry_interval = (0 if pkt.clean_start
                                    else self.zone.session_expiry_interval)
        # open session
        sess_opts = {
            "max_subscriptions": self.zone.max_subscriptions,
            "upgrade_qos": self.zone.upgrade_qos,
            "max_inflight": self.zone.max_inflight,
            "retry_interval": self.zone.retry_interval,
            "max_awaiting_rel": self.zone.max_awaiting_rel,
            "await_rel_timeout": self.zone.await_rel_timeout,
            "max_mqueue_len": self.zone.max_mqueue_len,
            "mqueue_store_qos0": self.zone.mqueue_store_qos0,
            "mqueue_priorities": self.zone.mqueue_priorities,
        }
        receive_max = None
        if pkt.proto_ver == C.MQTT_V5:
            receive_max = pkt.properties.get("Receive-Maximum")
            if receive_max:
                sess_opts["max_inflight"] = min(
                    sess_opts["max_inflight"] or receive_max, receive_max)
            # client-side limits the server must honor on delivery:
            # outbound aliases (MQTT-3.1.2-26) and the hard cap on
            # packets we may send (MQTT-3.1.2-24: drop, don't send)
            self.client_alias_max = int(
                pkt.properties.get("Topic-Alias-Maximum", 0) or 0)
            self.client_max_packet = pkt.properties.get(
                "Maximum-Packet-Size")
        try:
            self.session, session_present = self.cm.open_session(
                client_id, pkt.clean_start, self, sess_opts)
        except SessionUnavailableError:
            # the session's owner cannot hand it over now: ServerBusy,
            # and the client's retry comes back for it — the session
            # is never silently replaced by a fresh one
            self.broker.metrics.inc("overload.shed.connect")
            return self._connack_error(RC.SERVER_BUSY)
        self.session.broker = self.broker
        self.session.notify = self._notify_deliver
        # egress pre-serialization hints (read off-loop by
        # ops/dispatch_plan.preserialize_plan): pre-build wire bytes
        # only for transports the fast lanes can serve — mountpoint
        # unmounting and outbound topic aliasing rewrite per delivery
        self.session.proto_ver = self.proto_ver
        self.session.wire_fast_hint = bool(
            self.wire_fast and not self.mountpoint
            and not self.client_alias_max)
        # durability: the session knows its own expiry (to_wire
        # carries it across crash recovery), and a session-expiry > 0
        # CONNECT arms journaling — lifecycle + QoS1/2 window changes
        # survive a kill -9 from here on
        self.session.expiry_interval = self.expiry_interval
        dur = getattr(self.broker, "durability", None)
        if dur is not None:
            dur.session_opened(self.session, self.expiry_interval)
        # keepalive (server may override via zone)
        interval = pkt.keepalive
        props: Dict[str, Any] = {}
        if self.zone.server_keepalive is not None \
                and pkt.proto_ver == C.MQTT_V5:
            interval = self.zone.server_keepalive
            props["Server-Keep-Alive"] = interval
        self.keepalive = Keepalive(interval) if interval else None
        self.state = CONNECTED
        self.connected_at = time.time()
        self.broker.metrics.inc("client.connected")
        self.broker.hooks.run(
            "client.connected",
            (dict(self.clientinfo), {"connected_at": self.connected_at}))
        if pkt.proto_ver == C.MQTT_V5:
            if assigned:
                props["Assigned-Client-Identifier"] = client_id
            props["Topic-Alias-Maximum"] = self.zone.max_topic_alias
            if not self.zone.retain_available:
                props["Retain-Available"] = 0
            if self.zone.max_qos_allowed < 2:
                props["Maximum-QoS"] = self.zone.max_qos_allowed
            if not self.zone.wildcard_subscription:
                props["Wildcard-Subscription-Available"] = 0
            if not self.zone.shared_subscription:
                props["Shared-Subscription-Available"] = 0
            if self.zone.max_packet_size:
                props["Maximum-Packet-Size"] = self.zone.max_packet_size
            if pkt.properties.get("Request-Response-Information") == 1 \
                    and self.zone.response_information:
                # src/emqx_channel.erl:1432-1437
                props["Response-Information"] = \
                    self.zone.response_information
        self.broker.metrics.inc("packets.connack.sent")
        self.broker.metrics.inc("client.connack")
        out: List[Packet] = [Connack(session_present=session_present,
                                     reason_code=RC.SUCCESS,
                                     properties=props)]
        # replay pending state on resumed sessions
        if session_present:
            self.session.replay()
            out.extend(self.handle_deliver())
        return out

    # PUBLISH ------------------------------------------------------------

    def _in_publish(self, pkt: Publish) -> List[Packet]:
        self.broker.metrics.inc("packets.publish.received")
        # v5 topic alias (inbound)
        if self.proto_ver == C.MQTT_V5:
            alias = pkt.properties.get("Topic-Alias")
            if alias is not None:
                if alias == 0 or alias > self.zone.max_topic_alias:
                    return self._disconnect_with(RC.TOPIC_ALIAS_INVALID)
                if pkt.topic:
                    self.alias_in[alias] = pkt.topic
                else:
                    topic = self.alias_in.get(alias)
                    if topic is None:
                        return self._disconnect_with(
                            RC.PROTOCOL_ERROR)
                    pkt.topic = topic
                # the alias is a PER-CONNECTION input artifact: once
                # resolved it must not travel with the routed message
                # (MQTT-3.3.2-6 — a subscriber that advertised no
                # alias support must never see one; outbound aliasing
                # is negotiated separately in handle_deliver)
                pkt.properties = {k: v for k, v in pkt.properties.items()
                                  if k != "Topic-Alias"}
        try:
            check(pkt)
        except PacketError:
            # wildcard/empty topic in PUBLISH is a protocol violation:
            # disconnect, as the reference does (t_publish_wildtopic)
            self.broker.metrics.inc("packets.publish.error")
            return self._disconnect_with(RC.TOPIC_NAME_INVALID)
        # quota gate — the head of the routing pipeline (reference
        # check_quota_exceeded, src/emqx_channel.erl:458,1304-1310):
        # while the bucket is in refill pause, QoS0 drops silently,
        # QoS1 PUBACKs and QoS2 PUBRECs carry QUOTA_EXCEEDED (v5;
        # v3/v4 clients get the plain ack, the reference's handle_out
        # compat). Runs AFTER alias resolution and validation — unlike
        # the reference's pipeline order — so a quota drop can neither
        # swallow an alias registration the client relies on for its
        # post-pause publishes nor mask a protocol violation that must
        # stay fatal regardless of quota state.
        if self._quota is not None and \
                time.monotonic() < self._quota_blocked_until:
            if pkt.qos == C.QOS_0:
                self.broker.metrics.inc("packets.publish.dropped")
                return []
            return self._puback_for(pkt, RC.QUOTA_EXCEEDED)
        # caps
        cap_rc = check_pub(self.zone, pkt.qos, pkt.retain, pkt.topic)
        if cap_rc is not None:
            if cap_rc in PUB_DROP_CODES:
                self.broker.metrics.inc("packets.publish.dropped")
            return self._puback_for(pkt, cap_rc)
        # acl
        if self.zone.enable_acl and not self.clientinfo.get("is_superuser"):
            if self.access.check_acl(self.clientinfo, PUB, pkt.topic,
                                     self.acl_cache) == DENY:
                self.broker.metrics.inc("packets.publish.auth_error")
                self.broker.metrics.inc("client.acl.deny")
                if self.zone.acl_deny_action == "disconnect":
                    # src/emqx_channel.erl:470-478: deny escalates to
                    # a disconnect when the zone says so
                    return self._disconnect_with(RC.NOT_AUTHORIZED)
                return self._puback_for(pkt, RC.NOT_AUTHORIZED)
        msg = to_message(pkt, self.client_id,
                         headers={"proto_ver": self.proto_ver,
                                  "peerhost": self.peername[0],
                                  "username": self.username})
        if self.mountpoint:
            msg.topic = mount(self.mountpoint, msg.topic)
        try:
            if pkt.qos == C.QOS_2:
                self.session.check_awaiting_rel(pkt.packet_id)
            deferred = self._publish_batched(pkt, msg)
            if deferred:
                return []
            if pkt.qos == C.QOS_2:
                n = self.session.publish(pkt.packet_id, msg)
                self._ensure_quota(n)
                rc = RC.SUCCESS if n else RC.NO_MATCHING_SUBSCRIBERS
                self.broker.metrics.inc("packets.pubrec.sent")
                return [self._ack(C.PUBREC, pkt.packet_id,
                                  rc if self.proto_ver == C.MQTT_V5 else 0)]
            n = self.session.publish(pkt.packet_id, msg)
            self._ensure_quota(n)
        except SessionError as e:
            if pkt.qos == C.QOS_2:
                self.broker.metrics.inc("packets.pubrec.sent")
                return self._emit_ordered(
                    [self._ack(C.PUBREC, pkt.packet_id,
                               e.rc if self.proto_ver == C.MQTT_V5
                               else 0)])
            return self._puback_for(pkt, e.rc)
        if pkt.qos == C.QOS_1:
            rc = RC.SUCCESS if n else RC.NO_MATCHING_SUBSCRIBERS
            self.broker.metrics.inc("packets.puback.sent")
            return [self._ack(C.PUBACK, pkt.packet_id,
                              rc if self.proto_ver == C.MQTT_V5 else 0)]
        return []

    def _ensure_quota(self, routed) -> None:
        """Post-publish quota draw (reference ensure_quota,
        src/emqx_channel.erl:545-558): 1 token for the publish plus
        one per routed delivery; when the bucket runs dry the pipeline
        blocks until the computed refill instant (quota_timer)."""
        if self._quota is None:
            return
        pause = self._quota.consume(1 + (routed or 0))
        if pause > 0:
            self._quota_blocked_until = time.monotonic() + pause

    def _publish_batched(self, pkt: Publish, msg) -> bool:
        """Hand the message to the ingress batcher; the QoS1/2 ack is
        sent from the flush callback (SURVEY §2.2 row 1 — publishes
        batched per tick into one device call). False = no batcher or
        no event loop: caller publishes synchronously."""
        batcher = self.broker.ingress
        if batcher is None or self.send_oob is None:
            return False
        if pkt.qos == C.QOS_0:
            if self._quota is None:
                # fire-and-forget: no ack to defer, no future needed
                return batcher.submit(msg, want_result=False) is not None
            # with a quota configured the routed count matters (the
            # draw is 1 + deliveries): take the result future just to
            # feed the quota — QoS0 still sends no ack
            fut = batcher.submit(msg)
            if fut is None:
                return False

            def _quota_done(f) -> None:
                if f.exception() is None:
                    self._ensure_quota(f.result())

            fut.add_done_callback(_quota_done)
            return True
        fut = batcher.submit(msg)
        if fut is None:
            return False
        if pkt.qos == C.QOS_2:
            # window slot reserved now (checked by the caller); the
            # PUBREC completes when the batch lands
            self.session.record_awaiting_rel(pkt.packet_id)
        ack_type = C.PUBREC if pkt.qos == C.QOS_2 else C.PUBACK
        name = "pubrec" if pkt.qos == C.QOS_2 else "puback"
        pid = pkt.packet_id
        self._pending_pubs.append(fut)

        def _done(f) -> None:
            try:
                self._pending_pubs.remove(f)
            except ValueError:
                pass
            if self.closed or self.send_oob is None:
                return  # QoS1/2 clients re-send; at-least-once holds
            if f.exception() is not None:
                # the batch failed: do NOT ack — an ack here would be
                # a lie the client can't recover from (at-least-once
                # depends on its retransmit)
                return
            self._ensure_quota(f.result())
            rc = RC.SUCCESS if f.result() else RC.NO_MATCHING_SUBSCRIBERS
            self.broker.metrics.inc(f"packets.{name}.sent")
            self.send_oob([self._ack(
                ack_type, pid,
                rc if self.proto_ver == C.MQTT_V5 else 0)])

        fut.add_done_callback(_done)
        return True

    def _emit_ordered(self, pkts: List[Packet]) -> List[Packet]:
        """Send ``pkts`` now — unless batched publish acks are still
        pending on this channel, in which case they queue behind the
        last one (MQTT-4.6.0: acks go out in the order the PUBLISHes
        arrived)."""
        if not self._pending_pubs or self.send_oob is None:
            return pkts
        last = self._pending_pubs[-1]

        def _after(_f, pkts=pkts) -> None:
            if not self.closed and self.send_oob is not None:
                self.send_oob(pkts)

        last.add_done_callback(_after)
        return []

    def _puback_for(self, pkt: Publish, rc: int) -> List[Packet]:
        """Error-path PUBACK/PUBREC — queued behind any batched acks
        still pending so acks keep PUBLISH arrival order."""
        if pkt.qos == C.QOS_1:
            return self._emit_ordered(
                [self._ack(C.PUBACK, pkt.packet_id,
                           rc if self.proto_ver == C.MQTT_V5 else 0)])
        if pkt.qos == C.QOS_2:
            return self._emit_ordered(
                [self._ack(C.PUBREC, pkt.packet_id,
                           rc if self.proto_ver == C.MQTT_V5 else 0)])
        return []

    # PUBACK family ------------------------------------------------------

    def _in_puback(self, pkt: PubAck) -> List[Packet]:
        t = pkt.type
        out: List[Packet] = []
        try:
            if t == C.PUBACK:
                self.broker.metrics.inc("packets.puback.received")
                msg = self.session.puback(pkt.packet_id)
                self.broker.metrics.inc("messages.acked")
                # reference: emqx_channel.erl:300-323
                # (after_message_acked on PUBACK/PUBREC)
                self.broker.hooks.run(
                    "message.acked", (dict(self.clientinfo), msg))
            elif t == C.PUBREC:
                self.broker.metrics.inc("packets.pubrec.received")
                try:
                    msg = self.session.pubrec(pkt.packet_id)
                    rc = RC.SUCCESS
                    self.broker.hooks.run(
                        "message.acked", (dict(self.clientinfo), msg))
                except SessionError as e:
                    self.broker.metrics.inc(
                        "packets.pubrec.inuse"
                        if e.rc == RC.PACKET_IDENTIFIER_IN_USE
                        else "packets.pubrec.missed")
                    rc = e.rc
                self.broker.metrics.inc("packets.pubrel.sent")
                return [self._ack(C.PUBREL, pkt.packet_id,
                                  rc if self.proto_ver == C.MQTT_V5 else 0)]
            elif t == C.PUBREL:
                self.broker.metrics.inc("packets.pubrel.received")
                try:
                    self.session.pubrel(pkt.packet_id)
                    rc = RC.SUCCESS
                except SessionError as e:
                    self.broker.metrics.inc("packets.pubrel.missed")
                    rc = e.rc
                self.broker.metrics.inc("packets.pubcomp.sent")
                return [self._ack(C.PUBCOMP, pkt.packet_id,
                                  rc if self.proto_ver == C.MQTT_V5 else 0)]
            elif t == C.PUBCOMP:
                self.broker.metrics.inc("packets.pubcomp.received")
                self.session.pubcomp(pkt.packet_id)
                self.broker.metrics.inc("messages.acked")
        except SessionError as e:
            in_use = e.rc == RC.PACKET_IDENTIFIER_IN_USE
            if t == C.PUBACK:
                self.broker.metrics.inc(
                    "packets.puback.inuse" if in_use
                    else "packets.puback.missed")
            elif t == C.PUBCOMP:
                self.broker.metrics.inc(
                    "packets.pubcomp.inuse" if in_use
                    else "packets.pubcomp.missed")
            log.debug("ack error: %s", e)
        out.extend(self.handle_deliver())
        return out

    # SUBSCRIBE / UNSUBSCRIBE -------------------------------------------

    def _in_subscribe(self, pkt: Subscribe) -> List[Packet]:
        self.broker.metrics.inc("packets.subscribe.received")
        self.broker.metrics.inc("client.subscribe")
        tf = self.broker.hooks.run_fold(
            "client.subscribe",
            (dict(self.clientinfo), pkt.properties),
            pkt.topic_filters)
        rcs: List[int] = []
        subid = pkt.properties.get("Subscription-Identifier") \
            if self.proto_ver == C.MQTT_V5 else None
        for flt, opts in tf:
            rcs.append(self._do_subscribe(flt, opts, subid))
        if self.zone.acl_deny_action == "disconnect" and \
                RC.NOT_AUTHORIZED in rcs:
            # src/emqx_channel.erl:371-377: process_subscribe has
            # already subscribed the ALLOWED filters (the reference
            # iterates and subscribes as it checks, then escalates),
            # so disconnecting here — after _do_subscribe ran — is
            # the reference's exact ordering, ghost subscriptions on
            # a persistent session included
            return self._disconnect_with(RC.NOT_AUTHORIZED)
        self.broker.metrics.inc("packets.suback.sent")
        if self.proto_ver != C.MQTT_V5:
            rcs = [RC.compat("suback", rc) for rc in rcs]
        out: List[Packet] = [Suback(packet_id=pkt.packet_id,
                                    reason_codes=rcs)]
        out.extend(self.handle_deliver())
        return out

    def _do_subscribe(self, flt: str, opts: Dict[str, int],
                      subid) -> int:
        try:
            bare, popts = T.parse(flt)
            T.validate(bare, "filter")
        except T.TopicError:
            self.broker.metrics.inc("packets.subscribe.error")
            return RC.TOPIC_FILTER_INVALID
        # caps
        cap_rc = check_sub(self.zone, bare, popts)
        if cap_rc is not None:
            return cap_rc
        # acl on the bare filter
        if self.zone.enable_acl and not self.clientinfo.get("is_superuser"):
            if self.access.check_acl(self.clientinfo, SUB, bare,
                                     self.acl_cache) == DENY:
                self.broker.metrics.inc("packets.subscribe.auth_error")
                self.broker.metrics.inc("client.acl.deny")
                return RC.NOT_AUTHORIZED
        qos = min(opts.get("qos", 0), self.zone.max_qos_allowed)
        nl = opts.get("nl", 0)
        rap = opts.get("rap", 0)
        if self.proto_ver != C.MQTT_V5:
            # v3/v4 has neither flag on the wire: the zone knob
            # supplies nl and bridge mode supplies rap (reference
            # enrich_subopts, src/emqx_channel.erl:1386-1390 —
            # a bridge must re-publish retained flags as-is)
            if self.zone.ignore_loop_deliver:
                nl = 1
            rap = 1 if self.clientinfo.get("is_bridge") else 0
        subopts = SubOpts(qos=qos, nl=nl, rap=rap,
                          rh=opts.get("rh", 0),
                          subid=subid)
        mflt = self._mount_filter(flt, bare, popts)
        resub = mflt in self.session.subscriptions
        try:
            self.session.subscribe(mflt, subopts)
        except SessionError as e:
            return e.rc
        self.broker.hooks.run(
            "session.subscribed",
            (dict(self.clientinfo), mflt,
             {**subopts.to_dict(), "resub": resub}))
        return qos  # granted qos == RC 0/1/2

    def _mount_filter(self, flt: str, bare: str, popts: dict) -> str:
        """Apply the mountpoint under the share prefix: ``$queue/``
        keeps a 1-segment prefix, ``$share/<g>/`` a 2-segment one."""
        if not self.mountpoint:
            return flt
        mounted = mount(self.mountpoint, bare)
        share = popts.get("share")
        if share == "$queue":
            return "$queue/" + mounted
        if share is not None:
            return f"$share/{share}/{mounted}"
        return mounted

    def _in_unsubscribe(self, pkt: Unsubscribe) -> List[Packet]:
        self.broker.metrics.inc("packets.unsubscribe.received")
        self.broker.metrics.inc("client.unsubscribe")
        tf = self.broker.hooks.run_fold(
            "client.unsubscribe",
            (dict(self.clientinfo), pkt.properties),
            pkt.topic_filters)
        rcs = []
        for flt in tf:
            try:
                bare, popts = T.parse(flt)
            except T.TopicError:
                rcs.append(RC.TOPIC_FILTER_INVALID)
                continue
            mflt = self._mount_filter(flt, bare, popts)
            try:
                opts = self.session.unsubscribe(mflt)
                self.broker.hooks.run(
                    "session.unsubscribed",
                    (dict(self.clientinfo), mflt, opts.to_dict()))
                rcs.append(RC.SUCCESS)
            except SessionError as e:
                self.broker.metrics.inc("packets.unsubscribe.error")
                rcs.append(e.rc)
        self.broker.metrics.inc("packets.unsuback.sent")
        return [Unsuback(packet_id=pkt.packet_id, reason_codes=rcs)]

    # DISCONNECT ---------------------------------------------------------

    def _in_disconnect(self, pkt: Disconnect) -> List[Packet]:
        self.broker.metrics.inc("packets.disconnect.received")
        # v5: client may update session expiry on disconnect — but
        # raising it from a CONNECT-time 0 is a protocol error
        # (MQTT-3.14.2.2.2; src/emqx_channel.erl:639-643). Validated
        # BEFORE the will-discard: a protocol-error close is not a
        # clean disconnect, so the will must still fire.
        if self.proto_ver == C.MQTT_V5:
            exp = pkt.properties.get("Session-Expiry-Interval")
            if exp is not None:
                if self.expiry_interval == 0 and exp > 0:
                    return self._disconnect_with(RC.PROTOCOL_ERROR)
                self.expiry_interval = exp
        if pkt.reason_code == RC.NORMAL_DISCONNECTION:
            self.will = None  # clean close: discard will
        self.disconnect_reason = "normal"
        self._shutdown()
        return []

    def _disconnect_with(self, rc: int) -> List[Packet]:
        self.disconnect_reason = RC.name(rc)
        self._shutdown(close_transport=False)
        self.close_after_send = True
        if self.proto_ver == C.MQTT_V5:
            self.broker.metrics.inc("packets.disconnect.sent")
            return [Disconnect(reason_code=rc)]
        return []

    # -- outbound delivery ------------------------------------------------

    def _notify_deliver(self) -> None:
        if self.on_deliver is not None and not self.closed:
            self.on_deliver()

    def handle_deliver(self) -> List[Packet]:
        """Drain the session outbox into PUBLISH/PUBREL packets."""
        if self.session is None:
            return []
        out: List[Packet] = []
        n_sent = 0
        # the fast lanes' counters, batched per drain: the planner
        # hands a session its whole batch in one enqueue
        n_fast = n_tpl1 = n_tpl2 = 0
        wire_ok = (self.wire_fast and not self.mountpoint
                   and not self.client_alias_max)
        trc = self.broker.tracing
        trace_on = trc is not None and trc.active
        for pid, item in self.session.drain_outbox():
            if pid == PUBREL_MARKER:
                out.append(self._ack(C.PUBREL, item))
                continue
            msg = item
            if msg.is_expired():
                self.broker.metrics.inc("delivery.dropped")
                self.broker.metrics.inc("delivery.dropped.expired")
                continue
            if trace_on and "_trace" in msg.headers:
                # egress-flush span: stamp → this connection's flush.
                # The context key is checked (not re-sampled), so a
                # message the ingress stamped closes its chain here
                trc.flush_mark(msg.headers["_trace"], self.client_id)
            if wire_ok and pid is None:
                data = self._wire_cached(msg)
                if data is not None:
                    if self.client_max_packet and \
                            len(data) > self.client_max_packet:
                        self.broker.metrics.inc("delivery.dropped")
                        self.broker.metrics.inc(
                            "delivery.dropped.too_large")
                        continue
                    n_fast += 1
                    out.append(data)
                    continue
            elif wire_ok and not self.client_max_packet:
                # QoS 1/2 pre-serialized lane: patch the packet id into
                # a copy of the shared template (no size gate needed:
                # the client set no cap)
                data = self._wire_template(pid, msg)
                if data is not None:
                    if msg.qos == C.QOS_2:
                        n_tpl2 += 1
                    else:
                        n_tpl1 += 1
                    out.append(data)
                    continue
            # copy before wire-mutation: the same object stays in the
            # inflight window for retry/replay
            msg = msg.copy()
            if self.mountpoint:
                msg.topic = unmount(self.mountpoint, msg.topic)
            msg.update_expiry()
            pub = from_message(pid, msg)
            if self.proto_ver != C.MQTT_V5:
                pub.properties = {}
            new_alias_topic = None
            if self.proto_ver == C.MQTT_V5 and self.client_alias_max:
                # server-side alias assignment: first delivery of a
                # topic carries name + alias, repeats carry only the
                # alias (empty topic) — saving the topic bytes on
                # every hot-topic delivery
                pub.properties = dict(pub.properties or {})
                alias = self.alias_out.get(pub.topic)
                if alias is not None:
                    pub.properties["Topic-Alias"] = alias
                    pub.topic = ""
                elif len(self.alias_out) < self.client_alias_max:
                    alias = len(self.alias_out) + 1
                    self.alias_out[pub.topic] = alias
                    new_alias_topic = pub.topic
                    pub.properties["Topic-Alias"] = alias
            if self.client_max_packet and len(
                    wire_serialize(pub, self.proto_ver)) \
                    > self.client_max_packet:
                # MQTT-3.1.2-24: may not send past the client's cap.
                # The gate measures the FINAL packet (alias included).
                # A packet only over the cap because of a freshly
                # assigned alias is sent plain instead (rolled back —
                # the client must never see an alias whose defining
                # packet it never got).
                if new_alias_topic is not None:
                    self.alias_out.pop(new_alias_topic, None)
                    pub.topic = new_alias_topic
                    pub.properties.pop("Topic-Alias", None)
                    new_alias_topic = None
                if len(wire_serialize(pub, self.proto_ver)) \
                        > self.client_max_packet:
                    # genuinely oversized: discarded but treated as
                    # acknowledged — the inflight slot frees, before
                    # the sent metrics
                    self.broker.metrics.inc("delivery.dropped")
                    self.broker.metrics.inc(
                        "delivery.dropped.too_large")
                    if pid is not None and self.session is not None:
                        self.session.discard_delivery(pid)
                    continue
            self.broker.metrics.inc_sent(msg)
            n_sent += 1
            out.append(pub)
        m = self.broker.metrics
        if n_sent:
            m.inc("packets.publish.sent", n_sent)
            # PUBLISHes that paid a full serialize on the event loop
            # (ineligible traffic, or pre-serialization off)
            m.inc("delivery.serialize.onloop", n_sent)
        if n_fast:
            # the shared-frame lane is QoS 0 by construction
            m.inc("packets.publish.sent", n_fast)
            m.inc("messages.sent", n_fast)
            m.inc("messages.qos0.sent", n_fast)
        if n_tpl1 or n_tpl2:
            m.inc("packets.publish.sent", n_tpl1 + n_tpl2)
            m.inc("messages.sent", n_tpl1 + n_tpl2)
            if n_tpl1:
                m.inc("messages.qos1.sent", n_tpl1)
            if n_tpl2:
                m.inc("messages.qos2.sent", n_tpl2)
        return out

    def _wire_cached(self, msg) -> Optional[bytes]:
        """One serialized QoS 0 PUBLISH per (message, proto version,
        flags), shared by every subscriber session through the
        message's ``_wire`` header dict (shared across enrich copies,
        see Broker._deliver_one). None = not eligible: take the
        per-delivery path."""
        wire = msg.headers.get("_wire")
        if wire is None:
            return None
        props = msg.headers.get("properties")
        if props and ("Message-Expiry-Interval" in props
                      or "Subscription-Identifier" in props):
            # a per-delivery rewrite (expiry countdown) or a
            # per-SESSION value (subid) must never enter the shared
            # cache — another subscriber would replay it
            return None
        # enriched copies share this dict but can differ in the
        # byte-affecting flags (RAP keeps retain, shared redispatch
        # sets dup); the effective QoS is part of the key, so a
        # downgraded-to-QoS 0 copy never serves a QoS>0 frame
        key = (self.proto_ver, msg.qos, msg.flags.get("retain", False),
               msg.flags.get("dup", False))
        data = wire.get(key)
        if data is None:
            pub = from_message(None, msg)
            if self.proto_ver != C.MQTT_V5:
                pub.properties = {}
            data = wire[key] = wire_serialize(pub, self.proto_ver)
            # an image the pre-serialization did not prime, built ON
            # the loop
            self.broker.metrics.inc("delivery.serialize.onloop")
        return data

    def _wire_template(self, pid: int, msg) -> Optional[bytes]:
        """QoS 1/2 pre-serialized lane: a copy of the message's shared
        template (``_wiretpl``, built off-loop by
        ops/dispatch_plan.preserialize_plan) with ``pid`` patched in.
        None = no template cache on this message, or a per-delivery
        rewrite applies: take the per-delivery path."""
        tpl = msg.headers.get("_wiretpl")
        if tpl is None:
            return None
        if msg.headers.get("shared") is not None:
            # group redispatch carries per-delivery original/dup state
            return None
        props = msg.headers.get("properties")
        if props and ("Message-Expiry-Interval" in props
                      or "Subscription-Identifier" in props):
            return None
        key = (self.proto_ver, msg.qos, msg.flags.get("retain", False),
               msg.flags.get("dup", False))
        entry = tpl.get(key)
        if entry is None:
            # a variant miss (a retry's DUP, another proto version):
            # built once ON the loop and cached for the next frames
            pub = from_message(pid, msg)
            if self.proto_ver != C.MQTT_V5:
                pub.properties = {}
            entry = tpl[key] = wire_template(pub, self.proto_ver)
            self.broker.metrics.inc("delivery.serialize.onloop")
        data, off = entry
        buf = bytearray(data)
        buf[off] = (pid >> 8) & 0xFF
        buf[off + 1] = pid & 0xFF
        return bytes(buf)

    # -- timers -----------------------------------------------------------

    def handle_timeout(self, name: str, recv_bytes: int = 0) -> List[Packet]:
        if name == "keepalive":
            if self.keepalive is not None and \
                    not self.keepalive.check(recv_bytes):
                self.disconnect_reason = "keepalive_timeout"
                self._shutdown(publish_will=True, close_transport=False)
                self.close_after_send = True
                if self.proto_ver == C.MQTT_V5:
                    return [Disconnect(reason_code=RC.KEEPALIVE_TIMEOUT)]
            return []
        if name == "retry" and self.session is not None:
            self.session.retry()
            return self.handle_deliver()
        if name == "expire_awaiting_rel" and self.session is not None:
            self.session.expire_awaiting_rel()
            return []
        return []

    # -- takeover / kick (called by CM) -----------------------------------

    def takeover_begin(self) -> Optional[Session]:
        sess = self.session
        if sess is not None:
            sess.takeover()
        return sess

    def takeover_end(self, rc: int) -> None:
        self.session = None  # handed off — don't tear it down on close
        self.disconnect_reason = "takeovered"
        self.will = None
        self._shutdown(rc=rc)

    def kick(self, discard: bool = False) -> None:
        self.disconnect_reason = "discarded" if discard else "kicked"
        self._shutdown(rc=RC.SESSION_TAKEN_OVER)

    # -- drain redirect (called by DrainManager via the cm marshal) -------

    def drain_redirect(self, server_ref: Optional[str] = None) -> None:
        """Server-initiated redirect: v5 clients get DISCONNECT 0x9C
        Use-Another-Server with a Server-Reference; v3 clients a plain
        close (their protocol has no server DISCONNECT) and find the
        peer through the cluster registry on reconnect. The will is
        suppressed exactly like the cm takeover path — custody is
        moving, the session is not dying — and the close queues
        behind any batched publish acks still pending, so a publisher
        never loses an ack it was owed."""
        if self.closed or self.state != CONNECTED:
            return

        def _go(_f=None) -> None:
            if self.closed:
                return
            self.will = None  # custody hand-off, not session death
            self.disconnect_reason = "drained"
            self._shutdown(rc=RC.USE_ANOTHER_SERVER,
                           server_ref=server_ref)

        if self._pending_pubs:
            self._pending_pubs[-1].add_done_callback(_go)
        else:
            _go()

    # -- teardown ----------------------------------------------------------

    def _shutdown(self, publish_will: Optional[bool] = None,
                  rc: Optional[int] = None,
                  close_transport: bool = True,
                  server_ref: Optional[str] = None) -> None:
        if self.closed:
            return
        self.closed = True
        was_connected = self.state == CONNECTED
        self.state = DISCONNECTED
        if (rc is not None and was_connected
                and self.proto_ver == C.MQTT_V5
                and self.send_oob is not None):
            # tell the victim why before closing (e.g. DISCONNECT
            # 0x8E session-taken-over on kick/takeover, 0x9C + the
            # Server-Reference on a drain redirect — the reference's
            # handle_call({takeover,...}) reply path)
            props = ({"Server-Reference": server_ref}
                     if server_ref else {})
            try:
                self.send_oob([Disconnect(reason_code=rc,
                                          properties=props)])
            except Exception:
                pass
        if publish_will is None:
            publish_will = self.disconnect_reason not in (
                "normal", "takeovered", "discarded")
        if publish_will and self.will is not None:
            delay = (self.will.get_header("properties") or {}).get(
                "Will-Delay-Interval", 0)
            if delay and self.expiry_interval > 0 and self.client_id:
                # held back until the delay elapses or the session
                # ends, whichever first; cancelled on reconnect
                # (MQTT5 3.1.3.2.2)
                self.cm.schedule_will(
                    self.client_id, self.will,
                    min(delay, self.expiry_interval))
            else:
                # device-path will dispatch: a teardown wave's wills
                # coalesce into the ingress batcher's device batches
                self.broker.publish_will(self.will)
            self.will = None
        if was_connected:
            self.broker.metrics.inc("client.disconnected")
            self.broker.hooks.run(
                "client.disconnected",
                (dict(self.clientinfo), self.disconnect_reason or "normal"))
        if self.client_id and self.session is not None:
            self.cm.connection_closed(
                self.client_id, self, self.session, self.expiry_interval)
            self.session = None
        elif self.client_id:
            self.cm.unregister_channel(self.client_id, self)
        if close_transport and self.on_close is not None:
            try:
                self.on_close()
            except Exception:
                pass
