"""TCP transport: one asyncio task per connection feeding the channel
FSM, and the listener that accepts them.

The port of the JAX package's ``Connection`` and ``Listener``. It
replaces the reference's process-per-connection loop
(src/emqx_connection.erl:254-271): asyncio tasks play the role of
BEAM processes, and the esockd acceptor pool becomes
``asyncio.start_server`` on the node's one event loop. Flow control
mirrors `{active, N}` + rate-limit pause (:363-373, 633-645) with
token-bucket pauses and the ingress batcher's backpressure.

Publishes arriving within one event-loop iteration across connections
reach the device as one batch through the node's ingress batcher
(:mod:`emqx_tpu_torch.ingress`). WebSocket, TLS and PSK, several
front-door loops, the forced-GC policy and fault injection come with
their slices.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

from emqx_tpu_torch import faults
from emqx_tpu_torch.channel import Channel
from emqx_tpu_torch.device import resolve
from emqx_tpu_torch.gc import GcPolicy
from emqx_tpu_torch.limiter import TokenBucket
from emqx_tpu_torch.mqtt import reason_codes as RC
from emqx_tpu_torch.mqtt.frame import (FrameError, FrameTooLarge,
                                       make_parser, serialize)
from emqx_tpu_torch.mqtt.packet import Publish
from emqx_tpu_torch.zone import Zone, get_zone

log = logging.getLogger("emqx_tpu_torch.connection")

#: strong references to fire-and-forget tasks (accepted sockets,
#: close-bounding flushes): the event loop keeps only a WEAK
#: reference to a task, so a dropped handle can be garbage-collected
#: mid-run and its connection silently vanish
_BG_TASKS: set = set()


def _retain_task(task: "asyncio.Task") -> "asyncio.Task":
    _BG_TASKS.add(task)
    task.add_done_callback(_BG_TASKS.discard)
    return task


class Connection:
    """One client socket <-> one Channel."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter,
                 broker, cm, zone: Optional[Zone] = None,
                 listener: str = "tcp:default",
                 peername=None, frame: str = "py") -> None:
        self.reader = reader
        self.writer = writer
        self.zone = zone or get_zone()
        # an explicit peername wins: the listener's PROXY-protocol
        # parse carries the REAL client address from the LB
        peer = peername or writer.get_extra_info("peername") or ("?", 0)
        self.channel = Channel(broker, cm, zone=self.zone,
                               peername=(str(peer[0]), int(peer[1])),
                               listener=listener)
        self.channel.on_close = self._close_transport
        self.channel.on_deliver = self._schedule_flush
        self.channel.send_oob = self._send_packets
        # the transport takes raw wire bytes: handle_deliver may hand
        # it shared pre-serialized frames (Channel.wire_fast)
        self.channel.wire_fast = True
        # [node] frame: "py" or "native" (the C framing); a native
        # parser that cannot be built raises here, never downgrades
        self.parser = make_parser(max_size=self.zone.max_packet_size,
                                  mode=frame)
        self.broker = broker
        self.recv_bytes = 0
        self.send_bytes = 0
        self.recv_pkts = 0
        self.send_pkts = 0
        self._closing = False
        self._limiter = (TokenBucket(*self.zone.ratelimit_bytes_in)
                         if self.zone.ratelimit_bytes_in else None)
        # msgs-in limiter: counts inbound PUBLISHes and pauses the
        # read loop, the reference's conn_messages_in checker run by
        # ensure_rate_limit (src/emqx_connection.erl:633-645,
        # src/emqx_limiter.erl conn_messages_in)
        self._msg_limiter = (TokenBucket(*self.zone.ratelimit_msg_in)
                             if self.zone.ratelimit_msg_in else None)
        # while a limiter pause blocks the read loop the client is
        # unobservable, not dead: keepalive checks are deferred past
        # this instant (the reference's `blocked` sockstate holds off
        # idle shutdown the same way)
        self._paused_until = 0.0
        # forced young-generation collection per N packets / M bytes
        # received (the zone's force_gc_policy; src/emqx_gc.erl)
        self._gc = (GcPolicy(*self.zone.force_gc_policy)
                    if self.zone.force_gc_policy else None)
        self._timers: list = []
        self._loop = None  # serving loop, captured by run()
        self._flush_scheduled = False  # coalesced delivery wakeups
        self._send_guard: Optional[asyncio.Task] = None

    # -- IO ----------------------------------------------------------------

    def _send_packets(self, pkts) -> None:
        if faults.enabled and faults.fire("socket.reset"):
            raise ConnectionResetError("fault injected: socket.reset")
        max_out = self.channel.client_max_packet
        # counters batched per call: a planner batch drains a whole
        # outbox here
        n_pkts = 0
        n_bytes = 0
        # one transport writelines() per call
        frames: list = []
        try:
            for pkt in pkts:
                if type(pkt) is bytes:
                    # a pre-serialized frame: the channel already built
                    # (and size-gated) the wire bytes
                    self.send_bytes += len(pkt)
                    self.send_pkts += 1
                    n_pkts += 1
                    n_bytes += len(pkt)
                    frames.append(pkt)
                    continue
                data = serialize(pkt, self.channel.proto_ver)
                if max_out and len(data) > max_out:
                    # MQTT-3.1.2-24 covers EVERY packet. PUBLISHes are
                    # gated in Channel.handle_deliver (before alias and
                    # inflight effects); this is the backstop plus the
                    # non-PUBLISH handling: trim optional properties,
                    # and if the packet still can't fit, close rather
                    # than violate the client's declared limit.
                    if isinstance(pkt, Publish):
                        # unreachable in normal operation: the channel
                        # gates PUBLISHes (with inflight release + alias
                        # rollback) before they get here
                        log.warning("oversized PUBLISH reached transport "
                                    "backstop (%d > %d)", len(data),
                                    max_out)
                        self.broker.metrics.inc("delivery.dropped")
                        self.broker.metrics.inc(
                            "delivery.dropped.too_large")
                        continue
                    props = getattr(pkt, "properties", None)
                    if props:
                        # MQTT-3.2.2.3: only Reason String / User
                        # Properties may be dropped to fit — mandatory
                        # properties (Assigned-Client-Identifier, server
                        # limits) must survive
                        props.pop("Reason-String", None)
                        props.pop("User-Property", None)
                        data = serialize(pkt, self.channel.proto_ver)
                    if len(data) > max_out:
                        log.warning(
                            "cannot fit %s under client max packet %d: "
                            "closing %s", type(pkt).__name__, max_out,
                            self.channel.peername)
                        if frames and not self._closing:
                            self.writer.writelines(frames)
                        self._close_transport()
                        return
                self.send_bytes += len(data)
                self.send_pkts += 1
                n_pkts += 1
                n_bytes += len(data)
                frames.append(data)
            if frames and not self._closing:
                self.writer.writelines(frames)
        finally:
            if n_pkts:
                self.broker.metrics.inc("packets.sent", n_pkts)
                self.broker.metrics.inc("bytes.sent", n_bytes)

    def _schedule_flush(self) -> None:
        """Wake the writer when the broker delivered into our session
        from another connection's task.

        Coalesced: a burst of deliveries into one session (a batch
        tail fanning out) schedules ONE flush, which drains the whole
        outbox — not one callback per message (the benign cross-thread
        race costs at most one extra empty flush)."""
        if self._flush_scheduled:
            return
        self._flush_scheduled = True
        # wakeups that survived coalescing; the planner's grouped
        # delivery tail targets ≤1 per connection per batch
        self.broker.metrics.inc("delivery.wakeups")
        loop = self._loop
        if loop is None:
            self._flush_deliver()  # not running yet (sync callers)
            return
        loop.call_soon(self._flush_deliver)

    def _flush_deliver(self) -> None:
        self._flush_scheduled = False
        if self._closing:
            return
        try:
            self._send_packets(self.channel.handle_deliver())
        except (ConnectionResetError, BrokenPipeError, OSError):
            # socket died mid-flush OUTSIDE the read loop's handler
            # (this runs as a bare loop callback): close cleanly —
            # the read loop's EOF then runs the normal shutdown path
            # — instead of leaking the exception to the event loop
            self._abort_transport()
            return
        # slow-consumer guard: the fan-out path writes without
        # draining (one slow subscriber must not stall a broadcast),
        # so a consumer that stops reading would otherwise grow the
        # transport buffer without bound. Past high_watermark the
        # peer gets send_timeout seconds to drain or the socket
        # closes (reference: send_timeout + send_timeout_close).
        if (self.zone.send_timeout > 0 and self._loop is not None
                and (self._send_guard is None
                     or self._send_guard.done())):
            tr = self.writer.transport
            try:
                over = (tr is not None and tr.get_write_buffer_size()
                        > self.zone.high_watermark)
            except Exception:
                over = False
            if over:
                self._send_guard = self._loop.create_task(
                    self._send_timeout_guard())

    async def _send_timeout_guard(self) -> None:
        try:
            await asyncio.wait_for(self.writer.drain(),
                                   self.zone.send_timeout)
        except asyncio.TimeoutError:
            if not self.zone.send_timeout_close:
                log.warning("slow consumer %s: write buffer stuck > "
                            "%.0fs (send_timeout_close off)",
                            self.channel.peername,
                            self.zone.send_timeout)
                return
            log.info("closing slow consumer %s: write buffer stuck "
                     "> %.0fs", self.channel.peername,
                     self.zone.send_timeout)
            self.broker.metrics.inc("connections.closed.slow_consumer")
            self.channel.disconnect_reason = "send_timeout"
            # abort, not close: a graceful close would wait forever
            # to flush the very buffer the peer refuses to drain
            self._abort_transport()
        except Exception:
            pass  # socket died on its own

    def _close_transport(self) -> None:
        self._closing = True
        try:
            self.writer.close()
        except Exception:
            return
        # a graceful close flushes the write buffer first — a wedged
        # peer would hold the socket (and the conn task, and
        # Listener.stop) forever. Bound it by send_timeout, then
        # abort. (send_timeout = 0 keeps closes unbounded.)
        if self.zone.send_timeout > 0 and self._loop is not None:
            coro = self._ensure_closed(self.zone.send_timeout)
            try:
                _retain_task(self._loop.create_task(coro))
            except RuntimeError:
                coro.close()  # serving loop already closed

    async def _ensure_closed(self, timeout: float) -> None:
        try:
            await asyncio.wait_for(self.writer.wait_closed(), timeout)
        except asyncio.TimeoutError:
            self._abort_transport()
        except Exception:
            pass

    def _abort_transport(self) -> None:
        self._closing = True
        try:
            self.writer.transport.abort()
        except Exception:
            self._close_transport()

    async def _drain_and_close(self) -> None:
        """Flush pending bytes (error CONNACK / reason-coded
        DISCONNECT), then close the socket — bounded: a peer that
        won't drain must not pin the task forever."""
        try:
            if self.zone.send_timeout > 0:
                await asyncio.wait_for(self.writer.drain(),
                                       self.zone.send_timeout)
            else:
                await self.writer.drain()
        except asyncio.TimeoutError:
            self._abort_transport()
            return
        except Exception:
            pass
        self._close_transport()

    async def run(self) -> None:
        """The connection loop: read → parse → channel → write."""
        self._loop = asyncio.get_running_loop()
        # make zone.high_watermark govern the TRANSPORT too: drain()
        # in the read loop and in the guard resolves against these
        # limits, so the knob means what it says instead of asyncio's
        # fixed 64KB default
        try:
            self.writer.transport.set_write_buffer_limits(
                high=self.zone.high_watermark)
        except Exception:
            pass
        idle_deadline = time.time() + self.zone.idle_timeout
        try:
            while not self._closing:
                timeout = None
                if self.channel.state == "idle":
                    timeout = max(0.1, idle_deadline - time.time())
                try:
                    data = await asyncio.wait_for(
                        self.reader.read(65536), timeout) \
                        if timeout else await self.reader.read(65536)
                except asyncio.TimeoutError:
                    break  # no CONNECT within idle_timeout
                if not data:
                    break
                self.recv_bytes += len(data)
                self.broker.metrics.inc("bytes.received", len(data))
                if self._limiter is not None:
                    wait = self._limiter.consume(len(data))
                    if wait > 0:  # backpressure pause
                        self._paused_until = time.monotonic() + wait
                        await asyncio.sleep(wait)
                if self._gc is not None:
                    self._gc.inc(1, len(data))
                pkts = await self._decode(data)
                for idx, pkt in enumerate(pkts or []):
                    if not await self._process(pkt):
                        return
                    if idx % 32 == 31:
                        # bound this handler's event-loop quantum: a
                        # 64KB read can hold ~650 PUBLISHes (~20ms of
                        # channel work), and several such handlers
                        # back-to-back made ~160ms loop cycles — every
                        # OTHER connection's delivery tail rode that
                        # cycle (round-4 live p99). Yielding every 32
                        # packets interleaves deliveries at ~ms
                        # granularity; throughput is unchanged (the
                        # work is conserved, just sliced).
                        await asyncio.sleep(0)
                if pkts is None:
                    # framing violation: any packets decoded before it
                    # were processed above, and their responses flush
                    # before the close
                    await self._drain_and_close()
                    break
                if not self._closing:
                    await self.writer.drain()
                if pkts:
                    ing = self.broker.ingress
                    if (ing is not None and ing.backlogged()
                            and any(isinstance(p, Publish)
                                    for p in pkts)):
                        # ingest backpressure (active_n analogue,
                        # src/emqx_connection.erl:99): the shared
                        # accumulator is at its high-water mark —
                        # stop READING this publisher until a flush
                        # drains it. The standing queue then lives in
                        # the publisher's TCP buffer, not in the
                        # broker, so delivery tail latency stays
                        # bounded at saturation. The wait is bounded
                        # (OverloadConfig.ingress_wait_timeout_s): a
                        # queue that never drains sheds the publisher
                        # instead of parking it forever
                        if not await ing.wait_ready(
                                ing.submit_wait_timeout):
                            self.broker.metrics.inc(
                                "overload.shed.ingress_timeout")
                            alarms = self.broker.alarms
                            if alarms is not None:
                                alarms.activate(
                                    "ingress_saturated",
                                    details={"queue": len(ing._pending)},
                                    message="ingress accumulator "
                                            "saturated past the "
                                            "submit wait bound; "
                                            "shedding publishers")
                            log.warning(
                                "shedding publisher %s: ingress "
                                "saturated > %.0fs",
                                self.channel.peername,
                                ing.submit_wait_timeout)
                            self.channel.disconnect_reason = \
                                "ingress_saturated"
                            break
                if self._msg_limiter is not None and pkts:
                    # like the reference, the already-parsed batch is
                    # processed first, then the socket pauses (state
                    # `blocked` + limit_timeout timer there; a plain
                    # sleep before the next read here)
                    n_pubs = sum(1 for p in pkts
                                 if isinstance(p, Publish))
                    if n_pubs:
                        wait = self._msg_limiter.consume(n_pubs)
                        if wait > 0:
                            self._paused_until = \
                                time.monotonic() + wait
                            await asyncio.sleep(wait)
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            for t in self._timers:
                try:
                    t.cancel()
                except RuntimeError:
                    pass  # serving loop already closed (chaos stop)
            if not self.channel.closed:
                if self.channel.disconnect_reason is None:
                    self.channel.disconnect_reason = "sock_closed"
                self.channel._shutdown()
            self._close_transport()

    async def _decode(self, data: bytes):
        """Inbound framing: bytes → MQTT packets, or ``None`` to finish
        the connection (framing violation)."""
        try:
            pkts = self.parser.feed(data)
        except FrameTooLarge as e:
            # rejected at header-decode time, BEFORE the body buffers:
            # a 256MB-claiming header costs its
            # header bytes, not its claimed size. v5 clients learn
            # why (DISCONNECT 0x95 Packet Too Large) before the close
            log.debug("oversized frame from %s: %s",
                      self.channel.peername, e)
            m = self.broker.metrics
            m.inc("delivery.dropped.too_large")
            m.inc("frame.oversize")
            if not self.channel.closed:
                self.channel.disconnect_reason = "frame_too_large"
                self.channel._shutdown(rc=RC.PACKET_TOO_LARGE,
                                       close_transport=False)
            return None
        except FrameError as e:
            log.debug("frame error from %s: %s", self.channel.peername, e)
            return None
        nf = getattr(self.parser, "native_frames", 0)
        if nf:
            self.broker.metrics.inc("frame.native.frames", nf)
            self.parser.native_frames = 0
        return pkts

    async def _process(self, pkt) -> bool:
        """Run one parsed packet through the channel; ``False`` ends
        the connection loop (the FSM asked for a close)."""
        self.recv_pkts += 1
        self.broker.metrics.inc("packets.received")
        first_connect = self.channel.state == "idle"
        self._send_packets(self.channel.handle_in(pkt))
        self._send_packets(self.channel.handle_deliver())
        if first_connect and self.channel.state == "connected":
            self._start_timers()
        if self.channel.close_after_send:
            await self._drain_and_close()
            return False
        return True

    def _start_timers(self) -> None:
        loop = asyncio.get_running_loop()
        self._timers.append(loop.create_task(self._keepalive_loop()))
        self._timers.append(loop.create_task(self._retry_loop()))

    async def _keepalive_loop(self) -> None:
        ka = self.channel.keepalive
        if ka is None:
            return
        while not self._closing:
            await asyncio.sleep(ka.check_interval())
            if time.monotonic() < self._paused_until:
                # rate-limit pause: the read loop isn't draining the
                # socket, so a silent client proves nothing — a
                # keepalive kill here would disconnect a live,
                # merely-throttled client (and falsely fire its will)
                continue
            out = self.channel.handle_timeout("keepalive", self.recv_bytes)
            self._send_packets(out)
            if self.channel.close_after_send:
                await self._drain_and_close()
                return
            if self.channel.closed:
                return

    async def _retry_loop(self) -> None:
        while not self._closing and self.channel.session is not None:
            await asyncio.sleep(
                max(1.0, self.channel.session.retry_interval))
            out = self.channel.handle_timeout("retry")
            self._send_packets(out)
            out = self.channel.handle_timeout("expire_awaiting_rel")
            self._send_packets(out)
            try:
                await self.writer.drain()
            except Exception:
                return


def parse_access_rules(rules):
    """``["allow 127.0.0.1", "deny 10.0.0.0/8", "allow all"]`` →
    ordered (allow, network|None) pairs (reference: esockd access
    rules, etc/emqx.conf listener.*.access.N). First match wins; NO
    match denies — end the list with "allow all" for the reference's
    default-open behavior (its shipped config does exactly that)."""
    import ipaddress

    parsed = []
    for rule in rules:
        parts = str(rule).split()
        if len(parts) != 2 or parts[0] not in ("allow", "deny"):
            raise ValueError(f"bad access rule {rule!r}")
        who = None if parts[1] == "all" else \
            ipaddress.ip_network(parts[1], strict=False)
        parsed.append((parts[0] == "allow", who))
    return parsed


def check_access(parsed_rules, ip: str) -> bool:
    import ipaddress

    try:
        addr = ipaddress.ip_address(ip)
    except ValueError:
        return False  # unknown peer form: never through an ACL
    # dual-stack listeners hand IPv4 peers to us as ::ffff:a.b.c.d —
    # an un-unmapped address would bypass every IPv4 deny rule
    mapped = getattr(addr, "ipv4_mapped", None)
    if mapped is not None:
        addr = mapped
    for allow, net in parsed_rules:
        if net is None or (addr.version == net.version
                           and addr in net):
            return allow
    return False


_PP2_SIG = b"\r\n\r\n\x00\r\nQUIT\n"


async def read_proxy_header(reader: asyncio.StreamReader):
    """Consume a PROXY protocol v1/v2 header; return the real client
    ``(ip, port)`` or None (UNKNOWN / v2 LOCAL — keep the socket
    peer). Raises on a malformed header (caller closes).

    Reference: esockd's ``proxy_protocol`` listener option
    (etc/emqx.conf listener.tcp.*.proxy_protocol) — a fronting load
    balancer prepends the header so ACLs/bans/flapping/logs see the
    real client, not the LB.
    """
    import ipaddress
    import struct

    head = await reader.readexactly(12)
    if head == _PP2_SIG:
        ver_cmd, fam, ln = struct.unpack(
            "!BBH", await reader.readexactly(4))
        if ver_cmd >> 4 != 2:
            raise ValueError(f"bad PPv2 version {ver_cmd:#x}")
        cmd = ver_cmd & 0x0F
        if cmd > 1:
            # spec: receivers must abort on reserved commands — a
            # silently-admitted connection would wear the LB's
            # address and poison bans/ACLs keyed on it
            raise ValueError(f"bad PPv2 command {cmd}")
        body = await reader.readexactly(ln)
        if cmd == 0:  # LOCAL (health check): socket peer
            return None
        if fam >> 4 == 1:     # AF_INET
            if ln < 12:
                raise ValueError("truncated PPv2 INET block")
            src = str(ipaddress.IPv4Address(body[0:4]))
            sport = struct.unpack("!H", body[8:10])[0]
            return (src, sport)
        if fam >> 4 == 2:     # AF_INET6
            if ln < 36:
                raise ValueError("truncated PPv2 INET6 block")
            src = str(ipaddress.IPv6Address(body[0:16]))
            sport = struct.unpack("!H", body[32:34])[0]
            return (src, sport)
        return None  # AF_UNSPEC/unix: keep socket peer
    if head[:6] == b"PROXY ":
        rest = await reader.readuntil(b"\r\n")
        line = (head + rest)[:-2].decode("latin-1")
        if len(line) > 107:
            raise ValueError("PPv1 header too long")
        parts = line.split(" ")
        if parts[1] == "UNKNOWN":
            return None
        if len(parts) != 6 or parts[1] not in ("TCP4", "TCP6"):
            raise ValueError(f"bad PPv1 line {line!r}")
        addr = ipaddress.ip_address(parts[2])
        if addr.version != (4 if parts[1] == "TCP4" else 6):
            raise ValueError(f"PPv1 family/address mismatch {line!r}")
        return (parts[2], int(parts[4]))
    raise ValueError("no PROXY header")


class Listener:
    """TCP listener: accepts sockets, spawns Connections
    (reference: src/emqx_listeners.erl + esockd acceptors), on the
    node's event loop. Like every entry point it runs on CUDA unless
    the caller passes ``device="cpu"``, and only on the broker's
    device."""

    #: sockets open at once (esockd max_connections); past it a new
    #: socket closes at accept
    MAX_CONNECTIONS = 1024000
    #: seconds a PROXY header may take to arrive
    PROXY_PROTOCOL_TIMEOUT = 3.0

    def __init__(self, broker, cm, host: str = "127.0.0.1",
                 port: int = 1883, zone: Optional[Zone] = None,
                 name: str = "tcp:default",
                 proxy_protocol: bool = False,
                 access_rules=None,
                 device=None, frame: str = "py") -> None:
        dev = resolve(device)
        if dev != broker.device:
            raise ValueError(f"Listener on {dev} for a broker on "
                             f"{broker.device}")
        self.broker = broker
        self.cm = cm
        self.host = host
        self.port = port
        self.zone = zone or get_zone()
        self.name = name
        # parser variant of the accepted connections ([node] frame)
        self.frame = frame
        # PROXY protocol v1/v2 (esockd proxy_protocol): a fronting LB
        # prepends the REAL client address; the header must arrive
        # within PROXY_PROTOCOL_TIMEOUT or the socket closes
        self.proxy_protocol = proxy_protocol
        # esockd access rules: ordered allow/deny on the SOCKET peer
        self.access_rules = (parse_access_rules(access_rules)
                             if access_rules else None)
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()
        self._handshaking: set = set()
        # graceful shutdown: a v5 reason code to send in a DISCONNECT
        # before force-closing live connections at stop() — Node.stop
        # sets Server-Shutting-Down (0x8B) on a durable node so
        # clients reconnect and resume. None = a silent close
        self.shutdown_rc: Optional[int] = None

    async def _on_client(self, reader, writer) -> None:
        if len(self._conns) + len(self._handshaking) >= \
                self.MAX_CONNECTIONS:
            writer.close()
            return
        if self.access_rules is not None:
            peer = writer.get_extra_info("peername") or ("?",)
            if not check_access(self.access_rules, str(peer[0])):
                writer.close()
                return
        conn = None
        self._handshaking.add(writer)
        try:
            peername = None
            if self.proxy_protocol:
                try:
                    peername = await asyncio.wait_for(
                        read_proxy_header(reader),
                        self.PROXY_PROTOCOL_TIMEOUT)
                except Exception as e:
                    # no/garbled header within the window: the
                    # listener is LB-only by configuration
                    log.debug("proxy_protocol reject: %r", e)
                    return
            conn = Connection(reader, writer, self.broker, self.cm,
                              zone=self.zone, listener=self.name,
                              peername=peername, frame=self.frame)
            self._conns.add(conn)
            self._handshaking.discard(writer)
            await conn.run()
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            self._handshaking.discard(writer)
            if conn is not None:
                self._conns.discard(conn)
            try:
                writer.close()
            except Exception:
                pass

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._on_client, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("listener %s on %s:%s", self.name, self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # force-close live connections: wait_closed() (3.12+)
            # blocks until every client handler returns
            for w in list(self._handshaking):
                try:
                    w.close()
                except Exception:
                    pass
            for conn in list(self._conns):
                try:
                    if not conn.channel.closed:
                        conn.channel.disconnect_reason = "server_shutdown"
                        conn.channel._shutdown(rc=self.shutdown_rc)
                    conn._close_transport()
                except Exception:
                    pass
            await self._server.wait_closed()
            self._server = None

    def current_connections(self) -> int:
        return len(self._conns)
