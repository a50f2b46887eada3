"""Socket transport for the cluster: the gen_rpc data plane over TCP.

The port of the JAX package's ``cluster_net``; the same ``(op, args)``
frames to the same bytes in both packages (``wire.py`` is byte-equal).

The reference's distribution stack runs two planes (SURVEY §2.3):
gen_rpc TCP clients keyed per node for the data plane
(src/emqx_rpc.erl:33-60) and native distribution for control calls.
Here one asyncio TCP link per peer carries both, behind the same
:class:`~emqx_tpu_torch.cluster.Transport` seam the in-process
``LocalTransport`` implements — the Cluster logic cannot tell them
apart (that seam-isolation is the reference's own testing strategy,
SURVEY §4).

Design:

  - **Own IO thread.** The transport runs a private event loop on a
    daemon thread. Synchronous ``call``/``cast`` from broker code
    (which may itself be running on the node's server loop) submit
    work to the IO loop and — for calls — block on a future with a
    timeout. Data-plane forwards use ``cast`` (fire-and-forget), so
    the publish path never blocks on a peer.
  - **Inbound dispatch on the owner loop.** Received RPCs mutate
    broker/session state whose wakeups (``call_soon``) must land on
    the node's serving loop; the transport therefore trampolines
    inbound handling onto the loop captured at ``serve()`` time and
    only falls back to inline execution in loop-less (sync test)
    processes.
  - **Frames.** 4-byte big-endian length + a DATA-ONLY payload
    (:mod:`emqx_tpu_torch.wire`) of ``(kind, req_id, payload)``. The
    reference ships Erlang *terms* — pure data — over its
    cookie-gated distribution; so does this: the wire codec decodes
    only a fixed value vocabulary (no pickle, so a compromised peer
    cannot run code here), and the cookie gate is an access control,
    not the last line of defense.
  - **Per-peer connection cache** with lazy (re)connect, mirroring
    gen_rpc's per-key client sockets.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import threading
import time
from concurrent import futures as _futures
from typing import Dict, Optional, Tuple

from emqx_tpu_torch import faults as _faults
from emqx_tpu_torch import wire
from emqx_tpu_torch.cluster import (ClusterConfig, PeerUnavailableError,
                              Transport)

log = logging.getLogger("emqx_tpu_torch.cluster_net")

_LEN = struct.Struct(">I")
_MAX_FRAME = 64 * 1024 * 1024
_HELLO, _CAST, _CALL, _REPLY, _ERR = "hello", "cast", "call", "reply", "err"


#: failure-detector states: ok → suspect on missed
#: heartbeats or a link drop (casts park, NOTHING is purged) → down
#: after the full miss window (nodedown dispatched) → back to ok via
#: reappearance (down) or consecutive heartbeat successes (suspect)
_OK, _SUSPECT, _DOWN = "ok", "suspect", "down"

_STATE_RANK = {_OK: 0, _SUSPECT: 1, _DOWN: 2}


class _PeerHealth:
    """Per-peer detector state. Written only by the transport's IO
    loop; read lock-free from other threads (single-field loads are
    atomic under the GIL — readers may see a state one transition
    old, which every consumer tolerates)."""

    __slots__ = ("state", "misses", "oks", "rtt_ms", "since",
                 "dial_fails", "next_dial", "departed")

    def __init__(self) -> None:
        self.state = _OK
        self.misses = 0
        self.oks = 0
        self.rtt_ms: Optional[float] = None
        self.since = time.time()
        self.dial_fails = 0     # consecutive failed (re)dials
        self.next_dial = 0.0    # monotonic gate for the next redial
        self.departed = False   # left deliberately: never auto-heal


async def _send_frame(writer: asyncio.StreamWriter, obj) -> None:
    data = wire.dumps(obj)
    writer.write(_LEN.pack(len(data)) + data)
    await writer.drain()


async def _recv_frame(reader: asyncio.StreamReader):
    head = await reader.readexactly(_LEN.size)
    (n,) = _LEN.unpack(head)
    if n > _MAX_FRAME:
        raise ConnectionError(f"cluster frame too large: {n}")
    try:
        return wire.loads(await reader.readexactly(n))
    except wire.WireError as e:
        # malformed/hostile frame: drop the link (the peer handler's
        # ConnectionError path), never anything worse — decode is
        # data-only by construction
        raise ConnectionError(f"bad cluster frame: {e}") from e


class SocketTransport(Transport):
    """TCP transport between OS-process nodes.

    One instance per node: ``serve()`` starts the listener (and the
    IO thread), ``register_peer`` records peer addresses (propagated
    cluster-wide by ``Cluster.join_remote``).
    """

    def __init__(self, name: str, host: str = "127.0.0.1",
                 port: int = 0, cookie: str = "emqxtpu",
                 call_timeout: float = 10.0,
                 config: Optional[ClusterConfig] = None) -> None:
        self.name = name
        self.host = host
        self.port = port           # actual port known after serve()
        self.cookie = cookie
        self.config = config
        if config is not None:
            call_timeout = config.call_timeout_s
        self.call_timeout = call_timeout
        # heartbeat failure detector. None config or detector=false
        # keeps the EOF-only paths exactly:
        # no detector task, no suspect state, no fast-fail, no
        # bounded-coroutine calls, no redial backoff
        self._hb_enabled = bool(config is not None and config.detector)
        self._health: Dict[str, _PeerHealth] = {}
        self._hb_inflight: set = set()
        # event counters drained by Cluster.drain_counters → Metrics
        self._counters: Dict[str, int] = {}
        self._counters_lock = threading.Lock()
        # chaos scoping for the net.* fault points: a multi-node-in-
        # one-process test severs SPECIFIC links by naming the peers
        # this transport's net faults apply to (None = all peers —
        # the production one-node-per-process case), and picks which
        # node a peer.wedge arm wedges via fault_local
        self.fault_peers: Optional[set] = None
        self.fault_local = True
        self.cluster = None        # set by Cluster's constructor
        self._peers: Dict[str, Tuple[str, int]] = {}
        self._conns: Dict[Tuple[str, int], tuple] = {}  # addr -> (r, w, lock)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._owner_loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._started = threading.Event()
        self._probing: set = set()      # peers with a probe in flight
        # strong refs to spawned tasks (asyncio keeps only weak ones
        # — an untracked task can be GC'd mid-flight); shutdown
        # cancels via all_tasks(), so these are anchors, not the
        # cancellation roster
        self._probe_tasks: set = set()
        self._peer_tasks: set = set()   # inbound _on_peer handlers
        self._closing = False
        # cast coalescing (one IO-loop wakeup + one drain() PER
        # forwarded message would serialize the cross-node path):
        # casts serialize (the data-only wire codec) in the caller's
        # thread, buffer per peer,
        # and one scheduled flush writes the whole burst with a
        # single drain per peer
        self._cast_buf: Dict[Tuple[str, int], bytearray] = {}
        self._cast_lock = threading.Lock()
        self._cast_flush_scheduled = False
        self._cast_flushing: set = set()  # addrs with a flush task
        self._cast_pending = 0  # inbound casts queued on owner loop

    _CAST_BUF_MAX = 32 * 1024 * 1024  # per-peer outbound cast buffer

    # -- lifecycle ---------------------------------------------------------

    def serve(self) -> Tuple[str, int]:
        """Start the IO thread + listener; returns the bound addr.
        Captures the caller's running loop (if any) as the owner loop
        for inbound dispatch."""
        try:
            self._owner_loop = asyncio.get_running_loop()
        except RuntimeError:
            self._owner_loop = None
        self._thread = threading.Thread(
            target=self._io_main, daemon=True,
            name=f"cluster-io-{self.name}")
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise ConnectionError("cluster transport failed to start")
        return self.host, self.port

    def _io_main(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def boot():
            self._server = await asyncio.start_server(
                self._on_peer, self.host, self.port)
            self.port = self._server.sockets[0].getsockname()[1]
            if self._hb_enabled:
                self._track(
                    self._loop.create_task(self._detector_loop()),
                    self._probe_tasks)
            self._started.set()

        self._loop.run_until_complete(boot())
        try:
            self._loop.run_forever()
        finally:
            self._loop.close()

    def close(self) -> None:
        if self._loop is None or self._closing:
            return  # idempotent: a second close() is a no-op
        # set BEFORE the shutdown callback runs: an _on_peer EOF
        # firing during the cancel/gather must not spawn a fresh
        # probe task that escapes it
        self._closing = True

        async def _shutdown():
            if self._server is not None:
                self._server.close()
            # best-effort drain of casts buffered BEFORE close():
            # leave()'s nodedown announcements ride the cast buffer,
            # and the _closing gate stops the normal flush machinery
            # — without this, a peer only learns of our departure
            # via the slower link-monitor path. Bounded per peer.
            with self._cast_lock:
                addrs = [a for a, b in self._cast_buf.items() if b]
            if addrs:
                try:
                    # all peers concurrently under ONE overall bound:
                    # close() joins the IO thread with a 5s budget,
                    # and N black-holed peers at 1s each serially
                    # would blow it (leaving the loop live forever —
                    # _closing makes a retry a no-op)
                    await asyncio.wait_for(asyncio.gather(
                        *(self._flush_once(a) for a in addrs),
                        return_exceptions=True), 2.0)
                except BaseException:
                    pass
            # cancel EVERY task on this (transport-private) loop, not
            # a bucket snapshot: a connection accepted just before
            # close() spawns its handler task after the snapshot
            # would be taken, and a racing cast() can schedule a
            # fresh flush — both would be destroyed-while-pending.
            # Loop until quiescent (each gather can run scheduled
            # callbacks that spawn more tasks); bounded — _closing
            # gates new probe spawns and the server accepts nothing.
            me = asyncio.current_task()
            for _ in range(10):
                pending = [t for t in asyncio.all_tasks(self._loop)
                           if t is not me and not t.done()]
                if not pending:
                    break
                for task in pending:
                    task.cancel()
                # cancel() only schedules the CancelledError; the
                # tasks must actually unwind before the loop stops,
                # or loop.close() still reports them destroyed-
                # while-pending
                await asyncio.gather(*pending, return_exceptions=True)
            for _, w, _l in list(self._conns.values()):
                try:
                    w.close()
                except Exception:
                    pass
            self._conns.clear()
            self._loop.stop()

        try:
            coro = _shutdown()
            try:
                asyncio.run_coroutine_threadsafe(coro, self._loop)
            except Exception:
                coro.close()  # loop already gone: don't leak a
                raise         # never-awaited coroutine warning
            self._thread.join(timeout=5)
        except Exception:
            pass

    # -- address book ------------------------------------------------------

    def register_peer(self, node: str, host: str, port: int) -> None:
        prev = self._peers.get(node)
        self._peers[node] = (host, port)
        if prev is not None and prev != (host, port):
            # a fresh incarnation at a new address must not inherit
            # casts buffered for the old one
            with self._cast_lock:
                self._cast_buf.pop(prev, None)
        # an explicit (re)registration — a join — clears any departed
        # mark and gives the detector a clean slate for the peer
        h = self._health.get(node)
        if h is not None and (h.departed or prev != (host, port)):
            self._health[node] = _PeerHealth()

    def addr_book(self) -> Dict[str, Tuple[str, int]]:
        book = dict(self._peers)
        book[self.name] = (self.host, self.port)
        return book

    def local_ip_for(self, addr: Tuple[str, int]) -> Optional[str]:
        """The local interface IP a connection to ``addr`` uses —
        the routable self-advertisement when bound to a wildcard."""
        async def _sockname():
            _, writer, _ = await self._connect(addr)
            sn = writer.get_extra_info("sockname")
            return sn[0] if sn else None

        try:
            return asyncio.run_coroutine_threadsafe(
                _sockname(), self._loop).result(timeout=self.call_timeout)
        except (Exception, asyncio.CancelledError):
            # CancelledError (BaseException): shutdown's task sweep —
            # same best-effort None as any other failure here
            return None

    # -- failure detector ---------------------------------------------------

    def _count(self, key: str, n: int = 1) -> None:
        with self._counters_lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def drain_counters(self) -> Dict[str, int]:
        with self._counters_lock:
            out = dict(self._counters)
            self._counters.clear()
        return out

    def _health_of(self, name: str) -> _PeerHealth:
        h = self._health.get(name)
        if h is None:
            h = self._health[name] = _PeerHealth()
        return h

    def peer_state(self, node: str) -> str:
        if not self._hb_enabled:
            return _OK
        h = self._health.get(node)
        return h.state if h is not None else _OK

    def health_info(self) -> Dict[str, dict]:
        return {name: {"state": h.state, "rtt_ms": h.rtt_ms,
                       "misses": h.misses, "since": h.since,
                       "departed": h.departed}
                for name, h in self._health.items()}

    def set_departed(self, node: str) -> None:
        if not self._hb_enabled:
            return
        h = self._health_of(node)
        h.departed = True

    def _fault_on(self, name) -> bool:
        """Does an armed net.* fault apply to this peer? (chaos
        scoping for multi-node-in-one-process tests)"""
        return self.fault_peers is None or name in self.fault_peers

    def _name_of_addr(self, addr) -> Optional[str]:
        for n, a in self._peers.items():
            if a == addr:
                return n
        return None

    def _drop_conn(self, addr, writer) -> None:
        """Drop the link ``writer`` belongs to so the next writer
        redials — a call abandoned by its deadline may receive its
        reply LATE, and a stale reply left in the stream would desync
        the next call. Called only under the link's lock by the writer
        whose frame went unanswered (``_request``), never under
        another writer's feet."""
        ent = self._conns.get(addr)
        if ent is not None and ent[1] is writer:
            del self._conns[addr]
        try:
            writer.close()
        except Exception:
            pass

    async def _detector_loop(self) -> None:
        """One heartbeat round per interval: ping every member peer
        over the existing link; probe DOWN peers (bounded by redial
        backoff) for reappearance."""
        cfg = self.config
        try:
            while not self._closing:
                await asyncio.sleep(cfg.heartbeat_interval_s)
                if self._closing:
                    return
                cl = self.cluster
                if cl is None:
                    continue
                members = set(getattr(cl, "members", ()))
                for name, addr in list(self._peers.items()):
                    h = self._health_of(name)
                    if h.departed or name in self._hb_inflight:
                        continue
                    if name not in members and h.state != _DOWN:
                        continue  # not a member, nothing to watch
                    self._hb_inflight.add(name)
                    self._track(self._loop.create_task(
                        self._heartbeat(name, addr)),
                        self._probe_tasks)
        except asyncio.CancelledError:
            pass

    async def _heartbeat(self, name: str, addr) -> None:
        cfg = self.config
        try:
            h = self._health_of(name)
            if h.state == _DOWN:
                # reappearance probe, paced by exponential backoff
                if self._loop.time() < h.next_dial:
                    return
                if await self._probe_once(addr, name=name):
                    self._peer_reappeared(name, addr)
                else:
                    h.dial_fails += 1
                    h.next_dial = self._loop.time() + min(
                        cfg.redial_backoff_max_s,
                        cfg.redial_backoff_s
                        * (2 ** min(h.dial_fails, 6)))
                return
            t0 = time.perf_counter()
            try:
                res = await asyncio.wait_for(
                    self._request(addr, "ping", ()),
                    cfg.heartbeat_timeout_s)
                ok = res == "pong"
            except asyncio.TimeoutError:
                # a ping that went out unanswered dropped its link in
                # _request; one still waiting for the link (a call or a
                # cast burst holds it) sent nothing and drops nothing
                ok = False
            except (ConnectionError, OSError, EOFError,
                    asyncio.IncompleteReadError):
                ok = False
            if ok:
                self._note_hb_ok(name, (time.perf_counter() - t0)
                                 * 1000.0)
            else:
                self._note_hb_miss(name)
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("heartbeat to %s failed unexpectedly", name)
        finally:
            self._hb_inflight.discard(name)

    def _note_hb_ok(self, name: str, rtt_ms: float) -> None:
        h = self._health_of(name)
        h.rtt_ms = rtt_ms
        h.misses = 0
        h.dial_fails = 0
        if h.state == _SUSPECT:
            h.oks += 1
            if h.oks >= self.config.ok_after:
                h.state = _OK
                h.since = time.time()
                h.oks = 0
                log.warning("peer %s recovered: suspect -> ok", name)
                # unpark any casts buffered while suspect
                self._spawn_cast_flush()

    def _note_hb_miss(self, name: str) -> None:
        cfg = self.config
        h = self._health_of(name)
        h.oks = 0
        h.misses += 1
        if h.state == _OK and h.misses >= cfg.suspect_after:
            h.state = _SUSPECT
            h.since = time.time()
            self._count("hb.suspects")
            log.warning("peer %s missed %d heartbeats: ok -> suspect "
                        "(casts parked, nothing purged)", name,
                        h.misses)
        if h.state == _SUSPECT and h.misses >= cfg.down_after:
            self._track(self._loop.create_task(
                self._declare_down(name)), self._probe_tasks)

    async def _declare_down(self, name: str) -> None:
        h = self._health_of(name)
        if h.state == _DOWN:
            return
        h.state = _DOWN
        h.since = time.time()
        h.oks = 0
        h.dial_fails = 0
        h.next_dial = self._loop.time() + self.config.redial_backoff_s
        self._count("hb.downs")
        addr = self._peers.get(name)
        # the dead peer's buffered casts are state mutations from
        # BEFORE the death — replaying them into a rejoined
        # incarnation would resurrect what nodedown purges (same
        # contract as the EOF-only probe path)
        with self._cast_lock:
            self._cast_buf.pop(addr, None)
        log.warning("peer %s declared DOWN by the failure detector",
                    name)
        try:
            await self._dispatch("nodedown", (name,))
        except Exception:
            log.exception("nodedown dispatch for %s failed", name)

    def _peer_reappeared(self, name: str, addr) -> None:
        """A downed peer answered a probe (or dialed in): clear the
        detector state and hand the rejoin to the cluster's auto-heal
        worker (membership re-merge + anti-entropy)."""
        h = self._health_of(name)
        h.state = _OK
        h.since = time.time()
        h.misses = h.oks = h.dial_fails = 0
        self._count("hb.reappears")
        log.warning("peer %s reappeared; scheduling auto-heal", name)
        cl = self.cluster
        if cl is not None:
            try:
                cl.schedule_heal(name)
            except Exception:
                log.exception("heal scheduling for %s failed", name)

    # -- outbound ----------------------------------------------------------

    def cast(self, node: str, op: str, *args) -> None:
        """Fire-and-forget (gen_rpc async cast): buffer and return —
        the publish path must never block on a peer. A burst of casts
        (a batch tail forwarding to a peer) coalesces into ONE loop
        wakeup and one write+drain per peer; encoding happens in the
        caller's thread so the IO loop only moves bytes. Raises only
        for an unknown node; a dead peer is detected by the link
        monitor (EOF → probe → nodedown), not by the sender."""
        addr = self._peers.get(node)
        if addr is None:
            raise ConnectionError(f"unknown node: {node}")
        if self._closing:
            return  # fire-and-forget: a cast racing shutdown drops
        data = wire.dumps((_CAST, 0, (op, args)))
        with self._cast_lock:
            buf = self._cast_buf.setdefault(addr, bytearray())
            if len(buf) >= self._CAST_BUF_MAX:
                # the peer link is wedged and the flush can't drain:
                # shed new casts instead of growing without bound
                # (gen_rpc's async cast is at-most-once the same way;
                # QoS1 recovers via client retransmit, and the link
                # monitor will declare nodedown). Counted: at-most-
                # once loss must be observable, not a log line —
                # the stats tick folds this into
                # ``cluster.forward.dropped`` + the
                # ``cluster_forward_dropped`` alarm
                self._count("forward.dropped")
                log.warning("cast buffer to %s full; dropping %s",
                            addr, op)
                return
            buf.extend(_LEN.pack(len(data)) + data)
            wake = not self._cast_flush_scheduled
            self._cast_flush_scheduled = True
        if wake:
            try:
                self._loop.call_soon_threadsafe(self._spawn_cast_flush)
            except RuntimeError:  # loop closed under the race window
                pass

    def _spawn_cast_flush(self) -> None:
        # closing: a cast() racing shutdown must not spawn a flush
        # task between the quiescence loop's gather rounds — the
        # sweep's boundedness depends on nothing new being scheduled
        if self._closing:
            return
        # one INDEPENDENT task per peer: a backpressured peer parking
        # in drain() must not head-of-line-block healthy peers. The
        # in-flight set guarantees at most ONE flush task per peer —
        # a wedged peer parks one task, not one per wakeup. Bytes
        # stay in _cast_buf until a writer holds the conn lock (see
        # _flush_once / _request), and a failed write REQUEUES its
        # claim at the front, so cast-before-call ordering has no
        # claim window even across the redial retry.
        with self._cast_lock:
            addrs = [a for a in self._cast_buf
                     if a not in self._cast_flushing]
            self._cast_flushing.update(addrs)
            self._cast_flush_scheduled = False
        if self._hb_enabled:
            # suspect peers PARK their casts: the buffer holds (the
            # blip may clear) instead of burning redials — flushed by
            # the suspect → ok transition; dropped whole on → down
            parked = [a for a in addrs
                      if self.peer_state(self._name_of_addr(a)) != _OK]
            if parked:
                with self._cast_lock:
                    self._cast_flushing.difference_update(parked)
                addrs = [a for a in addrs if a not in parked]
        for addr in addrs:
            self._track(self._loop.create_task(self._flush_addr(addr)),
                        self._probe_tasks)

    @staticmethod
    def _track(task, bucket: set) -> None:
        """Anchor a spawned task (asyncio holds only weak refs) and
        drop the anchor when it finishes."""
        bucket.add(task)
        task.add_done_callback(bucket.discard)

    def _take_cast_buf(self, addr) -> bytes:
        """Atomically claim any buffered casts for ``addr`` (a call
        about to write on the same link drains them first, keeping
        the cast-before-call ordering per peer)."""
        with self._cast_lock:
            buf = self._cast_buf.pop(addr, None)
        return bytes(buf) if buf else b""

    def _requeue_cast_buf(self, addr, pending: bytes) -> None:
        """Return a claimed-but-unsent burst to the FRONT of the
        buffer so casts issued meanwhile stay behind it. The cap is
        re-enforced here: claimed bytes don't show in _cast_buf, so
        a flapping peer could otherwise grow claimed+refilled by one
        cap per failed write cycle. Both segments are whole frames —
        dropping the NEWER segment (like cast()'s shed) keeps the
        stream frame-aligned."""
        with self._cast_lock:
            buf = self._cast_buf.get(addr)
            merged = bytearray(pending)
            if buf:
                if len(pending) + len(buf) <= self._CAST_BUF_MAX:
                    merged += buf
                else:
                    log.warning(
                        "cast requeue to %s over cap; dropping %d "
                        "newer bytes", addr, len(buf))
            self._cast_buf[addr] = merged

    async def _flush_addr(self, addr) -> None:
        try:
            while True:
                ok = await self._flush_once(addr)
                with self._cast_lock:
                    if not ok or not self._cast_buf.get(addr):
                        self._cast_flushing.discard(addr)
                        return
                # more casts were buffered while we wrote: go again
        except BaseException:
            with self._cast_lock:
                self._cast_flushing.discard(addr)
            raise

    async def _flush_once(self, addr) -> bool:
        """One delivery attempt (+ one redial retry for a stale
        cached link). IncompleteReadError from a half-open hello is
        an EOFError, hence the broad catch."""
        for attempt in (0, 1):
            try:
                reused = addr in self._conns
                _, writer, lock = await self._connect(addr)
                async with lock:
                    if writer.is_closing():
                        # dropped while we waited for it: bytes written
                        # now could die with it (a late reply to the
                        # drop's unanswered frame resets the socket)
                        raise ConnectionError(f"link to {addr} dropped")
                    pending = self._take_cast_buf(addr)
                    if not pending:
                        return True  # a call on this link drained us
                    if _faults.enabled \
                            and self._fault_on(self._name_of_addr(addr)):
                        # net.delay (stall) slows the write; net.drop
                        # discards the claimed burst as if sent — the
                        # at-most-once loss the anti-entropy sweep
                        # exists to repair; net.partition fails the
                        # established link
                        _faults.fire("net.delay")
                        if _faults.fire("net.drop"):
                            self._count("forward.dropped")
                            return True
                        if _faults.fire("net.partition"):
                            self._requeue_cast_buf(addr, pending)
                            raise ConnectionError(
                                f"injected partition to {addr}")
                    try:
                        writer.write(pending)
                        await writer.drain()
                    except BaseException:
                        # includes CancelledError: the shutdown
                        # drain's wait_for cancels mid-write, and the
                        # claimed frames must go back or the
                        # best-effort drain silently loses them
                        self._requeue_cast_buf(addr, pending)
                        raise
                return True
            except (ConnectionError, OSError, EOFError) as e:
                self._conns.pop(addr, None)
                if attempt == 0 and reused:
                    # stale cached link: redial once and resend (a dead
                    # cached socket normally delivered nothing, so the
                    # dup risk is confined to a rare mid-write failure)
                    continue
                # bytes stay buffered (bounded by the cap): the link
                # monitor decides the peer's fate; a later cast or
                # reconnect retries them in order
                log.debug("cast flush to %s failed: %s", addr, e)
                return False
        return False

    def call(self, node: str, op: str, *args):
        addr = self._peers.get(node)
        if addr is None:
            raise ConnectionError(f"unknown node: {node}")
        if self._hb_enabled and self.config.suspect_fast_fail:
            # suspect-aware fast-fail: no broker path (locker quorum,
            # takeover, discard) ever blocks call_timeout on a peer
            # the detector already holds unhealthy. Raised WITHOUT
            # touching the wire; heal/probe traffic goes via
            # call_addr/_probe_once, which bypass this gate
            st = self.peer_state(node)
            if st != _OK:
                self._count("rpc.fastfail")
                raise PeerUnavailableError(node, st)
        return self.call_addr(addr, op, *args)

    def call_addr(self, addr: Tuple[str, int], op: str, *args):
        """Call a peer by raw address (used before its name is known
        — the join handshake — and by heal/anti-entropy traffic,
        which must reach peers the fast-fail gate would refuse)."""
        if self._hb_enabled:
            # bounded cluster RPC: the deadline also cancels the
            # COROUTINE (releasing the link lock + dropping the conn)
            # — the bare fut.result timeout below leaves it holding
            # the per-link lock forever against a wedged peer
            coro = self._request_bounded(addr, op, args)
        else:
            coro = self._request(addr, op, args)
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        try:
            return fut.result(timeout=self.call_timeout)
        except (ConnectionError, asyncio.TimeoutError, OSError,
                asyncio.IncompleteReadError, TimeoutError,
                _futures.TimeoutError,  # ≠ builtin TimeoutError <3.11
                asyncio.CancelledError) as e:
            # CancelledError: close()'s all-task sweep cancelled the
            # in-flight request — callers were promised a
            # ConnectionError on shutdown, and CancelledError is a
            # BaseException that would sail through their handlers
            raise ConnectionError(f"call {op} to {addr} failed: {e}") from e

    async def _request_bounded(self, addr, op, args):
        """``_request`` under the per-peer deadline: on expiry a call
        that went out has its link dropped (``_request``: a late reply
        must never desync the next call's frame stream) and the caller
        gets the promised ConnectionError."""
        try:
            return await asyncio.wait_for(
                self._request(addr, op, args), self.call_timeout)
        except asyncio.TimeoutError:
            raise ConnectionError(
                f"call {op} to {addr} timed out "
                f"after {self.call_timeout}s") from None

    async def _connect(self, addr: Tuple[str, int]):
        ent = self._conns.get(addr)
        if ent is not None and not ent[1].is_closing():
            return ent
        if _faults.enabled and self._fault_on(self._name_of_addr(addr)) \
                and _faults.fire("net.partition"):
            raise ConnectionError(f"injected partition to {addr}")
        if self._hb_enabled:
            # exponential redial backoff: a dead peer costs one dial
            # per backoff window, not one per caller
            h = self._health.get(self._name_of_addr(addr) or "")
            if h is not None and h.dial_fails \
                    and self._loop.time() < h.next_dial:
                raise ConnectionError(
                    f"redial to {addr} backing off")
        try:
            reader, writer = await asyncio.open_connection(*addr)
        except (ConnectionError, OSError):
            self._note_dial_failed(addr)
            raise
        # data-plane hello: 2-tuple (the probe flag defaults False
        # receiver-side; only probe dials carry the third field)
        await _send_frame(writer, (_HELLO, 0, (self.name, self.cookie)))
        kind, _, ok = await _recv_frame(reader)
        if kind != _REPLY or not ok:
            writer.close()
            raise ConnectionError(f"cluster hello rejected by {addr}")
        ent = (reader, writer, asyncio.Lock())
        self._conns[addr] = ent
        if self._hb_enabled:
            h = self._health.get(self._name_of_addr(addr) or "")
            if h is not None:
                h.dial_fails = 0
        return ent

    def _note_dial_failed(self, addr) -> None:
        if not self._hb_enabled:
            return
        name = self._name_of_addr(addr)
        if name is None:
            return
        h = self._health_of(name)
        h.dial_fails += 1
        h.next_dial = self._loop.time() + min(
            self.config.redial_backoff_max_s,
            self.config.redial_backoff_s
            * (2 ** min(h.dial_fails, 6)))

    async def _send(self, addr, frame) -> None:
        reader, writer, lock = await self._connect(addr)
        try:
            async with lock:
                await _send_frame(writer, frame)
        except (ConnectionError, OSError):
            self._conns.pop(addr, None)
            raise

    async def _request(self, addr, op, args):
        while True:
            reader, writer, lock = await self._connect(addr)
            if _faults.enabled and self._fault_on(self._name_of_addr(addr)):
                _faults.fire("net.delay")
                if _faults.fire("net.partition"):
                    self._conns.pop(addr, None)
                    try:
                        writer.close()
                    except Exception:
                        pass
                    raise ConnectionError(f"injected partition to {addr}")
            try:
                async with lock:  # one in-flight call per link: serialize
                    if writer.is_closing():
                        # dropped while we waited for it: redial (see
                        # _flush_once)
                        continue
                    pending = self._take_cast_buf(addr)
                    try:
                        if pending:
                            # casts issued before this call go first on
                            # the wire (the locker's release-then-acquire
                            # pattern depends on per-peer cast/call
                            # ordering)
                            writer.write(pending)
                        await _send_frame(writer, (_CALL, 1, (op, args)))
                        while True:
                            kind, _, payload = await _recv_frame(reader)
                            if kind == _REPLY:
                                return payload
                            if kind == _ERR:
                                raise RuntimeError(
                                    f"remote error: {payload}")
                    except asyncio.CancelledError:
                        # a deadline (the heartbeat's or the call's)
                        # expired after this frame went out: drop the
                        # link here, still holding it, so no other
                        # writer's bytes are on it. A deadline that
                        # expires while the call waits for the lock
                        # above sent nothing and leaves the link to the
                        # writer that holds it (dropping it there cut
                        # that writer's call or cast burst short)
                        self._drop_conn(addr, writer)
                        raise
            except (ConnectionError, OSError, asyncio.IncompleteReadError):
                self._conns.pop(addr, None)
                raise

    # -- inbound -----------------------------------------------------------

    async def _on_peer(self, reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task is not None:
            self._track(task, self._peer_tasks)
        peer = writer.get_extra_info("peername")
        name = None
        try:
            kind, _, hello = await _recv_frame(reader)
            if _faults.enabled and self.fault_local \
                    and _faults.fire("peer.wedge"):
                # wedged-but-connected: TCP stays up, frames are
                # swallowed, nothing ever replies — the failure mode
                # only a heartbeat detector can see
                while True:
                    await _recv_frame(reader)
            name, cookie = hello[0], hello[1]
            is_probe = bool(hello[2]) if len(hello) > 2 else False
            if kind != _HELLO or cookie != self.cookie:
                name = None
                await _send_frame(writer, (_REPLY, 0, False))
                return
            if _faults.enabled and name is not None \
                    and self._fault_on(name) \
                    and _faults.fire("net.partition"):
                name = None
                return  # inbound side of an injected partition
            if is_probe:
                # a liveness probe's disconnect is expected, never a
                # link-drop signal
                name = None
            await _send_frame(writer, (_REPLY, 0, True))
            if name is not None and self._hb_enabled \
                    and name in self._peers:
                # an incoming data link from a DOWN peer is a
                # reappearance: trigger auto-heal without waiting for
                # our own probe cycle to find it
                h = self._health_of(name)
                if h.state == _DOWN and not h.departed:
                    self._peer_reappeared(name, self._peers.get(name))
            while True:
                kind, req, (op, args) = await _recv_frame(reader)
                if _faults.enabled and self.fault_local \
                        and _faults.fire("peer.wedge"):
                    continue  # swallow the frame: wedged, no reply
                if _faults.enabled and self._fault_on(name) \
                        and name is not None \
                        and _faults.fire("net.partition"):
                    return  # sever the inbound link mid-stream
                if kind == _CAST:
                    try:
                        if not self._dispatch_cast(op, args, peer):
                            # cap reached (or loop-less node): the
                            # AWAITED path — stalls only this link's
                            # frame loop, so TCP backpressure reaches
                            # the sender while other links stay live
                            await self._dispatch(op, args)
                    except Exception:
                        log.exception("cast %s from %s failed", op, peer)
                elif kind == _CALL:
                    try:
                        res = await self._dispatch(op, args)
                        await _send_frame(writer, (_REPLY, req, res))
                    except Exception as e:
                        log.exception("call %s from %s failed", op, peer)
                        await _send_frame(writer, (_ERR, req, repr(e)))
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass
            # Erlang-distribution semantics: losing an established
            # link from a peer signals nodedown (a TCP write to a
            # dead peer doesn't error until the retransmit gives up,
            # so cast failure alone detects death far too late). But
            # a transient drop (idle middlebox reset) must NOT purge
            # a live member — probe before declaring death. With the
            # heartbeat detector on, the drop only marks the peer
            # SUSPECT (casts park, nothing purged) and the detector's
            # own miss window decides down.
            if name is not None and self.cluster is not None \
                    and name in self._peers and not self._closing:
                if self._hb_enabled:
                    self._note_link_drop(name)
                elif name not in self._probing:
                    coro = self._probe_then_nodedown(name)
                    try:
                        self._track(self._loop.create_task(coro),
                                    self._probe_tasks)
                    except RuntimeError:  # transport shutting down
                        coro.close()

    def _note_link_drop(self, name: str) -> None:
        """Detector-mode link-drop handling: an established link
        dying demotes the peer straight to suspect (hysteresis down
        would be wasted on a signal this strong) but NEVER to down —
        a transient blip must not purge a live member."""
        h = self._health_of(name)
        if h.state == _OK:
            h.oks = 0
            h.misses = max(h.misses, self.config.suspect_after)
            h.state = _SUSPECT
            h.since = time.time()
            self._count("hb.suspects")
            log.warning("link to %s dropped: ok -> suspect "
                        "(casts parked, nothing purged)", name)

    async def _probe_then_nodedown(self, name: str) -> None:
        if name in self._probing:
            return  # one probe per peer: a storm of link drops must
            # not fan out into a storm of probes
        self._probing.add(name)
        try:
            addr = self._peers.get(name)
            for attempt in range(3):
                if await self._probe_once(addr, name=name):
                    return  # alive: the drop was transient
                await asyncio.sleep(0.3 * (attempt + 1))
            # the peer is dead: its buffered casts are state
            # mutations from BEFORE the death — replaying them into
            # a rejoined incarnation would resurrect exactly what
            # handle_nodedown purges (and a never-returning peer
            # would leak the buffer forever)
            with self._cast_lock:
                self._cast_buf.pop(addr, None)
            try:
                await self._dispatch("nodedown", (name,))
            except Exception:
                log.exception("nodedown dispatch for %s failed", name)
        finally:
            self._probing.discard(name)

    async def _probe_once(self, addr, name: Optional[str] = None) -> bool:
        """Liveness ping over a DEDICATED throwaway connection. The
        cached data connection must not be touched: closing it to
        force a fresh dial would drop the peer's inbound link, firing
        the peer's own probe against us — a mutual probe/close storm
        that can sever a call in flight.

        The hello carries the probe flag (the peer must not treat
        this connection's close as a link drop, or every probe close
        would fire a counter-probe). Cluster peers are assumed
        co-versioned — the link is cookie-gated and frames carry the
        data-only wire codec (no pickle, no code on the wire), but
        mixed-version clusters remain out of contract; there is no
        older-hello fallback (one would bring back a probe storm or
        double the dead-peer detection latency)."""
        writer = None
        if _faults.enabled and self._fault_on(
                name if name is not None else self._name_of_addr(addr)) \
                and _faults.fire("net.partition"):
            return False
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(*addr), timeout=3.0)
            await _send_frame(writer, (_HELLO, 0,
                                       (self.name, self.cookie, True)))
            kind, _, ok = await asyncio.wait_for(_recv_frame(reader), 3.0)
            if kind != _REPLY or not ok:
                return False
            await _send_frame(writer, (_CALL, 1, ("ping", ())))
            kind, _, payload = await asyncio.wait_for(
                _recv_frame(reader), 3.0)
            return kind == _REPLY and payload == "pong"
        except Exception:
            return False
        finally:
            if writer is not None:
                try:
                    writer.close()
                except Exception:
                    pass

    # inbound casts in flight on the owner loop; past the cap the
    # reader falls back to the awaited path, which stalls the frame
    # loop and lets TCP backpressure reach the sender (taking that
    # path for EVERY cast — one owner-loop round-trip per frame —
    # would serialize the whole inbound forward path)
    _CAST_PENDING_MAX = 1024

    def _dispatch_cast(self, op: str, args, peer) -> bool:
        """Fire-and-forget inbound cast: schedule on the owner loop
        WITHOUT awaiting the round-trip, so the frame loop keeps
        reading the burst. call_soon_threadsafe is FIFO per loop —
        forward ordering is preserved. Returns False when the caller
        must take the awaited ``_dispatch`` path instead (pending cap
        reached, control-plane op, or loop-less node)."""
        if self.cluster is None:
            raise RuntimeError("transport not attached to a cluster")
        owner = self._owner_loop
        if op not in _OWNER_OPS or owner is None or not owner.is_running():
            return False
        with self._cast_lock:
            if self._cast_pending >= self._CAST_PENDING_MAX:
                return False
            self._cast_pending += 1

        def _run(op=op, args=args):
            with self._cast_lock:
                self._cast_pending -= 1
            try:
                self.cluster.handle_rpc(op, *args)
            except Exception:
                log.exception("cast %s from %s failed", op, peer)

        owner.call_soon_threadsafe(_run)
        return True

    async def _dispatch(self, op: str, args):
        """Run one inbound RPC.

        Control-plane ops touch only lock-guarded router/cluster
        state and run directly on the IO thread — crucially, they
        stay serviceable while the owner loop is blocked in a
        synchronous outbound ``call`` (two nodes joining each other
        simultaneously would otherwise deadlock until timeout).
        Data/session ops (forwards, takeover, discard) mutate session
        state whose wakeups must land on the node's serving loop, so
        they trampoline there."""
        if self.cluster is None:
            raise RuntimeError("transport not attached to a cluster")
        if op not in _OWNER_OPS:
            return self.cluster.handle_rpc(op, *args)
        owner = self._owner_loop
        if owner is not None and owner.is_running():
            cfut: "asyncio.Future" = self._loop.create_future()

            def _run():
                try:
                    res = self.cluster.handle_rpc(op, *args)
                    self._loop.call_soon_threadsafe(
                        cfut.set_result, res)
                except Exception as e:
                    self._loop.call_soon_threadsafe(cfut.set_exception, e)

            owner.call_soon_threadsafe(_run)
            return await cfut
        if op in _APPLY_OPS:
            # a node with no serving loop (a node driven without
            # start()) applies a hand-off chunk or a resync snapshot on
            # a worker thread: on the IO thread it stops this node's
            # heartbeat replies for the whole apply (a 256-session
            # failback chunk outlasts a 0.5 s ping deadline), the peer
            # declares it down, purges its routes and promotes again
            # over the hand-off. The JAX package applies them on the IO
            # thread (fault C.6)
            return await self._loop.run_in_executor(
                None, lambda: self.cluster.handle_rpc(op, *args))
        return self.cluster.handle_rpc(op, *args)


#: ops that touch per-session state: must run on the node's serving
#: loop. Everything else (membership, routes, registry, ping) is
#: lock-guarded and runs on the IO thread. ``repl_failback`` and
#: ``repl_hello`` belong here because both mutate ``cm._detached``
#: (failback/drain adoption re-applies pop-then-re-add; the hello's
#: stale-duplicate cleanup pops), which ``takeover_client`` does on the
#: serving loop.
_OWNER_OPS = frozenset(
    {"forward", "forward_shared", "discard_client", "takeover_client",
     "repl_failback", "repl_hello"})
#: of those, the bulk applies (a failback or drain hand-off chunk, a
#: resync snapshot): on a node with no serving loop they run on a
#: worker thread, not on the IO thread
_APPLY_OPS = frozenset({"repl_failback", "repl_hello"})
