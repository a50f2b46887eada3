"""Connection/session manager: clientid registry, session open with
clean-start/resume, takeover, discard, kick.

The port of the JAX package's ``ConnectionManager``
(``src/emqx_cm.erl``): ``open_session/3`` under a per-clientid lock
(:209-236) — a node-local mutex PLUS, when clustered, the distributed
quorum lock (:mod:`emqx_tpu_torch.cm_locker`: two nodes racing the
same clientid serialize cluster-wide, so exactly one session
survives), the takeover protocol (:244-272) with the cross-node
takeover through the cluster's registry, discard/kick (:274-326), and
the clientid→channel registry (emqx_cm_registry). Detached persistent
sessions are kept for their session expiry and swept by
:meth:`expire_sessions`; wills held back by Will-Delay-Interval live
here too. With durability on, a persistent session's detach and close
journal through :attr:`ConnectionManager.durability`.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Dict, Optional, Tuple

from emqx_tpu_torch.session import Session

log = logging.getLogger("emqx_tpu_torch.cm")

TAKEOVER_RC = 0x8E  # session taken over


class SessionUnavailableError(Exception):
    """The clientid's registered session owner is SUSPECT (unconfirmed
    by the failure detector): the session exists but cannot be pulled
    right now. The channel answers the CONNECT with ServerBusy — the
    client's retry lands after the detector settles the owner's fate
    (recovered → takeover; down → fresh session) — instead of minting
    a fresh session over a live one."""

    def __init__(self, client_id: str, owner: str) -> None:
        super().__init__(
            f"session owner {owner} of {client_id!r} is suspect")
        self.owner = owner


class ConnectionManager:
    def __init__(self, broker=None) -> None:
        self.broker = broker
        # set by Cluster: replicated clientid registry + remote
        # takeover/discard (emqx_cm_registry + emqx_rpc seam)
        self.cluster = None
        # durability layer (durability.py), wired by Node: persistent-
        # session detach/close transitions journal through it. None =
        # nothing journals
        self.durability = None
        self._lock = threading.Lock()
        self._locks: Dict[str, threading.Lock] = {}
        self._channels: Dict[str, object] = {}   # clientid -> live channel
        # clientid -> (detached Session, detach_ts, expiry_interval)
        self._detached: Dict[str, Tuple[Session, float, float]] = {}
        # clientid -> (timer handle, will Message) — wills held back by
        # Will-Delay-Interval (MQTT5 3.1.3.2.2)
        self._pending_wills: Dict[str, Tuple[object, object]] = {}

    def _client_lock(self, client_id: str) -> threading.Lock:
        with self._lock:
            lk = self._locks.get(client_id)
            if lk is None:
                lk = threading.Lock()
                self._locks[client_id] = lk
            return lk

    def _cluster_locker(self):
        return getattr(self.cluster, "locker", None) \
            if self.cluster is not None else None

    # -- registry ---------------------------------------------------------

    def register_channel(self, client_id: str, channel) -> None:
        self._channels[client_id] = channel

    def unregister_channel(self, client_id: str, channel=None) -> None:
        cur = self._channels.get(client_id)
        if channel is None or cur is channel:
            self._channels.pop(client_id, None)

    def lookup_channel(self, client_id: str):
        return self._channels.get(client_id)

    def connection_count(self) -> int:
        return len(self._channels)

    # -- delayed wills (MQTT5 Will-Delay-Interval) ------------------------

    def schedule_will(self, client_id: str, msg, delay: float) -> None:
        """Hold the will back for ``delay`` seconds; a reconnect
        cancels it (spec: MUST NOT send if the connection is
        re-established first)."""
        self.cancel_will(client_id)
        try:
            loop = asyncio.get_running_loop()
            handle = loop.call_later(delay, self._fire_will, client_id)
        except RuntimeError:
            # no event loop (sync callers): a timer thread keeps the
            # delay's semantics
            timer = threading.Timer(delay, self._fire_will, (client_id,))
            timer.daemon = True
            timer.start()
            handle = timer
        with self._lock:
            self._pending_wills[client_id] = (handle, msg)

    def _fire_will(self, client_id: str) -> None:
        """Timer expiry: publish the delayed will, unless the client
        reconnected while the timer was in flight (checked under the
        registry lock)."""
        with self._lock:
            if self._channels.get(client_id) is not None:
                self._pending_wills.pop(client_id, None)
                return  # re-established: the will is void
            ent = self._pending_wills.pop(client_id, None)
        if ent is not None and self.broker is not None:
            self.broker.publish_will(ent[1])

    def cancel_will(self, client_id: str, fire: bool = False) -> None:
        """Drop a pending will; ``fire=True`` publishes it instead
        (the session ended before the delay elapsed)."""
        with self._lock:
            ent = self._pending_wills.pop(client_id, None)
        if ent is None:
            return
        handle, msg = ent
        handle.cancel()
        if fire and self.broker is not None:
            self.broker.publish_will(msg)

    # -- session lifecycle (emqx_cm:open_session) -------------------------

    def open_session(self, client_id: str, clean_start: bool,
                     channel, session_opts: Optional[dict] = None,
                     expiry_interval: float = 0.0
                     ) -> Tuple[Session, bool]:
        """Returns (session, session_present)."""
        with self._client_lock(client_id):
            locker = self._cluster_locker()
            if locker is not None:
                locker.acquire(client_id)
            try:
                return self._open_session_locked(
                    client_id, clean_start, channel, session_opts)
            finally:
                if locker is not None:
                    locker.release(client_id)

    def _open_session_locked(self, client_id: str, clean_start: bool,
                             channel,
                             session_opts: Optional[dict]
                             ) -> Tuple[Session, bool]:
        old_chan = self._channels.get(client_id)
        if clean_start:
            # the old session ends now → a delay-held will fires now
            self.cancel_will(client_id, fire=True)
            if old_chan is not None and old_chan is not channel:
                self._kick(old_chan, discard=True)
            elif self.cluster is not None:
                loc = self.cluster.locate_client(client_id)
                if loc is not None and loc != self.cluster.name:
                    self.cluster.remote_discard(client_id, loc)
            stale = self._detached.pop(client_id, None)
            if stale is not None and self.broker is not None:
                self.broker.subscriber_down(stale[0])
            if stale is not None and self.durability is not None:
                # clean start discards the persistent session for
                # good — the journal must agree
                self.durability.session_closed(client_id)
            return self._fresh(client_id, True, channel, session_opts), False
        # resume: the connection is re-established, so a pending will
        # MUST NOT be sent (MQTT5 3.1.3.2.2)
        self.cancel_will(client_id)
        sess: Optional[Session] = None
        if old_chan is not None and old_chan is not channel:
            try:
                sess = self._takeover(old_chan)
            except RuntimeError as e:
                # the bounded cross-loop takeover expired (the owning
                # loop is wedged or dead): the old channel cannot be
                # reached from here — unregister it and give the client
                # a FRESH session rather than failing its CONNECT. A
                # recovered loop finds its channel unregistered and
                # shuts it down alone
                log.warning("takeover of %r timed out (%s): starting a "
                            "fresh session", client_id, e)
                if self.broker is not None:
                    self.broker.metrics.inc("overload.takeover.timeout")
                self.unregister_channel(client_id, old_chan)
                sess = None
        elif client_id in self._detached:
            repl = getattr(self.cluster, "replication", None) \
                if self.cluster is not None else None
            if repl is not None and repl.adopting(client_id):
                # adopted by a STILL-RUNNING hand-off (failback or
                # drain): this copy is an intermediate snapshot —
                # resuming it would make the finalize skip the
                # authoritative one (live wins) and drop its queued
                # messages with the source
                raise SessionUnavailableError(client_id,
                                              self.cluster.name)
            sess, _ts, _exp = self._detached.pop(client_id)
        elif self.cluster is not None:
            sess = self._remote_takeover(client_id)
        if sess is not None:
            self._register(client_id, channel)
            if self.broker is not None:
                sess.resume(self.broker)
            return sess, True
        return self._fresh(client_id, False, channel, session_opts), False

    def _remote_takeover(self, client_id: str) -> Optional[Session]:
        """The session may live on another node: pull it over
        (emqx_cm:takeover_session RPC path). A holder that no longer
        has the session answers with a forwarding marker and the chase
        follows the chain, bounded by the visited set; a SUSPECT owner
        is retried at most 3 times while the detector already reads it
        ok again, else the CONNECT is refused with ServerBusy
        (:class:`SessionUnavailableError`)."""
        loc = self.cluster.locate_client(client_id)
        visited = set()
        retries = 0
        sess = None
        while loc is not None and loc not in visited:
            if loc == self.cluster.name:
                ent = self._detached.pop(client_id, None)
                if ent is not None:
                    sess = ent[0]
                else:
                    # a takeover hand-out whose reply was lost parked
                    # the session here
                    sess = self.cluster.claim_parked(client_id)
                break
            res = self.cluster.remote_takeover(client_id, loc)
            if isinstance(res, dict) and "suspect" in res:
                # the named owner is SUSPECT — unconfirmed, the session
                # exists: minting a fresh session here loses it, and
                # blocking the serving loop is worse. The CLIENT's
                # retry paces the next attempt, after the detector's
                # hysteresis has settled the owner's fate
                retries += 1
                state = self.cluster.transport.peer_state(loc)
                if retries <= 3 and state == "ok":
                    continue  # blip already cleared: retry now
                log.warning("resume of %r deferred: owner %s is %s",
                            client_id, loc, state)
                raise SessionUnavailableError(client_id, loc)
            visited.add(loc)
            if isinstance(res, dict):
                loc = res.get("moved")
                continue
            sess = res
            if sess is not None:
                sess.client_id = client_id
            break
        if sess is None and visited:
            # the chase dead-ended: the client gets a fresh session
            # (availability); a registry that NAMED owners but produced
            # no session usually means a custody move raced this CONNECT
            log.warning("takeover chase for %r ended empty (visited %s, "
                        "last claim %r)", client_id, sorted(visited), loc)
        return sess

    def _register(self, client_id: str, channel) -> None:
        self._channels[client_id] = channel
        if self.cluster is not None:
            self.cluster.client_up(client_id)

    def _fresh(self, client_id: str, clean_start: bool, channel,
               opts: Optional[dict]) -> Session:
        sess = Session(client_id, broker=self.broker,
                       clean_start=clean_start, **(opts or {}))
        if self.broker is not None:
            self.broker.metrics.inc("session.created")
            self.broker.hooks.run("session.created",
                                  (client_id, sess.info()))
        self._register(client_id, channel)
        return sess

    #: bound on a channel call marshalled onto the channel's owning
    #: event loop from another thread (a takeover or kick of a session
    #: another front-door loop owns; the drain's redirect waves, which
    #: run on an executor thread): a wedged loop, or a crossed pair of
    #: opposite takeovers, fails the call with a clear error instead of
    #: blocking both loops forever
    XLOOP_CALL_TIMEOUT = 15.0

    def _call_channel(self, chan, fn):
        """Run ``fn()`` on the channel's owning event loop
        (``chan.owner_loop``, stamped by its connection): transports
        and session state belong to that loop. Same-loop and loop-less
        (sans-IO) channels run inline."""
        loop = getattr(chan, "owner_loop", None)
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if loop is None or loop is running or not loop.is_running():
            return fn()
        import concurrent.futures
        cf: concurrent.futures.Future = concurrent.futures.Future()

        def _run():
            try:
                cf.set_result(fn())
            except BaseException as e:  # marshal the failure back
                cf.set_exception(e)

        loop.call_soon_threadsafe(_run)
        try:
            return cf.result(timeout=self.XLOOP_CALL_TIMEOUT)
        except concurrent.futures.TimeoutError:
            raise RuntimeError(
                f"channel call for {getattr(chan, 'client_id', '?')!r} "
                f"did not complete within "
                f"{self.XLOOP_CALL_TIMEOUT:.0f}s (owning loop "
                f"wedged)") from None

    def _takeover(self, old_chan) -> Optional[Session]:
        """The {takeover, begin/end} protocol against the old channel —
        run on the old channel's owning loop when another front-door
        loop accepted the new connection (bounded: a wedged owner
        raises ``RuntimeError`` after :data:`XLOOP_CALL_TIMEOUT`)."""
        def _do():
            sess = old_chan.takeover_begin()
            old_chan.takeover_end(TAKEOVER_RC)
            return sess

        sess = self._call_channel(old_chan, _do)
        if self.broker is not None:
            self.broker.metrics.inc("session.takeovered")
        return sess

    def _kick(self, chan, discard: bool) -> None:
        try:
            self._call_channel(chan, lambda: chan.kick(discard=discard))
        except Exception:
            # a dead or wedged owner loop: the channel is unregistered
            # below all the same, and shuts down alone if its loop
            # recovers
            log.warning("kick of %r failed",
                        getattr(chan, "client_id", "?"), exc_info=True)
        self.unregister_channel(getattr(chan, "client_id", ""), chan)

    def discard_session(self, client_id: str,
                        cluster_lock: bool = True) -> None:
        """``cluster_lock=False`` is the remote-RPC entry: the
        REQUESTING node already holds this clientid's cluster lock
        (emqx_cm.erl:274-282 — discard runs inside the caller's
        locker transaction)."""
        locker = self._cluster_locker() if cluster_lock else None
        if locker is not None:
            locker.acquire(client_id)
        try:
            self.cancel_will(client_id, fire=True)  # the session ends now
            chan = self._channels.get(client_id)
            if chan is not None:
                self._kick(chan, discard=True)
            stale = self._detached.pop(client_id, None)
            if stale is not None and self.broker is not None:
                self.broker.subscriber_down(stale[0])
            if stale is not None and self.durability is not None:
                self.durability.session_closed(client_id)
            if self.cluster is not None:
                self.cluster.client_down(client_id)
            if self.broker is not None:
                self.broker.metrics.inc("session.discarded")
        finally:
            if locker is not None:
                locker.release(client_id)

    def kick_session(self, client_id: str) -> bool:
        chan = self._channels.get(client_id)
        if chan is None:
            return False
        self.cancel_will(client_id, fire=True)  # the session ends now
        self._kick(chan, discard=True)
        return True

    # -- disconnect bookkeeping ------------------------------------------

    def connection_closed(self, client_id: str, channel,
                          session: Optional[Session],
                          expiry_interval: float) -> None:
        """Keep a persistent session around; drop a clean one."""
        self.unregister_channel(client_id, channel)
        if session is None:
            return
        cur = self._channels.get(client_id)
        if cur is not None and cur is not channel \
                and getattr(cur, "session", None) is session:
            # the session already re-attached to a newer connection (a
            # reconnect raced this channel's teardown): detaching it
            # here would strand the live owner's deliveries
            return
        if expiry_interval > 0:
            # stay subscribed: deliveries enqueue to the mqueue while
            # the owner is away (the reference's `disconnected` state).
            # The loop stamp clears too: a detached session's mqueue is
            # fed from the main loop until a reconnect re-stamps it
            session.connected = False
            session.notify = None
            session.owner_loop = None
            self._detached[client_id] = (
                session, time.time(), expiry_interval)
            if self.durability is not None:
                # the final pre-detach snapshot: what a crash-while-
                # detached recovery resumes this session from
                self.durability.session_detached(session)
        else:
            if self.broker is not None:
                session.broker = self.broker
                self.broker.subscriber_down(session)
                self.broker.metrics.inc("session.terminated")
            if self.cluster is not None:
                self.cluster.client_down(client_id)
            if self.durability is not None \
                    and getattr(session, "durable", False):
                self.durability.session_closed(client_id)

    def expire_sessions(self, now: Optional[float] = None) -> int:
        now = time.time() if now is None else now
        dead = [cid for cid, (_s, ts, exp) in self._detached.items()
                if now - ts >= exp]
        for cid in dead:
            sess, _, _ = self._detached.pop(cid)
            if self.durability is not None \
                    and getattr(sess, "durable", False):
                self.durability.session_closed(cid)
            self.cancel_will(cid, fire=True)  # session end publishes it
            if self.cluster is not None:
                self.cluster.client_down(cid)
            if self.broker is not None:
                self.broker.subscriber_down(sess)
                self.broker.metrics.inc("session.terminated")
                self.broker.hooks.run(
                    "session.terminated", (cid, "expired", sess.info()))
        return len(dead)

    def session_count(self) -> int:
        return len(self._channels) + len(self._detached)
