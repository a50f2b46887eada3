"""Connection/session manager: clientid registry, session open with
clean-start/resume, takeover, discard, kick.

The port of the JAX package's ``ConnectionManager``
(``src/emqx_cm.erl``) on one node: ``open_session/3`` under a
per-clientid lock (:209-236), the takeover protocol (:244-272),
discard/kick (:274-326), and the clientid→channel registry
(emqx_cm_registry). Detached persistent sessions are kept for their
session expiry and swept by :meth:`expire_sessions`; wills held back
by Will-Delay-Interval live here too. With durability on, a
persistent session's detach and close journal through
:attr:`ConnectionManager.durability`. The cluster's distributed lock
and remote takeover come with the cluster.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Dict, Optional, Tuple

from emqx_tpu_torch.session import Session

TAKEOVER_RC = 0x8E  # session taken over


class SessionUnavailableError(Exception):
    """The clientid's session owner cannot hand the session over right
    now; the channel answers the CONNECT with ServerBusy. One node
    never raises it: it is the contract the cluster's owner check
    plugs into."""

    def __init__(self, client_id: str, owner: str) -> None:
        super().__init__(
            f"session owner {owner} of {client_id!r} is suspect")
        self.owner = owner


class ConnectionManager:
    def __init__(self, broker=None) -> None:
        self.broker = broker
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
                     channel, session_opts: Optional[dict] = None
                     ) -> Tuple[Session, bool]:
        """Returns (session, session_present)."""
        with self._client_lock(client_id):
            return self._open_session_locked(
                client_id, clean_start, channel, session_opts)

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
            sess = self._takeover(old_chan)
        elif client_id in self._detached:
            sess, _ts, _exp = self._detached.pop(client_id)
        if sess is not None:
            self._channels[client_id] = channel
            if self.broker is not None:
                sess.resume(self.broker)
            return sess, True
        return self._fresh(client_id, False, channel, session_opts), False

    def _fresh(self, client_id: str, clean_start: bool, channel,
               opts: Optional[dict]) -> Session:
        sess = Session(client_id, broker=self.broker,
                       clean_start=clean_start, **(opts or {}))
        if self.broker is not None:
            self.broker.metrics.inc("session.created")
            self.broker.hooks.run("session.created",
                                  (client_id, sess.info()))
        self._channels[client_id] = channel
        return sess

    def _takeover(self, old_chan) -> Optional[Session]:
        """The {takeover, begin/end} protocol against the old channel."""
        sess = old_chan.takeover_begin()
        old_chan.takeover_end(TAKEOVER_RC)
        if self.broker is not None:
            self.broker.metrics.inc("session.takeovered")
        return sess

    def _kick(self, chan, discard: bool) -> None:
        chan.kick(discard=discard)
        self.unregister_channel(getattr(chan, "client_id", ""), chan)

    def discard_session(self, client_id: str) -> None:
        self.cancel_will(client_id, fire=True)  # the session ends now
        chan = self._channels.get(client_id)
        if chan is not None:
            self._kick(chan, discard=True)
        stale = self._detached.pop(client_id, None)
        if stale is not None and self.broker is not None:
            self.broker.subscriber_down(stale[0])
        if stale is not None and self.durability is not None:
            self.durability.session_closed(client_id)
        if self.broker is not None:
            self.broker.metrics.inc("session.discarded")

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
            # the owner is away (the reference's `disconnected` state)
            session.connected = False
            session.notify = None
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
            if self.broker is not None:
                self.broker.subscriber_down(sess)
                self.broker.metrics.inc("session.terminated")
                self.broker.hooks.run(
                    "session.terminated", (cid, "expired", sess.info()))
        return len(dead)

    def session_count(self) -> int:
        return len(self._channels) + len(self._detached)
