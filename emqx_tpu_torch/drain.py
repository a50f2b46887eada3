"""Graceful node drain — planned change as a first-class path.

The port of the JAX package's ``drain`` module. Every *unplanned*
failure is survivable (device loss, crash recovery, warm standbys);
this module makes *operator-driven* change survivable: a node entering
``DRAINING`` stops accepting new CONNECTs (CONNACK 0x9C
Use-Another-Server with a Server-Reference on v5 — the reference's
MQTT 5 server-redirect story; v3 clients see the server-unavailable
compat code), redirects its live clients in **paced waves** (a bounded
disconnects/sec budget that adapts to the receiving peer's overload
level), and then hands custody of its persistent sessions to the drain
target through the replication/failback machinery
(``replication.py``) — the same chunked ``repl_failback`` adoption the
promoted-standby hand-back uses, so a drain is a *voluntary, zero-RPO
failover*: journal tail shipped and acked first, the handed set
digest-verified on the target before the local copies (and exactly
their route refs) drop, the registry repointed so exactly one holder
survives. The target serves the adopted sessions on the card: its
next publish batch walks their routes with B1.

Wave redirects never race a publisher's in-flight acks: a channel with
pending batched publish acks defers its DISCONNECT behind the last one
(:meth:`Channel.drain_redirect`), so a QoS1 publisher that was acked
can trust the ack and one that was not can safely republish.

Custody hand-off under live traffic converges by iteration: the first
chunked send makes the target install the sessions' routes
(``handle_failback`` → replicated ``route_add``), after which every
cluster forward reaches BOTH copies; subsequent rounds re-send only
sessions whose digests still differ (full-state overwrites are
idempotent), and the loop exits when the local and target digests of
the handed set match — messages that arrived between a snapshot and
the dual-route window are exactly what the re-send repairs.

The drain state machine::

    RUNNING ──drain.start(target=...)──▶ DRAINING ──Node.stop──▶ STOPPING
       ▲            (new CONNECTs 0x9C,                (listeners close;
       │             redirect waves,                    0x9C+Server-Reference
       └──drain.stop()──── custody hand-off)            when a target is set)
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import time
from typing import List, Optional

from emqx_tpu_torch.concurrency import executor_thread, owner_loop

log = logging.getLogger("emqx_tpu_torch.drain")

#: node lifecycle states (the ``node.state`` gauge value)
NODE_RUNNING, NODE_DRAINING, NODE_STOPPING = 0, 1, 2
NODE_STATE_NAMES = ("running", "draining", "stopping")

#: custody hand-off chunk (sessions per repl_failback call) — the
#: same bound the failback hand-back uses, and for the same reason:
#: one apply must not stall the target's transport IO thread long
#: enough to get it suspected
HANDOFF_BATCH_SESSIONS = 256


@dataclasses.dataclass
class DrainConfig:
    """The drain knobs, with the JAX package's defaults (its ``[drain]``
    section). Every knob here is read at use time — the whole section
    is live-reloadable."""

    #: clients redirected per wave; with ``wave_interval_s`` this is
    #: the disconnects/sec budget (wave_size / wave_interval_s)
    wave_size: int = 100
    #: seconds between redirect waves
    wave_interval_s: float = 1.0
    #: default redirect/hand-off target peer node name ("" = none:
    #: v5 clients get 0x9C without a Server-Reference and pick a
    #: server from their own config; no custody hand-off runs)
    target: str = ""
    #: Server-Reference string sent to v5 clients ("" = the target's
    #: node name; operators set the real MQTT "host:port" here — the
    #: broker only knows the cluster transport address)
    server_ref: str = ""
    #: bound on the custody hand-off (journal tail ship + chunked
    #: session transfer + digest-verify rounds)
    handoff_timeout_s: float = 30.0
    #: SIGTERM starts a drain (bounded by ``sigterm_grace_s``) before
    #: the normal graceful stop, instead of stopping immediately; a
    #: second SIGTERM skips straight to the stop (read by the
    #: command-line entry point, ``python -m emqx_tpu_torch``)
    on_sigterm: bool = False
    sigterm_grace_s: float = 30.0

    #: every knob is read per wave / per signal (not a dataclass
    #: field: unannotated)
    RELOADABLE = frozenset({
        "wave_size", "wave_interval_s", "target", "server_ref",
        "handoff_timeout_s", "on_sigterm", "sigterm_grace_s"})

    def __post_init__(self) -> None:
        if self.wave_size < 1:
            raise ValueError("drain.wave_size must be >= 1")
        if self.wave_interval_s <= 0:
            raise ValueError("drain.wave_interval_s must be > 0")
        if self.handoff_timeout_s <= 0:
            raise ValueError("drain.handoff_timeout_s must be > 0")
        if self.sigterm_grace_s <= 0:
            raise ValueError("drain.sigterm_grace_s must be > 0")


class DrainManager:
    """Per-node drain agent (built by Node unconditionally; passive
    until :meth:`start`). While active, the channel's CONNECT
    pipeline consults it through ``broker.draining`` — the same
    None-guard pattern every other robustness hook uses."""

    def __init__(self, node, config: Optional[DrainConfig] = None
                 ) -> None:
        self.node = node
        self.cfg = config or DrainConfig()
        self.active = False
        self.target: Optional[str] = None
        self.ref: Optional[str] = None
        self.started_at: Optional[float] = None
        #: monotonic drain start / end (time_to_empty_s)
        self._t0: Optional[float] = None
        self.time_to_empty_s: Optional[float] = None
        self.redirected = 0
        self.handed_off = 0
        #: digest verdict of the custody hand-off (None = no hand-off
        #: ran; False = deadline hit with a digest mismatch — the
        #: final state was still sent, counted in handoff.errors)
        self.handoff_ok: Optional[bool] = None
        #: per-wave redirect durations (ms) — the bench's wave p99
        self.wave_ms: List[float] = []
        self._task: Optional[asyncio.Task] = None

    # -- predicates consulted on hot paths --------------------------------

    def rejects_connects(self) -> bool:
        return self.active

    def server_ref(self) -> Optional[str]:
        """The Server-Reference string for redirects/CONNACKs: the
        explicit ref, else the target's node name; None with no
        target at all (0x9C still goes out — the client falls back
        to its own server list)."""
        ref = self.ref or self.cfg.server_ref
        if ref:
            return ref
        return self.target or (self.cfg.target or None)

    # -- lifecycle ---------------------------------------------------------

    @owner_loop
    def start(self, target: Optional[str] = None,
              ref: Optional[str] = None) -> None:
        """Enter DRAINING: arm the CONNECT gate, raise the alarm,
        start the redirect-wave task. Needs a running node (the
        waves are an event-loop task)."""
        if self.active:
            raise ValueError("drain already in progress")
        target = target or (self.cfg.target or None)
        cl = getattr(self.node, "cluster", None)
        if target is not None and cl is not None \
                and target not in cl.members:
            raise ValueError(f"drain target {target!r} is not a "
                             f"cluster member ({sorted(cl.members)})")
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            raise ValueError(
                "drain needs a running node event loop") from None
        self.active = True
        self.target = target
        self.ref = ref
        self.started_at = time.time()
        self._t0 = time.perf_counter()
        self.time_to_empty_s = None
        self.redirected = 0
        self.handed_off = 0
        self.handoff_ok = None
        self.wave_ms = []
        self.node.node_state = NODE_DRAINING
        self.node.broker.draining = self
        self.node.alarms.activate(
            "node_draining",
            details={"target": target, "ref": self.server_ref()},
            message="node is draining: new CONNECTs redirected, live "
                    "clients disconnected in paced waves, session "
                    "custody handing to the target")
        self._task = loop.create_task(self._run())
        log.warning("drain started (target=%s, ref=%s, budget=%d/%ss)",
                    target, self.server_ref(), self.cfg.wave_size,
                    self.cfg.wave_interval_s)

    @owner_loop
    def stop(self) -> None:
        """Abort/finish the drain and return to RUNNING (an aborted
        drain keeps whatever custody already moved — hand-offs are
        full-state idempotent, nothing is half-transferred)."""
        if not self.active:
            return
        self.active = False
        if self._task is not None:
            self._task.cancel()
            self._task = None
        if getattr(self.node.broker, "draining", None) is self:
            self.node.broker.draining = None
        self.node.node_state = NODE_RUNNING
        self.node.alarms.deactivate("node_draining")
        log.warning("drain stopped (redirected=%d, handed_off=%d)",
                    self.redirected, self.handed_off)

    async def wait(self, timeout: float) -> bool:
        """Block until the drain's wave + hand-off task finishes
        (the SIGTERM drain mode's bounded grace); True = drained to
        empty inside the bound."""
        t = self._task
        if t is None:
            return True
        try:
            await asyncio.wait_for(asyncio.shield(t), timeout)
            return True
        except (asyncio.TimeoutError, asyncio.CancelledError):
            return False

    # -- the drain task ----------------------------------------------------

    @owner_loop
    async def _run(self) -> None:
        node = self.node
        loop = asyncio.get_running_loop()
        try:
            while self.active:
                chans = [c for c in list(node.cm._channels.values())
                         if getattr(c, "drain_redirect", None)
                         is not None and not getattr(c, "closed", True)]
                if not chans:
                    break
                n = await loop.run_in_executor(
                    None, self._redirect_wave, chans)
                if n:
                    self.redirected += n
                    node.metrics.inc("drain.redirects", n)
                    node.metrics.inc("drain.waves")
                else:
                    # the target reported critical overload: the
                    # budget adapted to zero — hold this wave
                    node.metrics.inc("drain.waves.deferred")
                await asyncio.sleep(self.cfg.wave_interval_s)
            cl = getattr(node, "cluster", None)
            if self.active and self.target is not None \
                    and (node.cm._detached
                         or (cl is not None
                             and cl._takeover_parked)):
                await loop.run_in_executor(None, self._handoff)
            if self.active and self._t0 is not None:
                self.time_to_empty_s = round(
                    time.perf_counter() - self._t0, 4)
                log.warning(
                    "drain complete in %.2fs: %d redirected, %d "
                    "sessions handed to %s (digest_ok=%s)",
                    self.time_to_empty_s, self.redirected,
                    self.handed_off, self.target, self.handoff_ok)
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("drain task failed")

    @executor_thread
    def _wave_budget(self) -> int:
        """This wave's disconnect budget: ``wave_size``, halved when
        the receiving peer reports WARN overload, zero (wave held)
        at CRITICAL — the drain must not tip the target over."""
        budget = max(1, int(self.cfg.wave_size))
        cl = getattr(self.node, "cluster", None)
        if self.target is None or cl is None:
            return budget
        try:
            lvl = int(cl.transport.call(self.target, "overload_level"))
        except Exception:
            lvl = 0  # unknown target health: keep the configured rate
        if lvl >= 2:
            return 0
        if lvl == 1:
            return max(1, budget // 2)
        return budget

    @executor_thread
    def _redirect_wave(self, chans: list) -> int:
        """One paced wave, off the event loop (the budget probe and
        the cross-loop channel marshals both block): redirect up to
        the adapted budget of live channels. Returns redirects
        initiated (0 = wave deferred)."""
        budget = self._wave_budget()
        if budget <= 0:
            return 0
        t0 = time.perf_counter()
        ref = self.server_ref()
        n = 0
        for chan in chans[:budget]:
            try:
                self.node.cm._call_channel(
                    chan, lambda c=chan: c.drain_redirect(ref))
                n += 1
            except Exception:
                log.exception("drain redirect of %r failed",
                              getattr(chan, "client_id", "?"))
        self.wave_ms.append((time.perf_counter() - t0) * 1000.0)
        return n

    # -- custody hand-off (the voluntary zero-RPO failover) ---------------

    @executor_thread
    def _handoff(self) -> None:
        """Hand every detached persistent session to the target
        through the failback adoption path: ship the journal
        tail (quorum-acked), send the session set in bounded chunks
        (``repl_failback`` — full-state overwrites, idempotent),
        iterate until the handed set's digest matches on both sides
        (live cluster forwards land in both copies once the target's
        routes are up), then drop the local copies + exactly their
        route refs and repoint the registry."""
        from emqx_tpu_torch.cluster import PeerUnavailableError
        from emqx_tpu_torch.replication import sessions_digest

        node = self.node
        cm = node.cm
        cl = node.cluster
        repl = node.replication
        target = self.target
        if cl is None or repl is None or target is None:
            return
        deadline = time.monotonic() + self.cfg.handoff_timeout_s

        def call(*args):
            # a target the detector holds suspect is unconfirmed, not
            # lost: wait its hysteresis out inside the hand-off's bound.
            # Giving up at once kept custody on a node about to stop,
            # whose restart recovers the sessions where no registry
            # entry points (a reconnect elsewhere then got a fresh
            # session: the rolling restart's session loss)
            while True:
                try:
                    return cl.transport.call(target, *args)
                except PeerUnavailableError as e:
                    if e.state != "suspect" or not self.active \
                            or time.monotonic() >= deadline:
                        raise
                time.sleep(0.05)

        d = node.durability
        if d is not None and d.wal is not None:
            # local durability first, then the replicated tail: the
            # hand-off must never outrun what the journal group can
            # prove (the quorum-acked contract)
            d.wal.flush()
            if repl._thread is not None:
                repl.notify_flush()
                repl.ship_sync(
                    max(0.1, min(5.0, deadline - time.monotonic())))
        ok = False
        cids: List[str] = []
        universe: set = set()  # every cid ever transferred
        try:
            # phase 1 — BULK convergence rounds (no locks): transfer
            # the whole detached set; the first round installs the
            # sessions' routes on the target (handle_failback →
            # replicated route_add), after which every live cluster
            # forward lands in BOTH copies and a full-state re-send
            # of any still-divergent session settles the digest
            while time.monotonic() < deadline:
                if not self.active:
                    return  # drain aborted / node stopping: the
                    # thread must not keep calling peers with state
                    # that is no longer this node's to hand
                cids = sorted(cm._detached)
                universe.update(cids)
                if not cids:
                    ok = True
                    break
                handed = []
                for cid in cids:
                    ent = cm._detached.get(cid)
                    if ent is None:
                        continue
                    s, dts, _exp = ent
                    try:
                        handed.append((cid, float(dts), s.to_wire()))
                    except Exception:
                        log.exception("snapshot of %r failed", cid)
                local_digest = sessions_digest(node, cids)
                for i in range(0, len(handed),
                               HANDOFF_BATCH_SESSIONS):
                    chunk = handed[i:i + HANDOFF_BATCH_SESSIONS]
                    call("repl_failback", node.name,
                         {"sessions": chunk, "final": False})
                if sessions_digest(node, cids) == local_digest \
                        and call("drain_digest", cids) == local_digest:
                    ok = True
                    break
                # digests differ: a forward landed mid-transfer —
                # the dual-route window makes the next full-state
                # re-send converge
                time.sleep(0.05)
            self.handoff_ok = ok
            if not ok:
                # deadline with live divergence: the locked finalize
                # below still moves custody with a fresh snapshot —
                # the settle miss is counted and visible in status
                node.metrics.inc("drain.handoff.errors")
                log.warning("drain hand-off digest did not settle "
                            "inside %.1fs; finalizing anyway",
                            self.cfg.handoff_timeout_s)
            # phase 2 — per-cid FINALIZE under the cluster locker
            # (the same per-clientid lock every open_session /
            # takeover holds): re-snapshot, re-send, drop local +
            # exactly its route refs, repoint the registry. A racing
            # reconnect either wins the lock first (it takes the
            # session away — we skip it and tell the target to drop
            # its stale bulk copy via the keep list) or blocks a few
            # ms and then chases the registry to the target. Without
            # this lock a takeover landing between the transfer and
            # the drop minted fresh sessions.
            moved: List[str] = []
            lk = cl.locker
            universe.update(cm._detached)
            # reply-loss-parked takeover copies die with this node if
            # left behind: they are custody too — hand them over
            universe.update(cl._takeover_parked)
            for cid in sorted(universe):
                if not self.active:
                    return
                lk.acquire(cid)
                try:
                    ent = cm._detached.pop(cid, None)
                    if ent is not None:
                        s, dts, _exp = ent
                        # QUIESCE FIRST, snapshot second: dropping
                        # the dispatch wiring + this node's route
                        # refs before the snapshot means no further
                        # message can land in this copy — local
                        # publishes route to the target only, and an
                        # in-flight forward bounces there (the
                        # "forward" RPC's re-route). Snapshotting
                        # first lost the messages that arrived
                        # between the snapshot and the drop: present
                        # only in copies that were overwritten or
                        # dropped.
                        repl._drop_local_session(cid, s,
                                                 registry=False)
                    else:
                        s = cl.claim_parked(cid)
                        dts = time.time()
                        if s is None:
                            continue  # taken over mid-hand-off
                    try:
                        call("repl_failback", node.name,
                             {"sessions": [(cid, float(dts),
                                            s.to_wire())],
                              "final": False})
                    except (ConnectionError, OSError):
                        # already dropped locally: park so the copy
                        # stays reachable (takeover/claim) instead
                        # of evaporating with the failed call
                        cl._takeover_parked[cid] = (s, time.time())
                        raise
                    cl.reassign_client(cid, target)
                    moved.append(cid)
                finally:
                    lk.release(cid)
            # final marker: the target checkpoints + resyncs the
            # adopted set to ITS standbys (quorum-grade custody) and
            # drops stale bulk copies of any session a racing
            # reconnect took elsewhere mid-hand-off (the keep list —
            # unless the registry meanwhile placed it on the target
            # itself, which handle_failback's live-wins rule keeps)
            taken = sorted(universe - set(moved))
            call("repl_failback", node.name,
                 {"sessions": [], "final": True, "keep": taken})
        except (ConnectionError, OSError) as e:
            log.warning("drain hand-off to %s failed (%s); local "
                        "custody kept for what was not finalized",
                        target, e)
            node.metrics.inc("drain.handoff.errors")
            self.handoff_ok = False
            return
        # the reassign broadcast is an at-most-once cast; this node
        # is about to STOP, so every member must learn the new
        # custodian NOW — a stale registry entry pointing at a dead
        # node costs a reconnecting client its session (the custody
        # chase can only follow claims that exist). Synchronous,
        # best-effort per member; anti-entropy repairs stragglers
        if moved:
            for m in list(cl.members):
                if m in (cl.name, target):
                    continue
                try:
                    cl.transport.call(m, "registry_sync", target,
                                      moved)
                except (ConnectionError, OSError):
                    pass
        self.handed_off = len(moved)
        node.metrics.inc("drain.handoff.sessions", len(moved))

    # -- observability -----------------------------------------------------

    def info(self) -> dict:
        waves = sorted(self.wave_ms)
        p99 = waves[max(0, int(len(waves) * 0.99) - 1)] \
            if waves else None
        return {
            "state": NODE_STATE_NAMES[self.node.node_state],
            "active": self.active,
            "target": self.target,
            "server_ref": self.server_ref(),
            "redirected": self.redirected,
            "handed_off": self.handed_off,
            "handoff_ok": self.handoff_ok,
            "waves": len(self.wave_ms),
            "wave_p99_ms": round(p99, 3) if p99 is not None else None,
            "time_to_empty_s": self.time_to_empty_s,
            "budget_per_s": round(
                self.cfg.wave_size / self.cfg.wave_interval_s, 1),
        }
