"""Replicated durability: journal shipping to warm standbys, promotion,
failback.

The port of the JAX package's ``replication`` module. The durability
layer makes a node crash-consistent against its OWN disk, and the
cluster replicates routes but not sessions — a node death still loses
its live persistent sessions until that disk comes back. This module
closes the gap the reference broker never did (mnesia ram tables +
takeover, PAPER.md L7/L8): the primary streams its journal records over
the cluster transport to a REPLICATION GROUP of standby peers, each of
which continuously replays them into a warm *detached* replica state
(never into its live broker tables). When the heartbeat failure
detector declares the primary down, one standby PROMOTES — resurrecting
the primary's persistent sessions, retained messages, and routes
exactly, with RPO = 0 for every record the primary flushed and the
standby acked.

Group shipping model: **fan-out**, not chained — the primary keeps ONE
global offered stream and an independent cursor per standby
(``_PeerLink``). Every standby receives the same per-key-ordered record
stream the merge rule already pins, so any standby's replica converges
to the same state; a record is **quorum-acked** once ``ack_quorum``
distinct standbys acked an offset at or past it, and quorum-acked
records survive the loss of any ``ack_quorum - 1`` nodes (plus the
primary's own disk). ``ack_quorum > 0`` makes the local group commit
wait — bounded by ``quorum_timeout_ms``, degrade-don't-wedge — for that
watermark; ``ack_quorum = 0`` keeps shipping fully asynchronous.

Roles (one :class:`ReplicationManager` per clustered node plays both):

  - **Shipper** (primary side, armed when ``DurabilityConfig.standbys``
    — or the single ``standby`` — names peers): journal appends are
    offered to a bounded queue; after each local group commit the
    shipper thread drains the queue — only locally-durable records ship
    — and calls ``repl_ship`` per standby with a contiguous sequence
    range. Each standby's reply is its acked offset; lag is
    ``offered − min(acked)``. A suspect/down standby (the transport
    fast-fails), a ship error, or a full queue drops THAT peer's link to
    **local-only** mode: local durability and the other standbys are
    unaffected, the ``replication_lagging`` alarm raises (hysteresis on
    the lag thresholds), and the next successful contact runs a full
    RESYNC (``repl_hello`` with a fresh snapshot) before incremental
    shipping resumes.
  - **Replica** (standby side, one per primary): applies shipped records
    into staging dicts keyed exactly like recovery's (sessions /
    retained / tombstones / absolute route refcounts). Contiguity is
    enforced — a sequence gap answers ``resync`` and the primary
    re-snapshots. The replica is WARM state, not live state: zero
    interference with the standby's own traffic.

Promotion (``Cluster.handle_nodedown`` → :meth:`maybe_promote`): runs
after the cluster's normal dead-node purge, so the primary's replicated
route entries are gone and the replica re-installs them remapped to the
standby's own name (exact refcounts via ``Router.set_route_refs``,
broadcast to the surviving members); persistent sessions resurrect
DETACHED (expiry evaluated against detach time, reconnecting clients
get session-present + DUP redelivery); retained messages re-arm through
the retainer's restore path. On the card the adopted state is served by
the kernels: the re-installed routes go through the router's patcher,
the next publish batch walks them with B1 (B2 for a filter past the
fan-out threshold), and a SUBSCRIBE burst replays the adopted retained
store through B3. If the standby runs its own durability, a full
checkpoint immediately journals the adopted state, and its OWN shipper
full-resyncs so the adopted state reaches the surviving standbys too.
With several standbys, promotion is ARBITRATED
(:meth:`ReplicationManager._arbitrate`, serialized through the cluster
locker): the reachable replica with the highest applied offset wins,
ties break to the first node name — a dual promotion is only possible
when the co-standbys cannot reach each other, and resolves on heal
through the same failback hand-off.

FAILBACK: when the dead primary restarts, recovers from its own disk,
rejoins (the cluster's heal path) and hellos its standby, a PROMOTED
replica does not reset — it answers ``failback_pending`` and ships the
authoritative post-promotion state BACK (:meth:`maybe_failback` →
``repl_failback`` chunks): still-detached adopted sessions hand over
wholesale (full-state overwrite of the primary's stale crash-recovered
copies — no second session-present/DUP storm, clients were never
attached here), sessions whose clients reconnected to the standby stay
(``keep``), and dead ones are closed. After the primary's ack the
standby drops the handed sessions + exactly their route refs, re-stages
them as its warm replica (a re-failover re-promotes from there), demotes
itself, and the primary's next hello resyncs the stream — the pair
converges digest-byte-exact. The original dying again mid-failback is
safe in both windows: before the apply the standby aborts and stays
promoted; after the apply the demoted standby re-promotes from the
re-staged replica. The ``repl.failback`` fault point rehearses the
first window; a hello from the authoritative primary drops the
standby's unregistered stale detached duplicates (the crash-during-
failback double recovery).

Fault points: ``repl.ship`` drop discards the ship call (the standby
never sees it — the resync path's repair target), stall delays it (lag
visible to the alarm); ``repl.failback`` drops/stalls the hand-off call
(the standby stays promoted and retries on the primary's next hello).

Where the port differs from the JAX package (its faults C.4 and C.5,
and one cost): a session handed away drops its route refs once
(:meth:`ReplicationManager._drop_local_session`); a hello never
reclaims, as a stale duplicate, a session its sender handed here; and
a primary whose standby answered ``failback_pending`` holds its next
hello for :data:`FAILBACK_HELLO_HOLD_S` instead of re-sending a full
snapshot at every ship pass.
"""

from __future__ import annotations

import hashlib
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from emqx_tpu_torch import faults as _faults
from emqx_tpu_torch import topic as T
from emqx_tpu_torch.concurrency import (any_thread, bg_thread,
                                        executor_thread, owner_loop,
                                        shared_state)

log = logging.getLogger("emqx_tpu_torch.replication")

#: ship batch bound: one repl_ship call carries at most this many
#: records (a huge tail ships as several bounded calls)
SHIP_BATCH_RECORDS = 2048
#: failback hand-off chunk: sessions per repl_failback call (bounds
#: how long one apply blocks the primary's transport IO thread —
#: long stalls get the freshly-rejoined primary suspected)
FAILBACK_BATCH_SESSIONS = 256
#: seconds a primary holds its next hello to a standby that answered
#: ``failback_pending`` (the standby is handing our state back; its
#: final chunk re-arms the hello at once through schedule_resync). The
#: JAX package re-snapshots at every ship pass meanwhile — a full
#: snapshot of every session, as often as the journal flushes
FAILBACK_HELLO_HOLD_S = 2.0


def _sub_route(key: str, node_name: str) -> Tuple[str, object]:
    """A subscription key's (filter, dest) route contribution on
    ``node_name`` — the same mapping recovery's orphan pruning and
    the broker's subscribe path use."""
    flt, popts = T.parse(key)
    share = popts.get("share")
    return (flt, (share, node_name) if share else node_name)


@shared_state(lock="lock", attrs=("sessions", "retained",
                                 "tombs", "routes"))
class StandbyReplica:
    """Warm detached replica of one primary's durable state."""

    def __init__(self, primary: str) -> None:
        self.primary = primary
        self.lock = threading.Lock()
        #: serializes the replica's STATE TRANSITIONS — a hello's
        #: accept/reset, a promotion, a failback finalize. Without
        #: it, the restarted primary's hello can reset the replica
        #: between the promotion's table installs and its promoted
        #: flag, wiping the adopted bookkeeping the failback needs
        #: (the adopted sessions would orphan on the holder)
        self.op_lock = threading.RLock()
        #: staging dicts — the same shapes recovery stages into
        self.sessions: Dict[str, list] = {}   # cid -> [dts, state]
        self.retained: Dict[str, object] = {}
        self.tombs: Dict[str, float] = {}
        self.routes: Dict[Tuple, int] = {}    # (flt, dest) -> refs
        self.applied_seq = 0
        self.applied_records = 0
        self.clean = False        # primary said goodbye cleanly
        self.promoted = False
        #: the primary's full standby list (hello snapshot) — the
        #: promotion-arbitration electorate
        self.peers: List[str] = []
        #: promotion bookkeeping for failback: every cid the replica
        #: carried at promote time (the hand-back universe)
        self.adopted_all: set = set()
        self.last_ship_ts: Optional[float] = None

    def reset(self, start_seq: int) -> None:
        with self.lock:
            self.sessions.clear()
            self.retained.clear()
            self.tombs.clear()
            self.routes.clear()
            self.applied_seq = start_seq - 1
            self.clean = False
            self.promoted = False
            self.adopted_all = set()

    @any_thread
    def _apply_locked(self, rec: tuple) -> None:
        """One journal record into the warm state — the replica-side
        mirror of ``DurabilityManager._apply`` (absolute refcounts,
        LWW retained, full-state session overwrites). The ``_locked``
        suffix says the caller holds ``self.lock`` (apply_batch,
        handle_hello, _promote)."""
        op = rec[0]
        if op == "route":
            _, flt, dest, refs = rec
            key = (flt, tuple(dest) if isinstance(dest, list)
                   else dest)
            if int(refs) > 0:
                self.routes[key] = int(refs)
            else:
                self.routes.pop(key, None)
        elif op == "retain":
            _, topic, msg, ts = rec
            if msg is None:
                self.retained.pop(topic, None)
                self.tombs[topic] = max(self.tombs.get(topic, 0.0),
                                        float(ts))
            else:
                self.retained[topic] = msg
        elif op == "sess.state":
            _, cid, dts, d = rec
            self.sessions[cid] = [dts, d]
        elif op == "sess.sub":
            _, cid, key, opts = rec
            ent = self.sessions.get(cid)
            if ent is not None:
                ent[1]["subscriptions"][key] = opts
        elif op == "sess.unsub":
            _, cid, key = rec
            ent = self.sessions.get(cid)
            if ent is not None:
                ent[1]["subscriptions"].pop(key, None)
        elif op == "sess.close":
            self.sessions.pop(rec[1], None)
        else:
            raise ValueError(f"unknown replicated record {op!r}")

    @any_thread
    def apply_batch(self, seq0: int, records: list) -> dict:
        with self.lock:
            if seq0 != self.applied_seq + 1:
                # sequence gap (dropped ship, replica restarted):
                # refuse — the primary re-snapshots via repl_hello
                return {"resync": True, "applied": self.applied_seq}
            for rec in records:
                try:
                    self._apply_locked(tuple(rec))
                except Exception:
                    log.warning("skipping malformed shipped record "
                                "%r", rec[:1] if rec else rec)
            self.applied_seq = seq0 + len(records) - 1
            self.applied_records += len(records)
            self.last_ship_ts = time.time()
            return {"applied": self.applied_seq}

    def info(self) -> dict:
        with self.lock:
            return {
                "primary": self.primary,
                "applied_seq": self.applied_seq,
                "applied_records": self.applied_records,
                "sessions": len(self.sessions),
                "retained": len(self.retained),
                "routes": len(self.routes),
                "clean": self.clean,
                "promoted": self.promoted,
                "peers": list(self.peers),
                "last_ship_age_s": (
                    round(time.time() - self.last_ship_ts, 1)
                    if self.last_ship_ts else None),
            }


class _PeerLink:
    """One standby's shipping cursor in the fan-out group: its own
    stream offsets and health; mutated under the manager's
    ``_q_lock`` (offsets) or the ship lock (state machine)."""

    __slots__ = ("name", "state", "need_hello", "hello_after",
                 "shipped_seq", "acked_seq", "acked_bytes",
                 "last_ack_ts")

    def __init__(self, name: str) -> None:
        self.name = name
        #: "replicating" | "syncing" | "local_only"
        self.state = "syncing"
        self.need_hello = True
        #: monotonic time before which no hello goes out (held after
        #: a ``failback_pending`` answer)
        self.hello_after = 0.0
        self.shipped_seq = 0
        self.acked_seq = 0
        self.acked_bytes = 0
        self.last_ack_ts: Optional[float] = None

    def info(self) -> dict:
        return {"state": self.state,
                "shipped_seq": self.shipped_seq,
                "acked_seq": self.acked_seq,
                "last_ack_age_s": (
                    round(time.time() - self.last_ack_ts, 1)
                    if self.last_ack_ts else None)}


@shared_state(lock="_q_lock", attrs=("_q",))
class ReplicationManager:
    """Per-node replication agent: the shipper half (when this node
    is a primary with configured standbys) plus any standby replicas
    this node holds for its peers. Attached by ``Cluster.__init__``
    as ``node.replication``; RPC ops route here via
    ``Cluster.handle_rpc``."""

    def __init__(self, node, cluster) -> None:
        self.node = node
        self.cluster = cluster
        self.replicas: Dict[str, StandbyReplica] = {}
        # shipper state (armed by arm_shipper)
        self.durability = None
        self.standbys: Tuple[str, ...] = ()
        self.peers: Dict[str, _PeerLink] = {}
        self._ack_quorum = 0
        self._q: List[tuple] = []         # offered, not yet shipped
        self._q_lock = threading.Lock()
        #: group-commit quorum wait: signaled whenever any standby's
        #: acked offset advances
        self._ack_cv = threading.Condition(self._q_lock)
        #: one ship pass at a time: the shipper thread and a
        #: shutdown's synchronous ship_sync must not interleave
        #: batches (a replica would see a sequence regression and
        #: force a pointless resync)
        self._ship_lock = threading.Lock()
        self._flush_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self.offered_seq = 0              # last seq assigned
        self._flushed_seq = 0             # locally durable watermark
        self.offered_bytes = 0
        self._q_bytes = 0
        self._lag_alarmed = False
        self._quorum_alarmed = False
        self._quorum_timed_out = False
        #: sessions adopted by a STILL-RUNNING hand-off (failback or
        #: drain): cid -> (source, adopted_at). Serving one of these
        #: to a reconnecting client mid-transfer would resume a STALE
        #: intermediate snapshot and make the finalize skip the
        #: authoritative copy (live-wins) — its queued messages would
        #: drop with the source. The resume/takeover paths answer
        #: ServerBusy until the source's final marker lands (or the
        #: TTL expires — a source that died mid-hand-off must not
        #: wedge its sessions behind BUSY forever).
        self._adopting: Dict[str, tuple] = {}
        #: cid -> the node that handed it here (failback or drain),
        #: while this node holds it: that node's hello never reclaims
        #: it as a stale duplicate (see _drop_stale_duplicates)
        self._handed_by: Dict[str, str] = {}
        #: failback hand-offs / promotion checks in flight (primary
        #: names; single-flight guards)
        self._failback_busy: set = set()
        self._promote_busy: set = set()
        self._fb_lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "repl.shipped": 0, "repl.acked": 0, "repl.ship_errors": 0,
            "repl.resyncs": 0, "repl.dropped": 0,
            "repl.promotions": 0,
            "repl.quorum.waits": 0, "repl.quorum.timeouts": 0,
            "repl.failbacks": 0, "repl.failback_errors": 0,
        }
        self._last_fold: Dict[str, int] = {}
        #: thread-recorded alarm transitions, drained on the stats
        #: tick (same pattern as DurabilityManager._events)
        self._events: List[tuple] = []

    # -- shipper arming ----------------------------------------------------

    def arm_shipper(self, durability) -> None:
        """Become a replicating primary: ship the journal stream to
        every ``[durability] standbys`` peer. Called by
        Cluster.__init__ when the config names standbys."""
        if self._thread is not None:
            return
        self.durability = durability
        self.standbys = tuple(durability.cfg.standby_list)
        self.peers = {n: _PeerLink(n) for n in self.standbys}
        self._ack_quorum = int(durability.cfg.ack_quorum)
        durability.repl = self
        self._thread = threading.Thread(
            target=self._ship_main, daemon=True,
            name=f"repl-ship-{self.node.name}")
        self._thread.start()

    def close(self) -> None:
        self._stopping = True
        self._flush_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # -- aggregate offsets (the single-standby surface) -------------------

    @property
    def standby(self) -> Optional[str]:
        """The first configured standby (the single-standby accessor;
        the full group lives in ``peers``)."""
        return self.standbys[0] if self.standbys else None

    @property
    def acked_seq(self) -> int:
        """Fully-replicated watermark: the highest seq EVERY standby
        acked (the queue-trim floor and the lag baseline)."""
        if not self.peers:
            return 0
        return min(p.acked_seq for p in self.peers.values())

    @property
    def shipped_seq(self) -> int:
        if not self.peers:
            return 0
        return max(p.shipped_seq for p in self.peers.values())

    @property
    def last_ack_ts(self) -> Optional[float]:
        ts = [p.last_ack_ts for p in self.peers.values()
              if p.last_ack_ts is not None]
        return max(ts) if ts else None

    @property
    def state(self) -> str:
        """Aggregate link state: ``replicating`` only when every
        standby is; ``partial`` when some are; else the worst of
        ``local_only``/``syncing`` (single-standby groups reduce to
        the single-standby three-state machine exactly)."""
        if not self.peers:
            return "syncing"
        sts = [p.state for p in self.peers.values()]
        if all(s == "replicating" for s in sts):
            return "replicating"
        if any(s == "replicating" for s in sts):
            return "partial"
        if any(s == "local_only" for s in sts):
            return "local_only"
        return "syncing"

    def quorum_acked_seq(self) -> int:
        """Highest seq acked by at least ``ack_quorum`` standbys —
        the quorum durability watermark (``ack_quorum = 0`` reports
        the best single ack)."""
        k = max(1, self._ack_quorum)
        acks = sorted((p.acked_seq for p in self.peers.values()),
                      reverse=True)
        if len(acks) < k:
            return 0
        return acks[k - 1]

    # -- primary side ------------------------------------------------------

    @any_thread
    def offer(self, op: tuple) -> None:
        """Queue one journal record for shipping (called from
        DurabilityManager._append, any thread). Bounded: overflow
        drops the queue whole and schedules a full resync on every
        standby — local durability is never affected."""
        with self._q_lock:
            self.offered_seq += 1
            size = _op_size(op)
            self.offered_bytes += size
            if len(self._q) >= \
                    self.durability.cfg.repl_queue_max_records:
                self.counters["repl.dropped"] += len(self._q)
                self._q.clear()
                self._q_bytes = 0
                for p in self.peers.values():
                    p.need_hello = True
                    p.state = "local_only"
                return
            self._q.append((self.offered_seq, size, op))
            self._q_bytes += size

    @executor_thread
    def notify_flush(self) -> None:
        """The local group commit landed: everything offered so far
        is durable and may ship (called from on_batch, executor
        thread)."""
        with self._q_lock:
            self._flushed_seq = self.offered_seq
        self._flush_evt.set()

    @executor_thread
    def wait_quorum(self) -> bool:
        """Quorum-aware group commit: after the local WAL group
        commit, block — bounded by ``quorum_timeout_ms`` — until
        ``ack_quorum`` standbys acked the flushed watermark. Returns
        False on timeout: the publish path continues
        (degrade-don't-wedge), the timeout counts, and the
        ``repl_quorum_degraded`` alarm raises until the quorum catches
        back up. ``ack_quorum = 0`` never blocks."""
        k = self._ack_quorum
        if k <= 0 or self._thread is None:
            return True
        with self._ack_cv:
            target = self._flushed_seq
            if self.quorum_acked_seq() >= target:
                self._quorum_timed_out = False
                return True
            self.counters["repl.quorum.waits"] += 1
            deadline = time.monotonic() + \
                self.durability.cfg.quorum_timeout_ms / 1000.0
            while self.quorum_acked_seq() < target:
                left = deadline - time.monotonic()
                if left <= 0:
                    self.counters["repl.quorum.timeouts"] += 1
                    self._quorum_timed_out = True
                    return False
                self._ack_cv.wait(left)
            self._quorum_timed_out = False
            return True

    @bg_thread
    def _ship_main(self) -> None:
        while not self._stopping:
            fired = self._flush_evt.wait(timeout=1.0)
            if self._stopping:
                return
            if fired:
                self._flush_evt.clear()
            try:
                self._ship_pass()
            except Exception:
                if self._stopping:
                    return  # transport torn down under the pass
                log.exception("journal ship pass failed")

    def _peer_ok(self, name: str) -> bool:
        tr = self.cluster.transport
        return tr.peer_state(name) == "ok" \
            and name in getattr(tr, "_peers", {name})

    @bg_thread
    def _ship_pass(self) -> None:
        """One fan-out pass: ship everything durable and pending to
        every standby, bounded per call. Suspect-aware: a standby the
        failure detector holds unhealthy is not dialed at all — the
        queue holds (bounded) and THAT link stays/goes local-only
        until its peer recovers; healthy siblings keep shipping."""
        with self._ship_lock:
            for peer in self.peers.values():
                try:
                    self._ship_peer(peer)
                except Exception:
                    if self._stopping:
                        return  # transport torn down under the pass
                    log.exception("journal ship to %s failed",
                                  peer.name)

    @bg_thread
    def _ship_peer(self, peer: _PeerLink) -> None:
        if peer.name not in self.cluster.members \
                and peer.state != "replicating":
            return  # standby not joined yet
        if not self._peer_ok(peer.name):
            if peer.state == "replicating":
                peer.state = "local_only"
            return
        if peer.need_hello:
            if time.monotonic() < peer.hello_after:
                return  # the standby is handing our state back
            if not self._hello(peer):
                return
        while True:
            with self._q_lock:
                batch = [e for e in self._q
                         if peer.acked_seq < e[0] <= self._flushed_seq]
                batch = batch[:SHIP_BATCH_RECORDS]
            if not batch:
                if peer.state == "local_only" \
                        and peer.acked_seq >= self._flushed_seq:
                    # the link degraded while already fully acked
                    # (peer went suspect with nothing left to ship):
                    # with the detector holding it healthy again and
                    # zero lag there is no call to prove recovery
                    # with — the stale local_only stamp would stick
                    # forever
                    peer.state = "replicating"
                return
            if not self._ship_batch(peer, batch):
                return

    @bg_thread
    def _hello(self, peer: _PeerLink) -> bool:
        """Full resync with one standby: snapshot the primary's
        durable planes and hand its replica a fresh baseline + the
        next stream seq."""
        d = self.durability
        with self._q_lock:
            # records already queued re-ship after the snapshot (they
            # are idempotent over it); the stream restarts contiguous
            start_seq = self._q[0][0] if self._q else \
                self.offered_seq + 1
        snapshot = _primary_snapshot(self.node, d, self.standbys)
        try:
            if _faults.enabled and _faults.fire("repl.ship"):
                raise ConnectionError("injected repl.ship drop")
            reply = self.cluster.transport.call(
                peer.name, "repl_hello", self.node.name,
                snapshot, start_seq)
        except (ConnectionError, OSError) as e:
            self.counters["repl.ship_errors"] += 1
            peer.state = "local_only"
            log.warning("replication hello to %s failed: %s",
                        peer.name, e)
            return False
        if isinstance(reply, dict) and reply.get("failback_pending"):
            # the standby still owns a PROMOTED incarnation of our
            # state: hold the stream until its failback hand-off
            # lands (handle_hello scheduled it); not an error
            peer.state = "syncing"
            peer.hello_after = time.monotonic() + FAILBACK_HELLO_HOLD_S
            return False
        self.counters["repl.resyncs"] += 1
        peer.need_hello = False
        peer.state = "replicating"
        with self._q_lock:
            # the reset DEFINES the replica's position: a stale
            # higher ack from a previous replica incarnation must not
            # survive (it would make every subsequent ship start past
            # the replica's true offset — a resync→hello live-lock).
            # The queue still holds every record past start_seq - 1:
            # start_seq is the queue head (trimmed at the min-ack
            # floor), or offered + 1 on an empty queue
            peer.acked_seq = start_seq - 1
            peer.shipped_seq = min(peer.shipped_seq, start_seq - 1)
            self._ack_cv.notify_all()
        log.info("replication resync with %s complete (%d sessions, "
                 "%d routes)", peer.name,
                 len(snapshot["sessions"]), len(snapshot["routes"]))
        return True

    @bg_thread
    def _ship_batch(self, peer: _PeerLink,
                    batch: List[tuple]) -> bool:
        seq0 = batch[0][0]
        records = [op for _s, _b, op in batch]
        nbytes = sum(b for _s, b, _op in batch)
        try:
            if _faults.enabled and _faults.fire("repl.ship"):
                raise ConnectionError("injected repl.ship drop")
            reply = self.cluster.transport.call(
                peer.name, "repl_ship", self.node.name, seq0,
                records)
        except (ConnectionError, OSError) as e:
            self.counters["repl.ship_errors"] += 1
            peer.state = "local_only"
            log.warning("journal ship to %s failed (%s); local-only "
                        "until the peer recovers", peer.name, e)
            return False
        if isinstance(reply, dict) and reply.get("failback_pending"):
            # the standby holds a promoted incarnation of our state:
            # park the stream until its hand-off lands
            peer.state = "syncing"
            peer.need_hello = True
            peer.hello_after = time.monotonic() + FAILBACK_HELLO_HOLD_S
            return False
        if isinstance(reply, dict) and reply.get("resync"):
            peer.need_hello = True
            return self._hello(peer)
        acked = int(reply["applied"] if isinstance(reply, dict)
                    else reply)
        with self._q_lock:
            peer.shipped_seq = max(peer.shipped_seq, batch[-1][0])
            peer.acked_seq = max(peer.acked_seq, acked)
            peer.acked_bytes += nbytes
            floor = min(p.acked_seq for p in self.peers.values())
            self._q = [e for e in self._q if e[0] > floor]
            self._q_bytes = sum(e[1] for e in self._q)
            self._ack_cv.notify_all()
        self.counters["repl.shipped"] += len(records)
        self.counters["repl.acked"] += len(records)
        peer.last_ack_ts = time.time()
        peer.state = "replicating"
        return True

    @any_thread
    def schedule_resync(self) -> None:
        """Force a full re-snapshot to every standby (post-promotion
        / post-failback: the adopted state must reach this node's own
        standbys for quorum-grade survival)."""
        if self._thread is None:
            return
        with self._q_lock:
            for p in self.peers.values():
                p.need_hello = True
                p.hello_after = 0.0
        self._flush_evt.set()

    @any_thread
    def ship_sync(self, timeout: float) -> bool:
        """Drain + ship the tail synchronously (graceful shutdown's
        bounded hand-off). True when EVERY standby acked
        everything."""
        if self._thread is None:
            return True
        with self._q_lock:
            self._flushed_seq = self.offered_seq
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                self._ship_pass()
            except Exception:
                log.exception("shutdown ship pass failed")
                return False
            with self._q_lock:
                if self.acked_seq >= self.offered_seq:
                    return True
            if all(p.state == "local_only"
                   for p in self.peers.values()):
                return False
            time.sleep(0.02)
        return False

    def bye(self, clean: bool = False) -> None:
        """Tell every standby this primary is departing deliberately
        (each keeps its warm replica, stamped clean —
        failback-safe)."""
        if self._thread is None:
            return
        for name in self.standbys:
            try:
                self.cluster.transport.call(
                    name, "repl_bye", self.node.name, bool(clean))
            except (ConnectionError, OSError):
                pass

    def lag(self) -> Tuple[int, int]:
        """(records, bytes) the slowest standby is behind."""
        with self._q_lock:
            return (max(0, self.offered_seq - self.acked_seq),
                    self._q_bytes)

    # -- standby side ------------------------------------------------------

    def handle_hello(self, primary: str, snapshot: dict,
                     start_seq: int):
        rep = self.replicas.get(primary)
        if rep is None:
            rep = self.replicas[primary] = StandbyReplica(primary)
        with rep.op_lock:
            if rep.promoted:
                # the primary is back but THIS replica is
                # authoritative: hold its stream and hand the
                # adopted state back first
                self.maybe_failback(primary)
                return {"failback_pending": True,
                        "applied": rep.applied_seq}
            self._drop_stale_duplicates(primary, snapshot)
            rep.reset(start_seq)
            with rep.lock:
                rep.peers = list(snapshot.get("standbys", ()))
                for cid, dts, sd in snapshot.get("sessions", []):
                    rep.sessions[cid] = [dts, sd]
                for topic, msg in snapshot.get("retained", []):
                    rep.retained[topic] = msg
                for topic, ts in snapshot.get("tombstones", []):
                    rep.tombs[topic] = float(ts)
                for flt, dest, refs in snapshot.get("routes", []):
                    key = (flt, tuple(dest) if isinstance(dest, list)
                           else dest)
                    rep.routes[key] = int(refs)
                rep.last_ship_ts = time.time()
        log.info("warm standby armed for %s (%d sessions, %d routes,"
                 " %d retained)", primary, len(rep.sessions),
                 len(rep.routes), len(rep.retained))
        return {"applied": rep.applied_seq}

    def _drop_stale_duplicates(self, primary: str,
                               snapshot: dict) -> None:
        """A hello is the primary's claim over the cids in its
        snapshot (it only snapshots sessions it currently holds). A
        DETACHED local copy of such a cid that the cluster registry
        does not place here is a crash artifact (a standby that died
        between a failback apply and its finalize recovers the
        handed sessions a second time) — drop it, refs and all, so
        the double-recovery converges instead of double-owning. A
        session ``primary`` itself handed here stays: here is its
        authoritative copy."""
        cm = self.node.cm
        for cid in [c for c in list(self._handed_by)
                    if c not in cm._detached and c not in cm._channels]:
            self._handed_by.pop(cid, None)  # no longer held here
        for ent in snapshot.get("sessions", []):
            cid = ent[0]
            stale = cm._detached.get(cid)
            if stale is None:
                continue
            if self._handed_by.get(cid) == primary:
                # ``primary`` handed this session HERE (it held it as
                # a promoted standby or a draining node): this copy is
                # the authoritative one, the claim in its hello is
                # stale. The registry alone cannot tell: a registry
                # push ``primary`` cast before the hand-off can land
                # after it. The JAX package drops the session here and
                # ``primary``'s finalize drops its own (fault C.5)
                continue
            owner = self.cluster._registry.get(cid)
            if owner is not None and owner != primary:
                continue  # registry places it elsewhere: not ours to drop
            cm._detached.pop(cid, None)
            self._drop_local_session(cid, stale[0], registry=False)
            # the registry must follow the custody: leaving OUR
            # stale owner-authoritative claim in place would have
            # anti-entropy re-propagate the wrong owner forever
            self.cluster.reassign_client(cid, primary)
            log.warning("dropped stale detached duplicate of %r "
                        "(authoritative primary %s reclaimed it)",
                        cid, primary)

    def handle_ship(self, primary: str, seq0: int, records: list):
        rep = self.replicas.get(primary)
        if rep is None:
            return {"resync": True, "applied": 0}
        if rep.promoted:
            # the primary is alive and shipping, but THIS replica is
            # the authoritative incarnation (a spurious promotion
            # under a link cut, or a restart mid-failback): park its
            # stream and hand the state back first
            self.maybe_failback(primary)
            return {"failback_pending": True,
                    "applied": rep.applied_seq}
        return rep.apply_batch(int(seq0), records)

    def handle_bye(self, primary: str, clean: bool):
        rep = self.replicas.get(primary)
        if rep is not None:
            rep.clean = bool(clean)
        return None

    def handle_replica_info(self, primary: str) -> dict:
        """Promotion-arbitration probe: what this node's replica of
        ``primary`` holds (co-standbys compare applied offsets)."""
        rep = self.replicas.get(primary)
        if rep is None:
            return {"exists": False}
        return {"exists": True, "applied_seq": rep.applied_seq,
                "promoted": rep.promoted,
                "records": rep.applied_records}

    # -- failover ----------------------------------------------------------

    def maybe_promote(self, dead: str) -> bool:
        """``dead`` went down (heartbeat detector). If this node is
        one of its warm standbys AND wins the promotion arbitration,
        promote the replica — runs AFTER the cluster's normal
        nodedown purge, so the dead primary's replicated route
        entries are already gone and re-install remapped to this
        node."""
        rep = self.replicas.get(dead)
        if rep is None or rep.promoted:
            return False
        if rep.clean:
            # the primary said a clean goodbye (graceful stop /
            # drain): a planned departure is not a failure. Its own
            # disk is authoritative when it returns, and a drained
            # node's sessions were already handed off — promoting a
            # replica whose close records may not all have shipped
            # resurrects zombies and poisons the registry (caught
            # live by the rolling-restart proof). A primary that
            # comes back and resyncs clears the flag, so a LATER
            # crash promotes normally.
            log.info("not promoting for %s: clean departure", dead)
            return False
        with self._fb_lock:  # single-flight per primary
            if dead in self._promote_busy:
                return False
            self._promote_busy.add(dead)
        try:
            return self._maybe_promote_exclusive(rep)
        finally:
            with self._fb_lock:
                self._promote_busy.discard(dead)

    def _maybe_promote_exclusive(self, rep: StandbyReplica) -> bool:
        dead = rep.primary
        # serialize the promotion claim through the cluster locker
        # (majority of live members, suspect-degraded): co-standbys
        # race their nodedown dispatches, and unserialized crossing
        # reads of each other's applied offsets (a late in-flight
        # ship batch landing between the two reads) can elect two
        # winners — or none
        lk = getattr(self.cluster, "locker", None)
        key = f"\x00repl-promote\x00{dead}"
        deadline = time.monotonic() + 10.0
        while True:
            locked = lk.acquire(key) if lk is not None else False
            try:
                verdict = self._arbitrate(rep)
                if verdict == "done":
                    return False
                if verdict == "win" \
                        or time.monotonic() >= deadline:
                    # "defer" past the deadline is the availability
                    # fallback: a deferral is only final once a
                    # winner is VISIBLE — if the candidates' reads
                    # crossed and everyone deferred, somebody must
                    # still resurrect the dead primary's sessions (a
                    # rare dual claim resolves on heal via the
                    # failback hand-off)
                    return self._promote_now(rep)
            finally:
                if locked:
                    lk.release(key)
            # deferred: wait for the better replica to claim it —
            # OUTSIDE the lock, so the winner is never blocked by a
            # loser's polling
            time.sleep(0.5)

    def _promote_now(self, rep: StandbyReplica) -> bool:
        dead = rep.primary
        t0 = time.perf_counter()
        with rep.op_lock:
            if rep.promoted:
                return False
            try:
                summary = self._promote(rep)
            except Exception:
                log.exception("standby promotion for %s failed",
                              dead)
                return False
            # the flag lands INSIDE the transition lock: a hello
            # arriving from the restarted primary either ran before
            # this whole section (the promotion then adopts its
            # fresh snapshot and fails back cleanly) or defers with
            # failback_pending — it can never reset the replica
            # between the table installs and this flag
            rep.promoted = True
        # the adopted state becomes durable + shipped off-lock (the
        # checkpoint can be slow; hellos must not stall on it)
        d = self.node.durability
        if d is not None and d.wal is not None:
            d.checkpoint_now(full=True)
        self.schedule_resync()
        self.counters["repl.promotions"] += 1
        failover_s = time.perf_counter() - t0
        self.last_promotion = dict(summary, primary=dead,
                                   failover_s=round(failover_s, 4),
                                   clean=rep.clean)
        self._events.append((
            "activate", "standby_promoted",
            dict(self.last_promotion),
            f"standby promoted for {dead}: "
            f"{summary['sessions']} sessions, "
            f"{summary['routes']} routes resurrected"))
        log.warning("standby PROMOTED for %s in %.1fms: %s",
                    dead, failover_s * 1000.0, summary)
        return True

    last_promotion: Optional[dict] = None
    last_failback: Optional[dict] = None

    def _arbitrate(self, rep: StandbyReplica) -> str:
        """One promotion-arbitration round among the dead primary's
        surviving standbys: the replica with the highest applied
        offset wins, ties break to the first node name. Returns
        ``"done"`` when a co-standby already promoted (it IS the
        winner), ``"defer"`` when a reachable co-standby beats this
        replica, ``"win"`` otherwise. Unreachable co-standbys are
        ignored — availability over a perfect election: a dual
        promotion is only possible when the standbys cannot reach
        each other, and resolves on heal via the failback
        hand-off."""
        me = str(self.node.name)
        with rep.lock:
            peers = list(rep.peers)
            mine = rep.applied_seq
        verdict = "win"
        for other in peers:
            other = str(other)
            if other == me or other == rep.primary:
                continue
            if not self._peer_ok(other):
                continue
            try:
                info = self.cluster.transport.call(
                    other, "repl_replica_info", rep.primary)
            except (ConnectionError, OSError):
                continue
            if not isinstance(info, dict) or not info.get("exists"):
                continue
            if info.get("promoted"):
                return "done"
            oa = int(info.get("applied_seq", 0))
            if oa > mine or (oa == mine and other < me):
                verdict = "defer"
        return verdict

    def _promote(self, rep: StandbyReplica) -> dict:
        node = self.node
        me = node.broker.node
        primary = rep.primary
        down_ts = time.time()
        with rep.lock:
            routes = dict(rep.routes)
            sessions = {c: list(v) for c, v in rep.sessions.items()}
            retained = dict(rep.retained)
            tombs = dict(rep.tombs)
            rep.adopted_all = set(sessions)
        # 1. routes: the dead primary's dests remap to this node with
        # exact refcounts; other nodes' dests are live replication's
        # problem, not the replica's
        installed = 0
        dj = node.durability
        for (flt, dest), refs in routes.items():
            if dest == primary:
                dest2 = me
            elif isinstance(dest, tuple) and len(dest) == 2 \
                    and dest[1] == primary:
                dest2 = (dest[0], me)
            else:
                continue
            have = node.router.route_refs(flt, dest2)
            node.router.set_route_refs(flt, dest2, have + int(refs))
            if dj is not None:
                # absolute refcount record: a crash BEFORE the
                # post-promotion checkpoint lands still recovers the
                # adopted route (Wal.close flushes — the journal is
                # the belt, the checkpoint the fast path)
                dj._append(("route", flt, dest2,
                            node.router.route_refs(flt, dest2)))
            installed += 1
            # surviving members need the adopted route (set_route_refs
            # bypasses the replicated add wrapper on purpose)
            self.cluster._broadcast("route_add", flt, dest2)
        # 2. retained messages re-arm through the restore path (LWW
        # + tombstone-monotone, no re-broadcast storm; anti-entropy
        # reconciles peers)
        mods = getattr(node, "modules", None)
        ret = mods._loaded.get("retainer") if mods is not None else None
        if ret is not None and (retained or tombs):
            ret.restore_entries(retained.items(), tombs.items())
        # 3. persistent sessions resurrect DETACHED (recovery's exact
        # contract: reconnecting clients resume with session-present
        # and DUP redelivery)
        from emqx_tpu_torch.session import Session

        resurrected = 0
        for cid, (dts, sd) in sessions.items():
            if cid in node.cm._channels or cid in node.cm._detached:
                continue  # the client already lives here — keep it
            owner = self.cluster._registry.get(cid)
            if owner is not None and owner != primary \
                    and owner != me and owner in self.cluster.members:
                # custody already MOVED off the dead primary (a drain
                # hand-off, a takeover chain) to a live member: the
                # replica's copy is stale — resurrecting it would
                # double-own the session and poison the registry with
                # this node's claim (registry-guarded promotion)
                continue
            try:
                sess = Session.from_wire(sd)
            except Exception as e:
                log.warning("replicated session %r unrecoverable: %s",
                            cid, e)
                continue
            expiry = float(sd.get("expiry_interval", 0.0) or 0.0)
            if expiry <= 0:
                continue
            detach = float(dts) if dts is not None else down_ts
            if down_ts - detach >= expiry:
                continue  # expired before the failover
            sess.client_id = cid
            sess.broker = node.broker
            d = node.durability
            if d is not None:
                sess.durable = True
                sess._dur = d
                d._detach_ts[cid] = detach
            for key, opts in list(sess.subscriptions.items()):
                try:
                    self._restore_sub(sess, key, opts)
                except Exception:
                    log.exception("restoring %r of %r failed",
                                  key, cid)
            node.cm._detached[cid] = (sess, detach, expiry)
            if d is not None:
                # journal the adopted session NOW: the promoted
                # holder crashing before its checkpoint must still
                # recover it (the double-recovery contract)
                d._append(("sess.state", cid, detach, sd))
            if self.cluster is not None:
                self.cluster.client_up(cid)
            resurrected += 1
        # (the caller checkpoints + resyncs its own shippers after
        # the promoted flag lands — quorum-grade: the promoted
        # holder dying next must not lose the adopted state)
        return {"sessions": resurrected, "routes": installed,
                "retained": len(retained)}

    def _restore_sub(self, sess, key: str, opts) -> None:
        """Rebuild subscriber/fanout/shared tables WITHOUT bumping
        the router (refs were installed from the replica) — the
        promotion-side analogue of Broker.restore_subscription."""
        self.node.broker.restore_subscription(sess, key, opts)

    # -- failback ----------------------------------------------------------

    @any_thread
    def retry_failbacks(self) -> None:
        """Failback trigger of last resort (the cluster heal
        worker's periodic sweep): a promoted replica whose primary
        is back, healthy, and a member again hands the state back
        even when the original trigger — the heal rejoin or the
        primary's hello — was lost to a transient error or a quiet
        fully-acked stream that never makes contact."""
        for primary, rep in list(self.replicas.items()):
            if not rep.promoted:
                continue
            if primary in self.cluster.members \
                    and self._peer_ok(primary):
                self.maybe_failback(primary)

    @any_thread
    def maybe_failback(self, peer: str) -> None:
        """``peer`` — a primary this node promoted for — is back
        (auto-heal rejoin, or its hello reached handle_hello). Hand
        the adopted state over on a background thread; idempotent
        and single-flight per primary."""
        rep = self.replicas.get(peer)
        if rep is None or not rep.promoted:
            return
        with self._fb_lock:
            if peer in self._failback_busy:
                return
            self._failback_busy.add(peer)
        t = threading.Thread(
            target=self._failback_main, args=(rep,), daemon=True,
            name=f"repl-failback-{self.node.name}")
        t.start()

    @bg_thread
    def _failback_main(self, rep: StandbyReplica) -> None:
        try:
            self._failback(rep)
        except Exception:
            self.counters["repl.failback_errors"] += 1
            log.exception("failback to %s failed", rep.primary)
        finally:
            with self._fb_lock:
                self._failback_busy.discard(rep.primary)

    @bg_thread
    def _failback(self, rep: StandbyReplica) -> None:
        """The FAILBACK hand-off: ship the authoritative
        post-promotion state back to the restarted primary, then
        demote. Nothing is removed locally until the primary acked the
        final chunk — the original dying mid-transfer leaves this node
        promoted and authoritative."""
        primary = rep.primary
        node = self.node
        cm = node.cm
        t0 = time.perf_counter()
        with rep.lock:
            universe = sorted(rep.adopted_all)
        # classify the adopted population NOW (post-promotion churn
        # included): still-detached sessions hand back; sessions
        # whose clients reconnected HERE stay; the rest closed
        handed: List[tuple] = []
        keep: List[str] = []
        closed: List[str] = []
        for cid in universe:
            ent = cm._detached.get(cid)
            if ent is not None:
                s, dts, _exp = ent
                try:
                    handed.append((cid, float(dts), s.to_wire()))
                except Exception:
                    keep.append(cid)  # mutating mid-walk: keep here
            elif cid in cm._channels:
                keep.append(cid)
            else:
                # adopted here once, gone now. The registry decides
                # what to tell the primary: owned by the primary
                # itself → ITS copy is authoritative, say nothing;
                # owned by another VERIFIED member → it MIGRATED
                # through a further failover chain (that owner's
                # hand-off machinery is responsible for it) and the
                # primary only drops its stale copy. Ownerless (or
                # claimed by us without a copy): say NOTHING — the
                # primary keeps its recovered copy. Telling it
                # "closed" here once dropped the LAST copy of a
                # quorum-acked session under a racing custody chain;
                # a possibly-stale resurrection (it expires on its
                # own clock) always beats data loss
                owner = self.cluster._registry.get(cid)
                if owner is not None and owner != primary \
                        and owner != self.node.name:
                    keep.append(cid)
        # failback is HEAL traffic: it goes via call_addr like the
        # rejoin/anti-entropy path, bypassing the suspect fast-fail
        # gate — the primary's IO loop stalls while applying big
        # chunks, gets transiently suspected, and a fast-fail here
        # would abort (and restart) the hand-off forever at scale
        tr = self.cluster.transport
        call_addr = getattr(tr, "call_addr", None)
        addr = getattr(tr, "_peers", {}).get(primary)

        def _send(payload):
            if _faults.enabled and _faults.fire("repl.failback"):
                raise ConnectionError("injected repl.failback drop")
            if call_addr is not None and addr is not None:
                return call_addr(addr, "repl_failback",
                                 self.node.name, payload)
            return tr.call(primary, "repl_failback",
                           self.node.name, payload)

        try:
            for i in range(0, max(len(handed), 1),
                           FAILBACK_BATCH_SESSIONS):
                chunk = handed[i:i + FAILBACK_BATCH_SESSIONS]
                final = i + FAILBACK_BATCH_SESSIONS >= len(handed)
                payload = {"sessions": chunk, "final": final}
                if final:
                    payload["keep"] = keep
                    payload["closed"] = closed
                _send(payload)
        except (ConnectionError, OSError) as e:
            self.counters["repl.failback_errors"] += 1
            log.warning("failback to %s failed (%s); staying "
                        "promoted", primary, e)
            return
        # the primary applied everything: drop the handed sessions +
        # exactly their route refs, re-stage them as the warm replica
        # (a re-failover re-promotes from here), demote — one
        # transition-locked section, so a concurrent hello/promotion
        # can never interleave with the finalize
        with rep.op_lock:
            restaged = []
            for cid, dts, sd in handed:
                ent = cm._detached.pop(cid, None)
                if ent is None:
                    continue
                self._drop_local_session(cid, ent[0])
                restaged.append((cid, dts, sd))
            with rep.lock:
                rep.sessions.clear()
                rep.retained.clear()
                rep.tombs.clear()
                rep.routes.clear()
                for cid, dts, sd in restaged:
                    rep.sessions[cid] = [dts, sd]
                    for key in sd.get("subscriptions", {}):
                        flt, dest = _sub_route(key, primary)
                        rep.routes[(flt, dest)] = \
                            rep.routes.get((flt, dest), 0) + 1
                rep.clean = False
                rep.applied_seq = 0  # the next hello resets
                rep.adopted_all = set()
                # count + record BEFORE clearing promoted: an
                # observer seeing the demotion must also see the
                # completed hand-off
                self.counters["repl.failbacks"] += 1
                fb = {"primary": primary,
                      "sessions": len(restaged),
                      "kept": len(keep), "closed": len(closed),
                      "failback_s":
                          round(time.perf_counter() - t0, 4)}
                self.last_failback = fb
                rep.promoted = False
        self._events.append(("deactivate", "standby_promoted",
                             {}, ""))
        d = node.durability
        if d is not None and d.wal is not None:
            d.checkpoint_now(full=True)
        self.schedule_resync()
        log.warning("FAILBACK to %s complete in %.1fms: %s",
                    primary, fb["failback_s"] * 1000.0, fb)

    def adopting(self, client_id: str) -> bool:
        """True while ``client_id`` was adopted by a hand-off whose
        final marker has not landed (bounded by a 30 s TTL against a
        source dying mid-transfer) — the resume/takeover paths defer
        such sessions instead of serving a stale snapshot."""
        ent = self._adopting.get(client_id)
        if ent is None:
            return False
        if time.time() - ent[1] > 30.0:
            self._adopting.pop(client_id, None)
            return False
        return True

    def handle_failback(self, standby: str, payload: dict) -> dict:
        """The returning primary's half of FAILBACK: adopt the
        authoritative post-promotion session state back from the
        promoted standby (chunked calls; idempotent — a timed-out
        chunk re-applies cleanly). Stale crash-recovered local
        copies are replaced by full-state overwrite; sessions the
        standby kept (their clients reconnected there) or closed
        drop their stale local copies; LIVE local sessions always
        win."""
        from emqx_tpu_torch.session import Session

        node = self.node
        cm = node.cm
        me = node.broker.node
        d = node.durability
        down_ts = time.time()
        adopted = 0
        for cid, dts, sd in payload.get("sessions", []):
            if cid in cm._channels:
                continue  # the client already came home live
            stale = cm._detached.pop(cid, None)
            # an earlier chunk of this same hand-off: from its apply
            # on, live forwards reach that copy, and the ones that
            # landed after the sender quiesced its own copy are in no
            # snapshot of the sender's — the overwrite below must keep
            # them (fault C.9)
            carry = stale[0] if stale is not None \
                and self.adopting(cid) \
                and self._adopting[cid][0] == standby else None
            try:
                sess = Session.from_wire(sd)
                expiry = float(sd.get("expiry_interval", 0.0) or 0.0)
            except Exception as e:
                log.warning("failback session %r unrecoverable: %s",
                            cid, e)
                sess = None
            detach = float(dts) if dts is not None else down_ts
            if sess is None or expiry <= 0 \
                    or down_ts - detach >= expiry:
                # unrecoverable, not persistent, or expired while
                # failed over
                if stale is not None:
                    self._drop_local_session(cid, stale[0],
                                             registry=False)
                continue
            sess.client_id = cid
            sess.broker = node.broker
            if d is not None:
                sess.durable = True
                sess._dur = d
            for key, opts in list(sess.subscriptions.items()):
                try:
                    flt, dest = _sub_route(key, me)
                    node.router.add_route(flt, dest=dest)
                    node.broker.restore_subscription(sess, key, opts)
                    if d is not None:
                        # absolute refcount record: a crash before
                        # the failback checkpoint still recovers it
                        d._append(("route", flt, dest,
                                   node.router.route_refs(flt,
                                                          dest)))
                except Exception:
                    log.exception("failback restore of %r for %r "
                                  "failed", key, cid)
            if stale is not None:
                # only now that the new copy holds its route refs: a
                # drop first took a filter's last ref on this node, and
                # a publish between the route_del and route_add that
                # went out reached no copy at all (fault C.9)
                self._drop_local_session(cid, stale[0],
                                         registry=False)
            if d is not None:
                d._detach_ts[cid] = detach
            if carry is not None and sess.carry_queued(carry):
                sd = sess.to_wire()  # the journal holds the merge
            cm._detached[cid] = (sess, detach, expiry)
            self._adopting[cid] = (standby, time.time())
            self._handed_by[cid] = standby
            if d is not None:
                d._append(("sess.state", cid, detach, sd))
            if self.cluster is not None:
                self.cluster.client_up(cid)
            adopted += 1
        for cid in list(payload.get("keep", ())) + \
                list(payload.get("closed", ())):
            stale = cm._detached.pop(cid, None)
            if stale is not None:
                self._drop_local_session(cid, stale[0],
                                         registry=False)
        if d is not None and d.wal is not None:
            # the adopted records journaled above must become
            # locally durable AND shippable now — nothing else runs
            # on_batch for them (no publish traffic yet on a node
            # that just came back)
            d.wal.flush()
            if d.repl is not None:
                d.repl.notify_flush()
        if payload.get("final"):
            # the hand-off is complete: its adopted sessions are
            # authoritative and serveable
            for cid in [c for c, (src, _ts) in
                        self._adopting.items() if src == standby]:
                self._adopting.pop(cid, None)
            if d is not None and d.wal is not None:
                # the heavy full checkpoint runs off the transport
                # IO thread (heartbeats keep flowing); the journal
                # records above already cover a crash window
                threading.Thread(
                    target=lambda: d.checkpoint_now(full=True),
                    daemon=True,
                    name=f"failback-ckpt-{node.name}").start()
            self.schedule_resync()
            self.last_failback = {"from": standby,
                                  "applied": adopted,
                                  "role": "primary"}
            log.warning("failback from %s applied (%d sessions "
                        "adopted)", standby, adopted)
        return {"applied": adopted}

    def _drop_local_session(self, cid: str, sess,
                            registry: bool = True) -> None:
        """Remove one locally-held detached session plus exactly its
        route-ref contributions (failback hand-off finalize, the drain
        hand-off and stale-duplicate cleanup). The caller already
        popped it from ``cm._detached``.

        ``detach_subscriber`` unsubscribes every key the broker holds
        for the session, and each unsubscribe drops that key's route
        ref; only a key the broker does not hold drops its ref here.
        The JAX package drops every key's ref once more here, so a
        filter other local sessions still hold loses one ref per
        session handed away (fault C.4)."""
        node = self.node
        me = node.broker.node
        held = set(node.broker.subscriptions(sess))
        try:
            node.broker.detach_subscriber(sess)
        except Exception:
            log.exception("detaching handed session %r failed", cid)
        for key in list(getattr(sess, "subscriptions", {})):
            if key in held:
                continue  # its unsubscribe above dropped the ref
            try:
                flt, dest = _sub_route(key, me)
                if node.router.route_refs(flt, dest) > 0:
                    node.router.delete_route(flt, dest=dest)
            except Exception:
                log.exception("dropping route of %r for %r failed",
                              key, cid)
        d = node.durability
        if d is not None:
            d.session_closed(cid)
        if registry and self.cluster is not None:
            self.cluster.client_down(cid)

    # -- observability -----------------------------------------------------

    @owner_loop
    def fold(self, metrics, alarms, stats) -> None:
        """Stats-tick fold: counter deltas, lag gauges, and the
        ``replication_lagging`` / ``repl_quorum_degraded`` alarms
        with hysteresis. Runs on the main loop."""
        cur = dict(self.counters)
        for name, val in cur.items():
            delta = val - self._last_fold.get(name, 0)
            if delta:
                metrics.inc(f"durability.{name}", delta)
        self._last_fold = cur
        while self._events:
            try:
                kind, name, details, message = self._events.pop(0)
            except IndexError:
                break
            if kind == "activate":
                alarms.activate(name, details=details,
                                message=message)
            else:
                alarms.deactivate(name)
        if self._thread is not None and self.durability is not None:
            lag_r, lag_b = self.lag()
            stats.setstat("durability.repl.lag_records", lag_r)
            stats.setstat("durability.repl.lag_bytes", lag_b)
            ack_ts = self.last_ack_ts
            if ack_ts is not None:
                stats.setstat(
                    "durability.repl.last_ack_age_s",
                    int(time.time() - ack_ts))
            cfg = self.durability.cfg
            if not self._lag_alarmed \
                    and lag_r > cfg.repl_lag_alarm_records:
                self._lag_alarmed = True
                alarms.activate(
                    "replication_lagging",
                    details={"lag_records": lag_r,
                             "lag_bytes": lag_b,
                             "state": self.state,
                             "standbys": list(self.standbys)},
                    message="journal shipping is behind the "
                            "configured lag bound; durability is "
                            "local-only beyond the acked offset")
            elif self._lag_alarmed \
                    and lag_r <= cfg.repl_lag_clear_records:
                self._lag_alarmed = False
                alarms.deactivate("replication_lagging")
            if self._ack_quorum > 0:
                degraded = self._quorum_timed_out and \
                    self.quorum_acked_seq() < self._flushed_seq
                if degraded and not self._quorum_alarmed:
                    self._quorum_alarmed = True
                    alarms.activate(
                        "repl_quorum_degraded",
                        details={"ack_quorum": self._ack_quorum,
                                 "quorum_acked_seq":
                                     self.quorum_acked_seq(),
                                 "flushed_seq": self._flushed_seq,
                                 "peers": {n: p.state for n, p
                                           in self.peers.items()}},
                        message="group commit cannot reach its ack "
                                "quorum inside the bounded wait; "
                                "records are durable locally and on "
                                "fewer than ack_quorum standbys")
                elif not degraded and self._quorum_alarmed:
                    self._quorum_alarmed = False
                    alarms.deactivate("repl_quorum_degraded")

    def info(self) -> dict:
        out: dict = {"counters": dict(self.counters)}
        if self._thread is not None:
            lag_r, lag_b = self.lag()
            out["role"] = "primary"
            out["state"] = self.state
            out["standby"] = self.standby
            out["standbys"] = {n: p.info()
                               for n, p in self.peers.items()}
            out["shipped_seq"] = self.shipped_seq
            out["acked_seq"] = self.acked_seq
            out["offered_seq"] = self.offered_seq
            out["lag_records"] = lag_r
            out["lag_bytes"] = lag_b
            out["ack_quorum"] = self._ack_quorum
            out["quorum_acked_seq"] = self.quorum_acked_seq()
            out["quorum_degraded"] = bool(
                self._ack_quorum > 0 and self._quorum_timed_out
                and self.quorum_acked_seq() < self._flushed_seq)
            ack_ts = self.last_ack_ts
            out["last_ack_age_s"] = (
                round(time.time() - ack_ts, 1)
                if ack_ts else None)
        if self.replicas:
            out["standby_for"] = {p: r.info()
                                  for p, r in self.replicas.items()}
        if self.last_promotion is not None:
            out["last_promotion"] = self.last_promotion
        if self.last_failback is not None:
            out["last_failback"] = self.last_failback
        return out


def _op_size(op: tuple) -> int:
    """Cheap (allocation-free-ish) record size estimate for lag
    accounting — exact byte counts would re-encode every record."""
    try:
        if op[0] == "retain" and op[2] is not None:
            return 64 + len(getattr(op[2], "payload", b""))
        if op[0] == "sess.state":
            return 256
        return 64
    except Exception:
        return 64


def _primary_snapshot(node, durability, standbys=()) -> dict:
    """The resync baseline: every durable plane as transferable
    data, same shapes the recovery checkpoint stages. Carries the
    primary's standby list — the replica-side promotion-arbitration
    electorate."""
    state = durability._snapshot_state()
    routes = []
    for flt, dests in node.router.route_table().items():
        for dest, refs in dests.items():
            routes.append((flt, dest, int(refs)))
    return {"sessions": state["sessions"],
            "retained": state["retained"],
            "tombstones": state["tombstones"],
            "routes": routes,
            "standbys": list(standbys)}


def _session_entry(cid: str, s) -> tuple:
    """One session's canonical digest entry — subscriptions, unacked
    inflight, queued mqueue payloads, QoS2 barrier, pid counter. The
    shared vocabulary of :func:`durable_digest` and
    :func:`sessions_digest`, so a drain hand-off and a full-node
    digest agree on what "byte-exact" means."""
    subs = []
    for key, o in sorted(s.subscriptions.items()):
        flt, popts = T.parse(key)
        subs.append((key, int(o.qos), int(o.nl),
                     popts.get("share", o.share)))
    inflight = sorted(
        (pid, (v[0] if isinstance(v[0], str)
               else (v[0].topic, bytes(v[0].payload).hex())))
        for pid, v in s.inflight.to_list())
    mq = [(m.topic, bytes(m.payload).hex())
          for _p, q in s.mqueue.snapshot() for m in q]
    return ("sess", cid, tuple(subs), tuple(inflight), tuple(mq),
            sorted(s.awaiting_rel), s.next_pkt_id)


def sessions_digest(node, cids) -> str:
    """Order-independent digest of a named session subset — live or
    detached, missing cids contribute nothing (so both sides of a
    custody hand-off hash exactly what they hold). The drain
    hand-off's verification predicate (drain.py)."""
    h = hashlib.sha1()
    entries = []
    for cid in cids:
        ent = node.cm._detached.get(cid)
        s = ent[0] if ent is not None else None
        if s is None:
            chan = node.cm._channels.get(cid)
            s = getattr(chan, "session", None)
        if s is None:
            continue
        try:
            entries.append(_session_entry(cid, s))
        except Exception:
            log.exception("digesting session %r failed", cid)
    for e in sorted(entries, key=repr):
        h.update(repr(e).encode())
        h.update(b"\x00")
    return h.hexdigest()


def durable_digest(node) -> str:
    """Order-independent digest of a node's durable planes — routes
    (own-node dests normalized to ``@self`` so a primary and its
    promoted standby compare equal), retained payloads, and
    persistent-session state. The failover bench's RPO/byte-exactness
    predicate; handy in tests."""
    me = node.broker.node
    h = hashlib.sha1()
    entries = []
    for flt, dests in node.router.route_table().items():
        for dest, refs in dests.items():
            if dest == me:
                dest = "@self"
            elif isinstance(dest, tuple) and len(dest) == 2 \
                    and dest[1] == me:
                dest = (dest[0], "@self")
            entries.append(("route", flt, repr(dest), int(refs)))
    mods = getattr(node, "modules", None)
    ret = mods._loaded.get("retainer") if mods is not None else None
    if ret is not None:
        for t, m in ret._store.items():
            entries.append(("retain", t, bytes(m.payload).hex(),
                            int(m.qos)))
    # durable sessions, live OR detached — a primary's live session
    # failovers into the standby's detached table, and the digest
    # must not care which side of that line it sits on
    sessions = {cid: s for cid, (s, _ts, _exp)
                in node.cm._detached.items()}
    for cid, chan in node.cm._channels.items():
        s = getattr(chan, "session", None)
        if s is not None and cid not in sessions \
                and getattr(s, "durable", False):
            sessions[cid] = s
    for cid, s in sessions.items():
        entries.append(_session_entry(cid, s))
    for e in sorted(entries, key=repr):
        h.update(repr(e).encode())
        h.update(b"\x00")
    return h.hexdigest()
