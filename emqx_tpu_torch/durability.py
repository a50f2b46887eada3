"""Durable broker state: write-ahead journal + atomic checkpoints +
exact crash recovery.

The port of the JAX package's single-node durability layer at its
defaults. The reference keeps routes/retained/session state in Mnesia
ram copies and survives node death through replicas on other nodes;
this layer is per-node and disk-backed instead: a kill -9 at millions
of persistent subscriptions restarts into the exact pre-crash state —
the automaton back on the device (straight from the checkpoint's
tables when the router patches in place, re-flattened from the route
log in delta mode), retained topics re-armed, persistent sessions
resurrected so reconnecting clients get session-present CONNACKs and
DUP redelivery of unacked QoS1/2.

Three planes are durable:

  1. **Routes** — every (filter, dest) refcount change journals an
     absolute-value record; checkpoints reuse :func:`checkpoint.save`.
  2. **Retained messages** — set/clear journal records + full-store
     checkpoint (tombstones included).
  3. **Persistent sessions** (session-expiry > 0) — lifecycle,
     subscriptions, and the QoS1/2 inflight window + mqueue as
     coalesced full-state records: however many transitions a batch
     caused, ONE ``sess.state`` record per dirty session per flush.

Consistency protocol:

  - journal appends buffer in memory; the ingress executor flushes
    them with one batched fsync per publish batch (plus a timer);
  - a checkpoint ROTATES the journal first, then snapshots — records
    landing in the window live in both the new journal and the
    snapshot, and every record is idempotent, so replay-on-top is
    exact;
  - the generation commits via tmp-file + fsync + MANIFEST rename;
    old journals/segments are deleted only after the rename lands;
  - recovery loads the newest intact generation, replays every
    journal at-or-after its sequence, truncates at the first torn
    record (``journal_torn_tail`` alarm — a crash mid-append is
    expected, not fatal), resurrects sessions, and prunes route refs
    that belonged to crash-dead clean sessions (their connections
    died with the process, exactly as if they had disconnected).

``DurabilityConfig(enabled=False)`` (the default) builds none of this —
every hot-path site is one ``None`` attribute test. Journal shipping
to a standby is not part of this layer: ``standby``, ``standbys`` and
``ack_quorum`` other than their defaults raise ``ValueError``, as
``Router.add_route`` refuses a remote node.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from emqx_tpu_torch import checkpoint
from emqx_tpu_torch import topic as T
from emqx_tpu_torch.concurrency import (any_thread, executor_thread,
                                        owner_loop, shared_state)
from emqx_tpu_torch.wal import WalGroup
from emqx_tpu_torch.wal import replay as wal_replay

log = logging.getLogger("emqx_tpu_torch.durability")

_JOURNAL_RE = re.compile(r"^journal-(\d+)\.wal$")
#: sharded segment: journal-<shard>-<seq>.wal
_JOURNAL_SHARD_RE = re.compile(r"^journal-(\d+)-(\d+)\.wal$")
_DELTA_RE = re.compile(r"^delta-(\d+)\.bin$")


@dataclasses.dataclass
class DurabilityConfig:
    """The durability knobs, with the JAX package's defaults (its
    ``[durability]`` section)."""

    #: master switch — False builds no manager at all: the broker/cm/
    #: session/retainer guards read None
    enabled: bool = False
    #: journal + checkpoint directory (created on boot)
    dir: str = "data/durability"
    #: False skips the per-flush os.fsync (still write-batched) —
    #: for tests and throwaway nodes only
    fsync: bool = True
    #: background flush/checkpoint tick
    flush_interval_ms: float = 50.0
    #: wall-clock checkpoint cadence (journal must be non-empty)
    checkpoint_interval_s: float = 300.0
    #: journal records that force a checkpoint before the interval
    checkpoint_min_records: int = 100_000
    #: degraded-mode (disk-full) retry backoff
    retry_backoff_s: float = 1.0
    retry_backoff_max_s: float = 30.0
    #: bounded in-memory record buffer while degraded/unarmed
    max_buffer_records: int = 100_000
    #: journal shards: 0 = auto (one shard per front-door loop; the
    #: port's node has one loop), 1 = the single-journal layout
    #: byte-for-byte, N > 1 = explicit shard count. Records
    #: route by key (filter / topic / client-id) so every key's
    #: stream lives in one shard in true order
    wal_shards: int = 0
    #: group-commit coalescing window: a flush leader sleeps this
    #: long so concurrent loops' flushes ride one fsync pass (0 =
    #: no added latency; leader-based coalescing still applies)
    group_commit_window_ms: float = 0.0
    #: full-checkpoint rebase cadence: at most this many generations
    #: between FULL snapshots; the generations in between write
    #: differential deltas whose cost tracks churn, not table size.
    #: 1 = every checkpoint full (the pre-incremental cost shape)
    checkpoint_full_every: int = 8
    #: journal-shipping warm standby: peer NODE NAME to stream the
    #: journal to over the cluster transport; "" = no replication (the
    #: only value the port takes: it has no cluster transport)
    standby: str = ""
    #: replication GROUP: peer node names the journal fans out to — each holds an
    #: independent warm replica. Mutually exclusive with the legacy
    #: single ``standby`` (which is exactly ``standbys = [peer]``)
    standbys: tuple = ()
    #: group-commit ack quorum over the standbys; 0 = fully async
    #: shipping (the only value the port takes). The JAX package's
    #: shipping knobs (quorum timeout, ack timeout, lag alarm, ship
    #: queue bound) come with journal shipping
    ack_quorum: int = 0

    #: live-reloadable knobs (the JAX package's config reload):
    #: cadences read per tick or per flush. Layout (dir,
    #: wal_shards), the fsync/backoff/buffer values baked into the
    #: Wal group at build and ``enabled`` itself need a restart (not
    #: a dataclass field: unannotated)
    RELOADABLE = frozenset({
        "flush_interval_ms", "checkpoint_interval_s",
        "checkpoint_min_records", "checkpoint_full_every"})

    def __post_init__(self) -> None:
        if self.flush_interval_ms <= 0:
            raise ValueError("durability.flush_interval_ms must be > 0")
        if self.checkpoint_interval_s <= 0:
            raise ValueError(
                "durability.checkpoint_interval_s must be > 0")
        if self.checkpoint_min_records <= 0:
            raise ValueError(
                "durability.checkpoint_min_records must be > 0")
        if self.wal_shards < 0:
            raise ValueError(
                "durability.wal_shards must be >= 0 (0 = per loop)")
        if self.group_commit_window_ms < 0:
            raise ValueError(
                "durability.group_commit_window_ms must be >= 0")
        if self.checkpoint_full_every < 1:
            raise ValueError(
                "durability.checkpoint_full_every must be >= 1")
        if not isinstance(self.standbys, (list, tuple)):
            raise ValueError(
                "durability.standbys must be a list of node names")
        self.standbys = tuple(str(s) for s in self.standbys)
        if any(not s for s in self.standbys):
            raise ValueError(
                "durability.standbys entries must be non-empty")
        if len(set(self.standbys)) != len(self.standbys):
            raise ValueError(
                "durability.standbys must not repeat a peer")
        if self.standby and self.standbys:
            raise ValueError(
                "set durability.standby OR durability.standbys, "
                "not both (standby = exactly standbys = [peer])")
        if self.ack_quorum < 0:
            raise ValueError("durability.ack_quorum must be >= 0")
        if self.ack_quorum > len(self.standby_list):
            raise ValueError(
                "durability.ack_quorum cannot exceed the number of "
                "configured standbys")
        if self.standby_list or self.ack_quorum:
            raise ValueError(
                "durability.standby/standbys/ack_quorum: this port "
                "runs one node (no journal shipping)")

    @property
    def standby_list(self) -> tuple:
        """The effective replication group: ``standbys``, or the
        legacy single ``standby`` as a one-element group."""
        if self.standbys:
            return tuple(self.standbys)
        return (self.standby,) if self.standby else ()


#: metric name -> journal counter folded into it (Node.tick)
_WAL_FOLD = (("wal.appends", "appends_total"), ("wal.fsyncs", "fsyncs"),
             ("wal.fsync_errors", "fsync_errors"),
             ("wal.degraded.dropped", "dropped"),
             ("wal.group.commits", "group_commits"),
             ("wal.group.coalesced", "group_coalesced"))


def journal_key(op: tuple) -> str:
    """The sharding key of a journal record (the merge rule): routes
    key by (filter, dest), retained by topic, session records by
    client-id — every key's records land in ONE shard in true order,
    which is what makes any per-shard-ordered replay merge converge."""
    kind = op[0]
    if kind == "route":
        return f"r|{op[1]}|{op[2]!r}"
    if kind == "retain":
        return f"t|{op[1]}"
    return f"s|{op[1]}"


@shared_state(lock="_mark_lock",
              attrs=("_pending_ops", "_delta_routes",
                     "_delta_retained", "_delta_sessions"))
class DurabilityManager:
    def __init__(self, node, cfg: DurabilityConfig) -> None:
        self.node = node
        self.cfg = cfg
        os.makedirs(cfg.dir, exist_ok=True)
        self.wal: Optional[WalGroup] = None
        #: resolved shard count: 0 = auto, one per front-door loop —
        #: the port's node runs one loop, so the single journal
        self.shards = cfg.wal_shards or 1
        #: committed checkpoint generation (0 = none yet)
        self.gen = 0
        #: journal sequence the CURRENT segment writes under
        self._seq = 0
        #: records buffered before recover() arms the on-disk journal
        self._pending_ops: List[tuple] = []
        #: pre-arm buffer records shed by the drop-oldest bound —
        #: folded into ``wal.degraded.dropped`` (they used to vanish)
        self._pending_dropped = 0
        self._dirty: set = set()
        #: cid -> detach wall time for detached durable sessions
        self._detach_ts: Dict[str, float] = {}
        self._replaying = False
        self._ckpt_lock = threading.Lock()
        # incremental-checkpoint dirty-key tracking: keys touched
        # since the last
        # checkpoint. _mark_lock orders (dirty-add + journal append)
        # against (set swap + journal rotate) so every record in a
        # truncated journal is provably covered by the delta blob
        self._mark_lock = threading.Lock()
        self._delta_routes: set = set()      # (flt, dest)
        self._delta_retained: set = set()    # topic
        self._delta_sessions: set = set()    # cid
        #: generation of the last FULL snapshot + the delta chain
        #: (generation numbers) committed on top of it
        self._full_gen = 0
        self._delta_chain: List[int] = []
        #: filename -> crc32 for the live base + delta chain (carried
        #: forward so a delta commit never re-reads the base)
        self._crc_map: Dict[str, int] = {}
        self.last_checkpoint_ts: Optional[float] = None
        self.last_recovery: Optional[dict] = None
        self.counters: Dict[str, int] = {
            "checkpoint.saves": 0, "checkpoint.errors": 0,
            "checkpoint.delta.saves": 0,
            "recovery.replayed": 0, "recovery.torn": 0,
            "recovery.sessions": 0, "recovery.routes.pruned": 0,
        }
        self._last_fold: Dict[str, int] = {}
        #: counters of journal groups closed by :meth:`shutdown`
        self._wal_retired: Dict[str, int] = {}
        #: thread-recorded alarm events, drained on the main loop by
        #: the stats tick (("activate"|"deactivate", name, details,
        #: message) — same pattern as Node._note_flatten_error)
        self._events: List[tuple] = []

    # -- paths ------------------------------------------------------------

    def _scan_journals(self) -> List[int]:
        """Distinct journal sequences present on disk (legacy
        single-journal AND sharded segment names)."""
        return sorted(self._scan_journal_files())

    def _scan_journal_files(self) -> Dict[int, List[str]]:
        """seq -> ordered segment file names for that sequence
        (legacy file first, then shards ascending — replay order
        within a sequence; per-key shard affinity makes any fixed
        order correct: the merge rule)."""
        out: Dict[int, List[str]] = {}
        try:
            names = os.listdir(self.cfg.dir)
        except OSError:
            return {}
        legacy: Dict[int, str] = {}
        sharded: Dict[int, List[Tuple[int, str]]] = {}
        for name in names:
            m = _JOURNAL_RE.match(name)
            if m:
                legacy[int(m.group(1))] = name
                continue
            m = _JOURNAL_SHARD_RE.match(name)
            if m:
                sharded.setdefault(int(m.group(2)), []).append(
                    (int(m.group(1)), name))
        for seq, name in legacy.items():
            out.setdefault(seq, []).append(name)
        for seq, pairs in sharded.items():
            out.setdefault(seq, []).extend(
                n for _s, n in sorted(pairs))
        return out

    def _retainer(self):
        return self.node.modules._loaded.get("retainer")

    # -- journal append side (called from broker/cm/channel/retainer) -----

    @any_thread
    def _append(self, op: tuple) -> None:
        if self._replaying:
            return
        # dirty-mark BEFORE the journal append, both under _mark_lock:
        # checkpoint_now swaps the dirty sets and rotates the journal
        # under the same lock, so a record can never land in a
        # to-be-truncated segment while its dirty mark lands in the
        # post-swap set (which would lose it from the delta blob)
        with self._mark_lock:
            self._note_delta(op)
            w = self.wal
            if w is not None:
                w.append(op, journal_key(op))
            else:
                # pre-recovery / library-mode buffering (bounded)
                self._pending_ops.append(op)
                if len(self._pending_ops) > self.cfg.max_buffer_records:
                    del self._pending_ops[0]
                    self._pending_dropped += 1

    def _note_delta(self, op: tuple) -> None:
        """Track the key this record touches for the next incremental
        checkpoint (set.add — cheap enough for the journal path).
        MUST be called with ``_mark_lock`` held (today: only from
        ``_append``) — the dirty mark must be ordered against
        ``checkpoint_now``'s set swap, see the comment there."""
        kind = op[0]
        if kind == "route":
            self._delta_routes.add((op[1], op[2]))
        elif kind == "retain":
            self._delta_retained.add(op[1])
        else:  # sess.* — keyed by client-id
            self._delta_sessions.add(op[1])

    @any_thread
    def journal_subscribe(self, sub, topic_filter: str, flt: str,
                          dest, opts, resub: bool) -> None:
        if self._replaying:
            return
        if not resub:
            self._append(("route", flt, dest,
                          self.node.router.route_refs(flt, dest)))
        if getattr(sub, "durable", False):
            self._append(("sess.sub", sub.client_id, topic_filter,
                          opts))

    @any_thread
    def journal_unsubscribe(self, sub, topic_filter: str, flt: str,
                            dest) -> None:
        if self._replaying:
            return
        self._append(("route", flt, dest,
                      self.node.router.route_refs(flt, dest)))
        if getattr(sub, "durable", False):
            self._append(("sess.unsub", sub.client_id, topic_filter))

    @any_thread
    def journal_retain(self, topic: str, msg,
                       ts: Optional[float] = None) -> None:
        if self._replaying:
            return
        self._append(("retain", topic, msg,
                      time.time() if ts is None else float(ts)))

    # -- session lifecycle (called from channel/cm) -----------------------

    def session_opened(self, sess, expiry_interval: float) -> None:
        """CONNECT accepted: arm (or demote) the session's durability
        and journal a full-state record — idempotent overwrite, so a
        resume after recovery re-baselines cleanly."""
        if self._replaying:
            return
        cid = sess.client_id
        if expiry_interval > 0:
            sess.durable = True
            sess._dur = self
            sess.expiry_interval = expiry_interval
            self._detach_ts.pop(cid, None)
            self._append_state(sess, None)
        elif getattr(sess, "durable", False):
            # previously-persistent cid reconnected with expiry 0:
            # the session now dies with the connection
            sess.durable = False
            sess._dur = None
            self._detach_ts.pop(cid, None)
            self._append(("sess.close", cid))

    def session_detached(self, sess) -> None:
        """Persistent disconnect: the final pre-detach state (the
        record a crash-after-disconnect recovery resumes from)."""
        if not getattr(sess, "durable", False) or self._replaying:
            return
        now = time.time()
        self._detach_ts[sess.client_id] = now
        self._dirty.discard(sess)
        self._append_state(sess, now)

    def session_closed(self, cid: str) -> None:
        """The session ended for good (clean-start discard, expiry,
        kick, zero-expiry disconnect)."""
        if self._replaying:
            return
        self._detach_ts.pop(cid, None)
        self._append(("sess.close", cid))

    def _append_state(self, sess,
                      detached_ts: Optional[float]) -> None:
        try:
            d = sess.to_wire()
        except Exception:
            # a concurrent mutation on the owning loop mid-walk: skip
            # this snapshot, retry at the next flush
            self._dirty.add(sess)
            return
        self._append(("sess.state", sess.client_id, detached_ts, d))

    def mark_dirty(self, sess) -> None:
        self._dirty.add(sess)

    # -- flush side (executor thread / timer) -----------------------------

    @executor_thread
    def _flush_states(self) -> None:
        while self._dirty:
            try:
                sess = self._dirty.pop()
            except KeyError:
                break
            if not getattr(sess, "durable", False):
                continue
            self._append_state(
                sess, self._detach_ts.get(sess.client_id))

    @executor_thread
    def on_batch(self) -> None:
        """The per-publish-batch hook (Broker.publish_fetch, executor
        thread) and the timer body: coalesce dirty session states,
        then one batched group commit (concurrent flushes coalesce
        through the WalGroup leader)."""
        w = self.wal
        if w is None:
            return
        if self._dirty:
            self._flush_states()
        if w.pending():
            w.flush()

    flush = on_batch

    # -- checkpoint -------------------------------------------------------

    def _checkpoint_due(self) -> bool:
        w = self.wal
        if w is None or (w.records == 0 and not w.pending()):
            return False
        if w.records + w.pending() >= self.cfg.checkpoint_min_records:
            return True
        last = self.last_checkpoint_ts or 0.0
        return time.time() - last >= self.cfg.checkpoint_interval_s

    def _snapshot_state(self) -> dict:
        sessions: List[Tuple[str, Optional[float], dict]] = []
        seen = set()
        cm = self.node.cm
        for cid, (s, ts, _exp) in list(cm._detached.items()):
            if getattr(s, "durable", False):
                try:
                    sessions.append((cid, float(ts), s.to_wire()))
                    seen.add(cid)
                except Exception:
                    log.warning("session %r skipped a checkpoint "
                                "snapshot (concurrent mutation)", cid)
        for cid, chan in list(cm._channels.items()):
            s = getattr(chan, "session", None)
            if s is None or cid in seen \
                    or not getattr(s, "durable", False):
                continue
            try:
                sessions.append((cid, None, s.to_wire()))
            except Exception:
                log.warning("session %r skipped a checkpoint "
                            "snapshot (concurrent mutation)", cid)
        retained: List[tuple] = []
        tombstones: List[tuple] = []
        ret = self._retainer()
        if ret is not None:
            retained = list(ret._store.items())
            tombstones = list(ret._tombstones.items())
        return {"format": 1, "ts": time.time(),
                "sessions": sessions, "retained": retained,
                "tombstones": tombstones}

    @any_thread
    def checkpoint_now(self, clean_shutdown: bool = False,
                       full: Optional[bool] = None) -> dict:
        """One atomic generation: rotate the journal (swapping the
        incremental dirty sets under the mark lock), snapshot, commit
        via manifest rename, then truncate the superseded journals/
        segments. ``full=None`` picks: a FULL rebase when the delta
        chain reached ``checkpoint_full_every``, on the first
        checkpoint, or at clean shutdown; otherwise an INCREMENTAL
        generation — a ``delta-<gen>.bin`` blob of journal-style
        records covering only the keys touched since the last
        generation, so the cost tracks churn, not table size. Safe
        from any thread; failures leave the previous generation
        authoritative (and merge the swapped dirty sets back)."""
        with self._ckpt_lock:
            t0 = time.time()
            gen = self.gen + 1
            seq = self._seq + 1
            d = self.cfg.dir
            if full is None:
                full = (clean_shutdown or self._full_gen == 0
                        or len(self._delta_chain)
                        >= self.cfg.checkpoint_full_every - 1)
            droutes = dret = dsess = None
            try:
                if self.wal is not None:
                    self._flush_states()
                # swap the dirty sets + rotate under ONE lock: every
                # record in the segments this generation will truncate
                # has its dirty mark in the swapped sets (see _append)
                with self._mark_lock:
                    droutes, self._delta_routes = \
                        self._delta_routes, set()
                    dret, self._delta_retained = \
                        self._delta_retained, set()
                    dsess, self._delta_sessions = \
                        self._delta_sessions, set()
                    if self.wal is not None:
                        self.wal.rotate_to(seq)
                self._seq = seq
                if full:
                    router_file = f"router-{gen}.npz"
                    state_file = f"state-{gen}.bin"
                    rtmp = os.path.join(d, f"router-{gen}.tmp.npz")
                    stmp = os.path.join(d, f"state-{gen}.tmp.bin")
                    info = checkpoint.save(self.node.router, rtmp)
                    _fsync_file(rtmp)
                    os.replace(rtmp, os.path.join(d, router_file))
                    state = self._snapshot_state()
                    checkpoint.save_state(stmp, state)
                    os.replace(stmp, os.path.join(d, state_file))
                    base_gen, deltas = gen, []
                    self._crc_map = {
                        router_file: checkpoint.file_crc(
                            os.path.join(d, router_file)),
                        state_file: checkpoint.file_crc(
                            os.path.join(d, state_file)),
                    }
                    result = {"generation": gen, "kind": "full",
                              "routes": info["routes"],
                              "sessions": len(state["sessions"]),
                              "retained": len(state["retained"])}
                else:
                    records = self._snapshot_delta(droutes, dret,
                                                   dsess)
                    delta_file = f"delta-{gen}.bin"
                    dtmp = os.path.join(d, f"delta-{gen}.tmp.bin")
                    checkpoint.save_state(dtmp, {
                        "format": 1, "kind": "delta",
                        "generation": gen, "records": records,
                        "ts": t0})
                    os.replace(dtmp, os.path.join(d, delta_file))
                    base_gen = self._full_gen
                    deltas = self._delta_chain + [gen]
                    router_file = f"router-{base_gen}.npz"
                    state_file = f"state-{base_gen}.bin"
                    # base/prior-delta CRCs carry forward — re-reading
                    # the table-sized base every generation would
                    # defeat the churn-cost contract
                    self._crc_map[delta_file] = checkpoint.file_crc(
                        os.path.join(d, delta_file))
                    result = {"generation": gen, "kind": "delta",
                              "records": len(records)}
                delta_names = [f"delta-{g}.bin" for g in deltas]
                manifest = {
                    "format": checkpoint.MANIFEST_FORMAT,
                    "generation": gen,
                    "journal_seq": seq,
                    "base_generation": base_gen,
                    "router": router_file,
                    "state": state_file,
                    "deltas": delta_names,
                    "crc": {k: v for k, v in self._crc_map.items()
                            if k in (router_file, state_file)
                            or k in delta_names},
                    "wal_shards": self.shards,
                    "clean_shutdown": bool(clean_shutdown),
                    "node": str(self.node.name),
                    "ts": t0,
                }
                # the commit point (checkpoint.rename fault fires
                # just before the rename inside)
                checkpoint.write_manifest(d, manifest)
                self.gen = gen
                self._full_gen = base_gen
                self._delta_chain = deltas
                self.last_checkpoint_ts = time.time()
                self.counters["checkpoint.saves"] += 1
                if not full:
                    self.counters["checkpoint.delta.saves"] += 1
                self._cleanup(manifest, seq)
                self._event("deactivate", "checkpoint_failed")
                result["duration_s"] = round(time.time() - t0, 3)
                return result
            except Exception as e:
                # previous generation stays authoritative; the new
                # journal segment keeps every record (replayed on top
                # of the OLD checkpoint at recovery). The swapped
                # dirty sets merge back so the keys stay covered by
                # the NEXT generation's delta
                if droutes is not None:
                    with self._mark_lock:
                        self._delta_routes |= droutes
                        self._delta_retained |= dret
                        self._delta_sessions |= dsess
                self.counters["checkpoint.errors"] += 1
                self._event(
                    "activate", "checkpoint_failed",
                    {"error": repr(e), "generation": gen},
                    "checkpoint commit failed; previous generation "
                    "still authoritative")
                log.exception("checkpoint generation %d failed", gen)
                return {"error": repr(e), "generation": gen}

    def _snapshot_delta(self, droutes, dret, dsess) -> List[tuple]:
        """The incremental generation's payload: journal-style
        records (absolute refcounts, LWW retained, full session
        state) for exactly the keys the swapped dirty sets name —
        read from CURRENT memory, so any later journal record replays
        idempotently on top."""
        node = self.node
        recs: List[tuple] = []
        for flt, dest in droutes:
            recs.append(("route", flt, dest,
                         node.router.route_refs(flt, dest)))
        ret = self._retainer()
        now = time.time()
        for topic in dret:
            if ret is not None and topic in ret._store:
                msg = ret._store[topic]
                recs.append(("retain", topic, msg,
                             float(getattr(msg, "timestamp", now))))
            else:
                ts = (ret._tombstones.get(topic, now)
                      if ret is not None else now)
                recs.append(("retain", topic, None, float(ts)))
        cm = node.cm
        for cid in dsess:
            sess = None
            dts: Optional[float] = None
            ent = cm._detached.get(cid)
            if ent is not None and getattr(ent[0], "durable", False):
                sess = ent[0]
                dts = float(ent[1])
            else:
                chan = cm._channels.get(cid)
                s = getattr(chan, "session", None) \
                    if chan is not None else None
                if s is not None and getattr(s, "durable", False):
                    sess = s
            if sess is None:
                recs.append(("sess.close", cid))
                continue
            try:
                recs.append(("sess.state", cid, dts, sess.to_wire()))
            except Exception:
                # concurrent mutation mid-walk: re-dirty so the NEW
                # journal + next delta carry the state instead
                self._dirty.add(sess)
                with self._mark_lock:
                    self._delta_sessions.add(cid)
        return recs

    def _cleanup(self, manifest: dict, seq: int) -> None:
        """After a committed manifest: superseded journals truncate
        and generation segments outside the manifest's base + delta
        chain are removed."""
        d = self.cfg.dir
        files = self._scan_journal_files()
        for s, names in files.items():
            if s < seq:
                for name in names:
                    _unlink(os.path.join(d, name))
        keep = {manifest["router"], manifest["state"],
                checkpoint.MANIFEST}
        keep.update(manifest.get("deltas", ()))
        self._crc_map = {k: v for k, v in self._crc_map.items()
                         if k in keep}
        for name in os.listdir(d):
            if name in keep or _JOURNAL_RE.match(name) \
                    or _JOURNAL_SHARD_RE.match(name):
                continue
            if name.startswith(("router-", "state-", "delta-",
                                "MANIFEST.")):
                _unlink(os.path.join(d, name))

    # -- recovery ---------------------------------------------------------

    @owner_loop
    def recover(self) -> dict:
        """Boot-time restore: newest intact checkpoint + journal tail
        replay + session resurrection + orphan-route pruning, then a
        fresh baseline checkpoint. Corruption degrades plane-by-plane
        with the ``recovery_degraded`` alarm — a damaged directory
        costs data, never the boot."""
        t0 = time.time()
        node = self.node
        degraded: List[str] = []
        summary: Dict[str, Any] = {}
        rec_sessions: Dict[str, list] = {}  # cid -> [detached_ts, d]
        rec_retained: Dict[str, Any] = {}
        rec_tombs: Dict[str, float] = {}
        self._replaying = True
        try:
            manifest = None
            try:
                manifest = checkpoint.read_manifest(self.cfg.dir)
            except checkpoint.CheckpointError as e:
                degraded.append(f"manifest: {e}")
            jseq0 = 0
            if manifest is not None:
                jseq0 = int(manifest.get("journal_seq", 0))
                self.gen = int(manifest.get("generation", 0))
                self._load_generation(manifest, degraded,
                                      rec_sessions, rec_retained,
                                      rec_tombs, summary)
            replayed = torn_files = nfiles = 0
            seq_files = self._scan_journal_files()
            seqs = sorted(s for s in seq_files if s >= jseq0)
            for s in seqs:
                # sequences replay in order; within one sequence the
                # shard files replay in any fixed order — per-key
                # shard affinity (journal_key) makes the merge
                # converge regardless
                for name in seq_files[s]:
                    path = os.path.join(self.cfg.dir, name)
                    records, torn = wal_replay(path)
                    nfiles += 1
                    for rec in records:
                        try:
                            self._apply(rec, rec_sessions,
                                        rec_retained, rec_tombs)
                            replayed += 1
                        except Exception:
                            log.warning("skipping malformed journal "
                                        "record %r", rec[:1])
                    if torn:
                        torn_files += 1
                        log.warning("journal %s truncated at a torn "
                                    "record (crash mid-append)", path)
            self.counters["recovery.replayed"] += replayed
            self.counters["recovery.torn"] += torn_files
            if torn_files:
                node.alarms.activate(
                    "journal_torn_tail",
                    details={"journals": torn_files},
                    message="journal replay truncated at a torn "
                            "record; unsynced tail ops lost")
            resurrected = self._resurrect(rec_sessions)
            pruned = self._prune_orphan_routes(resurrected)
            self._install_retained(rec_retained, rec_tombs, degraded)
            summary.update({
                "journals": nfiles,
                "replayed_records": replayed,
                "torn_journals": torn_files,
                "sessions": len(resurrected),
                "retained": len(rec_retained),
                "routes": node.router.stats()["routes.count"],
                "pruned_refs": pruned,
                "degraded": degraded,
                "duration_s": round(time.time() - t0, 3),
                "generation": self.gen,
            })
            self.counters["recovery.sessions"] += len(resurrected)
            self.counters["recovery.routes.pruned"] += pruned
        finally:
            self._replaying = False
        if degraded:
            node.alarms.activate(
                "recovery_degraded",
                details={"planes": degraded},
                message="recovery skipped corrupt segments; state "
                        "restored partially")
        # arm the on-disk journal on a FRESH segment (never append to
        # a possibly-torn file), drain anything buffered pre-recovery,
        # and commit a baseline generation so the next crash replays
        # nothing
        ck = self._arm_journal(jseq0)
        summary["baseline"] = ck.get("generation", ck)
        self.last_recovery = summary
        log.info("recovery: %s", summary)
        return summary

    @owner_loop
    def resume(self) -> dict:
        """A node started again after :meth:`shutdown`: its live state
        stands (there is nothing to recover), but the journal was
        closed. Arm a fresh segment and commit a baseline generation,
        as :meth:`recover`'s tail does; records buffered while the
        node was stopped go into the new segment."""
        if self.wal is not None:
            return {}
        return self._arm_journal(0)

    def _arm_journal(self, jseq0: int) -> dict:
        self._seq = max(self._scan_journals() + [self._seq,
                                                 jseq0]) + 1
        wal = WalGroup(
            self.cfg.dir, self._seq, shards=self.shards,
            fsync=self.cfg.fsync,
            max_buffer=self.cfg.max_buffer_records,
            retry_backoff_s=self.cfg.retry_backoff_s,
            retry_backoff_max_s=self.cfg.retry_backoff_max_s,
            on_error=self._wal_error,
            group_window_ms=self.cfg.group_commit_window_ms)
        with self._mark_lock:
            for op in self._pending_ops:
                wal.append(op, journal_key(op))
            self._pending_ops = []
            self.wal = wal
        wal.flush()
        return self.checkpoint_now()

    def _load_generation(self, manifest, degraded, rec_sessions,
                         rec_retained, rec_tombs, summary) -> None:
        d = self.cfg.dir
        node = self.node
        rp = os.path.join(d, manifest.get("router", ""))
        crcs = manifest.get("crc", {})
        try:
            want = crcs.get(manifest.get("router"))
            if want is not None \
                    and checkpoint.file_crc(rp) != int(want):
                raise checkpoint.CheckpointError(
                    f"router segment CRC mismatch: {rp}")
            if node.router.has_routes():
                raise checkpoint.CheckpointError(
                    "router already has routes (restore needs a "
                    "fresh node)")
            info = checkpoint.load(node.router, rp)
            summary["checkpoint_routes"] = info["routes"]
            summary["tables_restored"] = info["tables_restored"]
        except (checkpoint.CheckpointError, OSError) as e:
            degraded.append(f"router: {e}")
        sp = os.path.join(d, manifest.get("state", ""))
        try:
            want = crcs.get(manifest.get("state"))
            if want is not None \
                    and checkpoint.file_crc(sp) != int(want):
                raise checkpoint.CheckpointError(
                    f"state segment CRC mismatch: {sp}")
            state = checkpoint.load_state(sp)
            for cid, ts, sd in state.get("sessions", []):
                rec_sessions[cid] = [ts, sd]
            for topic, msg in state.get("retained", []):
                rec_retained[topic] = msg
            for topic, ts in state.get("tombstones", []):
                rec_tombs[topic] = float(ts)
        except (checkpoint.CheckpointError, OSError) as e:
            degraded.append(f"state: {e}")
        # incremental delta chain: journal-style records applied in
        # generation
        # order on top of the base. A corrupt link degrades (keys
        # touched ONLY in it are lost) but later deltas still apply —
        # absolute values keep the best-effort merge consistent
        applied = 0
        for name in manifest.get("deltas", []):
            p = os.path.join(d, name)
            try:
                want = crcs.get(name)
                if want is not None \
                        and checkpoint.file_crc(p) != int(want):
                    raise checkpoint.CheckpointError(
                        f"delta segment CRC mismatch: {p}")
                blob = checkpoint.load_state(p)
                if blob.get("kind") != "delta":
                    raise checkpoint.CheckpointError(
                        f"not a delta blob: {p}")
                for rec in blob.get("records", []):
                    try:
                        self._apply(tuple(rec), rec_sessions,
                                    rec_retained, rec_tombs)
                        applied += 1
                    except Exception:
                        log.warning("skipping malformed delta "
                                    "record %r", rec[:1])
            except (checkpoint.CheckpointError, OSError) as e:
                degraded.append(f"delta {name}: {e}")
        if manifest.get("deltas"):
            summary["delta_records"] = applied

    def _apply(self, rec, rec_sessions, rec_retained,
               rec_tombs) -> None:
        """One journal record, idempotently (absolute refcounts, full
        state overwrites, keyed set/clear)."""
        op = rec[0]
        if op == "route":
            _, flt, dest, refs = rec
            self.node.router.set_route_refs(flt, dest, int(refs))
        elif op == "retain":
            _, topic, msg, ts = rec
            if msg is None:
                rec_retained.pop(topic, None)
                rec_tombs[topic] = max(rec_tombs.get(topic, 0.0),
                                       float(ts))
            else:
                rec_retained[topic] = msg
        elif op == "sess.state":
            _, cid, dts, d = rec
            rec_sessions[cid] = [dts, d]
        elif op == "sess.sub":
            _, cid, key, opts = rec
            ent = rec_sessions.get(cid)
            if ent is not None:
                ent[1]["subscriptions"][key] = opts
        elif op == "sess.unsub":
            _, cid, key = rec
            ent = rec_sessions.get(cid)
            if ent is not None:
                ent[1]["subscriptions"].pop(key, None)
        elif op == "sess.close":
            rec_sessions.pop(rec[1], None)
        else:
            raise ValueError(f"unknown journal op {op!r}")

    def _resurrect(self, rec_sessions) -> list:
        """Rebuild persistent sessions as DETACHED (the reference's
        ``disconnected`` state): broker tables re-attach without
        touching restored route refs; a reconnecting client resumes
        with session-present and replay()'s DUP redelivery."""
        from emqx_tpu_torch.session import Session

        node = self.node
        now = time.time()
        out = []
        for cid, (dts, sd) in rec_sessions.items():
            try:
                sess = Session.from_wire(sd)
            except Exception as e:
                log.warning("session %r unrecoverable: %s", cid, e)
                continue
            expiry = float(sd.get("expiry_interval", 0.0) or 0.0)
            if expiry <= 0:
                continue  # not persistent — died with the process
            detach = float(dts) if dts is not None else now
            if now - detach >= expiry:
                continue  # expired while the node was down
            sess.client_id = cid
            sess.broker = node.broker
            sess.durable = True
            sess._dur = self
            for key, opts in list(sess.subscriptions.items()):
                try:
                    node.broker.restore_subscription(sess, key, opts)
                except Exception:
                    log.exception("restoring %r of %r failed",
                                  key, cid)
            node.cm._detached[cid] = (sess, detach, expiry)
            self._detach_ts[cid] = detach
            out.append(sess)
        return out

    def _prune_orphan_routes(self, sessions) -> int:
        """Route refs whose owners were clean sessions died with the
        process — remove them exactly as their disconnects would
        have. Remote (other-node) dests are left alone: the cluster
        layer reconciles those on rejoin."""
        node = self.node
        router = node.router
        expected: Dict[tuple, int] = {}
        for sess in sessions:
            for key, opts in sess.subscriptions.items():
                flt, popts = T.parse(key)
                share = popts.get("share",
                                  getattr(opts, "share", None))
                dest = (share, node.broker.node) if share \
                    else node.broker.node
                expected[(flt, dest)] = \
                    expected.get((flt, dest), 0) + 1
        pruned = 0
        self_node = node.broker.node
        for flt, dests in router.route_table().items():
            for dest, refs in dests.items():
                local = dest == self_node or (
                    isinstance(dest, tuple) and len(dest) == 2
                    and dest[1] == self_node)
                if not local:
                    continue
                want = expected.get((flt, dest), 0)
                for _ in range(refs - want):
                    router.delete_route(flt, dest=dest)
                    pruned += 1
        return pruned

    def _install_retained(self, rec_retained, rec_tombs,
                          degraded) -> None:
        ret = self._retainer()
        if ret is None:
            if rec_retained:
                degraded.append(
                    f"retained: {len(rec_retained)} recovered "
                    f"messages but no retainer module loaded")
            return
        ret.restore_entries(rec_retained.items(), rec_tombs.items())

    # -- lifecycle / observability ---------------------------------------

    @owner_loop
    async def run(self) -> None:
        """Background flush + checkpoint cadence. Disk work runs on
        the default executor — the event loop never waits on fsync."""
        import asyncio

        loop = asyncio.get_running_loop()
        while True:
            await asyncio.sleep(self.cfg.flush_interval_ms / 1000.0)
            try:
                await loop.run_in_executor(None, self.on_batch)
                if self._checkpoint_due():
                    await loop.run_in_executor(
                        None, self.checkpoint_now)
            except Exception:
                log.exception("durability tick failed")

    def shutdown(self) -> None:
        """Graceful stop: flush everything, one final FULL checkpoint
        stamped ``clean_shutdown``, close the journal. Restart
        recovery then starts from the checkpoint instead of a journal
        replay."""
        if self.wal is None:
            return
        self._flush_states()
        self.wal.flush()
        self.checkpoint_now(clean_shutdown=True)
        # records made while the node is stopped buffer pre-arm, as
        # before recovery; :meth:`resume` drains them into a new
        # segment. The closed group's counters stay in the folds
        with self._mark_lock:
            w, self.wal = self.wal, None
        w.close()
        wi = w.info()
        for name, key in _WAL_FOLD:
            self._wal_retired[name] = \
                self._wal_retired.get(name, 0) + wi[key]

    def _wal_error(self, exc) -> None:
        """Wal flush outcome (executor thread): exc degrades to the
        ``wal_write_failed`` alarm, None clears it — both applied
        on-loop by drain_events."""
        if exc is not None:
            self._event("activate", "wal_write_failed",
                        {"error": repr(exc)},
                        "journal flush failed; memory-only with "
                        "bounded backoff retry (publishes continue)")
        else:
            self._event("deactivate", "wal_write_failed")

    def _event(self, kind: str, name: str, details: dict = None,
               message: str = "") -> None:
        self._events.append((kind, name, details or {}, message))

    @owner_loop
    def drain_events(self, alarms) -> None:
        """Apply thread-recorded alarm transitions (stats tick, main
        loop)."""
        while self._events:
            try:
                kind, name, details, message = self._events.pop(0)
            except IndexError:
                break
            if kind == "activate":
                alarms.activate(name, details=details, message=message)
            else:
                alarms.deactivate(name)

    @owner_loop
    def fold_metrics(self, metrics) -> None:
        """Fold counter DELTAS into the node metrics (stats tick) —
        the journal's own counters are written from the executor
        thread, so the lock-free metrics array only ever sees them
        from here."""
        cur = dict(self.counters)
        w = self.wal
        wi = w.info() if w is not None else {}
        for name, key in _WAL_FOLD:
            cur[name] = self._wal_retired.get(name, 0) + wi.get(key, 0)
        # records shed by the memory-only degrade path's drop-oldest
        # buffer — shard buffers AND the pre-arm pending buffer
        cur["wal.degraded.dropped"] += self._pending_dropped
        for name, val in cur.items():
            delta = val - self._last_fold.get(name, 0)
            if delta:
                metrics.inc(name, delta)
        self._last_fold = cur

    def info(self) -> dict:
        out = {
            "enabled": True,
            "dir": self.cfg.dir,
            "generation": self.gen,
            "wal_shards": self.shards,
            "journal": self.wal.info() if self.wal is not None
            else {"armed": False,
                  "pending": len(self._pending_ops),
                  "pending_dropped": self._pending_dropped},
            "dirty_sessions": len(self._dirty),
            "checkpoint_chain": {
                "base_generation": self._full_gen,
                "deltas": list(self._delta_chain),
                "full_every": self.cfg.checkpoint_full_every,
                "dirty_keys": (len(self._delta_routes)
                               + len(self._delta_retained)
                               + len(self._delta_sessions)),
            },
            "last_checkpoint_ts": self.last_checkpoint_ts,
            "checkpoint_age_s": (
                round(time.time() - self.last_checkpoint_ts, 1)
                if self.last_checkpoint_ts else None),
            "last_recovery": self.last_recovery,
            "counters": dict(self.counters),
        }
        return out


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _unlink(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass
