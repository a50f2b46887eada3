"""Cluster layer: membership, replicated routes, cross-node
forwarding, node-down cleanup — behind one RPC seam.

The port of the JAX package's ``cluster`` module. It maps the
reference's distribution stack (SURVEY §2.3):

  - ekka membership           → :class:`Cluster` join/leave/nodedown,
    transitive (membership is a set agreed by all members)
  - Mnesia route replication  → one logical route per (filter, dest)
    replicated to every member (bag semantics; local refcounts stay
    node-private and only edge transitions broadcast), reads stay
    node-local like replicated ram_copies (src/emqx_router.erl:77-86)
  - gen_rpc data plane        → :class:`Transport` — in-process
    :class:`LocalTransport` for tests and single-host multi-node; the
    socket transport (``cluster_net.py``) plugs in the same seam
  - node-down route purge     → :meth:`Cluster.handle_nodedown`
    (emqx_router_helper:135-144, emqx_cm_registry:123-128)
  - shared groups             → one delivery per group cluster-wide:
    the publishing node picks ONE member node per (group, filter)
    (weighted round-robin over nodes) and forwards; the picked node
    runs its local strategy (src/emqx_shared_sub.erl:229-244)

The device angle: each member keeps its own automaton on its own
device; route replication means every node's automaton covers the
whole cluster's filter set, so any node matches locally in one walk
(kernel B1) and only *deliveries* cross nodes. A forwarded message is
dispatched on the receiving node by its already-matched filter, on
the host: it launches no kernel there.

Replicated durability rides this module: every clustered node
carries a :class:`~emqx_tpu_torch.replication.ReplicationManager`
(:attr:`Cluster.replication`) that holds warm standby replicas for its
peers, arms the journal shipper when its durability config names
standbys, promotes on a primary's nodedown, hands the adopted state
back when the primary heals, and answers the ``repl_*`` and
``drain_digest`` operations (the drain's custody hand-off,
``drain.py``). The port's broker has no ban table, so the ``bans``
plane is always empty and ``ban_add``/``ban_del`` do nothing — as on a
JAX node that holds no ban.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

from emqx_tpu_torch.concurrency import (any_thread, bg_thread,
                                        owner_loop, shared_state)
from emqx_tpu_torch.replication import (ReplicationManager, _sub_route,
                                        sessions_digest)
from emqx_tpu_torch.types import Message

log = logging.getLogger("emqx_tpu_torch.cluster")


class PeerUnavailableError(ConnectionError):
    """A call was refused WITHOUT touching the wire because the
    failure detector holds the peer suspect/down. Distinct from a
    plain ConnectionError on purpose: a suspect peer is *unconfirmed*
    — callers must degrade (skip the vote, hand out a fresh session)
    but never purge, which is exactly what the generic
    ``except ConnectionError: handle_nodedown`` sites do."""

    def __init__(self, node: str, state: str) -> None:
        super().__init__(f"peer {node} is {state} (fast-fail)")
        self.node = node
        self.state = state


@dataclasses.dataclass
class ClusterConfig:
    """``[cluster]`` section: failure detector + auto-heal knobs.
    ``detector = false`` reproduces the EOF-only behavior exactly — no
    heartbeats, no suspect state, no fast-fail, no bounded-coroutine
    calls, no auto-heal."""

    #: heartbeat failure detector (ok → suspect → down state machine
    #: over periodic per-peer pings). Off = link-EOF detection.
    detector: bool = True
    #: seconds between heartbeat rounds
    heartbeat_interval_s: float = 1.0
    #: per-ping RTT deadline; a reply slower than this is a miss
    heartbeat_timeout_s: float = 1.0
    #: consecutive misses before ok → suspect (casts park, nothing
    #: is purged)
    suspect_after: int = 2
    #: consecutive misses before suspect → down (nodedown dispatched)
    down_after: int = 5
    #: consecutive successes before suspect → ok (hysteresis up)
    ok_after: int = 2
    #: a downed peer that reappears triggers an automatic rejoin
    #: handshake + anti-entropy reconciliation
    auto_heal: bool = True
    #: background anti-entropy sweep period (repairs missed
    #: at-most-once casts); 0 disables the sweep (heal-triggered
    #: syncs still run)
    anti_entropy_interval_s: float = 30.0
    #: per-peer RPC deadline — bounds the caller's wait and the
    #: in-flight coroutine (the link is dropped on expiry so a stale
    #: late reply can never desync the frame stream)
    call_timeout_s: float = 10.0
    #: calls to a suspect/down member raise PeerUnavailableError
    #: immediately instead of dialing into the timeout
    suspect_fast_fail: bool = True
    #: redial backoff to a peer whose dials keep failing
    #: (exponential from the base, capped at the max)
    redial_backoff_s: float = 0.5
    redial_backoff_max_s: float = 5.0

    #: live-reloadable knobs: the detector loop and the call gate read
    #: these per round / per call off the shared config object.
    #: ``detector`` decides what gets built; ``call_timeout_s`` is
    #: captured by the transport at construction;
    #: ``anti_entropy_interval_s`` by the heal worker's queue timeout
    #: (not a dataclass field: unannotated)
    RELOADABLE = frozenset({
        "heartbeat_interval_s", "heartbeat_timeout_s",
        "suspect_after", "down_after", "ok_after", "auto_heal",
        "suspect_fast_fail", "redial_backoff_s",
        "redial_backoff_max_s"})

    def __post_init__(self) -> None:
        if self.heartbeat_interval_s <= 0:
            raise ValueError("cluster.heartbeat_interval_s must be > 0")
        if self.heartbeat_timeout_s <= 0:
            raise ValueError("cluster.heartbeat_timeout_s must be > 0")
        if self.suspect_after < 1:
            raise ValueError("cluster.suspect_after must be >= 1")
        if self.down_after < self.suspect_after:
            raise ValueError(
                "cluster.down_after must be >= suspect_after")
        if self.ok_after < 1:
            raise ValueError("cluster.ok_after must be >= 1")
        if self.anti_entropy_interval_s < 0:
            raise ValueError(
                "cluster.anti_entropy_interval_s must be >= 0")
        if self.call_timeout_s <= 0:
            raise ValueError("cluster.call_timeout_s must be > 0")
        if self.redial_backoff_s <= 0:
            raise ValueError("cluster.redial_backoff_s must be > 0")
        if self.redial_backoff_max_s < self.redial_backoff_s:
            raise ValueError(
                "cluster.redial_backoff_max_s must be >= "
                "redial_backoff_s")


class Transport:
    """RPC seam (emqx_rpc): deliver opaque calls to peer nodes."""

    def cast(self, node: str, op: str, *args) -> None:
        raise NotImplementedError

    def call(self, node: str, op: str, *args):
        raise NotImplementedError

    # -- failure-detector seam (no-ops for transports without one) --------

    def peer_state(self, node: str) -> str:
        """``ok`` | ``suspect`` | ``down`` — transports without a
        detector report every peer healthy."""
        return "ok"

    def health_info(self) -> Dict[str, dict]:
        """Per-peer detector state for operators (stats)."""
        return {}

    def drain_counters(self) -> Dict[str, int]:
        """Transport-level event counters since the last drain."""
        return {}

    def set_departed(self, node: str) -> None:
        """Mark a peer as having LEFT deliberately: the detector must
        stop probing it for reappearance (a left node answering pings
        must not be dragged back into the cluster)."""


class LocalTransport(Transport):
    """In-process transport: peers are Cluster objects in this
    process (the reference tests fake remote nodes the same way,
    test/emqx_broker_SUITE)."""

    def __init__(self) -> None:
        self._peers: Dict[str, "Cluster"] = {}

    def register(self, node: str, cluster: "Cluster") -> None:
        self._peers[node] = cluster

    def unregister(self, node: str) -> None:
        self._peers.pop(node, None)

    def cast(self, node: str, op: str, *args) -> None:
        peer = self._peers.get(node)
        if peer is None:
            raise ConnectionError(f"node down: {node}")
        peer.handle_rpc(op, *args)

    def call(self, node: str, op: str, *args):
        peer = self._peers.get(node)
        if peer is None:
            raise ConnectionError(f"node down: {node}")
        return peer.handle_rpc(op, *args)


@shared_state(lock="_lock", attrs=("members", "_registry"))
class Cluster:
    """Per-node cluster agent: wires a Node's broker/router into the
    membership + replication + forwarding protocol."""

    def __init__(self, node, transport: Optional[Transport] = None,
                 config: Optional[ClusterConfig] = None) -> None:
        self.node = node            # emqx_tpu_torch.node.Node
        self.name = node.name
        self.transport = transport or LocalTransport()
        self.config = config
        self.members: List[str] = [self.name]
        self._lock = threading.Lock()
        # cluster-plane event counters, drained into Metrics by the
        # node's stats tick (names land as ``cluster.<key>``)
        self._counters: Dict[str, int] = {}
        # anti-entropy bookkeeping for stats
        self._ae_info: Dict[str, object] = {
            "sweeps": 0, "repairs": 0, "last_sweep_ts": None,
            "last_repairs": 0, "last_peer": None}
        # auto-heal / background-sweep worker: heal requests from the
        # failure detector queue here; queue timeouts pace the sweep.
        # Only a configured cluster WITH the detector on spawns the
        # thread — a bare Cluster(node, transport) stays thread-free,
        # and ``detector = false`` builds no heal worker and no sweep
        self._heal_q: "queue.Queue" = queue.Queue()
        self._healing: set = set()
        self._stopping = False
        self._ae_rr = -1
        self._heal_thread: Optional[threading.Thread] = None
        if config is not None and config.detector and (
                config.auto_heal or config.anti_entropy_interval_s > 0):
            self._heal_thread = threading.Thread(
                target=self._heal_main, daemon=True,
                name=f"cluster-heal-{self.name}")
            self._heal_thread.start()
        self._shared_rr: Dict[Tuple[str, str], int] = {}
        # replicated per-node shared-group member counts: the
        # reference picks over the full replicated member table
        # (src/emqx_shared_sub.erl:229-244); replicating COUNTS gives
        # the same distribution without replicating member pids
        self._shared_weights: Dict[Tuple[str, str, str], int] = {}
        # replicated clientid -> node registry (emqx_cm_registry:
        # Mnesia bag emqx_channel_registry); covers live and detached
        # sessions so cross-node takeover can find the owner
        self._registry: Dict[str, str] = {}
        # takeover parking: a session handed out by ``takeover_client``
        # whose REPLY is lost (a stale link) must not evaporate — the
        # owner parks it until the taker's client_up confirms custody;
        # the taker's retry (paced by the ServerBusy answer) collects
        # it. cid -> (session, parked_at); TTL-pruned, client_up-cleared
        self._takeover_parked: Dict[str, tuple] = {}
        # distributed per-clientid lock (emqx_cm_locker / ekka_locker
        # quorum) — taken by cm around open/discard/takeover
        from emqx_tpu_torch.cm_locker import ClusterLocker
        self.locker = ClusterLocker(self)
        node.cm.cluster = self
        if hasattr(node, "cluster"):
            node.cluster = self  # node-level accessor (stats)
        # replicated durability (replication.py): every clustered
        # node can hold warm standby replicas for its peers; a node
        # whose durability config names standbys also arms the
        # journal shipper
        self.replication = ReplicationManager(node, self)
        node.replication = self.replication
        dur = getattr(node, "durability", None)
        if dur is not None and dur.cfg.standby_list:
            self.replication.arm_shipper(dur)
        # intercept local route mutations for replication
        self._orig_add = node.router.add_route
        self._orig_del = node.router.delete_route
        node.router.add_route = self._add_route_replicated
        node.router.delete_route = self._del_route_replicated
        node.broker.forwarder = self._forward
        node.broker.shared_router = self._route_shared
        # intercept shared-membership mutations to replicate weights
        shared = node.broker.shared
        self._orig_shared_sub = shared.subscribe
        self._orig_shared_unsub = shared.unsubscribe
        self._orig_shared_down = shared.subscriber_down
        shared.subscribe = self._shared_sub_replicated
        shared.unsubscribe = self._shared_unsub_replicated
        shared.subscriber_down = self._shared_down_replicated
        # retained-store replication seam: the retainer module (if
        # loaded, now or later) broadcasts its stores/deletes (the
        # reference plugin replicates via Mnesia)
        node.retain_replicate = (
            lambda topic, msg, ts=None: self._broadcast(
                "retain_set", topic, msg, ts))
        if isinstance(self.transport, LocalTransport):
            self.transport.register(self.name, self)
        elif hasattr(self.transport, "cluster"):
            # socket transport: inbound RPCs route back through us
            self.transport.cluster = self

    # -- membership (ekka) ------------------------------------------------

    def join(self, other: "Cluster") -> None:
        """Merge the two membership sets cluster-wide and sync routes
        to/from every member (transitive: all members of both sides
        learn the union)."""
        union = sorted(set(self.members) | set(other.members))
        self._propagate_union(union)

    def join_remote(self, host: str, port: int) -> None:
        """Join a cluster through a peer's socket address (the
        ``emqx_ctl cluster join`` flow over the wire): fetch the
        peer's member + address book, merge, propagate the union to
        every member, then sync routes all around — the same protocol
        :meth:`join` runs for in-process peers."""
        tr = self.transport
        info = tr.call_addr((host, port), "cluster_info")
        addrs = dict(info["addrs"])
        # the peer self-reports its bind address, which may be
        # unroutable from here (0.0.0.0, loopback on another host);
        # the dialed address demonstrably works — use it, and
        # propagate it to the rest of the cluster
        addrs[info["name"]] = (host, port)
        addrs.update(tr.addr_book())
        if tr.host in ("0.0.0.0", "::", ""):
            # same problem in reverse: advertise the local interface
            # the working dial went out of, not the wildcard bind
            local_ip = tr.local_ip_for((host, port))
            if local_ip:
                addrs[self.name] = (local_ip, tr.port)
        union = sorted(set(self.members) | set(info["members"]))
        for m, a in addrs.items():
            if m != self.name:
                tr.register_peer(m, *a)
        self._propagate_union(union, addrs)

    def _propagate_union(self, union: List[str],
                         addrs: Optional[Dict] = None,
                         sync_routes: bool = True) -> None:
        """Tell every member the merged membership (and, over a
        socket transport, the address book), then sync routes all
        around — shared by in-process join and join_remote.
        ``sync_routes=False`` (the auto-heal path) skips the full
        route push: anti-entropy re-pushes only the diff.

        A member that died moments ago may still be in the book its
        peers handed us (their probe hasn't declared nodedown yet):
        an unreachable member must not abort the join — it is skipped
        and the membership machinery reaps it."""
        unreachable: List[str] = []
        suspect: List[str] = []
        for m in union:
            if m == self.name:
                self._set_members(union)
                continue
            try:
                if addrs is not None:
                    self.transport.call(m, "set_members_net", union,
                                        addrs)
                else:
                    self.transport.call(m, "set_members", union)
            except PeerUnavailableError as e:
                # suspect ≠ dead: skip it (the heal/anti-entropy
                # machinery re-merges once the detector clears it)
                # but NEVER purge on suspicion
                log.warning("join: member %s suspect (%s); skipping",
                            m, e)
                suspect.append(m)
            except ConnectionError as e:
                log.warning("join: member %s unreachable (%s); "
                            "skipping", m, e)
                unreachable.append(m)
        for m in union if sync_routes else ():
            if m == self.name:
                self._push_owned_routes()
            elif m not in unreachable and m not in suspect:
                try:
                    self.transport.call(m, "push_routes")
                except PeerUnavailableError as e:
                    log.warning("join: member %s suspect (%s); "
                                "skipping push", m, e)
                    suspect.append(m)
                except ConnectionError as e:
                    log.warning("join: push_routes to %s failed (%s)",
                                m, e)
                    unreachable.append(m)
        # reap what we just proved dead, the way every other
        # ConnectionError site here does. Suspect members are NOT
        # reaped, and with the detector armed the verdict is deferred
        # to it
        for m in unreachable:
            self._peer_call_failed(m)

    @any_thread
    def _set_members(self, members: List[str]) -> None:
        with self._lock:
            self.members = list(members)

    def _push_owned_routes(self) -> None:
        for flt in self.node.router.topics():
            for r in self.node.router.lookup_routes(flt):
                if self._owned(r.dest, self.name):
                    self._broadcast("route_add", flt, r.dest)
        # ...and this node's clientid-registry claims, batched (ONE
        # cast per peer): a freshly restarted node would otherwise
        # serve reconnects with a FRESH session until anti-entropy
        with self._lock:
            owned = [c for c, n in self._registry.items()
                     if n == self.name]
        if owned:
            self._broadcast("registry_sync", self.name, owned)
        # new joiners also need our shared-group weights
        for (group, flt), members in \
                self.node.broker.shared._subs.items():
            if members:
                self._broadcast("shared_weight", group, flt,
                                self.name, len(members))
        # ...and the retained store: ONE batched cast per peer
        # (idempotent timestamp-LWW on the receiver)
        ret = self._retainer()
        if ret is not None:
            entries = ret.entries()
            tombs = ret.tombstones()
            if entries or tombs:
                self._broadcast("retain_sync", entries, tombs)

    def _retainer(self):
        mods = getattr(self.node, "modules", None)
        return mods._loaded.get("retainer") if mods is not None else None

    @staticmethod
    def _owned(dest, name: str) -> bool:
        return dest == name or (isinstance(dest, tuple) and dest[1] == name)

    def leave(self) -> None:
        """Leave the cluster: tell everyone, purge every ex-member's
        routes locally (the symmetric half of nodedown). The
        ``leaving`` announcement (vs a detector-observed death) also
        tells each peer's failure detector to stop probing us for
        reappearance."""
        ex = [m for m in self.members if m != self.name]
        for m in ex:
            try:
                self.transport.cast(m, "leaving", self.name)
            except ConnectionError:
                pass
        with self._lock:
            self.members = [self.name]
        for m in ex:
            self._purge_node_routes(m)

    @any_thread
    def _peer_call_failed(self, name: str) -> None:
        """A call/cast to a member failed with a transport error.
        With the failure detector armed, one transient error is NOT
        a death verdict: the failed dial already dropped the link
        (straight to suspect) and the detector's miss counting
        delivers the real verdict. Detector-less transports keep the
        EOF-only behavior: the error IS the only failure detection."""
        tr = self.transport
        if getattr(tr, "_hb_enabled", False):
            self._count("rpc.errors")
            return
        self.handle_nodedown(name)

    @any_thread
    def handle_nodedown(self, name: str) -> None:
        """Purge a dead member's routes + registry entries
        (emqx_router_helper cleanup + emqx_cm_registry
        cleanup_channels, §3.5)."""
        with self._lock:
            if name in self.members:
                self.members.remove(name)
            dead = [c for c, n in self._registry.items() if n == name]
            for c in dead:
                del self._registry[c]
            for k in [k for k in self._shared_weights if k[2] == name]:
                del self._shared_weights[k]
        # a dead node's clientid locks release NOW (ekka_locker's
        # monitored-lock cleanup) — waiters unblock immediately
        self.locker.drop_owner(name)
        self._purge_node_routes(name)
        # warm-standby failover (replication.py): AFTER the purge —
        # the promotion re-installs the dead primary's durable state
        # remapped to this node with exact refcounts. On its own
        # thread: nodedown is dispatched on the transport IO loop,
        # and the promotion ARBITRATION makes synchronous calls to
        # co-standbys that must not block that loop against itself
        if self.replication is not None \
                and name in self.replication.replicas:
            def _promote_check(repl=self.replication, dead=name):
                try:
                    repl.maybe_promote(dead)
                except Exception:
                    log.exception("standby promotion check for %s "
                                  "failed", dead)
            t = threading.Thread(
                target=_promote_check, daemon=True,
                name=f"repl-promote-{self.name}")
            t.start()

    # -- clientid registry + cross-node takeover (emqx_cm_registry) -------

    @any_thread
    def client_up(self, client_id: str) -> None:
        with self._lock:
            self._registry[client_id] = self.name
        self._broadcast("client_up", client_id, self.name)

    @any_thread
    def client_down(self, client_id: str) -> None:
        with self._lock:
            if self._registry.get(client_id) == self.name:
                self._registry.pop(client_id, None)
        self._broadcast("client_down", client_id, self.name)

    def locate_client(self, client_id: str) -> Optional[str]:
        return self._registry.get(client_id)

    def claim_parked(self, client_id: str):
        """Collect a reply-loss-parked takeover copy locally (a
        client dialing the parking node directly must find its
        session, not a fresh one)."""
        ent = self._takeover_parked.pop(client_id, None)
        return ent[0] if ent is not None else None

    @any_thread
    def reassign_client(self, client_id: str, owner: str) -> None:
        """Point the registry at ``owner`` on every member (a node
        dropping its stale copy of a session must also retract its
        owner-authoritative registry claim, or anti-entropy
        propagates the wrong owner forever)."""
        with self._lock:
            self._registry[client_id] = owner
        self._broadcast("client_up", client_id, owner)

    def remote_discard(self, client_id: str, node: str) -> None:
        """Old session on another node must die (clean start)."""
        try:
            self.transport.call(node, "discard_client", client_id)
        except PeerUnavailableError:
            # suspect owner: proceed without the discard (the CONNECT
            # must not block); anti-entropy reconciles the registry
            # once the peer recovers or is confirmed down
            log.warning("remote discard of %s skipped: owner %s "
                        "suspect", client_id, node)
        except ConnectionError:
            self._peer_call_failed(node)

    def remote_takeover(self, client_id: str, node: str):
        """Pull the session from its current owner node
        (emqx_cm:takeover_session RPC, src/emqx_cm.erl:263-272). The
        caller's name rides along so the owner can move the route
        contributions with the session (see _local_takeover)."""
        try:
            return self.transport.call(node, "takeover_client",
                                       client_id, self.name)
        except PeerUnavailableError as e:
            if e.state == "suspect":
                # suspect ≠ dead: the registry NAMES this owner, so
                # the session exists — let the caller (the cm chase)
                # wait out the detector's hysteresis, bounded, instead
                # of minting a fresh session. A confirmed-down owner
                # still degrades to a fresh session immediately.
                return {"suspect": node}
            log.warning("remote takeover of %s skipped: owner %s "
                        "%s — fresh session", client_id, node,
                        e.state)
            return None
        except ConnectionError:
            self._peer_call_failed(node)
            if getattr(self.transport, "_hb_enabled", False):
                # the call may have EXECUTED with the reply lost (the
                # owner parked the handed session): answer BUSY so
                # the client's retry re-chases and collects it
                return {"suspect": node}
            return None
        except Exception:
            # a takeover failure must degrade to a fresh session,
            # never kill the CONNECT (the reference's badrpc path)
            log.exception("remote takeover of %s from %s failed",
                          client_id, node)
            return None

    def _local_takeover(self, client_id: str, taker=None):
        cm = self.node.cm
        # TTL prune of the parking lot (bounded bookkeeping)
        now = time.time()
        for cid in [c for c, (_s, ts) in
                    self._takeover_parked.items() if now - ts > 60.0]:
            self._takeover_parked.pop(cid, None)
        chan = cm.lookup_channel(client_id)
        if chan is None and self.replication is not None \
                and self.replication.adopting(client_id):
            # mid-hand-off adopted copy (see ReplicationManager
            # .adopting): not serveable until the final marker lands
            return {"suspect": self.name}
        dr = getattr(self.node, "drain", None)
        if chan is None and dr is not None and dr.active \
                and dr.target is not None \
                and (client_id in cm._detached
                     or client_id in self._takeover_parked):
            # custody is ALREADY moving through the drain hand-off
            # (dual-route, digest-verified — loss-free under live
            # traffic). A client-initiated pull racing it would rip
            # the session out mid-transfer and drop every forward in
            # the pull window; defer instead — the caller answers
            # ServerBusy and the client's retry lands on the target
            return {"suspect": self.name}
        sess = None
        if chan is not None:
            sess = cm._takeover(chan)
        elif client_id in cm._detached:
            sess, _ts, _exp = cm._detached.pop(client_id)
        if sess is None and client_id in self._takeover_parked:
            # a previous hand-out's reply was lost: the taker's retry
            # collects the parked copy instead of finding nothing
            return self._takeover_parked.pop(client_id)[0]
        cm.cancel_will(client_id)  # connection re-established elsewhere
        if sess is None:
            # not held here (anymore): if OUR registry already knows
            # the new custodian — a drain hand-off or failback moved
            # it while the caller still held a stale claim — answer
            # with a forwarding marker so the caller chases the
            # custody chain instead of minting a fresh session
            with self._lock:
                owner = self._registry.get(client_id)
            if owner is not None and owner != self.name:
                return {"moved": owner}
            return None
        # the keys whose route refs the detach below drops (through
        # the broker's unsubscribe, the replicated wrapper: the
        # zero-edge broadcasts route_del)
        held = set(self.node.broker.subscriptions(sess))
        if taker:
            # move the route contributions WITH the session — BEFORE
            # detaching its dispatch wiring: install the taker's dest
            # locally NOW (idempotent; its broadcast confirms) and
            # drop this node's refs of the keys the broker does not
            # hold (the detach drops the others). The JAX package
            # drops every key's ref here AND in the detach, so a
            # filter another local session still holds loses its
            # route (fault C.4). A local publish in the detach window
            # reaches the (still-wired) session object, which travels
            # with it, and the taker.
            for key in list(getattr(sess, "subscriptions", {})):
                try:
                    flt, dest = _sub_route(key, taker)
                    self._apply_route("add", flt, dest)
                    if key in held:
                        continue
                    flt2, dest2 = _sub_route(key, self.name)
                    if self.node.router.route_refs(flt2, dest2) > 0:
                        self.node.router.delete_route(flt2,
                                                      dest=dest2)
                except Exception:
                    log.exception("moving route of %r for %r failed",
                                  key, client_id)
        # hand-off: drop table entries here without death-path
        # side effects; the new node's resume() resubscribes. The
        # broker/notify references MUST be severed: over a socket
        # transport the session travels as data (``to_wire``)
        self.node.broker.detach_subscriber(sess)
        sess.notify = None
        sess.broker = None
        d = getattr(self.node, "durability", None)
        if d is not None and getattr(sess, "durable", False):
            # the session now lives on the taking node: a stale
            # state record left in OUR journal would resurrect it
            d.session_closed(client_id)
        # park until the taker's client_up confirms custody: if the
        # REPLY below is lost to a broken link, the severed session
        # would otherwise be gone from every node
        self._takeover_parked[client_id] = (sess, time.time())
        return sess

    def _purge_node_routes(self, name: str) -> None:
        self.node.router.cleanup_routes(name)
        # shared-group routes carry (group, node) dests
        for flt in list(self.node.router.topics()):
            for r in self.node.router.lookup_routes(flt):
                if isinstance(r.dest, tuple) and r.dest[1] == name:
                    self._orig_del(flt, dest=r.dest)

    # -- route replication (mnesia ram_copies analogue) -------------------

    def _add_route_replicated(self, flt: str, dest=None):
        dest = self.name if dest is None else dest
        fresh = not self.node.router.has_dest(flt, dest)
        fid = self._orig_add(flt, dest=dest)
        if fresh:  # only edge transitions replicate (bag semantics)
            self._broadcast("route_add", flt, dest)
        return fid

    def _del_route_replicated(self, flt: str, dest=None) -> None:
        dest = self.name if dest is None else dest
        self._orig_del(flt, dest=dest)
        if not self.node.router.has_dest(flt, dest):
            self._broadcast("route_del", flt, dest)

    def _broadcast(self, op: str, *args) -> None:
        for m in list(self.members):
            if m == self.name:
                continue
            try:
                self.transport.cast(m, op, *args)
            except ConnectionError:
                self._peer_call_failed(m)

    def _apply_route(self, op: str, flt: str, dest) -> None:
        """Idempotent remote apply — always through the ORIGINAL
        router methods (a replicated apply must never re-broadcast)."""
        if op == "add":
            if not self.node.router.has_dest(flt, dest):
                self._orig_add(flt, dest=dest)
        else:
            dests = self.node.router._routes.get(flt)
            if dests is not None and dest in dests:
                dests[dest] = 1
                self._orig_del(flt, dest=dest)

    # -- data plane (gen_rpc analogue) ------------------------------------

    def _forward(self, node: str, flt: str, msg: Message) -> None:
        if "_wire" in msg.headers:
            # the local-delivery wire cache must not travel: rebuild
            # with the headers minus the cache (a full msg.copy()
            # would deep-copy the very bytes being discarded, once
            # per destination node)
            msg = Message(
                topic=msg.topic, payload=msg.payload, qos=msg.qos,
                from_=msg.from_, flags=dict(msg.flags),
                headers={k: v for k, v in msg.headers.items()
                         if k != "_wire"},
                id=msg.id, timestamp=msg.timestamp)
        try:
            self.transport.cast(node, "forward", flt, msg)
        except ConnectionError:
            self._peer_call_failed(node)

    def _local_shared_count(self, group: str, flt: str) -> int:
        return len(self.node.broker.shared._subs.get((group, flt), ()))

    def _broadcast_weight(self, group: str, flt: str) -> None:
        self._broadcast("shared_weight", group, flt, self.name,
                        self._local_shared_count(group, flt))

    def _shared_sub_replicated(self, group, flt, sub) -> None:
        self._orig_shared_sub(group, flt, sub)
        self._broadcast_weight(group, flt)

    def _shared_unsub_replicated(self, group, flt, sub) -> None:
        self._orig_shared_unsub(group, flt, sub)
        self._broadcast_weight(group, flt)

    def _shared_down_replicated(self, sub) -> None:
        before = [k for k, m in self.node.broker.shared._subs.items()
                  if sub in m]
        self._orig_shared_down(sub)
        for group, flt in before:
            self._broadcast_weight(group, flt)

    def _weight(self, group: str, flt: str, node: str) -> int:
        if node == self.name:
            return max(1, self._local_shared_count(group, flt))
        return max(1, self._shared_weights.get((group, flt, node), 1))

    def _route_shared(self, group: str, flt: str, nodes: List[str],
                      msg: Message) -> int:
        """One delivery per (group, filter) cluster-wide: weighted
        round-robin over the member nodes (weight = that node's
        member count, replicated on membership changes), then the
        picked node's local strategy chooses the subscriber — a node
        with 100 members gets 100x the share of a node with 1,
        matching the reference's pick over the global member table
        (src/emqx_shared_sub.erl:229-244)."""
        if not nodes:
            return 0
        key = (group, flt)
        ordered = sorted(nodes)
        # under the lock: the IO thread (forwarded publishes) and the
        # serving loop both route shared messages — the rr counter is
        # a read-modify-write, and weights are written by handle_rpc
        with self._lock:
            weights = [self._weight(group, flt, x) for x in ordered]
            total = sum(weights)
            n = (self._shared_rr.get(key, -1) + 1) % total
            self._shared_rr[key] = n
        target = ordered[-1]
        acc = 0
        for node_name, w in zip(ordered, weights):
            acc += w
            if n < acc:
                target = node_name
                break
        if target == self.name:
            return self.node.broker.shared.dispatch(group, flt, msg)
        try:
            self.transport.cast(target, "forward_shared", group, flt, msg)
            return 0  # remote delivery, not counted locally
        except ConnectionError:
            # availability: re-route this delivery around the failed
            # member either way; the death verdict is the detector's
            self._peer_call_failed(target)
            rest = [x for x in nodes if x != target]
            return self._route_shared(group, flt, rest, msg)

    # -- counters / observability -----------------------------------------

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def drain_counters(self) -> Dict[str, int]:
        """Cluster + transport event-counter deltas since the last
        drain; the node's stats tick folds them into Metrics as
        ``cluster.<key>``."""
        with self._lock:
            out = dict(self._counters)
            self._counters.clear()
        for k, v in self.transport.drain_counters().items():
            out[k] = out.get(k, 0) + v
        return out

    def ae_info(self) -> dict:
        """Anti-entropy sweep/repair summary for stats."""
        with self._lock:
            return dict(self._ae_info)

    # -- auto-heal + anti-entropy -----------------------------------------
    #
    # The replication casts above are at-most-once (gen_rpc async
    # cast semantics): a dropped cast would diverge the replica planes
    # forever. Anti-entropy closes the loop: per-plane digests are
    # exchanged and diffed, and only the differing entries cross the
    # wire again. It runs (a) as the reconciliation half of an
    # auto-heal rejoin and (b) as a low-frequency background sweep
    # (one peer per round).
    #
    # Consistency contract per plane:
    #   routes / registry / weights — OWNER-authoritative: each
    #     node's view of node X's entries is replaced by X's own set
    #     (adds AND stale deletes repaired, no tombstones needed);
    #   bans      — longest-ban-wins merge (empty on the port: no ban
    #     table until banned.py);
    #   retained  — timestamp LWW with delete tombstones (the
    #     retainer's join-sync rules).

    def schedule_heal(self, name: str) -> None:
        """Queue an auto-heal rejoin with a reappeared peer.
        Thread-safe — called from the transport's IO loop."""
        if self._heal_thread is None or self.config is None \
                or not self.config.auto_heal or self._stopping:
            return
        self._heal_q.put(name)

    def close(self) -> None:
        """Stop the heal/anti-entropy worker and the journal shipper
        (Node.stop)."""
        self._stopping = True
        if self.replication is not None:
            self.replication.close()
        if self._heal_thread is not None:
            self._heal_q.put(None)
            self._heal_thread.join(timeout=5)
            self._heal_thread = None

    @bg_thread
    def _heal_main(self) -> None:
        interval = self.config.anti_entropy_interval_s or None
        while True:
            try:
                item = self._heal_q.get(timeout=interval)
            except queue.Empty:
                item = None  # sweep tick
            if self._stopping:
                return
            try:
                if item is None:
                    self._ae_sweep_once()
                else:
                    self._heal_rejoin(item)
            except Exception:
                log.exception("cluster heal/anti-entropy pass failed")

    def _heal_rejoin(self, name: str) -> None:
        """The auto-heal handshake with a reappeared peer: re-merge
        membership (the join protocol, minus its full route push) and
        reconcile every replicated plane via anti-entropy. Both sides
        typically run this concurrently — every step is idempotent."""
        if name in self._healing:
            return
        self._healing.add(name)
        try:
            addr = getattr(self.transport, "_peers", {}).get(name)
            call_addr = getattr(self.transport, "call_addr", None)
            if addr is None or call_addr is None:
                return
            info = call_addr(addr, "cluster_info")
            addrs = dict(info["addrs"])
            addrs[info["name"]] = addr
            addrs.update(self.transport.addr_book())
            union = sorted(set(self.members) | set(info["members"]))
            for m, a in addrs.items():
                if m != self.name:
                    self.transport.register_peer(m, *a)
            self._propagate_union(union, addrs, sync_routes=False)
            n = self.anti_entropy_sync(name)
            self._count("heal.rejoins")
            with self._lock:
                self._ae_info["repairs"] += n
                self._ae_info["last_sweep_ts"] = time.time()
                self._ae_info["last_repairs"] = n
                self._ae_info["last_peer"] = name
            log.warning("cluster auto-heal: rejoined %s "
                        "(%d entries repaired)", name, n)
        except ConnectionError as e:
            log.warning("cluster auto-heal with %s failed: %s",
                        name, e)
        finally:
            # FAILBACK (replication.py): a healed peer we promoted
            # for gets its adopted state handed back — even when the
            # anti-entropy half of the rejoin failed transiently (the
            # sweep below retries it periodically regardless)
            if self.replication is not None:
                try:
                    self.replication.maybe_failback(name)
                except Exception:
                    log.exception("failback scheduling for %s "
                                  "failed", name)
            self._healing.discard(name)

    def _ae_sweep_once(self) -> None:
        """One background anti-entropy round: sync with ONE live
        peer (round-robin) — N nodes sweeping all-to-all every
        interval would be O(N²) traffic for no extra convergence.
        Also the failback retry tick: a promoted replica whose primary
        is back and healthy hands its state back even if every
        event-driven trigger was lost."""
        if self.replication is not None:
            try:
                self.replication.retry_failbacks()
            except Exception:
                log.exception("failback retry sweep failed")
        peers = sorted(m for m in list(self.members)
                       if m != self.name
                       and self.transport.peer_state(m) == "ok")
        if not peers:
            return
        self._ae_rr += 1
        peer = peers[self._ae_rr % len(peers)]
        try:
            n = self.anti_entropy_sync(peer)
        except ConnectionError as e:
            log.debug("anti-entropy with %s failed: %s", peer, e)
            return
        self._count("ae.sweeps")
        with self._lock:
            self._ae_info["sweeps"] += 1
            self._ae_info["repairs"] += n
            self._ae_info["last_sweep_ts"] = time.time()
            self._ae_info["last_repairs"] = n
            self._ae_info["last_peer"] = peer

    #: planes where each entry has an authoritative owner node
    _OWNER_PLANES = ("routes", "registry", "weights")

    @any_thread
    def anti_entropy_sync(self, peer: str) -> int:
        """Reconcile all five replicated planes with ``peer``; returns
        the number of entries repaired (pushed + pulled). One digest
        round-trip when everything already matches."""
        tr = self.transport
        mine = {p: self._plane_digest(p, self.name)
                for p in self._OWNER_PLANES}
        merged = {"bans": self._plane_digest("bans", None),
                  "retained": self._plane_digest("retained", None)}
        reply = tr.call(peer, "ae_digests", self.name, mine, merged)
        repairs = 0
        # push: planes where the peer's replica of OUR entries drifted
        for plane in reply.get("want", ()):
            entries = self._plane_entries(plane, self.name)
            n = tr.call(peer, "ae_apply", self.name, plane, entries)
            repairs += int(n or 0)
        # pull: planes where our replica of the PEER's entries drifted
        for plane, dg in reply.get("mine", {}).items():
            if dg != self._plane_digest(plane, peer):
                entries = tr.call(peer, "ae_entries", plane)
                repairs += self._ae_reconcile(plane, peer, entries)
        pm = reply.get("merged", {})
        if pm.get("bans") != merged["bans"]:
            repairs += self._ae_reconcile(
                "bans", peer, tr.call(peer, "ae_entries", "bans"))
            n = tr.call(peer, "ae_apply", self.name, "bans",
                        self._plane_entries("bans", None))
            repairs += int(n or 0)
        if pm.get("retained") != merged["retained"]:
            repairs += self._retained_sync(peer)
        if repairs:
            self._count("ae.repairs", repairs)
        return repairs

    @staticmethod
    def _digest(entries) -> str:
        """Stable digest over a canonically ordered entry list."""
        h = hashlib.sha1()
        for e in entries:
            h.update(repr(e).encode())
            h.update(b"\x00")
        return h.hexdigest()

    def plane_digests(self) -> Dict[str, str]:
        """Whole-table digest per replicated plane — equal digests
        across members == converged cluster (the convergence
        predicate of the partition tests and the smoke's 13d)."""
        return {"routes": self._plane_digest("routes", None),
                "registry": self._plane_digest("registry", None),
                "weights": self._plane_digest("weights", None),
                "bans": self._plane_digest("bans", None),
                "retained": self._plane_digest("retained", None)}

    def _route_entries(self, owner: Optional[str]) -> list:
        out = []
        for flt in self.node.router.topics():
            for r in self.node.router.lookup_routes(flt):
                if owner is None or self._owned(r.dest, owner):
                    out.append((flt, r.dest))
        out.sort(key=repr)
        return out

    def _plane_entries(self, plane: str, owner: Optional[str]):
        """Canonical transferable entry list for one plane. ``owner``
        scopes the owner-authoritative planes; None = whole table
        (merge planes + digest oracles)."""
        if plane == "routes":
            return self._route_entries(owner)
        if plane == "registry":
            with self._lock:
                if owner is None:
                    return sorted(self._registry.items())
                return sorted(c for c, n in self._registry.items()
                              if n == owner)
        if plane == "weights":
            local = {(g, f): len(m) for (g, f), m in
                     self.node.broker.shared._subs.items() if m}
            if owner == self.name:
                return sorted((g, f, c) for (g, f), c in local.items())
            with self._lock:
                if owner is not None:
                    return sorted((g, f, c) for (g, f, n), c in
                                  self._shared_weights.items()
                                  if n == owner)
                out = [(g, f, self.name, c)
                       for (g, f), c in local.items()]
                out += [(g, f, n, c) for (g, f, n), c in
                        self._shared_weights.items() if n != self.name]
                return sorted(out)
        if plane == "bans":
            return []  # no ban table until banned.py
        raise ValueError(f"bad anti-entropy plane: {plane}")

    def _retained_idx(self) -> Dict[str, tuple]:
        """topic -> (timestamp, payload hash): the retained plane's
        per-entry diff index (full messages only cross the wire for
        topics whose index entry differs)."""
        ret = self._retainer()
        if ret is None:
            return {}
        return {t: (float(m.timestamp),
                    hashlib.sha1(bytes(m.payload)).hexdigest())
                for t, m in ret.entries()}

    def _plane_digest(self, plane: str, owner: Optional[str]) -> str:
        if plane == "retained":
            ret = self._retainer()
            tombs = sorted(ret.tombstones()) if ret is not None else []
            return self._digest(
                sorted(self._retained_idx().items()) + tombs)
        return self._digest(self._plane_entries(plane, owner))

    def _ae_reconcile(self, plane: str, owner: str, entries) -> int:
        """Apply a peer's authoritative entry set for one plane;
        returns the number of local entries changed. Owner planes
        REPLACE our replica of ``owner``'s entries (repairing stale
        survivors of missed deletes); retained MERGES."""
        if owner == self.name:
            return 0  # nobody rewrites our view of our own entries
        repairs = 0
        if plane == "routes":
            want = {(flt, tuple(d) if isinstance(d, (list, tuple))
                     else d) for flt, d in entries}
            cur = {(flt, tuple(d) if isinstance(d, (list, tuple))
                    else d) for flt, d in self._route_entries(owner)}
            for flt, dest in want - cur:
                self._apply_route("add", flt, dest)
                repairs += 1
            for flt, dest in cur - want:
                self._apply_route("del", flt, dest)
                repairs += 1
            return repairs
        if plane == "registry":
            want = set(entries)
            with self._lock:
                stale = [c for c, n in self._registry.items()
                         if n == owner and c not in want]
                for c in stale:
                    del self._registry[c]
                    repairs += 1
                for c in want:
                    if self._registry.get(c) != owner:
                        self._registry[c] = owner
                        repairs += 1
            return repairs
        if plane == "weights":
            want = {(g, f): int(c) for g, f, c in entries}
            with self._lock:
                stale = [k for k in self._shared_weights
                         if k[2] == owner and (k[0], k[1]) not in want]
                for k in stale:
                    del self._shared_weights[k]
                    repairs += 1
                for (g, f), c in want.items():
                    if c > 0 and \
                            self._shared_weights.get((g, f, owner)) != c:
                        self._shared_weights[(g, f, owner)] = c
                        repairs += 1
            return repairs
        if plane == "bans":
            return 0  # no ban table until banned.py
        if plane == "retained":
            ret = self._retainer()
            if ret is None or not isinstance(entries, dict):
                return 0
            for topic, ts in entries.get("tombs", ()):
                ret.apply_tombstone(topic, float(ts))
            for topic, msg in entries.get("entries", ()):
                ret.apply_remote(topic, msg, sync=True)
                repairs += 1
            return repairs
        raise ValueError(f"bad anti-entropy plane: {plane}")

    def _retained_sync(self, peer: str) -> int:
        """Entry-level retained reconciliation: exchange (timestamp,
        payload-hash) indexes, transfer full messages only for
        differing topics, merge tombstones both ways — LWW on both
        sides makes over-transfer harmless and order irrelevant."""
        ret = self._retainer()
        if ret is None:
            return 0
        tr = self.transport
        remote = tr.call(peer, "ae_retained_idx")
        if not isinstance(remote, dict):
            return 0  # peer has no retainer loaded
        ridx = {t: (float(ts), ph) for t, ts, ph in remote["idx"]}
        mine = self._retained_idx()
        repairs = 0
        for t, ts in remote.get("tombs", ()):
            ret.apply_tombstone(t, float(ts))
        pull = [t for t, v in ridx.items() if mine.get(t) != v]
        if pull:
            for topic, msg in tr.call(peer, "ae_fetch_retained", pull):
                if msg is not None:
                    ret.apply_remote(topic, msg, sync=True)
                    repairs += 1
        push = [t for t, v in mine.items() if ridx.get(t) != v]
        entries = [(t, ret._store[t]) for t in push
                   if t in ret._store]
        tombs = ret.tombstones()
        if entries or tombs:
            n = tr.call(peer, "ae_apply", self.name, "retained",
                        {"entries": entries, "tombs": tombs})
            repairs += int(n or 0)
        return repairs

    @owner_loop
    def handle_rpc(self, op: str, *args):
        if op == "route_add":
            return self._apply_route("add", args[0], args[1])
        if op == "route_del":
            return self._apply_route("del", args[0], args[1])
        if op == "forward":
            flt, msg = args
            b = self.node.broker
            b.metrics.inc("messages.received")
            # dispatch by the already-matched filter (no re-match, no
            # kernel launch, no shared dispatch — shared goes via
            # forward_shared)
            n = b.dispatch(flt, msg)
            if not n and getattr(msg, "qos", 0) > 0 \
                    and not msg.headers.get("fwd_bounce"):
                # the session this forward targeted MOVED between the
                # cast and its delivery (a takeover, a parked cast
                # replayed after a heal): re-route once to the
                # filter's CURRENT owners — scoped to this filter's
                # routes, one bounce max, so a QoS>0 delivery survives
                # a custody move instead of dying on the stale owner
                msg.headers["fwd_bounce"] = True
                for r in self.node.router.lookup_routes(flt):
                    if isinstance(r.dest, tuple):
                        continue  # shared groups pick per-dispatch
                    if r.dest != self.name:
                        self._forward(r.dest, flt, msg)
            return n
        if op == "forward_shared":
            group, flt, msg = args
            return self.node.broker.shared.dispatch(group, flt, msg)
        if op == "client_up":
            cid, name = args
            with self._lock:
                self._registry[cid] = name
            # custody confirmed elsewhere: a parked takeover copy
            # (reply-loss insurance) is no longer needed
            if name != self.name:
                self._takeover_parked.pop(cid, None)
            return None
        if op == "client_down":
            cid, name = args
            with self._lock:
                if self._registry.get(cid) == name:
                    self._registry.pop(cid, None)
            return None
        if op == "registry_sync":
            # join-time batched registry push (owner-authoritative,
            # idempotent — the per-entry analogue of client_up)
            owner, cids = args
            with self._lock:
                for cid in cids:
                    self._registry[cid] = owner
            return None
        if op == "discard_client":
            # the REQUESTING node holds the cluster lock for this
            # clientid — re-acquiring here would deadlock on it
            return self.node.cm.discard_session(args[0],
                                                cluster_lock=False)
        if op == "takeover_client":
            return self._local_takeover(
                args[0], args[1] if len(args) > 1 else None)
        if op == "lock_acquire":
            return self.locker.grant(args[0], args[1])
        if op == "lock_release":
            return self.locker.release_local(args[0], args[1])
        if op == "set_members":
            return self._set_members(args[0])
        if op == "ping":
            return "pong"
        if op == "retain_set":
            ret = self._retainer()
            if ret is not None:
                ret.apply_remote(args[0], args[1],
                                 ts=args[2] if len(args) > 2 else None)
            return None
        if op == "retain_sync":
            ret = self._retainer()
            if ret is not None:
                for topic, msg in args[0]:
                    ret.apply_remote(topic, msg, sync=True)
                for topic, ts in (args[1] if len(args) > 1 else []):
                    ret.apply_tombstone(topic, ts)
            return None
        if op in ("ban_add", "ban_del"):
            return None  # no ban table until banned.py
        if op == "shared_weight":
            group, flt, node, count = args
            with self._lock:
                if count > 0:
                    self._shared_weights[(group, flt, node)] = count
                else:
                    self._shared_weights.pop((group, flt, node), None)
            return None
        if op == "cluster_info":
            return {"name": self.name, "members": list(self.members),
                    "addrs": self.transport.addr_book()}
        if op == "set_members_net":
            members, addrs = args
            for m, a in addrs.items():
                if m != self.name:
                    self.transport.register_peer(m, *a)
            return self._set_members(members)
        if op == "push_routes":
            return self._push_owned_routes()
        if op == "nodedown":
            return self.handle_nodedown(args[0])
        if op == "leaving":
            # a DELIBERATE departure (vs a detector-observed death):
            # same purge, but the failure detector must also stop
            # probing the leaver for reappearance
            self.transport.set_departed(args[0])
            return self.handle_nodedown(args[0])
        if op == "ae_digests":
            from_name, owned, merged = args
            want = [p for p, dg in owned.items()
                    if p in self._OWNER_PLANES
                    and dg != self._plane_digest(p, from_name)]
            return {
                "want": want,
                "mine": {p: self._plane_digest(p, self.name)
                         for p in self._OWNER_PLANES},
                "merged": {
                    "bans": self._plane_digest("bans", None),
                    "retained": self._plane_digest("retained", None)},
            }
        if op == "ae_entries":
            plane = args[0]
            return self._plane_entries(
                plane, self.name if plane in self._OWNER_PLANES
                else None)
        if op == "ae_apply":
            from_name, plane, entries = args
            return self._ae_reconcile(plane, from_name, entries)
        if op == "ae_retained_idx":
            ret = self._retainer()
            if ret is None:
                return None
            return {"idx": [(t, ts, ph) for t, (ts, ph) in
                            self._retained_idx().items()],
                    "tombs": ret.tombstones()}
        if op == "ae_fetch_retained":
            ret = self._retainer()
            if ret is None:
                return []
            return [(t, ret._store.get(t)) for t in args[0]
                    if t in ret._store]
        if op == "repl_hello":
            # replicated durability (replication.py): arm/resync the
            # warm standby replica for the calling primary
            return self.replication.handle_hello(args[0], args[1],
                                                 int(args[2]))
        if op == "repl_ship":
            return self.replication.handle_ship(args[0], int(args[1]),
                                                args[2])
        if op == "repl_bye":
            return self.replication.handle_bye(args[0], bool(args[1]))
        if op == "repl_replica_info":
            # promotion arbitration: a co-standby compares warm-replica
            # offsets before promoting
            return self.replication.handle_replica_info(args[0])
        if op == "repl_failback":
            # FAILBACK: the promoted standby hands the adopted state
            # back to this (restarted) primary — also the receive side
            # of a DRAIN custody hand-off (drain.py): same chunked
            # full-state adoption, same journaling
            return self.replication.handle_failback(args[0], args[1])
        if op == "overload_level":
            # a draining peer adapts its disconnect budget to THIS
            # node's overload level
            ov = getattr(self.node, "overload", None)
            return int(ov.level) if ov is not None else 0
        if op == "drain_digest":
            # drain custody verification: digest of the named sessions
            # as THIS node now holds them
            return sessions_digest(self.node, args[0])
        raise ValueError(f"bad rpc op: {op}")
