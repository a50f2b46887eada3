"""Distributed per-clientid lock — the cluster CM locker.

The port of the JAX package's ``cm_locker``. It mirrors
``src/emqx_cm_locker.erl:41-49`` (ekka_locker with the ``quorum``
strategy): every session open/discard/takeover for a
clientid runs under a cluster-wide lock (taken at
``src/emqx_cm.erl:209-236``), so two nodes racing the SAME clientid
serialize — the second open observes the first's registry entry and
takes over / discards it instead of double-owning the session.

Semantics:

- a lock is granted when a STRICT MAJORITY of the current membership
  accepts it (self counts); grants are owner-reentrant;
- grants are tied to the OWNER NODE's liveness, exactly like
  ekka_locker's monitored locks: ``handle_nodedown`` drops every
  grant the dead node held, so a crashed owner never deadlocks a
  clientid (the ``LEASE`` is only a generous backstop against
  same-node leaks — release runs in a ``finally``);
- an unreachable peer during acquisition triggers the normal
  nodedown path (membership shrinks — the quorum is over LIVE
  members, like ekka's after a netsplit verdict), and grant RPCs fan
  out CONCURRENTLY (ekka_locker multicall) so an uncontended open
  pays one round-trip, not N;
- a lock HELD by a live owner is waited on up to
  ``ACQUIRE_TIMEOUT``; only past that (a pathological critical
  section) does :meth:`acquire` return False and the caller proceed
  under its node-local mutex only — availability over consistency,
  the reference's post-ekka behavior once a holder is unresponsive.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

from emqx_tpu_torch.cluster import PeerUnavailableError

log = logging.getLogger("emqx_tpu_torch.cm_locker")

LEASE = 60.0            # backstop expiry for a leaked same-node grant
ACQUIRE_TIMEOUT = 10.0  # max wait on a lock held by a live owner
RETRY_DELAY = 0.05


class ClusterLocker:
    def __init__(self, cluster) -> None:
        self.cluster = cluster
        self._lock = threading.Lock()
        # client_id -> (owner node, lease expiry)
        self._table: Dict[str, Tuple[str, float]] = {}
        self._pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="cm-locker")

    # -- local grant table (self + RPC from peers) ------------------------

    def grant(self, client_id: str, owner: str) -> bool:
        """Grant (or refresh) this node's vote for ``owner`` holding
        ``client_id``; False while a live different-owner lease holds."""
        now = time.time()
        with self._lock:
            ent = self._table.get(client_id)
            if ent is not None and ent[0] != owner and ent[1] > now:
                return False
            self._table[client_id] = (owner, now + LEASE)
            return True

    def release_local(self, client_id: str, owner: str) -> None:
        with self._lock:
            ent = self._table.get(client_id)
            if ent is not None and ent[0] == owner:
                del self._table[client_id]

    # -- cluster acquire/release ------------------------------------------

    def _ask_peer(self, m: str, client_id: str, me: str):
        try:
            return m, bool(self.cluster.transport.call(
                m, "lock_acquire", client_id, me))
        except PeerUnavailableError:
            # suspect ≠ dead: no vote, no nodedown — the member is
            # skipped this round (subclass check must come first)
            return m, PeerUnavailableError
        except ConnectionError:
            return m, ConnectionError
        except Exception:
            log.exception("lock rpc to %s failed", m)
            return m, False

    def acquire(self, client_id: str) -> bool:
        """Take the cluster lock: majority of the LIVE membership.

        Blocks while another LIVE owner holds it — that wait IS the
        serialization that prevents double-owned sessions; a crashed
        holder's grants drop on its nodedown, so the wait tracks the
        holder's actual critical section, not a timer.

        A suspect/down member (PeerUnavailableError from the failure
        detector's fast-fail gate) is neither a vote
        nor a death: it is excluded from the quorum denominator for
        this attempt, so a CONNECT never blocks ``call_timeout`` on a
        peer the detector already holds unhealthy — quorum proceeds
        over the responsive membership and ``cluster.locker.degraded``
        counts the degradation."""
        me = self.cluster.name
        deadline = time.monotonic() + ACQUIRE_TIMEOUT
        while True:
            peers = [m for m in list(self.cluster.members) if m != me]
            granted = []
            suspect = []
            if self.grant(client_id, me):
                granted.append(me)
            # concurrent fan-out (ekka_locker multicall): one
            # round-trip per attempt regardless of cluster size
            for m, res in self._pool.map(
                    lambda p: self._ask_peer(p, client_id, me), peers):
                if res is ConnectionError:
                    # unreachable peer: with the failure detector
                    # armed the verdict is DEFERRED to it (a
                    # transient call error to a LIVE member must not
                    # shrink the membership, Cluster._peer_call_failed);
                    # legacy transports keep the nodedown-now path
                    self.cluster._peer_call_failed(m)
                elif res is PeerUnavailableError:
                    # suspect ≠ dead: no vote, no nodedown, no wait
                    suspect.append(m)
                elif res:
                    granted.append(m)
            live = set(self.cluster.members)
            votes = len([g for g in granted if g in live])
            if votes * 2 > len(live):
                return True
            responsive = live - set(suspect)
            if suspect and responsive and votes * 2 > len(responsive):
                # majority of the members that can answer at all:
                # proceed (availability over a full quorum — the
                # suspect peer is either dead, in which case nodedown
                # will shrink the membership anyway, or partitioned,
                # in which case anti-entropy reconciles the registry
                # after heal), but make the degradation observable
                self.cluster._count("locker.degraded")
                log.warning(
                    "cluster lock on %r granted by %d/%d with %r "
                    "suspect — degraded quorum", client_id, votes,
                    len(live), suspect)
                return True
            # held elsewhere: release partial grants so the competing
            # owner can win, then retry until the deadline
            for g in granted:
                if g == me:
                    self.release_local(client_id, me)
                else:
                    try:
                        self.cluster.transport.cast(
                            g, "lock_release", client_id, me)
                    except ConnectionError:
                        pass
            if time.monotonic() >= deadline:
                break
            # jittered backoff: two nodes racing in lockstep must
            # not retry in lockstep forever
            time.sleep(RETRY_DELAY * (0.5 + random.random()))
        log.warning("cluster lock on %r unattainable within %.0fs "
                    "(members=%r) — proceeding under the local mutex "
                    "only", client_id, ACQUIRE_TIMEOUT,
                    self.cluster.members)
        return False

    def release(self, client_id: str) -> None:
        me = self.cluster.name
        self.release_local(client_id, me)
        self.cluster._broadcast("lock_release", client_id, me)

    def drop_owner(self, node: str) -> int:
        """Drop every grant a dead node holds (called from the
        cluster's nodedown path — the ekka_locker monitored-lock
        cleanup): a crashed holder releases immediately instead of
        deadlocking its clientids until the lease backstop."""
        with self._lock:
            dead = [c for c, (o, _e) in self._table.items()
                    if o == node]
            for c in dead:
                del self._table[c]
        return len(dead)

    def sweep(self) -> int:
        """Drop expired leases (housekeeping; grant() also treats an
        expired lease as free)."""
        now = time.time()
        with self._lock:
            dead = [c for c, (_o, exp) in self._table.items()
                    if exp <= now]
            for c in dead:
                del self._table[c]
        return len(dead)

    def info(self) -> Dict[str, Tuple[str, float]]:
        with self._lock:
            return dict(self._table)
