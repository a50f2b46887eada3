"""Overload protection and self-healing: the port of the JAX package's
``overload.py``.

  - :class:`OverloadMonitor` samples the event loop's lag, the ingress
    queue depth, the fetch executor's backlog and the process RSS into
    an ok → warn → critical state machine. Each level sheds: warn drops
    QoS 0 at mqueue pressure, critical also divides the ingress
    high-water mark (publishers pause reading sooner) and refuses new
    CONNECTs with ServerBusy. It also supervises the background
    pieces: a crashed compaction is alarmed and retried after its
    backoff (executor heal lives in ``ingress.py``).
  - :class:`DeviceBreaker` is a circuit breaker on the device publish
    path: consecutive device-step failures (or steps slower than
    ``breaker_slow_ms``) trip matching to the exact host trie; after
    ``cooldown_s`` one half-open probe batch rides the device again
    and closes the breaker or re-opens it. A trip that the sentinel
    classifies as a LOST backend enters ``REBUILDING`` instead:
    :class:`~emqx_tpu_torch.devloss.DeviceRecovery` rebuilds every
    device-resident table from the host structures, re-warms the
    kernels, and only then admits the probe.

Every batch the breaker serves from the host is counted
(``breaker.fallback.batches``) and an alarm is active the whole time;
a kernel library that fails to build raises when the ``Broker`` is
built, before any breaker exists, so a build failure is never served
from the host.

``OverloadConfig(enabled=False)`` builds none of this: every hot-path
guard reads a ``None`` attribute. On a multi-loop node the monitor
also probes every peer loop each tick (a probe not run by the next tick
reads as critical lag) and heals a loop whose thread died: it routes
around it and closes its connections from the main loop, so their
wills fire.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import threading
import time
from typing import Dict, Optional

log = logging.getLogger("emqx_tpu_torch.overload")

#: overload levels (gauge value = index)
OK, WARN, CRITICAL = 0, 1, 2
LEVEL_NAMES = ("ok", "warn", "critical")


@dataclasses.dataclass
class OverloadConfig:
    """The ``[overload]`` section (closed schema), with the JAX
    package's defaults."""

    enabled: bool = True
    #: monitor sample interval (seconds)
    interval_s: float = 1.0
    #: event-loop lag thresholds (the long_schedule signal)
    lag_warn_ms: float = 200.0
    lag_critical_ms: float = 1000.0
    #: ingress accumulator depth thresholds, in multiples of the
    #: batcher's queue high-water mark
    queue_warn: float = 2.0
    queue_critical: float = 8.0
    #: process RSS thresholds in MB; 0 = RSS not consulted
    rss_warn_mb: float = 0.0
    rss_critical_mb: float = 0.0
    #: consecutive clean samples before the level steps DOWN
    #: (upgrades apply immediately; hysteresis only on the way out)
    clear_ticks: int = 3
    #: warn+: drop QoS0 deliveries once a session's mqueue is past
    #: half its bound (QoS0 has no redelivery contract)
    shed_qos0: bool = True
    #: critical: refuse new CONNECTs with ServerBusy (0x89) —
    #: existing connections keep their service
    reject_connects: bool = True
    #: critical: divide the ingress high-water mark by this, so
    #: publisher read-pauses engage earlier (active_n pulled harder)
    critical_hiwater_div: int = 4
    #: per-connection force-shutdown policy: a connected session
    #: whose outbox+mqueue exceeds this is killed (the reference's
    #: per-process OOM shutdown, emqx_connection.erl:657-665).
    #: 0 = off.
    force_shutdown_queue_len: int = 0
    #: bound on a publisher's wait for a saturated ingress
    #: accumulator: past it the publisher is shed (disconnected)
    #: instead of parking forever. 0 = unbounded.
    ingress_wait_timeout_s: float = 30.0
    # -- device-path circuit breaker --------------------------------------
    breaker: bool = True
    #: consecutive device-step failures that trip the breaker open
    breaker_failures: int = 3
    #: seconds the breaker stays open before a half-open probe
    breaker_cooldown_s: float = 5.0
    #: a successful device fetch slower than this counts as a
    #: failure (a stalled device is as bad as a dead one); 0 = off
    breaker_slow_ms: float = 0.0
    # -- device-loss recovery (devloss.py) --------------------------------
    #: classify breaker trips with a sentinel device op and, on a
    #: LOST backend, rebuild all device-resident state from the host
    #: structures before admitting the half-open probe; False = an
    #: open breaker on a dead backend probes forever
    breaker_rebuild: bool = True
    #: initial retry backoff after a failed rebuild attempt
    #: (exponential, capped at 30 s — the device may still be gone)
    rebuild_backoff_s: float = 0.5
    #: bound on the sentinel classification op: a backend that cannot
    #: answer a trivial device op within this is LOST (a hung runtime
    #: classifies the same as a dead one)
    sentinel_timeout_s: float = 5.0

    #: the knobs a live reload may change (kept as data for the
    #: operations slice; not a dataclass field: unannotated).
    #: ``enabled``/``breaker``/``breaker_rebuild`` decide what gets
    #: BUILT; ``interval_s`` is captured by the monitor loop
    RELOADABLE = frozenset({
        "lag_warn_ms", "lag_critical_ms", "queue_warn",
        "queue_critical", "rss_warn_mb", "rss_critical_mb",
        "clear_ticks", "shed_qos0", "reject_connects",
        "critical_hiwater_div", "force_shutdown_queue_len",
        "ingress_wait_timeout_s", "breaker_failures",
        "breaker_cooldown_s", "breaker_slow_ms",
        "rebuild_backoff_s", "sentinel_timeout_s"})

    def __post_init__(self) -> None:
        if self.interval_s <= 0:
            raise ValueError("overload.interval_s must be > 0")
        if self.lag_warn_ms > self.lag_critical_ms:
            raise ValueError("overload.lag_warn_ms must be <= "
                             "lag_critical_ms")
        if self.queue_warn > self.queue_critical:
            raise ValueError("overload.queue_warn must be <= "
                             "queue_critical")
        if self.clear_ticks < 1:
            raise ValueError("overload.clear_ticks must be >= 1")
        if self.critical_hiwater_div < 1:
            raise ValueError("overload.critical_hiwater_div must "
                             "be >= 1")
        if self.force_shutdown_queue_len < 0:
            raise ValueError("overload.force_shutdown_queue_len "
                             "must be >= 0")
        if self.ingress_wait_timeout_s < 0:
            raise ValueError("overload.ingress_wait_timeout_s must "
                             "be >= 0")
        if self.breaker_failures < 1:
            raise ValueError("overload.breaker_failures must be >= 1")
        if self.breaker_cooldown_s <= 0:
            raise ValueError("overload.breaker_cooldown_s must be > 0")
        if self.rebuild_backoff_s <= 0:
            raise ValueError("overload.rebuild_backoff_s must be > 0")
        if self.sentinel_timeout_s <= 0:
            raise ValueError("overload.sentinel_timeout_s must be > 0")


class DeviceBreaker:
    """Circuit breaker on the device publish path (match + fan-out +
    fetch). CLOSED = the device serves; OPEN = every batch takes the
    exact host trie; HALF_OPEN = exactly one probe batch rides the
    device and its outcome decides; REBUILDING = the backend was
    classified LOST and :mod:`~emqx_tpu_torch.devloss` is rebuilding
    the device state from the host structures — no probe is admitted
    until the rebuilt tables are published and the kernels re-warmed.
    Failure recording is thread-safe: fetches run on the ingress
    executor, recovery on its own thread.

    ``strict`` (the Node sets it on a CUDA device) keeps the card's
    work on the card: an open breaker then diverts batches to the host
    only when an injected fault tripped it or the recovery confirmed
    the backend lost (:meth:`diverts`). A trip by a real failure or a
    slow step is counted, alarmed and classified all the same, and
    the batches keep launching on the card."""

    CLOSED, HALF_OPEN, OPEN, REBUILDING = 0, 1, 2, 3
    STATE_NAMES = ("closed", "half_open", "open", "rebuilding")

    def __init__(self, metrics, alarms=None, failures: int = 3,
                 cooldown_s: float = 5.0, slow_ms: float = 0.0,
                 strict: bool = False) -> None:
        self.metrics = metrics
        self.alarms = alarms
        self.threshold = max(1, failures)
        self.cooldown_s = cooldown_s
        self.slow_ms = slow_ms
        self.state = self.CLOSED
        self.failures = 0
        self._open_until = 0.0
        self._probing = False
        self.strict = strict
        #: the trip came from an injected fault or a confirmed loss
        self._divert = False
        self._lock = threading.Lock()
        #: device-loss recovery (devloss.DeviceRecovery), attached by
        #: the Node when ``breaker_rebuild``; None = an OPEN breaker
        #: probes forever on a dead backend
        self.recovery = None

    def allow_device(self) -> bool:
        """May this batch use the device path? CLOSED is a lock-free
        read (the per-batch hot-path cost); OPEN returns False until
        the cooldown elapses, then admits ONE half-open probe;
        REBUILDING never admits a probe — :meth:`rebuild_complete`
        (not the cooldown clock) re-arms the half-open window."""
        if self.state == self.CLOSED:
            return True
        with self._lock:
            if self.state == self.OPEN \
                    and time.monotonic() >= self._open_until:
                self.state = self.HALF_OPEN
            if self.state == self.HALF_OPEN and not self._probing:
                self._probing = True
                probe = True
            else:
                probe = False
        if probe:
            self.metrics.inc("breaker.probes")
            log.info("device-path breaker: half-open probe")
        return probe

    def diverts(self) -> bool:
        """May a batch this breaker does not admit go to the host?
        Always, unless ``strict``; then only after an injected fault
        or a confirmed loss."""
        return not self.strict or self._divert

    def record_success(self, elapsed_s: float = 0.0) -> None:
        """A device batch completed. A completion slower than
        ``slow_ms`` counts as a failure. A success arriving in OPEN or
        REBUILDING is a pre-trip in-flight batch completing late: it
        must NOT close the breaker nor preempt a rebuild — the
        half-open probe is the only evidence that counts."""
        if self.slow_ms and elapsed_s * 1000.0 > self.slow_ms:
            self.record_failure(
                reason=f"slow device step {elapsed_s * 1000.0:.0f}ms"
                       f" > {self.slow_ms:.0f}ms")
            return
        if self.state == self.CLOSED and not self.failures:
            return
        with self._lock:
            if self.state in (self.OPEN, self.REBUILDING):
                return
            was = self.state
            self.state = self.CLOSED
            self.failures = 0
            self._probing = False
            self._divert = False
        if was != self.CLOSED:
            log.info("device-path breaker closed: probe succeeded "
                     "(device path recovered)")
            if self.alarms is not None:
                self.alarms.deactivate("device_path_breaker")
                # the device_path_lost clear is the recovered signal
                self.alarms.deactivate("device_path_lost")

    def record_failure(self, reason: str = "device step failed",
                       injected: bool = False) -> None:
        """A device step failed (``injected``: by an armed fault)."""
        self.metrics.inc("breaker.failures")
        with self._lock:
            self.failures += 1
            tripped = (self.state == self.HALF_OPEN
                       or (self.state == self.CLOSED
                           and self.failures >= self.threshold))
            if tripped:
                self._divert = injected
                self.state = self.OPEN
                self._open_until = time.monotonic() + self.cooldown_s
                self._probing = False
        if tripped:
            self.metrics.inc("breaker.trips")
            log.error("device-path breaker OPEN (%s; %d consecutive "
                      "failures): host-trie matching for %.1fs",
                      reason, self.failures, self.cooldown_s)
            if self.alarms is not None:
                self.alarms.activate(
                    "device_path_breaker",
                    details={"failures": self.failures,
                             "cooldown_s": self.cooldown_s,
                             "reason": reason},
                    message="device publish path tripped to "
                            "host-oracle fallback")
            rec = self.recovery
            if rec is not None:
                # classify the trip off the hot path: a sentinel
                # device op tells a slow batch (transient — the
                # cooldown probe handles it) from a dead runtime
                # (enter REBUILDING and rebuild the device state)
                rec.on_trip(reason)

    def enter_rebuilding(self) -> bool:
        """OPEN → REBUILDING (the recovery classified the backend
        LOST). False if the breaker moved on meanwhile (a racing probe
        closed it — nothing to rebuild)."""
        with self._lock:
            if self.state not in (self.OPEN, self.HALF_OPEN):
                return False
            self.state = self.REBUILDING
            self._probing = False
            self._divert = True
        log.error("device-path breaker REBUILDING: backend lost — "
                  "rebuilding device state from host structures")
        return True

    def rebuild_complete(self) -> None:
        """The rebuilt tables are published and the kernels warmed:
        admit the half-open probe NOW (no cooldown wait — the probe
        rides fresh state, not the dead buffers that tripped us)."""
        with self._lock:
            if self.state != self.REBUILDING:
                return
            self.state = self.HALF_OPEN
            self._probing = False
            self.failures = 0
        log.warning("device-state rebuild complete: half-open probe "
                    "window armed")

    def info(self) -> dict:
        out = {
            "state": self.STATE_NAMES[self.state],
            "failures": self.failures,
            "threshold": self.threshold,
            "open_for_s": round(
                max(0.0, self._open_until - time.monotonic()), 3)
            if self.state == self.OPEN else 0.0,
        }
        rec = self.recovery
        if rec is not None:
            out.update(rec.info())
        return out


def read_rss_mb() -> Optional[float]:
    """Process resident set from /proc/self/status, None off-Linux."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except (OSError, ValueError, IndexError):
        pass
    return None


class OverloadMonitor:
    """The ok → warn → critical state machine plus the self-healing
    sweeps. One async :meth:`run` loop on the node's loop; :meth:`tick`
    is the step the tests drive directly."""

    def __init__(self, node, config: OverloadConfig) -> None:
        self.node = node
        self.cfg = config
        self.level = OK
        self._clean = 0
        #: the last sample set
        self.samples: Dict[str, object] = {}
        # peer-loop probe bookkeeping: loop index -> the last posted
        # and the last seen probe sequence
        self._probe_sent: Dict[int, int] = {}
        self._probe_seen: Dict[int, int] = {}
        self._seq = 0

    # -- shedding predicates (consulted on hot paths) ---------------------

    def reject_connects(self) -> bool:
        return self.cfg.reject_connects and self.level >= CRITICAL

    def shed_qos0(self, qlen: int, max_len: int) -> bool:
        """Drop a QoS0 enqueue? Only at warn+ and only once the
        session's mqueue is past half its bound (an unbounded queue
        never sheds — there is no pressure signal to act on)."""
        return (self.cfg.shed_qos0 and self.level >= WARN
                and max_len > 0 and qlen * 2 >= max_len)

    # -- the monitor loop -------------------------------------------------

    async def run(self) -> None:
        iv = self.cfg.interval_s
        while True:
            t0 = time.perf_counter()
            await asyncio.sleep(iv)
            lag_ms = max(0.0, (time.perf_counter() - t0 - iv) * 1000.0)
            try:
                self.tick(lag_ms)
            except Exception:
                log.exception("overload monitor tick failed")

    def info(self) -> dict:
        """The level, the clean-tick streak and the last samples
        (``ctl overload``)."""
        return {
            "level": LEVEL_NAMES[self.level],
            "clean_ticks": self._clean,
            "samples": dict(self.samples),
        }

    def reset(self) -> None:
        """The monitor stopped (``Node.stop``): no sample backs the
        level any more, so the shedding ends — back to ok, the alarm
        cleared, the ingress mark restored."""
        self._clean = 0
        self._transition(OK)

    def tick(self, home_lag_ms: float = 0.0) -> int:
        """One monitor step: sample → evaluate → transition → heal.
        Returns the (possibly new) level."""
        s = self._sample(home_lag_ms)
        self.samples = s
        lvl = self._evaluate(s)
        if lvl >= self.level:
            self._clean = 0
            if lvl > self.level:
                self._transition(lvl)
        else:
            self._clean += 1
            if self._clean >= self.cfg.clear_ticks:
                self._transition(lvl)
                self._clean = 0
        self._heal()
        self._sweep_force_shutdown()
        return self.level

    def _sample(self, home_lag_ms: float) -> Dict[str, object]:
        node = self.node
        s: Dict[str, object] = {"lag_ms": round(home_lag_ms, 1)}
        ing = node.ingress
        if ing is not None:
            s["ingress_queue"] = len(ing._pending)
            s["ingress_hiwater"] = ing.queue_hiwater
            s["ingress_inflight"] = ing._inflight
            s["executor_saturated"] = ing._inflight >= ing.max_inflight
        rss = read_rss_mb()
        if rss is not None:
            s["rss_mb"] = round(rss, 1)
        # peer-loop liveness probes: a posted probe that has not run by
        # the NEXT tick means that loop lagged a whole interval —
        # critical lag; a dead thread is the heal sweep's
        lg = node.loop_group
        if lg is not None and lg.loops:
            stuck = []
            for i in range(1, lg.n):
                if not lg.alive(i):
                    continue
                sent = self._probe_sent.get(i, 0)
                seen = self._probe_seen.get(i, 0)
                if sent and seen < sent:
                    stuck.append(i)
                self._seq += 1
                self._probe_sent[i] = self._seq

                def _mark(idx=i, seq=self._seq):
                    self._probe_seen[idx] = max(
                        self._probe_seen.get(idx, 0), seq)

                try:
                    lg.post(i, _mark)
                except RuntimeError:
                    stuck.append(i)
            s["loops_stuck"] = stuck
        return s

    def _evaluate(self, s: Dict[str, object]) -> int:
        cfg = self.cfg
        lvl = OK

        def bump(to: int) -> None:
            nonlocal lvl
            lvl = max(lvl, to)

        lag = float(s.get("lag_ms", 0.0))
        if lag >= cfg.lag_critical_ms:
            bump(CRITICAL)
        elif lag >= cfg.lag_warn_ms:
            bump(WARN)
        if s.get("loops_stuck"):
            bump(CRITICAL)
        q = s.get("ingress_queue")
        if q is not None:
            hw = max(1, int(s.get("ingress_hiwater", 1)))
            ratio = q / hw
            if ratio >= cfg.queue_critical:
                bump(CRITICAL)
            elif ratio >= cfg.queue_warn:
                bump(WARN)
        rss = s.get("rss_mb")
        if rss is not None:
            if cfg.rss_critical_mb and rss >= cfg.rss_critical_mb:
                bump(CRITICAL)
            elif cfg.rss_warn_mb and rss >= cfg.rss_warn_mb:
                bump(WARN)
        return lvl

    def _transition(self, new: int) -> None:
        old = self.level
        if new == old:
            return
        self.level = new
        node = self.node
        node.metrics.inc("overload.transitions")
        ing = node.ingress
        if ing is not None:
            ing.set_pressure(self.cfg.critical_hiwater_div
                             if new >= CRITICAL else 1)
        if new == OK:
            log.info("overload cleared (was %s)", LEVEL_NAMES[old])
            node.alarms.deactivate("overload")
        else:
            log.warning("overload level %s (was %s): %s",
                        LEVEL_NAMES[new], LEVEL_NAMES[old],
                        self.samples)
            # re-raise so the alarm's details carry the CURRENT level
            # (activate is a no-op on an active name)
            node.alarms.deactivate("overload")
            node.alarms.activate(
                "overload",
                details={"level": LEVEL_NAMES[new],
                         "samples": dict(self.samples)},
                message=f"broker overload: {LEVEL_NAMES[new]}")

    # -- self-healing sweeps ----------------------------------------------

    def _heal(self) -> None:
        node = self.node
        # crashed background flatten: surface the alarm and re-kick
        # the compaction once its backoff elapsed
        node.drain_robustness_events()
        node.router.retry_compaction()
        # a dead front-door loop: close its connections so their wills
        # fire, and route the delivery ring around it
        lg = node.loop_group
        if lg is not None:
            for idx in lg.dead_peer_indices():
                self._heal_dead_loop(idx)
        # the ingress saturation alarm clears once the backlog drained
        ing = node.ingress
        if ing is not None and not ing.backlogged():
            node.alarms.deactivate("ingress_saturated")

    def _heal_dead_loop(self, idx: int) -> None:
        """A front-door loop's thread died: its connection tasks are
        frozen mid-await and can never run their cleanup. Route around
        it (``mark_dead``: the delivery ring and its sessions fall back
        to the main loop) and shut its channels down FROM HERE, so
        wills fire, sessions detach or terminate, and the registry
        stays truthful."""
        node = self.node
        lg = node.loop_group
        dead_loop = lg.loops[idx]
        lg.mark_dead(idx)
        node.metrics.inc("overload.heal.loop")
        node.alarms.activate(
            f"frontdoor_loop_{idx}_dead", details={"loop": idx},
            message=f"front-door loop {idx} thread died; its "
                    f"connections were closed and its sessions "
                    f"re-homed to the main loop")
        n = 0
        for lst in node.listeners:
            for conn in list(lst._conns):
                if conn._loop is not dead_loop:
                    continue
                try:
                    if not conn.channel.closed:
                        conn.channel.disconnect_reason = "loop_dead"
                        # fires the will (an abnormal disconnect) and
                        # detaches or terminates the session; this runs
                        # on the main thread, so the will's publish
                        # takes the broker's own path from here
                        conn.channel._shutdown(close_transport=False)
                except Exception:
                    log.exception("closing channel on dead loop %d", idx)
                conn._closing = True
                try:
                    conn.writer.transport.abort()
                except Exception:
                    pass
                lst._conns.discard(conn)
                n += 1
        log.error("front-door loop %d died: closed %d of its "
                  "connections, re-homed its sessions", idx, n)

    def _sweep_force_shutdown(self) -> None:
        pol = self.cfg.force_shutdown_queue_len
        if pol <= 0:
            return
        cm = self.node.cm
        for cid, chan in list(cm._channels.items()):
            sess = getattr(chan, "session", None)
            if sess is None:
                continue
            try:
                qlen = len(sess.mqueue) + len(sess.outbox)
            except Exception:
                continue
            if qlen > pol:
                log.warning(
                    "force-shutdown %r: session queue %d > policy %d "
                    "(emqx_connection OOM policy analogue)",
                    cid, qlen, pol)
                self.node.metrics.inc("overload.force_shutdown")
                try:
                    cm.kick_session(cid)
                except Exception:
                    log.exception("force-shutdown of %r failed", cid)
