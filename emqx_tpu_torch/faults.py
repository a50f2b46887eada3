"""Deterministic fault injection: named injection points threaded
through the hot paths.

The port of the JAX package's fault registry. The broker has a failure
surface of its own: an ingress executor thread, an off-lock compaction
thread and a device step that can fail or stall apart from the host.
This module makes those failures a seedable test input.

Design rules:

  - **Zero cost disabled.** Every site is one module-attribute branch
    (``if faults.enabled: faults.fire("point")``); ``enabled`` is True
    only while at least one point is armed AND the master switch is
    on, so production traffic pays a dead branch.
  - **Deterministic.** Probabilistic arms draw from one seedable RNG;
    count-limited arms (``times``) self-disarm after the last trigger,
    so a chaos scenario is a finite, reproducible schedule.
  - **Closed catalog.** Arming an unknown point raises: a mistyped
    chaos config must not silently test nothing.

The registry is this process's own, apart from the JAX package's: a
test that runs both packages arms both. Arm specs are
``point[:action[:times[:delay_ms]]]`` (``times`` 0 = unlimited).

Actions:

  - ``raise`` — the site raises :class:`FaultInjected`;
  - ``stall`` — the site sleeps ``delay_ms`` then proceeds normally
    (a slow device step);
  - ``drop``  — :func:`fire` returns True and the SITE implements the
    effect (report a saturated queue, reset a socket), for points
    whose failure is not an exception.

The catalog is the JAX package's, whole. The ``xloop.*`` sites come
with the multi-loop front door; arming one of them here fires nowhere
yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import random
import threading
import time
from typing import Dict, List, Optional

from emqx_tpu_torch.concurrency import any_thread

log = logging.getLogger("emqx_tpu_torch.faults")

#: module-level fast gate read by every injection site. True only
#: while the master switch is on AND at least one point is armed.
enabled = False


class FaultInjected(RuntimeError):
    """Raised by an armed ``raise``-action injection point."""

    def __init__(self, point: str) -> None:
        super().__init__(f"fault injected: {point}")
        self.point = point


#: the injection-point catalog: name -> (default action, site)
POINTS: Dict[str, tuple] = {
    "device.walk": ("raise",
                    "Broker._begin_device — the device match step "
                    "fails/stalls at dispatch"),
    "device.fetch": ("raise",
                     "Broker._fetch_device — the device→host "
                     "transfer fails/stalls (executor thread)"),
    "device.lost": ("raise",
                    "every device seam — Broker._begin_device "
                    "dispatch, Broker._fetch_device transfer, the "
                    "recovery sentinel probe, and the rebuild's "
                    "fresh-table device placement "
                    "(Router.rebuild_device_state). Arm times=0: "
                    "the backend is GONE — every device call raises "
                    "until disarmed (the fresh backend), unlike the "
                    "times-bounded device.walk/device.fetch"),
    "executor.death": ("drop",
                       "IngressBatcher._complete — the fetch thread "
                       "pool dies out from under a batch"),
    "xloop.handoff": ("drop",
                      "Broker._post_xloop_handoffs — a cross-loop "
                      "delivery handoff is dropped (or, with stall, "
                      "delayed)"),
    "compaction.flatten": ("raise",
                           "Router._flatten_main — the background "
                           "compaction flatten crashes"),
    "socket.reset": ("drop",
                     "Connection._send_packets — the client socket "
                     "resets mid-flush"),
    "ingress.saturate": ("drop",
                         "IngressBatcher.backlogged — the ingress "
                         "accumulator reports saturation"),
    "wal.append": ("drop",
                   "Wal.flush — a journal frame short-writes (torn "
                   "tail on disk, as if the process crashed "
                   "mid-append) and the writer degrades"),
    "wal.fsync": ("raise",
                  "Wal.flush — the batched fsync fails (disk full): "
                  "the journal degrades to memory-only with alarm + "
                  "bounded backoff retry; publishes never wedge"),
    "checkpoint.rename": ("raise",
                          "checkpoint.write_manifest — crash before "
                          "the manifest rename lands (every new "
                          "segment written, previous generation "
                          "still authoritative; covers full AND "
                          "incremental generations)"),
    "repl.ship": ("drop",
                  "ReplicationManager ship/hello — the journal-ship "
                  "call to the warm standby is dropped (the shipper "
                  "falls back to local-only + resync) or, with "
                  "stall, delayed (replication lag)"),
    "repl.failback": ("drop",
                      "ReplicationManager._failback — the FAILBACK "
                      "hand-off call to the returning primary is "
                      "dropped (the promoted standby aborts, stays "
                      "promoted, and retries on the primary's next "
                      "hello) or, with stall, delayed"),
    "net.partition": ("drop",
                      "SocketTransport dial/call/flush/inbound — the "
                      "link to a peer is severed both ways (arm "
                      "times=0 for the partition window, disarm to "
                      "heal)"),
    "net.delay": ("stall",
                  "SocketTransport call/flush — frames to a peer are "
                  "delayed delay_ms before the write"),
    "net.drop": ("drop",
                 "SocketTransport cast flush — a claimed cast burst "
                 "is discarded as if sent (at-most-once loss; the "
                 "anti-entropy sweep's repair target)"),
    "peer.wedge": ("drop",
                   "SocketTransport._on_peer — this node's inbound "
                   "frame loop swallows frames without replying: "
                   "wedged-but-connected, visible only to the "
                   "heartbeat detector"),
}

_ACTIONS = ("raise", "stall", "drop")


@dataclasses.dataclass
class FaultsConfig:
    """The ``[faults]`` section (closed schema)."""

    #: master switch: False keeps every site a dead branch even with
    #: arm specs present (a staged chaos config that must not run yet)
    enabled: bool = False
    #: RNG seed for probabilistic arms — the determinism contract
    seed: int = 0
    #: arm specs: ``point[:action[:times[:delay_ms]]]``
    arm: List[str] = dataclasses.field(default_factory=list)

    #: live-reloadable knobs: none — the section configures the
    #: process-global registry at boot (not a dataclass field:
    #: unannotated)
    RELOADABLE = frozenset()


class _Arm:
    __slots__ = ("point", "action", "times", "delay_ms", "prob",
                 "fired")

    def __init__(self, point: str, action: str, times: int,
                 delay_ms: float, prob: float) -> None:
        self.point = point
        self.action = action
        self.times = times
        self.delay_ms = delay_ms
        self.prob = prob
        self.fired = 0


class FaultRegistry:
    """The armed points; ``_arms`` is guarded by ``_lock``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._arms: Dict[str, _Arm] = {}
        self._rng = random.Random(0)
        self.master = True
        #: total triggers since the last drain (the node folds this
        #: into the ``faults.injected`` counter on its tick)
        self._injected = 0
        self.injected_total = 0

    def _recompute(self) -> None:
        global enabled
        enabled = self.master and bool(self._arms)

    def arm(self, point: str, action: Optional[str] = None,
            times: int = 1, delay_ms: float = 0.0,
            prob: float = 1.0) -> None:
        if point not in POINTS:
            raise ValueError(
                f"unknown fault point {point!r} "
                f"(known: {sorted(POINTS)})")
        action = action or POINTS[point][0]
        if action not in _ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r} (one of {_ACTIONS})")
        if action == "stall" and delay_ms <= 0:
            raise ValueError("stall action needs delay_ms > 0")
        if not 0.0 < prob <= 1.0:
            raise ValueError(f"prob must be in (0, 1], got {prob}")
        with self._lock:
            self._arms[point] = _Arm(point, action, int(times),
                                     float(delay_ms), float(prob))
            self._recompute()
        log.warning("fault point armed: %s action=%s times=%s "
                    "delay_ms=%s prob=%s", point, action,
                    times or "inf", delay_ms, prob)

    def disarm(self, point: str) -> bool:
        with self._lock:
            out = self._arms.pop(point, None) is not None
            self._recompute()
        return out

    def clear(self) -> None:
        with self._lock:
            self._arms.clear()
            self._recompute()

    def set_master(self, on: bool) -> None:
        with self._lock:
            self.master = bool(on)
            self._recompute()

    def seed(self, n: int) -> None:
        with self._lock:
            self._rng = random.Random(n)

    @any_thread
    def check(self, point: str) -> Optional[_Arm]:
        """One trigger decision for ``point``: None = not armed / the
        RNG spared it; otherwise the arm (``times`` accounting applied,
        self-disarms after the last trigger)."""
        with self._lock:
            arm = self._arms.get(point)
            if arm is None:
                return None
            if arm.prob < 1.0 and self._rng.random() >= arm.prob:
                return None
            arm.fired += 1
            if arm.times and arm.fired >= arm.times:
                del self._arms[point]
                self._recompute()
            self._injected += 1
            self.injected_total += 1
            return arm

    def drain_injected(self) -> int:
        with self._lock:
            n = self._injected
            self._injected = 0
        return n

    def info(self) -> dict:
        with self._lock:
            return {
                "enabled": enabled,
                "master": self.master,
                "injected_total": self.injected_total,
                "armed": {
                    p: {"action": a.action,
                        "times": a.times or "inf",
                        "fired": a.fired,
                        "delay_ms": a.delay_ms,
                        "prob": a.prob}
                    for p, a in self._arms.items()},
                "points": {p: d for p, (_a, d) in POINTS.items()},
            }


_registry = FaultRegistry()


@any_thread
def fire(point: str) -> bool:
    """Run ``point``'s armed effect, if any. Raises
    :class:`FaultInjected` for ``raise`` arms; sleeps then returns
    False for ``stall`` arms; returns True for ``drop`` arms (the site
    implements the drop). Returns False when not triggered.

    Callers MUST gate on the module's ``enabled`` flag first — that
    branch is the whole disabled-mode cost."""
    arm = _registry.check(point)
    if arm is None:
        return False
    log.warning("fault injected: %s (%s)", point, arm.action)
    if arm.delay_ms:
        time.sleep(arm.delay_ms / 1000.0)
    if arm.action == "raise":
        raise FaultInjected(point)
    return arm.action == "drop"


def arm(point: str, action: Optional[str] = None, times: int = 1,
        delay_ms: float = 0.0, prob: float = 1.0) -> None:
    _registry.arm(point, action, times, delay_ms, prob)


def disarm(point: str) -> bool:
    return _registry.disarm(point)


def clear() -> None:
    _registry.clear()


def set_master(on: bool) -> None:
    _registry.set_master(on)


def seed(n: int) -> None:
    _registry.seed(n)


def drain_injected() -> int:
    return _registry.drain_injected()


def info() -> dict:
    return _registry.info()


def parse_arm(spec: str) -> tuple:
    """``point[:action[:times[:delay_ms]]]`` → arm kwargs tuple,
    validated against the catalog."""
    parts = str(spec).split(":")
    if not parts or not parts[0]:
        raise ValueError(f"bad arm spec {spec!r}")
    point = parts[0]
    action = parts[1] if len(parts) > 1 and parts[1] else None
    times = int(parts[2]) if len(parts) > 2 and parts[2] else 1
    delay_ms = float(parts[3]) if len(parts) > 3 and parts[3] else 0.0
    if point not in POINTS:
        raise ValueError(
            f"unknown fault point {point!r} (known: {sorted(POINTS)})")
    if action is not None and action not in _ACTIONS:
        raise ValueError(
            f"unknown fault action {action!r} (one of {_ACTIONS})")
    return point, action, times, delay_ms


def arm_spec(spec: str) -> None:
    point, action, times, delay_ms = parse_arm(spec)
    arm(point, action=action, times=times, delay_ms=delay_ms)


def configure(cfg: FaultsConfig) -> None:
    """Apply a ``[faults]`` section: master switch, seed, arm list.
    Called at node build; a disabled section with arm specs stores
    the arms inert (master off ⇒ ``enabled`` stays False)."""
    set_master(cfg.enabled)
    seed(cfg.seed)
    for spec in cfg.arm:
        arm_spec(spec)


@contextlib.contextmanager
def injected(point: str, action: Optional[str] = None, times: int = 1,
             delay_ms: float = 0.0, prob: float = 1.0):
    """Test context manager: arm ``point`` on entry, disarm on exit
    (whether or not it fired)."""
    arm(point, action=action, times=times, delay_ms=delay_ms,
        prob=prob)
    try:
        yield
    finally:
        disarm(point)
