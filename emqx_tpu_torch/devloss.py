"""Device-loss recovery: rebuild the device state and auto-close the
breaker (the port of the JAX package's ``devloss.py``).

A circuit breaker alone survives a *failing* device step, but a LOST
runtime would leave it OPEN forever: every half-open probe runs against
dead buffers. This module recovers:

  1. **Classify** — a breaker trip runs a trivial *sentinel* device op
     on a recovery thread, bounded by ``sentinel_timeout_s`` (a hung
     card classifies the same as a dead one). The sentinel answers →
     transient (a slow batch, a failed launch): the cooldown →
     half-open probe path handles it, nothing changes.
  2. **Quarantine + rebuild** — no answer → the breaker enters
     ``REBUILDING`` and :meth:`Router.rebuild_device_state` rebuilds
     every device-resident table from the host structures: the trie
     flattens to fresh tables on the router's device, the delta side
     automaton and tombstone mask re-stage, the match cache starts
     cold under a global epoch bump. The fan-out manager's device
     tables are dropped too and re-derive at the new epoch.
  3. **Re-warm** — ``Broker.warm_device_path`` drives the real
     dispatch/fetch seams over the observed batch shapes
     (``ops/warmup.py``), so the first live batch after recovery does
     not pay the cold start.
  4. **Admit the probe** — only then does the breaker re-arm its
     half-open window; the probe's success closes it and clears the
     ``device_path_lost`` alarm.

Failed attempts (the backend still gone, or gone again mid-rebuild)
count ``breaker.rebuild.failures`` and retry with exponential backoff,
capped at 30 s; publishes never wedge, they ride the exact host trie.

On CUDA an illegal-address fault leaves the process's context dead: no
rebuild attempt can succeed and the host trie serves with
``device_path_lost`` active until the process restarts. Nothing here
tries to reset the context.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

import torch

from emqx_tpu_torch import faults
from emqx_tpu_torch.concurrency import any_thread, bg_thread

log = logging.getLogger("emqx_tpu_torch.devloss")


@bg_thread
def sentinel_alive(timeout_s: float, device) -> bool:
    """One trivial op on ``device``, bounded: can the backend still
    answer? A one-element tensor made on the device and read back
    with ``.item()`` (the round trip). The probe runs on a daemon
    thread joined with the timeout, so a HUNG runtime (no exception,
    no progress) times out into the same LOST verdict a dead one
    raises into."""
    out = {}

    def _probe() -> None:
        try:
            if faults.enabled:
                faults.fire("device.lost")
            x = torch.ones(1, dtype=torch.int32, device=device)
            out["ok"] = int(x.item()) == 1
        except Exception:
            out["ok"] = False

    t = threading.Thread(target=_probe, daemon=True,
                         name="devloss-sentinel")
    t.start()
    t.join(timeout_s)
    return bool(out.get("ok"))


class DeviceRecovery:
    """The breaker's lost-backend recovery arm (one per node, wired by
    the Node when ``breaker_rebuild``). All device work happens on a
    dedicated daemon thread per episode — never on the publish path,
    never on the event loop. ``_active`` is guarded by ``_lock``."""

    def __init__(self, broker, metrics, alarms,
                 backoff_s: float = 0.5,
                 sentinel_timeout_s: float = 5.0) -> None:
        self.broker = broker
        self.metrics = metrics
        self.alarms = alarms
        self.backoff_s = max(0.01, float(backoff_s))
        self.sentinel_timeout_s = max(0.1, float(sentinel_timeout_s))
        self._lock = threading.Lock()
        self._active = False
        self._stop = threading.Event()
        # episode bookkeeping
        self.rebuilds = 0
        self.rebuild_failures = 0
        self.last_rebuild_s: Optional[float] = None
        self.last_classification: Optional[str] = None
        self.last_error: Optional[str] = None

    # -- breaker hook (any thread — fetch executor, event loop) -----------

    @any_thread
    def on_trip(self, reason: str) -> bool:
        """A breaker trip landed: classify it on the recovery thread.
        At most one episode runs at a time — re-trips during an active
        episode are already being handled."""
        with self._lock:
            if self._active or self._stop.is_set():
                return False
            self._active = True
        threading.Thread(target=self._run, args=(reason,),
                         daemon=True, name="device-recovery").start()
        return True

    def stop(self) -> None:
        """Node shutdown: let an in-flight episode exit at its next
        backoff check instead of rebuilding into a dying process."""
        self._stop.set()

    def start(self) -> None:
        """Node (re)start: trips are classified again after a
        :meth:`stop` (the port's ``Node`` may start after a stop)."""
        self._stop.clear()

    # -- the recovery episode (its own daemon thread) ---------------------

    @bg_thread
    def _run(self, reason: str) -> None:
        try:
            self._classify_and_recover(reason)
        except Exception:
            log.exception("device-loss recovery episode crashed")
        finally:
            with self._lock:
                self._active = False

    @bg_thread
    def _classify_and_recover(self, reason: str) -> None:
        br = self.broker.breaker
        router = self.broker.router
        if sentinel_alive(self.sentinel_timeout_s, router.device):
            # the backend answers: a slow or failed BATCH, not a lost
            # runtime — the cooldown → half-open probe recovers it
            self.last_classification = "transient"
            log.info("breaker trip classified transient (%s): "
                     "sentinel answered, cooldown probe will decide",
                     reason)
            return
        self.last_classification = "lost"
        if not br.enter_rebuilding():
            return  # a racing probe closed the breaker meanwhile
        if self.alarms is not None:
            self.alarms.activate(
                "device_path_lost",
                details={"reason": reason,
                         "sentinel_timeout_s": self.sentinel_timeout_s},
                message="device backend lost: rebuilding device state "
                        "from host-authoritative structures")
        router.suspend_device()
        # the fan-out manager's device tables reference dead buffers;
        # the next state() call re-derives them at the new epoch
        self.broker.helper.invalidate_device()
        backoff = self.backoff_s
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                info = router.rebuild_device_state()
                self.broker.warm_device_path()
            except Exception as e:
                self.rebuild_failures += 1
                self.metrics.inc("breaker.rebuild.failures")
                self.last_error = repr(e)[:200]
                log.warning(
                    "device-state rebuild failed (attempt %d, "
                    "backend still gone?): %r — retrying in %.2fs",
                    self.rebuild_failures, e, backoff)
                if self._stop.wait(backoff):
                    return
                backoff = min(backoff * 2, 30.0)
                continue
            self.last_rebuild_s = time.monotonic() - t0
            self.rebuilds += 1
            self.metrics.inc("breaker.rebuilds")
            log.warning(
                "device state rebuilt in %.3fs (epoch %s, %s filters"
                ", kernels re-warmed): admitting half-open probe",
                self.last_rebuild_s, info.get("epoch"),
                info.get("filters"))
            br.rebuild_complete()
            return

    def info(self) -> dict:
        return {
            "rebuilding": self._active
            and self.last_classification == "lost",
            "classification": self.last_classification,
            "rebuilds": self.rebuilds,
            "rebuild_failures": self.rebuild_failures,
            "last_rebuild_s": (round(self.last_rebuild_s, 3)
                               if self.last_rebuild_s is not None
                               else None),
            "last_rebuild_error": self.last_error,
        }
