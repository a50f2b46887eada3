"""Multi-loop front door: N asyncio event loops inside one Node.

The port of the JAX package's ``LoopGroup``. The reference's front
door scales inside one BEAM node because every connection is a
process and the schedulers own every core (src/emqx_connection.erl
one-process-per-socket, esockd acceptor pools). A :class:`LoopGroup`
of ``n`` event loops (index 0 is the node's main loop; indices 1..n-1
run on their own threads) is that here: the listener shards accepted
connections over it (``connection.Listener._start_dispatch``) and the
dispatch planner hands each subscriber group to its owning loop
(``broker.Broker._post_xloop_handoffs``, the cross-loop delivery
ring).

Ownership rules (the invariants everything else leans on):

  - a connection — its read loop, parser, channel FSM, timers, and
    delivery flushes — runs entirely on the loop that accepted it;
  - a session is owned by its connection's loop (``Session.
    owner_loop``, stamped at CONNECT); its inflight window, mqueue
    and outbox are only touched from that loop while connected —
    the delivery ring routes each planned subscriber group to the
    owning loop instead of enqueueing from the main loop;
  - the main loop (index 0) keeps the node-wide state and the device
    plane: ingress batcher, every kernel launch of a publish batch,
    route tables (mutations serialized by the broker's route lock),
    metrics fold, housekeeping;
  - cross-loop channel operations (takeover/kick of a session owned
    by another loop) marshal onto the owning loop and wait, bounded
    (``cm.ConnectionManager._call_channel``).

This module is host code only: it touches no tensor. ``loops = 1``
constructs no LoopGroup at all — every code path is the single-loop
node's.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import List, Optional, Set

from emqx_tpu_torch.concurrency import any_thread, bg_thread, owner_loop

log = logging.getLogger("emqx_tpu_torch.loops")

#: strong references to in-flight shutdown drains: the loop holds
#: only a weak reference to a task, and the drain
#: must survive until it stops its own loop
_DRAIN_TASKS: Set = set()


class LoopGroup:
    """``n`` event loops: the node's main loop plus ``n - 1`` peer
    loop threads. Started inside ``Node.start()`` (index 0 must be
    the running loop); peer threads are daemons, stopped by
    :meth:`stop` after the listeners and ingress drain."""

    def __init__(self, n: int) -> None:
        if n < 1:
            raise ValueError(f"loop count must be >= 1, got {n}")
        self.n = n
        self.loops: List[asyncio.AbstractEventLoop] = []
        self._threads: List[threading.Thread] = []
        self._idx = {}  # id(loop) -> index
        self._home_tid: Optional[int] = None
        self._started = False
        # peer loops whose thread died (overload monitor heal sweep):
        # posts to them raise, index_of maps their sessions home
        self._dead: Set[int] = set()
        #: exceptions raised out of a peer loop's callbacks and tasks
        #: (a failed retained-replay flush, a CUDA error in B3): logged
        #: by the loop's default handler AND kept here, (loop index,
        #: message, exception repr), the newest :data:`MAX_ERRORS`, so a
        #: caller can fail its run on them instead of reading a log
        self.errors: List[tuple] = []

    #: peer-loop errors kept in :attr:`errors`
    MAX_ERRORS = 100

    @property
    def home(self) -> Optional[asyncio.AbstractEventLoop]:
        """The node's main loop (index 0)."""
        return self.loops[0] if self.loops else None

    @owner_loop
    def start(self, main_loop: asyncio.AbstractEventLoop) -> None:
        if self._started:
            return
        self.loops = [main_loop]
        self._idx = {id(main_loop): 0}
        self._home_tid = threading.get_ident()
        ready = threading.Event()
        for i in range(1, self.n):
            loop = asyncio.new_event_loop()
            loop.set_exception_handler(self._on_error)
            t = threading.Thread(target=self._run_loop,
                                 args=(loop, ready),
                                 name=f"frontdoor-loop-{i}",
                                 daemon=True)
            self.loops.append(loop)
            self._idx[id(loop)] = i
            self._threads.append(t)
            ready.clear()
            t.start()
            # wait until the loop is actually spinning: a socket
            # handed to a not-yet-running loop would sit unserved
            ready.wait(5.0)
        self._started = True
        log.info("front door sharded over %d event loops", self.n)

    @any_thread
    def _on_error(self, loop, context: dict) -> None:
        """A peer loop's exception handler: keep the error, then log it
        as the default handler does."""
        exc = context.get("exception")
        self.errors.append((self._idx.get(id(loop), -1),
                            context.get("message", ""),
                            repr(exc) if exc is not None else None))
        del self.errors[:-self.MAX_ERRORS]
        loop.default_exception_handler(context)

    @staticmethod
    @bg_thread
    def _run_loop(loop: asyncio.AbstractEventLoop,
                  ready: threading.Event) -> None:
        asyncio.set_event_loop(loop)
        loop.call_soon(ready.set)
        try:
            loop.run_forever()
        finally:
            try:
                loop.close()
            except Exception:
                pass

    @owner_loop
    def stop(self, timeout: float = 10.0) -> None:
        """Cancel every peer loop's tasks, stop the loops, join the
        threads. The main loop (index 0) is the caller's — untouched."""
        for loop in self.loops[1:]:
            if loop.is_running():
                try:
                    loop.call_soon_threadsafe(self._shutdown_loop, loop)
                except RuntimeError:
                    pass
        for t in self._threads:
            t.join(timeout)
            if t.is_alive():
                log.warning("front-door loop thread %s did not stop "
                            "within %.0fs", t.name, timeout)
        self._threads.clear()
        self._started = False

    @staticmethod
    def _shutdown_loop(loop: asyncio.AbstractEventLoop) -> None:
        async def _drain():
            tasks = [t for t in asyncio.all_tasks(loop)
                     if t is not asyncio.current_task()]
            for t in tasks:
                t.cancel()
            if tasks:
                await asyncio.gather(*tasks, return_exceptions=True)
            loop.stop()

        t = loop.create_task(_drain())
        _DRAIN_TASKS.add(t)
        t.add_done_callback(_DRAIN_TASKS.discard)

    # -- addressing --------------------------------------------------------

    def index_of(self, loop) -> int:
        """Loop → index; unknown/None map to 0 (home): a session
        without a stamped owner is delivered from the main loop,
        exactly like the single-loop build."""
        if loop is None:
            return 0
        return self._idx.get(id(loop), 0)

    def on_home_thread(self) -> bool:
        return threading.get_ident() == self._home_tid

    @any_thread
    def post(self, idx: int, cb, *args) -> None:
        """Schedule ``cb(*args)`` on loop ``idx`` (thread-safe).
        Raises ``RuntimeError`` if that loop is closed or marked dead
        — callers fall back to running the work in place. The dead
        check matters: a loop whose THREAD died but whose loop object
        was never closed still accepts ``call_soon_threadsafe``, and
        the callback would silently never run (a hung join)."""
        if idx in self._dead:
            raise RuntimeError(f"front-door loop {idx} is dead")
        self.loops[idx].call_soon_threadsafe(cb, *args)

    # -- liveness (the overload monitor's heal sweep) ---------------------

    def alive(self, idx: int) -> bool:
        """Is loop ``idx`` serviceable? The home loop always is (it
        is the caller's); a peer is alive while its thread runs and
        it is not marked dead."""
        if idx == 0:
            return True
        if idx in self._dead or not self._started:
            return False
        t = self._threads[idx - 1] if idx - 1 < len(self._threads) \
            else None
        return t is not None and t.is_alive()

    def dead_peer_indices(self) -> List[int]:
        """Peer loops whose thread died but are not yet marked dead
        — the monitor marks + heals each exactly once."""
        if not self._started:
            return []
        return [i for i in range(1, len(self._threads) + 1)
                if i not in self._dead
                and not self._threads[i - 1].is_alive()]

    @owner_loop
    def mark_dead(self, idx: int) -> None:
        """Route around a dead loop: its sessions map home
        (``index_of`` → 0), future posts to it raise."""
        self._dead.add(idx)
        self._idx.pop(id(self.loops[idx]), None)

    # -- chaos helpers (NOT part of the fault registry — these simulate
    # a loop dying or wedging from outside) -----------------------------

    def crash(self, idx: int) -> None:
        """Stop peer loop ``idx``: its run_forever returns and its
        thread exits, leaving its connection tasks frozen — exactly
        the state a crashed loop thread leaves behind."""
        loop = self.loops[idx]
        try:
            loop.call_soon_threadsafe(loop.stop)
        except RuntimeError:
            pass

    def stall(self, idx: int, seconds: float) -> None:
        """Wedge peer loop ``idx`` for ``seconds`` (a blocking sleep
        ON the loop): every task it owns — read loops, keepalive
        timers, cross-loop marshals — stalls with it."""
        self.loops[idx].call_soon_threadsafe(time.sleep, seconds)
