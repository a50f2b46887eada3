"""Multi-process front-door sharding: the SO_REUSEPORT worker pool.

The port of the JAX package's ``WorkerPool``. The reference's front
door scales inside ONE BEAM node — esockd acceptor pools fan accepted
sockets over scheduler threads that own every core
(src/emqx_listeners.erl:43-81, src/emqx_channel.erl one process per
connection). CPython's interpreter lock forces the process boundary
instead, so the port shards the LISTENER:

- N worker processes each run a full Node (own event loop, own ingress
  batcher, own device plane: on the card each worker holds its own
  CUDA context and its own copy of the tables) and bind the SAME MQTT
  port with ``SO_REUSEPORT`` — the kernel load-balances accepted
  connections across the workers;
- the workers join one broker cluster over the socket transport
  (:mod:`emqx_tpu_torch.cluster_net`), so route replication,
  cross-node forwarding, shared-group routing, clientid locking and
  takeover make the shard split invisible: a subscriber accepted by
  worker 2 receives publishes ingested by worker 0 through the
  cluster data plane, exactly as between any two cluster nodes;
- worker 0 is the cluster seed; later workers join through its
  transport address (handed over the spawn arguments).

The device travels as an argument: ``WorkerPool(n, device="cuda")``
(the default) puts it on each worker's command line, and a worker on a
host without CUDA raises before it serves. The parent builds the
kernel library and the host library once before the first worker
starts, so no worker compiles.

A worker speaks a line protocol on its pipes: it prints ``READY
<listener-port> <transport-port>`` once serving, answers ``STATS?`` on
stdin with ``STATS <connections> <delivered>``, and ends on ``QUIT`` (or
SIGTERM, or its stdin closing).

Used as a library (:class:`WorkerPool`) and as the ``--workers N``
flag of ``python -m emqx_tpu_torch``.
"""

from __future__ import annotations

import os
import select
import signal
import subprocess
import sys
import time
from typing import List, Optional

_WORKER_MAIN = r"""
import asyncio, os, signal, sys

import torch  # noqa: F401  (the worker's own CUDA context)

from emqx_tpu_torch.cluster import Cluster
from emqx_tpu_torch.cluster_net import SocketTransport
from emqx_tpu_torch.modules.retainer import RetainerModule
from emqx_tpu_torch.node import Node


async def main():
    idx = int(sys.argv[1])
    port = int(sys.argv[2])
    host = sys.argv[3]
    seed = sys.argv[4]          # "" for worker 0, else "host:port"
    cookie = sys.argv[5]
    device = sys.argv[6]
    name = f"worker{idx}@{os.getpid()}"
    n = Node(name=name, boot_listeners=False, device=device)
    # a retained-replay storm needs the retainer serving replays on
    # every worker
    n.modules.load(RetainerModule)
    tr = SocketTransport(name, cookie=cookie)
    tr.serve()
    cl = Cluster(n, transport=tr)
    lst = n.add_listener(host=host, port=port, reuse_port=True)
    await n.start()
    if seed:
        sh, sp = seed.rsplit(":", 1)
        cl.join_remote(sh, int(sp))
    # READY <listener-port> <transport-port>
    print(f"READY {lst.port} {tr.port}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    reader = asyncio.StreamReader()
    await loop.connect_read_pipe(
        lambda: asyncio.StreamReaderProtocol(reader), sys.stdin)

    async def stdin_cmds():
        while True:
            line = await reader.readline()
            if not line:
                stop.set()
                return
            parts = line.decode().split()
            if not parts:
                continue
            if parts[0] == "STATS?":
                print(f"STATS {n.cm.connection_count()} "
                      f"{n.metrics.val('messages.delivered')}",
                      flush=True)
            elif parts[0] == "QUIT":
                stop.set()
                return

    cmds = asyncio.create_task(stdin_cmds())
    await stop.wait()
    cmds.cancel()
    cl.leave()
    await n.stop()
    tr.close()


asyncio.run(main())
"""


class WorkerPool:
    """Spawn and supervise N SO_REUSEPORT listener workers on
    ``device`` (``"cuda"`` unless the caller asks for the CPU)."""

    def __init__(self, n_workers: int, port: int = 1883,
                 host: str = "127.0.0.1", cookie: str = "emqx-workers",
                 device: Optional[str] = None) -> None:
        from emqx_tpu_torch.device import resolve

        self.n_workers = n_workers
        self.port = port
        self.host = host
        self.cookie = cookie
        # raises here, in the parent, when CUDA is asked for and absent
        self.device = str(resolve(device))
        self.procs: List[subprocess.Popen] = []
        self.tports: List[Optional[int]] = []  # per-worker transport
        #: seconds from each worker's spawn to its READY line (its last
        #: start or restart)
        self.ready_s: List[float] = []
        self._seed_addr = ""

    def _prebuild(self) -> None:
        """Build the libraries every worker loads once, here: the host
        library always (the router's native engine), the kernel library
        on CUDA. Concurrent first uses in the workers then only load
        (both builds are up to date and locked against each other)."""
        from emqx_tpu_torch.ops import _build

        _build.build_host()
        if self.device.startswith("cuda"):
            _build.library()

    def _spawn_one(self, idx: int,
                   seed: Optional[str] = None) -> subprocess.Popen:
        env = dict(os.environ)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        return subprocess.Popen(
            [sys.executable, "-c", _WORKER_MAIN, str(idx),
             str(self.port), self.host,
             self._seed_addr if seed is None else seed, self.cookie,
             self.device],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)

    #: seconds a worker may take to print READY (import torch, a CUDA
    #: context, loading the kernel library, the node's start)
    READY_TIMEOUT = 120.0

    def _await_ready(self, proc: subprocess.Popen,
                     timeout: Optional[float] = None):
        deadline = time.monotonic() + (timeout or self.READY_TIMEOUT)
        buf = b""
        while time.monotonic() < deadline:
            # readline() would block forever on a wedged worker (a hung
            # device init); select enforces the budget
            r, _, _ = select.select([proc.stdout], [], [],
                                    min(1.0, deadline - time.monotonic()))
            if not r:
                continue
            chunk = os.read(proc.stdout.fileno(), 4096)
            if not chunk:
                raise RuntimeError("worker died before READY")
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                text = line.decode().strip()
                if text.startswith("READY"):
                    _, lport, tport = text.split()
                    return int(lport), int(tport)
        raise TimeoutError("worker did not become ready")

    def start(self) -> int:
        """Spawn all workers; returns the (shared) listener port. A
        worker failing to come up tears the whole pool down — no orphan
        may keep holding the SO_REUSEPORT port."""
        try:
            self._prebuild()
            t0 = time.monotonic()
            p0 = self._spawn_one(0)
            self.procs.append(p0)
            lport, tport = self._await_ready(p0)
            self.ready_s.append(time.monotonic() - t0)
            self.tports.append(tport)
            self.port = lport
            self._seed_addr = f"{self.host}:{tport}"
            for i in range(1, self.n_workers):
                t0 = time.monotonic()
                p = self._spawn_one(i)
                self.procs.append(p)
                _, tp = self._await_ready(p)
                self.ready_s.append(time.monotonic() - t0)
                self.tports.append(tp)
        except BaseException:
            self.stop()
            raise
        return self.port

    #: bound on waiting for a worker process to exit before its slot is
    #: reused (restart) or stop() returns. A worker that has not exited
    #: still holds its SO_REUSEPORT share of the listener port: the
    #: kernel keeps steering a share of new connections at the dying
    #: process, so a respawn beside an orphan silently splits the
    #: listener.
    REAP_TIMEOUT = 15.0

    def _reap(self, p: subprocess.Popen) -> None:
        """Make sure ``p`` has exited — TERM, then KILL, each with half
        the budget — raising a clear error if the orphan survives (its
        exit is what releases the SO_REUSEPORT port share)."""
        if p.poll() is not None:
            return
        try:
            p.terminate()
        except OSError:
            pass
        try:
            p.wait(timeout=self.REAP_TIMEOUT / 2)
            return
        except subprocess.TimeoutExpired:
            pass
        try:
            p.kill()
        except OSError:
            pass
        try:
            p.wait(timeout=self.REAP_TIMEOUT / 2)
        except subprocess.TimeoutExpired:
            raise RuntimeError(
                f"worker pid {p.pid} did not exit within "
                f"{self.REAP_TIMEOUT:.0f}s of SIGKILL; the orphan still "
                f"holds its SO_REUSEPORT share of port {self.port} — "
                f"refusing to respawn into a split listener") from None

    def restart_worker(self, idx: int) -> None:
        """Respawn a dead worker in place (the reference supervisor's
        restart). The predecessor is reaped FIRST — a respawn beside a
        live orphan would split the SO_REUSEPORT listener. The
        replacement joins the cluster through any LIVE worker's
        transport: membership is a mesh, so losing the original seed
        (worker 0) does not strand the pool."""
        self._reap(self.procs[idx])
        seed = ""
        for j, p in enumerate(self.procs):
            if j != idx and p.poll() is None and self.tports[j]:
                seed = f"{self.host}:{self.tports[j]}"
                break
        # the predecessor's transport port is dead once we respawn:
        # invalidate it BEFORE waiting for readiness, so a wedged
        # replacement cannot leave a stale port for later restarts
        self.tports[idx] = None
        t0 = time.monotonic()
        p = self._spawn_one(idx, seed=seed)
        self.procs[idx] = p
        _, tp = self._await_ready(p)
        self.ready_s[idx] = time.monotonic() - t0
        self.tports[idx] = tp
        if idx == 0:
            self._seed_addr = f"{self.host}:{tp}"

    #: seconds a worker may take to answer ``STATS?``
    STATS_TIMEOUT = 30.0

    def stats(self) -> List[tuple]:
        """[(connections, delivered)] per worker; (0, 0) for a dead or
        silent one."""
        out = []
        for p in self.procs:
            if p.poll() is not None:
                out.append((0, 0))
                continue
            p.stdin.write(b"STATS?\n")
            p.stdin.flush()
            deadline = time.monotonic() + self.STATS_TIMEOUT
            row = (0, 0)
            buf = b""
            while time.monotonic() < deadline:
                r, _, _ = select.select([p.stdout], [], [],
                                        min(1.0,
                                            deadline - time.monotonic()))
                if not r:
                    continue
                chunk = os.read(p.stdout.fileno(), 4096)
                if not chunk:
                    break
                buf += chunk
                lines = buf.split(b"\n")
                buf = lines.pop()
                text = next((ln.decode().strip() for ln in lines
                             if ln.startswith(b"STATS")), None)
                if text is not None:
                    _, conns, deliv = text.split()
                    row = (int(conns), int(deliv))
                    break
            out.append(row)
        return out

    def stop(self, timeout: float = 20.0) -> None:
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.stdin.write(b"QUIT\n")
                    p.stdin.flush()
                except Exception:
                    p.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + timeout
        stuck = []
        for p in self.procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                # a kill without a wait can leave an exiting orphan
                # holding its SO_REUSEPORT share past stop(): bounded,
                # with a clear error for a true wedge
                try:
                    p.wait(timeout=self.REAP_TIMEOUT)
                except subprocess.TimeoutExpired:
                    stuck.append(p.pid)
        self.procs.clear()
        # keep the bookkeeping aligned for a retried start()
        self.tports.clear()
        self.ready_s.clear()
        self._seed_addr = ""
        if stuck:
            raise RuntimeError(
                f"worker pids {stuck} survived SIGKILL for "
                f"{self.REAP_TIMEOUT:.0f}s; orphans may still hold their "
                f"SO_REUSEPORT share of port {self.port}")

    def __enter__(self) -> "WorkerPool":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
