"""``python -m emqx_tpu_torch [--config etc/emqx_tpu.toml]`` — run a
broker node of the port (the reference's ``emqx start`` / emqx_app
boot, src/emqx_app.erl:31-44).

The flags are the JAX package's (``--config``, ``--port``, ``--host``,
``--log-level``, ``--workers``, ``--loops``, ``--restart-intensity``)
plus ``--device`` (``cuda`` by default; ``cpu`` runs the plain PyTorch
path). Without CUDA a ``cuda`` node raises at boot. With ``--workers
N`` (N > 1) a supervisor runs a :class:`~emqx_tpu_torch.workers.
WorkerPool` and restarts a dead worker, up to ``--restart-intensity``
restarts a minute. A SIGTERM stops the node; with ``[drain]
on_sigterm = true`` it first drains the node (paced redirects and the
session hand-off, bounded by ``sigterm_grace_s``); a second SIGTERM
stops at once.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import time


def _supervise(args) -> int:
    """The worker pool with an OTP-style restart intensity: a dead
    worker restarts until ``--restart-intensity`` restarts fall within
    60 s, then the pool gives up with a failure exit."""
    from emqx_tpu_torch.workers import WorkerPool

    pool = WorkerPool(args.workers, port=args.port, host=args.host,
                      device=args.device)
    port = pool.start()
    print(f"listening: {args.workers} workers on {args.host}:{port}",
          flush=True)
    rc = 0
    restarts: list = []  # restart times inside the intensity window
    stop = []
    signal.signal(signal.SIGTERM, lambda *_: stop.append(True))
    try:
        while not stop:
            for i, p in enumerate(pool.procs):
                if p.poll() is None:
                    continue
                print(f"worker {i} exited rc={p.returncode}", flush=True)
                now = time.monotonic()
                restarts[:] = [t for t in restarts if now - t < 60]
                if len(restarts) >= args.restart_intensity:
                    # intensity exceeded: the reference supervisor gives
                    # up the same way — a FAILURE exit, so a process
                    # supervisor sees it
                    print(f"restart intensity exceeded "
                          f"({args.restart_intensity}/60s); giving up",
                          flush=True)
                    rc = 1
                    break
                try:
                    pool.restart_worker(i)
                    restarts.append(now)
                    print(f"worker {i} restarted", flush=True)
                except Exception as e:
                    print(f"worker {i} restart failed: {e}", flush=True)
                    rc = 1
                    break
            if rc:
                break
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        pool.stop()
    return rc


async def _serve(node) -> None:
    await node.start()
    for lst in node.listeners:
        print(f"listening: {lst.name} on {lst.host}:{lst.port}", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    hold = []  # a strong reference: a weakly held drain task may vanish

    async def _drain_then_stop():
        # SIGTERM drain mode ([drain] on_sigterm): redirect the clients
        # in paced waves and hand session custody over, bounded by the
        # grace window, then the normal graceful stop
        try:
            dr = node.drain
            if not dr.active:
                dr.start()
            await dr.wait(dr.cfg.sigterm_grace_s)
        except Exception:
            logging.getLogger("emqx_tpu_torch").exception(
                "SIGTERM drain failed; stopping anyway")
        finally:
            stop.set()

    def _term():
        if node.drain.cfg.on_sigterm and not node.drain.active \
                and not stop.is_set():
            hold.append(loop.create_task(_drain_then_stop()))
        else:
            # no drain mode, a drain already running, or a SECOND
            # SIGTERM: stop now
            stop.set()

    loop.add_signal_handler(signal.SIGINT, stop.set)
    loop.add_signal_handler(signal.SIGTERM, _term)
    await stop.wait()
    await node.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="emqx_tpu_torch",
        description="MQTT broker node on PyTorch/CUDA")
    ap.add_argument("--config", "-c", default=None,
                    help="TOML config file (see etc/emqx_tpu.toml)")
    ap.add_argument("--port", type=int, default=1883,
                    help="TCP listener port when no config file is given")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--log-level", default="INFO")
    ap.add_argument("--workers", type=int, default=0,
                    help="SO_REUSEPORT worker processes sharing the "
                         "port, clustered (0 = single process)")
    ap.add_argument("--loops", type=int, default=1,
                    help="front-door event loops inside the node "
                         "(in-process connection sharding; 1 = "
                         "single loop). Ignored with --workers > 1 "
                         "or --config (use [node] loops there)")
    ap.add_argument("--restart-intensity", type=int, default=5,
                    help="max worker restarts per 60s window before "
                         "the pool gives up with a failure exit "
                         "(OTP supervisor intensity; 0 = never "
                         "restart, fail on first death)")
    ap.add_argument("--device", default="cuda",
                    help="the node's device: cuda (the default; raises "
                         "without CUDA) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    from emqx_tpu_torch.logger import setup as setup_logger
    setup_logger(level=getattr(logging, args.log_level.upper(),
                               logging.INFO))

    if args.workers > 1:
        return _supervise(args)
    if args.config:
        from emqx_tpu_torch.config import boot_from_file
        node = boot_from_file(args.config, device=args.device)
    else:
        from emqx_tpu_torch.node import Node
        node = Node(boot_listeners=False, loops=max(1, args.loops),
                    device=args.device)
        node.add_listener(host=args.host, port=args.port)
    asyncio.run(_serve(node))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
