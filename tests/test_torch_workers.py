"""The port's SO_REUSEPORT worker pool (``emqx_tpu_torch.workers``):
tests/test_workers.py's four scenarios on ``WorkerPool(2,
device="cpu")``.

N worker processes, each a port ``Node`` on the device it was given on
its command line, share one MQTT port and join one cluster: a
subscriber accepted by one worker receives what another worker
ingested (6 subscribers × 3 publishes, every delivery checked); one
client id across the workers ends with one live session; a worker
killed mid-traffic leaves a pool whose survivor serves every fresh and
surviving client; a restarted seed worker rejoins through the surviving
one. Every wait is bounded: the pool's READY and STATS budgets, the
clients' receive timeouts and an ``asyncio.wait_for`` around each test.
A pool asked for ``cuda`` on a host without CUDA raises in the parent
and spawns nothing.
"""

import asyncio
import socket
import time

import pytest
import torch

from emqx_tpu.mqtt import constants as C
from emqx_tpu_torch.workers import WorkerPool

from mqtt_client import TestClient

LIMIT = 150.0

needs_reuseport = pytest.mark.skipif(
    not hasattr(socket, "SO_REUSEPORT"), reason="no SO_REUSEPORT")


def run(coro):
    asyncio.run(asyncio.wait_for(coro, LIMIT))


@needs_reuseport
def test_worker_pool_cross_worker_delivery():
    async def main():
        with WorkerPool(2, port=0, device="cpu", cookie="wk-test") as pool:
            port = pool.port
            # the kernel hashes each 4-tuple to a worker, so subscribers
            # and publishers spread over both
            subs = []
            for i in range(6):
                s = TestClient(f"wsub{i}", version=C.MQTT_V5)
                await s.connect(port=port)
                await s.subscribe("wk/+", qos=0)
                subs.append(s)
            await asyncio.sleep(0.7)  # route replication settles
            pub = TestClient("wpub", version=C.MQTT_V5)
            await pub.connect(port=port)
            for k in range(3):
                await pub.publish(f"wk/{k}", f"m{k}".encode(), qos=1)
            got = []
            for s in subs:
                for _ in range(3):
                    m = await s.recv(30)
                    got.append((s.client_id, m.topic, m.payload))
            assert sorted(got) == sorted(
                (f"wsub{i}", f"wk/{k}", f"m{k}".encode())
                for i in range(6) for k in range(3))
            stats = pool.stats()
            assert sum(c for c, _ in stats) == 7, stats
            assert sum(d for _, d in stats) >= 18, stats
            for c in subs + [pub]:
                await c.close()

    run(main())


@needs_reuseport
def test_worker_pool_same_clientid_across_workers():
    """The distributed clientid lock holds across the pool: a duplicate
    client id through the shared port ends with one live session."""
    async def main():
        with WorkerPool(2, port=0, device="cpu", cookie="wk-test2") as pool:
            c1 = TestClient("wdup", version=C.MQTT_V5)
            await c1.connect(port=pool.port)
            c2 = TestClient("wdup", version=C.MQTT_V5)
            await c2.connect(port=pool.port)
            await asyncio.sleep(0.7)
            stats = pool.stats()
            assert sum(c for c, _ in stats) == 1, stats
            await c2.close()

    run(main())


@needs_reuseport
def test_worker_killed_mid_traffic_cluster_recovers():
    """SIGKILL one worker while clients are live: the survivor serves on,
    the dead worker's routes purge once the probe declares it down, and
    clients connecting through the shared port get every delivery."""
    async def main():
        with WorkerPool(2, port=0, device="cpu", cookie="wk-kill") as pool:
            port = pool.port
            subs = []
            for i in range(6):
                s = TestClient(f"kr{i}", version=C.MQTT_V5)
                await s.connect(port=port)
                await s.subscribe("kr/+", qos=1)
                subs.append(s)
            await asyncio.sleep(0.7)
            pub = TestClient("krpub", version=C.MQTT_V5)
            await pub.connect(port=port)
            await pub.publish("kr/a", b"before", qos=1, timeout=30)
            for s in subs:
                assert (await s.recv(30)).payload == b"before"
            pool.procs[1].kill()  # a hard death, no goodbye
            await asyncio.sleep(4.0)
            live = []
            for s in subs:
                try:
                    await s.ping(timeout=3)
                    live.append(s)
                except Exception:
                    pass
            fresh = TestClient("kr-new", version=C.MQTT_V5)
            await fresh.connect(port=port)
            await fresh.subscribe("kr/+", qos=1)
            pub2 = TestClient("krpub2", version=C.MQTT_V5)
            await pub2.connect(port=port)
            await pub2.publish("kr/b", b"after", qos=1, timeout=30)
            assert (await fresh.recv(30)).payload == b"after"
            for s in live:
                assert (await s.recv(30)).payload == b"after"
            for c in live + [fresh, pub2]:
                try:
                    await c.close()
                except Exception:
                    pass

    run(main())


@needs_reuseport
def test_restart_worker_rejoins_cluster():
    """``restart_worker`` replaces a dead SEED worker in place and the
    replacement rejoins through the surviving one."""
    async def main():
        with WorkerPool(2, port=0, device="cpu", cookie="wk-rs") as pool:
            port = pool.port
            pool.procs[0].kill()
            time.sleep(0.5)
            pool.restart_worker(0)  # must reseed through worker 1
            await asyncio.sleep(1.0)
            subs = []
            for i in range(6):
                s = TestClient(f"rs{i}", version=C.MQTT_V5)
                await s.connect(port=port)
                await s.subscribe("rs/t", qos=1)
                subs.append(s)
            await asyncio.sleep(0.7)
            pub = TestClient("rspub", version=C.MQTT_V5)
            await pub.connect(port=port)
            await pub.publish("rs/t", b"rebuilt", qos=1, timeout=30)
            for s in subs:
                assert (await s.recv(30)).payload == b"rebuilt"
            stats = pool.stats()
            assert all(p.poll() is None for p in pool.procs), stats
            for c in subs + [pub]:
                await c.close()

    run(main())


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="holds the no-CUDA refusal; this host has CUDA")
def test_worker_pool_on_cuda_raises_without_it():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WorkerPool(2, port=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WorkerPool(2, port=0, device="cuda")
