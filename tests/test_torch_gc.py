"""The port's forced-GC policy and host monitors (``emqx_tpu_torch/gc.py``,
``monitors.py`` and the connection's byte-receive seam) against the
JAX package's, on the CPU.

The same received byte streams and the same readings, made from a
seed with numpy, go through both packages; collection counts and alarm
transitions are compared exactly.
"""

import asyncio
import gc
import types

import numpy as np
import pytest

from emqx_tpu import gc as jgc
from emqx_tpu import monitors as jmon
from emqx_tpu.alarm import AlarmManager as JAlarms
from emqx_tpu.metrics import Metrics as JMetrics
from emqx_tpu.node import Node as JNode
from emqx_tpu.zone import Zone as JZone
from emqx_tpu_torch import gc as pgc
from emqx_tpu_torch import monitors as pmon
from emqx_tpu_torch.alarm import AlarmManager as PAlarms
from emqx_tpu_torch.metrics import Metrics as PMetrics
from emqx_tpu_torch.node import Node as PNode
from emqx_tpu_torch.zone import Zone as PZone
from mqtt_client import TestClient


@pytest.fixture
def no_collect(monkeypatch):
    """Count the collections a policy forces without running them (the
    counts are what is compared; a real collection per case would only
    slow the suite)."""
    calls = []
    monkeypatch.setattr(jgc._gc, "collect", lambda *a: calls.append(a))
    return calls


def _stream(seed, n=2000):
    rng = np.random.default_rng(seed)
    return [int(x) for x in rng.integers(1, 65537, size=n)]


@pytest.mark.parametrize("limits", [(16000, 16 * 1024 * 1024), (7, 1 << 20),
                                    (1000, 64 * 1024), (1, 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_gc_policy_equal_collections_on_the_same_stream(limits, seed,
                                                        no_collect):
    jp, pp = jgc.GcPolicy(*limits), pgc.GcPolicy(*limits)
    forced0 = pgc.GcPolicy.forced
    seq = [(jp.inc(1, n), pp.inc(1, n)) for n in _stream(seed)]
    assert all(a == b for a, b in seq)
    assert pp.collections == jp.collections > 0
    assert (pp._cnt, pp._oct) == (jp._cnt, jp._oct)
    assert pgc.GcPolicy.forced - forced0 == pp.collections
    assert no_collect.count((0,)) == 2 * pp.collections  # young only


def test_gc_policy_defaults_and_global_gc(no_collect):
    assert vars(pgc.GcPolicy()) == vars(jgc.GcPolicy())
    assert PZone().force_gc_policy == JZone().force_gc_policy
    g = pgc.GlobalGc()
    assert g.interval == jgc.GlobalGc().interval == 900.0
    g.run_gc()
    assert g.runs == 1 and no_collect == [()]  # a full collection
    asyncio.run(pgc.GlobalGc(interval=None).run())  # returns at once


async def test_global_gc_runs_on_its_interval(no_collect):
    g = pgc.GlobalGc(interval=0.01)
    task = asyncio.get_running_loop().create_task(g.run())
    for _ in range(200):
        if g.runs >= 2:
            break
        await asyncio.sleep(0.01)
    task.cancel()
    assert g.runs >= 2


async def test_a_connection_forces_collections_as_the_jax_one_does():
    """Each PINGREQ waits for its PINGRESP, so every read is one
    packet: both packages' connections count the same reads and bytes
    against a policy of 4 packets."""
    zone_kw = {"force_gc_policy": (4, 1 << 20)}
    counts = []
    for N, Z, kw in ((JNode, JZone, {"boot_listeners": False}),
                     (PNode, PZone, {"device": "cpu"})):
        node = N(zone=Z(name="gcz", **zone_kw), **kw)
        lst = node.add_listener(port=0)
        await node.start()
        try:
            c = TestClient("pinger")
            await c.connect(port=lst.port)
            for _ in range(9):
                await c.ping()
            (conn,) = list(lst._conns)
            counts.append((conn._gc.collections, conn._gc._cnt,
                           conn._gc.count_limit))
            await c.close()
        finally:
            await node.stop()
    assert counts[0] == counts[1] == (2, 2, 4)
    off = PNode(device="cpu", zone=PZone(name="nogc",
                                         force_gc_policy=None))
    lst = off.add_listener(port=0)
    await off.start()
    try:
        c = TestClient("p2")
        await c.connect(port=lst.port)
        (conn,) = list(lst._conns)
        assert conn._gc is None
        await c.close()
    finally:
        await off.stop()


# -- monitors -------------------------------------------------------------

def _names(alarms, which):
    return sorted(a.name for a in alarms.get_alarms(which))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_os_mon_fires_and_clears_at_the_same_readings(seed):
    rng = np.random.default_rng(seed)
    readings = [(None if rng.random() < 0.1 else float(rng.random()),
                 None if rng.random() < 0.1 else float(rng.random()))
                for _ in range(300)]
    seqs = []
    for mod, A in ((jmon, JAlarms), (pmon, PAlarms)):
        alarms = A(node="t")
        m = mod.OsMon(alarms)
        seq = []
        for cpu, mem in readings:
            m.check(cpu, mem)
            seq.append((_names(alarms, "activated"),
                        len(alarms.get_alarms("deactivated"))))
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert any(s[0] for s in seqs[1]) and seqs[1][-1][1] > 0


@pytest.mark.parametrize("max_count", [0, 10, 1000])
def test_vm_mon_fires_and_clears_at_the_same_counts(max_count):
    counts = [int(x) for x in
              np.random.default_rng(max_count).integers(0, 1200, size=200)]
    seqs = []
    for mod, A in ((jmon, JAlarms), (pmon, PAlarms)):
        alarms = A(node="t")
        m = mod.VmMon(alarms, lambda: 0, max_count=max_count)
        seq = []
        for n in counts:
            m.check(n)
            seq.append(_names(alarms, "activated"))
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    if max_count == 10:
        assert ["too_many_processes"] in seqs[1]


def test_os_mon_reads_the_host():
    m = pmon.OsMon(PAlarms(node="t"))
    assert m.sample_cpu() is None  # the first reading sets the base
    usage = m.sample_cpu()
    assert usage is None or 0.0 <= usage <= 1.0
    mem = pmon.read_mem_usage()
    assert mem is None or 0.0 < mem < 1.0


def test_sys_mon_counts_long_collections_and_lag_equally(monkeypatch):
    rng = np.random.default_rng(4)
    pauses = [float(x) for x in rng.exponential(60.0, size=200)]
    lags = [float(x) for x in rng.exponential(0.2, size=200)]
    out = []
    for mod, M in ((jmon, JMetrics), (pmon, PMetrics)):
        clock = {"t": 0.0}
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=lambda: clock["t"]))
        metrics = M()
        fired = []
        hooks = types.SimpleNamespace(
            run=lambda name, args: fired.append((name, args)))
        sm = mod.SysMon(metrics=metrics, hooks=hooks)
        for ms in pauses:
            sm._on_gc("start", {})
            clock["t"] += ms / 1000.0
            sm._on_gc("stop", {})
        sm._on_gc("stop", {})  # a stop without a start: nothing
        for lag in lags:
            sm.check_lag(1.0, 1.0 + lag)
        out.append((sm.long_gc_count, sm.long_schedule_count,
                    metrics.val("sysmon.long_gc"),
                    metrics.val("sysmon.long_schedule"), len(fired)))
    assert out[0] == out[1]
    assert out[1][0] == sum(1 for p in pauses if p > 100.0) > 0


def test_sys_mon_hook_is_installed_once_and_removed():
    sm = pmon.SysMon()
    n0 = len(gc.callbacks)
    sm.install_gc_hook()
    sm.install_gc_hook()
    assert len(gc.callbacks) == n0 + 1
    sm.remove_gc_hook()
    sm.remove_gc_hook()
    assert len(gc.callbacks) == n0


async def test_sys_mon_run_records_the_loop_lag_and_removes_its_hook():
    sm = pmon.SysMon(tick=0.01)
    n0 = len(gc.callbacks)
    task = asyncio.get_running_loop().create_task(sm.run())
    await asyncio.sleep(0.05)
    assert len(gc.callbacks) == n0 + 1
    assert sm.loop_lags[0] >= 0.0
    task.cancel()
    with pytest.raises(asyncio.CancelledError):
        await task
    assert len(gc.callbacks) == n0
