"""Host resource monitors → alarms (the port of the JAX package's
``monitors.py``).

The reference watches the BEAM and the OS and raises alarms on
watermarks: ``emqx_os_mon`` (CPU/memory, src/emqx_os_mon.erl),
``emqx_vm_mon`` (process count, src/emqx_vm_mon.erl) and
``emqx_sys_mon`` (long_gc / long_schedule / busy_port VM events,
src/emqx_sys_mon.erl). Here the host runtime is a Python process on
Linux, so:

  - :class:`OsMon` reads ``/proc/stat`` deltas and ``/proc/meminfo``;
  - :class:`VmMon` watches a supplied count (connections by default —
    the asyncio analogue of the process count) against a watermark;
  - :class:`SysMon` measures event-loop lag (the analogue of
    long_schedule: the scheduler not getting to our task on time) and
    Python GC pauses via ``gc.callbacks`` (the analogue of long_gc);
    its hook also feeds every full collection to the node's telemetry
    (the ``gc`` stage) and, while tracing samples, to a ``gc``
    interval on the collecting thread's ring.

Each monitor has a pure ``check(...)`` (unit-testable with injected
readings) and an async ``run()`` loop the node supervises. Alarm
names mirror the reference: ``high_cpu_usage``, ``high_memory_usage``,
``too_many_processes``.
"""

from __future__ import annotations

import asyncio
import gc as _gc
import logging
import time
from typing import Callable, List, Optional

from emqx_tpu_torch.alarm import AlarmManager

log = logging.getLogger("emqx_tpu_torch.monitors")


def read_cpu_times() -> Optional[tuple]:
    """(busy, total) jiffies from /proc/stat, None off-Linux."""
    try:
        with open("/proc/stat") as f:
            parts = f.readline().split()
        vals = [int(v) for v in parts[1:9]]
        idle = vals[3] + vals[4]  # idle + iowait
        total = sum(vals)
        return total - idle, total
    except (OSError, ValueError, IndexError):
        return None


def read_mem_usage() -> Optional[float]:
    """Used-memory fraction from /proc/meminfo, None off-Linux."""
    try:
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, _, rest = line.partition(":")
                info[k] = int(rest.split()[0])
        total = info["MemTotal"]
        avail = info.get(
            "MemAvailable",
            info.get("MemFree", 0) + info.get("Buffers", 0)
            + info.get("Cached", 0))
        return (total - avail) / total if total else None
    except (OSError, ValueError, KeyError):
        return None


class OsMon:
    """CPU/memory watermark monitor (emqx_os_mon defaults:
    cpu_high_watermark 80%, cpu_low_watermark 60%, 60s interval;
    mem watermarks from os_mon's memsup)."""

    def __init__(self, alarms: AlarmManager,
                 cpu_high: float = 0.80, cpu_low: float = 0.60,
                 mem_high: float = 0.80, mem_low: float = 0.60,
                 interval: float = 60.0) -> None:
        self.alarms = alarms
        self.cpu_high = cpu_high
        self.cpu_low = cpu_low
        self.mem_high = mem_high
        self.mem_low = mem_low
        self.interval = interval
        self._prev_cpu: Optional[tuple] = None

    def check(self, cpu_usage: Optional[float],
              mem_usage: Optional[float]) -> None:
        """Apply one reading pair (fractions in [0,1] or None)."""
        if cpu_usage is not None:
            if cpu_usage > self.cpu_high:
                self.alarms.activate(
                    "high_cpu_usage", {"usage": round(cpu_usage, 4)},
                    f"cpu usage {cpu_usage:.0%} > {self.cpu_high:.0%}")
            elif cpu_usage < self.cpu_low:
                self.alarms.deactivate("high_cpu_usage")
        if mem_usage is not None:
            if mem_usage > self.mem_high:
                self.alarms.activate(
                    "high_memory_usage", {"usage": round(mem_usage, 4)},
                    f"mem usage {mem_usage:.0%} > {self.mem_high:.0%}")
            elif mem_usage < self.mem_low:
                self.alarms.deactivate("high_memory_usage")

    def sample_cpu(self) -> Optional[float]:
        cur = read_cpu_times()
        if cur is None:
            return None
        usage = None
        if self._prev_cpu is not None:
            busy = cur[0] - self._prev_cpu[0]
            total = cur[1] - self._prev_cpu[1]
            if total > 0:
                usage = busy / total
        self._prev_cpu = cur
        return usage

    async def run(self) -> None:
        while True:
            self.check(self.sample_cpu(), read_mem_usage())
            await asyncio.sleep(self.interval)


class VmMon:
    """Count-watermark monitor (emqx_vm_mon: process_count against
    process_high_watermark of max; here the count defaults to live
    connections against the listener limit)."""

    def __init__(self, alarms: AlarmManager, count_fn: Callable[[], int],
                 max_count: int, high: float = 0.80, low: float = 0.60,
                 interval: float = 30.0,
                 alarm_name: str = "too_many_processes") -> None:
        self.alarms = alarms
        self.count_fn = count_fn
        self.max_count = max_count
        self.high = high
        self.low = low
        self.interval = interval
        self.alarm_name = alarm_name

    def check(self, count: int) -> None:
        if self.max_count <= 0:
            return
        frac = count / self.max_count
        if frac > self.high:
            self.alarms.activate(
                self.alarm_name,
                {"count": count, "max": self.max_count},
                f"{count}/{self.max_count} > {self.high:.0%}")
        elif frac < self.low:
            self.alarms.deactivate(self.alarm_name)

    async def run(self) -> None:
        while True:
            self.check(self.count_fn())
            await asyncio.sleep(self.interval)


class SysMon:
    """Runtime-event monitor: event-loop lag ≈ long_schedule, GC
    pauses ≈ long_gc (emqx_sys_mon publishes these to '$SYS' and
    counts them; we count + log + optionally alarm)."""

    def __init__(self, metrics=None, hooks=None,
                 long_schedule_ms: float = 240.0,
                 long_gc_ms: float = 100.0,
                 tick: float = 1.0) -> None:
        self.metrics = metrics
        if metrics is not None:
            metrics.new("sysmon.long_gc")
            metrics.new("sysmon.long_schedule")
        self.hooks = hooks
        self.long_schedule_ms = long_schedule_ms
        self.long_gc_ms = long_gc_ms
        self.tick = tick
        self.long_schedule_count = 0
        self.long_gc_count = 0
        self._gc_t0: Optional[float] = None
        self._gc_installed = False
        # the node's telemetry and tracing planes (wired by Node): the
        # full collections' ``gc`` stage and intervals; None = neither
        self.telemetry = None
        self.tracing = None
        # per-loop scheduling lag (ms), index 0 = the main loop. Peer
        # entries are written by their own loop's probe callback and
        # read by the main loop's tick and the stats flush — float
        # stores are atomic under the GIL, no lock needed
        self.loop_group = None
        self.loop_lags: List[float] = [0.0]
        self._probe_seq: List[int] = [0]
        self._seen_seq: List[int] = [0]

    def bind_loops(self, loop_group) -> None:
        """Extend lag monitoring over every loop of a LoopGroup: each
        tick posts a timestamped probe to every live peer loop; the
        probe (running ON that loop) records its scheduling delay."""
        self.loop_group = loop_group
        n = loop_group.n
        self.loop_lags = [0.0] * n
        self._probe_seq = [0] * n
        self._seen_seq = [0] * n

    def _probe_loop(self, idx: int, t_post: float) -> None:
        # runs on peer loop `idx`: the post → run delay IS its lag
        self.loop_lags[idx] = (time.perf_counter() - t_post) * 1000.0
        self._probe_seq[idx] += 1

    # -- GC pause tracking (gc.callbacks) ------------------------------

    def install_gc_hook(self) -> None:
        if not self._gc_installed:
            _gc.callbacks.append(self._on_gc)
            self._gc_installed = True

    def remove_gc_hook(self) -> None:
        if self._gc_installed:
            try:
                _gc.callbacks.remove(self._on_gc)
            except ValueError:
                pass
            self._gc_installed = False

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif phase == "stop" and self._gc_t0 is not None:
            ms = (time.perf_counter() - self._gc_t0) * 1000.0
            self._gc_t0 = None
            if info.get("generation") == 2:
                tel = self.telemetry
                if tel is not None:
                    tel.observe_gc(ms)
                trc = self.tracing
                if trc is not None and trc.active:
                    trc.interval_at("gc", time.time() - ms / 1000.0, ms)
            if ms > self.long_gc_ms:
                self.on_long_gc(ms)

    # -- events --------------------------------------------------------

    def on_long_gc(self, ms: float) -> None:
        self.long_gc_count += 1
        log.warning("long_gc: %.1fms", ms)
        if self.metrics is not None:
            self.metrics.inc("sysmon.long_gc")
        if self.hooks is not None:
            self.hooks.run("sysmon.long_gc", (ms,))

    def on_long_schedule(self, ms: float) -> None:
        self.long_schedule_count += 1
        log.warning("long_schedule: event loop lagged %.1fms", ms)
        if self.metrics is not None:
            self.metrics.inc("sysmon.long_schedule")
        if self.hooks is not None:
            self.hooks.run("sysmon.long_schedule", (ms,))

    def check_lag(self, expected_s: float, actual_s: float) -> None:
        lag_ms = (actual_s - expected_s) * 1000.0
        if lag_ms > self.long_schedule_ms:
            self.on_long_schedule(lag_ms)

    async def run(self) -> None:
        self.install_gc_hook()
        try:
            while True:
                t0 = time.perf_counter()
                await asyncio.sleep(self.tick)
                elapsed = time.perf_counter() - t0
                self.check_lag(self.tick, elapsed)
                self.loop_lags[0] = max(
                    0.0, (elapsed - self.tick) * 1000.0)
                lg = self.loop_group
                if lg is not None:
                    # fold the last tick's peer probes (events fire on
                    # the main loop: hooks and metrics are not posted
                    # from peer threads), then post the next round
                    for i in range(1, lg.n):
                        if self._probe_seq[i] != self._seen_seq[i]:
                            self._seen_seq[i] = self._probe_seq[i]
                            lag = self.loop_lags[i]
                            if lag > self.long_schedule_ms:
                                self.on_long_schedule(lag)
                        if lg.alive(i):
                            try:
                                lg.post(i, self._probe_loop, i,
                                        time.perf_counter())
                            except RuntimeError:
                                pass  # the loop died since alive()
        finally:
            self.remove_gc_hook()
