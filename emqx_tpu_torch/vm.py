"""Host/runtime introspection — the ``emqx_vm`` analogue (the port of
the JAX package's ``vm.py``).

The reference inspects the BEAM (schedulers, process/port counts,
memory allocators — src/emqx_vm.erl, 487 LoC) to feed ``emqx_ctl``'s
``vm`` command and the $SYS stats. The runtime here is a CPython
host process driving a GPU, so the equivalents are: host memory/CPU,
thread and fd counts, asyncio task count, GC generation counters, and
the CUDA device inventory with each card's allocated and total memory
(``torch.cuda``). A node on the CPU lists no card.

Everything reads from /proc (Linux) or the stdlib — no psutil in the
image.
"""

from __future__ import annotations

import gc
import os
import resource
import sys
import threading
from typing import Dict, List


def get_memory() -> Dict[str, int]:
    """RSS/VM sizes in bytes (emqx_vm:get_memory/0)."""
    out = {"rss": 0, "vms": 0, "max_rss": 0}
    try:
        with open("/proc/self/statm") as f:
            vms_pages, rss_pages = f.read().split()[:2]
        page = os.sysconf("SC_PAGE_SIZE")
        out["vms"] = int(vms_pages) * page
        out["rss"] = int(rss_pages) * page
    except OSError:
        pass
    # ru_maxrss is KiB on Linux
    out["max_rss"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return out


def get_process_info() -> Dict[str, int]:
    """Thread/fd/task counts — the process-count analogue
    (emqx_vm:get_process_count/0, get_port_count)."""
    try:
        fds = len(os.listdir("/proc/self/fd"))
    except OSError:
        fds = -1
    tasks = 0
    try:
        import asyncio
        tasks = len(asyncio.all_tasks())
    except RuntimeError:
        pass
    return {
        "threads": threading.active_count(),
        "fds": fds,
        "async_tasks": tasks,
        "gc_objects": len(gc.get_objects()),
    }


def get_gc_info() -> Dict[str, int]:
    """Collector generation counters (the BEAM GC stats analogue)."""
    stats = gc.get_stats()
    return {
        f"gen{i}_collections": s.get("collections", 0)
        for i, s in enumerate(stats)
    } | {
        f"gen{i}_collected": s.get("collected", 0)
        for i, s in enumerate(stats)
    }


def loads() -> List[float]:
    """1/5/15-minute load averages (emqx_vm:loads/0)."""
    try:
        return [round(x, 2) for x in os.getloadavg()]
    except OSError:
        return [0.0, 0.0, 0.0]


def cpu_count() -> int:
    """Scheduler-count analogue."""
    return os.cpu_count() or 1


def get_device_info(device=None) -> List[Dict[str, object]]:
    """CUDA device inventory: per card its index, ``platform`` "gpu",
    ``kind`` (the device name), ``bytes_in_use`` (memory allocated by
    this process's tensors) and ``bytes_limit`` (the card's total
    memory). Empty without CUDA, and for a node whose ``device`` is the
    CPU."""
    out: List[Dict[str, object]] = []
    if device is not None and getattr(device, "type", str(device)) != "cuda":
        return out
    import torch

    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        out.append({
            "id": i, "platform": "gpu",
            "kind": torch.cuda.get_device_name(i),
            "bytes_in_use": int(torch.cuda.memory_allocated(i)),
            "bytes_limit": int(props.total_memory),
        })
    return out


def get_system_info(device=None) -> Dict[str, object]:
    """The full ``ctl vm`` payload (emqx_vm:get_system_info/0);
    ``device`` is the node's (see :func:`get_device_info`)."""
    return {
        "python": sys.version.split()[0],
        "cpu_count": cpu_count(),
        "load": loads(),
        "memory": get_memory(),
        "process": get_process_info(),
        "gc": get_gc_info(),
        "devices": get_device_info(device),
    }
