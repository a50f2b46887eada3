"""The traced window: torch.profiler over the card, reduced in memory.

A traced run (``--trace 1``) profiles the whole measured window with
CPU and CUDA activity and keeps nothing on disk. The reduction gives:

- each device operation's total seconds in the window (kernels, copies
  and fills, by name);
- the device's busy seconds, the union of those intervals, and the
  window's length;
- the idle gaps between them, each labelled by the publish stages the
  host was in meanwhile and by the interpreter's full collections (the
  harness records those intervals with the wall clock; one annotation
  calibrates that clock against the trace's).

The profiler (torch 2.11 on an NVIDIA H100) drops the first kernel
records of a trace window, more the older the process, while their
launch records stay; so the window opens with :data:`TRACE_FLUSH`
launches of a one-cycle spin kernel of its own, which the reduction
leaves out (``chip_smoke.py``'s ``flush_trace``, copied).
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

TRACE_FLUSH = 1000
#: the kernel of ``torch.cuda._sleep``, launched to open the window
FLUSH_KERNEL = "spin_kernel"
#: the annotation that ties the harness's wall clock to the trace's
MARK = "benchmark.clock_mark"
#: entries a breakdown list keeps
TOP = 10


class HostStages:
    """Wall-clock intervals of the publish stages, from any thread."""

    def __init__(self) -> None:
        self.spans: List[Tuple[str, int, int]] = []
        self._lock = threading.Lock()

    def wrap(self, obj, attr: str, label: str) -> None:
        """Record every call of ``obj.attr`` as a ``label`` interval."""
        fn = getattr(obj, attr)
        spans, lock = self.spans, self._lock

        def timed(*a, **kw):
            t0 = time.time_ns()
            try:
                return fn(*a, **kw)
            finally:
                t1 = time.time_ns()
                with lock:
                    spans.append((label, t0, t1))

        setattr(obj, attr, timed)


def warm_profiler() -> None:
    """One short profiled launch: the profiler's first start on a
    process loads and arms its tracing of the card, which takes seconds
    (about 10 s on an H100 host), and belongs to the set-up, not to the
    window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda._sleep(1)
        torch.cuda.synchronize()


class Window:
    """One profiler window over the measured seconds."""

    def __init__(self, device: str = "cuda") -> None:
        self.cuda = device == "cuda"
        self.prof = None
        self.offset_ns = 0
        self.t0_ns = self.t1_ns = 0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        if self.cuda:
            for _ in range(TRACE_FLUSH):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        self._mark_wall = time.time_ns()
        with record_function(MARK):
            pass

    def open(self) -> None:
        self.t0_ns = time.time_ns()

    def close(self) -> None:
        self.t1_ns = time.time_ns()

    def stop(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def _events(self):
        res = self.prof.profiler.kineto_results
        return res.events()

    def reduce(self, host: Optional[HostStages]) -> dict:
        """``{"ops": {name: seconds}, "busy_s", "window_s", "gaps":
        [(label, seconds)]}`` over the window ``[t0, t1)``."""
        from torch.autograd import DeviceType

        evs = self._events()
        for e in evs:
            if e.name() == MARK:
                self.offset_ns = e.start_ns() - self._mark_wall
                break
        lo = self.t0_ns + self.offset_ns
        hi = self.t1_ns + self.offset_ns
        ops: Dict[str, float] = defaultdict(float)
        iv: List[Tuple[int, int]] = []
        for e in evs:
            if e.device_type() != DeviceType.CUDA:
                continue
            name = e.name()
            if FLUSH_KERNEL in name:
                continue
            s = e.start_ns()
            t = s + e.duration_ns()
            s, t = max(s, lo), min(t, hi)
            if t <= s:
                continue
            ops[name] += (t - s) / 1e9
            iv.append((s, t))
        iv.sort()
        busy = 0
        gaps: List[Tuple[int, int]] = []
        cur_s, cur_t = lo, lo
        for s, t in iv:
            if s > cur_t:
                if cur_t > cur_s:
                    busy += cur_t - cur_s
                gaps.append((cur_t, s))
                cur_s, cur_t = s, t
            else:
                cur_t = max(cur_t, t)
        busy += cur_t - cur_s
        if hi > cur_t:
            gaps.append((cur_t, hi))
        return {"ops": dict(ops), "busy_s": busy / 1e9,
                "window_s": (hi - lo) / 1e9,
                "gaps": label_gaps(gaps, host, self.offset_ns)}


def _union(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, t in sorted(iv):
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1] = (out[-1][0], t)
        else:
            out.append((s, t))
    return out


def label_gaps(gaps: List[Tuple[int, int]], host: Optional[HostStages],
               offset_ns: int) -> List[Tuple[str, float, int]]:
    """Idle seconds by the set of host stages overlapping each gap:
    ``[(label, seconds, gaps)]``, most idle first."""
    by_label: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    for lab, s, t in (host.spans if host else ()):
        by_label[lab].append((s + offset_ns, t + offset_ns))
    unions = {lab: _union(iv) for lab, iv in by_label.items()}
    starts = {lab: [s for s, _ in u] for lab, u in unions.items()}
    tot: Dict[str, float] = defaultdict(float)
    cnt: Dict[str, int] = defaultdict(int)
    for g0, g1 in gaps:
        labs = []
        for lab, u in unions.items():
            # the last interval starting before the gap's end
            k = bisect.bisect_left(starts[lab], g1) - 1
            if k >= 0 and u[k][1] > g0:
                labs.append(lab)
        label = "+".join(sorted(labs)) if labs else "no publish stage"
        tot[label] += (g1 - g0) / 1e9
        cnt[label] += 1
    out = [(lab, sec, cnt[lab]) for lab, sec in tot.items()]
    out.sort(key=lambda x: -x[1])
    return out


def kernel_seconds(red: Optional[dict], name: str) -> float:
    """Summed device seconds of the operations whose name holds
    ``name`` (0 without a trace)."""
    if not red:
        return 0.0
    return sum(v for k, v in red["ops"].items() if name in k)
