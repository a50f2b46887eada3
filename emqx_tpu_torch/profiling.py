"""Device profiling: ``torch.profiler`` traces and per-kernel timing
(the port of the JAX package's ``profiling.py``).

The reference profiles with BEAM VM introspection (emqx_vm.erl) and
system monitors (SURVEY §5 "Tracing/profiling"); here that is the
PyTorch profiler (a Chrome trace of every kernel and host op) plus
wall-clock timing of whole calls. Exposed as:

  - :func:`trace` — a context manager writing a ``torch.profiler``
    Chrome trace of the enclosed block (``chrome://tracing`` or
    Perfetto);
  - :class:`KernelTimer` — named wall-clock accumulators that wait for
    the output's device at the end of a span (per-call timing for the
    smoke script);
  - :func:`register_ctl` — the live node's ``profile`` command:
    ``start [dir]`` / ``stop`` around a :func:`start_trace` /
    :func:`stop_trace` pair (a Chrome trace where the JAX package
    writes a TensorBoard dump; ``stop`` lays the node's publish-stage
    intervals over it, :func:`merge_intervals`) and ``loops`` (the
    sampling loop profiler, :class:`~emqx_tpu_torch.tracing.LoopProfiler`).
    The automaton's rebuilds are the telemetry's ``rebuild`` stage.

The JAX package's ``enable_compile_cache`` has no counterpart: the
port's kernels are compiled once into ``emqx_tpu_torch/_build/`` at
first use and loaded from there afterwards.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import deque
from typing import Dict, Optional


#: the trace started by :func:`start_trace`: its directory, the
#: running ``torch.profiler.profile`` and its start on the wall clock
_active: Dict[str, Optional[object]] = {"dir": None, "prof": None,
                                        "t0": None}

#: the annotation that ties the wall clock to the profiler's; it
#: encloses no launch or copy, so the trace holds it on the host alone
CLOCK_MARK = "emqx_tpu_torch.clock_mark"
#: the first row id of the merged intervals, past any OS thread id
INTERVAL_TID_BASE = 1 << 32


def start_trace(logdir: str):
    """Start a ``torch.profiler`` trace (host ops, and the card's
    kernels when CUDA is available) that :func:`stop_trace` writes to
    ``<logdir>/trace.json``; returns the profiler. One at a time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if _active["prof"] is not None:
        raise RuntimeError(f"already tracing to {_active['dir']}")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    _active["dir"], _active["prof"] = logdir, prof
    _active["t0"] = time.time()
    return prof


def clock_mark() -> int:
    """Two empty :data:`CLOCK_MARK` annotations; returns the wall
    clock (ns) read just before the second, whose start the trace
    holds (the first takes the annotation's one-time set-up)."""
    from torch.profiler import record_function

    with record_function(CLOCK_MARK):
        pass
    t = time.time_ns()
    with record_function(CLOCK_MARK):
        pass
    return t


def stop_trace(tracing=None) -> str:
    """Stop the running trace and write its Chrome trace; returns the
    file's path. With a node's ``tracing`` plane, a clock mark is
    taken inside the window and the intervals its rings retained over
    the window are laid over the trace (:func:`merge_intervals`)."""
    prof, logdir, t0 = _active["prof"], _active["dir"], _active["t0"]
    if prof is None:
        raise RuntimeError("not tracing")
    _active["dir"] = _active["prof"] = _active["t0"] = None
    mark_ns = clock_mark() if tracing is not None else None
    t1 = time.time()
    prof.stop()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    if tracing is not None:
        tracing.collect()
        merge_intervals(path, tracing, mark_ns, t0, t1)
    return path


def merge_intervals(path: str, tracing, mark_ns: int, t0: float,
                    t1: float) -> None:
    """Add ``tracing``'s intervals over wall-clock ``[t0, t1]`` to the
    Chrome trace at ``path``, moved onto the profiler's clock by the
    last :data:`CLOCK_MARK` (read at wall clock ``mark_ns``): each
    thread's stages, waits and full collections on rows of their own
    in the trace's own process."""
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    marks = [e for e in evs
             if e.get("name") == CLOCK_MARK and e.get("ph") == "X"]
    if not marks:
        raise RuntimeError(f"no {CLOCK_MARK} in {path}")
    mark = max(marks, key=lambda e: e["ts"])
    shift_us = mark["ts"] - mark_ns / 1000.0
    evs += tracing.interval_events(t0, t1, shift_us, mark["pid"],
                                   INTERVAL_TID_BASE)
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace over the enclosed block, written to
    ``<logdir>/trace.json`` in Chrome trace format."""
    prof = start_trace(logdir)
    try:
        yield prof
    finally:
        stop_trace()


def _wait_for(out) -> None:
    """Block until every CUDA tensor in ``out`` (a tensor, or a tuple,
    list or dict of them, nested) is computed: one device sync per card
    the outputs live on. A CPU tensor, or anything else, needs nothing."""
    import torch

    devices = set()
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
    for dev in devices:
        torch.cuda.synchronize(dev)


class KernelTimer:
    """Named wall-clock timing of whole calls.

    The span yields a capture function; pass it the call's output so
    the timer waits for the card at the end of the span (otherwise only
    the asynchronous launch is measured, microseconds instead of the
    device execution)::

        with timer.span("match") as done:
            done(step(x))

    p50/p99 per name; samples ring-buffered (a long-lived node must
    not grow timing lists without bound).
    """

    MAX_SAMPLES = 4096

    def __init__(self) -> None:
        self._samples: Dict[str, deque] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        holder = {}

        def _block(x):
            holder["out"] = x
            return x

        try:
            yield _block
        finally:
            if "out" in holder:
                _wait_for(holder["out"])
            self.record(name, (time.perf_counter() - t0) * 1000.0)

    def record(self, name: str, ms: float) -> None:
        self._samples.setdefault(
            name, deque(maxlen=self.MAX_SAMPLES)).append(ms)

    def stats(self) -> Dict[str, Dict[str, float]]:
        import numpy as np

        out = {}
        for name, xs in self._samples.items():
            arr = np.asarray(xs)
            out[name] = {
                "count": int(arr.size),
                "p50_ms": float(np.percentile(arr, 50)),
                "p99_ms": float(np.percentile(arr, 99)),
                "total_ms": float(arr.sum()),
            }
        return out

    def reset(self) -> None:
        self._samples.clear()


def register_ctl(ctl) -> None:
    """``profile start <dir> | stop | loops ...`` on a live node."""
    import tempfile

    def _profile_loops(args):
        # the per-loop sampling profiler (tracing.LoopProfiler):
        # collapsed Python stacks over the node's loop and the ingress
        # executor
        trc = getattr(getattr(ctl, "node", None), "tracing", None)
        if trc is None:
            return "loop profiler unavailable (no node)"
        prof = trc.profiler
        if not args or args[0] == "show":
            state = "running" if prof.running else "stopped"
            head = f"loop profiler: {state}, {prof.samples} samples"
            stacks = prof.collapsed(top=20)
            return head + ("\n" + stacks if stacks else "")
        if args[0] == "start":
            if not prof.start():
                return "loop profiler already running"
            return (f"loop profiler sampling every "
                    f"{prof.interval_ms:g}ms (front-door loops + "
                    f"ingress executor + main loop)")
        if args[0] == "stop":
            if not prof.stop():
                return "loop profiler not running"
            return f"loop profiler stopped ({prof.samples} samples)"
        if args[0] == "dump":
            text = prof.collapsed()
            if len(args) > 1:
                with open(args[1], "w") as f:
                    f.write(text + "\n")
                return f"collapsed stacks written to {args[1]}"
            return text or "(no samples)"
        raise ValueError(f"bad subcommand: loops {args[0]}")

    def _profile(args):
        if not args:
            trc = getattr(getattr(ctl, "node", None), "tracing", None)
            loops = ("on" if trc is not None and trc.profiler.running
                     else "off")
            return (f"profiling: "
                    f"{'on -> ' + _active['dir'] if _active['dir'] else 'off'}"
                    f" | loops: {loops}")
        if args[0] == "loops":
            return _profile_loops(args[1:])
        if args[0] == "start":
            if _active["dir"] is not None:
                return f"already tracing to {_active['dir']}"
            logdir = args[1] if len(args) > 1 else os.path.join(
                tempfile.gettempdir(), "emqx_tpu_torch_trace")
            try:
                start_trace(logdir)
            except Exception as e:
                # an unwritable dir must not strand a half-started
                # trace: the registry stays clear and the operator
                # gets the reason as text
                _active["dir"] = _active["prof"] = None
                return f"profile start failed: {e}"
            return (f"tracing to {logdir} (a Chrome trace, "
                    f"chrome://tracing or Perfetto)")
        if args[0] == "stop":
            if _active["dir"] is None:
                return "not tracing"
            try:
                path = stop_trace(
                    getattr(getattr(ctl, "node", None), "tracing", None))
            except Exception as e:
                # the registry is already cleared, so the next `start`
                # works
                return f"profile stop failed: {e}"
            return f"trace written to {path}"
        raise ValueError(f"bad subcommand: {args[0]}")

    ctl.register_command(
        "profile", _profile,
        "start [dir] | stop | "
        "loops start|stop|show|dump [path]")
