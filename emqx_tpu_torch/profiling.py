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
    smoke script and the router's rebuilds);
  - :data:`timer` — the process-wide timer the router records its
    ``automaton.rebuild`` durations into.

The JAX package's ``enable_compile_cache`` has no counterpart: the
port's kernels are compiled once into ``emqx_tpu_torch/_build/`` at
first use and loaded from there afterwards. The live node's ``profile``
command (``register_ctl``) comes with the operations tooling.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Dict


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace over the enclosed block (host ops,
    and the card's kernels when CUDA is available), written to
    ``<logdir>/trace.json`` in Chrome trace format."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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


#: process-wide timer the router feeds (spans recorded only where
#: instrumented)
timer = KernelTimer()
