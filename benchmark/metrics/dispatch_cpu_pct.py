"""dispatch_cpu_pct: the event loop's CPU time over its wall time in
the window's delivery chunks (telemetry stage ``dispatch_cpu`` over
``dispatch``), in percent: under 100 by the waits for the interpreter
lock."""

from benchmark.metrics._port_stages import cpu_pct


def read(run):
    return cpu_pct(run, "dispatch_cpu", ("dispatch",))
