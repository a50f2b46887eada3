"""fetch_cpu_pct: the fetch executor thread's CPU time over its wall
time in the window's fetches (telemetry stage ``fetch_cpu`` over
``fetch`` + ``dispatch_plan`` + ``serialize``), in percent: under 100
by the waits for the interpreter lock and the device."""

from benchmark.metrics._port_stages import cpu_pct


def read(run):
    return cpu_pct(run, "fetch_cpu", ("fetch", "dispatch_plan",
                                      "serialize"))
