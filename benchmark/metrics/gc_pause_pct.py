"""gc_pause_pct: the window's full (generation 2) collections, the
telemetry stage ``gc`` (``monitors.SysMon``'s collector hook), in
percent of the window; nothing where the window's telemetry recorded
no span (it is off)."""

from benchmark.metrics._port_stages import present, sum_ms


def read(run):
    if run.window_s <= 0 or run.delta("telemetry.spans") <= 0 \
            or not present(run, ("gc",)):
        return None
    return 100.0 * sum_ms(run, "gc") / (run.window_s * 1000.0)
