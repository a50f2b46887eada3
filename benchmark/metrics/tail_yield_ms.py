"""tail_yield_ms: the telemetry stage ``tail_yield`` of the window's
device batches, per batch (the event loop's other work between a batch's
delivery chunks)."""

from benchmark.metrics._port_stages import per_batch_ms


def read(run):
    return per_batch_ms(run, "tail_yield")
