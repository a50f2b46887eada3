"""dispatch_ms: the telemetry stage ``dispatch`` (the delivery tail) of
the window's batches, per batch."""

from benchmark.metrics._stages import per_batch_ms


def read(run):
    return per_batch_ms(run, ("dispatch",))
