"""fetch_plan_ms: the telemetry stages ``fetch`` and ``dispatch_plan`` of
the window's batches, per batch."""

from benchmark.metrics._stages import per_batch_ms


def read(run):
    return per_batch_ms(run, ("fetch", "dispatch_plan"))
