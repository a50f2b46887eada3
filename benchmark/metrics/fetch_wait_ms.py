"""fetch_wait_ms: the telemetry stage ``fetch_wait`` of the window's
device batches, per batch (publish_begin's return to publish_fetch's entry:
the fetch executor's queue and the interpreter lock)."""

from benchmark.metrics._port_stages import per_batch_ms


def read(run):
    return per_batch_ms(run, "fetch_wait")
