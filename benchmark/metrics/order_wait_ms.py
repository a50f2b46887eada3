"""order_wait_ms: the telemetry stage ``order_wait`` of the window's
device batches, per batch (publish_fetch's return to the first delivery
chunk: the predecessor's delivery and the loop's turn)."""

from benchmark.metrics._port_stages import per_batch_ms


def read(run):
    return per_batch_ms(run, "order_wait")
