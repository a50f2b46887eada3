"""ingress_wait_ms: the telemetry stage ``queue`` of the window's
device batches, per batch (the mean wait of a batch's messages from
IngressBatcher.submit to publish_begin)."""

from benchmark.metrics._port_stages import per_batch_ms


def read(run):
    return per_batch_ms(run, "queue")
