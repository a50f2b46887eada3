"""ack_ms: the telemetry stage ``ack`` of the window's batches, per batch
(the last delivery chunk to the batch's acknowledgement futures set)."""

from benchmark.metrics._port_stages import per_batch_ms


def read(run):
    return per_batch_ms(run, "ack")
