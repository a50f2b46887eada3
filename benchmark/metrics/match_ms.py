"""match_ms: the telemetry stages ``match``, ``cache_gather`` and
``pack`` of the window's batches, per batch."""

from benchmark.metrics._stages import per_batch_ms


def read(run):
    return per_batch_ms(run, ("match", "cache_gather", "pack"))
