"""Window totals of the publish spans' stages over their batch count."""


def per_batch_ms(run, stages):
    n = run.delta("telemetry.spans")
    if n <= 0:
        return None
    return sum(run.delta(f"telemetry.{s}.sum_ms") for s in stages) / n
