"""Window totals of the port's own publish stages (``telemetry.py``'s
``PORT_STAGES``), read only where the program has them: on a program
without a stage's histogram the reader gives nothing."""


def present(run, stages) -> bool:
    return all(f"telemetry.{s}.sum_ms" in run.after for s in stages)


def sum_ms(run, stage: str) -> float:
    return run.delta(f"telemetry.{stage}.sum_ms")


def per_batch_ms(run, stage: str):
    """``stage``'s milliseconds a batch over the window's device
    batches of the ingress batcher, which stamp these stages once each
    (a span count would also hold the node's own direct publishes, such
    as the ``$SYS`` heartbeat's, which have no batcher stages)."""
    n = run.delta("ingress.device_batches")
    if n <= 0 or not present(run, (stage,)):
        return None
    return sum_ms(run, stage) / n


def cpu_pct(run, cpu: str, walls):
    """Thread CPU time of ``cpu`` over the wall time of ``walls``, in
    percent."""
    if not present(run, (cpu,) + tuple(walls)):
        return None
    wall = sum(sum_ms(run, s) for s in walls)
    if wall <= 0:
        return None
    return 100.0 * sum_ms(run, cpu) / wall
