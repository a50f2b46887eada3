"""walk_roofline_pct: kernel B1's share of its roofline over the window.

The least bytes of every topic the walk took in the window (the match
cache's misses, recorded at ``MatchCache.probe``), counted from the topic and the reference's answer
(``roofline.walk_bytes``), over the peak memory rate, divided by the
summed device time of the ``walk_kernel`` launches in the trace."""

from benchmark import roofline, trace


def read(run):
    dev = trace.kernel_seconds(run.trace, "walk_kernel")
    if dev <= 0:
        return None
    topics = run.walked
    match = run.reference.matcher.match
    levels = int(run.cfg.get("max_levels", 16))
    n = sum(roofline.walk_bytes(t, match(t), levels) for t in topics)
    return roofline.roofline_pct(n, dev)
