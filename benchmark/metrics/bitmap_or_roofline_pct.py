"""bitmap_or_roofline_pct: kernel B2's share of its roofline over the
window.

For each device batch of the window, the least bytes of its bitmap OR
(``roofline.bitmap_or_bytes``: each distinct wide filter's row read
once, one union row written for each unique topic that matched a wide
filter, rows one bit a subscriber), over the peak memory rate, divided
by the summed device time of the ``bitmap_or_kernel`` launches in the
trace."""

from benchmark import roofline, trace
from benchmark.reference import Matcher


def read(run):
    dev = trace.kernel_seconds(run.trace, "bitmap_or_kernel")
    if dev <= 0:
        return None
    wide = Matcher(run.reference.wide_filters(
        int(run.cfg.get("fanout_threshold", 1024))))
    n = sum(roofline.bitmap_or_bytes([wide.match(t) for t in batch],
                                     run.n_subscribers)
            for batch in run.batches)
    return roofline.roofline_pct(n, dev)
