"""host_fallback_pct: unique topics of the window's device batches whose
device match overflowed to the host, in percent (the spans' tags
``fallbacks`` over ``n_uniq``)."""


def read(run):
    spans = [s for s in run.spans if s["path"] == "device"]
    n = sum(s["n_uniq"] for s in spans)
    if n <= 0:
        return None
    return 100.0 * sum(s["fallbacks"] for s in spans) / n
