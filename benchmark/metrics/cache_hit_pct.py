"""cache_hit_pct: the match cache's hits over its probes in the window,
in percent (``MatchCache`` counters)."""


def read(run):
    if "cache.hit" not in run.after:
        return None
    hit, miss = run.delta("cache.hit"), run.delta("cache.miss")
    if hit + miss <= 0:
        return None
    return 100.0 * hit / (hit + miss)
