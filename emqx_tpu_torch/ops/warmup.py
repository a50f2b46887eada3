"""Kernel re-warm planning for device-loss recovery.

After :meth:`Router.rebuild_device_state` publishes fresh tables, the
batch shapes live traffic uses run once OFF the hot path, so the first
publish batch after recovery does not pay the cold start: the match
cache's cold start and the fan-out manager's table rebuild at the new
epoch. CUDA has no compile to pay, but those costs move to the
recovery thread all the same.

This module is pure host planning; the device work happens in
``Broker.warm_device_path``, which drives the real
``_begin_device``/``_fetch_device`` seams over the batches planned
here: encode → walk (kernel B1) → pack → fan-out expand → bitmap OR
(kernel B2) → bundle → fetch.

Synthetic warm topics are rooted at ``"\\x00devloss"``: no real
filter matches them (MQTT topics cannot contain NUL), so a warm batch
delivers nothing, and their match-cache entries are ordinary slots
that age out.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

#: bound on warm batches per recovery: the floor bucket plus the
#: largest observed live buckets
MAX_WARM_BUCKETS = 4


def warm_buckets(observed: Iterable[int], min_batch: int,
                 cap: int = MAX_WARM_BUCKETS) -> List[int]:
    """The padded-batch buckets worth warming: the configured floor
    bucket (every small batch lands there) plus the largest buckets
    live traffic was seen using (``Broker._pack_budgets`` keys — the
    budget table is learned per bucket, so its key set IS the
    observed shape set)."""
    buckets = sorted({int(b) for b in observed if int(b) > 0}
                     | {int(min_batch)})
    return buckets[-max(1, cap):]


def warm_topics(bucket: int, min_batch: int,
                levels: int = 4) -> List[str]:
    """A unique-topic list whose padded dispatch lands exactly in
    ``bucket``: the dispatch pads to the smallest power-of-two bucket
    ≥ the topic count (floored at ``min_batch``), so ``bucket//2 + 1``
    topics select ``bucket`` for any bucket above the floor.

    ``levels`` pins the batch's level-bucket shape: the walk slices
    its level axis to the batch's deepest topic (``depth_bucket``), so
    the FIRST topic carries exactly ``levels`` levels — one deep spine
    selects the shape, the rest stay short."""
    n = 1 if bucket <= min_batch else bucket // 2 + 1
    out = ["\x00devloss/warm/%d/%d" % (bucket, i) for i in range(n)]
    spine = ["\x00devloss", "warm", str(bucket), "0"][:max(2, levels)]
    spine += ["d"] * (max(2, levels) - len(spine))
    out[0] = "/".join(spine)
    return out


def warm_plan(observed: Iterable[int], min_batch: int,
              cap: int = MAX_WARM_BUCKETS,
              levels: Iterable[int] = ()
              ) -> List[Tuple[int, List[str]]]:
    """``(bucket, topics)`` warm batches, smallest bucket first.
    ``levels`` is the set of observed level-bucket shapes
    (``Router.observed_levels``): every bucket replays every depth.
    Empty = the 4-level shape only."""
    lvls = sorted({int(l) for l in levels if int(l) >= 2}) or [4]
    return [(b, warm_topics(b, min_batch, lv))
            for b in warm_buckets(observed, min_batch, cap)
            for lv in lvls]


def stamp_first_batch(record: Dict[str, object],
                      first_batch_ms: float) -> None:
    """Fold the first batch's latency after recovery into a record
    (one seam, so every reader names the same field)."""
    record["first_batch_p99_ms"] = round(float(first_batch_ms), 3)
