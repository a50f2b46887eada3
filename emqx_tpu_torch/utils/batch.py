"""Batch helpers of the publish path (copy of ``dedup_topics`` from
the JAX package's ``utils/batch.py``)."""

from __future__ import annotations


def dedup_topics(topics):
    """Collapse duplicate topics, first occurrence wins: returns
    ``(unique_topics, inverse_index)`` with
    ``unique_topics[inverse_index[i]] == topics[i]``. The publish
    path collapses hot topics to one device row per batch and expands
    results per message (broker.publish_begin)."""
    seen = {}
    uniq = []
    inv = []
    for t in topics:
        j = seen.get(t)
        if j is None:
            j = len(uniq)
            seen[t] = j
            uniq.append(t)
        inv.append(j)
    return uniq, inv
