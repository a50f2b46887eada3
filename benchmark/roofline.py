"""Least bytes and peaks: the yardstick of the kernels' roofline shares.

A kernel's share of its roofline is the least time the chip could take
for the work, over the time the kernel took, in percent. The least time
is the larger of the bytes the work needs over the peak memory rate and
the operations it needs over the peak operation rate. Both kernels here
move a few bytes for each operation, so the bytes bound them.

The bytes are counted from the batch's inputs and the reference's
answer, never from the program's table layout: a later redesign of a
kernel cannot move the yardstick. Each input byte counts once and each
output byte once, whatever the kernel reads again.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

#: NVIDIA H100 SXM data sheet: HBM3 bytes/s
HBM_BYTES_PER_S = 3.35e12
#: NVIDIA H100 SXM data sheet: FP32 operations/s outside the tensor
#: cores; integer compares run on the same lanes at no more than this
VECTOR_OPS_PER_S = 67e12
#: a topic word and a matched filter id are 32-bit integers
ID_BYTES = 4
#: one edge lookup of the trie walk reads at least the 32-bit key it
#: compares (the word at that level under the parent state) and the
#: 32-bit child it takes: a hashed (state, word) -> child edge table
#: cannot answer with less
EDGE_BYTES = 8
#: a bitmap row holds one bit per subscriber id, in 32-bit words
WORD_BITS = 32


def walk_lookups(matched: Iterable[str]) -> int:
    """The edge lookups a walk must make to reach every matched filter:
    one for each distinct prefix of the matched filters' words (the
    filter's own last word included). A walk that follows only the
    paths that end in a match makes exactly these."""
    prefixes = set()
    for f in matched:
        ws = tuple(f.split("/"))
        for n in range(1, len(ws) + 1):
            prefixes.add(ws[:n])
    return len(prefixes)


def walk_bytes(topic: str, matched: Sequence[str], max_levels: int) -> int:
    """Least bytes kernel B1 moves for one topic: its words read once,
    one edge lookup for each prefix it must walk, each matched filter
    id written once."""
    n_words = min(len(topic.split("/")), max_levels)
    return (ID_BYTES * n_words + EDGE_BYTES * walk_lookups(matched)
            + ID_BYTES * len(set(matched)))


def bitmap_row_bytes(n_subscribers: int) -> int:
    """One bitmap row: a bit for each subscriber id."""
    return ID_BYTES * -(-n_subscribers // WORD_BITS)


def bitmap_or_bytes(wide_per_topic: Sequence[List[str]],
                    n_subscribers: int) -> int:
    """Least bytes kernel B2 moves for one batch: each distinct wide
    filter's row read once, one union row written for each unique topic
    that matched a wide filter."""
    rows_in = set()
    rows_out = 0
    for ws in wide_per_topic:
        if ws:
            rows_out += 1
            rows_in.update(ws)
    return (len(rows_in) + rows_out) * bitmap_row_bytes(n_subscribers)


def least_seconds(n_bytes: float, n_ops: float = 0.0) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / VECTOR_OPS_PER_S)


def roofline_pct(n_bytes: float, device_s: float, n_ops: float = 0.0):
    """The share in percent, or None when the kernel did not run."""
    if device_s <= 0:
        return None
    return 100.0 * least_seconds(n_bytes, n_ops) / device_s
