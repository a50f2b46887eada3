"""Deployments and traffic, made from ``--seed`` and the data files.

A deployment (``configs/<name>.json``) lists filter classes. Each class
is one of four kinds over a topic tree whose level ``lv`` has the words
``w<lv>_0 .. w<lv>_<vocab-1>``:

- ``plus``: ``depth`` words, one of them replaced by ``+`` at a uniform
  level (the shape of ``chip_smoke.py::make_workload``'s ``+`` rows);
- ``literal``: ``depth`` words;
- ``hash``: ``depth`` drawn in ``[depth_min, depth_max]``, then ``#``
  after the first ``1..depth`` words (``bench.py::build_filters`` with
  ``mix="hash"``; ``depth_min = depth_max = 4`` is ``make_workload``'s
  ``#`` rows);
- ``wide``: ``w0_0/.../w<L-2>_0/big<j>``, the filters that many clients
  share (``make_workload``'s big filters).

The filters of a class are distinct, in the order of their first draw.
Each filter gets ``members`` subscribers: new ones, or, with
``members_from``, drawn without replacement from the subscribers of
another class. With ``share`` each subscription is
``$share/<share>/<filter>``.

The drawable list puts the drawable classes' filters in one order: the
class at each rank is fixed for every seed, the filter of that class at
that rank is the seed's. A traffic mix (``traffic/<name>.json``) draws
filters from it, by Zipf rank or uniformly, and fills each wildcard with
uniform words (``chip_smoke.py::zipf_topics``): ``+`` with one word of
its level, ``#`` with 0 up to ``topic_levels - prefix`` further words.
Topic ``i`` of a run depends on the seed and on ``i`` alone, in chunks
of :data:`CHUNK`.

Filters and topics are made in bulk: a row of token codes per string
(:class:`Tokens`), the wildcards filled on whole arrays, and the strings
joined from the rows' bytes in blocks.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

#: topics a chunk of the topic stream holds
CHUNK = 4096
#: chunks the topic stream makes in one bulk call
_BLOCK_CHUNKS = 16

#: the seed streams each derived generator takes
_FILTERS, _TOPICS, _SAMPLE = 1, 2, 3
#: the seed of the classes' layout over the Zipf ranks, the same for
#: every run
_LAYOUT = 0

#: the code of an empty place in a row
PAD = -1


def load(path) -> dict:
    with open(path) as f:
        return json.load(f)


def word(level: int, i: int) -> str:
    return f"w{level}_{i}"


class Tokens:
    """The token codes of a tree of ``levels + 1`` levels: word ``i`` of
    level ``lv`` is ``lv * vocab + i``, then ``+``, ``#`` and the extra
    words (the wide filters' last words)."""

    def __init__(self, levels: int, vocab: int, extra=()) -> None:
        self.levels = levels
        self.vocab = vocab
        n = (levels + 1) * vocab
        self.PLUS = n
        self.HASH = n + 1
        self.EXTRA = n + 2
        words = [word(lv, i) for lv in range(levels + 1)
                 for i in range(vocab)] + ["+", "#"] + list(extra)
        enc = [w.encode("ascii") + b"/" for w in words]
        self.tlen = np.array([len(e) for e in enc], dtype=np.int64)
        # each token's bytes in a slot of the longest token's width
        slot = int(self.tlen.max())
        self.tbytes = np.frombuffer(
            b"".join(e.ljust(slot, b"\0") for e in enc),
            dtype=np.uint8).reshape(len(enc), slot)
        self._lanes = np.arange(slot)

    def strings(self, rows: np.ndarray, block: int = 1 << 15) -> List[str]:
        """Each row's tokens joined by ``/``. A row holds its codes
        first and :data:`PAD` after them, and at least one code."""
        out: List[str] = []
        for b in range(0, len(rows), block):
            r = rows[b:b + block].astype(np.int64)
            valid = r >= 0
            flat = r[valid]
            buf = self.tbytes[flat][self._lanes < self.tlen[flat][:, None]]
            # every token carries a trailing '/': a row's last becomes
            # the row's end
            row_len = np.where(valid, self.tlen[np.maximum(r, 0)], 0).sum(1)
            buf[np.cumsum(row_len) - 1] = ord("\n")
            got = buf.tobytes().decode("ascii").split("\n")
            got.pop()
            out += got
        return out


class Deployment:
    """The subscriptions of one configuration at one seed.

    Subscription ``k`` is subscriber ``sids[k]`` on ``subs[k]``, in
    subscribe order; ``members[c]`` holds class ``c``'s subscriber ids,
    a row for each filter; ``draw_rows`` the drawable filters' codes in
    rank order; ``n_subscribers`` counts the distinct subscriber ids."""

    def __init__(self, cfg: dict, seed: int) -> None:
        self.levels = int(cfg["topic_levels"])
        self.vocab = int(cfg["vocab"])
        n_wide = sum(int(s["count"]) for s in cfg["classes"]
                     if s["kind"] == "wide")
        self.tokens = Tokens(self.levels, self.vocab,
                             [f"big{j}" for j in range(n_wide)])
        rng = np.random.default_rng([seed, _FILTERS])
        self.rows: Dict[str, np.ndarray] = {}
        self.classes: Dict[str, List[str]] = {}
        self.members: Dict[str, np.ndarray] = {}
        sids: List[np.ndarray] = []
        self.subs: List[str] = []
        next_sid = 0
        next_wide = 0
        for spec in cfg["classes"]:
            rows = make_rows(rng, spec, self.levels, self.vocab,
                             self.tokens, next_wide)
            if spec["kind"] == "wide":
                next_wide += len(rows)
            flts = self.tokens.strings(rows)
            n, k = len(flts), int(spec.get("members", 1))
            src = spec.get("members_from")
            if src is None:
                mem = np.arange(next_sid, next_sid + n * k,
                                dtype=np.int64).reshape(n, k)
                next_sid += n * k
            else:
                pool = self.members[src][:, 0]
                mem = np.stack([pool[rng.choice(len(pool), size=k,
                                                replace=False)]
                                for _ in range(n)]).reshape(n, k)
            share = spec.get("share")
            if share is not None:
                flts_sub = [f"$share/{share}/{f}" for f in flts]
            else:
                flts_sub = flts
            self.rows[spec["name"]] = rows
            self.classes[spec["name"]] = flts
            self.members[spec["name"]] = mem
            sids.append(mem.ravel())
            self.subs += flts_sub if k == 1 else \
                [f for f in flts_sub for _ in range(k)]
        self.sids = np.concatenate(sids)
        self.n_subscribers = next_sid
        # which class sits at each rank is the same for every seed (a
        # fixed layout); which filter of the class sits there is the
        # seed's: every seed draws the same mix of filter kinds, in
        # another order
        names = cfg["draw"]
        sizes = [len(self.rows[n]) for n in names]
        layout = np.random.default_rng(_LAYOUT).permutation(
            np.repeat(np.arange(len(names)), sizes))
        draw = np.empty((len(layout), self.levels + 1), dtype=np.int16)
        for c, name in enumerate(names):
            draw[layout == c] = self.rows[name][rng.permutation(sizes[c])]
        for ins in cfg.get("draw_insert", ()):
            at = min(int(ins["rank"]), len(draw))
            draw = np.insert(draw, at, self.rows[ins["class"]], axis=0)
        self.draw_rows = draw

    def subscriptions(self):
        """``(subscriber id, subscription string)`` in subscribe order."""
        return zip(self.sids.tolist(), self.subs)


def first_rows(rows: np.ndarray) -> np.ndarray:
    """The index of each distinct row's first occurrence, ascending.
    Rows of small codes pack into a few 62-bit keys; a stable sort by
    them puts each row's first occurrence first among its equals."""
    r = rows.astype(np.int64) + 1  # PAD packs as 0
    bits = max(1, int(r.max()).bit_length())
    per = max(1, 62 // bits)
    keys = []
    for c0 in range(0, r.shape[1], per):
        k = np.zeros(len(r), dtype=np.int64)
        for col in range(c0, min(c0 + per, r.shape[1])):
            k = (k << bits) | r[:, col]
        keys.append(k)
    order = np.lexsort(keys[::-1])
    new = np.ones(len(r), dtype=bool)
    for k in keys:
        ks = k[order]
        new[1:] &= ks[1:] == ks[:-1]
    new[1:] = ~new[1:]
    return np.sort(order[new])


def _distinct(draw, n: int) -> np.ndarray:
    """``n`` distinct rows of ``draw(count)``, in the order of their
    first draw. Each further draw is sized by the share of new rows the
    draws so far gave."""
    rows = draw(n + n // 4 + 64)
    while True:
        first = first_rows(rows)
        short = n - len(first)
        if short <= 0:
            return rows[first[:n]]
        share = max(len(first) / len(rows), 0.01)
        rows = np.concatenate([rows, draw(int(short / share * 1.25) + 64)])


def make_rows(rng, spec: dict, levels: int, vocab: int, tok: Tokens,
              first_extra: int = 0) -> np.ndarray:
    """The class's filters as rows of ``levels + 1`` codes."""
    kind = spec["kind"]
    n = int(spec["count"])
    width = levels + 1
    if kind == "wide":
        rows = np.full((n, width), PAD, dtype=np.int16)
        rows[:, :levels - 1] = np.arange(levels - 1) * vocab
        rows[:, levels - 1] = tok.EXTRA + first_extra + np.arange(n)
        return rows
    dmin = int(spec.get("depth_min", levels))
    dmax = int(spec.get("depth_max", levels))
    if not 1 <= dmin <= dmax <= levels:
        raise ValueError(f"class {spec['name']}: depth outside 1..{levels}")
    if kind not in ("plus", "hash", "literal"):
        raise ValueError(f"unknown filter kind {kind!r}")
    place = np.arange(width)

    def draw(c):
        r = rng.integers(0, vocab, size=(c, width)) + place * vocab
        depth = rng.integers(dmin, dmax + 1, size=c)
        at = np.arange(c)
        if kind == "plus":
            r[at, (rng.random(c) * depth).astype(np.int64)] = tok.PLUS
            cut = depth
        elif kind == "hash":
            # '#' after the first 1..depth words
            p = 1 + (rng.random(c) * depth).astype(np.int64)
            r[at, p] = tok.HASH
            cut = p + 1
        else:
            cut = depth
        r[place[None, :] >= cut[:, None]] = PAD
        return r.astype(np.int16)

    return _distinct(draw, n)


def fill_rows(rows: np.ndarray, fill: np.ndarray, extra: np.ndarray,
              tok: Tokens) -> np.ndarray:
    """Topics from filter rows: every ``+`` one word of its level (the
    word ``fill[:, level]``), a ``#`` at place ``p`` 0 up to
    ``levels - p`` further words (``extra`` in [0, 1) picks how many)."""
    r = rows.astype(np.int64)
    m, width = r.shape
    levels = tok.levels
    place = np.arange(width)
    words = np.full((m, width), PAD, dtype=np.int64)
    words[:, :levels] = place[:levels] * tok.vocab + fill[:, :levels]
    plus = r == tok.PLUS
    r[plus] = words[plus]
    hmask = r == tok.HASH
    has = hmask.any(1)
    p = hmask.argmax(1)
    e = (extra * (levels - p + 1)).astype(np.int64)
    lo, hi = p[:, None], (p + e)[:, None]
    inside = has[:, None] & (place >= lo) & (place < hi)
    r = np.where(inside, words, r)
    r[has[:, None] & (place >= hi)] = PAD
    return r


class TopicStream:
    """The run's topics: topic ``i`` is entry ``i % CHUNK`` of chunk
    ``i // CHUNK``, drawn with the generator ``(seed, 2, chunk)``."""

    def __init__(self, dep: Deployment, traffic: dict, seed: int) -> None:
        self.seed = seed
        self.levels = dep.levels
        self.vocab = dep.vocab
        self.tokens = dep.tokens
        self.draw_rows = dep.draw_rows
        law = traffic["draw"]
        n = len(self.draw_rows)
        if law == "zipf":
            a = float(traffic["zipf_a"])
            w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** a
            self._cdf = np.cumsum(w / w.sum())
            self._cdf[-1] = 1.0
        elif law == "uniform":
            self._cdf = None
        else:
            raise ValueError(f"unknown draw law {law!r}")
        self._chunks: Dict[int, List[str]] = {}
        #: chunks made on demand, after :meth:`prefill`
        self.late_chunks = 0

    def draw_indices(self, rng, n: int) -> np.ndarray:
        if self._cdf is None:
            return rng.integers(0, len(self.draw_rows), size=n)
        return np.searchsorted(self._cdf, rng.random(n), side="right")

    def _make(self, chunks) -> None:
        rows, fills, extras = [], [], []
        for c in chunks:
            rng = np.random.default_rng([self.seed, _TOPICS, c])
            rows.append(self.draw_rows[self.draw_indices(rng, CHUNK)])
            fills.append(rng.integers(0, self.vocab,
                                      size=(CHUNK, self.levels)))
            extras.append(rng.random(CHUNK))
        got = self.tokens.strings(fill_rows(
            np.concatenate(rows), np.concatenate(fills),
            np.concatenate(extras), self.tokens))
        for k, c in enumerate(chunks):
            self._chunks[c] = got[k * CHUNK:(k + 1) * CHUNK]

    def chunk(self, c: int) -> List[str]:
        got = self._chunks.get(c)
        if got is None:
            self.late_chunks += 1
            self._make([c])
            got = self._chunks[c]
        return got

    def topic(self, i: int) -> str:
        return self.chunk(i // CHUNK)[i % CHUNK]

    def prefill(self, n: int) -> None:
        """Make the first ``n`` topics in bulk."""
        todo = [c for c in range((n + CHUNK - 1) // CHUNK)
                if c not in self._chunks]
        for b in range(0, len(todo), _BLOCK_CHUNKS):
            self._make(todo[b:b + _BLOCK_CHUNKS])


def sample_rng(seed: int):
    """The generator the output check draws its sample with."""
    return np.random.default_rng([seed, _SAMPLE])
