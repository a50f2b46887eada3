"""Host-side topic tokenization: words → dense int32 word ids.

The reference walks the trie with binary words as ETS keys
(src/emqx_trie.erl:166-178); a TPU automaton needs fixed-dtype integer
word ids. We *intern* words into a dense vocabulary (exact, no hash
collisions — parity-safe): every word that appears in any subscription
filter gets an id; publish-topic words never seen in a filter map to
``UNKNOWN`` and can only be matched by ``+``/``#`` edges, which is
exactly the reference's "no literal edge exists" case.

Special ids (negative, never collide with vocab ids):
  - ``UNKNOWN`` (-1): word not in any filter
  - ``PAD``     (-2): padding beyond the topic's word count

Wildcard words ``+``/``#`` are interned like ordinary vocab words when
they appear in *filters* (they index edge tables, not publish words).
A publish *name* containing "+"/"#" is not valid MQTT but would simply
intern/list as literal words here, matching emqx_topic:match/2 which
treats them as literals on the name side.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

UNKNOWN = -1
PAD = -2


class WordTable:
    """Interning table: word str ↔ dense int id. Append-only."""

    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}
        self._words: List[str] = []

    def __len__(self) -> int:
        return len(self._words)

    def words(self):
        """All interned words in id order (checkpoint export)."""
        return list(self._words)

    def intern(self, word: str) -> int:
        wid = self._ids.get(word)
        if wid is None:
            wid = len(self._words)
            self._ids[word] = wid
            self._words.append(word)
        return wid

    def lookup(self, word: str) -> int:
        """Id for a publish-topic word; UNKNOWN if never interned."""
        return self._ids.get(word, UNKNOWN)

    def word(self, wid: int) -> str:
        return self._words[wid]

    def encode_filter(self, ws: Sequence[str]) -> List[int]:
        return [self.intern(w) for w in ws]

    def encode_topic(self, ws: Sequence[str]) -> List[int]:
        return [self.lookup(w) for w in ws]


def encode_batch(
    table: WordTable, topics: Sequence[str], max_levels: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Encode publish topics into fixed-shape arrays.

    Returns ``(word_ids[B, L], n_words[B], sys_mask[B])`` where
    ``sys_mask`` marks topics whose first word starts with ``$`` (these
    skip root wildcards, emqx_trie.erl:162-163). Topics with more than
    ``max_levels`` levels are marked with ``n_words = -1`` — the caller
    must route them to the host oracle (static-shape overflow fallback).
    """
    B = len(topics)
    ids = np.full((B, max_levels), PAD, dtype=np.int32)
    n_words = np.zeros((B,), dtype=np.int32)
    sys_mask = np.zeros((B,), dtype=bool)
    for i, t in enumerate(topics):
        ws = t.split("/")
        if len(ws) > max_levels:
            n_words[i] = -1
            continue
        n_words[i] = len(ws)
        sys_mask[i] = ws[0].startswith("$")
        for j, w in enumerate(ws):
            ids[i, j] = table.lookup(w)
    return ids, n_words, sys_mask
