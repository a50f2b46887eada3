"""Host-side wildcard subscription trie — the parity oracle.

Re-implements the semantics of the reference Mnesia trie
(``src/emqx_trie.erl``: insert/1 82-93, match/1 97-99, delete/1
108-116, match_node/3 161-178, 'match_#'/2 181-186) as a plain Python
tree. It serves three roles:

1. the *parity oracle* the compiled TPU automaton is tested against
   (the trie SUITE cases are the reference's own oracle, SURVEY §4
   tier 2);
2. the authoritative host copy of the filter set, from which the CSR
   device tables are flattened (:mod:`emqx_tpu.ops.csr`);
3. the fallback matcher for topics that exceed the compiled kernel's
   static bounds (levels > L, active-set or match-buffer overflow).

Match semantics pinned here (and by tests/test_oracle.py):
  - a filter word matches an equal literal word; ``+`` matches exactly
    one word; ``#`` matches the remaining words *including zero* (so
    ``a/#`` matches ``a``);
  - topics whose first word starts with ``$`` only follow the literal
    edge at the root — filters starting with ``+`` or ``#`` never
    match them (emqx_trie.erl:162-163);
  - match returns the set of inserted *filters* (route keys), not
    subscribers.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from emqx_tpu_torch import topic as T


class _Node:
    __slots__ = ("children", "filter", "node_id")

    def __init__(self, node_id: int):
        self.children: Dict[str, "_Node"] = {}
        self.filter: Optional[str] = None  # set iff a filter terminates here
        self.node_id = node_id  # dense id used by the CSR flattener


class TrieOracle:
    """Mutable subscription trie with EMQX-parity wildcard matching."""

    def __init__(self) -> None:
        self._next_id = 0
        self.root = self._new_node()
        self._filters: Dict[str, int] = {}  # filter -> refcount

    def _new_node(self) -> _Node:
        n = _Node(self._next_id)
        self._next_id += 1
        return n

    # -- mutation ---------------------------------------------------------

    def insert(self, filter_: str) -> bool:
        """Insert a topic filter. Returns True if newly added.

        Re-inserting an existing filter bumps a refcount (the reference
        stores one trie entry per filter; route refcounts live in the
        router — we keep a count here so delete is symmetric).
        """
        if filter_ in self._filters:
            self._filters[filter_] += 1
            return False
        self._filters[filter_] = 1
        node = self.root
        for w in T.words(filter_):
            nxt = node.children.get(w)
            if nxt is None:
                nxt = self._new_node()
                node.children[w] = nxt
            node = nxt
        node.filter = filter_
        return True

    def delete(self, filter_: str) -> bool:
        """Delete a filter; prunes empty paths. True if fully removed."""
        cnt = self._filters.get(filter_)
        if cnt is None:
            return False
        if cnt > 1:
            self._filters[filter_] = cnt - 1
            return False
        del self._filters[filter_]
        path: List[tuple] = []  # (parent, word, child)
        node = self.root
        for w in T.words(filter_):
            child = node.children.get(w)
            if child is None:
                return False  # shouldn't happen if refcounts are right
            path.append((node, w, child))
            node = child
        node.filter = None
        # prune leaf-ward (emqx_trie.erl delete_path/1:189-204)
        for parent, w, child in reversed(path):
            if child.filter is None and not child.children:
                del parent.children[w]
            else:
                break
        return True

    def is_empty(self) -> bool:
        return not self.root.children

    def filters(self) -> List[str]:
        return list(self._filters.keys())

    def __contains__(self, filter_: str) -> bool:
        return filter_ in self._filters

    def __len__(self) -> int:
        return len(self._filters)

    # -- matching ---------------------------------------------------------

    def match(self, name: str) -> List[str]:
        """All inserted filters matching topic ``name``.

        Mirrors emqx_trie:match/1 + match_node/3: topics starting with a
        ``$``-word enter the trie via the literal edge only.
        """
        ws = T.words(name)
        acc: List[str] = []
        if ws and ws[0].startswith("$"):
            first = self.root.children.get(ws[0])
            if first is not None:
                self._match_node(first, ws, 1, acc)
        else:
            self._match_node(self.root, ws, 0, acc)
        return acc

    def _match_node(self, node: _Node, ws: List[str], i: int, acc: List[str]) -> None:
        # '#' child matches at every prefix depth, including the full
        # topic (zero remaining words) — emqx_trie.erl:181-186.
        h = node.children.get(T.HASH)
        if h is not None and h.filter is not None:
            acc.append(h.filter)
        if i == len(ws):
            if node.filter is not None:
                acc.append(node.filter)
            return
        # a '#' edge is always the collapsed terminal child, never a
        # walkable literal (validate forbids '#' inside filter words),
        # so a '#' word in a publish name must not descend into it
        lit = None if ws[i] == T.HASH else node.children.get(ws[i])
        if lit is not None:
            self._match_node(lit, ws, i + 1, acc)
        plus = node.children.get(T.PLUS)
        # skip the '+' branch when the topic word IS '+' — the literal
        # lookup already returned that child (a '+' in a publish name
        # is invalid MQTT anyway; the device kernel matches it once)
        if plus is not None and plus is not lit:
            self._match_node(plus, ws, i + 1, acc)
