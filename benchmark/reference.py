"""The plain reference: MQTT topic matching, fan-out and the output check.

Built from the subscription list the benchmark also hands to the broker
under test, and from nothing the broker made. It imports no part of the
program, no JAX and no JAX package: only the standard library.

Matching follows MQTT 3.1.1 section 4.7: ``+`` matches exactly one level
(an empty one too), ``#`` matches the rest of the topic including its
parent level, and a topic that starts with ``$`` is matched by no filter
whose first level is a wildcard. The index groups filters by their
*shape* (length, positions of ``+``, trailing ``#``); a topic is
matched by one dictionary lookup per shape, keyed by its words at the
shape's literal positions.

The delivery rules (the configurations state them): every subscriber of
a matched filter receives the message once per matched filter; a
``$share/<group>/<filter>`` group delivers it to exactly one member;
a QoS 1 acknowledgement resolves to the number of deliveries, after
all of them.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Tuple

SHARE = "$share/"


def split_share(sub: str) -> Tuple[str, str]:
    """``(group, inner filter)``; the group is ``""`` for a plain
    subscription."""
    if sub.startswith(SHARE):
        group, _, inner = sub[len(SHARE):].partition("/")
        return group, inner
    return "", sub


class Matcher:
    """Topic -> matching filters, for a fixed set of filters."""

    def __init__(self, filters: Iterable[str]) -> None:
        # shape -> {literal words -> [filters]}
        self.shapes: Dict[tuple, Dict[tuple, List[str]]] = {}
        seen = set()
        words: Dict[str, str] = {}  # one string object per distinct word
        for f in filters:
            if f in seen:
                continue
            seen.add(f)
            ws = [words.setdefault(w, w) for w in f.split("/")]
            tail = ws[-1] == "#"
            body = ws[:-1] if tail else ws
            plus = tuple(i for i, w in enumerate(body) if w == "+")
            key = tuple(w for w in body if w != "+")
            shape = (len(body), tail, plus)
            self.shapes.setdefault(shape, {}).setdefault(key, []).append(f)

    def match(self, topic: str) -> List[str]:
        ws = topic.split("/")
        n_words = len(ws)
        dollar = topic.startswith("$")
        out: List[str] = []
        for (n, tail, plus), table in self.shapes.items():
            if n > n_words or (not tail and n != n_words):
                continue
            if dollar and ((plus and plus[0] == 0) or (tail and n == 0)):
                continue
            if plus:
                key = tuple(ws[i] for i in range(n) if i not in plus)
            else:
                key = tuple(ws[:n])
            hit = table.get(key)
            if hit:
                out += hit
        return out


class Reference:
    """What every message must produce, from the subscription list
    ``[(subscriber id, subscription string)]``."""

    def __init__(self, subscriptions: Iterable[Tuple[int, str]]) -> None:
        self.plain: Dict[str, List[int]] = {}
        self.groups: Dict[str, Dict[str, List[int]]] = {}
        for sid, sub in subscriptions:
            group, inner = split_share(sub)
            if group:
                self.groups.setdefault(inner, {}).setdefault(
                    group, []).append(sid)
            else:
                self.plain.setdefault(inner, []).append(sid)
        self.matcher = Matcher(list(self.plain) + list(self.groups))

    def expect(self, topic: str):
        """``(plain deliveries as a Counter of subscriber ids, the member
        lists of the matched shared groups, matched filters)``."""
        need: Counter = Counter()
        groups: List[List[int]] = []
        matched = self.matcher.match(topic)
        for f in matched:
            sids = self.plain.get(f)
            if sids:
                need.update(sids)
            for members in self.groups.get(f, {}).values():
                groups.append(members)
        return need, groups, matched

    def wide_filters(self, threshold: int) -> List[str]:
        """The filters with more than ``threshold`` plain subscribers."""
        return [f for f, s in self.plain.items() if len(s) > threshold]


#: the numbers the check compares, each against the limit 0
CHECKS = ("lost", "extra", "share_wrong", "ack_wrong", "early_ack",
          "unacked")


def judge(ref: Reference, topics: Dict[int, str],
          acks: Dict[int, Tuple[int, int]],
          got: Dict[int, List[Tuple[int, int]]]) -> Dict[str, int]:
    """Hold the sampled messages to the reference; every check of
    :data:`CHECKS` but ``unacked``, which the caller counts over every
    message of the window.

    ``topics``: message index -> topic, for every sampled message;
    ``acks``: message index -> (delivery count the acknowledgement
    resolved to, position in the delivery log when it resolved), for
    those acknowledged; ``got``: message index -> [(subscriber id,
    position in the delivery log)] of its recorded deliveries."""
    out = dict.fromkeys(CHECKS, 0)
    del out["unacked"]
    for i, topic in topics.items():
        need, groups, _ = ref.expect(topic)
        dl = got.get(i, ())
        seen = Counter(s for s, _ in dl)
        left = Counter(seen)
        for s, c in need.items():
            have = left.get(s, 0)
            if have < c:
                out["lost"] += c - have
            left[s] = max(0, have - c)
        for members in groups:
            c = sum(left.get(s, 0) for s in members)
            if c != 1:
                out["share_wrong"] += 1
            # one delivery is the group's due; any further ones are extra
            for s in members:
                if left.get(s, 0) > 0:
                    left[s] -= 1
                    break
        out["extra"] += sum(v for v in left.values() if v > 0)
        ack = acks.get(i)
        if ack is None:
            continue  # counted over the whole window by the caller
        n, pos = ack
        if n != sum(need.values()) + len(groups):
            out["ack_wrong"] += 1
        if any(p >= pos for _, p in dl):
            out["early_ack"] += 1
    return out
