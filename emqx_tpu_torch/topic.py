"""Pure topic algebra: split/join, wildcard tests, filter matching,
validation, ``$share``/``$queue`` parsing, variable feeding.

Semantics mirror the reference ``src/emqx_topic.erl`` (agustinus/emqx):
  - ``words/1``      (emqx_topic.erl:157-164)  -> :func:`words`
  - ``match/2``      (emqx_topic.erl:64-87)    -> :func:`match`
  - ``wildcard/1``   (emqx_topic.erl:52-62)    -> :func:`wildcard`
  - ``validate/2``   (emqx_topic.erl:96-127)   -> :func:`validate`
  - ``parse/2``      (emqx_topic.erl:203-220)  -> :func:`parse`
  - ``feed_var/3``   (emqx_topic.erl:173-181)  -> :func:`feed_var`
  - ``join/prepend`` (emqx_topic.erl:129-141,183-196)
  - ``systop/1``     (emqx_topic.erl:167-171)  -> :func:`systop`

Topics are ``str``; words are plain strings where ``"+"`` / ``"#"`` are
the wildcard words and ``""`` is the empty level. This module is pure —
no device code — and doubles as the host-side reference for parity
tests of the compiled matcher.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

MAX_TOPIC_LEN = 4096

PLUS = "+"
HASH = "#"
EMPTY = ""

SHARE_PREFIX = "$share/"
QUEUE_PREFIX = "$queue/"


class TopicError(ValueError):
    """Raised for invalid topic names/filters (reference: error/1 throws)."""


def tokens(topic: str) -> List[str]:
    """Split a topic into its ``/``-separated tokens."""
    return topic.split("/")


# Words and tokens coincide in the str representation; `words` is kept
# as the semantic name used throughout (reference keeps both too).
words = tokens


def levels(topic: str) -> int:
    return len(tokens(topic))


def wildcard(topic) -> bool:
    """True if the topic filter contains ``+`` or ``#`` words."""
    ws = words(topic) if isinstance(topic, str) else topic
    return any(w == PLUS or w == HASH for w in ws)


def match(name, filter_) -> bool:
    """Match a concrete topic *name* against a topic *filter*.

    ``$``-prefixed names never match filters that start with a wildcard
    (MQTT spec; reference emqx_topic.erl:67-70).
    """
    if isinstance(name, str) and isinstance(filter_, str):
        if name.startswith("$") and (filter_.startswith(PLUS) or filter_.startswith(HASH)):
            return False
        return _match_words(words(name), words(filter_))
    return _match_words(list(name), list(filter_))


def _match_words(n: List[str], f: List[str]) -> bool:
    i = 0
    while True:
        if i == len(f):
            return i == len(n)
        fw = f[i]
        if fw == HASH:
            return True
        if i == len(n):
            return False
        if fw != PLUS and fw != n[i]:
            return False
        i += 1


def validate(topic: str, kind: str = "filter") -> bool:
    """Validate a topic name (``kind="name"``) or filter (``"filter"``).

    Raises :class:`TopicError` on invalid input, returns True otherwise
    (reference emqx_topic.erl:96-127 raises ``error/1``).
    """
    if kind not in ("name", "filter"):
        raise ValueError(f"bad validate kind: {kind}")
    if topic == "":
        raise TopicError("empty_topic")
    if len(topic.encode("utf-8")) > MAX_TOPIC_LEN:
        raise TopicError("topic_too_long")
    ws = words(topic)
    if kind == "name" and wildcard(ws):
        raise TopicError("topic_name_error")
    for i, w in enumerate(ws):
        if w == HASH:
            # '#' must be the last word (emqx_topic.erl:113-116)
            if i != len(ws) - 1:
                raise TopicError("topic_invalid_#")
        elif w not in (PLUS, EMPTY):
            if any(c in ("#", "+", "\x00") for c in w):
                raise TopicError("topic_invalid_char")
    return True


def join(ws: List[str]) -> str:
    return "/".join(ws)


def prepend(parent: Optional[str], topic: str) -> str:
    """Prefix a topic, guaranteeing a single ``/`` separator."""
    if parent is None or parent == "":
        return topic
    if parent.endswith("/"):
        return parent + topic
    return parent + "/" + topic


def feed_var(var: str, val: str, topic: str) -> str:
    """Replace whole-word occurrences of ``var`` (e.g. ``%c``) with ``val``."""
    return join([val if w == var else w for w in words(topic)])


def systop(name: str, node: str = "emqx_tpu@127.0.0.1") -> str:
    """``$SYS`` topic for this node (reference emqx_topic.erl:167-171)."""
    return f"$SYS/brokers/{node}/{name}"


def parse(topic_filter: str, options: Optional[dict] = None) -> Tuple[str, dict]:
    """Parse ``$share/<group>/<filter>`` / ``$queue/<filter>`` prefixes.

    Returns ``(filter, options)`` where options may gain a ``"share"``
    key. Mirrors emqx_topic.erl:203-220 including its error cases.
    """
    options = dict(options or {})
    if topic_filter.startswith((QUEUE_PREFIX, SHARE_PREFIX)) and "share" in options:
        raise TopicError(f"invalid_topic_filter: {topic_filter}")
    if topic_filter.startswith(QUEUE_PREFIX):
        rest = topic_filter[len(QUEUE_PREFIX):]
        options["share"] = "$queue"
        return parse(rest, options)
    if topic_filter.startswith(SHARE_PREFIX):
        rest = topic_filter[len(SHARE_PREFIX):]
        if "/" not in rest:
            raise TopicError(f"invalid_topic_filter: {topic_filter}")
        group, flt = rest.split("/", 1)
        if "+" in group or "#" in group:
            raise TopicError(f"invalid_topic_filter: {topic_filter}")
        options["share"] = group
        return parse(flt, options)
    return topic_filter, options
