"""File/rule-based ACL — the internal ACL backend.

The port of the JAX package's ``AclFileModule``; it mirrors ``src/emqx_mod_acl_internal.erl`` + ``src/emqx_access_rule.erl``
(etc/acl.conf): ordered rules of

    (allow|deny, who, access, topics)

who:    "all" | ("user", Name) | ("client", Id) | ("ipaddr", CIDR)
access: "subscribe" | "publish" | "pubsub"
topics: list of topic filters; ("eq", topic) pins a literal match
        (no wildcard expansion); %c/%u placeholders substitute the
        client's id/username.

First matching rule wins; no match falls through to the zone's
acl_nomatch default (handled by AccessControl).
"""

from __future__ import annotations

import ipaddress
from typing import List, Tuple, Union

from emqx_tpu_torch import topic as T
from emqx_tpu_torch.access_control import ALLOW, DENY
from emqx_tpu_torch.hooks import STOP
from emqx_tpu_torch.modules import Module
from emqx_tpu_torch.mountpoint import replvar

Who = Union[str, Tuple[str, str]]
TopicSpec = Union[str, Tuple[str, str]]


DEFAULT_RULES: List[tuple] = [
    # mirror etc/acl.conf defaults: dashboard user, localhost full
    # access, deny $SYS+eq(#) sub for others, allow rest
    ("allow", ("user", "dashboard"), "subscribe", ["$SYS/#"]),
    ("allow", ("ipaddr", "127.0.0.1"), "pubsub", ["$SYS/#", "#"]),
    ("deny", "all", "subscribe", ["$SYS/#", ("eq", "#")]),
    ("allow", "all", "pubsub", ["#"]),
]


def parse_acl_file(text: str) -> List[tuple]:
    """Parse the reference's ``etc/acl.conf`` format (a subset of
    Erlang terms — ``src/emqx_mod_acl_internal.erl`` consults the
    file the same way):

        {allow, {user, "dashboard"}, subscribe, ["$SYS/#"]}.
        {deny, all, subscribe, ["$SYS/#", {eq, "#"}]}.
        {allow, all}.

    ``%%`` comments out the rest of a line. Returns rule tuples in
    this module's native shape; a 2-tuple ``{allow|deny, all}``
    becomes a catch-all over every access and topic.
    """
    import re

    # strip %-comments (the reference's files use %%), keep strings
    lines = []
    for line in text.splitlines():
        out, i, in_str = [], 0, False
        while i < len(line):
            ch = line[i]
            if in_str and ch == "\\" and i + 1 < len(line):
                # escaped char inside a string (e.g. \") must not
                # toggle string tracking or start a comment
                out.append(ch)
                out.append(line[i + 1])
                i += 2
                continue
            if ch == '"':
                in_str = not in_str
            if ch == "%" and not in_str:
                break
            out.append(ch)
            i += 1
        lines.append("".join(out))
    src = "\n".join(lines)
    toks = re.findall(r'"(?:[^"\\]|\\.)*"|[{}\[\],.]|[A-Za-z0-9_/$#+%.-]+',
                      src)
    pos = 0

    def peek():
        return toks[pos] if pos < len(toks) else None

    def take(expect=None):
        nonlocal pos
        t = toks[pos]
        if expect is not None and t != expect:
            raise ValueError(f"acl.conf: expected {expect!r}, got {t!r}")
        pos += 1
        return t

    def term():
        t = peek()
        if t == "{":
            take()
            items = []
            while peek() != "}":
                items.append(term())
                if peek() == ",":
                    take()
            take("}")
            return tuple(items)
        if t == "[":
            take()
            items = []
            while peek() != "]":
                items.append(term())
                if peek() == ",":
                    take()
            take("]")
            return items
        t = take()
        if t.startswith('"'):
            return t[1:-1].replace('\\"', '"')
        return t

    rules: List[tuple] = []
    while pos < len(toks):
        r = term()
        take(".")
        if not isinstance(r, tuple) or r[0] not in ("allow", "deny"):
            raise ValueError(f"acl.conf: bad rule {r!r}")
        if len(r) == 2:
            # {allow|deny, all} catch-all: matches EVERY topic,
            # including $-prefixed ones '#' would exclude
            rules.append((r[0], r[1], "pubsub", None))
        elif len(r) == 4:
            rules.append((r[0], r[1], r[2], list(r[3])))
        else:
            raise ValueError(f"acl.conf: bad rule arity {r!r}")
    return rules


class AclFileModule(Module):
    name = "acl_internal"

    def __init__(self, node) -> None:
        super().__init__(node)
        self.rules: List[tuple] = []

    def load(self, env: dict) -> None:
        if "file" in env:
            with open(env["file"], "r", encoding="utf-8") as f:
                self.rules = parse_acl_file(f.read())
        else:
            self.rules = list(env.get("rules", DEFAULT_RULES))
        self.node.hooks.add("client.check_acl", self.check_acl,
                            priority=-10)

    def unload(self) -> None:
        self.node.hooks.delete("client.check_acl", self.check_acl)

    # -- rule evaluation (emqx_access_rule:match/3) -----------------------

    def check_acl(self, clientinfo: dict, pubsub: str, topic: str, acc):
        for rule in self.rules:
            verdict, who, access, topics = rule
            if not self._match_access(access, pubsub):
                continue
            if not self._match_who(who, clientinfo):
                continue
            if not self._match_topics(topics, topic, clientinfo):
                continue
            return (STOP, ALLOW if verdict == "allow" else DENY)
        return None  # fall through to default

    @staticmethod
    def _match_access(access: str, pubsub: str) -> bool:
        return access == "pubsub" or access == pubsub

    @staticmethod
    def _match_who(who: Who, clientinfo: dict) -> bool:
        if who == "all":
            return True
        kind, value = who
        if kind == "user":
            return clientinfo.get("username") == value
        if kind == "client":
            return clientinfo.get("clientid") == value
        if kind == "ipaddr":
            try:
                host = clientinfo.get("peerhost", "")
                return ipaddress.ip_address(host) in ipaddress.ip_network(
                    value, strict=False)
            except ValueError:
                return False
        return False

    @staticmethod
    def _match_topics(topics, topic: str,
                      clientinfo: dict) -> bool:
        if topics is None:
            # {allow|deny, all} catch-all: every topic, including
            # $-prefixed names that '#' would exclude
            return True

        for spec in topics:
            if isinstance(spec, tuple):  # ("eq", literal)
                if spec[1] == topic:
                    return True
                continue
            flt = replvar(spec, clientinfo.get("clientid", ""),
                          clientinfo.get("username"))
            if T.match(topic, flt):
                return True
        return False
