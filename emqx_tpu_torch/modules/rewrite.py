"""Regex topic rewrite on publish, subscribe and unsubscribe.

The port of the JAX package's ``RewriteModule`` (reference:
src/emqx_mod_rewrite.erl — rules of {pub|sub|all, TopicFilter, Regex,
Dest} where $N backrefs feed the destination template). The
back-references are replaced in group order, ``$1`` before ``$10``,
as the JAX package does; ``$SYS/`` topics are never rewritten on
publish.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from emqx_tpu_torch import topic as T
from emqx_tpu_torch.modules import Module
from emqx_tpu_torch.types import Message

# rule: (pubsub, topic_filter, regex, dest_template)
Rule = Tuple[str, str, str, str]


class RewriteModule(Module):
    name = "rewrite"

    def __init__(self, node) -> None:
        super().__init__(node)
        self._pub_rules: List[Tuple[str, re.Pattern, str]] = []
        self._sub_rules: List[Tuple[str, re.Pattern, str]] = []

    def load(self, env: dict) -> None:
        for pubsub, flt, regex, dest in env.get("rules", []):
            compiled = (flt, re.compile(regex), dest)
            if pubsub in ("pub", "all"):
                self._pub_rules.append(compiled)
            if pubsub in ("sub", "all"):
                self._sub_rules.append(compiled)
        self.node.hooks.add("message.publish", self.on_publish,
                            priority=90)
        self.node.hooks.add("client.subscribe", self.on_subscribe,
                            priority=90)
        self.node.hooks.add("client.unsubscribe", self.on_unsubscribe,
                            priority=90)

    def unload(self) -> None:
        self.node.hooks.delete("message.publish", self.on_publish)
        self.node.hooks.delete("client.subscribe", self.on_subscribe)
        self.node.hooks.delete("client.unsubscribe", self.on_unsubscribe)

    @staticmethod
    def _rewrite(rules, topic: str) -> str:
        for flt, regex, dest in rules:
            if T.match(topic, flt):
                m = regex.match(topic)
                if m:
                    out = dest
                    for i, g in enumerate(m.groups(), 1):
                        out = out.replace(f"${i}", g or "")
                    topic = out
        return topic

    def on_publish(self, msg: Message):
        if msg.topic.startswith("$SYS/"):
            return None
        new = self._rewrite(self._pub_rules, msg.topic)
        if new != msg.topic:
            msg.topic = new
        return msg

    def on_subscribe(self, clientinfo, props, topic_filters):
        return [(self._rewrite(self._sub_rules, f), opts)
                for f, opts in topic_filters]

    def on_unsubscribe(self, clientinfo, props, topic_filters):
        return [self._rewrite(self._sub_rules, f) for f in topic_filters]
