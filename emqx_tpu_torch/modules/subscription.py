"""Auto-subscribe on connect with %c/%u templated topics.

The port of the JAX package's ``SubscriptionModule`` (reference:
src/emqx_mod_subscription.erl). As in the JAX package, the
subscriptions go through ``session.subscribe``, not the channel's
SUBSCRIBE path: no 'session.subscribed' hook fires and no retained
message is replayed for them.
"""

from __future__ import annotations

import logging

from emqx_tpu_torch.modules import Module
from emqx_tpu_torch.mountpoint import replvar
from emqx_tpu_torch.session import SessionError
from emqx_tpu_torch.topic import TopicError
from emqx_tpu_torch.types import SubOpts

log = logging.getLogger("emqx_tpu_torch.modules.subscription")


class SubscriptionModule(Module):
    name = "subscription"

    def __init__(self, node) -> None:
        super().__init__(node)
        self._topics = []  # [(template, qos)]

    def load(self, env: dict) -> None:
        self._topics = list(env.get("topics", []))
        self.node.hooks.add("client.connected", self.on_connected)

    def unload(self) -> None:
        self.node.hooks.delete("client.connected", self.on_connected)

    def on_connected(self, clientinfo: dict, conninfo: dict):
        cid = clientinfo.get("clientid", "")
        chan = self.node.cm.lookup_channel(cid)
        if chan is None or chan.session is None:
            return
        for template, qos in self._topics:
            flt = replvar(template, cid, clientinfo.get("username"))
            try:
                chan.session.subscribe(flt, SubOpts(qos=qos))
            except (SessionError, TopicError) as e:
                # a bad template or a full session skips this topic,
                # as in the JAX package; the others still subscribe
                log.warning("auto-subscribe %r for %s refused: %s",
                            flt, cid, e)
