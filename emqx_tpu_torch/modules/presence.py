"""Presence events: publishes connected/disconnected notifications to
``$SYS/brokers/<node>/clients/<clientid>/...``.

The port of the JAX package's ``PresenceModule`` (reference:
src/emqx_mod_presence.erl): the same JSON keys, published as system
messages (``flags={"sys": True}``) through ``broker.publish``.
"""

from __future__ import annotations

import json
import time

from emqx_tpu_torch.modules import Module
from emqx_tpu_torch.types import Message


class PresenceModule(Module):
    name = "presence"

    def __init__(self, node) -> None:
        super().__init__(node)
        self.qos = 0

    def load(self, env: dict) -> None:
        self.qos = env.get("qos", 0)
        self.node.hooks.add("client.connected", self.on_connected)
        self.node.hooks.add("client.disconnected", self.on_disconnected)

    def unload(self) -> None:
        self.node.hooks.delete("client.connected", self.on_connected)
        self.node.hooks.delete("client.disconnected", self.on_disconnected)

    def _pub(self, clientid: str, event: str, payload: dict) -> None:
        topic = (f"$SYS/brokers/{self.node.name}/clients/"
                 f"{clientid}/{event}")
        self.node.broker.publish(Message(
            topic=topic, qos=self.qos,
            payload=json.dumps(payload).encode(), flags={"sys": True}))

    def on_connected(self, clientinfo: dict, conninfo: dict):
        cid = clientinfo.get("clientid", "")
        self._pub(cid, "connected", {
            "clientid": cid,
            "username": clientinfo.get("username"),
            "ipaddress": clientinfo.get("peerhost"),
            "proto_ver": clientinfo.get("proto_ver"),
            "keepalive": clientinfo.get("keepalive"),
            "clean_start": clientinfo.get("clean_start"),
            "connected_at": conninfo.get("connected_at", time.time()),
            "ts": int(time.time() * 1000),
        })

    def on_disconnected(self, clientinfo: dict, reason):
        cid = clientinfo.get("clientid", "")
        self._pub(cid, "disconnected", {
            "clientid": cid,
            "username": clientinfo.get("username"),
            "reason": str(reason),
            "ts": int(time.time() * 1000),
        })
