"""``$delayed/<secs>/<topic>`` delayed publish.

The port of the JAX package's ``DelayedModule`` (reference:
src/emqx_mod_delayed.erl — intercepts 'message.publish', stores,
republishes after the delay). :meth:`DelayedModule.tick` republishes
each due message through ``broker.publish``: one device batch a
message, as the JAX package does.
"""

from __future__ import annotations

import asyncio
import heapq
import time
from typing import List, Optional, Tuple

from emqx_tpu_torch.hooks import STOP
from emqx_tpu_torch.modules import Module
from emqx_tpu_torch.types import Message

PREFIX = "$delayed/"
MAX_DELAY = 4294967  # seconds (reference caps at 0xFFFFFFFF ms)


class DelayedModule(Module):
    name = "delayed"

    def __init__(self, node) -> None:
        super().__init__(node)
        self._heap: List[Tuple[float, int, Message]] = []
        self._seq = 0
        self._task: Optional[asyncio.Task] = None

    def load(self, env: dict) -> None:
        self.node.broker.delayed = self
        self.node.hooks.add("message.publish", self.on_publish,
                            priority=100)
        # no loop yet: node.start() kicks on_loop_start; a caller
        # without a loop ticks by hand
        self._kick_on_loop()

    def on_loop_start(self) -> None:
        if self._task is None or self._task.done():
            loop = asyncio.get_running_loop()
            self._task = loop.create_task(self._timer_loop())

    def on_loop_stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    def unload(self) -> None:
        if getattr(self.node.broker, 'delayed', None) is self:
            self.node.broker.delayed = None
        self.node.hooks.delete("message.publish", self.on_publish)
        self.on_loop_stop()

    # -- hook -------------------------------------------------------------

    def on_publish(self, msg: Message):
        if not msg.topic.startswith(PREFIX):
            return None
        rest = msg.topic[len(PREFIX):]
        if "/" not in rest:
            return None
        secs_s, real_topic = rest.split("/", 1)
        try:
            secs = min(int(secs_s), MAX_DELAY)
        except ValueError:
            return None
        self.delay(msg, secs, real_topic)
        # veto the immediate publish
        msg.set_header("allow_publish", False)
        if self.node.broker is not None:
            self.node.broker.metrics.inc("messages.delayed")
        return (STOP, msg)

    def delay(self, msg: Message, secs: float,
              real_topic: Optional[str] = None) -> None:
        m = msg.copy()
        if real_topic is not None:
            m.topic = real_topic
        m.headers.pop("allow_publish", None)
        self._seq += 1
        heapq.heappush(self._heap, (time.time() + secs, self._seq, m))

    # -- delivery ---------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> int:
        now = time.time() if now is None else now
        n = 0
        while self._heap and self._heap[0][0] <= now:
            _, _, msg = heapq.heappop(self._heap)
            self.node.broker.publish(msg)
            n += 1
        return n

    async def _timer_loop(self) -> None:
        while True:
            await asyncio.sleep(0.5)
            self.tick()

    def __len__(self) -> int:
        return len(self._heap)
