"""Built-in modules — lightweight plugins with load/unload
(reference: src/emqx_modules.erl + emqx_gen_mod.erl behaviour)."""

from __future__ import annotations

import logging
from typing import Dict, Type

log = logging.getLogger("emqx_tpu_torch.modules")


class Module:
    """Behaviour: subclasses implement load/unload
    (emqx_gen_mod callbacks)."""

    name = "module"

    def __init__(self, node) -> None:
        self.node = node

    def load(self, env: dict) -> None:
        raise NotImplementedError

    def unload(self) -> None:
        raise NotImplementedError

    def on_loop_start(self) -> None:
        """Called by ``node.start()`` inside the running event loop.

        A module loaded before any loop exists starts its background
        tasks here, idempotently — ``load()`` may already have started
        them when it ran in an async context."""

    def on_loop_stop(self) -> None:
        """Called by ``node.stop()``: quiesce background tasks WITHOUT
        unloading (hooks stay registered; a later start() re-kicks
        on_loop_start)."""

    def _kick_on_loop(self) -> bool:
        """load() helper: start loop-bound work now if a loop is
        already running, else leave it for node.start()."""
        import asyncio

        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return False
        self.on_loop_start()
        return True


class ModuleRegistry:
    def __init__(self, node) -> None:
        self.node = node
        self._loaded: Dict[str, Module] = {}

    def load(self, cls: Type[Module], env: dict | None = None) -> Module:
        if cls.name in self._loaded:
            return self._loaded[cls.name]
        mod = cls(self.node)
        mod.load(env or {})
        self._loaded[cls.name] = mod
        return mod

    def unload(self, name: str) -> bool:
        mod = self._loaded.pop(name, None)
        if mod is None:
            return False
        mod.unload()
        return True

    def loaded(self):
        return list(self._loaded)

    def on_loop_start(self) -> None:
        """Kick every loaded module's loop-start hook, crash-isolated
        like hook callbacks (one broken module must not block the
        node's start)."""
        self._each("on_loop_start")

    def on_loop_stop(self) -> None:
        self._each("on_loop_stop")

    def _each(self, hook: str) -> None:
        for mod in list(self._loaded.values()):
            try:
                getattr(mod, hook)()
            except Exception:
                log.exception("module %s %s failed", mod.name, hook)
