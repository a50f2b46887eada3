"""Plugin system: discoverable extension packages with load/unload
and a persisted loaded-list (the port of the JAX package's
``plugins.py``).

Mirrors ``src/emqx_plugins.erl``: a reference plugin is an OTP app
carrying an ``-emqx_plugin`` attribute (:133); here a plugin is any
Python object/class exposing ``name``, ``load(node, env)`` and
``unload(node)`` — registered programmatically or discovered from a
module path string ("pkg.mod:PluginClass").

Per-plugin config (emqx_plugins.erl:51-59,180-191 renders each
plugin's own ``etc/<name>.conf`` into its app env before load): with
a ``config_dir`` set, ``load(name)`` reads ``<config_dir>/<name>.toml``
and passes it as the plugin's env, with any explicitly passed env
keys overriding the file's."""

from __future__ import annotations

import importlib
import json
import os
import tomllib
from typing import Dict, List, Optional


class Plugin:
    name = "plugin"

    def load(self, node, env: dict) -> None:
        raise NotImplementedError

    def unload(self, node) -> None:
        raise NotImplementedError


class Plugins:
    def __init__(self, node, state_file: Optional[str] = None,
                 config_dir: Optional[str] = None) -> None:
        self.node = node
        self.state_file = state_file
        self.config_dir = config_dir
        self._known: Dict[str, Plugin] = {}
        self._loaded: Dict[str, Plugin] = {}

    # -- discovery --------------------------------------------------------

    def register(self, plugin: Plugin) -> None:
        self._known[plugin.name] = plugin

    def discover(self, spec: str) -> Plugin:
        """'package.module:ClassName' → registered plugin instance."""
        mod_name, _, cls_name = spec.partition(":")
        mod = importlib.import_module(mod_name)
        plugin = getattr(mod, cls_name)() if cls_name else mod
        self.register(plugin)
        return plugin

    # -- lifecycle (emqx_plugins:load/unload/list) ------------------------

    def plugin_config(self, name: str) -> dict:
        """The plugin's own config file (``<config_dir>/<name>.toml``),
        or {} when absent."""
        if not self.config_dir:
            return {}
        path = os.path.join(self.config_dir, f"{name}.toml")
        if not os.path.exists(path):
            return {}
        with open(path, "rb") as f:
            return tomllib.load(f)

    def load(self, name: str, env: Optional[dict] = None) -> bool:
        if name in self._loaded:
            return False  # already_started
        plugin = self._known.get(name)
        if plugin is None:
            raise KeyError(f"plugin not found: {name}")
        merged = self.plugin_config(name)
        merged.update(env or {})
        plugin.load(self.node, merged)
        self._loaded[name] = plugin
        self._persist()
        return True

    def unload(self, name: str) -> bool:
        plugin = self._loaded.pop(name, None)
        if plugin is None:
            return False
        plugin.unload(self.node)
        self._persist()
        return True

    def load_all(self) -> None:
        for name in self._persisted():
            if name in self._known and name not in self._loaded:
                self.load(name)

    def list(self) -> List[dict]:
        return [{"name": n, "active": n in self._loaded}
                for n in self._known]

    # -- persistence (data/loaded_plugins analogue) -----------------------

    def _persist(self) -> None:
        if self.state_file:
            with open(self.state_file, "w") as f:
                json.dump(sorted(self._loaded), f)

    def _persisted(self) -> List[str]:
        if self.state_file and os.path.exists(self.state_file):
            with open(self.state_file) as f:
                return json.load(f)
        return []
