"""Priority-ordered hook chains — the extension seam of the broker.

Mirrors ``src/emqx_hooks.erl``: callbacks registered per hookpoint
with a priority (higher runs first, equal priority keeps registration
order, emqx_hooks.erl:119-178); ``run`` chains until a callback
returns STOP; ``run_fold`` threads an accumulator. Callbacks are
crash-isolated (safe_execute, emqx_hooks.erl:163-170): an exception
logs and the chain continues.

Hookpoint names follow the reference ('client.connected',
'message.publish', 'session.subscribed', ...).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

log = logging.getLogger("emqx_tpu_torch.hooks")

OK = "ok"
STOP = "stop"


class Callback(NamedTuple):
    action: Callable
    filter: Optional[Callable]
    priority: int
    seq: int


class Hooks:
    def __init__(self) -> None:
        self._chains: Dict[str, List[Callback]] = {}
        self._seq = 0

    def add(self, name: str, action: Callable, priority: int = 0,
            filter_: Optional[Callable] = None) -> None:
        self._seq += 1
        cb = Callback(action, filter_, priority, self._seq)
        chain = self._chains.setdefault(name, [])
        if any(c.action == action for c in chain):
            return  # already_exists (reference returns an error tuple)
        chain.append(cb)
        # higher priority first; stable on insertion order
        chain.sort(key=lambda c: (-c.priority, c.seq))

    def delete(self, name: str, action: Callable) -> None:
        chain = self._chains.get(name)
        if chain:
            self._chains[name] = [c for c in chain if c.action != action]

    def lookup(self, name: str) -> List[Callback]:
        return list(self._chains.get(name, ()))

    def run(self, name: str, args: Tuple = ()) -> None:
        """Run the chain; a callback returning STOP halts it
        (emqx_hooks.erl do_run/2:123-135)."""
        for cb in self._chains.get(name, ()):
            try:
                if cb.filter is not None and not cb.filter(*args):
                    continue
                if cb.action(*args) == STOP:
                    return
            except Exception:
                log.exception("hook %s callback failed", name)

    def run_fold(self, name: str, args: Tuple, acc: Any) -> Any:
        """Thread ``acc`` through the chain; callbacks return
        (OK|STOP, new_acc), a bare new acc, or None to leave it
        (emqx_hooks.erl do_run_fold/3:137-155)."""
        for cb in self._chains.get(name, ()):
            try:
                if cb.filter is not None and not cb.filter(*args, acc):
                    continue
                ret = cb.action(*args, acc)
            except Exception:
                log.exception("hook %s callback failed", name)
                continue
            if ret is None:
                continue
            if isinstance(ret, tuple) and len(ret) == 2 and ret[0] in (OK, STOP):
                acc = ret[1]
                if ret[0] == STOP:
                    return acc
            else:
                acc = ret
        return acc


_global = Hooks()


def global_hooks() -> Hooks:
    return _global
