"""Thread/loop-affinity markers.

:func:`owner_loop` marks code that runs only on the event loop that
owns the state it touches (the node's loop, or a session's owning
loop). It only sets ``__thread_domain__`` on the function: no
wrapper, no call-time cost.
"""

from __future__ import annotations

from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)


def _mark(domain: str) -> Callable[[F], F]:
    def deco(fn: F) -> F:
        fn.__thread_domain__ = domain
        return fn
    return deco


#: loop-affine: callable only on the owning event loop's thread
owner_loop = _mark("loop")
