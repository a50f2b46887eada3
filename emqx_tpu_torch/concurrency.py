"""Thread/loop-affinity markers.

:func:`owner_loop` marks code that runs only on the event loop that
owns the state it touches (the node's loop, or a session's owning
loop); :func:`executor_thread` code that runs on the ingress fetch
executor (the journal flush); :func:`bg_thread` code that runs on a
dedicated background thread (device-loss recovery); :func:`any_thread`
code that is thread-safe by construction (it owns a lock, or touches
only immutable state). A marker only sets ``__thread_domain__`` on the
function: no wrapper, no call-time cost.

:func:`shared_state` declares a class's cross-thread attributes and
the lock that guards them; it, too, only stamps the class.
"""

from __future__ import annotations

from typing import Callable, Tuple, TypeVar

F = TypeVar("F", bound=Callable)


def _mark(domain: str) -> Callable[[F], F]:
    def deco(fn: F) -> F:
        fn.__thread_domain__ = domain
        return fn
    return deco


#: loop-affine: callable only on the owning event loop's thread
owner_loop = _mark("loop")

#: runs on the ingress fetch executor pool
executor_thread = _mark("executor")

#: runs on a dedicated background thread
bg_thread = _mark("bg")

#: thread-safe by construction: callable from any thread
any_thread = _mark("any")


def shared_state(lock: str, attrs: Tuple[str, ...]):
    """Class decorator: ``attrs`` are mutated from more than one thread
    and every mutation holds ``self.<lock>``. Stamps
    ``__shared_state__`` on the class; no call-time cost."""
    def deco(cls):
        cls.__shared_state__ = (lock, tuple(attrs))
        return cls
    return deco
