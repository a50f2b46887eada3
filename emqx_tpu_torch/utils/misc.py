"""Small control-flow helpers shared across layers.

Mirrors ``src/emqx_misc.erl``: ``pipeline/3`` (the CONNECT/PUBLISH
processing chains thread state through fallible stages) and
``run_fold/3``. The drain/OOM helpers there are BEAM-mailbox specific
and have no analogue here.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Tuple

OK = "ok"
ERROR = "error"


def pipeline(funs: Iterable[Callable], packet: Any,
             state: Any) -> Tuple[str, Any, Any]:
    """Run stages over (packet, state); each returns one of
      - ``None`` / ``("ok",)``: keep both
      - ``("ok", new_packet)`` or ``("ok", new_packet, new_state)``
      - ``("error", reason)`` / ``("error", reason, new_state)``: halt
    Returns ``("ok", packet, state)`` or ``("error", reason, state)``
    (emqx_misc:pipeline/3)."""
    for fun in funs:
        ret = fun(packet, state)
        if ret is None or ret == (OK,):
            continue
        tag = ret[0]
        if tag == OK:
            if len(ret) == 2:
                packet = ret[1]
            else:
                packet, state = ret[1], ret[2]
        elif tag == ERROR:
            if len(ret) == 3:
                state = ret[2]
            return (ERROR, ret[1], state)
        else:
            raise ValueError(f"bad pipeline return: {ret!r}")
    return (OK, packet, state)


def run_fold(funs: Iterable[Callable], acc: Any, state: Any) -> Any:
    """Thread ``acc`` through funs(acc, state) (emqx_misc:run_fold/3)."""
    for fun in funs:
        acc = fun(acc, state)
    return acc
