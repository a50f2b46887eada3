"""Data-only serialization for the durability journal and checkpoints.

The port of the JAX package's ``wire`` codec, byte for byte: the same
value encodes to the same bytes in both packages, so either reads the
other's journal segments and state blobs. Like the reference's
``erlang:term_to_binary`` terms, a frame is pure data: it can only
ever decode into a fixed vocabulary of value types, never run code
(no pickle).

Encoding: a tagged tree lowered to JSON:

  - scalars (None/bool/int/float/str) encode as themselves;
  - every container/record encodes as a tagged JSON array
    ``[tag, ...]`` — plain JSON arrays and objects never appear, so
    there is no ambiguity with scalar payloads;
  - ``bytes`` ride base64; dict keys may be any scalar (pkt-ids are
    ints, pqueue priorities floats);
  - the only records are :class:`~emqx_tpu_torch.types.Message`,
    :class:`~emqx_tpu_torch.types.SubOpts` and the session snapshot
    dict produced by ``Session.to_wire()`` — all constructed
    field-wise by the decoder, never via arbitrary callables.

Anything else raises ``WireError`` at ENCODE time.
"""

from __future__ import annotations

import base64
import json
import math
from typing import Any

__all__ = ["WireError", "dumps", "loads"]


class WireError(ValueError):
    """Unencodable value (send side) or malformed frame (recv side)."""


_T_BYTES = "b"
_T_LIST = "l"
_T_TUPLE = "t"
_T_DICT = "d"
_T_SET = "s"
_T_FROZENSET = "fs"
_T_MESSAGE = "M"
_T_SUBOPTS = "O"
_T_SESSION = "S"
_T_BIGINT = "i"  # ints beyond IEEE-754 exactness ride as strings


def _enc(x: Any):
    if x is None or isinstance(x, (bool, str)):
        return x
    if isinstance(x, int):
        # json would round-trip big ints fine, but some parsers (and
        # float-coercing paths) lose precision — tag past 2^53
        if -(1 << 53) <= x <= (1 << 53):
            return x
        return [_T_BIGINT, str(x)]
    if isinstance(x, float):
        if math.isnan(x) or math.isinf(x):
            # Python's json emits NaN/Infinity literals; keep them —
            # pqueue priorities use inf
            return x
        return x
    if isinstance(x, (bytes, bytearray, memoryview)):
        return [_T_BYTES, base64.b64encode(bytes(x)).decode("ascii")]
    if isinstance(x, list):
        return [_T_LIST, [_enc(v) for v in x]]
    if isinstance(x, tuple):
        return [_T_TUPLE, [_enc(v) for v in x]]
    if isinstance(x, dict):
        return [_T_DICT, [[_enc(k), _enc(v)] for k, v in x.items()]]
    if isinstance(x, frozenset):
        return [_T_FROZENSET, [_enc(v) for v in x]]
    if isinstance(x, set):
        return [_T_SET, [_enc(v) for v in x]]
    from emqx_tpu_torch.session import Session
    from emqx_tpu_torch.types import Message, SubOpts

    if isinstance(x, Message):
        return [_T_MESSAGE, [
            x.topic, _enc(x.payload), x.qos, x.from_, _enc(x.flags),
            _enc(x.headers), _enc(x.id), x.timestamp]]
    if isinstance(x, SubOpts):
        return [_T_SUBOPTS, [x.qos, x.nl, x.rap, x.rh, x.share,
                             x.subid]]
    if isinstance(x, Session):
        return [_T_SESSION, _enc(x.to_wire())]
    raise WireError(f"unencodable type on cluster wire: {type(x)!r}")


def _dec(x: Any):
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if not isinstance(x, list) or len(x) != 2 \
            or not isinstance(x[0], str):
        raise WireError(f"malformed wire node: {x!r}")
    tag, body = x
    if tag == _T_BYTES:
        return base64.b64decode(body)
    if tag == _T_BIGINT:
        return int(body)
    if tag == _T_LIST:
        return [_dec(v) for v in body]
    if tag == _T_TUPLE:
        return tuple(_dec(v) for v in body)
    if tag == _T_DICT:
        return {_dec(k): _dec(v) for k, v in body}
    if tag == _T_SET:
        return {_dec(v) for v in body}
    if tag == _T_FROZENSET:
        return frozenset(_dec(v) for v in body)
    if tag == _T_MESSAGE:
        from emqx_tpu_torch.types import Message

        topic, payload, qos, from_, flags, headers, mid, ts = body
        return Message(
            topic=str(topic), payload=_dec(payload), qos=int(qos),
            from_=str(from_), flags=_dec(flags), headers=_dec(headers),
            id=_dec(mid), timestamp=float(ts))
    if tag == _T_SUBOPTS:
        from emqx_tpu_torch.types import SubOpts

        qos, nl, rap, rh, share, subid = body
        return SubOpts(qos=int(qos), nl=int(nl), rap=int(rap),
                       rh=int(rh), share=share, subid=subid)
    if tag == _T_SESSION:
        from emqx_tpu_torch.session import Session

        return Session.from_wire(_dec(body))
    raise WireError(f"unknown wire tag: {tag!r}")


def dumps(obj: Any) -> bytes:
    """Encode ``obj`` into a data-only frame payload. Raises
    :class:`WireError` for anything unencodable — including failures
    past ``_enc``'s type checks (strings carrying lone surrogates
    raise ``UnicodeEncodeError`` at the utf-8 step; pathologically
    deep structures raise ``RecursionError``): transport callers
    handle WireError/ConnectionError only, mirroring ``loads``."""
    try:
        return json.dumps(_enc(obj), separators=(",", ":"),
                          ensure_ascii=False).encode("utf-8")
    except WireError:
        raise
    except Exception as e:
        raise WireError(f"unencodable value on cluster wire: {e}") from e


def loads(data: bytes) -> Any:
    """Decode a frame payload. Raises :class:`WireError` on any
    malformed input; never constructs anything outside the codec's
    fixed type vocabulary (in particular: no callables, no pickle)."""
    try:
        tree = json.loads(data)
    except Exception as e:
        raise WireError(f"malformed wire frame: {e}") from e
    try:
        return _dec(tree)
    except WireError:
        raise
    except Exception as e:
        # any decode failure IS a malformed frame (short record
        # bodies, wrong arity, bad base64…) — one exception type for
        # the transport's drop-the-link path
        raise WireError(f"malformed wire frame: {e}") from e
