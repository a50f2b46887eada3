"""Base62 encode/decode (reference: src/emqx_base62.erl) — used for
auto-assigned client ids."""

from __future__ import annotations

_ALPHABET = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"


def encode(n: int) -> str:
    if n == 0:
        return "0"
    if n < 0:
        raise ValueError("negative")
    out = []
    while n:
        n, r = divmod(n, 62)
        out.append(_ALPHABET[r])
    return "".join(reversed(out))
