"""TLS-PSK identity lookup through the hook chain (the port of the JAX
package's ``psk.py``).

Mirrors ``src/emqx_psk.erl``: the listener's TLS handshake asks the
``'tls_handshake.psk_lookup'`` hookpoint for the pre-shared key of a
client identity; any auth plugin can register a resolver. On an
interpreter whose ``ssl`` module has no TLS-PSK server API (3.12), the
native engine (:mod:`emqx_tpu_torch.psk_tls`) calls
:meth:`PskAuth.lookup` during its handshake.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

log = logging.getLogger("emqx_tpu_torch.psk")

HOOKPOINT = "tls_handshake.psk_lookup"


class PskAuth:
    """In-memory identity→key store registered on the hookpoint
    (the reference's emqx_psk:lookup/3 fold)."""

    def __init__(self, hooks, keys: Optional[Dict[str, bytes]] = None,
                 priority: int = 0) -> None:
        self.hooks = hooks
        self._keys: Dict[str, bytes] = dict(keys or {})
        hooks.add(HOOKPOINT, self._on_lookup, priority=priority)

    def add(self, identity: str, key: bytes) -> None:
        self._keys[identity] = key

    def remove(self, identity: str) -> None:
        self._keys.pop(identity, None)

    def _on_lookup(self, identity: str, acc) -> Optional[bytes]:
        # run_fold semantics: first resolver that knows the identity
        # wins; unknown identities pass the accumulator through
        if acc is not None:
            return acc
        key = self._keys.get(identity)
        if key is None:
            log.debug("psk lookup miss: %s", identity)
        return key

    def lookup(self, identity: str) -> Optional[bytes]:
        """Resolve via the full hook chain (what a TLS frontend
        calls during the handshake)."""
        return self.hooks.run_fold(HOOKPOINT, (identity,), None)
