"""TLS listener support: SSLContext construction from listener options
(the port of the JAX package's ``tls.py``).

Mirrors the reference's esockd ssl_options surface
(src/emqx_listeners.erl:43-76 starts `mqtt:ssl` listeners; the
reference's client suite drives two-way-cert SSL,
test/emqx_client_SUITE.erl:78-86 with fixtures in test/certs/). The
asyncio transport stack takes a ready ``ssl.SSLContext``, so this
module is the translation layer from EMQX-style options
(cacertfile / certfile / keyfile / verify / fail_if_no_peer_cert)
to a configured context, shared by the TCP-TLS listener and the WSS
listener.

TLS-PSK: Python 3.13 added ``SSLContext.set_psk_server_callback``;
on interpreters that have it, a :class:`emqx_tpu_torch.psk.PskAuth`
resolver is wired straight into the handshake (the reference's
``'tls_handshake.psk_lookup'`` hookpoint, src/emqx_psk.erl:31). On
older interpreters a PSK-only listener is served by the native
ctypes-OpenSSL engine instead (:mod:`emqx_tpu_torch.psk_tls`) —
``Node.add_tls_listener`` picks the backend automatically.
"""

from __future__ import annotations

import ssl
from dataclasses import dataclass
from typing import Optional

#: esockd-style verify atoms → ssl module constants
_VERIFY = {
    "verify_none": ssl.CERT_NONE,
    "verify_peer": ssl.CERT_OPTIONAL,
}


@dataclass
class TlsOptions:
    """Listener ssl_options (reference: etc/emqx.conf listener.ssl.*)."""

    certfile: Optional[str] = None
    keyfile: Optional[str] = None
    cacertfile: Optional[str] = None
    #: "verify_none" | "verify_peer" (esockd atoms)
    verify: str = "verify_none"
    #: with verify_peer: reject clients that present no certificate
    fail_if_no_peer_cert: bool = False
    ciphers: Optional[str] = None
    #: minimum protocol version, e.g. "tlsv1.2"
    tls_version: str = "tlsv1.2"
    #: identity→key store for TLS-PSK (3.13+ interpreters only)
    psk: Optional[object] = None
    #: PSK hint sent in ServerKeyExchange
    psk_identity_hint: str = "emqx_tpu"


_TLS_VERSIONS = {
    "tlsv1.2": ssl.TLSVersion.TLSv1_2,
    "tlsv1.3": ssl.TLSVersion.TLSv1_3,
}


def make_server_context(opts: TlsOptions) -> ssl.SSLContext:
    """Build the server-side context for a TLS/WSS listener.

    Raises ``ValueError`` at configure time when no server certificate
    is supplied (and no PSK store that could replace it) — otherwise
    the listener would start cleanly and every handshake would die
    with an unexplained NO_SHARED_CIPHER.
    """
    if not opts.certfile and opts.psk is None:
        raise ValueError(
            "TLS listener needs ssl_options.certfile (or a psk store)")
    if opts.verify not in _VERIFY:
        # a typo ('verifyPeer') must not silently disable mutual TLS
        raise ValueError(
            f"unknown ssl_options.verify {opts.verify!r} "
            f"(expected one of {sorted(_VERIFY)})")
    psk_only = opts.psk is not None and not opts.certfile
    if psk_only and not hasattr(ssl.SSLContext,
                                "set_psk_server_callback"):
        raise ValueError(
            "PSK-only TLS needs the native engine on this "
            "interpreter (ssl has no server-side PSK API) — go "
            "through Node.add_tls_listener, which selects "
            "emqx_tpu_torch.psk_tls automatically")
    if psk_only and opts.tls_version == "tlsv1.3":
        # PSK callbacks apply to TLS <= 1.2 only; min 1.3 + max 1.2
        # would build a context no handshake can satisfy
        raise ValueError(
            "PSK-only TLS is a TLS <= 1.2 feature; "
            "tls_version must be tlsv1.2")
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = _TLS_VERSIONS.get(
        opts.tls_version, ssl.TLSVersion.TLSv1_2)
    if opts.certfile:
        ctx.load_cert_chain(opts.certfile, opts.keyfile)
    mode = _VERIFY[opts.verify]
    if mode != ssl.CERT_NONE and opts.fail_if_no_peer_cert:
        mode = ssl.CERT_REQUIRED
    if mode != ssl.CERT_NONE:
        if not opts.cacertfile:
            # CERT_REQUIRED with an empty trust store rejects every
            # client at handshake time — fail at configure time
            raise ValueError(
                "ssl_options.verify=verify_peer needs a cacertfile")
        ctx.load_verify_locations(opts.cacertfile)
    ctx.verify_mode = mode
    if opts.ciphers:
        ctx.set_ciphers(opts.ciphers)
    if opts.psk is not None and hasattr(ctx, "set_psk_server_callback"):
        if psk_only:
            # CPython PSK callbacks apply to TLS <= 1.2 only, and PSK
            # suites are absent from the default cipher list
            ctx.maximum_version = ssl.TLSVersion.TLSv1_2
            if not opts.ciphers:
                ctx.set_ciphers("PSK")
        lookup = opts.psk.lookup  # PskAuth → hook-chain resolver

        def _psk_cb(identity):
            key = lookup(identity or "")
            return key if key is not None else b""

        ctx.set_psk_server_callback(_psk_cb, opts.psk_identity_hint)
    return ctx


def make_client_context(cacertfile: Optional[str] = None,
                        certfile: Optional[str] = None,
                        keyfile: Optional[str] = None,
                        verify: bool = True) -> ssl.SSLContext:
    """Client-side context for tests and the embedded test client
    (the role of emqtt's ssl opts in the reference suites)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if cacertfile:
        ctx.load_verify_locations(cacertfile)
    if certfile:
        ctx.load_cert_chain(certfile, keyfile)
    if not verify:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    return ctx
