"""Native TLS-PSK termination via ctypes-bound OpenSSL memory BIOs (the
port of the JAX package's ``psk_tls.py``).

The reference serves TLS-PSK through esockd's ssl options with the
``'tls_handshake.psk_lookup'`` hook resolving identities
(``src/emqx_psk.erl:31``). CPython grew server-side PSK APIs only in
3.13; on older interpreters a PSK-only ``Node.add_tls_listener``
goes through this module, which drives ``libssl`` directly: an :class:`PskTlsEngine` owns
an OpenSSL ``SSL`` object wired to two memory BIOs (ciphertext in /
ciphertext out), and an asyncio pump shuttles bytes between the real
socket and the engine, presenting a plain ``(StreamReader, writer)``
pair to the normal MQTT connection loop. PSK cipher suites are a
TLS ≤ 1.2 feature, so the engine pins the protocol to TLS 1.2 and the
``PSK`` cipher-list family (as the reference's psk_ciphers config,
``etc/emqx.conf``).

No OpenSSL headers are required — every entry point is declared via
``ctypes`` against the runtime ``libssl.so.3``/``libcrypto.so.3``
(the same libraries CPython's own ``ssl`` links). If the libraries
are absent, :func:`available` is False and the PSK listener refuses
to start with a clear error.
"""

from __future__ import annotations

import asyncio
import ctypes
import ctypes.util
import logging
from typing import Callable, Optional, Tuple

log = logging.getLogger("emqx_tpu_torch.psk_tls")

# -- libssl / libcrypto binding ------------------------------------------

_SSL_ERROR_NONE = 0
_SSL_ERROR_SSL = 1
_SSL_ERROR_WANT_READ = 2
_SSL_ERROR_WANT_WRITE = 3
_SSL_ERROR_ZERO_RETURN = 6
_SSL_CTRL_SET_MIN_PROTO_VERSION = 123
_SSL_CTRL_SET_MAX_PROTO_VERSION = 124
_TLS1_2_VERSION = 0x0303

# unsigned int cb(SSL*, const char *identity, unsigned char *psk, max)
_SERVER_CB = ctypes.CFUNCTYPE(
    ctypes.c_uint, ctypes.c_void_p, ctypes.c_char_p,
    ctypes.POINTER(ctypes.c_ubyte), ctypes.c_uint)
# unsigned int cb(SSL*, const char *hint, char *identity, max_id,
#                 unsigned char *psk, max_psk)
_CLIENT_CB = ctypes.CFUNCTYPE(
    ctypes.c_uint, ctypes.c_void_p, ctypes.c_char_p,
    ctypes.POINTER(ctypes.c_char), ctypes.c_uint,
    ctypes.POINTER(ctypes.c_ubyte), ctypes.c_uint)

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    names = [("libssl.so.3", "libcrypto.so.3"),
             ("libssl.so.1.1", "libcrypto.so.1.1")]
    found = ctypes.util.find_library("ssl")
    if found:
        names.insert(0, (found, ctypes.util.find_library("crypto")))
    last = None
    for ssl_name, crypto_name in names:
        try:
            crypto = ctypes.CDLL(crypto_name or "libcrypto.so.3")
            ssl = ctypes.CDLL(ssl_name)
            _lib = _declare(ssl, crypto)
            return _lib
        except OSError as e:
            last = e
    raise RuntimeError(f"libssl not loadable: {last}")


def _declare(ssl, crypto):
    c = ctypes
    for name, args, res in [
        ("BIO_s_mem", [], c.c_void_p),
        ("BIO_new", [c.c_void_p], c.c_void_p),
        ("BIO_read", [c.c_void_p, c.c_void_p, c.c_int], c.c_int),
        ("BIO_write", [c.c_void_p, c.c_void_p, c.c_int], c.c_int),
        ("BIO_ctrl_pending", [c.c_void_p], c.c_size_t),
        ("ERR_get_error", [], c.c_ulong),
        ("ERR_error_string_n",
         [c.c_ulong, c.c_char_p, c.c_size_t], None),
        ("ERR_clear_error", [], None),
    ]:
        f = getattr(crypto, name)
        f.argtypes, f.restype = args, res
    for name, args, res in [
        ("TLS_server_method", [], c.c_void_p),
        ("TLS_client_method", [], c.c_void_p),
        ("SSL_CTX_new", [c.c_void_p], c.c_void_p),
        ("SSL_CTX_free", [c.c_void_p], None),
        ("SSL_CTX_ctrl",
         [c.c_void_p, c.c_int, c.c_long, c.c_void_p], c.c_long),
        ("SSL_CTX_set_cipher_list", [c.c_void_p, c.c_char_p], c.c_int),
        ("SSL_CTX_use_psk_identity_hint",
         [c.c_void_p, c.c_char_p], c.c_int),
        ("SSL_CTX_set_psk_server_callback",
         [c.c_void_p, _SERVER_CB], None),
        ("SSL_CTX_set_psk_client_callback",
         [c.c_void_p, _CLIENT_CB], None),
        ("SSL_new", [c.c_void_p], c.c_void_p),
        ("SSL_free", [c.c_void_p], None),
        ("SSL_set_accept_state", [c.c_void_p], None),
        ("SSL_set_connect_state", [c.c_void_p], None),
        ("SSL_set_bio", [c.c_void_p, c.c_void_p, c.c_void_p], None),
        ("SSL_do_handshake", [c.c_void_p], c.c_int),
        ("SSL_is_init_finished", [c.c_void_p], c.c_int),
        ("SSL_read", [c.c_void_p, c.c_void_p, c.c_int], c.c_int),
        ("SSL_write", [c.c_void_p, c.c_void_p, c.c_int], c.c_int),
        ("SSL_get_error", [c.c_void_p, c.c_int], c.c_int),
        ("SSL_get_psk_identity", [c.c_void_p], c.c_char_p),
    ]:
        f = getattr(ssl, name)
        f.argtypes, f.restype = args, res
    return (ssl, crypto)


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


class PskTlsError(Exception):
    pass


def _err_text(crypto) -> str:
    buf = ctypes.create_string_buffer(256)
    parts = []
    while True:
        code = crypto.ERR_get_error()
        if not code:
            break
        crypto.ERR_error_string_n(code, buf, len(buf))
        parts.append(buf.value.decode("ascii", "replace"))
    return "; ".join(parts) or "unknown OpenSSL error"


class PskTlsContext:
    """A shared ``SSL_CTX`` (the OpenSSL per-listener object): cipher
    list, protocol pin, and the PSK callback thunk live here — one
    allocation + cipher parse per listener, ``SSL_new`` per
    connection."""

    def __init__(self, *, server: bool,
                 lookup: Optional[Callable[[str], Optional[bytes]]] = None,
                 identity: Optional[str] = None,
                 key: Optional[bytes] = None,
                 hint: str = "emqx_tpu",
                 ciphers: str = "PSK") -> None:
        self._ssl_lib, self._crypto = _load()
        self.server = server
        s = self._ssl_lib
        method = (s.TLS_server_method() if server
                  else s.TLS_client_method())
        self._ctx = s.SSL_CTX_new(method)
        if not self._ctx:
            raise PskTlsError("SSL_CTX_new failed")
        s.SSL_CTX_ctrl(self._ctx, _SSL_CTRL_SET_MIN_PROTO_VERSION,
                       _TLS1_2_VERSION, None)
        s.SSL_CTX_ctrl(self._ctx, _SSL_CTRL_SET_MAX_PROTO_VERSION,
                       _TLS1_2_VERSION, None)
        if not s.SSL_CTX_set_cipher_list(self._ctx,
                                         ciphers.encode("ascii")):
            raise PskTlsError(
                f"no PSK ciphers available: {_err_text(self._crypto)}")
        if server:
            if lookup is None:
                raise ValueError("server context needs a lookup fn")

            def _server_cb(_ssl, ident, psk_buf, max_len):
                try:
                    key_ = lookup((ident or b"").decode("utf-8",
                                                        "replace"))
                    if not key_ or len(key_) > max_len:
                        return 0
                    ctypes.memmove(psk_buf, key_, len(key_))
                    return len(key_)
                except Exception:
                    log.exception("psk lookup callback failed")
                    return 0

            self._cb = _SERVER_CB(_server_cb)  # keep alive
            s.SSL_CTX_set_psk_server_callback(self._ctx, self._cb)
            s.SSL_CTX_use_psk_identity_hint(self._ctx,
                                            hint.encode("utf-8"))
        else:
            if identity is None or key is None:
                raise ValueError("client context needs identity + key")
            ident_z = identity.encode("utf-8") + b"\x00"

            def _client_cb(_ssl, _hint, id_buf, max_id, psk_buf,
                           max_psk):
                if len(ident_z) > max_id or len(key) > max_psk:
                    return 0
                ctypes.memmove(id_buf, ident_z, len(ident_z))
                ctypes.memmove(psk_buf, key, len(key))
                return len(key)

            self._cb = _CLIENT_CB(_client_cb)
            s.SSL_CTX_set_psk_client_callback(self._ctx, self._cb)

    def close(self) -> None:
        if getattr(self, "_ctx", None):
            self._ssl_lib.SSL_CTX_free(self._ctx)
            self._ctx = None

    def __del__(self) -> None:  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass


class PskTlsEngine:
    """One TLS-PSK endpoint over memory BIOs (sans-IO).

    Built either from a shared :class:`PskTlsContext` (``context=``,
    the listener path) or from the same keyword set (owns a private
    context — convenient for clients/tests). The caller pumps:
    :meth:`feed` ciphertext in, :meth:`outgoing` ciphertext out,
    :meth:`read`/:meth:`write` for plaintext.
    """

    def __init__(self, *, context: Optional[PskTlsContext] = None,
                 server: Optional[bool] = None, **ctx_kw) -> None:
        self._owns_ctx = context is None
        if context is None:
            if server is None:
                raise ValueError("need context= or server=")
            context = PskTlsContext(server=server, **ctx_kw)
        self._context = context  # keeps the callback thunk alive
        self._ssl_lib = context._ssl_lib
        self._crypto = context._crypto
        s = self._ssl_lib
        self._eof = False
        self._hs_done = False
        self._ssl = s.SSL_new(context._ctx)
        if not self._ssl:
            raise PskTlsError("SSL_new failed")
        (s.SSL_set_accept_state if context.server
         else s.SSL_set_connect_state)(self._ssl)
        mem = self._crypto.BIO_s_mem
        self._rbio = self._crypto.BIO_new(mem())
        self._wbio = self._crypto.BIO_new(mem())
        # SSL_set_bio transfers BIO ownership to the SSL object
        s.SSL_set_bio(self._ssl, self._rbio, self._wbio)

    def _check_open(self) -> None:
        if self._ssl is None:
            # a late write/read after close must be a Python error,
            # not a NULL pointer into libssl
            raise PskTlsError("TLS engine is closed")

    # -- byte pumps -------------------------------------------------------

    def feed(self, data: bytes) -> None:
        """Ciphertext from the network into the engine."""
        self._check_open()
        if data:
            n = self._crypto.BIO_write(self._rbio, data, len(data))
            if n != len(data):
                raise PskTlsError("BIO_write short write")

    def outgoing(self) -> bytes:
        """Drain ciphertext the engine wants on the wire."""
        self._check_open()
        out = b""
        while True:
            pending = self._crypto.BIO_ctrl_pending(self._wbio)
            if not pending:
                return out
            buf = ctypes.create_string_buffer(int(pending))
            n = self._crypto.BIO_read(self._wbio, buf, int(pending))
            if n <= 0:
                return out
            out += buf.raw[:n]

    def handshake(self) -> bool:
        """Advance the handshake; True once established. Raises
        :class:`PskTlsError` on fatal alert (bad key / no identity)."""
        if self._hs_done:
            return True
        self._check_open()
        self._crypto.ERR_clear_error()
        ret = self._ssl_lib.SSL_do_handshake(self._ssl)
        if ret == 1:
            self._hs_done = True
            return True
        err = self._ssl_lib.SSL_get_error(self._ssl, ret)
        if err in (_SSL_ERROR_WANT_READ, _SSL_ERROR_WANT_WRITE):
            return False
        raise PskTlsError(
            f"TLS-PSK handshake failed: {_err_text(self._crypto)}")

    @property
    def handshake_done(self) -> bool:
        return self._hs_done

    @property
    def psk_identity(self) -> Optional[str]:
        if self._ssl is None:
            return None
        ident = self._ssl_lib.SSL_get_psk_identity(self._ssl)
        return ident.decode("utf-8", "replace") if ident else None

    def read(self) -> bytes:
        """All decrypted plaintext currently available."""
        self._check_open()
        out = b""
        buf = ctypes.create_string_buffer(16384)
        while True:
            self._crypto.ERR_clear_error()
            n = self._ssl_lib.SSL_read(self._ssl, buf, len(buf))
            if n > 0:
                out += buf.raw[:n]
                continue
            err = self._ssl_lib.SSL_get_error(self._ssl, n)
            if err == _SSL_ERROR_ZERO_RETURN:
                self._eof = True  # close_notify
                return out
            if err in (_SSL_ERROR_WANT_READ, _SSL_ERROR_WANT_WRITE):
                return out
            raise PskTlsError(
                f"TLS read failed: {_err_text(self._crypto)}")

    @property
    def eof(self) -> bool:
        return self._eof

    def write(self, data: bytes) -> None:
        """Encrypt plaintext (collect ciphertext via
        :meth:`outgoing`). Memory BIOs grow, so this never blocks."""
        self._check_open()
        view = memoryview(data)
        while view:
            self._crypto.ERR_clear_error()
            n = self._ssl_lib.SSL_write(self._ssl, bytes(view[:16384]),
                                        min(len(view), 16384))
            if n <= 0:
                raise PskTlsError(
                    f"TLS write failed: {_err_text(self._crypto)}")
            view = view[n:]

    def close(self) -> None:
        if getattr(self, "_ssl", None):
            self._ssl_lib.SSL_free(self._ssl)  # frees both BIOs
            self._ssl = None
            self._rbio = self._wbio = None
        if getattr(self, "_owns_ctx", False) and \
                getattr(self, "_context", None) is not None:
            self._context.close()

    def __del__(self) -> None:  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass

    # ssl.SSLObject-compatible surface for Connection's peercert probe
    def getpeercert(self):
        return None


# -- asyncio integration --------------------------------------------------


class PskStreamWriter:
    """Writer facade: encrypts through the engine, forwards ciphertext
    to the real socket writer. Implements the subset of
    ``asyncio.StreamWriter`` the connection loop uses."""

    def __init__(self, engine: PskTlsEngine, writer, pump_task) -> None:
        self._engine = engine
        self._writer = writer
        self._pump = pump_task
        self._closed = False

    def write(self, data: bytes) -> None:
        if self._closed:
            return  # asyncio writers ignore late writes; so do we
        self._engine.write(data)
        out = self._engine.outgoing()
        if out:
            self._writer.write(out)

    def writelines(self, data) -> None:
        """The egress fast lane flushes runs of pre-serialized frames
        through one writelines() call (Connection._send_packets);
        through TLS they still encrypt frame-by-frame, but the
        ciphertext forwards as one write."""
        if self._closed:
            return
        for chunk in data:
            self._engine.write(chunk)
        out = self._engine.outgoing()
        if out:
            self._writer.write(out)

    async def drain(self) -> None:
        await self._writer.drain()

    @property
    def transport(self):
        """The socket's transport: the connection's write-buffer
        limits, slow-consumer check and abort act on the ciphertext
        the socket still holds."""
        return self._writer.transport

    def close(self) -> None:
        self._closed = True
        if self._pump is not None:
            self._pump.cancel()
        try:
            self._writer.close()
        finally:
            self._engine.close()

    def is_closing(self) -> bool:
        return self._writer.is_closing()

    async def wait_closed(self) -> None:
        await self._writer.wait_closed()

    def get_extra_info(self, name, default=None):
        if name == "ssl_object":
            return self._engine
        if name == "psk_identity":
            return self._engine.psk_identity
        return self._writer.get_extra_info(name, default)


#: decrypt-pump high-water mark: above this much un-consumed
#: plaintext the pump stops reading the socket, re-engaging TCP
#: backpressure (the plain-TCP path gets this for free by reading
#: the socket directly; the zone's rate limiter then works again)
_PUMP_HIGH_WATER = 1 << 20


async def _pump(engine: PskTlsEngine, sock_reader,
                plain: asyncio.StreamReader, writer) -> None:
    """Socket → engine → plaintext reader (and any engine-generated
    ciphertext — renegotiation, close_notify replies — back out)."""
    try:
        while True:
            while len(plain._buffer) > _PUMP_HIGH_WATER:
                # connection loop hasn't consumed the plaintext yet:
                # stop pulling off the socket so the peer's TCP
                # window closes instead of our memory growing
                await asyncio.sleep(0.02)
            data = await sock_reader.read(65536)
            if not data:
                plain.feed_eof()
                return
            engine.feed(data)
            pt = engine.read()
            if pt:
                plain.feed_data(pt)
            out = engine.outgoing()
            if out:
                writer.write(out)
            if engine.eof:
                plain.feed_eof()
                return
    except asyncio.CancelledError:
        raise
    except Exception as e:
        # a mid-connection TLS failure (bad record MAC, protocol
        # violation) must leave a diagnostic trail, and the alert
        # OpenSSL queued belongs on the wire before the close
        log.info("TLS-PSK connection error: %s", e)
        try:
            out = engine.outgoing()
            if out:
                writer.write(out)
        except Exception:
            pass
        try:
            plain.feed_eof()
        except Exception:
            pass


async def handshake_streams(
        engine: PskTlsEngine, reader, writer,
        timeout: float = 10.0,
) -> Tuple[asyncio.StreamReader, PskStreamWriter]:
    """Complete the TLS handshake over (reader, writer) and return the
    plaintext stream pair; raises on failure/timeout."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout

    while True:
        try:
            done = engine.handshake()
        except PskTlsError:
            # flush the alert OpenSSL queued (unknown_psk_identity /
            # decrypt_error) so the peer can tell a bad key from a
            # network failure, then re-raise
            out = engine.outgoing()
            if out:
                try:
                    writer.write(out)
                    await writer.drain()
                except Exception:
                    pass
            raise
        out = engine.outgoing()
        if out:
            writer.write(out)
            await writer.drain()
        if done:
            break
        remaining = deadline - loop.time()
        if remaining <= 0:
            # hard deadline: a drip-feeding client must not hold a
            # handshake slot past the timeout (slow-loris)
            raise asyncio.TimeoutError("TLS-PSK handshake deadline")
        data = await asyncio.wait_for(reader.read(65536), remaining)
        if not data:
            raise PskTlsError("peer closed during TLS-PSK handshake")
        engine.feed(data)

    plain = asyncio.StreamReader()
    pt = engine.read()  # early data arriving with the final flight
    if pt:
        plain.feed_data(pt)
    task = asyncio.ensure_future(_pump(engine, reader, plain, writer))
    return plain, PskStreamWriter(engine, writer, task)


async def open_psk_connection(
        host: str, port: int, identity: str, key: bytes,
        timeout: float = 10.0):
    """Client side: TCP connect + TLS-PSK handshake; returns a
    ``(reader, writer)`` pair speaking plaintext (what emqtt's
    ``{psk, ...}`` ssl opts give the reference's suites)."""
    reader, writer = await asyncio.open_connection(host, port)
    engine = PskTlsEngine(server=False, identity=identity, key=key)
    try:
        return await handshake_streams(engine, reader, writer,
                                       timeout=timeout)
    except Exception:
        writer.close()
        engine.close()
        raise


from emqx_tpu_torch.connection import Listener  # noqa: E402  (cycle-free)


class PskTlsListener(Listener):
    """MQTT listener terminating TLS-PSK natively (no fronting
    proxy): handshake via the ctypes OpenSSL engine, identities
    resolved through the ``'tls_handshake.psk_lookup'`` hook chain
    (:class:`emqx_tpu_torch.psk.PskAuth`). One shared ``SSL_CTX`` per
    listener (cipher list parsed once); ``SSL_new`` per connection."""

    def __init__(self, *args, psk=None, psk_identity_hint="emqx_tpu",
                 psk_ciphers="PSK", handshake_timeout=10.0, **kw):
        super().__init__(*args, **kw)
        if psk is None:
            raise ValueError("PskTlsListener needs a psk store")
        if not available():
            raise RuntimeError(
                "native TLS-PSK needs libssl; none loadable")
        self.psk = psk
        self.handshake_timeout = handshake_timeout
        # misconfiguration (bad cipher string, restricted provider)
        # surfaces HERE, at listener build, not per-connection
        self.tls_context = PskTlsContext(
            server=True, lookup=psk.lookup, hint=psk_identity_hint,
            ciphers=psk_ciphers)

    async def _handshake(self, reader, writer):
        engine = None
        try:
            engine = PskTlsEngine(context=self.tls_context)
            return await handshake_streams(
                engine, reader, writer,
                timeout=self.handshake_timeout)
        except (PskTlsError, asyncio.TimeoutError, OSError) as e:
            log.info("TLS-PSK handshake rejected: %s", e)
            if engine is not None:
                engine.close()
            return False
