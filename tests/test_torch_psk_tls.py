"""The port's native TLS-PSK termination (``emqx_tpu_torch.psk_tls``,
``emqx_tpu_torch.psk``) against the JAX package's, case for case with
``tests/test_psk_tls.py``.

The engine cases pump handshakes between in-memory engines: the
port's against itself, and across packages (a port client against a
JAX server and the reverse), so the two bind the same OpenSSL
protocol. The listener cases run on a JAX ``Node(boot_listeners=
False)`` and then on a port ``Node(device="cpu",
boot_listeners=False)`` — a PSK-only ``add_tls_listener`` on this
interpreter (no server-side PSK in ``ssl``) is the native engine — and
what the clients observe (deliveries, refusals, the deadline) must be
equal. Without ``libssl`` the listener refuses to start; it never
serves plain TCP.
"""

import asyncio
import ssl

import pytest

from emqx_tpu import psk_tls as J
from emqx_tpu.hooks import Hooks as JHooks
from emqx_tpu.node import Node as JNode
from emqx_tpu.psk import PskAuth as JPsk
from emqx_tpu.tls import TlsOptions as JTlsOptions
from emqx_tpu_torch import psk_tls as P_
from emqx_tpu_torch.hooks import Hooks as PHooks
from emqx_tpu_torch.node import Node as PNode
from emqx_tpu_torch.psk import PskAuth as PPsk
from emqx_tpu_torch.tls import TlsOptions as PTlsOptions
from mqtt_client import TestClient

pytestmark = pytest.mark.skipif(
    not P_.available(), reason="libssl not loadable")


class _Pkg:
    def __init__(self, **kw) -> None:
        self.__dict__.update(kw)


JAX = _Pkg(name="jax", port=False, M=J, Hooks=JHooks, Psk=JPsk,
           TlsOptions=JTlsOptions,
           Node=lambda **kw: JNode(boot_listeners=False, **kw))
PORT = _Pkg(name="port", port=True, M=P_, Hooks=PHooks, Psk=PPsk,
            TlsOptions=PTlsOptions,
            Node=lambda **kw: PNode(device="cpu", boot_listeners=False,
                                    **kw))


def both(scenario, *args):
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def both_async(scenario, *args):
    want = asyncio.run(scenario(JAX, *args))
    got = asyncio.run(scenario(PORT, *args))
    assert got == want
    return got


def _pump_pair(client, server, rounds: int = 10) -> None:
    """Shuttle handshake bytes between two in-memory engines."""
    for _ in range(rounds):
        if client.handshake_done and server.handshake_done:
            return
        try:
            client.handshake()
        finally:
            out = client.outgoing()
        if out:
            server.feed(out)
        try:
            server.handshake()
        finally:
            back = server.outgoing()
        if back:
            client.feed(back)
    raise AssertionError("handshake did not converge")


def _mk_server(P, keys):
    auth = P.Psk(P.Hooks(), keys=keys)
    return P.M.PskTlsEngine(server=True, lookup=auth.lookup)


def test_engine_handshake_and_data_both_ways():
    def scenario(P):
        server = _mk_server(P, {"dev1": b"sekret-key-123"})
        client = P.M.PskTlsEngine(server=False, identity="dev1",
                                  key=b"sekret-key-123")
        _pump_pair(client, server)
        seen = [server.psk_identity]
        client.write(b"hello broker")
        server.feed(client.outgoing())
        seen.append(server.read())
        server.write(b"hello device")
        client.feed(server.outgoing())
        seen.append(client.read())
        client.close()
        server.close()
        return seen

    assert both(scenario) == ["dev1", b"hello broker", b"hello device"]


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("port", "jax"), ("jax", "port")])
def test_engines_interoperate_across_packages(client_pkg, server_pkg):
    pk = {"port": PORT, "jax": JAX}
    server = _mk_server(pk[server_pkg], {"d": b"shared"})
    client = pk[client_pkg].M.PskTlsEngine(server=False, identity="d",
                                           key=b"shared")
    _pump_pair(client, server)
    client.write(b"x" * 40000)
    server.feed(client.outgoing())
    assert server.read() == b"x" * 40000
    client.close()
    server.close()


def test_engine_wrong_key_fails_handshake():
    def scenario(P):
        server = _mk_server(P, {"dev1": b"right-key"})
        client = P.M.PskTlsEngine(server=False, identity="dev1",
                                  key=b"wrong-key")
        with pytest.raises((P.M.PskTlsError, AssertionError)) as ei:
            _pump_pair(client, server)
        return type(ei.value).__name__

    assert both(scenario) == "PskTlsError"


def test_engine_unknown_identity_rejected():
    def scenario(P):
        server = _mk_server(P, {"dev1": b"right-key"})
        client = P.M.PskTlsEngine(server=False, identity="nobody",
                                  key=b"right-key")
        with pytest.raises((P.M.PskTlsError, AssertionError)) as ei:
            _pump_pair(client, server)
        return type(ei.value).__name__

    assert both(scenario) == "PskTlsError"


def test_engine_hook_chain_priority():
    """The lookup runs the hook chain (run_fold): the higher-priority
    resolver wins."""
    def scenario(P):
        hooks = P.Hooks()
        P.Psk(hooks, keys={"d": b"low"}, priority=0)
        P.Psk(hooks, keys={"d": b"high"}, priority=10)
        server = P.M.PskTlsEngine(
            server=True, lookup=lambda i: hooks.run_fold(
                "tls_handshake.psk_lookup", (i,), None))
        client = P.M.PskTlsEngine(server=False, identity="d", key=b"high")
        _pump_pair(client, server)
        return server.psk_identity

    assert both(scenario) == "d"


async def _psk_node(P, keys, **kw):
    n = P.Node()
    auth = P.Psk(n.hooks, keys=keys)
    lst = n.add_tls_listener(port=0, tls_options=P.TlsOptions(psk=auth),
                             **kw)
    await n.start()
    return n, lst


def test_mqtt_connect_over_native_psk_listener():
    """Node PSK listener → native handshake → MQTT CONNECT, SUBSCRIBE,
    PUBLISH and the delivery over the encrypted socket."""
    async def scenario(P):
        n, lst = await _psk_node(P, {"sensor-7": b"super-secret"},
                                 name="psk:test")
        try:
            assert isinstance(lst, P.M.PskTlsListener)
            assert not hasattr(ssl.SSLContext, "set_psk_server_callback")
            reader, writer = await P.M.open_psk_connection(
                "127.0.0.1", lst.port, "sensor-7", b"super-secret")
            c = TestClient("psk-client", version=4)
            ack = await c.connect_over(reader, writer)
            await c.subscribe("s/+", qos=1)
            await c.publish("s/1", b"encrypted payload", qos=1)
            m = await asyncio.wait_for(c.recv(), 10)
            ident = writer.get_extra_info("psk_identity")
            writer.close()
            return ack.reason_code, m.topic, m.payload, ident, lst.name
        finally:
            await n.stop()

    assert both_async(scenario) == (0, "s/1", b"encrypted payload",
                                    "sensor-7", "psk:test")


def test_native_psk_listener_rejects_bad_key():
    async def scenario(P):
        n, lst = await _psk_node(P, {"sensor-7": b"super-secret"})
        try:
            with pytest.raises((P.M.PskTlsError, ConnectionError,
                                asyncio.IncompleteReadError,
                                OSError)) as ei:
                await P.M.open_psk_connection(
                    "127.0.0.1", lst.port, "sensor-7", b"wrong")
            return type(ei.value).__name__, lst.current_connections()
        finally:
            await n.stop()

    assert both_async(scenario) == ("PskTlsError", 0)


def test_engine_closed_guard():
    """A closed engine raises PskTlsError — never a NULL pointer into
    libssl."""
    def scenario(P):
        server = _mk_server(P, {"d": b"k"})
        server.close()
        for op in (lambda: server.write(b"late"),
                   lambda: server.feed(b"late"), server.read):
            with pytest.raises(P.M.PskTlsError):
                op()
        out = server.psk_identity
        server.close()  # idempotent
        return out

    assert both(scenario) is None


def test_shared_context_multiple_engines():
    """One SSL_CTX, many connections (the listener model)."""
    def scenario(P):
        auth = P.Psk(P.Hooks(), keys={"d": b"k"})
        ctx = P.M.PskTlsContext(server=True, lookup=auth.lookup)
        out = []
        for i in range(3):
            server = P.M.PskTlsEngine(context=ctx)
            client = P.M.PskTlsEngine(server=False, identity="d", key=b"k")
            _pump_pair(client, server)
            client.write(b"x%d" % i)
            server.feed(client.outgoing())
            out.append(server.read())
            client.close()
            server.close()
        ctx.close()
        return out

    assert both(scenario) == [b"x0", b"x1", b"x2"]


def test_bad_cipher_string_fails_at_listener_build():
    from emqx_tpu.broker import Broker as JBroker
    from emqx_tpu.cm import ConnectionManager as JCM
    from emqx_tpu_torch.broker import Broker as PBroker
    from emqx_tpu_torch.cm import ConnectionManager as PCM

    def scenario(P):
        b = PBroker(device="cpu") if P.port else JBroker()
        cm = (PCM if P.port else JCM)(broker=b)
        auth = P.Psk(P.Hooks(), keys={})
        kw = {"device": "cpu"} if P.port else {}
        with pytest.raises(P.M.PskTlsError) as ei:
            P.M.PskTlsListener(b, cm, psk=auth,
                               psk_ciphers="NO-SUCH-CIPHER-FAMILY", **kw)
        with pytest.raises(ValueError):
            P.M.PskTlsListener(b, cm, **kw)
        return str(ei.value).split(":")[0]

    assert both(scenario) == "no PSK ciphers available"


def test_handshake_hard_deadline_drip_feed():
    """A drip-feeding client cannot hold a handshake slot past the
    timeout (slow-loris guard)."""
    async def scenario(P):
        n, lst = await _psk_node(P, {"d": b"k"})
        lst.handshake_timeout = 0.5
        try:
            r, w = await asyncio.open_connection("127.0.0.1", lst.port)
            t0 = asyncio.get_running_loop().time()
            w.write(b"\x16\x03\x03\x40\x00")

            async def drip():
                try:
                    while True:
                        w.write(b"\x00")
                        await w.drain()
                        await asyncio.sleep(0.05)
                except (ConnectionError, OSError):
                    pass

            task = asyncio.ensure_future(drip())
            await asyncio.wait_for(r.read(), 5)
            elapsed = asyncio.get_running_loop().time() - t0
            task.cancel()
            w.close()
            return 0.3 <= elapsed < 4.0
        finally:
            await n.stop()

    assert both_async(scenario) is True


def test_bad_key_gets_tls_alert_not_bare_close():
    async def scenario(P):
        n, lst = await _psk_node(P, {"d": b"right"})
        try:
            with pytest.raises(P.M.PskTlsError) as ei:
                await P.M.open_psk_connection("127.0.0.1", lst.port,
                                              "d", b"wrong")
            text = str(ei.value).lower()
            return any(w in text for w in ("handshake", "alert", "failed"))
        finally:
            await n.stop()

    assert both_async(scenario) is True


def test_concurrent_psk_handshakes_and_traffic():
    """Twenty simultaneous handshakes on one shared SSL_CTX, then a
    fan-out delivery to all of them."""
    async def scenario(P):
        n, lst = await _psk_node(P, {f"d{i}": f"k{i}".encode()
                                     for i in range(20)})
        try:
            async def one(i):
                r, w = await P.M.open_psk_connection(
                    "127.0.0.1", lst.port, f"d{i}", f"k{i}".encode())
                c = TestClient(f"c{i}", version=4)
                await c.connect_over(r, w)
                await c.subscribe("st/all")
                return c, w

            clients = await asyncio.gather(*(one(i) for i in range(20)))
            await clients[0][0].publish("st/all", b"fanout", qos=1)
            got = []
            for c, _ in clients:
                m = await asyncio.wait_for(c.recv(), 10)
                got.append(m.payload)
            conns = lst.current_connections()
            for _, w in clients:
                w.close()
            return got, conns
        finally:
            await n.stop()

    assert both_async(scenario) == ([b"fanout"] * 20, 20)


def test_without_libssl_the_listener_refuses_to_start(monkeypatch):
    """No loadable ``libssl``: ``add_tls_listener`` with a PSK-only
    option set raises the JAX package's error, and no listener (least
    of all a plain-TCP one) is added."""
    def scenario(P):
        monkeypatch.setattr(P.M, "available", lambda: False)
        n = P.Node()
        auth = P.Psk(n.hooks, keys={"d": b"k"})
        with pytest.raises(RuntimeError) as ei:
            n.add_tls_listener(port=0, tls_options=P.TlsOptions(psk=auth))
        return str(ei.value), n.listeners

    assert both(scenario) == (
        "native TLS-PSK needs libssl; none loadable", [])


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_flush_to_a_psk_connection_arms_the_slow_consumer_check(pkg):
    """Fault C.8 (in the reference too): a delivery flushed into a
    PSK-TLS connection from another connection's publish
    (``Connection._flush_deliver``) reads ``writer.transport`` for the
    slow-consumer check, which the engine's writer lacks in the JAX
    package: the flush raises ``AttributeError`` into the loop's
    handler after its packets went out. The port's writer exposes the
    socket's transport: the same flush raises nothing."""
    P = {"jax": JAX, "port": PORT}[pkg]

    async def scenario():
        errors = []
        loop = asyncio.get_running_loop()
        loop.set_exception_handler(
            lambda _l, ctx: errors.append(repr(ctx.get("exception"))))
        n, lst = await _psk_node(P, {"sub": b"k1", "pub": b"k2"})
        try:
            clients = []
            for cid, key in (("sub", b"k1"), ("pub", b"k2")):
                r, w = await P.M.open_psk_connection(
                    "127.0.0.1", lst.port, cid, key)
                c = TestClient(cid, version=4)
                await c.connect_over(r, w)
                clients.append((c, w))
            await clients[0][0].subscribe("c8/t", qos=1)
            await clients[1][0].publish("c8/t", b"x", qos=1)
            m = await asyncio.wait_for(clients[0][0].recv(), 10)
            await asyncio.sleep(0.05)
            for _c, w in clients:
                w.close()
            return m.payload, errors
        finally:
            await n.stop()

    payload, errors = asyncio.run(scenario())
    assert payload == b"x"
    if pkg == "jax":
        assert any("has no attribute 'transport'" in e for e in errors)
    else:
        assert not any("transport" in e for e in errors), errors
