"""The port's TLS and WSS listeners (``emqx_tpu_torch.tls``,
``Node.add_tls_listener``, ``Node.add_wss_listener``) against the JAX
package's, case for case with ``tests/test_tls.py``.

Each socket case runs on a JAX ``Node(boot_listeners=False)`` and then
on a port ``Node(device="cpu", boot_listeners=False)``, over loopback
with a per-module certificate chain from ``tests/certs.py``; what the
clients observe (CONNACK codes, delivered payloads, the certificate's
subject in the channel, handshake failures) must be equal. The
committed test certificates under ``emqx_tpu_torch/etc/certs/`` (what
``chip_smoke.py`` reads) load into ``make_server_context`` and are
valid until past 2040.
"""

import asyncio
import datetime
import os
import ssl

import pytest

from certs import generate_cert_chain
from emqx_tpu.mqtt.packet import Connack, Publish, Suback, Subscribe
from emqx_tpu.node import Node as JNode
from emqx_tpu.tls import TlsOptions as JTlsOptions
from emqx_tpu.tls import make_client_context as j_client_ctx
from emqx_tpu.tls import make_server_context as j_server_ctx
from emqx_tpu_torch.node import Node as PNode
from emqx_tpu_torch.tls import TlsOptions as PTlsOptions
from emqx_tpu_torch.tls import make_client_context as p_client_ctx
from emqx_tpu_torch.tls import make_server_context as p_server_ctx
from mqtt_client import TestClient

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CERTS = os.path.join(ROOT, "emqx_tpu_torch", "etc", "certs")


class _Pkg:
    def __init__(self, **kw) -> None:
        self.__dict__.update(kw)


JAX = _Pkg(name="jax", port=False, TlsOptions=JTlsOptions,
           client_ctx=j_client_ctx, server_ctx=j_server_ctx,
           Node=lambda **kw: JNode(boot_listeners=False, **kw))
PORT = _Pkg(name="port", port=True, TlsOptions=PTlsOptions,
            client_ctx=p_client_ctx, server_ctx=p_server_ctx,
            Node=lambda **kw: PNode(device="cpu", boot_listeners=False,
                                    **kw))


def both(scenario, *args):
    """``scenario(pkg, *args)`` on the JAX package, then on the port,
    each in a fresh event loop: the observations must be equal."""
    want = asyncio.run(scenario(JAX, *args))
    got = asyncio.run(scenario(PORT, *args))
    assert got == want
    return got


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    return generate_cert_chain(str(tmp_path_factory.mktemp("certs")))


async def _tls_node(P, certs, **tls_kw):
    n = P.Node()
    n.add_tls_listener(port=0, tls_options=P.TlsOptions(
        certfile=certs["cert"], keyfile=certs["key"],
        cacertfile=certs["cacert"], **tls_kw))
    await n.start()
    return n, n.listeners[0].port


def test_tls_connect_publish_roundtrip(certs):
    """One-way TLS: a subscribe/publish/deliver round trip over the
    encrypted socket."""
    async def scenario(P):
        n, port = await _tls_node(P, certs)
        ctx = P.client_ctx(cacertfile=certs["cacert"])
        try:
            sub, pub = TestClient("tls-sub"), TestClient("tls-pub")
            ack = await sub.connect(host="127.0.0.1", port=port, ssl=ctx)
            assert isinstance(ack, Connack)
            await pub.connect(host="127.0.0.1", port=port, ssl=ctx)
            await sub.subscribe("secure/t", qos=1)
            await pub.publish("secure/t", b"over-tls", qos=1)
            msg = await asyncio.wait_for(sub.inbox.get(), 5.0)
            assert isinstance(msg, Publish)
            tls = n.listeners[0].ssl_context is not None
            await sub.disconnect()
            await pub.disconnect()
            return ack.reason_code, msg.topic, msg.payload, msg.qos, tls
        finally:
            await n.stop()

    assert both(scenario) == (0, "secure/t", b"over-tls", 1, True)


def test_tls_two_way_cert(certs):
    """verify_peer + fail_if_no_peer_cert: the CA-signed client
    connects and its certificate lands in the channel; a client
    without one is refused in the handshake."""
    async def scenario(P):
        n, port = await _tls_node(
            P, certs, verify="verify_peer", fail_if_no_peer_cert=True)
        try:
            good = TestClient("mutual-ok")
            ctx = P.client_ctx(
                cacertfile=certs["cacert"],
                certfile=certs["client_cert"], keyfile=certs["client_key"])
            ack = await good.connect(host="127.0.0.1", port=port, ssl=ctx)
            [chan] = [c.channel for c in n.listeners[0]._conns]
            assert chan.peercert, "peer certificate not captured"
            subject = dict(x for rdn in chan.peercert["subject"]
                           for x in rdn)
            await good.disconnect()
            bare = P.client_ctx(cacertfile=certs["cacert"])
            bare.maximum_version = ssl.TLSVersion.TLSv1_2
            with pytest.raises((ssl.SSLError, ConnectionError)) as ei:
                await TestClient("mutual-no-cert").connect(
                    host="127.0.0.1", port=port, ssl=bare)
            return ack.reason_code, subject["commonName"], \
                isinstance(ei.value, ssl.SSLError)
        finally:
            await n.stop()

    assert both(scenario)[:2] == (0, "test-client")


def test_tls_rejects_untrusted_server(certs, tmp_path):
    """A client trusting another CA refuses the handshake: the
    listener serves the configured chain."""
    other = generate_cert_chain(str(tmp_path))

    async def scenario(P):
        n, port = await _tls_node(P, certs)
        try:
            ctx = P.client_ctx(cacertfile=other["cacert"])
            with pytest.raises(ssl.SSLError) as ei:
                await TestClient("wrong-ca").connect(
                    host="127.0.0.1", port=port, ssl=ctx)
            return ei.value.reason
        finally:
            await n.stop()

    assert both(scenario) == "CERTIFICATE_VERIFY_FAILED"


def test_wss_roundtrip(certs):
    """WSS: MQTT over WebSocket over TLS (reference https:wss)."""
    from test_ws import WsTestClient

    async def scenario(P):
        n = P.Node()
        n.add_wss_listener(port=0, tls_options=P.TlsOptions(
            certfile=certs["cert"], keyfile=certs["key"]))
        await n.start()
        port = n.listeners[0].port
        ctx = P.client_ctx(cacertfile=certs["cacert"])
        try:
            c = WsTestClient("wss-c1")
            ack = await c.connect(port, ssl=ctx)
            await c.send_mqtt(Subscribe(
                packet_id=1, topic_filters=[("wss/t", {"qos": 0})]))
            sa = await asyncio.wait_for(c.acks.get(), 5.0)
            assert isinstance(sa, Suback)
            await c.send_mqtt(Publish(topic="wss/t",
                                      payload=b"wss-payload"))
            msg = await asyncio.wait_for(c.inbox.get(), 5.0)
            await c.close()
            return ack.reason_code, sa.reason_codes, msg.payload, \
                n.listeners[0].name
        finally:
            await n.stop()

    assert both(scenario) == (0, [0], b"wss-payload", "wss:default")


def test_tls_options_context_shape(certs):
    """Context construction honours verify, fail_if_no_peer_cert and
    the minimum version without a live socket; configure-time errors
    raise alike."""
    def shape(P):
        ctx = P.server_ctx(P.TlsOptions(
            certfile=certs["cert"], keyfile=certs["key"],
            cacertfile=certs["cacert"], verify="verify_peer",
            fail_if_no_peer_cert=True, tls_version="tlsv1.3"))
        lax = P.server_ctx(P.TlsOptions(
            certfile=certs["cert"], keyfile=certs["key"],
            verify="verify_none"))
        errors = []
        for bad in (dict(), dict(certfile=certs["cert"],
                                 keyfile=certs["key"], verify="verifyPeer"),
                    dict(certfile=certs["cert"], keyfile=certs["key"],
                         verify="verify_peer")):
            with pytest.raises(ValueError) as ei:
                P.server_ctx(P.TlsOptions(**bad))
            errors.append(str(ei.value))
        return (ctx.verify_mode, ctx.minimum_version, lax.verify_mode,
                errors)

    want, got = shape(JAX), shape(PORT)
    assert got == want
    assert got[0] == ssl.CERT_REQUIRED
    assert got[1] == ssl.TLSVersion.TLSv1_3
    assert got[2] == ssl.CERT_NONE


def test_psk_seam_wiring(certs):
    """The PSK resolver through the hook chain (src/emqx_psk.erl:31);
    a context with a certificate and a PSK store still builds."""
    from emqx_tpu.hooks import Hooks as JHooks
    from emqx_tpu.psk import PskAuth as JPsk
    from emqx_tpu_torch.hooks import Hooks as PHooks
    from emqx_tpu_torch.psk import HOOKPOINT
    from emqx_tpu_torch.psk import PskAuth as PPsk

    def scenario(P):
        Hooks, Psk = (PHooks, PPsk) if P.port else (JHooks, JPsk)
        hooks = Hooks()
        psk = Psk(hooks, {"dev1": b"sekrit"})
        ctx = P.server_ctx(P.TlsOptions(
            certfile=certs["cert"], keyfile=certs["key"], psk=psk))
        assert isinstance(ctx, ssl.SSLContext)
        psk.add("dev2", b"two")
        psk.remove("dev1")
        return [psk.lookup(i) for i in ("dev1", "dev2", "nobody")]

    assert both_sync(scenario) == [None, b"two", None]
    assert HOOKPOINT == "tls_handshake.psk_lookup"


def both_sync(scenario):
    want, got = scenario(JAX), scenario(PORT)
    assert got == want
    return got


def test_committed_certificates_serve_until_2040():
    """The certificates ``chip_smoke.py`` reads: the server pair loads
    into ``make_server_context``, the client pair into a client
    context, and every one is valid from before now to past 2040."""
    from cryptography import x509

    paths = {name: os.path.join(CERTS, f"{name}.pem")
             for name in ("cacert", "cert", "key", "client-cert",
                          "client-key")}
    assert all(os.path.exists(p) for p in paths.values())
    ctx = p_server_ctx(PTlsOptions(
        certfile=paths["cert"], keyfile=paths["key"],
        cacertfile=paths["cacert"], verify="verify_peer"))
    assert ctx.verify_mode == ssl.CERT_OPTIONAL
    p_client_ctx(cacertfile=paths["cacert"], certfile=paths["client-cert"],
                 keyfile=paths["client-key"])
    horizon = datetime.datetime(2040, 1, 1, tzinfo=datetime.timezone.utc)
    now = datetime.datetime.now(datetime.timezone.utc)
    for name in ("cacert", "cert", "client-cert"):
        cert = x509.load_pem_x509_certificate(open(paths[name], "rb").read())
        assert cert.not_valid_before_utc <= now
        assert cert.not_valid_after_utc > horizon, name
    srv = x509.load_pem_x509_certificate(open(paths["cert"], "rb").read())
    san = srv.extensions.get_extension_for_class(
        x509.SubjectAlternativeName).value
    assert "localhost" in san.get_values_for_type(x509.DNSName)
    assert [str(a) for a in san.get_values_for_type(x509.IPAddress)] \
        == ["127.0.0.1"]


def test_committed_certificates_serve_a_two_way_handshake():
    """The committed chain end to end on a port node: two-way TLS with
    ``peer_cert_as_username="cn"``."""
    paths = {name: os.path.join(CERTS, f"{name}.pem")
             for name in ("cacert", "cert", "key", "client-cert",
                          "client-key")}

    async def main():
        n = PORT.Node()
        lst = n.add_tls_listener(port=0, tls_options=PTlsOptions(
            certfile=paths["cert"], keyfile=paths["key"],
            cacertfile=paths["cacert"], verify="verify_peer",
            fail_if_no_peer_cert=True), peer_cert_as_username="cn")
        await n.start()
        try:
            ctx = p_client_ctx(cacertfile=paths["cacert"],
                               certfile=paths["client-cert"],
                               keyfile=paths["client-key"])
            c = TestClient("committed")
            ack = await c.connect(host="localhost", port=lst.port, ssl=ctx)
            assert ack.reason_code == 0
            assert n.cm.lookup_channel("committed").username \
                == "test-client"
            await c.disconnect()
        finally:
            await n.stop()

    asyncio.run(main())
