"""The port's listener surface against the JAX package's: the esockd
options ``Listener`` takes back (``max_connections``, ``ssl_context``,
``reuse_port``, ``proxy_protocol_timeout``, ``max_conn_rate``,
``peer_cert_as_username``), passed through ``Node.add_listener`` and
``Node.add_tls_listener``, and ``Node.start()`` adding the default
listener exactly when none was added.

The cases follow ``tests/test_listener_access.py`` and
``tests/test_proxy_protocol.py``: each runs on a JAX
``Node(boot_listeners=False)`` and then on a port ``Node(device="cpu",
boot_listeners=False)`` over loopback, every socket on ``port=0``, and
what the clients observe must be equal (the accept-rate burst, which
depends on the clock, is held to the JAX test's bounds on both). The
default-listener case wraps ``add_listener`` so that the default port
is 0: no test binds 1883.
"""

import asyncio
import socket

import pytest

from emqx_tpu.node import Node as JNode
from emqx_tpu.tls import TlsOptions as JTlsOptions
from emqx_tpu.tls import make_client_context as j_client_ctx
from emqx_tpu_torch.connection import Listener
from emqx_tpu_torch.node import Node as PNode
from emqx_tpu_torch.tls import TlsOptions as PTlsOptions
from emqx_tpu_torch.tls import make_client_context as p_client_ctx
from mqtt_client import TestClient


class _Pkg:
    def __init__(self, **kw) -> None:
        self.__dict__.update(kw)


JAX = _Pkg(name="jax", port=False, TlsOptions=JTlsOptions,
           client_ctx=j_client_ctx, NodeCls=JNode,
           Node=lambda **kw: JNode(boot_listeners=False, **kw))
PORT = _Pkg(name="port", port=True, TlsOptions=PTlsOptions,
            client_ctx=p_client_ctx, NodeCls=PNode,
            Node=lambda **kw: PNode(device="cpu", boot_listeners=False,
                                    **kw))


def both(scenario, *args):
    want = asyncio.run(scenario(JAX, *args))
    got = asyncio.run(scenario(PORT, *args))
    assert got == want
    return got


def test_add_listener_passes_the_options_through():
    async def scenario(P):
        n = P.Node()
        a = n.add_listener(port=0, name="tcp:a", max_connections=5,
                           reuse_port=True, proxy_protocol=True,
                           proxy_protocol_timeout=1.5, max_conn_rate=3.0,
                           access_rules=["allow all"])
        b = n.add_listener(port=0, name="tcp:b")
        return [(x.name, x.max_connections, x.reuse_port,
                 x.proxy_protocol, x.proxy_protocol_timeout,
                 x._conn_bucket is not None, x.ssl_context,
                 x.peer_cert_as_username, x.access_rules is not None)
                for x in (a, b)]

    out = both(scenario)
    assert out[1] == ("tcp:b", 1024000, False, False, 3.0, False, None,
                      None, False)


def test_listener_access_denies_socket_peer():
    """tests/test_listener_access.py::
    test_listener_access_denies_socket_peer."""
    async def scenario(P):
        seen = []
        for rules in (["deny 127.0.0.1", "allow all"], ["allow 127.0.0.1"]):
            n = P.Node()
            lst = n.add_listener(port=0, access_rules=rules)
            await n.start()
            try:
                cli = TestClient(f"acc-{len(seen)}")
                try:
                    ack = await cli.connect(port=lst.port, timeout=3)
                    seen.append(ack.reason_code)
                    await cli.disconnect()
                except Exception as e:
                    seen.append(type(e).__name__ != "")
            finally:
                await n.stop()
        return seen

    assert both(scenario) == [True, 0]


def test_max_conn_rate_limits_accept_burst():
    """tests/test_listener_access.py::
    test_max_conn_rate_limits_accept_burst: a burst of 8 against a
    bucket of 2."""
    async def scenario(P):
        n = P.Node()
        lst = n.add_listener(port=0, max_conn_rate=2)
        await n.start()
        try:
            async def attempt(i):
                cli = TestClient(f"rate{i}")
                try:
                    await cli.connect(port=lst.port, timeout=2)
                    return cli
                except Exception:
                    return None

            results = await asyncio.gather(*[attempt(i) for i in range(8)])
            ok = [c for c in results if c is not None]
            assert 1 <= len(ok) <= 4, len(ok)
            assert len(results) - len(ok) >= 4, len(ok)
            for c in ok:
                await c.disconnect()
            return True
        finally:
            await n.stop()

    both(scenario)


def test_max_connections_refuses_the_next_connect():
    async def scenario(P):
        n = P.Node()
        lst = n.add_listener(port=0, max_connections=2)
        await n.start()
        try:
            a, b = TestClient("mc1"), TestClient("mc2")
            seen = [(await a.connect(port=lst.port)).reason_code,
                    (await b.connect(port=lst.port)).reason_code,
                    lst.current_connections()]
            with pytest.raises(Exception):
                await TestClient("mc3").connect(port=lst.port, timeout=2)
            seen.append(lst.current_connections())
            await a.disconnect()
            for _ in range(200):
                if lst.current_connections() < 2:
                    break
                await asyncio.sleep(0.01)
            c = TestClient("mc4")
            seen.append((await c.connect(port=lst.port)).reason_code)
            await b.disconnect()
            await c.disconnect()
            return seen
        finally:
            await n.stop()

    assert both(scenario) == [0, 0, 2, 2, 0]


@pytest.mark.parametrize("mode", ["cn", "dn"])
def test_peer_cert_as_username(tmp_path, mode):
    """tests/test_listener_access.py::test_peer_cert_as_username, with
    both modes: the CONNECT carries no username, the channel's is the
    client certificate's."""
    from certs import generate_cert_chain

    certs = generate_cert_chain(str(tmp_path))

    async def scenario(P):
        n = P.Node()
        lst = n.add_tls_listener(
            port=0, tls_options=P.TlsOptions(
                certfile=certs["cert"], keyfile=certs["key"],
                cacertfile=certs["cacert"], verify="verify_peer",
                fail_if_no_peer_cert=True),
            peer_cert_as_username=mode)
        await n.start()
        try:
            ctx = P.client_ctx(cacertfile=certs["cacert"],
                               certfile=certs["client_cert"],
                               keyfile=certs["client_key"])
            cli = TestClient("certuser")
            ack = await cli.connect(host="127.0.0.1", port=lst.port,
                                    ssl=ctx)
            chan = n.cm.lookup_channel("certuser")
            seen = (ack.reason_code, chan.username,
                    chan.clientinfo["username"],
                    lst.peer_cert_as_username, lst.ssl_context is not None)
            await cli.disconnect()
            return seen
        finally:
            await n.stop()

    want = {"cn": "test-client",
            "dn": "organizationName=emqx_tpu-test,commonName=test-client"}
    assert both(scenario) == (0, want[mode], want[mode], mode, True)


def test_cert_username_of_a_subject():
    from emqx_tpu.channel import cert_username as jcu
    from emqx_tpu_torch.channel import cert_username as pcu

    cases = [({"subject": ((("commonName", "a"),),
                           (("organizationName", "o"),))}, "cn"),
             ({"subject": ((("countryName", "SE"),),
                           (("commonName", "b"),))}, "dn"),
             ({"subject": ((("organizationName", "o"),),)}, "cn"),
             ({}, "dn"), ({"subject": ((("commonName", "c"),),)}, "x")]
    assert [pcu(c, m) for c, m in cases] == [jcu(c, m) for c, m in cases] \
        == ["a", "countryName=SE,commonName=b", None, None, None]


def test_proxy_protocol_end_to_end_with_its_timeout():
    """tests/test_proxy_protocol.py::
    test_listener_end_to_end_proxy_peername, with the listener's
    ``proxy_protocol_timeout`` (a bare client closes within it)."""
    async def scenario(P):
        n = P.Node()
        lst = n.add_listener(port=0, proxy_protocol=True,
                             proxy_protocol_timeout=1.0)
        await n.start()
        try:
            cli = TestClient("pp1", version=4)
            reader, writer = await asyncio.open_connection("127.0.0.1",
                                                           lst.port)
            writer.write(b"PROXY TCP4 198.51.100.23 127.0.0.1 4242 1883\r\n")
            await writer.drain()
            await cli.connect_over(reader, writer)
            peer = n.cm.lookup_channel("pp1").peername
            await cli.disconnect()
            t0 = asyncio.get_running_loop().time()
            r, w = await asyncio.open_connection("127.0.0.1", lst.port)
            closed = await asyncio.wait_for(r.read(), 5)
            took = asyncio.get_running_loop().time() - t0
            w.close()
            return peer, closed, 0.8 <= took < 3.0
        finally:
            await n.stop()

    assert both(scenario) == (("198.51.100.23", 4242), b"", True)


def test_reuse_port_binds_two_listeners_on_one_port():
    if not hasattr(socket, "SO_REUSEPORT"):
        pytest.skip("no SO_REUSEPORT on this platform")

    async def scenario(P):
        n = P.Node()
        a = n.add_listener(port=0, reuse_port=True, name="tcp:a")
        await a.start()
        b = n.add_listener(port=a.port, reuse_port=True, name="tcp:b")
        await b.start()
        try:
            cli = TestClient("rp")
            ack = await cli.connect(port=a.port)
            await cli.disconnect()
            return ack.reason_code, a.port == b.port
        finally:
            await a.stop()
            await b.stop()

    assert both(scenario) == (0, True)


@pytest.mark.parametrize("added", [False, True])
def test_start_adds_the_default_listener_only_when_none_was_added(
        monkeypatch, added):
    """``boot_listeners=True`` (the default): ``start()`` adds the
    default listener (``tcp:default`` on 127.0.0.1, the JAX node's
    ``add_listener()``) exactly when none was added. ``add_listener``
    is wrapped to ``port=0``, so no test binds 1883."""
    async def scenario(P):
        orig = P.NodeCls.add_listener
        calls = []

        def add_listener(self, *a, **kw):
            calls.append(dict(kw))
            kw.setdefault("port", 0)
            return orig(self, *a, **kw)

        monkeypatch.setattr(P.NodeCls, "add_listener", add_listener)
        n = P.NodeCls(**({"device": "cpu"} if P.port else {}))
        assert n.boot_listeners is True
        if added:
            n.add_listener(port=0, name="tcp:mine")
        await n.start()
        try:
            names = [(x.name, x.host) for x in n.listeners]
            cli = TestClient("dflt")
            ack = await cli.connect(port=n.listeners[0].port)
            await cli.disconnect()
            return names, len(calls), ack.reason_code, \
                n.vm_mon.max_count
        finally:
            await n.stop()
            # a second start adds nothing more
            await n.start()
            assert len(n.listeners) == 1
            await n.stop()

    names, calls, rc, cap = both(scenario)
    assert names == [("tcp:mine" if added else "tcp:default",
                      "127.0.0.1")]
    assert calls == 1 and rc == 0 and cap == 1024000


def test_boot_listeners_false_starts_no_listener():
    async def scenario(P):
        n = P.Node()
        await n.start()
        try:
            return n.boot_listeners, n.listeners, json_ctl(n)
        finally:
            await n.stop()

    assert both(scenario) == (False, [], [])


def json_ctl(n):
    import json

    return json.loads(n.ctl.run(["listeners"]))


def test_listener_on_another_device_than_its_broker_is_refused():
    import torch

    n = PORT.Node()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            Listener(n.broker, n.cm, port=0, device="cuda")
    lst = Listener(n.broker, n.cm, port=0, device="cpu",
                   max_connections=3)
    assert lst.max_connections == 3 and lst.ssl_context is None
