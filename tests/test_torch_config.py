"""The port's config-file layer (``emqx_tpu_torch.config``) and its
command line (``python -m emqx_tpu_torch``) against the JAX package's.

The same TOML goes through both packages' ``load_config`` /
``parse_config``: the repo's own ``etc/emqx_tpu.toml`` (with its
``etc/acl.conf``) and every file of tests/test_config.py parse into equal
``dataclasses.asdict`` trees, and every malformed file fails with the
same ``ConfigError`` text. Booted with ``build_node(cfg, device="cpu")``
the port's node carries what the file says (zones, listeners, modules
and the parsed ACL rules equal the JAX node's, ``[node] loops`` a
``LoopGroup``, ``[node] frame`` the configured parser), serves MQTT
from the file's listeners (the zone's packet cap bites; a TLS listener
on the committed test certificates), clusters from ``[node]
cluster_port``, and rebinds its listeners on a zone reload. ``python -m
emqx_tpu_torch --device cpu --config`` boots a process that serves and
exits 0 on SIGTERM; without ``--device`` on a host with no CUDA it
raises at boot and never listens. Every wait is bounded.
"""

import asyncio
import contextlib
import dataclasses
import os
import signal
import sys
from pathlib import Path

import pytest
import torch

from emqx_tpu import config as jconfig
from emqx_tpu_torch import config as pconfig
from emqx_tpu_torch import zone as pzone
from emqx_tpu_torch.mqtt import constants as C

from mqtt_client import TestClient

REPO = Path(__file__).resolve().parents[1]
EXAMPLE = str(REPO / "etc" / "emqx_tpu.toml")
CERTS = REPO / "emqx_tpu_torch" / "etc" / "certs"
LIMIT = 60.0


@pytest.fixture(autouse=True)
def _port_zone_isolation():
    """The port's zone registry is process-global too: a test that
    boots from a file must not leak its zones into later tests."""
    saved = dict(pzone._zones)
    yield
    pzone._zones.clear()
    pzone._zones.update(saved)


def _write(tmp_path, text, name="emqx_tpu.toml"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def tree(cfg):
    return dataclasses.asdict(cfg)


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT))


def test_example_config_parses_equal():
    j = jconfig.load_config(EXAMPLE)
    p = pconfig.load_config(EXAMPLE)
    assert tree(p) == tree(j)
    assert p.zones["external"].max_packet_size == 65536
    assert len(p.listeners) == 2
    assert p.base_dir == str(REPO / "etc")


def test_example_config_boots_modules_equal():
    """The example file's ``[modules]`` (the retainer, delayed, the
    file ACL over ``etc/acl.conf``) load in both packages, in the same
    order, with the same env and the same parsed rules."""
    jn = jconfig.boot_from_file(EXAMPLE)
    pn = pconfig.boot_from_file(EXAMPLE, device="cpu")
    assert pn.modules.loaded() == jn.modules.loaded() == [
        "retainer", "delayed", "acl_internal"]
    assert pn.modules._loaded["acl_internal"].rules == \
        jn.modules._loaded["acl_internal"].rules
    assert len(pn.modules._loaded["acl_internal"].rules) == 4
    assert pn.modules._loaded["retainer"].max_retained == \
        jn.modules._loaded["retainer"].max_retained == 1000000
    assert [(lst.name, lst.host, lst.port, lst.zone.name)
            for lst in pn.listeners] == \
        [(lst.name, lst.host, lst.port, lst.zone.name)
         for lst in jn.listeners]
    assert pn.device.type == "cpu"
    assert tree(pn.boot_config) == tree(jn.boot_config)


PARSE_ZONES = """
[node]
name = "n1@local"
sys_interval = 7.5

[zones.default]
max_packet_size = 2048
idle_timeout = 3.0

[zones.edge]
max_inflight = 4
ratelimit_bytes_in = [1000, 2000]

[[listeners]]
type = "tcp"
port = 0
zone = "edge"

[[listeners]]
type = "ws"
port = 0
path = "/mq"
"""


def test_parse_zones_listeners(tmp_path):
    path = _write(tmp_path, PARSE_ZONES)
    cfg = pconfig.load_config(path)
    assert tree(cfg) == tree(jconfig.load_config(path))
    assert cfg.name == "n1@local"
    assert cfg.sys_interval == 7.5
    assert cfg.zones["default"].max_packet_size == 2048
    assert cfg.zones["edge"].max_inflight == 4
    assert cfg.zones["edge"].ratelimit_bytes_in == (1000, 2000)
    assert [lc.type for lc in cfg.listeners] == ["tcp", "ws"]
    assert cfg.listeners[0].zone == "edge"
    assert cfg.listeners[1].path == "/mq"


#: every section with a value that parses: each package's tree equal
SECTIONS = [
    {"node": {"loops": 4, "frame": "native", "cookie": "c",
              "cluster_port": 0, "load_default_modules": True}},
    {"matcher": {"match_cache": False, "cache_partitions": 8,
                 "delta_max_filters": 100}},
    {"telemetry": {"enabled": False, "slow_threshold_ms": 5}},
    {"tracing": {"sample_rate": 0.5, "ring_size": 64}},
    {"dispatch": {"planner": False, "preserialize": False}},
    {"overload": {"lag_warn_ms": 300, "breaker_failures": 2}},
    {"faults": {"enabled": True, "seed": 3,
                "arm": ["device.walk:raise:2"]}},
    {"durability": {"enabled": True, "dir": "d", "wal_shards": 0,
                    "fsync": False}},
    {"cluster": {"detector": False}},
    {"drain": {"on_sigterm": True, "sigterm_grace_s": 5}},
    {"zones": {"z": {"keepalive_backoff": 0.5, "enable_stats": False,
                     "acl_deny_action": "disconnect",
                     "force_gc_policy": [10, 1024]}}},
    {"listeners": [{"type": "tcp", "port": 1, "access":
                    ["allow 127.0.0.1", "deny all"],
                    "max_conn_rate": 10.0, "proxy_protocol": True}]},
    {"listeners": [{"type": "ssl", "port": 1, "certfile": "c.pem",
                    "keyfile": "k.pem", "verify": "verify_peer",
                    "peer_cert_as_username": "cn"}]},
    {"modules": {"retainer": {"max_retained": 7}, "delayed": {}}},
]


@pytest.mark.parametrize("raw", SECTIONS, ids=lambda r: next(iter(r)))
def test_sections_parse_equal(raw):
    assert tree(pconfig.parse_config(raw)) == \
        tree(jconfig.parse_config(raw))


#: malformed configs: both packages raise ConfigError with equal text
BAD = [
    {"zones": {"default": {"max_paket_size": 1}}},
    {"node": {"naem": "x"}},
    {"node": {"frame": "rust"}},
    {"listeners": [{"type": "udp", "port": 1}]},
    {"listeners": [{"type": "ssl", "port": 1}]},
    {"listeners": [{"type": "tcp", "port": 1, "prot": 2}]},
    {"listeners": [{"type": "tcp"}]},
    {"zones": {"external": {"idle_timeout": 1.0}},
     "listeners": [{"type": "tcp", "port": 1, "zone": "exernal"}]},
    {"listeners": [{"type": "tcp", "port": 1, "certfile": "x.pem"}]},
    {"listeners": [{"type": "ws", "port": 1, "access": ["allow all"]}]},
    {"listeners": [{"type": "tcp", "port": 1, "access": ["maybe all"]}]},
    {"listeners": [{"type": "ws", "port": 1, "max_conn_rate": 5.0}]},
    {"listeners": [{"type": "tcp", "port": 1,
                    "proxy_protocol_timeout": 0}]},
    {"listeners": [{"type": "ws", "port": 1, "proxy_protocol": True}]},
    {"listeners": [{"type": "tcp", "port": 1,
                    "peer_cert_as_username": "cn"}]},
    {"listeners": [{"type": "ssl", "port": 1, "certfile": "c",
                    "peer_cert_as_username": "cn"}]},
    {"zones": {"z": {"acl_nomatch": "maybe"}}},
    {"matcher": {"match_cach": True}},
    {"matcher": {"delta": 1}},
    {"matcher": {"cache_partitions": 3}},
    {"matcher": []},
    {"telemetry": {"ring_size": 0}},
    {"tracing": {"sample_rate": 2.0}},
    {"dispatch": {"planner": "yes"}},
    {"overload": {"enabled": "no"}},
    {"faults": {"arm": ["no.such.point"]}},
    {"faults": {"seed": True}},
    {"durability": {"wal_shards": -1}},
    {"durability": {"dir": 3}},
    {"cluster": {"detectr": False}},
    {"drain": {"sigterm_grace_s": 0}},
    {"modules": {"no_such_module": {}}},
    {"modules": {"retainer": 3}},
]


@pytest.mark.parametrize("raw", BAD, ids=[str(i) for i in range(len(BAD))])
def test_malformed_fails_with_the_same_text(raw):
    with pytest.raises(jconfig.ConfigError) as je:
        jconfig.parse_config(raw)
    with pytest.raises(pconfig.ConfigError) as pe:
        pconfig.parse_config(raw)
    assert str(pe.value) == str(je.value)


def test_node_section_builds_what_it_says(tmp_path):
    """``[node] loops`` builds a LoopGroup of that size, ``frame`` is
    the configured parser in both packages (the port has no environment
    switch over it), ``name`` and ``sys_interval`` reach the node."""
    path = _write(tmp_path, '[node]\nname = "lp@x"\nloops = 3\n'
                            'frame = "native"\nsys_interval = 9.0\n')
    pn = pconfig.boot_from_file(path, device="cpu")
    jn = jconfig.boot_from_file(path)
    assert pn.loop_group.n == jn.loop_group.n == 3
    assert pn.frame == jn.frame == "native"
    assert pn.name == jn.name == "lp@x"
    assert pn.sys.interval == jn.sys.interval == 9.0
    one = pconfig.build_node(pconfig.parse_config({}), device="cpu")
    assert one.loop_group is None and one.frame == "py"


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="holds the no-CUDA refusal; this host has CUDA")
def test_build_node_defaults_to_cuda_and_raises_without_it():
    cfg = pconfig.parse_config({"node": {"loops": 2}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pconfig.build_node(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pconfig.boot_from_file(EXAMPLE)


def test_boot_node_from_file(tmp_path):
    """The node serves from the file: the tcp listener's zone caps the
    packet size (an oversized PUBLISH drops the connection), and a TLS
    listener comes up on the committed test certificates."""
    path = _write(tmp_path, f"""
[node]
name = "cfg@test"

[zones.default]
max_packet_size = 512

[zones.tiny]
max_packet_size = 128

[[listeners]]
type = "tcp"
port = 0
zone = "tiny"

[[listeners]]
type = "ssl"
port = 0
certfile = "{CERTS / 'cert.pem'}"
keyfile = "{CERTS / 'key.pem'}"
""")

    async def main():
        from emqx_tpu_torch.tls import make_client_context

        node = pconfig.boot_from_file(path, device="cpu")
        assert node.name == "cfg@test"
        await node.start()
        try:
            tcp, tls = node.listeners
            assert tcp.zone.name == "tiny"
            c = TestClient("cfg-c1", version=C.MQTT_V4)
            ack = await c.connect(port=tcp.port)
            assert ack.reason_code == 0
            await c.subscribe("t/1")
            with contextlib.suppress(ConnectionError,
                                     asyncio.TimeoutError):
                await c.publish("t/1", b"x" * 4096, qos=1, timeout=2.0)
            for _ in range(100):
                if node.cm.lookup_channel("cfg-c1") is None:
                    break
                await asyncio.sleep(0.02)
            assert node.cm.lookup_channel("cfg-c1") is None
            ctx = make_client_context(cacertfile=str(CERTS / "cacert.pem"))
            s = TestClient("cfg-tls")
            await s.connect(port=tls.port, ssl=ctx)
            await s.subscribe("t/2")
            await s.publish("t/2", b"ok", qos=0)
            msg = await asyncio.wait_for(s.inbox.get(), 5)
            assert msg.payload == b"ok"
            await s.disconnect()
        finally:
            await node.stop()

    run(main())


def _cluster_files(tmp_path, names, cookie):
    out = []
    for i, name in enumerate(names):
        out.append(_write(tmp_path, f"""
[node]
name = "{name}"
cookie = "{cookie}"
cluster_port = 0

[[listeners]]
type = "tcp"
port = 0
""", name=f"n{i}.toml"))
    return out


def test_cluster_from_config(tmp_path):
    """Two nodes booted from TOML files cluster over the configured
    socket transport, replicate a route and forward a publish."""
    from emqx_tpu_torch.types import Message

    a, b = _cluster_files(tmp_path, ["cfg1@local", "cfg2@local"],
                          "toml-cookie")

    async def main():
        n1 = pconfig.boot_from_file(a, device="cpu")
        n2 = pconfig.boot_from_file(b, device="cpu")
        await n1.start()
        await n2.start()
        try:
            assert n1.cluster is not None and n2.cluster is not None
            n1.cluster.join_remote("127.0.0.1", n2.cluster.transport.port)
            assert sorted(n1.cluster.members) == sorted(
                n2.cluster.members) == ["cfg1@local", "cfg2@local"]

            class Rec:
                def __init__(self):
                    self.got = asyncio.Queue()

                def deliver(self, topic, msg):
                    self.got.put_nowait(msg.payload)

            r = Rec()
            n2.broker.subscribe(r, "cfg/+")
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 20
            while not n1.router.has_dest("cfg/+", "cfg2@local"):
                assert loop.time() < deadline, "route never replicated"
                await asyncio.sleep(0.1)
            n1.broker.publish(Message(topic="cfg/x", payload=b"via-toml"))
            assert await asyncio.wait_for(r.got.get(), 20) == b"via-toml"
        finally:
            await n1.stop()
            await n2.stop()

    run(main())


def test_ctl_cluster_commands(tmp_path):
    """``ctl cluster`` status, join and leave on two config-booted
    nodes."""
    a, b = _cluster_files(tmp_path, ["ctl1@x", "ctl2@x"], "ctl-c")

    async def main():
        n1 = pconfig.boot_from_file(a, device="cpu")
        n2 = pconfig.boot_from_file(b, device="cpu")
        await n1.start()
        await n2.start()
        try:
            assert '"ctl1@x"' in n1.ctl.run(["cluster", "status"])
            port2 = n2.cluster.transport.port
            out = n1.ctl.run(["cluster", "join", f"127.0.0.1:{port2}"])
            # on a running loop the join goes to a worker thread
            assert "background" in out
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 20
            while sorted(n2.cluster.members) != ["ctl1@x", "ctl2@x"]:
                assert loop.time() < deadline
                await asyncio.sleep(0.1)
            assert "left" in n1.ctl.run(["cluster", "leave"])
            assert n1.cluster.members == ["ctl1@x"]
            deadline = loop.time() + 10
            while "ctl1@x" in n2.cluster.members:
                assert loop.time() < deadline
                await asyncio.sleep(0.1)
        finally:
            await n1.stop()
            await n2.stop()

    run(main())


def test_modules_section_loads_and_validates():
    raw = {"modules": {"retainer": {"max_retained": 7}, "delayed": {}}}
    n = pconfig.build_node(pconfig.parse_config(raw), device="cpu")
    jn = jconfig.build_node(jconfig.parse_config(raw))
    assert sorted(n.modules.loaded()) == sorted(jn.modules.loaded()) == [
        "delayed", "retainer"]
    assert n.broker.delayed is n.modules._loaded["delayed"]
    assert n.modules._loaded["retainer"].max_retained == 7
    with pytest.raises(pconfig.ConfigError, match="not found"):
        pconfig.build_node(pconfig.parse_config(
            {"modules": {"acl_internal": {"file": "/nonexistent.conf"}}}),
            device="cpu")


def test_runtime_zone_reload_rebinds_listeners(tmp_path):
    """``ctl reload <file>`` republishes the zones and rebinds the
    running listeners: connections accepted after the reload get the
    new limits, existing ones keep their snapshot; a broken file is
    rejected whole; a zone the file no longer has is reported stale."""
    cfg = tmp_path / "z.toml"
    body = ('[zones.hot]\nmax_packet_size = {}\n\n'
            '[[listeners]]\ntype = "tcp"\nport = 0\nzone = "hot"\n')
    cfg.write_text(body.format(1024))

    async def main():
        node = pconfig.build_node(pconfig.load_config(str(cfg)),
                                  device="cpu")
        await node.start()
        try:
            lst = node.listeners[0]
            assert lst.zone.max_packet_size == 1024
            old = TestClient("old")
            await old.connect(port=lst.port)
            cfg.write_text(body.format(2048))
            out = node.ctl.run(["reload", str(cfg)])
            assert "hot" in out and "rebound" in out
            assert lst.zone.max_packet_size == 2048
            assert pzone.get_zone("hot").max_packet_size == 2048
            new = TestClient("new")
            await new.connect(port=lst.port)
            assert new.connack.reason_code == 0
            cfg.write_text('[zones.hot]\nno_such_setting = 1\n')
            out = node.ctl.run(["reload", str(cfg)])
            assert "error" in out.lower()
            assert pzone.get_zone("hot").max_packet_size == 2048
            cfg.write_text(
                '[zones.other]\nmax_inflight = 5\n\n'
                '[[listeners]]\ntype = "tcp"\nport = 0\nzone = "other"\n')
            out = node.ctl.run(["reload", str(cfg)])
            assert "stale" in out and "hot" in out
            old.writer.close()
            new.writer.close()
        finally:
            await node.stop()

    run(main())


def test_reload_zones_equal_report(tmp_path):
    """``reload_zones`` (the zones-only reload) reports the same in both
    packages on the same file and a node booted from it."""
    p = _write(tmp_path, PARSE_ZONES)
    pn = pconfig.build_node(pconfig.load_config(p), device="cpu")
    jn = jconfig.build_node(jconfig.load_config(p))
    assert pconfig.reload_zones(p, pn) == jconfig.reload_zones(p, jn)


async def _read_port(proc):
    while True:
        line = await asyncio.wait_for(proc.stdout.readline(), 60)
        assert line, "the process exited before listening"
        if b"listening:" in line:
            return int(line.rsplit(b":", 1)[1])


def test_python_m_emqx_tpu_torch_boot_and_sigterm(tmp_path):
    """``python -m emqx_tpu_torch --device cpu --config`` boots a broker
    process from the file, serves MQTT, and exits 0 on SIGTERM."""
    cfg = _write(tmp_path, '[node]\nname = "main-test@127.0.0.1"\n'
                           'loops = 2\n\n'
                           '[[listeners]]\ntype = "tcp"\nport = 0\n',
                 name="n.toml")

    async def main():
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "emqx_tpu_torch", "--device", "cpu",
            "--config", cfg, stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.STDOUT, cwd=str(REPO))
        try:
            port = await _read_port(proc)
            c = TestClient("m-boot")
            await c.connect(port=port)
            await c.subscribe("m/t")
            await c.publish("m/t", b"via-module", qos=1)
            assert (await c.recv(10)).payload == b"via-module"
            c.writer.close()
            proc.send_signal(signal.SIGTERM)
            assert await asyncio.wait_for(proc.wait(), 20) == 0
        finally:
            if proc.returncode is None:
                proc.kill()
                await proc.wait()

    run(main())


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="holds the no-CUDA refusal; this host has CUDA")
def test_python_m_emqx_tpu_torch_without_cuda_raises(tmp_path):
    """Without ``--device`` the node is on ``cuda``: on a host with no
    CUDA the process raises at boot and never listens."""
    import subprocess

    cfg = _write(tmp_path, '[[listeners]]\ntype = "tcp"\nport = 0\n',
                 name="n.toml")
    r = subprocess.run([sys.executable, "-m", "emqx_tpu_torch",
                        "--config", cfg], capture_output=True,
                       cwd=str(REPO), timeout=60,
                       env=dict(os.environ))
    assert r.returncode != 0
    assert b"CUDA is not available" in r.stderr
    assert b"listening" not in r.stdout
