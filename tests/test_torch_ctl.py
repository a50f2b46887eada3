"""The port's operations surface (``emqx_tpu_torch.ctl``) against the
JAX package's ``Ctl``, command for command.

A JAX ``Node(boot_listeners=False)`` and a port ``Node(device="cpu",
boot_listeners=False)`` are built from the same seeded state: four
sans-IO clients (CONNECT, then a SUBSCRIBE of two filters), twenty
broker subscriptions, two permanent bans, ten retained messages with
the retainer loaded. Every command of the JAX ``Ctl`` but ``reload``
(held against the JAX package in tests/test_torch_reload.py) runs on
both, and the text must be equal. The exceptions, by name:

  - ``broker``: the version line names the port's ``SYSDESCR``;
  - ``cache`` and ``retained``: the walk variant is ``torch`` (the
    plain walk; ``cuda`` on the card) where the JAX one says ``lax``;
  - ``faults``: the catalogue describes the port's seams of
    ``device.walk`` and ``device.fetch`` (the broker's begin and
    fetch, where the JAX package names the router's compiled
    dispatch);
  - ``telemetry``: stage latencies are this run's clock readings, so
    the numbers are masked and the table compared; the port's table
    has the rows of its own stages (``telemetry.PORT_STAGES``) after
    the JAX package's, and its slow records a ``gc_ms`` tag, left out;
  - ``vm``: the device inventory lists the CUDA cards (none on a CPU
    node) where the JAX one lists its backend's devices, and the
    process counters are this process's at two moments;
  - ``profile``: the port has no ``kernels`` subcommand (the JAX
    package's prints its process-wide timer, whose only records were
    the automaton's rebuilds: the port's are the telemetry's
    ``rebuild`` stage), so the usage line of ``profile`` differs.

``help`` and an unknown command's usage are equal, ``reload``'s line
included.

The ``ctl.run`` cases of ``tests/test_ctl_obs.py`` and of the other
JAX suites that call it (apart from ``test_reload.py`` and
``test_config.py``) run on both packages with their assertions; a
``checkpoint save`` on either node loads into the other with the next
match batch equal; ``Router.match_routes`` is held against the JAX
router's and the TrieOracle.
"""

import asyncio
import json
import logging
import random
import re

import pytest

from emqx_tpu import faults as jfaults
from emqx_tpu.channel import Channel as JChannel
from emqx_tpu.durability import DurabilityConfig as JDurabilityConfig
from emqx_tpu.modules.retainer import RetainerModule as JRet
from emqx_tpu.mqtt import packet as JP
from emqx_tpu.node import Node as JNode
from emqx_tpu.oracle import TrieOracle
from emqx_tpu.router import MatcherConfig as JMatcherConfig
from emqx_tpu.router import Router as JRouter
from emqx_tpu.telemetry import TelemetryConfig as JTelemetryConfig
from emqx_tpu.types import Message as JMessage
from emqx_tpu.types import SubOpts as JSubOpts
from emqx_tpu_torch import faults as pfaults
from emqx_tpu_torch.channel import Channel as PChannel
from emqx_tpu_torch.durability import DurabilityConfig as PDurabilityConfig
from emqx_tpu_torch.modules.retainer import RetainerModule as PRet
from emqx_tpu_torch.node import Node as PNode
from emqx_tpu_torch.router import MatcherConfig as PMatcherConfig
from emqx_tpu_torch.router import Router as PRouter
from emqx_tpu_torch.telemetry import TelemetryConfig as PTelemetryConfig
from emqx_tpu_torch.types import Message as PMessage
from emqx_tpu_torch.types import SubOpts as PSubOpts
from test_torch_channel import to_port

C = JP.C


class _Pkg:
    def __init__(self, **kw) -> None:
        self.__dict__.update(kw)


JAX = _Pkg(name="jax", port=False, Message=JMessage, Channel=JChannel,
           Ret=JRet, SubOpts=JSubOpts, faults=jfaults,
           MatcherConfig=JMatcherConfig, Router=JRouter,
           TelemetryConfig=JTelemetryConfig,
           DurabilityConfig=JDurabilityConfig, logger="emqx_tpu",
           Node=lambda **kw: JNode(boot_listeners=False, **kw))
PORT = _Pkg(name="port", port=True, Message=PMessage, Channel=PChannel,
            Ret=PRet, SubOpts=PSubOpts, faults=pfaults,
            MatcherConfig=PMatcherConfig,
            Router=lambda **kw: PRouter(device="cpu", **kw),
            TelemetryConfig=PTelemetryConfig,
            DurabilityConfig=PDurabilityConfig, logger="emqx_tpu_torch",
            Node=lambda **kw: PNode(device="cpu", boot_listeners=False,
                                    **kw))


def both(scenario, *args):
    """``scenario(pkg, *args)`` on the JAX package, then on the port:
    the two observations must be equal."""
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


async def both_async(scenario, *args):
    want = await scenario(JAX, *args)
    got = await scenario(PORT, *args)
    assert got == want
    return got


class Sink:
    def __init__(self, cid: str = "ctl-sub") -> None:
        self.client_id = cid
        self.inbox = []

    def deliver(self, f, m):
        self.inbox.append((f, m.topic))


def _pkt(P, pkt):
    return to_port(pkt) if P.port else pkt


def seeded(P):
    """The seeded node of the module docstring."""
    n = P.Node()
    n.modules.load(P.Ret)
    rng = random.Random(7)
    chans = []
    for i in range(4):
        ch = P.Channel(n.broker, n.cm, peername=("127.0.0.1", 5000 + i))
        ch.handle_in(_pkt(P, JP.Connect(
            proto_ver=C.MQTT_V4, proto_name="MQTT", client_id=f"c{i}",
            clean_start=(i % 2 == 0), keepalive=30)))
        ch.handle_in(_pkt(P, JP.Subscribe(packet_id=1, topic_filters=[
            (f"t/{i}/+", {"qos": 1}), ("t/#", {"qos": 0})])))
        chans.append(ch)
    for j in range(20):
        n.broker.subscribe(Sink(f"s{j}"),
                           f"a/{rng.randrange(5)}/"
                           f"{rng.choice(['+', 'x', '#'])}")
    n.banned.create("clientid", "evil")
    n.banned.create("username", "mallory", reason="r")
    for k in range(10):
        n.broker.publish(P.Message(topic=f"r/{k}/state",
                                   payload=b"v%d" % k,
                                   flags={"retain": True}))
    return n, chans


@pytest.fixture(scope="module")
def twins():
    return seeded(JAX)[0], seeded(PORT)[0]


_WALK = re.compile(r'"(variant|walk)": "(lax|pallas|torch|cuda)"')
_NUM = re.compile(r"\d+\.\d+")


def _same_but(cmd, want, got):
    """Apply the module docstring's named exceptions."""
    if cmd == ["broker"]:
        from emqx_tpu.sys_topics import SYSDESCR as J
        from emqx_tpu_torch.sys_topics import SYSDESCR as P
        return want.replace(J, "<descr>"), got.replace(P, "<descr>")
    if cmd[0] in ("cache", "retained"):
        assert '"lax"' in want and '"torch"' in got
        return _WALK.sub(r'"\1": "<walk>"', want), \
            _WALK.sub(r'"\1": "<walk>"', got)
    if cmd[0] == "faults":
        w, g = json.loads(want), json.loads(got)
        for d in (w, g):
            for k in ("device.walk", "device.fetch"):
                assert " — " in d["points"][k]
                d["points"][k] = "<the package's seam>"
        return w, g
    if cmd[0] == "telemetry" and cmd[1:] in ([], ["stages"]):
        return _NUM.sub("<ms>", want), _NUM.sub("<ms>", _jax_rows(got))
    return want, got


def _jax_rows(table: str) -> str:
    """The port's ``ctl telemetry`` table without the rows of its own
    stages."""
    from emqx_tpu_torch.telemetry import PORT_STAGES

    return "\n".join(line for line in table.split("\n")
                     if line.split(" ", 1)[0] not in PORT_STAGES)


def _jax_usage(text: str) -> str:
    """The JAX package's usage text as the port's reads: ``profile``
    without ``kernels``."""
    return text.replace("start [dir] | stop | kernels | loops",
                        "start [dir] | stop | loops")


#: every built-in of the JAX ``Ctl`` but ``reload`` (its own file), and
#: their read-only subcommands, on the seeded nodes
COMMANDS = [
    ["status"], ["broker"], ["clients"], ["clients", "list"],
    ["clients", "show", "c0"], ["clients", "show", "nobody"],
    ["clients", "bogus"], ["sessions"], ["topics"], ["subscriptions"],
    ["subscriptions", "show", "c1"], ["subscriptions", "show", "nobody"],
    ["metrics"], ["stats"], ["routes"], ["plugins"], ["plugins", "list"],
    ["banned"], ["banned", "list"], ["checkpoint"], ["drain"],
    ["drain", "status"], ["trace"], ["trace", "list"], ["slow_subs"],
    ["vm"], ["cluster"], ["listeners"], ["log"], ["log", "show"],
    ["telemetry"], ["telemetry", "stages"], ["telemetry", "slow"],
    ["cache"], ["overload"], ["faults"], ["faults", "list"],
    ["durability"], ["retained"], ["profile"], ["profile", "loops"],
    ["profile", "loops", "show"],
]


@pytest.mark.parametrize("cmd", COMMANDS, ids=" ".join)
def test_command_text_equals_jax(twins, cmd):
    j, p = twins
    want, got = j.ctl.run(cmd), p.ctl.run(cmd)
    if cmd == ["vm"]:
        w, g = json.loads(want), json.loads(got)
        assert set(w) == set(g)
        for k in ("memory", "process", "gc"):
            assert set(w[k]) == set(g[k])
        assert len(g["load"]) == 3 and g["python"] == w["python"]
        assert g["cpu_count"] == w["cpu_count"]
        assert g["devices"] == []  # a CPU node lists no card
        return
    w, g = _same_but(cmd, want, got)
    assert g == w, (cmd, want, got)


def test_help_equals_jax_without_reload():
    """The usage text, once without ``reload``; the port now has the
    command, so the text equals the JAX package's whole."""
    j, p = JAX.Node(), PORT.Node()
    want = _jax_usage(j.ctl.run(["help"]))
    assert "\n  reload " in want
    assert p.ctl.run(["help"]) == want
    assert p.ctl.run([]) == p.ctl.usage() == want
    assert p.ctl.run(["--help"]) == want
    assert set(j.ctl._commands) == set(p.ctl._commands)
    # unknown command: the line, then the usage
    out = p.ctl.run(["bogus"])
    assert out.startswith("unknown command: bogus\n")
    assert out == _jax_usage(j.ctl.run(["bogus"]))
    # reload is a command: a missing file is an operator error
    assert p.ctl.run(["reload"]) == j.ctl.run(["reload"])
    assert p.ctl.run(["reload", "x.toml"]).startswith("error: ")


#: operator input errors and usage fall-throughs: the text equal
ERRORS = [
    ["banned", "add", "bogus-kind", "v"],
    ["banned", "add", "clientid", "v", "notanum"],
    ["banned", "bogus"], ["clients", "kick"], ["plugins", "bogus"],
    ["plugins", "load", "nope"], ["plugins", "unload", "nope"],
    ["checkpoint", "bad", "x"], ["checkpoint", "save"],
    ["trace", "bogus"], ["trace", "stop", "client", "nobody"],
    ["log", "set-level"], ["log", "set-level", "bogus"], ["log", "bogus"],
    ["telemetry", "nope"], ["faults", "bogus"], ["faults", "arm", "nope"],
    ["faults", "disarm", "device.walk"], ["drain", "bogus"],
    ["drain", "start", "--bogus"], ["cluster", "join", "h:1"],
    ["profile", "bogus"], ["profile", "loops", "bogus"],
    ["profile", "stop"], ["profile", "loops", "stop"],
    ["durability", "checkpoint"], ["slow_subs", "reset"],
    ["subscriptions", "bogus"],
]


@pytest.mark.parametrize("cmd", ERRORS, ids=" ".join)
def test_error_and_usage_texts_equal_jax(cmd):
    j, p = JAX.Node(), PORT.Node()
    assert p.ctl.run(cmd) == _jax_usage(j.ctl.run(cmd))


def test_registry_and_builtins():
    """tests/test_ctl_obs.py::test_ctl_registry_and_builtins."""
    async def scenario(P):
        n = P.Node()
        await n.start()
        try:
            ctl = n.ctl
            ctl.register_command("hello", lambda args: f"hi {args}")
            assert "hi ['x']" == ctl.run(["hello", "x"])
            ctl.unregister_command("hello")
            out = ctl.run(["hello"])
            assert "unknown" in out.lower() or "usage" in out.lower()
            assert "node:" in ctl.run(["status"])
            assert "MQTT broker" in ctl.run(["broker"]) or P.port
            n.broker.subscribe(Sink(), "ctl/t")
            assert "ctl/t" in ctl.run(["topics"])
            assert "ctl/t" in ctl.run(["routes"])
            n.metrics.inc("messages.received")
            assert "messages.received" in ctl.run(["metrics"])
            assert ctl.run(["vm"])
            assert "commands:" in ctl.usage()
            return [ctl.run(c) for c in (["status"], ["topics"],
                                         ["routes"], ["metrics"])]
        finally:
            await n.stop()

    asyncio.run(both_async(scenario))


def test_log_level_runtime():
    """tests/test_ctl_obs.py::test_ctl_log_level_runtime and
    tests/test_modules.py::test_ctl_log_level."""
    def scenario(P):
        n = P.Node()
        root = logging.getLogger(P.logger)
        saved = root.level
        try:
            out = [n.ctl.run(["log", "set-level", "debug"])]
            assert root.level == logging.DEBUG
            out.append(n.ctl.run(["log", "show"]))
            out.append(n.ctl.run(["log", "set-level", "warning"]))
            assert root.level == logging.WARNING
            out.append(n.ctl.run(["log", "set-level", "bogus"]))
            assert "error" in out[-1]
            assert "profile" in n.ctl.run(["help"])
            return out
        finally:
            root.setLevel(saved)

    assert both(scenario)[0] == "level: DEBUG"


def test_telemetry_stages_slow_reset():
    """tests/test_ctl_obs.py::test_ctl_telemetry_stages_slow_reset and
    tests/test_telemetry.py's ctl cases."""
    def scenario(P):
        n = P.Node(**({} if P.port else {"batch_ingress": False}))
        n.broker.subscribe(Sink(), "tel/t")
        n.publish(P.Message(topic="tel/t"))
        out = n.ctl.run(["telemetry"])
        assert "stage" in out and "end_to_end" in out and "p99_ms" in out
        seen = [_NUM.sub("<ms>", _jax_rows(out) if P.port else out)]
        seen.append(n.ctl.run(["telemetry", "slow"]))
        n.telemetry.config.slow_threshold_ms = 0.0
        n.publish(P.Message(topic="tel/t"))
        slow = json.loads(n.ctl.run(["telemetry", "slow"]))
        assert "end_to_end_ms" in slow[0]
        seen.append(sorted(k for k in slow[0]
                           if not (P.port and k == "gc_ms")))
        seen.append(n.ctl.run(["telemetry", "reset"]))
        seen.append(n.ctl.run(["telemetry", "slow"]))
        seen.append(n.ctl.run(["telemetry", "nope"]))
        assert n.telemetry.spans_total == 0
        off = P.Node(telemetry=P.TelemetryConfig(enabled=False))
        off.broker.subscribe(Sink(), "x")
        off.publish(P.Message(topic="x"))
        seen.append(off.ctl.run(["telemetry"]))
        return seen

    seen = both(scenario)
    assert seen[1] == seen[4] == "(none)" and seen[3] == "ok"
    assert "disabled" in seen[-1]


def test_banned_trace_status_topics_commands():
    """tests/test_modules.py::test_ctl_commands and
    ::test_ctl_bad_input_returns_error_text."""
    def scenario(P):
        n = P.Node()
        n.broker.subscribe(Sink(), "ctl/t")
        out = [n.ctl.run(["status"]), n.ctl.run(["topics"])]
        assert "connections: 0" in out[0] and "ctl/t" in out[1]
        out.append(n.ctl.run(["banned", "add", "clientid", "evil", "60"]))
        listed = n.ctl.run(["banned", "list"])
        assert "evil" in listed
        out.append(listed.split(" until=")[0])
        out.append(n.ctl.run(["banned", "del", "clientid", "evil"]))
        out.append(n.ctl.run(["banned", "list"]))
        assert "(none)" in out[-1]
        out.append(n.ctl.run(["trace", "start", "client", "c"]))
        out.append(n.ctl.run(["trace", "start", "client", "c"]))
        assert out[-1].startswith("error:")
        out.append(n.ctl.run(["trace", "start", "topic", "a/#"]))
        out.append(n.ctl.run(["trace", "list"]))
        out.append(n.ctl.run(["trace", "stop", "client", "c"]))
        out.append(n.ctl.run(["trace", "list"]))
        return out

    both(scenario)


def test_clients_kick_and_subscriptions_show():
    def scenario(P):
        n, chans = seeded(P)
        out = [n.ctl.run(["subscriptions", "show", "c2"]),
               n.ctl.run(["clients", "kick", "c2"]),
               n.ctl.run(["clients", "kick", "c2"]),
               n.ctl.run(["clients", "list"]),
               n.ctl.run(["sessions"]),
               n.ctl.run(["status"])]
        return out

    out = both(scenario)
    assert out[1] == "ok" and out[2] == "not found"


def test_overload_and_faults_commands():
    """tests/test_chaos.py::test_ctl_overload_and_faults_commands."""
    def scenario(P):
        n = P.Node(matcher=P.MatcherConfig(device_min_filters=0))
        try:
            out = json.loads(n.ctl.run(["overload"]))
            assert out["enabled"] and out["level"] == "ok"
            assert out["breaker"]["state"] == "closed"
            seen = [out, n.ctl.run(["faults", "arm",
                                    "device.fetch:raise:2"])]
            info = json.loads(n.ctl.run(["faults"]))
            assert info["armed"]["device.fetch"]["action"] == "raise"
            seen.append(info["armed"])
            seen.append(n.ctl.run(["faults", "disarm", "device.fetch"]))
            seen.append(n.ctl.run(["faults", "arm", "nope"]))
            assert "unknown fault point" in seen[-1]
            seen.append(n.ctl.run(["faults", "off"]))
            seen.append(n.ctl.run(["faults", "on"]))
            seen.append(n.ctl.run(["faults", "clear"]))
            assert not P.faults.enabled
            return seen
        finally:
            P.faults.clear()

    out = both(scenario)
    assert out[1] == out[3] == "ok"


def test_overload_disabled_node():
    from emqx_tpu.overload import OverloadConfig as J
    from emqx_tpu_torch.overload import OverloadConfig as P

    j = JAX.Node(overload=J(enabled=False))
    p = PORT.Node(overload=P(enabled=False))
    assert p.ctl.run(["overload"]) == j.ctl.run(["overload"])


def test_cache_command_partitions():
    """tests/test_cache_partition.py::
    test_node_gauges_ctl_cache_and_quarantine_alarm, its ctl part."""
    def scenario(P):
        n = P.Node(matcher=P.MatcherConfig(device_min_filters=0,
                                           cache_partitions=16))
        n.subscribe(Sink("c1"), "g/t")
        n.broker.publish(P.Message(topic="g/t"))
        n.stats.tick()
        out = n.ctl.run(["cache"])
        assert '"partitions": 16' in out
        assert "bumps" in out and "quarantined_ids" in out
        return _WALK.sub(r'"\1": "<walk>"', out)

    both(scenario)


def test_cache_command_cold_and_disabled():
    def scenario(P):
        cold = P.Node(matcher=P.MatcherConfig(device_min_filters=0))
        off = P.Node(matcher=P.MatcherConfig(match_cache=False))
        return [json.loads(_WALK.sub(r'"\1": "<walk>"',
                                     n.ctl.run(["cache"])))
                for n in (cold, off)]

    out = both(scenario)
    assert out[0]["state"] == "cold (no device match yet)"
    assert out[1]["state"] == "disabled"


def test_retained_command_after_a_replay():
    """tests/test_retained_replay.py::test_ctl_retained_snapshot and
    ::test_ctl_retained_without_module."""
    async def scenario(P):
        n = P.Node()
        mod = n.modules.load(P.Ret)
        mod.index_device_threshold = 0
        for t in ("x/1/a", "x/2/a", "x/3/b", "y/1"):
            n.broker.publish(P.Message(topic=t, payload=t.encode(),
                                       flags={"retain": True}))
        ch = P.Channel(n.broker, n.cm)
        ch.handle_in(_pkt(P, JP.Connect(proto_ver=C.MQTT_V4,
                                        proto_name="MQTT",
                                        client_id="ctlsub")))
        ch.handle_in(_pkt(P, JP.Subscribe(packet_id=1, topic_filters=[
            ("x/+/a", {"qos": 0}), ("y/#", {"qos": 0})])))
        await asyncio.sleep(0)  # the burst's flush, at the tick's end
        got = sorted(p.topic for p in ch.handle_deliver()
                     if type(p).__name__ == "Publish")
        out = json.loads(n.ctl.run(["retained"]))
        assert out["store"] == 4 and out["replay_batches"] == 1
        idx = out["index"]
        assert idx["rows"] == 4 and idx["last_batch"] == 2
        assert idx["device_broken"] == 0 and not idx["suspended"]
        idx["walk"] = "<walk>"
        bare = P.Node()
        return got, out, bare.ctl.run(["retained"])

    got, _out, bare = asyncio.run(both_async(scenario))
    assert got == ["x/1/a", "x/2/a", "y/1"]
    assert "not loaded" in bare


def test_durability_command(tmp_path):
    """tests/test_durability.py::test_ctl_durability_command."""
    async def scenario(P):
        d = tmp_path / P.name
        n = P.Node(durability=P.DurabilityConfig(enabled=True,
                                                 dir=str(d)))
        await n.start()
        try:
            ch = P.Channel(n.broker, n.cm)
            ch.handle_in(_pkt(P, JP.Connect(
                proto_ver=C.MQTT_V5, proto_name="MQTT", client_id="c",
                clean_start=False,
                properties={"Session-Expiry-Interval": 600})))
            ch.session.subscribe("q/+", P.SubOpts(qos=1))
            n.durability.on_batch()
            out = json.loads(n.ctl.run(["durability"]))
            assert out["enabled"] and out["generation"] >= 1
            assert out["journal"]["records"] >= 1
            assert out["last_recovery"]["generation"] >= 0
            out2 = json.loads(n.ctl.run(["durability", "checkpoint"]))
            assert out2["generation"] == out["generation"] + 1
            off = P.Node()
            return (sorted(out), out["generation"], out2["generation"],
                    off.ctl.run(["durability"]))
        finally:
            await n.stop()

    out = asyncio.run(both_async(scenario))
    assert "not enabled" in out[-1]


def test_drain_start_status_stop():
    """tests/test_drain.py's ``ctl drain`` cases, without a client."""
    async def scenario(P):
        n = P.Node()
        await n.start()
        try:
            started = json.loads(n.ctl.run(
                ["drain", "start", "--ref", "10.0.0.9:1883"]))
            assert n.node_state == 1
            st = json.loads(n.ctl.run(["drain", "status"]))
            stopped = json.loads(n.ctl.run(["drain", "stop"]))
            assert n.node_state == 0
            keys = (sorted(started), sorted(st), sorted(stopped))
            return keys, started.get("state"), stopped.get("state")
        finally:
            await n.stop()

    asyncio.run(both_async(scenario))


def test_trace_export_and_slow_subs(tmp_path):
    """tests/test_tracing.py's ``trace export`` and ``slow_subs``
    cases, on a sampled sans-IO flow."""
    from emqx_tpu.tracing import TracingConfig as J
    from emqx_tpu_torch.tracing import TracingConfig as P_

    def scenario(P):
        cfg = (P_ if P.port else J)(sample_rate=1.0)
        n = P.Node(tracing=cfg)
        none = n.ctl.run(["slow_subs"])
        path = tmp_path / f"{P.name}.json"
        out = n.ctl.run(["trace", "export", str(path)])
        assert "exported" in out
        doc = json.load(open(path))
        assert "traceEvents" in doc
        return none, out.split(" trace events")[0].split()[0], \
            n.ctl.run(["slow_subs", "reset"])

    out = both(scenario)
    assert "none traced" in out[0]


def test_cluster_status_on_joined_nodes():
    """tests/test_cluster_heal.py's ``cluster status`` case, on two
    nodes of each package joined in one process."""
    from emqx_tpu.cluster import Cluster as JCluster
    from emqx_tpu.cluster import LocalTransport as JLocal
    from emqx_tpu_torch.cluster import Cluster as PCluster
    from emqx_tpu_torch.cluster import LocalTransport as PLocal

    def scenario(P):
        Cl, Tr = (PCluster, PLocal) if P.port else (JCluster, JLocal)
        a = P.Node(name="a@h")
        b = P.Node(name="b@h")
        tr = Tr()
        ca, cb = Cl(a, tr), Cl(b, tr)
        ca.join(cb)
        out = json.loads(a.ctl.run(["cluster", "status"]))
        assert out["members"] == ["a@h", "b@h"]
        left = a.ctl.run(["cluster", "leave"])
        return out["node"], out["members"], sorted(out), left

    both(scenario)


def test_plugins_command_through_ctl(tmp_path):
    def scenario(P):
        n = P.Node(plugin_config_dir=str(tmp_path))
        (tmp_path / "ctl_demo.toml").write_text('greeting = "hi"\n')
        got = {}

        class Demo:
            name = "ctl_demo"

            def load(self, node, env):
                got["env"] = dict(env)

            def unload(self, node):
                got["unloaded"] = True

        n.plugins.register(Demo())
        return [n.ctl.run(["plugins", "list"]),
                n.ctl.run(["plugins", "load", "ctl_demo"]),
                n.ctl.run(["plugins", "load", "ctl_demo"]),
                n.ctl.run(["plugins"]),
                n.ctl.run(["plugins", "unload", "ctl_demo"]),
                n.ctl.run(["plugins", "unload", "ctl_demo"]), got]

    out = both(scenario)
    assert out[1] == "ok" and out[2] == "already loaded"
    assert out[-1] == {"env": {"greeting": "hi"}, "unloaded": True}


def test_listeners_command_names_every_listener():
    def scenario(P):
        n = P.Node()
        n.add_listener(port=0, name="tcp:a", max_connections=7)
        n.add_listener(port=0, name="tcp:b")
        return json.loads(n.ctl.run(["listeners"]))

    out = both(scenario)
    assert [d["name"] for d in out] == ["tcp:a", "tcp:b"]
    assert out[0]["max_connections"] == 7 and not out[0]["tls"]


def _routes_history(P, n):
    rng = random.Random(3)
    for i in range(300):
        w = [rng.choice("abcd") for _ in range(rng.randrange(1, 4))]
        if rng.random() < 0.3:
            w[rng.randrange(len(w))] = "+"
        if rng.random() < 0.2:
            w.append("#")
        n.broker.subscribe(Sink(f"s{i % 17}"), "/".join(w))


def _batch():
    rng = random.Random(4)
    return ["/".join(rng.choice("abcde") for _ in range(rng.randrange(1, 5)))
            for _ in range(64)]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_save_on_one_load_on_the_other(tmp_path, direction):
    """``ctl checkpoint save`` on one package's node, ``ctl checkpoint
    load`` into a fresh node of the other: the loaded router's next
    batch matches the source's, the TrieOracle's, and the JAX one's
    (tests/test_checkpoint.py::test_ctl_checkpoint_command: a live
    router refuses the restore)."""
    src_pkg, dst_pkg = (JAX, PORT) if direction == "jax_to_port" \
        else (PORT, JAX)
    cfg = dict(device_min_filters=0, delta=False, match_cache=False)
    src = src_pkg.Node(matcher=src_pkg.MatcherConfig(**cfg))
    _routes_history(src_pkg, src)
    src.router.automaton()
    path = str(tmp_path / "n.npz")
    saved = src.ctl.run(["checkpoint", "save", path])
    assert saved.startswith("saved ") and "+ tables" in saved
    assert "error" in src.ctl.run(["checkpoint", "load", path])
    dst = dst_pkg.Node(matcher=dst_pkg.MatcherConfig(**cfg))
    loaded = dst.ctl.run(["checkpoint", "load", path])
    assert loaded == saved.replace("saved", "restored")
    batch = _batch()
    want = [sorted(x) for x in src.router.match_filters(batch)]
    got = [sorted(x) for x in dst.router.match_filters(batch)]
    oracle = TrieOracle()
    for f in src.router.topics():
        oracle.insert(f)
    assert got == want == [sorted(oracle.match(t)) for t in batch]


@pytest.mark.parametrize("regime", ["host", "device"])
def test_match_routes_equals_jax_and_the_oracle(regime):
    """``Router.match_routes`` (emqx_router:match_routes/1): below
    ``device_min_filters`` the host trie, past it the walk (kernel B1's
    plain twin on the CPU), against the JAX router's and the oracle."""
    mins = 10 ** 6 if regime == "host" else 0

    def scenario(P):
        r = P.Router(config=P.MatcherConfig(device_min_filters=mins),
                     node="n1")
        rng = random.Random(5)
        flts = set()
        for i in range(200):
            w = [rng.choice("xyz") for _ in range(rng.randrange(1, 4))]
            if rng.random() < 0.3:
                w[0] = "+"
            if rng.random() < 0.2:
                w.append("#")
            f = "/".join(w)
            flts.add(f)
            r.add_route(f, dest="n1" if i % 3 else "n2")
        r.ensure_route("x/y", "n3")
        r.ensure_route("x/y", "n3")
        r.add_route("z/+", dest="n4")
        r.add_route("z/+", dest="n4")
        r.drop_route("z/+", "n4")
        topics = ["x", "x/y", "y/z/x", "z/z", "x/x/x/x", "q"]
        out = [sorted((rt.topic, str(rt.dest))
                      for rt in r.match_routes(t)) for t in topics]
        assert r.use_device_now() == (regime == "device")
        return out, sorted(flts), r.has_dest("z/+", "n4")

    out, flts, dropped = both(scenario)
    assert not dropped
    oracle = TrieOracle()
    for f in flts + ["x/y"]:
        oracle.insert(f)
    for t, routes in zip(["x", "x/y", "y/z/x", "z/z", "x/x/x/x", "q"],
                         out):
        assert sorted({f for f, _d in routes}) == sorted(oracle.match(t))
