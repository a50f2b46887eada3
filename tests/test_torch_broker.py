"""The port's publish → match → dispatch slice against the JAX
package's Broker, and the port's import boundary.

One seeded subscribe/publish script runs through
``emqx_tpu.broker.Broker`` (plain path: no match cache, no delta, no
native engine, device matching from the first filter) and through
``emqx_tpu_torch.broker.Broker(device="cpu")``. Both must give equal
delivery counts and equal per-subscriber ``(topic, filter)`` multisets
over literal, ``+``, ``#``, ``$share``, ``$SYS``, big-filter (bitmap)
and overflow cases; after ``router.rebuild()`` on both sides the
bundle a fetch copies must be equal too.
"""

import ast
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from emqx_tpu.broker import Broker as JaxBroker
from emqx_tpu.ops.pack import bundle_i32 as jax_bundle_i32
from emqx_tpu.router import MatcherConfig as JaxMatcherConfig
from emqx_tpu.router import Router as JaxRouter
from emqx_tpu.types import Message as JaxMessage
from emqx_tpu_torch.broker import Broker
from emqx_tpu_torch.ops.pack import bundle_i32
from emqx_tpu_torch.oracle import TrieOracle
from emqx_tpu_torch.router import MatcherConfig, Router
from emqx_tpu_torch.types import Message
from test_walk_pallas import _rand_filters, _rand_topics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOBS = dict(device_min_filters=1, fanout_threshold=4, active_k=2)
#: the JAX package's plain path, which these tests hold the port to:
#: no match cache, no delta automaton, the Python trie engine
PLAIN = dict(match_cache=False, delta=False, use_native=False)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run torch single-threaded here and restore the setting after:
    these tests share worker processes and cores with timing-sensitive
    tests of the JAX package."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

FILTERS = [
    "a/b/c", "x/y", "a/+/c", "+/b/+", "sensor/+/temp", "a/#", "#",
    "$SYS/broker/+", "o/+/+/+", "o/a/+/+", "o/a/b/+", "o/+/b/+",
    "o/+/+/c", "o/a/+/c", "$share/g/a/b/c", "$share/g2/sensor/#",
]
TOPICS = [
    "a/b/c", "x/y", "sensor/1/temp", "$SYS/broker/up", "big/topic",
    "o/a/b/c", "q/w", "a/b/c", "/".join(["d"] * 20), "a", "sensor/2/temp",
    "$SYS/other", "o/z/b/c",
]


class Sink:
    """Subscriber double recording ``(topic, filter)`` deliveries."""

    def __init__(self, name):
        self.client_id = name
        self.inbox = []

    def deliver(self, topic_filter, msg):
        self.inbox.append((msg.topic, topic_filter))


def _brokers():
    ref = JaxBroker(config=JaxMatcherConfig(**PLAIN, **KNOBS))
    port = Broker(config=MatcherConfig(**PLAIN, **KNOBS), device="cpu")
    return ref, port


def _subscribe_all(broker, sinks, seed):
    rs = np.random.RandomState(seed)
    for f in FILTERS:
        for s in rs.choice(len(sinks), size=rs.randint(1, 4), replace=False):
            broker.subscribe(sinks[s], f)
    for s in sinks[:6]:  # 6 > fanout_threshold → the bitmap path
        broker.subscribe(s, "big/topic")


def _run(broker, sinks, msg_cls, topics):
    res = broker.publish_batch([msg_cls(topic=t, payload=b"p")
                                for t in topics])
    boxes = {s.client_id: sorted(s.inbox) for s in sinks}
    for s in sinks:
        s.inbox.clear()
    return res, boxes


def _ref_bundle(ref, topics):
    pb = ref.publish_begin([JaxMessage(topic=t) for t in topics])
    parts = [pb.m_ptr_d, pb.ids_packed_d, pb.ovf_dev, pb.f_ptr_d,
             pb.subs_packed_d, pb.src_packed_d, pb.sel_d, pb.rows_packed_d,
             pb.bm_total_d, pb.bovf_d]
    return np.asarray(jax_bundle_i32(*[p for p in parts if p is not None]))


def test_slice_delivers_like_the_jax_broker():
    ref, port = _brokers()
    ref_sinks = [Sink(f"c{i}") for i in range(8)]
    port_sinks = [Sink(f"c{i}") for i in range(8)]
    _subscribe_all(ref, ref_sinks, 3)
    _subscribe_all(port, port_sinks, 3)
    # two rounds: the first overflows at k = 2 and boosts k for the
    # second; churn in between recycles filter ids on both sides
    for rnd in range(2):
        r_res, r_box = _run(ref, ref_sinks, JaxMessage, TOPICS)
        p_res, p_box = _run(port, port_sinks, Message, TOPICS)
        assert p_res == r_res, rnd
        assert p_box == r_box, rnd
        assert sum(p_res) > 0
        for b, sinks in ((ref, ref_sinks), (port, port_sinks)):
            b.unsubscribe(sinks[0], "x/y")
            b.unsubscribe(sinks[1], "x/y")
            b.unsubscribe(sinks[2], "x/y")
            b.subscribe(sinks[5], "new/+/f")
            b.subscriber_down(sinks[7])
    assert port.router.filter_id("new/+/f") == ref.router.filter_id("new/+/f")
    # the device path really ran: counts match only if every topic
    # went through the walk, the fan-out and the bitmap OR
    assert port.router.effective_k() == ref.router.effective_k() > 2
    ref.router.rebuild()
    port.router.rebuild()
    want = _ref_bundle(ref, TOPICS)
    pb = port.publish_begin([Message(topic=t) for t in TOPICS])
    got = bundle_i32(*port.fetch_parts(pb)).numpy()
    assert pb.sel_d is not None and pb.f_ptr_d is not None
    np.testing.assert_array_equal(got, want)


def test_host_regime_below_device_min_filters():
    port = Broker(config=MatcherConfig(device_min_filters=1024),
                  device="cpu")
    s = Sink("c")
    port.subscribe(s, "a/+")
    port.subscribe(s, "$share/g/a/b")
    assert not port.router.use_device_now()
    assert port.publish(Message(topic="a/b")) == 2
    assert sorted(s.inbox) == [("a/b", "a/+"), ("a/b", "a/b")]
    assert port.metrics.val("messages.delivered") == 1


def test_router_keeps_remote_routes_and_broker_forwards():
    """Routes to another node, plain and ``(group, other node)``, are
    kept (cluster route replication); a publish forwards one message
    per remote (node, filter) through ``Broker.forwarder`` (aggre/1)
    and hands the remote shared group to ``Broker.shared_router``,
    through the host regime and through the device path's planned tail,
    as the JAX broker does."""
    def run(make_broker, make_msg, min_filters):
        b = make_broker(min_filters)
        fwd, shared = [], []
        b.forwarder = lambda node, flt, msg: fwd.append(
            (node, flt, msg.topic))
        b.shared_router = lambda group, flt, nodes, msg: shared.append(
            (group, flt, sorted(nodes), msg.topic)) or 0
        s = Sink("c")
        b.subscribe(s, "a/+")
        for flt, dest in (("a/#", "n2"), ("a/b", "n2"), ("a/b", "n3"),
                          ("a/b", ("g", "n2")), ("z/+", "n3")):
            b.router.add_route(flt, dest=dest)
        res = b.publish_batch([make_msg(topic=t)
                               for t in ("a/b", "z/q", "a/b")])
        b.router.delete_route("z/+", dest="n3")
        return (res, sorted(fwd), sorted(shared), sorted(s.inbox),
                b.metrics.val("messages.forward"),
                sorted(map(repr, (r.dest for r in
                                  b.router.lookup_routes("a/b")))),
                b.router.has_route("z/+"))

    for min_filters in (1, 1024):  # the device path, the host regime
        got = run(lambda m: Broker(config=MatcherConfig(
            **PLAIN, **dict(KNOBS, device_min_filters=m)),
            node="n1", device="cpu"), Message, min_filters)
        want = run(lambda m: JaxBroker(config=JaxMatcherConfig(
            **PLAIN, **dict(KNOBS, device_min_filters=m)), node="n1"),
            JaxMessage, min_filters)
        assert got == want
        res, fwd, shared, inbox, n_fwd, dests, z = got
        assert res == [1, 0, 1]
        assert fwd == sorted(2 * [("n2", "a/#", "a/b"), ("n2", "a/b", "a/b"),
                                  ("n3", "a/b", "a/b")]
                             + [("n3", "z/+", "z/q")])
        assert shared == 2 * [("g", "a/b", ["n2"], "a/b")]
        assert n_fwd == 7
        assert dests == ["'n2'", "'n3'", "('g', 'n2')"]
        assert not z


def _port_files():
    pkg = os.path.join(ROOT, "emqx_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, files in os.walk(pkg):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_port_never_imports_jax_or_the_jax_package():
    for path in _port_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "emqx_tpu"), \
                    (path, name)
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith("__init__")
                    else rel)
    # the front door's, the router's, the host engine's, overload
    # protection's, the durability layer's, observability's, the
    # mesh's, the cluster's, replicated durability's, the drain's, the
    # access plane's, the built-in modules, the operations surface's,
    # the secure front door's, the front-door loops', the worker
    # pool's, the config loader's, the reload's and the command line's
    # are among those imported
    assert {"emqx_tpu_torch.faults", "emqx_tpu_torch.alarm",
            "emqx_tpu_torch.overload", "emqx_tpu_torch.devloss",
            "emqx_tpu_torch.ops.warmup", "emqx_tpu_torch.mqtt", "emqx_tpu_torch.mqtt.constants",
            "emqx_tpu_torch.mqtt.reason_codes", "emqx_tpu_torch.mqtt.props",
            "emqx_tpu_torch.mqtt.packet", "emqx_tpu_torch.mqtt.frame",
            "emqx_tpu_torch.channel", "emqx_tpu_torch.connection",
            "emqx_tpu_torch.ingress", "emqx_tpu_torch.cm",
            "emqx_tpu_torch.session", "emqx_tpu_torch.utils.base62",
            "emqx_tpu_torch.zone", "emqx_tpu_torch.logger",
            "emqx_tpu_torch.keepalive", "emqx_tpu_torch.limiter",
            "emqx_tpu_torch.mountpoint", "emqx_tpu_torch.mqtt_caps",
            "emqx_tpu_torch.acl_cache", "emqx_tpu_torch.access_control",
            "emqx_tpu_torch.node", "emqx_tpu_torch.ops.patch",
            "emqx_tpu_torch.ops.delta", "emqx_tpu_torch.ops.match_cache",
            "emqx_tpu_torch.ops.native", "emqx_tpu_torch.wire",
            "emqx_tpu_torch.wal", "emqx_tpu_torch.checkpoint",
            "emqx_tpu_torch.durability", "emqx_tpu_torch.gc",
            "emqx_tpu_torch.stats", "emqx_tpu_torch.metrics",
            "emqx_tpu_torch.tracer", "emqx_tpu_torch.telemetry",
            "emqx_tpu_torch.profiling", "emqx_tpu_torch.tracing",
            "emqx_tpu_torch.sys_topics", "emqx_tpu_torch.monitors",
            "emqx_tpu_torch.modules.prometheus",
            "emqx_tpu_torch.parallel", "emqx_tpu_torch.parallel.mesh",
            "emqx_tpu_torch.parallel.sharded",
            "emqx_tpu_torch.parallel.distributed",
            "emqx_tpu_torch.cluster", "emqx_tpu_torch.cluster_net",
            "emqx_tpu_torch.cm_locker", "emqx_tpu_torch.replication",
            "emqx_tpu_torch.drain", "emqx_tpu_torch.banned",
            "emqx_tpu_torch.flapping", "emqx_tpu_torch.utils.misc",
            "emqx_tpu_torch.utils.pmon", "emqx_tpu_torch.utils.sequence",
            "emqx_tpu_torch.modules.acl_file",
            "emqx_tpu_torch.modules.delayed",
            "emqx_tpu_torch.modules.rewrite",
            "emqx_tpu_torch.modules.topic_metrics",
            "emqx_tpu_torch.modules.presence",
            "emqx_tpu_torch.modules.subscription",
            "emqx_tpu_torch.ctl", "emqx_tpu_torch.plugins",
            "emqx_tpu_torch.vm", "emqx_tpu_torch.tls",
            "emqx_tpu_torch.psk", "emqx_tpu_torch.psk_tls",
            "emqx_tpu_torch.ws_connection",
            "emqx_tpu_torch.loops", "emqx_tpu_torch.workers",
            "emqx_tpu_torch.config", "emqx_tpu_torch.reload",
            "emqx_tpu_torch.__main__",
            "chip_smoke"} <= set(mods)
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'emqx_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("planner", [True, False])
def test_both_delivery_tails_agree(planner):
    from emqx_tpu_torch.broker import DispatchConfig

    port = Broker(config=MatcherConfig(**PLAIN, **KNOBS), device="cpu",
                  dispatch_config=DispatchConfig(planner=planner))
    sinks = [Sink(f"c{i}") for i in range(8)]
    _subscribe_all(port, sinks, 5)
    port.router.boost_k()
    port.router.boost_k()  # k = 8: no overflow row, so the plan runs
    topics = [t for t in TOPICS if t != "/".join(["d"] * 20)]
    pb = port.publish_begin([Message(topic=t) for t in topics])
    port.publish_fetch(pb)
    assert (pb.plan is not None) == planner
    # egress pre-serialization is on by default, as in the JAX package;
    # the Sink subscribers here carry no wire hints, so it builds
    # nothing and the deliveries are the plain tail's
    assert DispatchConfig(planner=planner).preserialize
    res = port.publish_finish(pb)
    ref, ref_sinks = _brokers()[0], [Sink(f"c{i}") for i in range(8)]
    _subscribe_all(ref, ref_sinks, 5)
    r_res, r_box = _run(ref, ref_sinks, JaxMessage, topics)
    assert res == r_res
    assert {s.client_id: sorted(s.inbox) for s in sinks} == r_box


def test_router_match_filters_matches_jax_router_and_oracle():
    """Router.match_filters on the device path (here the plain walk),
    across route churn that re-flattens the port's tables while the
    JAX router patches its own."""
    rng = random.Random(808)
    ref = JaxRouter(JaxMatcherConfig(device_min_filters=0, **PLAIN))
    port = Router(MatcherConfig(device_min_filters=0, **PLAIN),
                  device="cpu")
    oracle = TrieOracle()
    live = _rand_filters(rng, 120)
    for f in live:
        assert port.add_route(f) == ref.add_route(f)  # same ids
        oracle.insert(f)
    topics = _rand_topics(rng, 40) + ["$SYS/a", "/".join(["s0"] * 20)]
    for rnd in range(3):
        want = ref.match_filters(topics)
        got = port.match_filters(topics)
        for t, a, b in zip(topics, got, want):
            assert sorted(a) == sorted(b) == sorted(oracle.match(t)), (rnd, t)
        for f in live[rnd::7]:
            ref.delete_route(f)
            port.delete_route(f)
            oracle.delete(f)
        for f in _rand_filters(rng, 10):
            if not port.has_route(f):
                # ids may differ from here: the JAX router's patcher
                # compacts in the background and recycles freed ids
                ref.add_route(f)
                port.add_route(f)
                oracle.insert(f)


def test_front_door_entry_points_need_cuda_unless_asked_for_the_cpu(
        monkeypatch):
    """Node, Listener and IngressBatcher default to CUDA and raise
    without it; with device="cpu" they build on the CPU."""
    from emqx_tpu_torch.connection import Listener
    from emqx_tpu_torch.ingress import IngressBatcher
    from emqx_tpu_torch.node import Node

    cpu_node = Node(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: Node(),
                 lambda: Node(device="cuda"),
                 lambda: Listener(cpu_node.broker, cpu_node.cm),
                 lambda: IngressBatcher(cpu_node.broker)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    node = Node(device="cpu")
    assert node.ingress.broker is node.broker
    lst = node.add_listener(port=0)
    assert lst.broker is node.broker
    assert IngressBatcher(node.broker, device="cpu").broker is node.broker
    assert Listener(node.broker, node.cm, device="cpu").cm is node.cm
