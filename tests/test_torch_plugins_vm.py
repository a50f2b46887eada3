"""The port's plugins, host introspection, module-level API and the
members the earlier slices left out, against the JAX package's.

``emqx_tpu_torch.plugins`` runs ``tests/test_modules.py``'s plugin
cases (lifecycle, the persisted loaded-list, the per-plugin
``<config_dir>/<name>.toml`` env) on a node of each package, plus a
plugin discovered from a spec string; ``emqx_tpu_torch.vm`` gives the
JAX payload's keys and shapes (``tests/test_ctl_obs.py``'s vm case)
with the CUDA inventory, empty on a CPU node; the module-level
``subscribe``/``publish``/``hook`` run ``tests/test_broker.py``'s
facade case on a CPU broker installed as
``emqx_tpu_torch._default_broker``, and the package imports no torch.
Each member of the slice's list (``Broker.suboption``,
``SubRegistry.count``, ``FanoutManager.stats``, ``Inflight.window``,
``PQueue.peek``/``to_list``, ``MQueue.info``, ``Metrics.names``,
``global_metrics``, ``global_hooks``, ``logger.set_level``,
``mqtt_caps.get_caps``, ``base62.decode``, ``Batch``,
``AsyncBatcher``, ``RetainerModule.info``, ``Keepalive(backoff=)``,
``open_session(expiry_interval=)``) is driven the same way on both
packages and the observations must be equal.
"""

import asyncio
import json
import logging
import subprocess
import sys
import os

import pytest

import emqx_tpu
import emqx_tpu_torch
from emqx_tpu import vm as jvm
from emqx_tpu.broker import Broker as JBroker
from emqx_tpu.node import Node as JNode
from emqx_tpu.types import Message as JMessage
from emqx_tpu.types import SubOpts as JSubOpts
from emqx_tpu_torch import vm as pvm
from emqx_tpu_torch.broker import Broker as PBroker
from emqx_tpu_torch.node import Node as PNode
from emqx_tpu_torch.types import Message as PMessage
from emqx_tpu_torch.types import SubOpts as PSubOpts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Pkg:
    def __init__(self, **kw) -> None:
        self.__dict__.update(kw)


JAX = _Pkg(name="jax", port=False, root="emqx_tpu", pkg=emqx_tpu,
           Message=JMessage, SubOpts=JSubOpts, vm=jvm,
           Broker=lambda **kw: JBroker(**kw),
           Node=lambda **kw: JNode(boot_listeners=False, **kw))
PORT = _Pkg(name="port", port=True, root="emqx_tpu_torch",
            pkg=emqx_tpu_torch, Message=PMessage, SubOpts=PSubOpts,
            vm=pvm, Broker=lambda **kw: PBroker(device="cpu", **kw),
            Node=lambda **kw: PNode(device="cpu", boot_listeners=False,
                                    **kw))


def both(scenario, *args):
    want = scenario(JAX, *args)
    got = scenario(PORT, *args)
    assert got == want
    return got


def _mod(P, name):
    import importlib

    return importlib.import_module(f"{P.root}.{name}")


# -- plugins ------------------------------------------------------------------


class DemoPlugin:
    """A plugin class the spec-string discovery imports."""

    name = "spec_demo"

    def __init__(self):
        self.env = None

    def load(self, node, env):
        self.env = dict(env)

    def unload(self, node):
        self.env = None


def test_plugins_lifecycle_and_persisted_list(tmp_path):
    """tests/test_modules.py::test_plugins_lifecycle."""
    def scenario(P):
        Plugin = _mod(P, "plugins").Plugin

        class Demo(Plugin):
            name = "demo"

            def __init__(self):
                self.loads = 0

            def load(self, node, env):
                self.loads += 1

            def unload(self, node):
                self.loads -= 1

        n = P.Node()
        n.plugins.state_file = str(tmp_path / f"{P.name}.json")
        p = Demo()
        n.plugins.register(p)
        seen = [n.plugins.load("demo"), n.plugins.load("demo"), p.loads,
                n.plugins.list(), n.plugins.unload("demo"),
                n.plugins.unload("demo"), p.loads]
        n.plugins.load("demo")
        seen.append(json.load(open(n.plugins.state_file)))
        n2 = P.Node()
        n2.plugins.state_file = n.plugins.state_file
        p2 = Demo()
        n2.plugins.register(p2)
        n2.plugins.load_all()
        seen.append(p2.loads)
        with pytest.raises(KeyError):
            n2.plugins.load("nope")
        with pytest.raises(NotImplementedError):
            Plugin().load(n2, {})
        return seen

    seen = both(scenario)
    assert seen[:3] == [True, False, 1] and seen[-1] == 1


def test_plugin_config_file_merged(tmp_path):
    """tests/test_modules.py::test_plugin_config_file_merged."""
    (tmp_path / "demo.toml").write_text(
        'answer = 42\nlabel = "from-file"\n')

    def scenario(P):
        Plugin = _mod(P, "plugins").Plugin

        class Demo(Plugin):
            name = "demo"

            def load(self, node, env):
                self.env = env

            def unload(self, node):
                pass

        n = P.Node()
        n.plugins.config_dir = str(tmp_path)
        p = Demo()
        n.plugins.register(p)
        n.plugins.load("demo", env={"label": "override"})
        seen = [dict(p.env)]
        n.plugins.unload("demo")
        n.plugins.config_dir = str(tmp_path / "nope")
        n.plugins.load("demo", env={"k": 1})
        seen.append(dict(p.env))
        return seen

    assert both(scenario) == [{"answer": 42, "label": "override"},
                              {"k": 1}]


def test_plugin_discovered_from_a_spec_string(tmp_path):
    (tmp_path / "spec_demo.toml").write_text('greeting = "hello"\n')

    def scenario(P):
        n = P.Node(plugin_config_dir=str(tmp_path))
        assert n.plugins.config_dir == str(tmp_path)
        plugin = n.plugins.discover("test_torch_plugins_vm:DemoPlugin")
        seen = [type(plugin).__name__, n.ctl.run(["plugins", "list"]),
                n.ctl.run(["plugins", "load", "spec_demo"]), plugin.env,
                n.ctl.run(["plugins", "list"]),
                n.ctl.run(["plugins", "unload", "spec_demo"]), plugin.env]
        return seen

    seen = both(scenario)
    assert seen[2] == "ok" and seen[3] == {"greeting": "hello"}
    assert seen[4] == "spec_demo (active)"


# -- vm ------------------------------------------------------------------------


def test_vm_payload_shapes_equal_jax():
    """tests/test_ctl_obs.py::test_vm_introspection_shapes and
    tests/test_ops_aux.py::test_ctl_vm_command."""
    def scenario(P):
        vm = P.vm
        mem = vm.get_memory()
        assert mem["rss"] > 0 and mem["vms"] > 0
        pi = vm.get_process_info()
        assert pi["threads"] >= 1
        assert vm.cpu_count() >= 1 and len(vm.loads()) == 3
        info = vm.get_system_info()
        assert isinstance(info["devices"], list)
        out = json.loads(P.Node().ctl.run(["vm"]))
        assert '"cpu_count"' in P.Node().ctl.run(["vm"])
        return (sorted(mem), sorted(pi), sorted(vm.get_gc_info()),
                sorted(info), sorted(out), vm.cpu_count(),
                info["python"])

    both(scenario)


def test_vm_lists_no_card_on_a_cpu_node():
    import torch

    assert pvm.get_device_info("cpu") == []
    assert pvm.get_device_info(torch.device("cpu")) == []
    assert json.loads(PORT.Node().ctl.run(["vm"]))["devices"] == []
    if not torch.cuda.is_available():
        assert pvm.get_device_info() == []


# -- the module-level API -------------------------------------------------------


@pytest.fixture
def cpu_default_broker():
    saved_j, saved_p = emqx_tpu._default_broker, emqx_tpu_torch._default_broker
    emqx_tpu._default_broker = JBroker()
    emqx_tpu_torch._default_broker = PBroker(device="cpu")
    yield
    emqx_tpu._default_broker, emqx_tpu_torch._default_broker = \
        saved_j, saved_p


def test_package_facade_equals_jax(cpu_default_broker):
    """tests/test_broker.py::test_package_facade, on both packages."""
    def scenario(P):
        pkg = P.pkg

        class S:
            def __init__(self):
                self.got = []

            def deliver(self, t, m):
                self.got.append(m.payload)

        s = S()
        pkg.subscribe(s, "facade/+")
        n = pkg.publish(P.Message(topic="facade/x", payload=b"hi"))
        seen = [n, list(s.got), pkg.unsubscribe(s, "facade/+"),
                pkg.publish(P.Message(topic="facade/x"))]
        topics = []

        def on_pub(msg, acc=None):
            topics.append(msg.topic)
            return acc

        pkg.hook("message.publish", on_pub)
        pkg.publish(P.Message(topic="facade/hooked"))
        pkg.unhook("message.publish", on_pub)
        pkg.publish(P.Message(topic="facade/after"))
        seen.append(topics)
        assert pkg.default_broker() is pkg._default_broker
        return seen, pkg.__version__, sorted(pkg.__all__)

    seen, _v, _all = both(scenario)
    assert seen[:4] == [1, [b"hi"], True, 0]
    assert seen[4] == ["facade/hooked"]


def test_default_broker_is_built_on_cuda(cpu_default_broker):
    import torch

    emqx_tpu_torch._default_broker = None
    if torch.cuda.is_available():
        b = emqx_tpu_torch.default_broker()
        assert b.device.type == "cuda"
        assert emqx_tpu_torch.default_broker() is b
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            emqx_tpu_torch.default_broker()
        assert emqx_tpu_torch._default_broker is None


def test_package_import_loads_no_torch():
    code = ("import sys\n"
            "import emqx_tpu_torch\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "assert emqx_tpu_torch.topic.wildcard('a/+')\n"
            "print(emqx_tpu_torch.__version__)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == emqx_tpu.__version__


# -- the members the earlier slices left out -------------------------------------


class _Sub:
    def __init__(self, cid):
        self.client_id = cid

    def deliver(self, f, m):
        pass


def test_broker_suboption_and_fanout_stats():
    def scenario(P):
        b = P.Broker()
        subs = [_Sub(f"c{i}") for i in range(5)]
        for i, s in enumerate(subs):
            b.subscribe(s, f"so/{i % 2}/+", P.SubOpts(qos=i % 3))
        opt = b.suboption(subs[3], "so/1/+")
        seen = [opt.to_dict(), b.suboption(subs[3], "so/0/+"),
                b.suboption(_Sub("x"), "so/1/+"),
                b.helper.registry.count(), b.helper.stats()]
        b.unsubscribe(subs[0], "so/0/+")
        seen.append(b.helper.stats())
        return seen

    seen = both(scenario)
    assert seen[3] == 5 and seen[1] is None


def test_inflight_window_pqueue_peek_to_list_mqueue_info():
    def scenario(P):
        Inflight = _mod(P, "inflight").Inflight
        PQueue = _mod(P, "pqueue").PQueue
        MQueue = _mod(P, "mqueue").MQueue
        inf = Inflight(8)
        for k in (5, 2, 9):
            inf.insert(k, f"v{k}")
        inf.delete(2)
        q = PQueue()
        seen = [inf.window(), q.peek(), q.to_list()]
        for item, prio in (("a", 0), ("b", 3), ("c", 0), ("d", 3), ("e", 1)):
            q.push(item, prio)
        seen += [q.peek(), q.to_list(), q.pop(), q.to_list()]
        mq = MQueue(max_len=2, store_qos0=True)
        seen.append(mq.info())
        for i in range(4):
            mq.push(P.Message(topic=f"t/{i}", qos=1))
        seen.append(mq.info())
        return seen

    seen = both(scenario)
    assert seen[0] == [5, 9] and seen[3] == (True, "b")


def test_metrics_names_and_the_process_registries():
    def scenario(P):
        metrics = _mod(P, "metrics")
        hooks = _mod(P, "hooks")
        m = metrics.Metrics()
        names = m.names()
        g = metrics.global_metrics()
        assert g is metrics.global_metrics()
        h = hooks.global_hooks()
        assert h is hooks.global_hooks() and isinstance(h, hooks.Hooks)
        return (names[:40], "delivery.xloop.orphaned" in names,
                isinstance(g, metrics.Metrics))

    both(scenario)
    from emqx_tpu.metrics import Metrics as J
    from emqx_tpu_torch.metrics import Metrics as P_

    jn = J().names()
    # the port's catalogue is the JAX one's in its order, less the
    # names of unported paths
    assert P_().names() == [x for x in jn if x in set(P_().names())]


def test_logger_set_level_touches_only_broker_handlers():
    def scenario(P):
        logger = _mod(P, "logger")
        root = logging.getLogger(P.root)
        saved, saved_h = root.level, list(root.handlers)
        try:
            own = logger.setup(level=logging.INFO)
            pinned = logging.StreamHandler()
            pinned.setLevel(logging.ERROR)
            root.addHandler(pinned)
            logger.set_level(logging.DEBUG)
            return (root.level, own.level, pinned.level)
        finally:
            root.setLevel(saved)
            root.handlers = saved_h

    assert both(scenario) == (logging.DEBUG, logging.DEBUG, logging.ERROR)


def test_get_caps_and_base62_decode():
    """tests/test_caps.py::test_get_caps and
    tests/test_props.py::test_base62_roundtrip_random_ints."""
    import random

    def scenario(P):
        caps = _mod(P, "mqtt_caps")
        zone = _mod(P, "zone")
        b62 = _mod(P, "utils.base62")
        rng = random.Random(62)
        ints = [0, 1, 61, 62] + [rng.getrandbits(rng.randrange(1, 128))
                                 for _ in range(200)]
        assert all(b62.decode(b62.encode(n)) == n for n in ints)
        return (caps.get_caps(zone.Zone(max_qos_allowed=1)),
                caps.get_caps(zone.Zone()),
                [b62.decode(b62.encode(n)) for n in ints[:20]],
                b62.decode("zZ09"))

    both(scenario)


def test_batch_and_async_batcher():
    def scenario(P):
        batch = _mod(P, "utils.batch")
        commits = []
        b = batch.Batch(batch_size=3, linger_ms=50.0,
                        commit_fun=lambda xs: commits.append(list(xs)))
        seen = [b.push(1), b.push(2), len(b), b.due(), b.push(3), len(b)]
        b.push(4)
        seen += [b.due(now=b._first_at + 0.049),
                 b.due(now=b._first_at + 0.051), b.flush() is None,
                 b.flush(), list(commits)]
        plain = batch.Batch(batch_size=2)
        seen += [plain.push("a"), plain.push("b")]

        async def run():
            got = []
            ab = batch.AsyncBatcher(lambda xs: got.append(list(xs)),
                                    batch_size=4, linger_ms=5.0)
            ab.start()
            for i in range(6):
                ab.push(i)
            await asyncio.sleep(0.05)
            ab.push(99)
            ab.stop()
            return got

        seen.append(asyncio.run(run()))
        return seen

    seen = both(scenario)
    assert seen[-1] == [[0, 1, 2, 3], [4, 5], [99]]


def test_retainer_info_keepalive_backoff_open_session_expiry():
    def scenario(P):
        Ret = _mod(P, "modules.retainer").RetainerModule
        Keepalive = _mod(P, "keepalive").Keepalive
        n = P.Node()
        mod = n.modules.load(Ret)
        seen = [mod.info()]
        for i in range(3):
            n.broker.publish(P.Message(topic=f"ri/{i}", payload=b"x",
                                       flags={"retain": True}))
        seen.append(mod.info())
        ka = Keepalive(10.0)
        kb = Keepalive(10.0, backoff=0.5)
        seen.append((ka.backoff, kb.backoff, kb.check_interval()))

        class Chan:
            client_id = "oc"
            session = None

            def kick(self, discard=False):
                pass

        sess, present = n.cm.open_session("oc", False, Chan(),
                                          expiry_interval=300)
        seen.append((type(sess).__name__, present,
                     n.cm.session_count()))
        return seen

    seen = both(scenario)
    assert seen[0] == {"retained": 0} and seen[1] == {"retained": 3}
