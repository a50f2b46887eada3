"""The port's built-in modules (``emqx_tpu_torch.modules.delayed``,
``.rewrite``, ``.topic_metrics``, ``.presence``, ``.subscription``,
``.acl_file``), the module registry and ``Node.load_default_modules``
against the JAX package's.

Each case of ``tests/test_modules.py`` for these modules runs the same
operations on a JAX node and on a port node (``device="cpu"``), keeps
the original test's assertions, and the two observations must be
equal: deliveries (subscriber, filter, topic, payload), publish
results, counters, ACL verdicts and the ``$SYS`` presence payloads'
keys. Two cases drive the delayed and rewrite modules on BASELINE
config 2's filter shapes at a small size (``chip_smoke.make_workload``),
where every delivery must also equal what a host ``TrieOracle`` of the
same filters gives. One case shows fault C.7: the JAX retainer's
``sweep_expired`` raises when a store lands while it iterates; the
port's does not.
"""

import asyncio
import json
import time
from collections import Counter

import numpy as np
import pytest

from emqx_tpu.access_control import AccessControl as JAccess
from emqx_tpu.access_control import ClientInfo as JClientInfo
from emqx_tpu.hooks import STOP as J_STOP
from emqx_tpu.modules import acl_file as jacl
from emqx_tpu.modules.delayed import DelayedModule as JDelayed
from emqx_tpu.modules.presence import PresenceModule as JPresence
from emqx_tpu.modules.retainer import RetainerModule as JRetainer
from emqx_tpu.modules.rewrite import RewriteModule as JRewrite
from emqx_tpu.modules.subscription import SubscriptionModule as JSubscription
from emqx_tpu.modules.topic_metrics import TopicMetricsModule as JTopicMetrics
from emqx_tpu.node import Node as JNode
from emqx_tpu.router import MatcherConfig as JMatcher
from emqx_tpu.types import Message as JMessage
from emqx_tpu.zone import Zone as JZone
from emqx_tpu_torch.access_control import AccessControl as PAccess
from emqx_tpu_torch.access_control import ClientInfo as PClientInfo
from emqx_tpu_torch.hooks import STOP as P_STOP
from emqx_tpu_torch.modules import acl_file as pacl
from emqx_tpu_torch.modules import delayed as pdelayed
from emqx_tpu_torch.modules import topic_metrics as ptm
from emqx_tpu_torch.modules.delayed import DelayedModule as PDelayed
from emqx_tpu_torch.modules.presence import PresenceModule as PPresence
from emqx_tpu_torch.modules.retainer import RetainerModule as PRetainer
from emqx_tpu_torch.modules.rewrite import RewriteModule as PRewrite
from emqx_tpu_torch.modules.subscription import \
    SubscriptionModule as PSubscription
from emqx_tpu_torch.modules.topic_metrics import \
    TopicMetricsModule as PTopicMetrics
from emqx_tpu_torch.node import Node as PNode
from emqx_tpu_torch.oracle import TrieOracle
from emqx_tpu_torch.router import MatcherConfig as PMatcher
from emqx_tpu_torch.types import Message as PMessage
from emqx_tpu_torch.zone import Zone as PZone

import chip_smoke
from tests.mqtt_client import TestClient


class _Pkg:
    def __init__(self, **kw) -> None:
        self.__dict__.update(kw)


JAX = _Pkg(name="jax", Message=JMessage, Delayed=JDelayed,
           Presence=JPresence, Rewrite=JRewrite, TopicMetrics=JTopicMetrics,
           Subscription=JSubscription, Retainer=JRetainer, acl=jacl,
           Access=JAccess, ClientInfo=JClientInfo, Zone=JZone, STOP=J_STOP,
           Matcher=JMatcher,
           Node=lambda **kw: JNode(boot_listeners=False, **kw))
PORT = _Pkg(name="port", Message=PMessage, Delayed=PDelayed,
            Presence=PPresence, Rewrite=PRewrite, TopicMetrics=PTopicMetrics,
            Subscription=PSubscription, Retainer=PRetainer, acl=pacl,
            Access=PAccess, ClientInfo=PClientInfo, Zone=PZone, STOP=P_STOP,
            Matcher=PMatcher,
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


class Q:
    def __init__(self, cid="q"):
        self.client_id = cid
        self.inbox = []

    def deliver(self, t, m):
        self.inbox.append((t, m))


def _inbox(q):
    return [(t, m.topic, bytes(m.payload), m.qos) for t, m in q.inbox]


def test_module_constants_equal():
    from emqx_tpu.modules import delayed as jdelayed
    from emqx_tpu.modules import topic_metrics as jtm

    assert (pdelayed.PREFIX, pdelayed.MAX_DELAY) == \
        (jdelayed.PREFIX, jdelayed.MAX_DELAY)
    assert (ptm.METRICS, ptm.MAX_TOPICS) == (jtm.METRICS, jtm.MAX_TOPICS)
    assert ptm.MAX_TOPICS == 512
    assert pacl.DEFAULT_RULES == jacl.DEFAULT_RULES


# -- delayed -------------------------------------------------------------------

def _delayed_republishes(P):
    n = P.Node()
    n.modules.load(P.Delayed)
    dm = n.modules._loaded["delayed"]
    assert n.broker.delayed is dm
    s = Q()
    n.broker.subscribe(s, "real/topic")
    res = n.publish(P.Message(topic="$delayed/1/real/topic",
                              payload=b"later"))
    assert res == 0
    assert s.inbox == [] and len(dm) == 1
    assert n.metrics.val("messages.delayed") == 1
    early = dm.tick(now=time.time() + 0.5)
    due = dm.tick(now=time.time() + 2)
    assert len(s.inbox) == 1
    assert s.inbox[0][1].topic == "real/topic"
    assert s.inbox[0][1].get_header("allow_publish") is None
    n.modules.unload("delayed")
    assert n.broker.delayed is None
    return (res, early, due, _inbox(s), n.metrics.val("messages.dropped"),
            n.metrics.val("messages.delayed"))


def test_delayed_module_intercepts_and_republishes():
    both(_delayed_republishes)


def _delayed_passes_through(P):
    n = P.Node()
    n.modules.load(P.Delayed)
    s = Q()
    n.broker.subscribe(s, "$delayed/nope")
    out = [n.publish(P.Message(topic="$delayed/nope")),
           n.publish(P.Message(topic="$delayed/x/nope"))]  # not a number
    assert out[0] == 1
    dm = n.modules._loaded["delayed"]
    # the cap: a huge delay is clamped to MAX_DELAY seconds
    n.publish(P.Message(topic="$delayed/99999999999/cap/t"))
    cap = dm._heap[0][0] - time.time()
    return out, len(dm), round(cap, -2), _inbox(s)


def test_delayed_bad_prefix_passes_through():
    both(_delayed_passes_through)


async def _delayed_timer(P):
    """The timer runs on the loop: a load inside a running loop starts
    it, node.stop() stops it (the module stays loaded) and
    node.start() starts it again."""
    n = P.Node()
    n.modules.load(P.Delayed)
    dm = n.modules._loaded["delayed"]
    s = Q()
    n.broker.subscribe(s, "t/late")
    at_load = dm._task is not None
    await n.start()
    await n.stop()
    stopped = dm._task is None
    await n.start()
    try:
        restarted = dm._task is not None
        n.publish(P.Message(topic="$delayed/0/t/late", payload=b"z"))
        for _ in range(100):
            if s.inbox:
                break
            await asyncio.sleep(0.05)
    finally:
        await n.stop()
    return at_load, stopped, restarted, _inbox(s)


async def test_delayed_timer_runs_on_the_loop():
    out = await both_async(_delayed_timer)
    assert out == (True, True, True, [("t/late", "t/late", b"z", 0)])


# -- presence ------------------------------------------------------------------

def _presence(P):
    n = P.Node()
    n.modules.load(P.Presence, {"qos": 1})
    s = Q()
    n.broker.subscribe(s, f"$SYS/brokers/{n.name}/clients/#")
    root = Q()
    n.broker.subscribe(root, "#")  # '#' never matches $SYS
    n.hooks.run("client.connected",
                ({"clientid": "c1", "peerhost": "127.0.0.1",
                  "username": "u", "proto_ver": 5, "keepalive": 30,
                  "clean_start": True},
                 {"connected_at": 12.5}))
    n.hooks.run("client.disconnected", ({"clientid": "c1"}, "bye"))
    assert len(s.inbox) == 2
    assert s.inbox[0][1].topic.endswith("c1/connected")
    assert s.inbox[1][1].topic.endswith("c1/disconnected")
    out = []
    for _t, m in s.inbox:
        body = json.loads(bytes(m.payload))
        body.pop("ts")
        out.append((m.topic, m.qos, m.get_flag("sys"), body))
    return out, root.inbox


def test_presence_publishes_sys_events():
    out, root = both(_presence)
    assert root == []
    assert sorted(out[0][3]) == ["clean_start", "clientid", "connected_at",
                                 "ipaddress", "keepalive", "proto_ver",
                                 "username"]
    assert out[1][3] == {"clientid": "c1", "username": None,
                         "reason": "bye"}


# -- rewrite -------------------------------------------------------------------

def _rewrite(P):
    n = P.Node()
    n.modules.load(P.Rewrite, {"rules": [
        ("all", "x/#", r"^x/y/(.+)$", r"z/y/$1"),
        ("pub", "b/#", r"^b/(\w)/(\w)/(\w)/(\w)/(\w)/(\w)/(\w)/(\w)/(\w)/"
                        r"(\w)$", r"o/$10/$1"),
        ("sub", "s/#", r"^s/(.+)$", r"t/$1"),
    ]})
    s = Q()
    n.broker.subscribe(s, "z/y/1")
    o = Q()
    n.broker.subscribe(o, "o/#")
    sysq = Q()
    n.broker.subscribe(sysq, "$SYS/x/y/1")
    res = [n.publish(P.Message(topic="x/y/1")),
           # $1 is replaced before $10: the JAX order, kept
           n.publish(P.Message(topic="b/a/b/c/d/e/f/g/h/i/j")),
           n.publish(P.Message(topic="$SYS/x/y/1"))]  # never rewritten
    assert res[0] == 1
    tf = n.hooks.run_fold("client.subscribe", ({}, {}),
                          [("x/y/2", {"qos": 0}), ("s/q", {"qos": 1})])
    assert tf[0] == ("z/y/2", {"qos": 0})
    uf = n.hooks.run_fold("client.unsubscribe", ({}, {}),
                          ["x/y/3", "s/r", "b/1"])
    n.modules.unload("rewrite")
    after = n.publish(P.Message(topic="x/y/1"))
    return res, tf, uf, after, _inbox(s), _inbox(o), _inbox(sysq)


def test_rewrite_pub_and_sub():
    res, tf, uf, after, s, o, sysq = both(_rewrite)
    assert o[0][1] == "o/a0/a"
    assert uf == ["z/y/3", "t/r", "b/1"]
    assert after == 0 and sysq[0][1] == "$SYS/x/y/1"


# -- topic metrics -------------------------------------------------------------

def _topic_metrics_counts(P):
    n = P.Node()
    n.modules.load(P.TopicMetrics, {"topics": ["m/t"]})
    tm = n.modules._loaded["topic_metrics"]
    with pytest.raises(ValueError):
        tm.register("bad/#")
    n.publish(P.Message(topic="m/t", qos=1))
    n.publish(P.Message(topic="m/t"))
    n.publish(P.Message(topic="other"))
    m = tm.metrics("m/t")
    assert m["messages.in"] == 2 and m["messages.qos1.in"] == 1
    assert tm.metrics("other") is None
    rates = tm.rates("m/t")
    full = [tm.register(f"lim/{i}") for i in range(600)]
    tm.unregister("m/t")
    return (m, sorted(rates), all(v >= 0 for v in rates.values()),
            full.count(True), len(tm.all_topics()), tm.rates("m/t"))


def test_topic_metrics_counts():
    out = both(_topic_metrics_counts)
    assert out[3] == 511  # MAX_TOPICS with m/t registered


def _topic_metrics_dropped_and_out(P):
    n = P.Node()
    n.modules.load(P.TopicMetrics, {"topics": ["d/t"]})
    tm = n.modules._loaded["topic_metrics"]
    n.publish(P.Message(topic="d/t"))  # no subscribers -> dropped
    assert tm.metrics("d/t")["messages.dropped"] == 1
    s = Q()
    n.broker.subscribe(s, "d/t")
    s2 = Q("q2")
    n.broker.subscribe(s2, "d/+")
    n.publish(P.Message(topic="d/t"))
    out = tm.metrics("d/t")
    n.modules.unload("topic_metrics")
    return out, tm.all_topics()


def test_topic_metrics_dropped_and_out():
    out, left = both(_topic_metrics_dropped_and_out)
    assert out["messages.out"] == 2 and left == []


# -- acl file ------------------------------------------------------------------

def _acl_rules(P):
    n = P.Node()
    n.modules.load(P.acl.AclFileModule, {"rules": [
        ("allow", ("user", "dash"), "subscribe", ["$SYS/#"]),
        ("deny", "all", "subscribe", ["$SYS/#", ("eq", "#")]),
        ("deny", ("client", "bad"), "pubsub", ["#"]),
        ("deny", ("ipaddr", "192.168.0.0/16"), "publish", ["%c/#"]),
        ("allow", "all", "pubsub", ["#"]),
    ]})
    ac = P.Access(n.hooks, P.Zone())
    dash = P.ClientInfo(clientid="d", username="dash", peerhost="9.9.9.9")
    anon = P.ClientInfo(clientid="a", peerhost="9.9.9.9")
    bad = P.ClientInfo(clientid="bad", peerhost="9.9.9.9")
    lan = P.ClientInfo(clientid="lan", peerhost="192.168.4.4")
    junk = P.ClientInfo(clientid="j", peerhost="not-an-ip")
    out = [ac.check_acl(dash, "subscribe", "$SYS/x"),
           ac.check_acl(anon, "subscribe", "$SYS/x"),
           ac.check_acl(anon, "subscribe", "#"),      # eq(#)
           ac.check_acl(anon, "subscribe", "a/b"),
           ac.check_acl(bad, "publish", "a"),
           ac.check_acl(anon, "publish", "a"),
           ac.check_acl(lan, "publish", "lan/x"),     # %c in the filter
           ac.check_acl(lan, "publish", "other/x"),
           ac.check_acl(junk, "publish", "j/x")]
    assert out[:6] == ["allow", "deny", "deny", "allow", "deny", "allow"]
    return out


def test_acl_rules():
    out = both(_acl_rules)
    assert out[6:] == ["deny", "allow", "allow"]


def test_acl_conf_file_parsing_the_shipped_file():
    """Both parsers on ``etc/acl.conf``, the reference's shipped rules:
    equal rule lists, ending in the catch-all allow."""
    text = open("etc/acl.conf").read()
    ours = pacl.parse_acl_file(text)
    assert ours == jacl.parse_acl_file(text)
    assert ("deny", "all", "subscribe", ["$SYS/#", ("eq", "#")]) in ours
    assert ours[-1][0] == "allow"
    for bad in ("{allow, all, x}.", "{maybe, all}.", "[1]."):
        with pytest.raises(ValueError) as pe:
            pacl.parse_acl_file(bad)
        with pytest.raises(ValueError) as je:
            jacl.parse_acl_file(bad)
        assert str(pe.value) == str(je.value)


def _acl_file_module(P, path):
    n = P.Node()
    mod = n.modules.load(P.acl.AclFileModule, env={"file": str(path)})
    deny = mod.check_acl({"username": "evil", "clientid": "c",
                          "peerhost": "10.0.0.1"}, "publish", "secret/x",
                         None)
    ok = mod.check_acl({"username": "good", "clientid": "c",
                        "peerhost": "10.0.0.1"}, "publish", "secret/x", None)
    # the {allow, all} catch-all also covers $-topics '#' excludes
    sys_ok = mod.check_acl({"username": "good", "clientid": "c",
                            "peerhost": "10.0.0.1"}, "subscribe",
                           "$SYS/brokers", None)
    assert deny == (P.STOP, "deny") and ok == (P.STOP, "allow")
    n.modules.unload("acl_internal")
    return deny, ok, sys_ok, n.hooks.lookup("client.check_acl")


def test_acl_file_module_loads_from_file(tmp_path):
    path = tmp_path / "acl.conf"
    path.write_text(
        '{deny, {user, "evil"}, publish, ["secret/#"]}.\n'
        '{allow, all}.\n')
    out = both(_acl_file_module, path)
    assert out[2] == ("stop", "allow") and out[3] == []


def test_acl_conf_escaped_quote_in_string():
    for acl in (jacl, pacl):
        rules = acl.parse_acl_file(
            '{allow, {user, "a\\"b%c"}, publish, ["t/1"]}.\n')
        assert rules == [("allow", ("user", 'a"b%c'), "publish", ["t/1"])]
        rules = acl.parse_acl_file(
            '{allow, {user, "u"}, publish, ["t/2"]}. %% tail comment\n')
        assert rules == [("allow", ("user", "u"), "publish", ["t/2"])]


# -- the registry and the default modules ---------------------------------------

def _registry(P):
    n = P.Node()
    mod = n.modules.load(P.Presence)
    again = n.modules.load(P.Presence)
    assert again is mod
    loaded = n.modules.loaded()
    assert "presence" in loaded
    first = n.modules.unload("presence")
    second = n.modules.unload("presence")
    assert first and not second
    s = Q()
    n.broker.subscribe(s, "$SYS/#")
    n.hooks.run("client.connected", ({"clientid": "x"}, {}))
    assert s.inbox == []
    return loaded, first, second, n.modules.loaded()


def test_module_registry_load_unload():
    both(_registry)


async def _default_modules(P):
    a = P.Node()
    a.load_default_modules()
    a.load_default_modules()  # idempotent
    eager = a.modules.loaded()
    b = P.Node(load_default_modules=True)
    before = b.modules.loaded()
    b.add_listener(port=0)
    await b.start()
    try:
        at_start = b.modules.loaded()
        hooked = [len(b.hooks.lookup(h)) for h in (
            "message.publish", "client.check_acl", "session.subscribed")]
        delayed = b.broker.delayed is b.modules._loaded["delayed"]
    finally:
        await b.stop()
    return eager, before, at_start, hooked, delayed


async def test_load_default_modules():
    out = await both_async(_default_modules)
    assert out[0] == ["delayed", "acl_internal", "retainer"]
    assert out[1] == [] and out[2] == out[0] and out[4]


# -- auto-subscribe ------------------------------------------------------------

async def _auto_subscribe(P):
    n = P.Node()
    lst = n.add_listener(port=0)
    await n.start()
    try:
        mod = n.modules.load(P.Subscription, env={
            "topics": [("client/%c/inbox", 1), ("user/%u/all", 0),
                       ("bad/#/x", 0)]})
        c = TestClient("auto-c1", username="u9")
        await c.connect(port=lst.port)
        await asyncio.sleep(0.1)
        sess = n.cm.lookup_channel("auto-c1").session
        subs = sorted((f, o.qos) for f, o in sess.subscriptions.items())
        # no session.subscribed for an auto-subscription (the JAX
        # behaviour; the reference's goes through the channel)
        p = TestClient("auto-pub")
        await p.connect(port=lst.port)
        await p.publish("client/auto-c1/inbox", b"hi", qos=1)
        pkt = await c.recv(timeout=10)
        got = (pkt.topic, pkt.payload)
        await c.disconnect()
        n.modules.unload(mod.name)
        c2 = TestClient("auto-c2")
        await c2.connect(port=lst.port)
        await asyncio.sleep(0.1)
        left = dict(n.cm.lookup_channel("auto-c2").session.subscriptions)
        await c2.disconnect()
        await p.disconnect()
    finally:
        await n.stop()
    return subs, got, left


async def test_subscription_module_auto_subscribes_on_connect():
    subs, got, left = await both_async(_auto_subscribe)
    assert subs == [("client/auto-c1/inbox", 1), ("user/u9/all", 0)]
    assert got == ("client/auto-c1/inbox", b"hi") and left == {}


async def _auto_subscribe_no_replay(P):
    """The auto-subscription fires no session.subscribed, so a retained
    message on its filter is not replayed (kept from the JAX package)."""
    n = P.Node()
    n.modules.load(P.Retainer)
    n.modules.load(P.Subscription, env={"topics": [("ret/%c", 1)]})
    fired = []
    n.hooks.add("session.subscribed", lambda *a: fired.append(a[1]))
    n.publish(P.Message(topic="ret/rc1", payload=b"kept", qos=1,
                        flags={"retain": True}))
    lst = n.add_listener(port=0)
    await n.start()
    try:
        c = TestClient("rc1")
        await c.connect(port=lst.port)
        await asyncio.sleep(0.2)
        try:
            pkt = await c.recv(timeout=0.3)
            replayed = pkt.payload
        except (asyncio.TimeoutError, TimeoutError):
            replayed = None
        subs = sorted(n.cm.lookup_channel("rc1").session.subscriptions)
        await c.disconnect()
    finally:
        await n.stop()
    return fired, replayed, subs


async def test_auto_subscription_replays_no_retained_message():
    fired, replayed, subs = await both_async(_auto_subscribe_no_replay)
    assert fired == [] and replayed is None and subs == ["ret/rc1"]


# -- the modules on BASELINE config 2's filter shapes, at a small size ----------

class Sink:
    def __init__(self, sid):
        self.sid = sid
        self.got = []

    def deliver(self, topic_filter, msg):
        self.got.append((self.sid, topic_filter, msg.topic,
                         bytes(msg.payload)))


def _config2_node(P, seed):
    """A node holding config 2's filter classes (``+``, literal, ``#``,
    ``$share``, 2 big filters on the bitmap path); the sinks, the
    drawable filters, and an oracle of its filters."""
    rng = np.random.default_rng(seed)
    wl = chip_smoke.make_workload(rng, 600, 60, 2, 40)
    n = P.Node(matcher=P.Matcher(fanout_threshold=32))
    sinks = {}
    pairs = []
    for f in wl["plus"] + wl["literal"] + wl["hash"]:
        pairs.append((len(sinks), f))
        sinks[len(sinks)] = Sink(len(sinks))
    for f in wl["shared"]:
        for _ in range(4):
            pairs.append((len(sinks), f"$share/g/{f}"))
            sinks[len(sinks)] = Sink(len(sinks))
    for f in wl["big"]:
        for i in rng.choice(len(wl["plus"]), size=40, replace=False):
            pairs.append((int(i), f))
    for sid, f in pairs:
        n.broker.subscribe(sinks[sid], f)
    oracle = TrieOracle()
    for _sid, f in pairs:
        oracle.insert(f[len("$share/g/"):] if f.startswith("$share/")
                      else f)
    draw = wl["plus"] + wl["literal"] + wl["hash"] + wl["shared"] + wl["big"]
    topics = chip_smoke.zipf_topics(rng, draw, 3 * 64)
    return n, sinks, pairs, oracle, topics


def _oracle_check(pairs, oracle, topics, got, results):
    """Every topic's deliveries against the oracle: each subscriber of
    each matched filter once, one member per shared group."""
    subs = {}
    for sid, f in pairs:
        subs.setdefault(f, []).append(sid)
    per = {}
    for sid, flt, topic, payload in got:
        per.setdefault(payload, Counter())[(sid, flt)] += 1
    for i, topic in enumerate(topics):
        want = Counter()
        groups = 0
        for f in oracle.match(topic):
            for sid in subs.get(f, ()):
                want[(sid, f)] += 1
            if f"$share/g/{f}" in subs:
                groups += 1
        have = per.get(str(i).encode(), Counter())
        local = Counter({k: v for k, v in have.items()
                         if not k[1].startswith("$share/")})
        shared = sum(v for k, v in have.items()
                     if k[1].startswith("$share/"))
        assert local == want and shared == groups, topic
        assert results[i] == sum(want.values()) + groups, topic


def _rewrite_config2(P, seed):
    n, sinks, pairs, oracle, topics = _config2_node(P, seed)
    n.modules.load(P.Rewrite, {"rules": [
        ("pub", "mod/#", r"^mod/(.+)$", r"$1")]})
    n.modules.load(P.TopicMetrics, {"topics": topics[:8]})
    tm = n.modules._loaded["topic_metrics"]
    results = []
    for b in range(3):
        msgs = [P.Message(topic=f"mod/{t}", payload=str(64 * b + i).encode())
                for i, t in enumerate(topics[64 * b:64 * b + 64])]
        results += n.broker.publish_batch(msgs)
    got = sorted(x for s in sinks.values() for x in s.got)
    _oracle_check(pairs, oracle, topics, got, results)
    counts = {t: tm.metrics(t) for t in topics[:8]}
    for t, c in counts.items():
        assert c["messages.in"] == topics.count(t)
        assert c["messages.out"] == sum(
            results[i] for i, x in enumerate(topics) if x == t)
    return got, results, counts


@pytest.mark.parametrize("seed", [0, 1])
def test_rewrite_on_config2_shapes_matches_jax_and_oracle(seed):
    both(_rewrite_config2, seed)


def _delayed_config2(P, seed):
    n, sinks, pairs, oracle, topics = _config2_node(P, seed)
    n.modules.load(P.Delayed)
    dm = n.modules._loaded["delayed"]
    topics = topics[:64]
    held = n.broker.publish_batch([
        P.Message(topic=f"$delayed/1/{t}", payload=str(i).encode())
        for i, t in enumerate(topics)])
    assert held == [0] * len(topics) and len(dm) == len(topics)
    assert not any(s.got for s in sinks.values())
    assert n.metrics.val("messages.delayed") == len(topics)
    # one publish a due message, one device batch each
    results = []
    orig = n.broker.publish

    def counted(msg):
        results.append(orig(msg))
        return results[-1]

    n.broker.publish = counted
    ticked = dm.tick(now=time.time() + 2)
    got = sorted(x for s in sinks.values() for x in s.got)
    _oracle_check(pairs, oracle, topics, got, results)
    return ticked, got, results, len(dm)


@pytest.mark.parametrize("seed", [0, 1])
def test_delayed_on_config2_shapes_matches_jax_and_oracle(seed):
    out = both(_delayed_config2, seed)
    assert out[0] == 64 and out[3] == 0


# -- fault C.7: the retainer's sweep while another store lands -----------------

def _c7(P, concurrent):
    n = P.Node()
    ret = n.modules.load(P.Retainer)
    for i in range(8):
        n.publish(P.Message(topic=f"r/{i}", payload=b"x%d" % i,
                            flags={"retain": True}))
    fired = []

    class Trap(P.Message):
        def is_expired(self):
            if concurrent and not fired:
                # what the serving thread does while the heal thread
                # sweeps: a new retained message lands in the store
                fired.append(1)
                n.publish(P.Message(topic="r/new", payload=b"n",
                                    flags={"retain": True}))
            return True

    ret._put("r/trap", Trap(topic="r/trap", payload=b"t",
                            flags={"retain": True}))
    swept = ret.sweep_expired()
    if not concurrent:
        n.publish(P.Message(topic="r/new", payload=b"n",
                            flags={"retain": True}))
    return swept, sorted((t, bytes(m.payload))
                         for t, m in ret._store.items())


def test_c7_sweep_survives_a_store_during_the_iteration():
    """The JAX retainer's sweep raises ``RuntimeError: dictionary
    changed size during iteration``; the port's leaves the store a
    quiet sweep followed by the same store leaves."""
    with pytest.raises(RuntimeError, match="changed size"):
        _c7(JAX, True)
    quiet = _c7(PORT, False)
    assert _c7(PORT, True) == quiet == _c7(JAX, False)
    assert quiet[0] == 1 and ("r/new", b"n") in quiet[1]
    assert "r/trap" not in dict(quiet[1])
