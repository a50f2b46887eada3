"""Device-loss recovery and the device-path breaker, the port against
the JAX package in lockstep.

A JAX ``Node`` and a port ``Node(device="cpu")`` (device matching from
the first filter, so every batch takes the device path: the plain
twins of kernels B1 and B2 on the port) each carry the breaker and the
recovery at the given ``OverloadConfig``. The same subscriptions,
publishes and armed faults (both registries, same specs) go to both.
After every batch: equal delivery counts, equal per-subscriber
deliveries, equal breaker states (OPEN and REBUILDING alike: the
recovery thread moves between them on its own clock); at the end,
equal ``breaker.*``
counters — all but ``breaker.rebuild.failures``, whose count depends
on how many backoff retries fit before the test disarms the fault
(both must be ≥ 1). Recovery runs on its own thread in each package,
so a test waits for a state with a deadline, never on a bare sleep;
cooldowns and backoffs are tens of milliseconds.

Also: no plain walk or bitmap-OR call while the breaker is open,
``warm_plan`` equal to the JAX one, the retainer riding the
suspension and its failure breaker, a QoS 1 socket stream through a
device loss with nothing lost or duplicated, and a kernel library
that fails to build raising out of the constructor.
"""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

import indie_mqtt as im
from emqx_tpu import faults as jf
from emqx_tpu.modules.retainer import RetainIndex as JRetainIndex
from emqx_tpu.node import Node as JNode
from emqx_tpu.ops import warmup as jwarm
from emqx_tpu.overload import OverloadConfig as JConfig
from emqx_tpu.router import MatcherConfig as JMatcherConfig
from emqx_tpu.router import Router as JRouter
from emqx_tpu.types import Message as JMessage
from emqx_tpu_torch import devloss
from emqx_tpu_torch import faults as pf
from emqx_tpu_torch import router as prouter
from emqx_tpu_torch.broker import Broker
from emqx_tpu_torch.modules.retainer import RetainIndex
from emqx_tpu_torch.node import Node
from emqx_tpu_torch.ops import _build
from emqx_tpu_torch.ops import warmup as pwarm
from emqx_tpu_torch.overload import DeviceBreaker, OverloadConfig
from emqx_tpu_torch.router import MatcherConfig, Router
from emqx_tpu_torch.types import Message

CLOSED, HALF_OPEN, OPEN, REBUILDING = (
    DeviceBreaker.CLOSED, DeviceBreaker.HALF_OPEN, DeviceBreaker.OPEN,
    DeviceBreaker.REBUILDING)
#: counters the two packages must agree on exactly
COUNTERS = ("breaker.failures", "breaker.trips", "breaker.probes",
            "breaker.fallback.batches", "breaker.rebuilds")


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in (jf, pf):
        f.clear()
        f.set_master(True)
    try:
        yield
    finally:
        for f in (jf, pf):
            f.clear()
            f.set_master(True)


def wait_for(cond, timeout=15.0, step=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


def recovery_cfg(**over):
    kw = dict(breaker_failures=2, breaker_cooldown_s=30.0,
              rebuild_backoff_s=0.02, sentinel_timeout_s=1.0)
    kw.update(over)
    return kw


class Sink:
    def __init__(self, name):
        self.client_id = name
        self.got = []

    def deliver(self, flt, msg):
        self.got.append((flt, msg.topic, bytes(msg.payload)))


class Rig:
    """The two nodes side by side."""

    def __init__(self, matcher=None, **ocfg):
        matcher = dict(device_min_filters=0, **(matcher or {}))
        self.jn = JNode(boot_listeners=False,
                        matcher=JMatcherConfig(**matcher),
                        overload=JConfig(**ocfg))
        self.pn = Node(device="cpu", matcher=MatcherConfig(**matcher),
                       overload=OverloadConfig(**ocfg))
        self.sinks = ({}, {})
        self.states = []

    @property
    def brs(self):
        return self.jn.broker.breaker, self.pn.broker.breaker

    def subscribe(self, name, flt):
        for node, sinks in zip((self.jn, self.pn), self.sinks):
            node.subscribe(sinks.setdefault(name, Sink(name)), flt)

    def unsubscribe(self, name, flt):
        for node, sinks in zip((self.jn, self.pn), self.sinks):
            node.broker.unsubscribe(sinks[name], flt)

    def publish(self, *topics, payload=b"p"):
        """One batch on both; returns the port's counts after checking
        counts, deliveries and breaker states equal."""
        res = []
        for node, mcls in ((self.jn, JMessage), (self.pn, Message)):
            res.append(node.broker.publish_batch(
                [mcls(topic=t, payload=payload) for t in topics]))
        assert res[0] == res[1], topics
        boxes = [{n: sorted(s.got) for n, s in sinks.items()}
                 for sinks in self.sinks]
        assert boxes[0] == boxes[1], topics
        for sinks in self.sinks:
            for s in sinks.values():
                s.got.clear()
        # OPEN → REBUILDING is the recovery thread's move, timed apart
        # in each package: per batch both count as the host's
        st = tuple(OPEN if b.state == REBUILDING else b.state
                   for b in self.brs)
        assert st[0] == st[1], topics
        self.states.append(st[1])
        return res[1]

    def arm(self, point, **kw):
        for f in (jf, pf):
            f.arm(point, **kw)

    def disarm(self, point):
        for f in (jf, pf):
            f.disarm(point)

    def wait_state(self, state, timeout=15.0):
        assert wait_for(lambda: all(b.state == state for b in self.brs),
                        timeout), [b.state for b in self.brs]

    def counters(self):
        got = [{k: n.metrics.val(k) for k in COUNTERS}
               for n in (self.jn, self.pn)]
        assert got[0] == got[1]
        return got[1]

    def active(self):
        out = [sorted(a.name for a in n.alarms.get_alarms("activated"))
               for n in (self.jn, self.pn)]
        assert out[0] == out[1]
        return out[1]

    def close(self):
        for b in self.brs:
            if b is not None and b.recovery is not None:
                b.recovery.stop()


@pytest.fixture
def rig_factory():
    rigs = []

    def make(**kw):
        rigs.append(Rig(**kw))
        return rigs[-1]

    yield make
    for r in rigs:
        r.close()


# -- transient failures -------------------------------------------------------


def test_transient_trips_then_half_open_probe_closes(rig_factory):
    rig = rig_factory(**recovery_cfg(breaker_cooldown_s=0.2))
    rig.subscribe("s", "c/+")
    rig.subscribe("s", "c/#")
    rig.arm("device.fetch", times=2)
    for i in range(2):  # each failed fetch is served from the host
        assert rig.publish("c/t", payload=b"f%d" % i) == [2]
    assert rig.states == [CLOSED, OPEN]
    assert rig.active() == ["device_path_breaker"]
    assert rig.publish("c/t", payload=b"open") == [2]   # open: host
    # the sentinel answers: transient, no rebuild
    assert wait_for(lambda: all(b.recovery.last_classification
                                == "transient" for b in rig.brs))
    time.sleep(0.25)    # the cooldown clock
    assert rig.publish("c/t", payload=b"probe") == [2]
    assert rig.states[-1] == CLOSED
    assert rig.active() == []
    c = rig.counters()
    assert (c["breaker.trips"], c["breaker.failures"],
            c["breaker.probes"]) == (1, 2, 1)
    assert c["breaker.fallback.batches"] >= 1


def test_walk_failure_is_caught_and_host_served(rig_factory):
    rig = rig_factory()
    rig.subscribe("s", "w/1")
    rig.arm("device.walk", times=1)
    assert rig.publish("w/1") == [1]
    assert rig.counters()["breaker.failures"] == 1
    assert rig.states == [CLOSED]


def test_stalled_fetch_past_slow_ms_counts_as_failure(rig_factory):
    rig = rig_factory(breaker_failures=1, breaker_cooldown_s=30.0)
    rig.subscribe("s", "st/1")
    assert rig.publish("st/1", payload=b"warm") == [1]
    for b in rig.brs:
        b.slow_ms = 150.0
    rig.arm("device.fetch", action="stall", times=2, delay_ms=250.0)
    assert rig.publish("st/1", payload=b"slow") == [1]
    assert rig.states[-1] == OPEN
    assert rig.counters()["breaker.trips"] == 1


def test_breaker_off_reraises_the_device_failure(rig_factory):
    rig = rig_factory(enabled=False)
    assert rig.brs == (None, None)
    rig.subscribe("s", "r/1")
    rig.arm("device.fetch", times=1)
    for node, mcls, f in ((rig.jn, JMessage, jf), (rig.pn, Message, pf)):
        with pytest.raises(f.FaultInjected):
            node.broker.publish_batch([mcls(topic="r/1", payload=b"x")])


def test_breaker_batches_are_host_only_like_jax(rig_factory):
    """A batch the breaker sends to the host (failed fetch, open
    breaker) is marked ``host_only`` in both packages; a device batch
    is not."""
    rig = rig_factory(breaker_failures=1, breaker_cooldown_s=30.0,
                      breaker_rebuild=False)
    rig.subscribe("s", "h/+")
    out = []
    for node, mcls, f in ((rig.jn, JMessage, jf), (rig.pn, Message, pf)):
        b = node.broker
        pb = b.publish_begin([mcls(topic="h/1")])
        b.publish_fetch(pb)
        flags = [pb.host_only, b.publish_finish(pb)]
        f.arm("device.fetch", times=1)
        pb = b.publish_begin([mcls(topic="h/1")])
        b.publish_fetch(pb)                     # fails: host only
        flags += [pb.host_only, pb.host_topics is not None,
                  b.publish_finish(pb)]
        pb = b.publish_begin([mcls(topic="h/1")], defer_host=True)
        flags += [pb.host_only, pb.done, b.publish_finish(pb)]   # open
        out.append(flags)
    assert out[0] == out[1] == [False, [1], True, True, [1],
                                True, False, [1]]


# -- device loss -------------------------------------------------------------


def test_device_loss_classifies_rebuilds_and_auto_closes(rig_factory):
    rig = rig_factory(**recovery_cfg())
    rig.subscribe("s", "dl/+")
    rig.subscribe("s", "dl/#")
    assert rig.publish("dl/t", payload=b"warm") == [2]
    epochs = [n.router._rebuilds for n in (rig.jn, rig.pn)]
    rig.arm("device.lost", times=0)
    try:
        for i in range(2):   # the outage: every batch host-matched
            assert rig.publish("dl/t", payload=b"out%d" % i) == [2]
        rig.wait_state(REBUILDING)
        # suspended: later batches take the host regime, not the
        # breaker's fallback, so the counters below are exact
        assert wait_for(lambda: all(n.router.device_suspended()
                                    for n in (rig.jn, rig.pn)))
        for n in (rig.jn, rig.pn):
            assert n.broker.breaker.recovery.last_classification == "lost"
        assert "device_path_lost" in rig.active()
        assert rig.publish("dl/t", payload=b"out2") == [2]
        assert wait_for(lambda: all(b.recovery.rebuild_failures >= 1
                                    for b in rig.brs))
        assert rig.publish("dl/t", payload=b"mid") == [2]
    finally:
        rig.disarm("device.lost")
    rig.wait_state(HALF_OPEN)
    for n, e0 in zip((rig.jn, rig.pn), epochs):
        rec = n.broker.breaker.recovery
        assert rec.rebuilds == 1 and rec.last_rebuild_s is not None
        assert not n.router.device_suspended()
        assert n.router._rebuilds > e0      # fresh tables
        assert n.metrics.val("breaker.rebuild.failures") >= 1
    assert rig.publish("dl/t", payload=b"probe") == [2]
    assert rig.states[-1] == CLOSED
    assert rig.active() == []
    c = rig.counters()
    # the fallbacks are the two alarm publishes: device_path_breaker
    # at the trip (OPEN) and device_path_lost (REBUILDING, before the
    # suspension)
    assert (c["breaker.trips"], c["breaker.rebuilds"], c["breaker.probes"],
            c["breaker.failures"], c["breaker.fallback.batches"]) == \
        (1, 1, 1, 2, 2)


def test_device_loss_again_mid_rebuild(rig_factory):
    """The backend dies again during the re-warm (device.fetch): that
    attempt fails too, and only a clean rebuild + warm admits the
    probe."""
    rig = rig_factory(**recovery_cfg(breaker_failures=1))
    rig.subscribe("s", "dd/1")
    assert rig.publish("dd/1", payload=b"warm") == [1]
    rig.arm("device.lost", times=0)
    try:
        assert rig.publish("dd/1", payload=b"out") == [1]
        assert wait_for(lambda: all(b.recovery.rebuild_failures >= 1
                                    for b in rig.brs))
        rig.arm("device.fetch", action="raise", times=1)
    finally:
        rig.disarm("device.lost")
    rig.wait_state(HALF_OPEN)
    for b in rig.brs:
        assert b.recovery.rebuild_failures >= 2
        assert b.recovery.rebuilds == 1
    assert rig.publish("dd/1", payload=b"probe") == [1]
    assert rig.states[-1] == CLOSED
    rig.counters()


def test_rebuild_under_route_churn_matches_the_oracle(rig_factory):
    """Route ops landing DURING the rebuild's off-lock flatten complete
    quickly and reach the fresh tables; the rebuilt device match
    equals the host trie on the churned set, in both packages."""
    rig = rig_factory(**recovery_cfg(breaker_failures=1))
    for i in range(6):
        rig.subscribe(f"s{i}", f"rc/{i}")
    assert rig.publish("rc/0", payload=b"warm") == [1]
    rig.arm("device.lost", times=0)
    try:
        assert rig.publish("rc/0", payload=b"trip") == [1]
        assert wait_for(lambda: all(b.recovery.rebuild_failures >= 1
                                    for b in rig.brs))
        # stretch the successful attempt's flatten: churn lands in it
        rig.arm("compaction.flatten", action="stall", times=1,
                delay_ms=300.0)
    finally:
        rig.disarm("device.lost")
    t0 = time.monotonic()
    rig.subscribe("late", "rc/late/+")
    rig.subscribe("late", "rc/0")
    rig.unsubscribe("s5", "rc/5")
    assert time.monotonic() - t0 < 5.0
    rig.wait_state(HALF_OPEN)
    assert rig.publish("rc/0", payload=b"probe") == [2]
    assert rig.states[-1] == CLOSED
    topics = [f"rc/{i}" for i in range(6)] + ["rc/late/x", "rc/none"]
    for n in (rig.jn, rig.pn):
        dev = n.router.match_filters(topics)
        host = n.router.match_filters_host(topics)
        assert [sorted(r) for r in dev] == [sorted(r) for r in host]
        assert dev[5] == [] and dev[6] == ["rc/late/+"]
    assert rig.publish("rc/late/x", payload=b"new") == [1]
    assert rig.pn.router._filter_ids == rig.jn.router._filter_ids


def test_breaker_rebuild_off_probes_forever(rig_factory):
    rig = rig_factory(**recovery_cfg(breaker_rebuild=False,
                                     breaker_failures=1,
                                     breaker_cooldown_s=0.1))
    assert all(b.recovery is None for b in rig.brs)
    rig.subscribe("s", "lg/1")
    assert rig.publish("lg/1", payload=b"warm") == [1]
    rig.arm("device.lost", times=0)
    try:
        assert rig.publish("lg/1", payload=b"t") == [1]
        assert rig.states[-1] == OPEN
        time.sleep(0.12)
        # the probe runs against the dead backend and re-opens
        assert rig.publish("lg/1", payload=b"p") == [1]
        assert rig.states[-1] == OPEN
    finally:
        rig.disarm("device.lost")
    time.sleep(0.12)
    assert rig.publish("lg/1", payload=b"ok") == [1]
    assert rig.states[-1] == CLOSED
    assert rig.counters()["breaker.probes"] == 2


# -- the open breaker launches nothing ---------------------------------------


def test_open_breaker_never_reaches_the_walk_or_the_or(monkeypatch):
    """While the breaker is OPEN or REBUILDING no batch reaches the
    port's walk (B1's plain twin) or bitmap OR (B2's); after the probe
    closes it, both run again."""
    from emqx_tpu_torch import broker as pbroker
    from emqx_tpu_torch.ops import delta as pdelta

    calls = {"walk": 0, "or": 0}

    def counted(fn, key):
        def wrap(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrap

    monkeypatch.setattr(prouter, "match_batch_auto",
                        counted(prouter.match_batch_auto, "walk"))
    monkeypatch.setattr(pdelta, "match_batch_auto",
                        counted(pdelta.match_batch_auto, "walk"))
    monkeypatch.setattr(pbroker, "or_union_rows_auto",
                        counted(pbroker.or_union_rows_auto, "or"))
    node = Node(device="cpu",
                matcher=MatcherConfig(device_min_filters=0,
                                      fanout_threshold=2),
                overload=OverloadConfig(**recovery_cfg(
                    breaker_failures=1)))
    br = node.broker.breaker
    sinks = [Sink(f"b{i}") for i in range(4)]
    for s in sinks:                 # > fanout_threshold: bitmap path
        node.subscribe(s, "big/t")
    node.subscribe(sinks[0], "x/+")

    def pub(topic):
        return node.broker.publish_batch([Message(topic=topic)])

    assert pub("big/t") == [4] and calls["walk"] > 0 and calls["or"] > 0
    pf.arm("device.lost", times=0)
    try:
        assert pub("big/t") == [4]
        assert wait_for(lambda: br.state == REBUILDING)
        before = dict(calls)
        for t in ("big/t", "x/y", "none"):
            pub(t)
        assert calls == before
    finally:
        pf.disarm("device.lost")
    assert wait_for(lambda: br.state == HALF_OPEN)
    warmed = dict(calls)
    assert warmed["walk"] > before["walk"]   # the re-warm walked
    assert pub("big/t") == [4] and br.state == CLOSED
    assert calls["walk"] > warmed["walk"] and calls["or"] > warmed["or"]
    assert sum(len(s.got) for s in sinks) == 4 * 4 + 1   # + x/y


def test_open_breaker_fallback_never_enters_the_router_device_seams():
    node = Node(device="cpu", matcher=MatcherConfig(device_min_filters=0),
                overload=OverloadConfig(**recovery_cfg(breaker_failures=1)))
    s = Sink("s")
    node.subscribe(s, "ho/1")
    assert node.broker.publish_batch([Message(topic="ho/1")]) == [1]

    def boom(*a, **k):
        raise AssertionError("device path entered during fallback")

    pf.arm("device.lost", times=0)
    try:
        assert node.broker.publish_batch([Message(topic="ho/1")]) == [1]
        # the recovery thread enters REBUILDING, then suspends the
        # router's device matching: the checks start once both hold
        assert wait_for(lambda: node.broker.breaker.state == REBUILDING
                        and node.router.device_suspended())
        node.router.match_dispatch = boom
        node.router.match_ids = boom
        assert node.broker.publish_batch([Message(topic="ho/1")]) == [1]
        assert node.router.match_filters(["ho/1"]) == [["ho/1"]]
    finally:
        for name in ("match_dispatch", "match_ids"):
            node.router.__dict__.pop(name, None)
        pf.disarm("device.lost")
    assert len(s.got) == 3


# -- the router's quarantine and rebuild ---------------------------------------


@pytest.mark.parametrize("delta", [True, False])
def test_rebuild_device_state_in_lockstep_with_jax(delta):
    kw = dict(device_min_filters=0, delta=delta, delta_max_filters=64)
    jr = JRouter(config=JMatcherConfig(**kw))
    pr = Router(config=MatcherConfig(**kw), device="cpu")
    flts = ["a/+", "a/b", "#", "x/+/z", "$SYS/#"]
    topics = ["a/b", "a/c", "x/y/z", "$SYS/up", "q"]
    for r in (jr, pr):
        for f in flts:
            r.add_route(f)
        r.match_filters(topics)
        r.add_route("late/+")          # a pending delta add
        r.delete_route("a/b")           # a tombstone
        r.suspend_device()
        assert not r.use_device_now()
    assert pr.match_filters(topics) == jr.match_filters(topics)
    infos = [r.rebuild_device_state() for r in (jr, pr)]
    assert infos[0]["filters"] == infos[1]["filters"] == 5
    assert infos[0]["epoch"] == infos[1]["epoch"]
    for r in (jr, pr):
        assert not r.device_suspended() and r.use_device_now()
    t2 = topics + ["late/x"]
    assert [sorted(x) for x in pr.match_filters(t2)] == \
        [sorted(x) for x in jr.match_filters(t2)] == \
        [sorted(x) for x in pr.match_filters_host(t2)]
    assert pr._filter_ids == jr._filter_ids
    assert pr.observed_levels() and set(pr.observed_levels()) <= \
        set(jr.observed_levels()) | set(pr.observed_levels())


def test_reclaim_host_regime_in_lockstep_with_jax():
    kw = dict(device_min_filters=8, host_reclaim_pending=3,
              match_cache=False)
    jr = JRouter(config=JMatcherConfig(**kw))
    pr = Router(config=MatcherConfig(**kw), device="cpu")
    for r in (jr, pr):
        for i in range(10):
            r.add_route(f"h/{i}")
        r.match_filters(["h/1"])       # device regime: a flatten
        for i in range(6):             # below the threshold again
            r.delete_route(f"h/{i}")
        assert not r.use_device_now()
        assert len(r._pending_free) == 6
        r.reclaim_host_regime()
        assert r._auto is None and not r._pending_free
        r.add_route("n/1")
    assert pr._filter_ids == jr._filter_ids
    assert sorted(pr._free_ids) == sorted(jr._free_ids)


# -- the re-warm --------------------------------------------------------------


@pytest.mark.parametrize("observed,min_batch,cap,levels", [
    ([], 8, 4, []), ([8, 4096, 256], 8, 4, [5]),
    ([4096, 16, 32, 64, 128, 4096], 8, 2, [3, 5, 16]),
    ([1, 0, 8], 16, 4, [1, 2]), ([512], 8, 1, [4, 4, 7]),
])
def test_warm_plan_equals_the_jax_one(observed, min_batch, cap, levels):
    assert pwarm.warm_plan(observed, min_batch, cap, levels) == \
        jwarm.warm_plan(observed, min_batch, cap, levels)
    rec_p, rec_j = {}, {}
    pwarm.stamp_first_batch(rec_p, 1.23456)
    jwarm.stamp_first_batch(rec_j, 1.23456)
    assert rec_p == rec_j


def test_warm_device_path_drives_the_seams_and_delivers_nothing():
    node = Node(device="cpu", matcher=MatcherConfig(device_min_filters=0))
    s = Sink("s")
    node.subscribe(s, "w/+")
    node.subscribe(s, "#")
    node.broker.publish_batch([Message(topic=f"w/{i}") for i in range(20)])
    s.got.clear()
    b = node.broker
    seen = {"begin": 0, "fetch": 0}
    begin, fetch = b._begin_device, b._fetch_device

    def cb(*a):
        seen["begin"] += 1
        return begin(*a)

    def cf(*a):
        seen["fetch"] += 1
        return fetch(*a)

    b._begin_device, b._fetch_device = cb, cf
    want = pwarm.warm_plan(list(b._pack_budgets), node.router.config.min_batch,
                           levels=node.router.observed_levels())
    delivered = node.metrics.val("messages.delivered")
    assert b.warm_device_path() == len(want) == seen["begin"] == \
        seen["fetch"] >= 2
    assert s.got == [] and node.metrics.val("messages.delivered") == delivered


# -- the sentinel --------------------------------------------------------------


def test_sentinel_answers_and_classifies_a_hung_device_lost(monkeypatch):
    assert devloss.sentinel_alive(1.0, torch.device("cpu"))
    with pf.injected("device.lost", times=1):
        assert not devloss.sentinel_alive(1.0, torch.device("cpu"))
    release = threading.Event()
    real = torch.ones

    def hung(*a, **k):
        release.wait(5.0)
        return real(*a, **k)

    monkeypatch.setattr(devloss.torch, "ones", hung)
    t0 = time.monotonic()
    try:
        assert not devloss.sentinel_alive(0.2, torch.device("cpu"))
        assert time.monotonic() - t0 < 2.0
    finally:
        release.set()


# -- the retainer -------------------------------------------------------------


NAMES = [f"s{i % 7}/g{i % 3}/d{i}/state" for i in range(64)] + \
    ["$SYS/x/y", "/".join(["deep"] * 20)]
FILTERS = ["s1/+/+/state", "s2/#", "#", "+/g0/#", "$SYS/#", "none/+",
           "deep/#"]


def test_retainer_rides_the_suspension_and_its_breaker_like_jax():
    r = Router(config=MatcherConfig(device_min_filters=0), device="cpu")
    r.add_route("a/+")
    jr = JRouter(config=JMatcherConfig(device_min_filters=0))
    jr.add_route("a/+")
    p, j = RetainIndex("cpu"), JRetainIndex()
    p.attach_router(r)
    j.attach_router(jr)
    for t in NAMES:
        p.add(t)
        j.add(t)

    def both():
        got = [sorted(map(sorted, ix.match_many(FILTERS, 1)))
               for ix in (p, j)]
        assert got[0] == got[1]
        return got[1]

    want = both()
    assert p.device_info()["cached"]
    for x in (r, jr):
        x.suspend_device()
    assert both() == want                    # the host scan
    assert p.device_info()["suspended"] and not p.device_info()["cached"]
    # failures while suspended burn no strikes; three on the device
    # path turn it off until the suspension lifts again
    for x in (r, jr):
        x.rebuild_device_state()
    calls = {"n": 0}
    real = p._match_device_many

    def broken(filters):
        calls["n"] += 1
        raise RuntimeError("launch failed")

    p._match_device_many = broken
    j._match_device_many = broken
    for i in range(4):
        assert both() == want
        assert p._device_broken == j._device_broken == min(i + 1, 3)
    assert calls["n"] == 6                   # 3 each, then host scans
    p._match_device_many = real
    del j._match_device_many
    for x in (r, jr):
        x.suspend_device()
    assert both() == want
    for x in (r, jr):
        x.rebuild_device_state()
    assert both() == want                    # the rebuild reset it
    assert p._device_broken == j._device_broken == 0
    assert p.device_info()["cached"]


def fallback_index(**kw):
    """A CPU retained index wired as the RetainerModule wires it, its
    B3 call (the plain twin here) patched to fail while ``fail`` is
    set."""
    from emqx_tpu_torch.alarm import AlarmManager
    from emqx_tpu_torch.metrics import Metrics

    r = Router(config=MatcherConfig(device_min_filters=0), device="cpu")
    r.add_route("a/+")
    p = RetainIndex("cpu")
    metrics, alarms = Metrics(), AlarmManager()
    p.attach_router(r, metrics, alarms)
    for t in NAMES:
        p.add(t)
    return r, p, metrics, alarms


def test_retainer_counts_every_host_scan_and_alarms_at_the_third_strike(
        monkeypatch):
    from emqx_tpu_torch.modules import retainer as pret

    r, p, metrics, alarms = fallback_index()
    want = sorted(map(sorted, p.match_many(FILTERS, 1)))
    state = {"fail": True, "calls": 0}
    real = pret.match_names_auto

    def b3(*a):
        state["calls"] += 1
        if state["fail"]:
            raise RuntimeError("launch failed")
        return real(*a)

    monkeypatch.setattr(pret, "match_names_auto", b3)

    def active():
        return [a.name for a in alarms.get_alarms("activated")]

    def counts():
        return (p.device_failures, p.fallbacks,
                metrics.val("retained.device.failures"),
                metrics.val("retained.device.fallback"))

    for i in range(4):
        assert sorted(map(sorted, p.match_many(FILTERS, 1))) == want
        strikes = min(i + 1, 3)
        assert counts() == (strikes, i + 1, strikes, i + 1)
        assert active() == (["retained_device_fallback"] if i >= 2 else [])
    assert state["calls"] == 3          # the fourth never launched
    # a success does not reset the counters, only the strikes
    state["fail"] = False
    r.suspend_device()
    assert sorted(map(sorted, p.match_many(FILTERS, 1))) == want
    assert counts() == (3, 5, 3, 5)     # the suspended scan counts too
    r.rebuild_device_state()
    assert sorted(map(sorted, p.match_many(FILTERS, 1))) == want
    assert counts() == (3, 5, 3, 5) and state["calls"] == 4
    assert active() == [] and p._device_broken == 0
    # one failure followed by a success still shows in the counters
    state["fail"] = True
    p.match_many(FILTERS, 1)
    state["fail"] = False
    p.match_many(FILTERS, 1)
    assert p._device_broken == 0 and counts() == (4, 6, 4, 6)
    assert p.device_info()["fallbacks"] == 6


def test_strict_retain_index_raises_a_failed_match(monkeypatch):
    """A CUDA index (``strict``) never host-scans a failed B3 match:
    it counts the failure and raises, every time; only the router's
    suspension (a confirmed loss) moves a match to the host."""
    from emqx_tpu_torch.modules import retainer as pret

    r, p, metrics, alarms = fallback_index()
    assert not p.strict             # the CPU's default
    p.strict = True
    want = sorted(map(sorted, p.match_many(FILTERS, 1)))

    def b3(*a):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(pret, "match_names_auto", b3)
    for i in range(4):
        with pytest.raises(RuntimeError, match="launch failed"):
            p.match_many(FILTERS, 1)
    assert (p.device_failures, p.fallbacks, p._device_broken) == (4, 0, 0)
    assert metrics.val("retained.device.failures") == 4
    assert alarms.get_alarms("activated") == []
    r.suspend_device()
    assert sorted(map(sorted, p.match_many(FILTERS, 1))) == want
    assert p.fallbacks == 1 and metrics.val("retained.device.fallback") == 1


# -- a strict (CUDA) breaker: only injected faults and a confirmed loss
# reach the host --------------------------------------------------------------


def strict_node(**over):
    """A CPU node whose breaker is strict, as a CUDA node's is."""
    node = Node(device="cpu",
                matcher=MatcherConfig(device_min_filters=0),
                overload=OverloadConfig(**recovery_cfg(**over)))
    br = node.broker.breaker
    assert not br.strict            # the CPU's default
    br.strict = True
    return node, br


def failing_walk(monkeypatch):
    """Patches the router's walk (B1's plain twin) to raise while
    ``state["fail"]`` is above 0, counting every call."""
    from emqx_tpu_torch.ops import delta as pdelta

    state = {"fail": 0, "calls": 0}

    def wrap(fn):
        def walk(*a, **k):
            state["calls"] += 1
            if state["fail"]:
                state["fail"] -= 1
                raise RuntimeError("launch failed")
            return fn(*a, **k)
        return walk

    monkeypatch.setattr(prouter, "match_batch_auto",
                        wrap(prouter.match_batch_auto))
    monkeypatch.setattr(pdelta, "match_batch_auto",
                        wrap(pdelta.match_batch_auto))
    return state


def test_strict_breaker_raises_real_failures_and_keeps_launching(
        monkeypatch):
    node, br = strict_node(breaker_cooldown_s=0.2)
    walk = failing_walk(monkeypatch)
    s = Sink("s")
    node.subscribe(s, "st/+")

    def pub(t):
        return node.broker.publish_batch([Message(topic=t)])

    walk["fail"] = 2
    for _ in range(2):
        with pytest.raises(RuntimeError, match="launch failed"):
            pub("st/0")
    assert br.state == OPEN and not br.diverts()
    assert [a.name for a in node.alarms.get_alarms("activated")] \
        == ["device_path_breaker"]
    assert wait_for(lambda: br.recovery.last_classification == "transient")
    # open, yet the batch launches on the device, not on the host
    n = walk["calls"]
    assert pub("st/1") == [1] and walk["calls"] == n + 1
    assert br.state == OPEN
    time.sleep(0.25)                # the cooldown clock
    assert pub("st/2") == [1] and br.state == CLOSED
    assert [m for _, m, _ in s.got] == ["st/1", "st/2"]
    assert node.metrics.val("breaker.failures") == 2
    assert node.metrics.val("breaker.fallback.batches") == 0
    assert node.alarms.get_alarms("activated") == []


def test_strict_breaker_raises_a_real_fetch_failure(monkeypatch):
    from emqx_tpu_torch import broker as pbroker

    node, br = strict_node(breaker_failures=3)
    s = Sink("s")
    node.subscribe(s, "f/1")

    def dead(*a):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(pbroker, "bundle_i32", dead)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        node.broker.publish_batch([Message(topic="f/1")])
    assert node.metrics.val("breaker.failures") == 1
    assert node.metrics.val("breaker.fallback.batches") == 0
    assert s.got == [] and br.state == CLOSED


def test_strict_breaker_diverts_injected_faults():
    node, br = strict_node()
    s = Sink("s")
    node.subscribe(s, "d/+")

    def pub(t):
        return node.broker.publish_batch([Message(topic=t)])

    pf.arm("device.fetch", times=2)
    assert pub("d/1") == [1] and pub("d/2") == [1]   # host-served
    assert br.state == OPEN and br.diverts()
    n = node.metrics.val("breaker.fallback.batches")
    assert pub("d/3") == [1]                         # open: the host
    assert node.metrics.val("breaker.fallback.batches") == n + 1
    assert [m for _, m, _ in s.got] == ["d/1", "d/2", "d/3"]


def test_strict_breaker_diverts_after_a_confirmed_loss(monkeypatch):
    """A real failure trips a strict breaker; the sentinel finds the
    backend lost: the batches then go to the host trie while the
    tables are rebuilt, and the probe closes it."""
    node, br = strict_node(breaker_failures=1)
    walk = failing_walk(monkeypatch)
    monkeypatch.setattr(devloss, "sentinel_alive", lambda *a: False)
    gate = threading.Event()
    real = node.router.rebuild_device_state

    def held():
        assert gate.wait(15)
        return real()

    node.router.rebuild_device_state = held
    s = Sink("s")
    node.subscribe(s, "l/+")

    def pub(t):
        return node.broker.publish_batch([Message(topic=t)])

    walk["fail"] = 1
    with pytest.raises(RuntimeError, match="launch failed"):
        pub("l/0")
    assert wait_for(lambda: br.state == REBUILDING) and br.diverts()
    n = walk["calls"]
    assert pub("l/1") == [1] and walk["calls"] == n   # the host trie
    gate.set()
    assert wait_for(lambda: br.state == HALF_OPEN)
    assert pub("l/2") == [1] and br.state == CLOSED
    assert not br.diverts()
    assert [m for _, m, _ in s.got] == ["l/1", "l/2"]
    br.recovery.stop()


# -- a live QoS 1 stream through a device loss --------------------------------


async def test_qos1_stream_through_device_loss_loses_and_dups_nothing():
    node = Node(device="cpu", matcher=MatcherConfig(device_min_filters=0),
                overload=OverloadConfig(**recovery_cfg(
                    breaker_failures=1, sentinel_timeout_s=0.5)))
    node.add_listener(port=0)
    await node.start()
    try:
        port = node.listeners[0].port
        sub, pub = im.IndieClient("dlsub"), im.IndieClient("dlpub")
        await sub.connect(port=port)
        await pub.connect(port=port)
        await sub.subscribe(("dl/t", 1))
        br = node.broker.breaker
        sent = []

        async def send(i):
            payload = b"m%03d" % i
            await pub.publish("dl/t", payload=payload, qos=1)
            sent.append(payload)

        async def until(state, timeout=10.0):
            deadline = time.monotonic() + timeout
            while br.state != state and time.monotonic() < deadline:
                await asyncio.sleep(0.01)
            return br.state == state

        for i in range(5):          # the device regime, warm
            await send(i)
        pf.arm("device.lost", times=0)
        try:
            for i in range(5, 15):  # the outage
                await send(i)
            assert await until(REBUILDING)
            for i in range(15, 20):
                await send(i)
        finally:
            pf.disarm("device.lost")
        i = 20
        deadline = time.monotonic() + 20.0
        while br.state != CLOSED and time.monotonic() < deadline:
            await send(i)
            i += 1
            await asyncio.sleep(0.02)
        assert br.state == CLOSED
        for j in range(i, i + 3):   # device traffic after recovery
            await send(j)
        got = [bytes((await sub.recv(timeout=10.0)).payload) for _ in sent]
        assert sorted(got) == sorted(sent)      # nothing lost or dup'd
        with pytest.raises(asyncio.TimeoutError):
            await sub.recv(timeout=0.3)         # and nothing extra
        assert node.metrics.val("breaker.rebuilds") == 1
        assert node.ingress.device_batches > 0
        for c in (sub, pub):
            await c.close()
    finally:
        await node.stop()


# -- a kernel build failure raises at boot ------------------------------------


def test_kernel_build_failure_raises_at_construction(monkeypatch):
    """On ``device="cuda"`` the Node, the Broker and the retained index
    load the kernel library when they are built: a failed build raises
    out of the constructor and never reaches a breaker. Here the card
    is faked and the loader patched to fail."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def failed_build():
        raise RuntimeError("nvcc: kernel library build failed")

    monkeypatch.setattr(_build, "library", failed_build)
    recorded = []
    monkeypatch.setattr(DeviceBreaker, "record_failure",
                        lambda self, *a, **k: recorded.append(a))
    for build in (lambda: Node(device="cuda"),
                  lambda: Broker(device="cuda"),
                  lambda: RetainIndex("cuda")):
        with pytest.raises(RuntimeError, match="build failed"):
            build()
    assert recorded == []
    # the CPU never loads the library
    node = Node(device="cpu")
    assert node.broker.breaker is not None
    assert np.asarray(node.broker.publish_batch(
        [Message(topic="a")])).tolist() == [0]
