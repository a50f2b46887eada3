"""The port's router at the JAX package's defaults, seen from the node
and the broker, on the CPU: the matcher knobs equal the JAX package's,
a new subscription is matched without a re-flatten, the router's
counters fold into ``Metrics`` under the JAX node's names, and a
crashed background compaction arms its backoff and is retried by the
housekeeping tick."""

import dataclasses
import threading
import time

import pytest
import torch

from emqx_tpu.metrics import AUTOMATON_METRICS, CACHE_METRICS
from emqx_tpu.router import MatcherConfig as JaxMatcherConfig
from emqx_tpu_torch.broker import Broker
from emqx_tpu_torch.metrics import NAMES
from emqx_tpu_torch.node import Node
from emqx_tpu_torch.router import MatcherConfig
from emqx_tpu_torch.types import Message

KNOBS = ("patch_drain_batch", "match_cache", "match_cache_slots",
         "cache_partitions", "delta", "delta_max_filters")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Sink:
    def __init__(self, name):
        self.client_id = name
        self.inbox = []

    def deliver(self, topic_filter, msg):
        self.inbox.append((msg.topic, topic_filter))


def _wait_idle(router, timeout=30.0):
    deadline = time.monotonic() + timeout
    while router._compacting:
        assert time.monotonic() < deadline, "compaction never finished"
        time.sleep(0.005)


def test_matcher_config_defaults_equal_the_jax_package():
    port, ref = MatcherConfig(), JaxMatcherConfig()
    for k in KNOBS:
        assert getattr(port, k) == getattr(ref, k), k
    assert (port.patch_drain_batch, port.match_cache,
            port.match_cache_slots, port.cache_partitions, port.delta,
            port.delta_max_filters) == (256, True, 65536, 64, True, 4096)
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("delta,cache", [(True, True), (False, True),
                                         (True, False)])
def test_first_publish_after_a_new_subscription_does_not_reflatten(
        delta, cache):
    """At the defaults (delta), on patch in place, and with the cache
    off (the broker then takes the raw rows, the delta's emits
    concatenated after the main walk's): a SUBSCRIBE to a filter no
    one else holds, an UNSUBSCRIBE, and the publishes after each are
    matched without a flatten of the table."""
    b = Broker(config=MatcherConfig(device_min_filters=1, delta=delta,
                                    match_cache=cache), device="cpu")
    sinks = [Sink(f"c{i}") for i in range(4)]
    for i in range(200):
        b.subscribe(sinks[i % 3], f"base/{i}/+")
    assert b.publish_batch([Message(topic="base/7/x")]) == [1]
    r = b.router
    rebuilds = r._rebuilds
    b.subscribe(sinks[3], "fresh/+/leaf")
    assert b.publish_batch([Message(topic="fresh/a/leaf"),
                            Message(topic="base/7/y")]) == [1, 1]
    assert sinks[3].inbox == [("fresh/a/leaf", "fresh/+/leaf")]
    b.unsubscribe(sinks[0], "base/0/+")
    assert b.publish_batch([Message(topic="base/0/x")]) == [0]
    assert r._rebuilds == rebuilds
    if delta:
        assert r.delta_info()["pending"] == 1
        assert r.delta_info()["tombstones"] == 1
    else:
        assert r.stats()["patches"] == 2


def test_node_folds_router_counters_under_the_jax_names():
    for prefix, jax_names in (("cache.match.", CACHE_METRICS),
                              ("automaton.", AUTOMATON_METRICS)):
        assert {n for n in NAMES if n.startswith(prefix)} == set(jax_names)
    node = Node(matcher=MatcherConfig(device_min_filters=1,
                                      delta_max_filters=4), device="cpu")
    s = Sink("c")
    for i in range(20):
        node.subscribe(s, f"h/{i}")
    for _ in range(2):
        node.broker.publish_batch([Message(topic="h/1"),
                                   Message(topic="h/2")])
    for i in range(4):
        node.subscribe(s, f"hh/{i}/+")  # the 4th starts a compaction
        if i == 1:  # two pending adds: a two-probe batch
            node.broker.publish_batch([Message(topic="hh/1/x")])
    _wait_idle(node.router)
    node.broker.publish_batch([Message(topic="hh/1/x")])
    c = node.router._match_cache_obj
    want_cache = {"hit": c.hits, "miss": c.misses, "insert": c.inserts,
                  "stale": c.stale, **{
                      f"bump.{k}": v for k, v in
                      node.router.cache_bump_totals().items()}}
    info = node.router.delta_info()
    node.tick()
    m = node.metrics
    for k, v in want_cache.items():
        assert m.val(f"cache.match.{k}") == v, k
    assert m.val("cache.match.hit") >= 2
    assert m.val("automaton.delta.merges") == info["merges"] == 1
    assert m.val("automaton.delta.filters") == info["filters"] == 4
    assert m.val("automaton.delta.probes") == info["probes"] >= 1
    node.tick()  # deltas only: nothing new to fold
    assert m.val("cache.match.hit") == want_cache["hit"]


def test_crashed_compaction_arms_backoff_and_tick_retries():
    node = Node(matcher=MatcherConfig(device_min_filters=1,
                                      delta_max_filters=4), device="cpu")
    r = node.router
    s = Sink("c")
    for i in range(20):
        node.subscribe(s, f"k/{i}")
    node.broker.publish_batch([Message(topic="k/1")])
    orig = r._flatten_main
    crashed = threading.Event()

    def crash_once(cap, nb):
        if not crashed.is_set():
            crashed.set()
            raise RuntimeError("flatten failed")
        return orig(cap, nb)

    r._flatten_main = crash_once
    for i in range(4):
        node.subscribe(s, f"kk/{i}")  # crosses delta_max_filters
    assert crashed.wait(10)
    _wait_idle(r)
    assert r._compact_failures == 1
    assert "flatten failed" in node._flatten_err
    assert r._compact_backoff_until > time.monotonic()
    assert r.delta_info()["merges"] == 0 and r._freeze is None
    # the delta still serves every route while the merge waits
    assert node.broker.publish_batch([Message(topic="kk/3")]) == [1]
    node.tick()  # inside the backoff: no retry
    assert not r._compacting and r.delta_info()["merges"] == 0
    r._compact_backoff_until = time.monotonic() - 1.0  # backoff over
    node.tick()
    _wait_idle(r)
    assert r.delta_info()["merges"] == 1
    assert r._compact_failures == 0 and node._flatten_err is None
    assert node.broker.publish_batch([Message(topic="kk/3"),
                                      Message(topic="k/5")]) == [1, 1]


def test_route_ops_matches_and_compactions_race_without_a_lost_update():
    """More threads than cores — route-op threads on disjoint roots and
    matcher threads on a static set — with a shortened switch interval
    and repeated off-lock compactions (``delta_max_filters=16``): every
    match of a static topic equals the static set at every instant,
    and once the threads join every surviving route matches exactly
    (a lost add, delete or id would break one or the other). The
    Python engine here; tests/test_torch_native.py runs the same race
    on the native engine."""
    race_route_ops_matches_and_compactions(use_native=False)


def race_route_ops_matches_and_compactions(use_native):
    """The race of the test above on the given trie engine."""
    import os
    import sys

    from emqx_tpu_torch.oracle import TrieOracle
    from emqx_tpu_torch.router import Router

    r = Router(MatcherConfig(device_min_filters=0, delta_max_filters=16,
                             use_native=use_native), device="cpu")
    static = [f"s/{i}/+" for i in range(64)] + ["s/#"]
    for f in static:
        r.add_route(f)
    topics = [f"s/{i}/x" for i in range(64)]
    want = {t: sorted([f"s/{t.split('/')[1]}/+", "s/#"]) for t in topics}
    r.match_filters(topics[:2])
    n_ops = max(2, (os.cpu_count() or 2) // 2 + 1)
    n_match = (os.cpu_count() or 2) + 1 - n_ops
    errors, live = [], [set() for _ in range(n_ops)]
    deadline = time.monotonic() + 2.0

    def ops(t):
        try:
            i = 0
            while time.monotonic() < deadline:
                f = f"c{t}/{i % 40}/x"
                if f in live[t]:
                    r.delete_route(f)
                    live[t].discard(f)
                else:
                    r.add_route(f)
                    live[t].add(f)
                i += 7
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    def match():
        try:
            while time.monotonic() < deadline:
                for t, got in zip(topics, r.match_filters(topics)):
                    if sorted(got) != want[t]:
                        errors.append(AssertionError((t, got)))
                        return
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=ops, args=(t,)) for t in range(n_ops)]
    threads += [threading.Thread(target=match) for _ in range(n_match)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    _wait_idle(r)
    assert not errors, errors[:3]
    assert r._compact_failures == 0 and r.delta_info()["merges"] >= 1
    oracle = TrieOracle()
    for f in static + [f for s in live for f in s]:
        oracle.insert(f)
    probe = topics + [f"c{t}/{i}/x" for t in range(n_ops) for i in range(40)]
    for t, got in zip(probe, r.match_filters(probe)):
        assert sorted(got) == sorted(oracle.match(t)), t
