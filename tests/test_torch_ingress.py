"""The port's ingress batcher under an open-loop burst, and the
listener's accept controls.

The burst submits, in one event-loop step, more messages than
``MAX_INFLIGHT`` batches and one capped batch hold: four batches go
in flight at once (begin on the loop, fetch on the executor's
threads), the backlog behind them flushes as one batch of
``batch_cap`` messages, and the rest after it. The same topics go
through the JAX package's ``Broker.publish_batch`` in one batch. The
port must give the same delivery count per message and the same
``(topic, filter, payload)`` multiset per subscriber, resolve the
publishers' futures in submission order (the ack order of
MQTT-4.6.0), and deliver each topic's messages to a subscriber in
publish order across the batches. The burst runs on the CPU, over
the kernels' plain twins; tests/test_torch_kernels.py runs it on the
card against the port's CPU broker.

The batcher's telemetry: on the same burst each device batch's
stages add up to its life, ``publish_begin`` entry to its last
acknowledgement, with one span a batch; a batch held behind four in
flight reads its wait in ``queue``.

The accept controls (access rules, the PROXY header) run through a
port ``Node(device="cpu")`` over loopback sockets, and
``read_proxy_header`` against the JAX package's on the same headers.
"""

import asyncio
import struct
import time
from collections import Counter

import numpy as np
import pytest

import indie_mqtt as im
from emqx_tpu.broker import Broker as JaxBroker
from emqx_tpu.connection import read_proxy_header as jax_read_proxy_header
from emqx_tpu.router import MatcherConfig as JaxMatcherConfig
from emqx_tpu.types import Message as JaxMessage
from emqx_tpu_torch.connection import (check_access, parse_access_rules,
                                       read_proxy_header)
from emqx_tpu_torch.ingress import MAX_INFLIGHT
from emqx_tpu_torch.node import Node
from emqx_tpu_torch.router import MatcherConfig
from emqx_tpu_torch.types import Message
from test_torch_telemetry import cpu_pairs, cpu_step_ms

KNOBS = dict(device_min_filters=1, fanout_threshold=4, active_k=2)
#: the JAX package's plain path, which these tests hold the port to:
#: no match cache, no delta automaton, the Python trie engine
PLAIN = dict(match_cache=False, delta=False, use_native=False)
LIMIT = 60.0
WORDS = ["a", "b", "c", "d"]


class Sink:
    """Subscriber double recording ``(topic, filter, payload)``."""

    def __init__(self, name):
        self.client_id = name
        self.inbox = []

    def deliver(self, topic_filter, msg):
        self.inbox.append((msg.topic, topic_filter, msg.payload))


def _workload(seed, n_msgs):
    """Filters (literal, ``+``, ``#``, one big filter past the fan-out
    threshold) with their subscriber indexes, and ``n_msgs`` topics."""
    rs = np.random.RandomState(seed)
    subs = []
    for _ in range(40):
        ws = [WORDS[i] for i in rs.randint(0, 4, size=rs.randint(1, 5))]
        r = rs.rand()
        if r < 0.3:
            ws[rs.randint(0, len(ws))] = "+"
        elif r < 0.45:
            ws[-1] = "#"
        for s in rs.choice(8, size=rs.randint(1, 3), replace=False):
            subs.append(("/".join(ws), int(s)))
    subs += [("a/b", s) for s in range(6)]  # 6 > fanout_threshold
    topics = ["/".join(WORDS[i]
                       for i in rs.randint(0, 4, size=rs.randint(1, 5)))
              for _ in range(n_msgs)]
    topics[::17] = ["$SYS/a"] * len(topics[::17])
    return subs, topics


def _jax_deliveries(subs, topics):
    broker = JaxBroker(config=JaxMatcherConfig(**PLAIN, **KNOBS))
    sinks = [Sink(f"c{i}") for i in range(8)]
    for f, s in subs:
        broker.subscribe(sinks[s], f)
    res = broker.publish_batch([JaxMessage(topic=t, payload=b"%d" % i)
                                for i, t in enumerate(topics)])
    return list(res), sinks


async def _burst(node, sinks, topics):
    ing = node.ingress
    order, futs = [], []
    for i, t in enumerate(topics):
        fut = ing.submit(Message(topic=t, payload=b"%d" % i))
        fut.add_done_callback(lambda _f, i=i: order.append(i))
        futs.append(fut)
    inflight = ing.stats()["ingress.inflight"]
    results = await asyncio.gather(*futs)
    await ing.drain()
    return list(results), order, inflight


def test_open_loop_burst_fills_the_pipeline_and_keeps_order():
    node = Node(matcher=MatcherConfig(**PLAIN, **KNOBS), batch_size=8, device="cpu")
    ing = node.ingress
    # four batches of batch_size in flight, one capped batch behind
    # them, and a short last batch
    n = MAX_INFLIGHT * ing.batch_size + ing.batch_cap + 5
    subs, topics = _workload(7, n)
    sinks = [Sink(f"c{i}") for i in range(8)]
    for f, s in subs:
        node.broker.subscribe(sinks[s], f)
    node.broker.publish_batch([Message(topic="warm/up")])
    results, order, inflight = asyncio.run(
        asyncio.wait_for(_burst(node, sinks, topics), LIMIT))

    assert inflight == MAX_INFLIGHT
    stats = ing.stats()
    assert stats["ingress.max_batch"] == ing.batch_cap
    assert stats["ingress.flushes"] == MAX_INFLIGHT + 2
    assert stats["ingress.device_batches"] == MAX_INFLIGHT + 2
    assert order == list(range(n))
    want_res, want_sinks = _jax_deliveries(subs, topics)
    assert results == want_res
    for got, want in zip(sinks, want_sinks):
        assert Counter(got.inbox) == Counter(want.inbox), got.client_id
        # each topic's messages reach a subscriber in publish order
        last = {}
        for t, f, p in got.inbox:
            assert int(p) >= last.get((t, f), -1), (got.client_id, t)
            last[(t, f)] = int(p)


#: the stages that tile a device batch's life under the batcher
LIFE = ("begin_host", "match", "cache_gather", "pack", "fetch_wait",
        "fetch", "dispatch_plan", "serialize", "order_wait", "dispatch",
        "tail_yield", "ack")


def _folded_spans(node):
    """Every span the node's telemetry folds, with the clock at the
    fold (right after the batch's acknowledgements were set)."""
    tel = node.telemetry
    finish = tel.finish
    got = []

    def rec(span):
        if not span.closed:
            got.append((span, time.perf_counter()))
        return finish(span)

    tel.finish = rec
    return got


def _burst_node(subs):
    node = Node(matcher=MatcherConfig(**PLAIN, **KNOBS), batch_size=8,
                device="cpu")
    sinks = [Sink(f"c{i}") for i in range(8)]
    for f, s in subs:
        node.broker.subscribe(sinks[s], f)
    node.broker.publish_batch([Message(topic="warm/up")])
    return node, sinks


def test_device_batch_stages_add_up_to_its_life(monkeypatch):
    subs, topics = _workload(9, 4 * 8 + 32 + 5)
    node, sinks = _burst_node(subs)
    spans = _folded_spans(node)
    pairs = cpu_pairs(monkeypatch)
    flushes = node.ingress.flushes
    asyncio.run(asyncio.wait_for(_burst(node, sinks, topics), LIMIT))
    batches = node.ingress.flushes - flushes
    assert batches == MAX_INFLIGHT + 2
    # one span a batch, each a device batch the batcher held
    assert len(spans) == batches
    step = cpu_step_ms()
    for sp, t_fold in spans:
        st = sp.stages
        assert sp.path == "device" and sp.held
        assert all(st.get(s, 0.0) >= 0.0 for s in LIFE), st
        life = (t_fold - sp.t0) * 1000.0
        total = sum(st.get(s, 0.0) for s in LIFE)
        assert abs(total - life) <= max(0.01 * life, 0.5), (total, life, st)
        # end_to_end keeps its end, the last delivery chunk: the ack
        # comes after it
        assert abs(st["end_to_end"] - (total - st["ack"])) <= \
            max(0.01 * life, 0.5), st
        assert st["end_to_end"] <= life
        # CPU against wall, each on its own thread, within the thread
        # CPU clock's step for each read pair
        wall = st["fetch"] + st.get("dispatch_plan", 0.0) + \
            st.get("serialize", 0.0)
        assert st["fetch_cpu"] <= wall + pairs[sp, "fetch_cpu"] * step \
            and st["dispatch_cpu"] <= \
            st["dispatch"] + pairs[sp, "dispatch_cpu"] * step, (st, step)


def test_a_batch_behind_four_in_flight_reads_its_queue_wait():
    subs, topics = _workload(3, 5 * 8)
    node, sinks = _burst_node(subs)
    spans = _folded_spans(node)
    fetch = node.broker.publish_fetch

    def slow_fetch(pb):
        time.sleep(0.05)  # the four slots stay busy a while
        return fetch(pb)

    node.broker.publish_fetch = slow_fetch
    stamps = []

    async def go():
        ing = node.ingress
        futs = []
        for i, t in enumerate(topics):
            stamps.append(time.perf_counter())
            futs.append(ing.submit(Message(topic=t, payload=b"%d" % i)))
        assert ing.stats()["ingress.inflight"] == MAX_INFLIGHT
        await asyncio.gather(*futs)
        await ing.drain()

    asyncio.run(asyncio.wait_for(go(), LIMIT))
    assert len(spans) == 5
    spans.sort(key=lambda x: x[0].t0)
    for k, (sp, _t) in enumerate(spans):
        mean_sub = sum(stamps[8 * k:8 * k + 8]) / 8
        want = (sp.t0 - mean_sub) * 1000.0
        assert abs(sp.stages["queue"] - want) < 0.5, (k, sp.stages, want)
    assert spans[0][0].stages["queue"] < 5.0
    # the fifth batch waits for a slot: the first batch's fetch at least
    assert spans[4][0].stages["queue"] >= 45.0


def test_telemetry_off_reads_no_clock_at_submit(monkeypatch):
    """Disabled, telemetry costs the batcher one branch a message: no
    submit reads the clock, and no batch takes a span."""
    import emqx_tpu_torch.ingress as ingress_mod
    from emqx_tpu_torch.telemetry import TelemetryConfig

    subs, topics = _workload(5, 3 * 8 + 3)
    reads = []
    now = ingress_mod._now

    def counted():
        reads.append(1)
        return now()

    monkeypatch.setattr(ingress_mod, "_now", counted)
    got = []
    for enabled in (False, True):
        node = Node(matcher=MatcherConfig(**PLAIN, **KNOBS), batch_size=8,
                    device="cpu",
                    telemetry=TelemetryConfig(enabled=enabled))
        sinks = [Sink(f"c{i}") for i in range(8)]
        for f, s in subs:
            node.broker.subscribe(sinks[s], f)
        spans = node.telemetry.spans_total
        del reads[:]
        res, _order, _inflight = asyncio.run(
            asyncio.wait_for(_burst(node, sinks, topics), LIMIT))
        got.append((res, [s.inbox for s in sinks]))
        if enabled:
            assert len(reads) >= len(topics)
            assert node.telemetry.spans_total > spans
        else:
            assert reads == [] and node.telemetry.spans_total == spans
    assert got[0] == got[1]


def test_set_pressure_divides_the_high_water_mark():
    node = Node(batch_size=8, device="cpu")
    ing = node.ingress

    async def go():
        for i in range(3):
            ing.submit(Message(topic=f"p/{i}"), want_result=False)
        assert not ing.backlogged()          # 3 < 8
        ing.set_pressure(4)                  # mark 8 // 4 = 2
        assert ing.backlogged()
        # the parked reader wakes when the scheduled flush drains it
        flushes = ing.flushes
        await asyncio.wait_for(ing.wait_ready(), LIMIT)
        assert ing.flushes == flushes + 1 and not ing.backlogged()
        ing.set_pressure(1)
        for i in range(7):
            ing.submit(Message(topic=f"q/{i}"), want_result=False)
        assert not ing.backlogged()          # 7 < 8 again
        await ing.drain()

    asyncio.run(go())


def test_access_rules_parse_and_match():
    rules = parse_access_rules(
        ["deny 10.0.0.0/8", "allow 127.0.0.1", "allow all"])
    assert check_access(rules, "10.1.2.3") is False
    assert check_access(rules, "127.0.0.1") is True
    assert check_access(rules, "::ffff:10.0.0.1") is False
    assert check_access(parse_access_rules(["allow 192.0.2.0/24"]),
                        "198.51.100.1") is False
    with pytest.raises(ValueError):
        parse_access_rules(["permit all"])


async def _connect(port, cid):
    c = im.IndieClient(cid, keepalive=0)
    await c.connect(port=port, timeout=5.0)
    return c


def test_listener_access_rules_deny_the_socket_peer():
    async def go():
        node = Node(device="cpu")
        denied = node.add_listener(port=0,
                                   access_rules=["deny 127.0.0.1",
                                                 "allow all"])
        allowed = node.add_listener(port=0, name="tcp:allowed",
                                    access_rules=["allow 127.0.0.1"])
        await node.start()
        try:
            with pytest.raises(Exception):
                await _connect(denied.port, "denied")
            c = await _connect(allowed.port, "allowed")
            assert c.connack.rc == 0
            await c.close()
        finally:
            await node.stop()

    asyncio.run(asyncio.wait_for(go(), LIMIT))


def _ppv2(fam, body, cmd=1):
    return (b"\r\n\r\n\x00\r\nQUIT\n"
            + struct.pack("!BBH", 0x20 | cmd, fam << 4 | 1, len(body))
            + body)


@pytest.mark.parametrize("header", [
    b"PROXY TCP4 203.0.113.7 10.0.0.1 54321 1883\r\n",
    b"PROXY TCP6 2001:db8::1 2001:db8::2 4000 1883\r\n",
    b"PROXY UNKNOWN\r\n",
    _ppv2(1, bytes([203, 0, 113, 9, 10, 0, 0, 1])
          + struct.pack("!HH", 61000, 1883)),
    _ppv2(2, bytes(15) + b"\x01" + bytes(15) + b"\x02"
          + struct.pack("!HH", 7000, 1883)),
    _ppv2(0, b"", cmd=0),
    b"PROXY TCP4 nonsense\r\n",
    b"PROXY TCP4 ::1 10.0.0.1 1 2\r\n",
    b"GET / HTTP/1.1\r\n\r\n",
])
def test_read_proxy_header_like_the_jax_package(header):
    async def read(fn):
        r = asyncio.StreamReader()
        r.feed_data(header + b"rest")
        r.feed_eof()
        try:
            return await fn(r), await r.read()
        except Exception as e:  # noqa: BLE001 - the type is compared
            return type(e).__name__, None

    async def go():
        return await read(read_proxy_header), await read(
            jax_read_proxy_header)

    got, want = asyncio.run(go())
    assert got == want


def test_listener_proxy_header_sets_the_peername():
    async def go():
        node = Node(device="cpu")
        lst = node.add_listener(port=0, proxy_protocol=True)
        await node.start()
        try:
            r, w = await asyncio.open_connection("127.0.0.1", lst.port)
            w.write(b"PROXY TCP4 203.0.113.7 10.0.0.1 54321 1883\r\n"
                    + im.build_connect("behind-lb", version=4,
                                       keepalive=0))
            await w.drain()
            ack = await asyncio.wait_for(im.read_packet(r, 4), LIMIT)
            assert ack.ptype == im.CONNACK and ack.rc == 0
            chan = node.cm.lookup_channel("behind-lb")
            assert chan.peername == ("203.0.113.7", 54321)
            w.close()
            # a bare client on the same listener sends no header
            with pytest.raises(Exception):
                await _connect(lst.port, "bare")
        finally:
            await node.stop()

    asyncio.run(asyncio.wait_for(go(), LIMIT))
