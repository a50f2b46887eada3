"""The port's retained store and subscribe-time replay against the JAX
package, on the CPU.

- kernel B3's plain version (``match_names_many``) against the JAX lax
  function and the Pallas kernel in interpret mode, on the matrices of
  one add/remove/re-add script run through both ``RetainIndex``es;
- ``RetainIndex.match_many`` (device route on ``device="cpu"`` and the
  host route) against the JAX index and the ``T.match`` oracle, through
  interleaved mutations, growth, compaction, deep names and duplicate
  filters;
- replay through the port's ``Node`` against ``emqx_tpu.node.Node``:
  the same retained publishes and the same subscribe script (the
  channel's sequence of calls on a ``Session`` registered in ``cm``),
  each session's outbox and the ``retained.*`` counters compared, with
  a running loop (one replay batch per burst) and without (inline);
- ``or_bitmaps`` (kernel B4's entry point) against the JAX function in
  interpret mode; the port ``Session`` against the JAX ``Session``.

Every output is bits or integers: comparisons are exact.
"""

import asyncio
import random
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emqx_tpu import topic as JT
from emqx_tpu.broker import DispatchConfig as JaxDispatchConfig
from emqx_tpu.modules.retainer import RetainerModule as JaxRetainerModule
from emqx_tpu.modules.retainer import RetainIndex as JaxRetainIndex
from emqx_tpu.node import Node as JaxNode
from emqx_tpu.ops.bitmap import or_bitmaps as jax_or_bitmaps
from emqx_tpu.ops.retained_match import match_names_many as jax_match_lax
from emqx_tpu.ops.retained_match import match_names_many_pallas
from emqx_tpu.session import Session as JaxSession
from emqx_tpu.types import Message as JaxMessage
from emqx_tpu.types import SubOpts as JaxSubOpts
from emqx_tpu_torch.broker import DispatchConfig
from emqx_tpu_torch.metrics import Metrics
from emqx_tpu_torch.modules.retainer import RetainerModule, RetainIndex
from emqx_tpu_torch.node import Node
from emqx_tpu_torch.ops import _build
from emqx_tpu_torch.ops.bitmap import or_bitmaps
from emqx_tpu_torch.ops.retained_match import match_names_auto, match_names_many
from emqx_tpu_torch.session import Session
from emqx_tpu_torch.stats import Stats
from emqx_tpu_torch.types import Message, SubOpts
from test_retained_replay import _burst, _rand_filter, _rand_topic


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run torch single-threaded here and restore the setting after:
    these tests share worker processes with the JAX package's tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair_script(rng, n=400):
    """One add/remove/re-add script through the JAX and the port
    index; returns both and the live name set."""
    jidx, pidx, live = JaxRetainIndex(), RetainIndex("cpu"), set()

    def add(t):
        jidx.add(t)
        pidx.add(t)
        live.add(t)

    def remove(t):
        jidx.remove(t)
        pidx.remove(t)
        live.discard(t)

    for _ in range(n):
        add(_rand_topic(rng))
    for t in rng.sample(sorted(live), n // 3):
        remove(t)
    for _ in range(n // 8):  # slot reuse
        add(_rand_topic(rng))
    return jidx, pidx, live, add, remove


def _same_matrices(jidx, pidx):
    np.testing.assert_array_equal(jidx._ids, pidx._ids)
    np.testing.assert_array_equal(jidx._n, pidx._n)
    np.testing.assert_array_equal(jidx._sys, pidx._sys)


def _oracle(live, flt):
    return sorted(t for t in live if JT.match(t, flt))


# -- B3's plain version against the JAX functions ---------------------------

@pytest.mark.parametrize("seed", [3, 4])
def test_plain_match_equals_jax_lax_and_pallas(seed):
    rng = random.Random(seed)
    jidx, pidx, live, _add, _remove = _pair_script(rng)
    _same_matrices(jidx, pidx)
    flts = _burst(rng, live) + ["+", "$priv/+", "nope/#", "+/+/+/#"]
    fw, fn, hh = pidx._encode(flts)
    want_lax = np.asarray(jax_match_lax(
        jnp.asarray(fw), jnp.asarray(fn), jnp.asarray(hh),
        jnp.asarray(jidx._ids), jnp.asarray(jidx._n),
        jnp.asarray(jidx._sys)))
    want_pal = np.asarray(match_names_many_pallas(
        jnp.asarray(fw), jnp.asarray(fn), jnp.asarray(hh),
        jnp.asarray(jidx._ids), jnp.asarray(jidx._n),
        jnp.asarray(jidx._sys), interpret=True))
    args = [torch.from_numpy(a) for a in (fw, fn, hh, pidx._ids, pidx._n,
                                          pidx._sys)]
    got = match_names_many(*args)
    assert got.dtype == torch.bool and got.shape == want_lax.shape
    np.testing.assert_array_equal(got.numpy(), want_lax)
    np.testing.assert_array_equal(got.numpy(), want_pal)
    # the seam runs the plain version on CPU tensors and launches nothing
    _build.reset_launches()
    np.testing.assert_array_equal(match_names_auto(*args).numpy(), want_lax)
    assert _build.LAUNCHES["retained_match"] == 0


def test_plain_match_ragged_and_padding_rows():
    """F and cap that are multiples of no tile; a padding filter row
    (fn = 0, no '#') and a dead name row (n = 0) match nothing."""
    rs = np.random.RandomState(9)
    F, cap, L = 5, 37, 16
    ids = rs.randint(-2, 4, size=(cap, L)).astype(np.int32)
    n = rs.randint(0, 6, size=cap).astype(np.int32)
    sysm = rs.rand(cap) < 0.2
    fw = rs.randint(-3, 4, size=(F, L)).astype(np.int32)
    fn = np.array([0, 2, 3, 0, 16], np.int32)
    hh = np.array([False, True, False, True, False])
    want = np.asarray(jax_match_lax(*(jnp.asarray(a) for a in
                                      (fw, fn, hh, ids, n, sysm))))
    got = match_names_many(*(torch.from_numpy(a) for a in
                             (fw, fn, hh, ids, n, sysm))).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[0].any() and not got[:, n == 0].any()


# -- RetainIndex.match_many against the JAX index and the oracle -----------

@pytest.mark.parametrize("threshold", [0, 10**9], ids=["device", "host"])
async def test_index_match_many_equals_jax_and_oracle(threshold):
    rng = random.Random(21)
    jidx, pidx, live, add, remove = _pair_script(rng)

    def check(flts):
        _same_matrices(jidx, pidx)
        got = pidx.match_many(flts, device_threshold=threshold)
        want = jidx.match_many(flts, device_threshold=threshold)
        assert got == want
        for flt, hits in zip(flts, got):
            assert sorted(hits) == _oracle(live, flt), flt

    check(_burst(rng, live))
    dev = pidx._dev
    # interleaved mutations: the dirty rows are patched in place
    for step in range(6):
        for _ in range(5):
            if rng.random() < 0.5:
                remove(rng.choice(sorted(live)))
            else:
                add(_rand_topic(rng))
        check(_burst(rng, live) + [_rand_filter(rng)])
    if threshold == 0:
        assert pidx._dev[2] is dev[2] and pidx._cap == 1024
    # growth past 1,024 rows (the device matrix is uploaded anew)
    for i in range(900):
        add(f"g/{i % 13}/n{i}")
    assert pidx._cap == jidx._cap == 2048
    check(["g/+/#", "g/3/+", "#", "g/#", "g/3/n3"] + _burst(rng, live))
    # compaction once most interned words are dead
    for i in range(4200):
        add(f"z{i}")
    for i in range(4200):
        remove(f"z{i}")
    assert pidx._compact_due() and jidx._compact_due()
    jidx._maybe_compact()
    assert await pidx.compact_async()
    assert len(pidx._table) == len(jidx._table)
    check(["g/+/#", "z1", "+", "#"] + _burst(rng, live))
    # deep names (> L levels) live in the host side set
    deep = "/".join(["d"] * 20)
    add(deep)
    assert deep in pidx._deep
    check(["d/#", deep, "/".join(["+"] * 20), "#", "#", "d/#"])


# -- replay through the port's Node against the JAX Node ---------------------

class _Chan:
    """Stand-in channel: the registry entry that holds ``.session``."""

    def __init__(self, session):
        self.session = session


_SUBS = [  # (clientid, filter, qos, rh, rap)
    ("c0", "r/+/#", 1, 0, 0),
    ("c1", "r/1/+", 0, 0, 0),         # QoS downgrade
    ("c2", "#", 2, 1, 0),             # Retain-Handling 1, new
    ("c3", "$share/g/r/#", 1, 0, 0),  # never replayed to $share
    ("c4", "r/2/8", 2, 2, 0),         # Retain-Handling 2: never
    ("c5", "+/+", 1, 0, 1),           # RAP
    ("c5", "$priv/#", 2, 0, 0),
    ("c5", "$SYS/#", 0, 0, 0),
    ("c0", "r/3/13", 2, 0, 0),        # literal
    ("c1", "r/1/+", 0, 0, 0),         # duplicate in the burst
    ("c6", "/".join(["d"] * 20), 1, 0, 0),
    ("c6", "e/+", 1, 0, 0),           # an expired entry
]
_RESUBS = [
    ("c2", "#", 2, 1, 0),             # Retain-Handling 1 on resubscribe
    ("c0", "r/+/#", 1, 0, 0),         # Retain-Handling 0 on resubscribe
    ("c6", "r/0/#", 2, 0, 1),
]


def _publish_all(node, M):
    now = time.time()
    msgs = []
    for i in range(48):
        msgs.append(M(topic=f"r/{i % 4}/{i}", payload=b"v%d" % i,
                      qos=1 + i % 2, flags={"retain": True}))
    msgs += [
        M(topic="$priv/a", payload=b"p", qos=2, flags={"retain": True}),
        M(topic="$SYS/x", payload=b"s", flags={"retain": True}),  # skipped
        M(topic="r/0/big", payload=b"x" * 100, flags={"retain": True}),
        M(topic="/".join(["d"] * 20), payload=b"deep", qos=1,
          flags={"retain": True}),
        M(topic="e/t", payload=b"old", qos=1, flags={"retain": True},
          timestamp=now - 100,
          headers={"properties": {"Message-Expiry-Interval": 1}}),
        M(topic="e/u", payload=b"new", qos=1, flags={"retain": True}),
        M(topic="r/1/5", payload=b"", flags={"retain": True}),   # delete
        M(topic="r/2/6", payload=b"", flags={"retain": True}),   # delete
        M(topic="r/2/7", payload=b"v7b", qos=1, flags={"retain": True}),
        M(topic="r/9/plain", payload=b"n"),  # not retained
    ]
    msgs += [M(topic=f"over/{i}", payload=b"o", flags={"retain": True})
             for i in range(4)]  # the last ones pass max_retained
    for m in msgs:
        node.broker.publish(m)


def _subscribe(node, sessions, script, SO):
    """The channel's sequence of calls per subscription
    (emqx_tpu/channel.py:752-768)."""
    for cid, flt, qos, rh, rap in script:
        s = sessions[cid]
        opts = SO(qos=qos, rh=rh, rap=rap)
        resub = flt in s.subscriptions
        s.subscribe(flt, opts)
        node.hooks.run("session.subscribed",
                       ({"clientid": cid}, flt,
                        {**opts.to_dict(), "resub": resub}))


def _boxes(sessions):
    return {cid: [(pid, m.topic, m.payload, m.qos, bool(m.flags.get("retain")))
                  for pid, m in s.drain_outbox()]
            for cid, s in sorted(sessions.items())}


_COUNTERS = ("retained.count", "retained.dropped", "retained.expired",
             "retained.replay.batches", "retained.replay.messages")
_ENV = {"index_device_threshold": 0, "max_payload": 64, "max_retained": 54}


def _nodes(planner):
    jnode = JaxNode(boot_listeners=False, dispatch_config=JaxDispatchConfig(
        planner=planner, preserialize=False))
    pnode = Node(device="cpu", boot_listeners=False,
                 dispatch_config=DispatchConfig(planner=planner))
    out = []
    for node, mod, sess_cls, M in (
            (jnode, JaxRetainerModule, JaxSession, JaxMessage),
            (pnode, RetainerModule, Session, Message)):
        node.modules.load(mod, dict(_ENV))
        _publish_all(node, M)
        sessions = {f"c{i}": sess_cls(f"c{i}", broker=node.broker)
                    for i in range(7)}
        for cid, s in sessions.items():
            node.cm.register_channel(cid, _Chan(s))
        out.append((node, sessions))
    return out


def _counters(node):
    return {k: node.metrics.val(k) for k in _COUNTERS}


@pytest.mark.parametrize("planner", [True, False])
async def test_replay_with_a_loop_equals_jax(planner):
    (jnode, jsess), (pnode, psess) = _nodes(planner)
    await pnode.start()
    try:
        results = []
        for node, sessions, SO in ((jnode, jsess, JaxSubOpts),
                                   (pnode, psess, SubOpts)):
            got = []
            for script in (_SUBS, _RESUBS):
                before = node.metrics.val("retained.replay.batches")
                _subscribe(node, sessions, script, SO)
                await asyncio.sleep(0)  # the replay kick runs here
                assert node.metrics.val("retained.replay.batches") \
                    == before + 1
                got.append(_boxes(sessions))
            results.append((got, _counters(node)))
        assert results[0] == results[1]
        boxes, counters = results[1]
        assert counters["retained.expired"] == 1
        assert counters["retained.dropped"] == 2  # 1 payload, 1 over max
        assert not boxes[0]["c3"] and not boxes[0]["c4"]
        assert not boxes[1]["c2"] and boxes[1]["c6"]
        assert all(r for box in boxes[0].values() for *_x, r in box)
    finally:
        await pnode.stop()
        for node in (jnode, pnode):
            node.modules.unload("retainer")


@pytest.mark.parametrize("planner", [True, False])
def test_replay_without_a_loop_flushes_inline(planner):
    (jnode, jsess), (pnode, psess) = _nodes(planner)
    results = []
    for node, sessions, SO in ((jnode, jsess, JaxSubOpts),
                               (pnode, psess, SubOpts)):
        _subscribe(node, sessions, _SUBS, SO)
        first = _boxes(sessions)
        _subscribe(node, sessions, _RESUBS, SO)
        results.append((first, _boxes(sessions), _counters(node)))
    assert results[0] == results[1]
    # inline: one replay batch per subscription that found anything
    assert results[1][2]["retained.replay.batches"] > 2


def test_sweep_expired_on_the_stats_tick_and_the_node_facade():
    node = Node(device="cpu")
    mod = node.modules.load(RetainerModule)
    assert node.modules.load(RetainerModule) is mod
    node.publish(Message(
        topic="e/t", payload=b"x", flags={"retain": True},
        timestamp=time.time() - 100,
        headers={"properties": {"Message-Expiry-Interval": 1}}))
    node.publish(Message(topic="e/u", payload=b"y", flags={"retain": True}))
    for _ in range(RetainerModule._GC_EVERY):
        node.stats.tick()
    assert list(mod._store) == ["e/u"]
    assert node.metrics.val("retained.count") == 1
    assert node.metrics.val("retained.expired") == 1
    assert mod.replay_info()["store"] == 1
    # the facade subscribes plain subscribers on the node's broker
    s = Session("c", broker=node.broker)
    node.cm.register_channel("c", _Chan(s))
    assert node.cm.connection_count() == node.cm.session_count() == 1
    node.subscribe(s, "e/#")
    assert node.publish(Message(topic="e/v", payload=b"z")) == 1
    assert node.unsubscribe(s, "e/#")
    assert node.publish(Message(topic="e/v", payload=b"z")) == 0
    node.cm.unregister_channel("c")
    assert node.cm.lookup_channel("c") is None
    assert node.modules.unload("retainer") and not mod._store


async def test_node_start_stop_and_failed_flush_reaches_the_loop():
    """start/stop kick the sweep task; a flush that raises is not
    swallowed by the module: it reaches the loop's handler."""
    node = Node(device="cpu", boot_listeners=False)
    mod = node.modules.load(RetainerModule, {"index_device_threshold": 0})
    await node.start()
    assert mod._sweep_task is not None and not mod._sweep_task.done()
    node.broker.publish(Message(topic="a/b", payload=b"v",
                                flags={"retain": True}))
    seen = []
    loop = asyncio.get_running_loop()
    loop.set_exception_handler(lambda _l, ctx: seen.append(ctx["exception"]))

    def boom(*_a, **_k):
        raise RuntimeError("device match failed")

    mod._index.match_many = boom
    s = Session("c", broker=node.broker)
    node.cm.register_channel("c", _Chan(s))
    _subscribe(node, {"c": s}, [("c", "a/+", 0, 0, 0)], SubOpts)
    await asyncio.sleep(0)
    loop.set_exception_handler(None)
    assert [str(e) for e in seen] == ["device match failed"]
    await node.stop()
    assert mod._sweep_task is None
    node.modules.unload("retainer")


# -- B4's entry point -------------------------------------------------------

@pytest.mark.parametrize("W", [1024, 4096])
def test_or_bitmaps_equals_jax(W):
    rs = np.random.RandomState(W)
    bm = rs.randint(0, 2**32, size=(6, W), dtype=np.uint64).astype(np.uint32)
    rows = rs.randint(-1, 6, size=(9, 4)).astype(np.int32)
    rows[0] = -1
    want = np.asarray(jax_or_bitmaps(jnp.asarray(bm), jnp.asarray(rows),
                                     interpret=True))
    _build.reset_launches()
    got = or_bitmaps(torch.from_numpy(bm.view(np.int32)),
                     torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert not want[0].any() and _build.LAUNCHES["or_bitmaps"] == 0


@pytest.mark.parametrize("W", [1000, 1536, 96 * 1024])
def test_or_bitmaps_refuses_widths_outside_its_contract(W):
    with pytest.raises(ValueError):
        or_bitmaps(torch.zeros((2, W), dtype=torch.int32),
                   torch.zeros((1, 2), dtype=torch.int32))


# -- Session, Metrics, Stats -----------------------------------------------

def _session_script(S, M, SO):
    s = S("c", max_inflight=2, max_mqueue_len=3, retry_interval=0.0)
    s.subscribe("a/+", SO(qos=2))
    s.subscribe("$share/g/b/#", SO(qos=1))
    s.subscribe("u/#", SO(qos=0, subid=7))
    for i in range(6):
        s.deliver("a/+", M(topic=f"a/{i}", payload=b"%d" % i, qos=i % 3,
                           flags={"retain": True}))
    s.deliver("b/#", M(topic="b/c", payload=b"s", qos=2))
    s.deliver_many([("u/#", M(topic="u/x", payload=b"u", qos=1), None, False),
                    ("a/+", M(topic="a/y", payload=b"f"), None, True)])
    out = [s.drain_outbox()]
    s.puback(1)
    s.pubrec(2)
    s.pubcomp(2)
    out.append(s.drain_outbox())
    s.retry(now=time.time() + 1)
    out.append(s.drain_outbox())
    s.unsubscribe("$share/g/b/#")
    return [[(pid, m) if isinstance(m, int) else
             (pid, m.topic, m.payload, m.qos, dict(m.flags),
              m.headers.get("properties"), bool(m.headers.get("shared")))
             for pid, m in box] for box in out], s.info()["mqueue_len"]


def test_session_equals_jax_session():
    assert _session_script(Session, Message, SubOpts) \
        == _session_script(JaxSession, JaxMessage, JaxSubOpts)


def test_metrics_new_dec_and_unknown_names():
    m = Metrics()
    m.new("retained.count")
    m.inc("retained.count", 3)
    m.new("retained.count")  # idempotent: keeps its value
    m.dec("retained.count")
    assert m.val("retained.count") == 2
    with pytest.raises(KeyError):
        m.inc("no.such.counter")
    s = Stats()
    s.setstat("retained.count", 5, "retained.max")
    s.setstat("retained.count", 2, "retained.max")
    assert (s.getstat("retained.count"), s.getstat("retained.max")) == (2, 5)
