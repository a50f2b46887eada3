"""The port's native host engine (``emqx_tpu_torch.ops.native``, built
from ``csrc/host_native.cpp`` with ``g++``) on the CPU.

1. The cases of ``tests/test_native.py``, run against the port's
   engine, the port's ``TrieOracle`` and the port's plain walk.
2. Byte equality with the JAX package's ``NativeEngine`` on the same
   inserts and deletes: every array of ``flatten()`` (the CSR arrays
   and the compressed walk tables, narrow and wide), the three outputs
   of ``encode_batch``, ``match`` and the word table.
3. The port's ``Router`` on either engine in lockstep with the JAX
   ``Router`` on the same engine (the ``Pair`` of
   ``tests/test_torch_delta.py``): equal filter ids, ``match_ids``
   and deliveries, across an off-lock compaction with a delete during
   the flatten (held on a ``threading.Event``); the node router's
   stress race on the native engine.
4. The build: ``use_native=True`` raises when the build fails, two
   processes building at once leave one valid library, and a newer
   source rebuilds it.

Tolerance is 0 throughout: every output is an integer array or a set.
"""

import ctypes
import os
import random
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from emqx_tpu.broker import Broker as JaxBroker
from emqx_tpu.ops import native as jnative
from emqx_tpu.router import MatcherConfig as JaxMatcherConfig
from emqx_tpu.types import Message as JaxMessage
from emqx_tpu_torch.broker import Broker
from emqx_tpu_torch.ops import _build, convert, native
from emqx_tpu_torch.ops.match import match_batch, walk_params
from emqx_tpu_torch.ops.tokenize import WordTable, encode_batch
from emqx_tpu_torch.oracle import TrieOracle
from emqx_tpu_torch.router import MatcherConfig, Router
from emqx_tpu_torch.types import Message
from test_torch_delta import Pair, wait_idle
from test_torch_node_router import race_route_ops_matches_and_compactions
from test_walk_pallas import _rand_filters, _rand_topics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run torch single-threaded here and restore the setting after:
    these tests share worker processes and cores with timing-sensitive
    tests of the JAX package."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_filter(rng, maxlen=6):
    words = ["a", "b", "c", "d", "e", "x", "yy", "z0", "$s", ""]
    n = rng.randint(1, maxlen)
    ws = []
    for i in range(n):
        r = rng.random()
        if r < 0.2:
            ws.append("+")
        elif r < 0.3 and i == n - 1:
            ws.append("#")
        else:
            ws.append(rng.choice(words))
    return "/".join(ws)


def _random_name(rng):
    words = ["a", "b", "c", "d", "e", "x", "yy", "z0", "$s", "", "new"]
    return "/".join(rng.choice(words) for _ in range(rng.randint(1, 6)))


# -- 1. the cases of tests/test_native.py on the port's engine -------------


def test_native_match_parity_random():
    rng = random.Random(3)
    eng = native.NativeEngine()
    oracle = TrieOracle()
    filters = sorted({_random_filter(rng) for _ in range(500)})
    fids = {f: i for i, f in enumerate(filters)}
    for f in filters:
        eng.insert(f, fids[f])
        oracle.insert(f)
    inv = {v: k for k, v in fids.items()}
    for _ in range(600):
        name = _random_name(rng)
        got = sorted(inv[i] for i in eng.match(name))
        assert got == sorted(oracle.match(name)), name


def test_native_insert_delete_parity():
    rng = random.Random(5)
    eng = native.NativeEngine()
    oracle = TrieOracle()
    refs = {}

    def fid(f):
        return refs.setdefault(f, len(refs))

    live = {}
    for _ in range(600):
        f = _random_filter(rng)
        if f in live and rng.random() < 0.5:
            eng.delete(f)
            oracle.delete(f)
            live[f] -= 1
            if live[f] == 0:
                del live[f]
        else:
            eng.insert(f, fid(f))
            oracle.insert(f)
            live[f] = live.get(f, 0) + 1
        if rng.random() < 0.25:
            name = _random_name(rng)
            inv = {v: k for k, v in refs.items()}
            got = sorted(inv[i] for i in eng.match(name))
            assert got == sorted(oracle.match(name)), name
    assert eng.num_filters() == len(live)


def test_native_flatten_device_parity():
    """The native tables drive the port's plain walk to the trie's
    exact match sets."""
    rng = random.Random(11)
    filters = sorted({_random_filter(rng) for _ in range(300)})
    fids = {f: i for i, f in enumerate(filters)}
    oracle = TrieOracle()
    eng = native.NativeEngine()
    for f in filters:
        oracle.insert(f)
        eng.insert(f, fids[f])
    auto = eng.flatten()
    topics = [_random_name(rng) for _ in range(64)]
    ids, n, sysm = eng.encode_batch(topics, 8)
    res = match_batch(convert.automaton(auto, "cpu"), torch.from_numpy(ids),
                      torch.from_numpy(n), torch.from_numpy(sysm), k=64,
                      m=128, **walk_params(auto, ids.shape[1]))
    inv = {v: k for k, v in fids.items()}
    walked = 0
    for i, t in enumerate(topics):
        if res.overflow[i]:
            continue
        walked += 1
        got = sorted(inv[j] for j in res.ids[i].tolist() if j >= 0)
        assert got == sorted(oracle.match(t)), t
    assert walked > 48


def test_native_encode_matches_python():
    eng = native.NativeEngine()
    table = WordTable()
    # the native engine pre-interns '+'/'#' at trie construction
    table.intern("+")
    table.intern("#")
    for f in ["a/b/c", "x//y", "$SYS/z"]:
        for w in f.split("/"):
            eng.intern(w)
            table.intern(w)
    topics = ["a/b/c", "x//y", "$SYS/z", "unknown/word", "a",
              "/".join(["d"] * 40), "$SYS/" + "/".join(["d"] * 40)]
    got = eng.encode_batch(topics, 16)
    want = encode_batch(table, topics, 16)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_native_match_grows_past_cap():
    """The host match returns ALL matches even when the first output
    buffer is smaller than the match count."""
    eng = native.NativeEngine()
    for i, f in enumerate(["m/1", "m/+", "m/#", "#"]):
        eng.insert(f, i)
    assert sorted(eng.match("m/1", cap=2)) == [0, 1, 2, 3]


def test_native_churn_prunes_nodes():
    """Unique-filter churn must not grow the trie without bound."""
    eng = native.NativeEngine()
    eng.insert("keep/#", 0)
    s0 = eng.counts()
    for i in range(2000):
        f = f"reply/client-{i}/inbox"
        eng.insert(f, 1)
        eng.delete(f)
    assert eng.counts() == s0
    assert list(eng.match("keep/x")) == [0]
    assert list(eng.match("reply/client-5/inbox")) == []


def test_native_flatten_capacity_growth():
    eng = native.NativeEngine()
    eng.insert("a/b", 0)
    a1 = eng.flatten()
    eng.insert("a/+/c", 1)
    a2 = eng.flatten(state_capacity=a1.row_ptr.shape[0] - 1,
                     edge_capacity=a1.edge_word.shape[0])
    assert a2.n_states >= a1.n_states
    assert a2.row_ptr.shape == a1.row_ptr.shape


def test_native_o1_counts_match_dfs_oracle():
    """The O(1) counters agree with the DFS count after any churn:
    every flatten sizes its capacities from them."""
    rng = random.Random(11)
    eng = native.NativeEngine()
    live = {}
    for step in range(4000):
        if live and rng.random() < 0.45:
            f = rng.choice(list(live))
            eng.delete(f)
            del live[f]
        else:
            f = _random_filter(rng)
            if f not in live:
                eng.insert(f, len(live))
                live[f] = True
        if step % 500 == 0:
            assert eng.counts() == eng.counts_scan()
    assert eng.counts() == eng.counts_scan()
    for f in list(live):
        eng.delete(f)
    assert eng.counts() == eng.counts_scan() == (1, 0)


# -- 2. byte equality with the JAX package's engine ------------------------


def _engines(filters, deletes=()):
    """The port's engine and the JAX package's after the same inserts
    (ids in order) and deletes."""
    port, ref = native.NativeEngine(), jnative.NativeEngine()
    for i, f in enumerate(filters):
        assert port.insert(f, i) == ref.insert(f, i)
    for f in deletes:
        assert port.delete(f) == ref.delete(f)
    return port, ref


def _same_automaton(a, b):
    assert a._fields == b._fields
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name


@pytest.mark.parametrize("deep", [False, True], ids=["narrow", "wide"])
def test_flatten_arrays_equal_the_jax_engine(deep):
    rng = random.Random(808 + deep)
    filters = sorted(_rand_filters(rng, 400, deep=deep))
    gone = rng.sample(filters, 60)
    port, ref = _engines(filters, gone)
    assert port.counts() == ref.counts()
    a, b = port.flatten(), ref.flatten()
    assert (a.wt_take > 1) == deep
    _same_automaton(a, b)
    # capacity floors, as a rebuild passes them, and the raw CSR
    kw = dict(v2_state_capacity=4 * a.node2.shape[0],
              n_buckets=2 * a.wt.shape[0])
    _same_automaton(port.flatten(**kw), ref.flatten(**kw))
    _same_automaton(port.flatten(skip_hash=True),
                    ref.flatten(skip_hash=True))


def test_encode_batch_and_match_equal_the_jax_engine():
    rng = random.Random(909)
    filters = sorted(_rand_filters(rng, 300))
    port, ref = _engines(filters, filters[::7])
    topics = _rand_topics(rng, 200) + [
        "$SYS/a/b", "/".join(["s1"] * 40), "", "a//b", "never/seen"]
    for L in (4, 16, 64):
        for g, w in zip(port.encode_batch(topics, L),
                        ref.encode_batch(topics, L)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    for t in topics:
        np.testing.assert_array_equal(port.match(t), ref.match(t))
    assert port.words() == ref.words()
    assert port.vocab_size() == ref.vocab_size()
    assert [port.lookup(w) for w in ("s1", "a", "zz")] == \
        [ref.lookup(w) for w in ("s1", "a", "zz")]


def test_mqtt_scan_equals_the_jax_scanner():
    from emqx_tpu.mqtt.frame import serialize as jser
    from emqx_tpu.mqtt.packet import Publish as JPublish

    frames = b"".join(jser(JPublish(topic=f"t/{i}", qos=i % 3,
                                    packet_id=(i + 1) if i % 3 else None,
                                    payload=b"x" * i), 4)
                      for i in range(40))
    for buf in (frames, frames[:-3], bytearray(frames),
                b"\x30\xff\xff\xff\xff\xff", b"\x30\xff\xff\x7f"):
        assert native.mqtt_scan(buf, 1 << 20) == \
            jnative.mqtt_scan(buf, 1 << 20)


# -- 3. the router on either engine, in lockstep with the JAX router -------


def _match_ids_filters(router, topics):
    """``match_ids`` read back through its id map: a set of filters
    per topic, overflow rows re-matched on the host."""
    _d, mid, ovf, id_map, _e = router.match_ids(topics)
    out = []
    for i, t in enumerate(topics):
        if ovf[i]:
            out.append(sorted(router.host_match(t)))
        else:
            out.append(sorted(id_map[j] for j in mid[i] if j >= 0
                              and id_map[j] is not None))
    return out


def test_router_defaults_to_the_native_engine():
    r = Router(device="cpu")
    assert r.config.use_native and isinstance(r._native,
                                              native.NativeEngine)
    assert r._trie is None and r._table is None
    assert Router(MatcherConfig(use_native=False),
                  device="cpu")._native is None


@pytest.mark.parametrize("match_cache", [False, True])
@pytest.mark.parametrize("delta", [False, True])
def test_native_router_randomized_churn_lockstep(delta, match_cache):
    """Both routers on the C++ engine under interleaved add, delete and
    match churn: byte-equal ``match_dispatch``, equal state, results
    equal to the TrieOracle; then a fold, and the same again."""
    rng = random.Random(42 + 2 * delta + match_cache)
    pr = Pair(native=True, delta=delta, match_cache=match_cache,
              max_levels=6, active_k=4, delta_max_filters=10_000)
    words = ["a", "b", "w1", "w2", "x"]

    def roll():
        if rng.random() < 0.1:
            return "$share/g1/%s/%s" % (rng.choice(words),
                                        rng.choice(words))
        ws = [rng.choice(words + ["+"]) for _ in range(rng.randint(1, 5))]
        if rng.random() < 0.2:
            ws[-1] = "#"
        return "/".join(ws)

    probe = ["a/b", "w1/w2/x", "a/a/a/a/a", "$share/g1/a/b", "b",
             "zz/unmatched", "a/b/x/w1/w2/a/b/x"] + [
        "x/" + "/".join(rng.choice(words) for _ in range(3))
        for _ in range(4)]
    live = set()
    while len(live) < 60:
        f = roll()
        if f not in live:
            pr.add(f)
            live.add(f)
    pr.parity(probe[:2])
    for step in range(120):
        if live and rng.random() < 0.45:
            f = rng.choice(sorted(live))
            pr.delete(f)
            live.discard(f)
        else:
            f = roll()
            if f not in live:
                pr.add(f)
                live.add(f)
        if step % 15 == 0:
            pr.parity(probe, tag=f"@{step}")
            assert _match_ids_filters(pr.ref, probe) == \
                _match_ids_filters(pr.port, probe)
    pr.rebuild()
    pr.parity(probe, tag="post-fold")


@pytest.mark.parametrize("native_engine", [False, True],
                         ids=["py", "native"])
def test_router_lockstep_across_offlock_compaction(native_engine):
    """Deletes, an add and a delete-then-re-add land while the
    compaction flatten is held. On the native engine both routers
    complete the compaction and stay byte-equal throughout. On the
    Python engine the JAX router's flatten raises ``KeyError`` (the
    reference caveat, ROADMAP.md queue C) while the port's completes;
    ids, ``match_ids`` and matches stay equal."""
    pr = Pair(native=native_engine, match_cache=False, delta_max_filters=8)
    for i in range(50):
        pr.add(f"s/{i}/x")
    pr.parity(["s/0/x"])
    started, release = pr.gate()
    for i in range(8):
        pr.add(f"b/{i}/y")   # the 8th triggers the compaction (held)
    assert started()
    assert pr.port.delta_info()["rebuild_inflight"]
    pr.delete("s/7/x")
    pr.delete("b/2/y")
    pr.add("mid/flight")
    pr.delete("s/9/x")
    pr.add("s/9/x")
    topics = ["s/7/x", "b/2/y", "mid/flight", "b/3/y", "s/9/x", "s/8/x",
              "zz/none"]
    want = [sorted(pr.oracle.match(t)) for t in topics]
    for r in (pr.ref, pr.port):   # during the flatten, trie frozen
        assert [sorted(r.host_match(t)) for t in topics] == want
        assert _match_ids_filters(r, topics) == want
    pr.parity(topics, tag="during")
    release()
    assert pr.port._compact_failures == 0
    assert pr.port.delta_info()["merges"] == 1
    assert pr.ref._compact_failures == (0 if native_engine else 1)
    assert pr.ref._filter_ids == pr.port._filter_ids
    for r in (pr.ref, pr.port):
        assert _match_ids_filters(r, topics) == want
    if native_engine:
        pr.parity(topics, tag="post-swap")
    else:
        assert [sorted(r) for r in pr.filters(topics)] == want
    pr.rebuild()
    for r in (pr.ref, pr.port):
        assert _match_ids_filters(r, topics) == want
    if native_engine:
        pr.parity(topics, tag="post-fold")


def test_native_route_ops_matches_and_compactions_race():
    """The node router's stress race (more threads than cores, a short
    switch interval, repeated off-lock compactions) on the native
    engine, whose flatten runs in C++ with the GIL released."""
    race_route_ops_matches_and_compactions(use_native=True)


class _Sink:
    def __init__(self, name):
        self.client_id = name
        self.inbox = []

    def deliver(self, topic_filter, msg):
        self.inbox.append((msg.topic, topic_filter, msg.payload))


@pytest.mark.parametrize("native_engine", [False, True],
                         ids=["py", "native"])
def test_broker_deliveries_in_lockstep(native_engine):
    """The JAX Broker and the port's, each at its defaults (delta, match
    cache) on the same engine: equal deliveries per batch across
    subscribe/unsubscribe churn that crosses ``delta_max_filters`` and
    runs background compactions."""
    kw = dict(use_native=native_engine, device_min_filters=1,
              fanout_threshold=4, delta_max_filters=16)
    ref = JaxBroker(config=JaxMatcherConfig(**kw))
    port = Broker(config=MatcherConfig(**kw), device="cpu")
    rng = random.Random(77 + native_engine)
    filters = sorted(_rand_filters(rng, 80, deep=False))
    pairs = [(ref, [_Sink(f"c{i}") for i in range(6)], JaxMessage),
             (port, [_Sink(f"c{i}") for i in range(6)], Message)]
    subs = set()
    for step in range(6):
        ops = []
        for _ in range(24):
            f, s = rng.choice(filters), rng.randrange(6)
            ops.append(("-" if (f, s) in subs else "+", f, s))
            subs ^= {(f, s)}
        topics = _rand_topics(rng, 40, L=10)
        got = []
        for b, sinks, mcls in pairs:
            for op, f, s in ops:
                (b.subscribe if op == "+" else b.unsubscribe)(sinks[s], f)
                # a compaction this op started freezes and swaps before
                # the next op, in both routers: where a swap lands
                # among the ops decides which quarantined ids recycle
                # into later adds, so a thread-timed swap point would
                # let the routers' filter ids drift apart
                wait_idle(b.router)
            res = b.publish_batch([mcls(topic=t, payload=b"%d" % i)
                                   for i, t in enumerate(topics)])
            got.append((list(res),
                        {s.client_id: sorted(s.inbox) for s in sinks}))
            for s in sinks:
                s.inbox.clear()
        assert got[0] == got[1], step
        assert sum(got[1][0]) > 0
    assert port.router._native is not None if native_engine \
        else port.router._native is None
    assert port.router.filter_id(filters[0]) == \
        ref.router.filter_id(filters[0])


# -- 4. the build ------------------------------------------------------------


def test_use_native_raises_when_the_build_fails(tmp_path, monkeypatch):
    bad = tmp_path / "host_native.cpp"
    bad.write_text("int broken(; // not C++\n")
    monkeypatch.setattr(_build, "HOST_SRC", bad)
    monkeypatch.setattr(_build, "HOST_LIB", tmp_path / "libhost.so")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="host library build failed"):
        Router(device="cpu")
    with pytest.raises(RuntimeError, match="broken"):
        native.NativeEngine()
    assert not (tmp_path / "libhost.so").exists()
    # the Python engine is asked for explicitly, and needs no build
    r = Router(MatcherConfig(use_native=False), device="cpu")
    assert r.add_route("a/+") == 0 and r.host_match("a/b") == ["a/+"]


def test_two_processes_building_at_once_leave_one_valid_library(tmp_path):
    lib = tmp_path / "libhost.so"
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        from emqx_tpu_torch.ops import _build
        _build.build_host(lib={str(lib)!r})
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for _ in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out.decode(errors="replace")
    # one library, no temporary file left behind, and it loads
    assert sorted(x.name for x in tmp_path.iterdir()) == \
        ["libhost.so", "libhost.so.lock"]
    so = ctypes.CDLL(str(lib))
    so.wt_new.restype = ctypes.c_void_p
    so.wt_size.argtypes = [ctypes.c_void_p]
    assert so.wt_size(so.wt_new()) == 0


def test_build_host_rebuilds_only_when_the_source_is_newer(tmp_path):
    src = tmp_path / "host.cpp"
    src.write_bytes(_build.HOST_SRC.read_bytes())
    lib = tmp_path / "libhost.so"
    _build.build_host(src, lib)
    first = lib.stat().st_mtime_ns
    _build.build_host(src, lib)
    assert lib.stat().st_mtime_ns == first   # up to date: no build
    later = time.time() + 5
    os.utime(src, (later, later))
    _build.build_host(src, lib)
    assert lib.stat().st_mtime_ns != first
