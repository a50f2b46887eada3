"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one; the
file imports only torch, numpy and the port (no JAX), so on a GPU host
it runs without the JAX package's test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerance is 0: every output is an integer or a bit.
"""

import numpy as np
import pytest
import torch

from emqx_tpu_torch import topic as T
from emqx_tpu_torch.broker import Broker
from emqx_tpu_torch.ops import _build, convert
from emqx_tpu_torch.modules.retainer import RetainIndex
from emqx_tpu_torch.ops.bitmap import (or_bitmaps, or_bitmaps_cuda,
                                       or_bitmaps_ref, or_union_rows_cuda,
                                       or_union_rows_ref)
from emqx_tpu_torch.ops.csr import (attach_walk_tables, build_automaton,
                                    compress_automaton)
from emqx_tpu_torch.ops.match import match_batch, walk_params
from emqx_tpu_torch.ops.pack import pack_union_rows, union_slots
from emqx_tpu_torch.ops.retained_match import (match_names_cuda,
                                               match_names_many)
from emqx_tpu_torch.ops.tokenize import WordTable, encode_batch
from emqx_tpu_torch.ops.walk_cuda import match_batch_cuda
from emqx_tpu_torch.oracle import TrieOracle
from emqx_tpu_torch.router import MatcherConfig
from emqx_tpu_torch.types import Message

WORDS = ["a", "b", "c", "s0", "s1", "s2", ""]


@pytest.fixture
def cuda_device():
    """The card, or a skip on a host without one (decided per test,
    never at import time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs the kernels "
                    "on the card")
    return torch.device("cuda")


def _filters(rs, n):
    out = set()
    while len(out) < n:
        depth = int(rs.randint(1, 15))
        ws = [WORDS[i] for i in rs.randint(0, len(WORDS), size=depth)]
        r = rs.rand()
        if r < 0.2:
            ws[int(rs.randint(0, depth))] = "+"
        elif r < 0.3:
            ws[-1] = "#"
        elif r < 0.35:
            ws = ["$SYS"] + ws
        f = "/".join(ws)
        try:
            T.validate(f, "filter")
        except T.TopicError:
            continue  # e.g. the empty filter
        out.add(f)
    return sorted(out)


def _topics(rs, n):
    out = []
    for _ in range(n):
        depth = int(rs.randint(1, 17))
        out.append("/".join(WORDS[i] for i in
                            rs.randint(0, len(WORDS), size=depth)))
    return out + ["$SYS/a/b", "/".join(["s0"] * 20)]


def _automaton(filters, mode):
    trie, table, fids = TrieOracle(), WordTable(), {}
    for f in filters:
        trie.insert(f)
        fids[f] = len(fids)
        for w in f.split("/"):
            if w not in ("+", "#"):
                table.intern(w)
    raw = build_automaton(trie, fids, table, skip_hash=True)
    auto, edges = compress_automaton(raw, force_mode=mode)
    return attach_walk_tables(auto, edges), table


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["narrow", "wide"])
def test_walk_kernel_matches_plain_walk(cuda_device, mode):
    """k on both sides of the two compaction orders (2k = 30, 32, 34
    and 64) and of two frontier slots a lane (k = 33), a batch of 700
    topics, of one and of 4,093 (not a multiple of the block's 4). A
    topic made from each filter walks every edge, the ones placed in
    their second-choice bucket row too."""
    rs = np.random.RandomState(12)
    filters = _filters(rs, 400)
    auto, table = _automaton(filters, mode)
    topics = _topics(rs, 300) + [f.replace("+", "a").replace("#", "b")
                                 for f in filters]
    batches = [topics, topics[:1], (topics * 6)[:4093]]
    for bi, batch in enumerate(batches):
        ids, n, sysm = encode_batch(table, batch, 16)
        ta = convert.automaton(auto, cuda_device)
        args = [torch.from_numpy(a).to(cuda_device) for a in (ids, n, sysm)]
        for k in ((2, 15, 16, 17, 32, 33, 64) if bi == 0 else (2, 16, 64)):
            for pack_ids in (True, False):
                kw = dict(k=k, m=64, pack_ids=pack_ids,
                          **walk_params(auto, ids.shape[1]))
                want = match_batch(ta, *args, **kw)
                _build.reset_launches()
                got = match_batch_cuda(ta, *args, **kw)
                torch.cuda.synchronize()
                assert _build.LAUNCHES["walk"] == 1
                for x, y in zip(got, want):
                    assert torch.equal(x, y), (len(batch), k, pack_ids)
        # no hop at all: every live topic keeps a lane, so it overflows
        kw = dict(k=16, m=64, steps=0, slots=auto.wt_slots,
                  take=auto.wt_take)
        for x, y in zip(match_batch_cuda(ta, *args, **kw),
                        match_batch(ta, *args, **kw)):
            assert torch.equal(x, y), (len(batch), "steps=0")


def _wide_frontier(rs):
    """Filters over {a, b, +} of up to 10 levels, half of the words
    wildcards: an all-``a`` topic's frontier grows past 64 lanes."""
    filters = set()
    while len(filters) < 1500:
        ws = list(rs.choice(list("aaab++++"), size=int(rs.randint(1, 11))))
        if rs.rand() < 0.15:
            ws[-1] = "#"
        filters.add("/".join(ws))
    filters = sorted(filters)
    topics = ["/".join(rs.choice(list("aaabc"), size=int(rs.randint(1, 12))))
              for _ in range(40)]
    return filters, topics + [f.replace("+", "a").replace("#", "b")
                              for f in filters[::9]]


def _deep(rs, L):
    """Spines of 60 to ``L`` levels with wildcards sprinkled in."""
    filters = set()
    while len(filters) < 120:
        depth = int(rs.randint(60, L + 1))
        ws = ["s%d" % i for i in rs.randint(0, 3, size=depth)]
        for _ in range(int(rs.randint(0, 4))):
            ws[int(rs.randint(0, depth))] = "+"
        if rs.rand() < 0.3:
            ws[-1] = "#"
        filters.add("/".join(ws))
    filters = sorted(filters)
    topics = ["/".join("s%d" % i for i in
                       rs.randint(0, 3, size=int(rs.randint(1, L + 1))))
              for _ in range(24)]
    return filters, topics + [f.replace("+", "s1").replace("#", "s2")
                              for f in filters] + ["/".join(["s0"] * L)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["k65-narrow", "k128-narrow", "k200-narrow",
                                  "k65-wide", "k128-wide", "k200-wide",
                                  "L65", "L100"])
def test_walk_kernel_past_the_register_limits(cuda_device, case):
    """Frontiers of 65 to 200 lanes and topics of 65 and 100 levels
    (the kernel's scratch-row instantiation) against the plain walk,
    at a batch of one topic, of the inputs and of 4,093."""
    rs = np.random.RandomState(14)
    if case.startswith("k"):
        k, mode = case[1:].split("-")
        k, L = int(k), 16
        filters, topics = _wide_frontier(rs)
    else:
        k, L, mode = 16, int(case[1:]), "narrow"
        filters, topics = _deep(rs, L)
    auto, table = _automaton(filters, mode)
    ta = convert.automaton(auto, cuda_device)
    for batch in (topics, topics[-1:], (topics * 30)[:4093]):
        ids, n, sysm = encode_batch(table, batch, L)
        args = [torch.from_numpy(a).to(cuda_device) for a in (ids, n, sysm)]
        for pack_ids in (True, False):
            kw = dict(k=k, m=512, pack_ids=pack_ids,
                      **walk_params(auto, ids.shape[1]))
            want = match_batch(ta, *args, **kw)
            _build.reset_launches()
            got = match_batch_cuda(ta, *args, **kw)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["walk"] == 1
            for x, y in zip(got, want):
                assert torch.equal(x, y), (case, len(batch), pack_ids)
        assert not bool(want.overflow.all())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["narrow", "wide"])
def test_walk_kernel_refuses_a_slot_count_of_another_layout(cuda_device,
                                                            mode):
    """The kernel is built for 2 slots (narrow) and 4 (wide); any other
    count is refused before a launch, on CUDA tensors."""
    rs = np.random.RandomState(13)
    auto, table = _automaton(_filters(rs, 50), mode)
    ids, n, sysm = encode_batch(table, _topics(rs, 20), 16)
    ta = convert.automaton(auto, cuda_device)
    args = [torch.from_numpy(a).to(cuda_device) for a in (ids, n, sysm)]
    kw = dict(k=16, m=64, **walk_params(auto, ids.shape[1]))
    for slots in (1, 3, 6 - kw["slots"], 8):
        _build.reset_launches()
        with pytest.raises(ValueError, match="slots"):
            match_batch_cuda(ta, *args, **dict(kw, slots=slots))
        assert _build.LAUNCHES["walk"] == 0


@pytest.mark.gpu
def test_bitmap_kernel_matches_plain_or(cuda_device):
    g = torch.Generator(device="cpu").manual_seed(3)
    bm = torch.randint(-2**31, 2**31 - 1, (16, 4096), generator=g,
                       dtype=torch.int32).to(cuda_device)
    rows = torch.randint(-1, 16, (300, 16), generator=g,
                         dtype=torch.int32).to(cuda_device)
    want = or_bitmaps_ref(bm, rows)
    got = or_bitmaps_cuda(bm, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_or_bitmaps_entry_point_launches_the_bitmap_kernel(cuda_device):
    g = torch.Generator(device="cpu").manual_seed(4)
    bm = torch.randint(-2**31, 2**31 - 1, (8, 2048), generator=g,
                       dtype=torch.int32).to(cuda_device)
    rows = torch.randint(-1, 8, (50, 5), generator=g,
                         dtype=torch.int32).to(cuda_device)
    _build.reset_launches()
    got = or_bitmaps(bm, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, or_bitmaps_ref(bm, rows))
    assert _build.LAUNCHES["or_bitmaps"] == _build.LAUNCHES["bitmap_or"] == 1


@pytest.mark.gpu
def test_union_kernel_matches_its_twin_and_the_dense_route(cuda_device):
    """The packed union at budgets below (overflow), at and above the
    live count, against its plain twin and against the dense route
    (the same kernel with a null slot map, then ``pack_union_rows``);
    W = 4,100 words leaves a ragged strip at the row's end."""
    g = torch.Generator(device="cpu").manual_seed(5)
    bm = torch.randint(-2**31, 2**31 - 1, (16, 4100), generator=g,
                       dtype=torch.int32).to(cuda_device)
    rows = torch.randint(-1, 16, (300, 16), generator=g, dtype=torch.int32)
    rows[torch.rand(300, generator=g) < 0.7] = -1
    rows = rows.to(cuda_device)
    has_big = (rows >= 0).any(1)
    live = int(has_big.sum())
    for pr in (1, live // 2, live, live + 7):
        sel, src, total = union_slots(has_big, pr)
        _build.reset_launches()
        got = or_union_rows_cuda(bm, rows, src)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["bitmap_or"] == 1
        assert got.shape == (pr, 4100) and int(total) == live
        assert torch.equal(got, or_union_rows_ref(bm, rows, src)), pr
        dense = pack_union_rows(or_bitmaps_cuda(bm, rows), has_big, pr=pr)
        assert torch.equal(dense[1], got) and torch.equal(dense[0], sel)


def _retained_index(rs, n):
    idx = RetainIndex("cpu")
    words = ["a", "b", "c", "$SYS", "$p", "s0", ""]
    for _ in range(n):
        depth = int(rs.randint(1, 21))
        idx.add("/".join(words[i] for i in rs.randint(0, len(words),
                                                        size=depth)))
    for t in list(idx._row_of)[::3]:
        idx.remove(t)  # dead rows
    return idx


@pytest.mark.gpu
@pytest.mark.parametrize("n_names", [37, 1500])
def test_retained_kernel_matches_plain_match(cuda_device, n_names):
    rs = np.random.RandomState(n_names)
    idx = _retained_index(rs, n_names)
    flts = ["#", "+/+", "$SYS/#", "a/+/#", "zz/+", "+", "a", "b/#",
            "/".join(["+"] * 16), "+/b/c/#"]
    for F in (1, 3, 10, 130):
        fw, fn, hh = idx._encode((flts * 13)[:F])
        args = [torch.from_numpy(a).to(cuda_device) for a in
                (fw, fn, hh, idx._ids, idx._n, idx._sys)]
        want = match_names_many(*args)
        _build.reset_launches()
        got = match_names_cuda(*args)
        torch.cuda.synchronize()
        assert got.dtype == torch.bool and torch.equal(got, want), F
        assert _build.LAUNCHES["retained_match"] == 1
        # ragged cap: a slice of the name rows
        cut = [a[:-5] if a.shape[0] == idx._cap else a for a in args]
        assert torch.equal(match_names_cuda(*cut), match_names_many(*cut))


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [1000, 1001, 1002, 1003])
def test_retained_kernel_at_ragged_caps_and_every_level_count(cuda_device,
                                                              cap):
    """Random rows (a small word alphabet, so levels match often) at a
    cap of 4·k and 4·k + 1..3, with the burst's deepest filter
    comparing 1 to 16 levels: every quarter count of a name row, and
    the byte-store path wherever a filter's output row is not 4-byte
    aligned."""
    rs = np.random.RandomState(cap)
    F = 37
    names = [rs.randint(-2, 4, size=(cap, 16)), rs.randint(-1, 21, size=cap),
             rs.rand(cap) < 0.3]
    for top in range(1, 17):
        fn = rs.randint(-1, top + 1, size=F)
        fn[0] = top
        raw = [rs.randint(-3, 4, size=(F, 16)), fn, rs.rand(F) < 0.4] + names
        args = [torch.from_numpy(a.astype(np.int32) if a.dtype != bool else a)
                .to(cuda_device) for a in raw]
        want = match_names_many(*args)
        _build.reset_launches()
        got = match_names_cuda(*args)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["retained_match"] == 1
        assert got.dtype == torch.bool and torch.equal(got, want), top
        assert bool(want.any())


@pytest.mark.gpu
def test_retain_index_on_card_matches_cpu_index(cuda_device):
    rs = np.random.RandomState(5)
    cpu = _retained_index(rs, 1200)
    card = RetainIndex(cuda_device)
    for t in cpu._row_of:
        card.add(t)
    for t in cpu._deep:
        card.add(t)
    flts = ["#", "+/+/#", "$SYS/#", "a/#", "a/b", "c/+/a"]
    _build.reset_launches()
    got = card.match_many(flts, device_threshold=0)
    want = cpu.match_many(flts, device_threshold=0)
    assert [sorted(h) for h in got] == [sorted(h) for h in want]
    assert _build.LAUNCHES["retained_match"] == 1


class Sink:
    def __init__(self, name):
        self.client_id = name
        self.inbox = []

    def deliver(self, topic_filter, msg):
        self.inbox.append((msg.topic, topic_filter))


@pytest.mark.gpu
def test_broker_on_card_delivers_like_the_cpu_broker(cuda_device):
    rs = np.random.RandomState(7)
    filters = _filters(rs, 200)
    topics = _topics(rs, 100)
    boxes = []
    for dev in ("cpu", cuda_device):
        b = Broker(config=MatcherConfig(device_min_filters=1,
                                        fanout_threshold=4), device=dev)
        sinks = [Sink(f"c{i}") for i in range(10)]
        for f in filters:
            for i in rs.choice(10, size=2, replace=False):
                b.subscribe(sinks[i], f)
        for s in sinks[:6]:
            b.subscribe(s, "a/b/c")
        _build.reset_launches()
        res = b.publish_batch([Message(topic=t) for t in topics])
        boxes.append((res, {s.client_id: sorted(s.inbox) for s in sinks}))
        if dev != "cpu":
            assert _build.LAUNCHES["walk"] >= 1
            assert _build.LAUNCHES["bitmap_or"] >= 1
        rs = np.random.RandomState(7)
        _filters(rs, 200)
        _topics(rs, 100)
    assert boxes[0] == boxes[1]


class PayloadSink:
    """Subscriber double recording ``(topic, filter, payload)``."""

    def __init__(self, name):
        self.client_id = name
        self.inbox = []

    def deliver(self, topic_filter, msg):
        self.inbox.append((msg.topic, topic_filter, msg.payload))


@pytest.mark.gpu
def test_ingress_burst_on_card_delivers_like_the_cpu_broker(cuda_device):
    """An open-loop burst into the card node's ingress batcher, all of
    it in one event-loop step: every pipeline slot busy (begin on the
    loop, fetch on the executor's threads), the backlog flushed as one
    batch of ``batch_cap`` messages. The delivery counts and the
    per-subscriber multisets equal the CPU broker's ``publish_batch``,
    the acks resolve in submission order and each topic reaches a
    subscriber in publish order."""
    import asyncio
    from collections import Counter

    from emqx_tpu_torch.ingress import MAX_INFLIGHT
    from emqx_tpu_torch.node import Node

    cfg = dict(device_min_filters=1, fanout_threshold=4)
    rs = np.random.RandomState(11)
    pairs = [(f, int(i)) for f in _filters(rs, 200)
             for i in rs.choice(10, size=2, replace=False)]
    pairs += [("a/b/c", i) for i in range(6)]
    node = Node(matcher=MatcherConfig(**cfg), batch_size=64,
                device=cuda_device)
    ing = node.ingress
    topics = _topics(rs, MAX_INFLIGHT * ing.batch_size + ing.batch_cap + 32)
    ref = Broker(config=MatcherConfig(**cfg), device="cpu")
    boxes = []
    for b in (node.broker, ref):
        sinks = [PayloadSink(f"c{i}") for i in range(10)]
        for f, i in pairs:
            b.subscribe(sinks[i], f)
        boxes.append(sinks)
    msgs = [Message(topic=t, payload=b"%d" % i) for i, t in enumerate(topics)]

    async def burst():
        order, futs = [], []
        for i, m in enumerate(msgs):
            fut = ing.submit(m)
            fut.add_done_callback(lambda _f, i=i: order.append(i))
            futs.append(fut)
        inflight = ing.stats()["ingress.inflight"]
        res = await asyncio.gather(*futs)
        await ing.drain()
        return list(res), order, inflight

    _build.reset_launches()
    res, order, inflight = asyncio.run(asyncio.wait_for(burst(), 120))
    assert inflight == MAX_INFLIGHT
    assert ing.stats()["ingress.max_batch"] == ing.batch_cap
    assert ing.device_batches == ing.flushes == MAX_INFLIGHT + 2
    assert _build.LAUNCHES["walk"] >= ing.device_batches
    assert order == list(range(len(msgs)))
    want = ref.publish_batch([Message(topic=m.topic, payload=m.payload)
                              for m in msgs])
    assert res == list(want)
    for got, exp in zip(*boxes):
        assert Counter(got.inbox) == Counter(exp.inbox), got.client_id
        last = {}
        for t, f, p in got.inbox:
            assert int(p) >= last.get((t, f), -1), (got.client_id, t)
            last[(t, f)] = int(p)


# -- the router's torch glue on the card: delta, match cache, patch ---------


def _router_pair(cuda_device, **kw):
    """A CPU router and a card router fed the same routes."""
    from emqx_tpu_torch.router import Router

    rs = np.random.RandomState(21)
    filters = _filters(rs, 300)
    topics = _topics(rs, 200)
    routers = [Router(MatcherConfig(device_min_filters=1, **kw), device=d)
               for d in ("cpu", cuda_device)]
    for r in routers:
        for f in filters[:250]:
            r.add_route(f)
        r.automaton()
    return routers, filters, topics


@pytest.mark.gpu
def test_delta_walk_on_kernel_matches_plain_walk(cuda_device):
    """The side automaton's walk (narrow, take 1, slots 2, k =
    ``snap.k``) through kernel B1 equals the plain walk bit for bit,
    raw and packed, with tombstones masked; a batch with pending delta
    adds launches B1 twice (main tables, then the delta)."""
    from emqx_tpu_torch.ops.delta import probe_packed, probe_raw

    routers, filters, topics = _router_pair(cuda_device, match_cache=False)
    for r in routers:
        for f in filters[250:]:
            r.add_route(f)          # pending adds: the side automaton
        for f in filters[:250:9]:
            r.delete_route(f)       # tombstones
    outs = []
    for r in routers:
        main, snap = r._snapshot_pair()
        assert snap.auto is not None and snap.mask is not None
        args, kw = r.walk_inputs(topics)
        res = (match_batch_cuda if args[0].is_cuda else match_batch)(
            main[0], *args, **kw)
        packed = (match_batch_cuda if args[0].is_cuda else match_batch)(
            main[0], *args, **dict(kw, pack_ids=True))
        _build.reset_launches()
        raw = probe_raw(snap, *args, res.ids, res.overflow, m=kw["m"])
        pk = probe_packed(snap, *args, packed.ids, packed.overflow,
                          m=kw["m"])
        outs.append((raw, pk, dict(_build.LAUNCHES)))
        _build.reset_launches()
        r.match_dispatch(topics)
        outs[-1] += (dict(_build.LAUNCHES),)
    (c_raw, c_pk, _, _), (g_raw, g_pk, g_launch, g_disp) = outs
    for x, y in zip(c_raw + c_pk, g_raw + g_pk):
        assert torch.equal(x, y.cpu())
    assert g_launch["walk"] == 2      # one per probe call
    assert g_disp["walk"] == 2        # main tables + the delta


@pytest.mark.gpu
def test_cache_tombstone_union_and_patch_ops_on_card_equal_cpu(cuda_device):
    """The cache's insert and merge, the tombstone mask, the packed
    union and one patch drain, on CUDA tensors, equal their CPU
    results."""
    from emqx_tpu_torch.ops.delta import mask_ids, union_packed
    from emqx_tpu_torch.ops.match_cache import insert_rows, merge_rows

    rs = np.random.RandomState(5)
    table = torch.from_numpy(rs.randint(-1, 99, (64, 9)).astype(np.int32))
    rows = torch.from_numpy(rs.randint(-1, 99, (16, 8)).astype(np.int32))
    ovf = torch.from_numpy(rs.rand(16) < 0.2)
    slots = [int(s) for s in rs.choice(64, 11, replace=False)] + [7, 7]
    mask = torch.from_numpy(rs.rand(40) < 0.3)
    ids = torch.from_numpy(rs.randint(-1, 60, (32, 20)).astype(np.int32))
    b = torch.from_numpy(rs.randint(-1, 60, (32, 12)).astype(np.int32))
    res = []
    for d in ("cpu", cuda_device):
        res.append([
            insert_rows(table.to(d), slots, rows.to(d), ovf.to(d)),
            *merge_rows(table.to(d), [3, 9, 1], [0, 5, 17], rows.to(d),
                        ovf.to(d), [2, 4, 30, 31], 32),
            mask_ids(ids.to(d), mask.to(d)),
            *union_packed(ids.to(d), b.to(d), m=24),
        ])
    for x, y in zip(*res):
        assert torch.equal(x, y.cpu())
    # one patch drain: the same queue applied on each device
    from emqx_tpu_torch.router import Router

    routers = [Router(MatcherConfig(device_min_filters=1, delta=False,
                                    match_cache=False,
                                    patch_drain_batch=10**9), device=d)
               for d in ("cpu", cuda_device)]
    filters = _filters(np.random.RandomState(8), 260)
    tables = []
    for r in routers:
        for f in filters[:200]:
            r.add_route(f)
        r.automaton()
        for f in filters[200:]:
            r.add_route(f)
        for f in filters[:200:7]:
            r.delete_route(f)
        assert r._patcher.queued > 0
        auto = r.automaton()[0]
        tables.append((auto.wt, auto.node2))
    for x, y in zip(*tables):
        assert torch.equal(x, y.cpu())


def _mesh_case(rs, n_trie):
    """Sharded tables, small-filter fan-out and big-filter bitmaps over
    ``n_trie`` shards (host arrays), and an encoded batch."""
    from emqx_tpu_torch.parallel.sharded import (build_sharded,
                                                 build_sharded_bitmaps,
                                                 build_sharded_fanout,
                                                 shard_filters)

    filters = _filters(rs, 200)
    fids = {f: i for i, f in enumerate(filters)}
    table = WordTable()
    for f in filters:
        for w in f.split("/"):
            table.intern(w)
    shards = shard_filters(filters, n_trie)
    auto, parts = build_sharded(shards, fids, table, return_parts=True)
    small, big = [{} for _ in shards], [{} for _ in shards]
    for t, shard in enumerate(shards):
        for f in shard:
            n = int(rs.randint(1, 40))
            (big if n > 30 else small)[t][fids[f]] = sorted(
                int(x) for x in rs.choice(50_000, n, replace=False))
    fan = build_sharded_fanout(small, len(filters))
    bm = build_sharded_bitmaps(big, len(filters), 50_000, row_capacity=64)
    ids, n, sysm = encode_batch(table, (_topics(rs, 500) * 9)[:4096], 16)
    return auto, fan, bm, (ids, n, sysm), walk_params(parts[0], 16)


@pytest.mark.gpu
def test_mesh_step_on_a_2x2_grid_of_one_card_equals_the_cpu_mesh(cuda_device):
    """publish_step on a 2×2 mesh of the one card: B1 and B2 launch once
    per cell (4 each), and every output equals the same step on a 2×2
    CPU mesh (the plain walk and the plain OR in every cell)."""
    from emqx_tpu_torch.parallel.mesh import make_mesh
    from emqx_tpu_torch.parallel.sharded import place_sharded, publish_step

    auto, fan, bm, batch, wp = _mesh_case(np.random.RandomState(21), 2)
    kw = dict(k=16, m=64, d=32, mb=4, **wp)
    outs = []
    for devs in ([cuda_device] * 4, ["cpu"] * 4):
        mesh = make_mesh(2, 2, devs)
        placed = [place_sharded(mesh, x) for x in (auto, fan, bm)]
        _build.reset_launches()
        outs.append(publish_step(mesh, placed[0], placed[1], *batch,
                                 placed[2], **kw))
        torch.cuda.synchronize()
        if devs[0] == cuda_device:
            assert _build.LAUNCHES["walk"] == 4
            assert _build.LAUNCHES["bitmap_or"] == 4
    got, want = outs
    for j in (0, 1, 2, 4, 5):
        assert torch.equal(got[j].cpu(), want[j]), j
    for x, y in zip(got[3], want[3]):
        assert torch.equal(x.cpu(), y)
    for key in want[6]:
        assert int(got[6][key]) == int(want[6][key]), key
    assert bool(want[3][1].any())   # the bitmap path ran


@pytest.mark.gpu
def test_mesh_broker_on_a_2x2_grid_of_one_card_delivers_like_one_device(
        cuda_device):
    """A mesh broker on a 2×2 grid of the card delivers what a
    one-device broker on the card delivers, message by message, with
    B1 and B2 launched once per cell and batch."""
    from emqx_tpu_torch.parallel.mesh import make_mesh

    rs = np.random.RandomState(23)
    filters = _filters(rs, 300)
    topics = _topics(rs, 200)

    class Rec:
        def __init__(self):
            self.got = []

        def deliver(self, flt, msg):
            self.got.append((flt, msg.topic))

    results = []
    for mesh in (None, make_mesh(2, 2, [cuda_device] * 4)):
        cfg = MatcherConfig(mesh=mesh, device_min_filters=1,
                            fanout_threshold=8, fanout_d=8)
        b = Broker(config=cfg, device=cuda_device)
        subs = [Rec() for _ in range(40)]
        for i, f in enumerate(filters):
            for s in subs[i % 7:i % 7 + 1 + (12 if i % 50 == 0 else 0)]:
                b.subscribe(s, f)
        _build.reset_launches()
        counts = b.publish_batch([Message(topic=t) for t in topics])
        torch.cuda.synchronize()
        if mesh is not None:
            assert _build.LAUNCHES["walk"] == 4
            assert _build.LAUNCHES["bitmap_or"] == 4
        results.append((counts, [sorted(s.got) for s in subs]))
    assert results[0] == results[1]
