"""The port's publish match cache (``ops/match_cache.py`` and the
router's cache path, partitioned epochs included) against the JAX
package's, on the CPU.

The unit cases hold ``MatchCache`` probe/insert/merge against the JAX
package's class on the same inputs; the router cases run one seeded
script through both routers (:class:`test_torch_delta.Pair`: equal
ids, byte-equal ``match_dispatch``, equal hit/miss/insert/stale counts
and epoch bumps, TrieOracle results). They are the single-chip cases
of ``tests/test_match_cache.py`` and ``tests/test_cache_partition.py``,
plus what the port's design adds: copy-on-write tables under
interleaved batches, scatters that never see a pad index, and the
revision read order.
"""

import random

import numpy as np
import pytest
import torch

from emqx_tpu.ops.match_cache import MatchCache as JaxMatchCache
from emqx_tpu.router import filter_partitions as jax_filter_partitions
from emqx_tpu.router import topic_partition as jax_topic_partition
from emqx_tpu_torch.broker import Broker
from emqx_tpu_torch.ops.match_cache import (MatchCache, insert_rows,
                                            merge_rows)
from emqx_tpu_torch.router import (MatcherConfig, filter_partitions,
                                   topic_partition)
from emqx_tpu_torch.types import Message
from test_torch_delta import Pair


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run torch single-threaded here and restore the setting after:
    these tests share worker processes and cores with timing-sensitive
    tests of the JAX package."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Q:
    def __init__(self, client_id="c"):
        self.client_id = client_id
        self.inbox = []

    def deliver(self, topic, msg):
        self.inbox.append((topic, msg))


def _caches(slots, width):
    return JaxMatchCache(slots, width), MatchCache(slots, width, "cpu")


def _same_probe(jp, pp):
    for f in ("hit_pos", "hit_slots", "miss_pos", "miss_topics",
              "miss_slots", "miss_keys"):
        assert getattr(jp, f) == getattr(pp, f), f


def _same_merge(jout, pout):
    for a, b in zip(jout, pout):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# -- MatchCache unit ------------------------------------------------------


def test_cache_unit_probe_insert_merge_roundtrip():
    jc, pc = _caches(16, 4)
    key = ("e", 1)
    topics = ["a", "b", "c"]
    jp, pp = jc.probe(topics, key), pc.probe(topics, key)
    _same_probe(jp, pp)
    assert pp.hit_pos == [] and pp.miss_topics == topics
    rows = np.array([[1, -1, -1, -1],
                     [2, 3, -1, -1],
                     [4, 5, 6, -1],
                     [9, 9, 9, 9]], np.int32)  # a pad row: never stored
    ovf = np.zeros(4, bool)
    jc.insert(jp, rows, ovf)
    pc.insert(pp, torch.from_numpy(rows), torch.from_numpy(ovf))
    np.testing.assert_array_equal(np.asarray(jc._table), pc._table.numpy())
    jp2, pp2 = (c.probe(["b", "a", "c", "d"], key) for c in (jc, pc))
    _same_probe(jp2, pp2)
    assert pp2.hit_pos == [0, 1, 2] and pp2.miss_topics == ["d"]
    miss = np.full((1, 4), -1, np.int32)
    jout = jc.merge(8, jp2, miss, np.zeros(1, bool))
    pout = pc.merge(8, pp2, torch.from_numpy(miss),
                    torch.zeros(1, dtype=torch.bool))
    _same_merge(jout, pout)
    merged = pout[0].numpy()
    assert merged[0].tolist() == [2, 3, -1, -1]
    assert merged[1].tolist() == [1, -1, -1, -1]
    assert merged[2].tolist() == [4, 5, 6, -1]
    # epoch bump: everything is a (stale-counted) miss again
    _same_probe(jc.probe(["a", "b"], ("e", 2)),
                pc.probe(["a", "b"], ("e", 2)))
    assert pc.stale == jc.stale == 2
    assert pc.stats() == jc.stats()
    assert pc.drain_stats() == jc.drain_stats()


def test_cache_unit_overflow_rows_store_invalid_markers():
    jc, pc = _caches(8, 4)
    jp, pp = jc.probe(["t"], 7), pc.probe(["t"], 7)
    jc.insert(jp, np.array([[9, 9, 9, 9]], np.int32), np.array([True]))
    pc.insert(pp, torch.tensor([[9, 9, 9, 9]], dtype=torch.int32),
              torch.tensor([True]))
    jp2, pp2 = jc.probe(["t"], 7), pc.probe(["t"], 7)
    assert pp2.hit_pos == [0]  # found — but flagged, never served
    jout, pout = jc.merge(4, jp2), pc.merge(4, pp2)
    _same_merge(jout, pout)
    assert bool(pout[1][0])               # caller must host-fallback
    assert (pout[0][0] == -1).all()       # no truncated ids


def test_cache_ops_never_scatter_a_pad_index():
    """Every pad case of the JAX package's drop-mode scatters: pad
    rows of a batch-padded miss walk, absent hits, a batch with no
    miss, a slot reused inside one batch and a packed union past m.
    torch raises on an out-of-range index (the JAX pads are
    ``slots`` and ``b_pad``), so each case passing here means no pad
    reached a scatter; each result equals the JAX function's."""
    from emqx_tpu.ops.delta import _union_packed
    from emqx_tpu.ops.match_cache import _insert_jit, _merge_jit
    from emqx_tpu_torch.ops.delta import union_packed

    rs = np.random.RandomState(3)
    table = rs.randint(-1, 9, size=(8, 5)).astype(np.int32)
    rows = rs.randint(-1, 9, size=(8, 4)).astype(np.int32)
    ovf = np.array([0, 1, 0, 0, 1, 0, 0, 0], bool)
    T_ = torch.from_numpy
    # insert: 3 live misses in a batch padded to 8 (pads → slot 8);
    # one device has no mesh, so the JAX movf flag equals ovf
    slots = [5, 0, 7]
    idx = np.full(8, 8, np.int32)
    idx[:3] = slots
    want = _insert_jit(table, idx, rows, ovf, ovf)
    got = insert_rows(T_(table), slots, T_(rows), T_(ovf))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    # insert: one slot handed to two topics of a batch (last wins)
    want = _insert_jit(table, np.array([3], np.int32), rows[1:2], ovf[1:2],
                       ovf[1:2])
    got = insert_rows(T_(table), [3, 3], T_(rows), T_(ovf))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    # merge: 2 hits padded to 8 (pads → position b_pad), 3 misses in
    # rows padded to 8, and the no-miss case
    b_pad = 16
    hit_pos, hit_slots = [4, 1], [6, 2]
    miss_pos = [0, 9, 2]
    hp = np.full(8, b_pad, np.int32)
    hp[:2] = hit_pos
    hs = np.zeros(8, np.int32)
    hs[:2] = hit_slots
    mp = np.full(8, b_pad, np.int32)
    mp[:3] = miss_pos
    want = _merge_jit(table, hs, hp, rows, ovf, ovf, mp, b_pad=b_pad)
    got = merge_rows(T_(table), hit_slots, hit_pos, T_(rows), T_(ovf),
                     miss_pos, b_pad)
    _same_merge(want, got)
    none = np.full(1, b_pad, np.int32)
    want = _merge_jit(table, hs, hp, rows[:1], ovf[:1], ovf[:1], none,
                      b_pad=b_pad)
    got = merge_rows(T_(table), hit_slots, hit_pos, None, None, (), b_pad)
    _same_merge(want, got)
    # union: rows past m (the JAX position m drops)
    a = rs.randint(-1, 50, size=(6, 5)).astype(np.int32)
    b = rs.randint(-1, 50, size=(6, 7)).astype(np.int32)
    for m in (3, 8, 12):
        _same_merge(_union_packed(a, b, m=m),
                    union_packed(torch.from_numpy(a), torch.from_numpy(b),
                                 m=m))


def test_cache_tables_are_copy_on_write_across_interleaved_batches():
    """Batch A probes a hit on slot s; batch C's clock sweep then
    hands s to a new topic and inserts into it before A's merge. A
    must still gather its own row: the insert writes a clone, and A's
    probe holds the table it probed."""
    c = MatchCache(4, 2, "cpu")
    p = c.probe(["a", "b", "c", "d"], 1)
    c.insert(p, torch.tensor([[10, -1], [11, -1], [12, -1], [13, -1]],
                             dtype=torch.int32),
             torch.zeros(4, dtype=torch.bool))
    pa = c.probe(["a"], 1)                  # batch A: a hit on slot 0
    assert pa.hit_slots == [0]
    pc_ = c.probe(["x", "y"], 1)            # batch C: sweeps slots 0, 1
    assert pc_.miss_slots == [0, 1]
    c.insert(pc_, torch.tensor([[20, 21], [22, -1]], dtype=torch.int32),
             torch.zeros(2, dtype=torch.bool))
    ids, ovf, _ = c.merge(8, pa)
    assert ids[0].tolist() == [10, -1] and not bool(ovf[0])
    assert pa.table is not c._table
    # a later probe of "a" misses (its slot went to "x")
    assert c.probe(["a", "x"], 1).hit_pos == [1]


# -- single-device router path --------------------------------------------


def test_router_cached_parity_and_hit_counters():
    pr = Pair(match_cache_slots=256)
    for f in ["s/+/a", "s/1/a", "s/#", "x/y", "+/y"]:
        pr.add(f)
    topics = ["s/1/a", "s/2/a", "x/y", "nope", "s/1/a", "x/y"]
    pr.parity(topics)
    c = pr.port._match_cache_obj
    assert c is not None and c.inserts > 0
    before = c.hits
    pr.parity(topics)  # identical batch: pure hits
    assert c.hits > before
    assert c.stats()["hit_rate"] > 0


def test_epoch_invalidation_on_add_and_delete():
    pr = Pair(match_cache_slots=64)
    pr.add("a/b")
    pr.parity(["a/b", "a/c"])
    pr.add("a/+")     # must appear in the next match (no stale hit)
    pr.parity(["a/b", "a/c"])
    pr.delete("a/b")  # must disappear (no ghost delivery)
    pr.parity(["a/b", "a/c"])
    assert pr.port._match_cache_obj.stale > 0


@pytest.mark.parametrize("delta", [True, False])
def test_churn_interleaved_with_cached_matches_stays_exact(delta):
    """Interleave add/delete with cached matches: exact and equal to
    the JAX package after EVERY epoch bump, on the delta path and on
    patch in place."""
    rng = random.Random(7)
    pr = Pair(match_cache_slots=512, delta=delta)
    words = ["a", "b", "c", "d"]
    live = []
    for f in ["a/#", "b/+", "a/b/c"]:
        pr.add(f)
        live.append(f)
    topics = ["/".join(rng.choice(words)
                       for _ in range(rng.randint(1, 4)))
              for _ in range(24)]
    for step in range(30):
        if live and rng.random() < 0.4:
            pr.delete(live.pop(rng.randrange(len(live))))
        else:
            depth = rng.randint(1, 4)
            ws = [rng.choice(words + ["+"]) for _ in range(depth)]
            if rng.random() < 0.2:
                ws.append("#")
            f = "/".join(ws)
            if f not in live:
                pr.add(f)
                live.append(f)
        pr.parity([rng.choice(topics) for _ in range(12)], tag=step)
    st = pr.port._match_cache_obj.stats()
    assert st["hit"] > 0 and st["stale"] > 0


def test_overflow_topics_fall_back_exact_through_cache():
    # max_matches=2 forces m-overflow for a topic matching 3 filters
    pr = Pair(match_cache_slots=64, max_matches=2, active_k=2)
    for f in ["t/#", "t/+", "t/x", "other"]:
        pr.add(f)
    for _ in range(3):  # miss, then negative-cached hits
        pr.parity(["t/x", "t/x", "other"])
    assert pr.port._match_cache_obj.hits > 0


def test_cache_off_restores_uncached_dispatch_bytes():
    """``match_cache=False`` runs the uncached dispatch byte for byte:
    raw (pack_ids=False) walk output, no cache object ever built."""
    from emqx_tpu_torch.ops.match import match_batch

    pr = Pair(match_cache=False)
    for f in ["s/+/a", "s/1/a", "s/#", "x/y"]:
        pr.add(f)
    topics = ["s/1/a", "x/y", "s/1/a", "zz"]
    ids_dev, ovf_dev = pr.dispatch(topics)
    assert pr.port._match_cache_obj is None
    r = pr.port
    args, kw = r.walk_inputs(topics)
    res = match_batch(r.automaton()[0], *args, **kw)
    assert torch.equal(ids_dev, res.ids)
    assert torch.equal(ovf_dev, res.overflow)


def test_broker_publish_batch_hits_cache_across_batches():
    from emqx_tpu.broker import Broker as JaxBroker
    from emqx_tpu.router import MatcherConfig as JaxMatcherConfig
    from emqx_tpu.types import Message as JaxMessage

    kw = dict(device_min_filters=0, match_cache_slots=128)
    port = Broker(config=MatcherConfig(**kw), device="cpu")
    ref = JaxBroker(config=JaxMatcherConfig(use_native=False, **kw))
    counts = []
    for b, mcls in ((port, Message), (ref, JaxMessage)):
        s1, s2 = Q("c1"), Q("c2")
        b.subscribe(s1, "a/+")
        b.subscribe(s2, "a/b")
        msgs = [mcls(topic=t) for t in ["a/b", "a/c", "a/b"]]
        out = [b.publish_batch(msgs)]
        c = b.router._match_cache_obj
        hits_before = c.hits
        out.append(b.publish_batch(msgs))  # all repeat topics
        assert c.hits > hits_before
        assert len(s1.inbox) == 6 and len(s2.inbox) == 4
        # churn between batches: parity must survive the epoch bump
        b.subscribe(Q("c3"), "a/#")
        out.append(b.publish_batch(msgs))
        counts.append((out, c.stats()))
    assert counts[0] == counts[1]
    assert counts[0][0] == [[2, 1, 2], [2, 1, 2], [3, 2, 3]]


def test_drain_cache_stats_feeds_metrics():
    from emqx_tpu.metrics import Metrics as JaxMetrics
    from emqx_tpu_torch.metrics import Metrics

    pr = Pair(match_cache_slots=64, cache_partitions=16)
    pr.add("m/1")
    pr.add("+/w")       # a global bump
    pr.filters(["m/1", "m/1"])
    pr.filters(["m/1"])
    drained = pr.port.drain_cache_stats()
    assert drained == pr.ref.drain_cache_stats()
    assert drained["miss"] >= 1 and drained["hit"] >= 1
    assert drained["bump.partition"] >= 1 and drained["bump.global"] >= 1
    m, jm = Metrics(), JaxMetrics()
    m.fold_cache_stats(drained)
    jm.fold_cache_stats(drained)
    for k in drained:
        assert m.val(f"cache.match.{k}") == jm.val(f"cache.match.{k}") \
            == drained[k]
    # second drain: deltas only
    again = pr.port.drain_cache_stats()
    assert again == pr.ref.drain_cache_stats()
    assert again["hit"] == 0 and again["bump.global"] == 0
    assert pr.port.cache_entries() == pr.ref.cache_entries() >= 1
    assert pr.port.cache_partitions_live() == 16
    # cache off: no bump keys leak into the fold
    off = Pair(match_cache=False)
    off.add("a/b")
    assert "bump.global" not in off.port.drain_cache_stats()
    assert off.port.cache_partitions_live() == 0


# -- partitioned epochs -----------------------------------------------------


def test_filter_partitions_mapping():
    P = 64
    cases = ["a/+/c", "a/#", "a/b", "/x", "+/x", "#", "+",
             "$share/g/a/b", "$queue/a/b", "$share/g/+/b",
             "$share/nofilter", "w0_1/w1_2", "$share/g/deep/x"]
    for f in cases:
        assert filter_partitions(f, P) == jax_filter_partitions(f, P), f
    for t in ("a/x/c", "/y/z", "$share/anything", "a/zz"):
        assert topic_partition(t, P) == jax_topic_partition(t, P)
    assert filter_partitions("a/+/c", P) == (topic_partition("a/x/c", P),)
    assert filter_partitions("+/x", P) is None
    assert filter_partitions("#", P) is None
    ps = filter_partitions("$share/g/a/b", P)
    assert topic_partition("a/zz", P) in ps
    assert topic_partition("$share/anything", P) in ps
    assert filter_partitions("$share/g/+/b", P) is None


def test_disjoint_literal_churn_keeps_entries_valid():
    pr = Pair(match_cache_slots=256, cache_partitions=64)
    for f in ["a/+", "a/b", "b/#"]:
        pr.add(f)
    topics = ["a/b", "a/c", "b/x"]
    pr.parity(topics)  # fill
    c = pr.port._match_cache_obj
    hits0, stale0 = c.hits, c.stale
    # literal-rooted churn in a DISJOINT partition: cached entries for
    # a/* and b/* stay valid (pure hits, no stale)
    for i in range(8):
        pr.add(f"churn{i}/x/leaf")
        pr.parity(topics)
        pr.delete(f"churn{i}/x/leaf")
    assert c.hits - hits0 == 2 * 8 * len(topics)  # dispatch + filters
    assert c.stale == stale0
    assert pr.port.cache_bump_totals()["partition"] >= 16
    # ...and a literal mutation in a HOT partition invalidates only it
    pr.add("a/new")
    pr.parity(topics)  # a/* stale-missed, b/* hit
    assert c.stale > stale0


def test_root_wildcard_mutations_bump_globally():
    pr = Pair(match_cache_slots=128, cache_partitions=16)
    pr.add("a/b")
    pr.parity(["a/b", "z/z"])
    g0 = pr.port.cache_bump_totals()["global"]
    for f in ("+/b", "#"):
        pr.add(f)
        pr.parity(["a/b", "z/z"])
        pr.delete(f)
        pr.parity(["a/b", "z/z"])
    assert pr.port.cache_bump_totals()["global"] - g0 == 4
    assert pr.port._match_cache_obj.stale > 0


def test_share_filter_bumps_post_prefix_partition():
    pr = Pair(match_cache_slots=128, cache_partitions=64)
    for f in ("a/+", "b/x"):
        pr.add(f)
    pr.parity(["a/1", "b/x"])
    c = pr.port._match_cache_obj
    stale0, hits0 = c.stale, c.hits
    pr.add("$share/g/a/leaf")
    pr.parity(["a/1", "b/x"])
    assert c.stale > stale0  # 'a' partition re-walked
    assert c.hits > hits0    # 'b' partition still served
    pr.parity(["$share/g/a/leaf", "a/1"])
    pr.delete("$share/g/a/leaf")
    pr.parity(["$share/g/a/leaf", "a/1", "b/x"])


def test_partitions_one_is_whole_epoch():
    """``cache_partitions = 1``: every mutation bumps the global
    revision, keys carry no partition component, every cached entry
    goes stale on any filter-set change — and the match rows equal
    the partitioned router's."""
    pr = Pair(match_cache_slots=64, cache_partitions=1)
    rev0 = pr.port._cache_rev
    pr.add("a/b")
    assert pr.port._cache_rev == rev0 + 1
    assert pr.port._part_revs == [0]
    pr.parity(["a/b", "zz/q"])
    keys = [k for k in pr.port._match_cache_obj._slot_key if k is not None]
    assert keys and all(len(k) == 3 for k in keys)
    stale0 = pr.port._match_cache_obj.stale
    pr.add("disjoint/leaf")
    pr.parity(["a/b", "zz/q"])
    assert pr.port._match_cache_obj.stale > stale0
    assert pr.port.cache_bump_totals()["partition"] == 0
    p64 = Pair(match_cache_slots=64, cache_partitions=64)
    for f in ("a/b", "disjoint/leaf"):
        p64.add(f)
    topics = ["a/b", "zz/q", "disjoint/leaf"]
    ids1, ovf1 = pr.dispatch(topics)
    ids64, ovf64 = p64.dispatch(topics)
    assert torch.equal(ids1, ids64) and torch.equal(ovf1, ovf64)


def _random_filter(rng, words):
    kind = rng.random()
    depth = rng.randint(1, 4)
    ws = [rng.choice(words) for _ in range(depth)]
    if kind < 0.15:
        ws[0] = "+"
    elif kind < 0.25:
        return "#"
    elif kind < 0.45 and depth > 1:
        ws[rng.randrange(1, depth)] = "+"
    elif kind < 0.55:
        return "$share/grp/" + "/".join(ws)
    if rng.random() < 0.2:
        ws = ws[:max(1, depth - 1)] + ["#"]
    return "/".join(ws)


@pytest.mark.parametrize("delta", [True, False])
def test_randomized_churn_parity_single_chip(delta):
    """Interleaved add/delete/match with literal, root-wildcard,
    $share and overflow-marker topics: exact and equal to the JAX
    package after EVERY mutation, partition and global bumps both
    exercised."""
    rng = random.Random(11)
    pr = Pair(match_cache_slots=512, cache_partitions=16,
              max_matches=4, active_k=4, delta=delta)
    words = ["a", "b", "c", "d"]
    live = []
    topics = ["/".join(rng.choice(words)
                       for _ in range(rng.randint(1, 4)))
              for _ in range(20)] + ["$share/grp/a/b", "$sys-ish/x"]
    for step in range(40):
        if live and rng.random() < 0.45:
            pr.delete(live.pop(rng.randrange(len(live))))
        else:
            f = _random_filter(rng, words)
            if f not in live:
                pr.add(f)
                live.append(f)
        pr.parity([rng.choice(topics) for _ in range(10)], tag=step)
    st = pr.port._match_cache_obj.stats()
    bumps = pr.port.cache_bump_totals()
    assert st["hit"] > 0 and st["stale"] > 0
    assert bumps["global"] > 0 and bumps["partition"] > 0


def test_overflow_markers_respect_partition_epochs():
    pr = Pair(match_cache_slots=64, cache_partitions=64,
              max_matches=2, active_k=2)
    for f in ["t/#", "t/+", "t/x", "other/y"]:
        pr.add(f)
    for _ in range(2):
        pr.parity(["t/x", "other/y"])
    c = pr.port._match_cache_obj
    hits0 = c.hits
    pr.add("disjoint/leaf")  # other partition: the marker stays
    pr.parity(["t/x", "other/y"])
    assert c.hits > hits0
    pr.add("t/y")  # t partition: the marker re-keys, still exact
    pr.parity(["t/x", "t/y", "other/y"])


# -- read order -------------------------------------------------------------


def test_cached_dispatch_reads_revisions_before_the_snapshot(monkeypatch):
    """A mutation landing between the revision read and the snapshot
    can only make the batch's entries look stale: ``k_boost`` and the
    partition revisions are read BEFORE the snapshot. Here a route
    add runs inside the snapshot read; the rows inserted under the
    old revisions must miss on the next probe, and the next dispatch
    sees the new filter."""
    from emqx_tpu_torch.router import Router

    r = Router(MatcherConfig(device_min_filters=0, match_cache_slots=64),
               device="cpu")
    r.add_route("a/b")
    r.match_filters(["a/x"])  # first flatten, delta armed
    orig = Router._snapshot_pair
    fired = []

    def racing(self):
        if not fired:
            fired.append(1)
            self.add_route("a/+")  # lands after the revision read
        return orig(self)

    monkeypatch.setattr(Router, "_snapshot_pair", racing)
    r.match_dispatch(["a/x"])
    c = r._match_cache_obj
    stale0, hits0 = c.stale, c.hits
    assert r.match_filters(["a/x"]) == [["a/+"]]
    assert c.stale == stale0 + 1 and c.hits == hits0


def test_publish_pair_restamps_the_cache_revision():
    """In delta mode a mutation never dirties the main tables; the
    published pair must carry the CURRENT global revision, or a root
    wildcard's globally bumped entries would probe as fresh."""
    pr = Pair(match_cache_slots=64)
    pr.add("a/b")
    pr.parity(["a/b", "z/q"])
    rev = pr.port._published[3]
    pr.add("#")              # a global bump, delta path
    pr.parity(["a/b", "z/q"])
    assert pr.port._published[3] == pr.port._cache_rev == rev + 1
    assert pr.port._pub2[0] is pr.port._published
