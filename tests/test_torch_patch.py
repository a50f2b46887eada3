"""The port's incremental patcher (``ops/patch.py`` and the router's
patch-in-place path) against the JAX package's, on the CPU.

Each case builds the same automaton with the JAX package's builder
and the port's, runs the same inserts and deletes through both
``AutoPatcher``\\ s, and checks equal mirrors (``wt``, ``node2``,
``hops_for_level``, counters), byte-equal tables after
``apply_updates`` (the port's torch scatter against the JAX
``_apply_jit``), and match results equal to a fresh flatten or the
TrieOracle. They are the cases of ``tests/test_patch.py``; the router
cases run through :class:`test_torch_delta.Pair`.
"""

import random
import time

import numpy as np
import pytest
import torch

from emqx_tpu.oracle import TrieOracle as JaxTrieOracle
from emqx_tpu.ops import csr as jcsr
from emqx_tpu.ops.match import walk_params as jax_walk_params
from emqx_tpu.ops.patch import AutoPatcher as JaxAutoPatcher
from emqx_tpu.ops.patch import PatchOverflow as JaxPatchOverflow
from emqx_tpu.ops.tokenize import WordTable as JaxWordTable
from emqx_tpu_torch.ops import convert, csr
from emqx_tpu_torch.ops.match import match_batch, walk_params
from emqx_tpu_torch.ops.patch import AutoPatcher, PatchOverflow
from emqx_tpu_torch.ops.tokenize import WordTable, encode_batch
from emqx_tpu_torch.oracle import TrieOracle
from test_torch_delta import Pair, same_mirror

WORDS = ["a", "b", "c", "dd", "ee", "sensor", "x"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run torch single-threaded here and restore the setting after:
    these tests share worker processes and cores with timing-sensitive
    tests of the JAX package."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_filter(rng):
    depth = rng.randint(1, 5)
    ws = []
    for i in range(depth):
        p = rng.random()
        if p < 0.2:
            ws.append("+")
        elif p < 0.3 and i == depth - 1:
            ws.append("#")
        else:
            ws.append(rng.choice(WORDS))
    return "/".join(ws)


class Twin:
    """One filter set built by both packages' builders, with a
    patcher on each: ``auto``/``dev`` are the port's host automaton and
    its CPU tensors, ``jauto`` the JAX package's."""

    def __init__(self, filters, caps=(None, None), mode=None):
        self.table, self.jtable = WordTable(), JaxWordTable()
        self.fids = {}
        trie, jtrie = TrieOracle(), JaxTrieOracle()
        for f in filters:
            trie.insert(f)
            jtrie.insert(f)
            self.fids[f] = len(self.fids)
            for w in f.split("/"):
                if w not in ("+", "#"):
                    self.table.intern(w)
                    self.jtable.intern(w)
        if mode is None:
            self.auto = csr.build_automaton(
                trie, self.fids, self.table,
                state_capacity=caps[0], edge_capacity=caps[1])
            self.jauto = jcsr.build_automaton(
                jtrie, self.fids, self.jtable,
                state_capacity=caps[0], edge_capacity=caps[1])
        else:  # forced layout at a padded capacity
            outs = []
            for mod, tr, tb in ((csr, trie, self.table),
                                (jcsr, jtrie, self.jtable)):
                raw = mod.build_automaton(tr, self.fids, tb, skip_hash=True,
                                          state_capacity=caps[0],
                                          edge_capacity=caps[1])
                a, edges = mod.compress_automaton(
                    raw, force_mode=mode, state_capacity=caps[0])
                outs.append(mod.attach_walk_tables(a, edges,
                                                   edge_capacity=caps[1]))
            self.auto, self.jauto = outs
        self.dev = convert.automaton(self.auto, "cpu")
        self.jdev = jcsr.device_view(self.jauto)
        self.p = AutoPatcher(self.auto, self.table.intern)
        self.jp = JaxAutoPatcher(self.jauto, self.jtable.intern)

    def insert(self, f, fid):
        self.jp.insert(f, fid)
        self.p.insert(f, fid)

    def delete(self, f):
        got = self.p.delete(f)
        assert self.jp.delete(f) == got
        return got

    def apply(self):
        """Both drains; the port's tables equal the JAX package's."""
        assert self.p.queued == self.jp.queued
        self.jdev = self.jp.apply_updates(self.jdev)
        self.dev = self.p.apply_updates(self.dev)
        same_mirror(self.jp, self.p)
        np.testing.assert_array_equal(np.asarray(self.jdev.wt),
                                      self.dev.wt.numpy())
        np.testing.assert_array_equal(np.asarray(self.jdev.node2),
                                      self.dev.node2.numpy())
        return self.dev


def _match_set(auto, table, fids_rev, topic):
    ids, n, sysm = encode_batch(table, [topic] * 8, 8)
    args = [torch.from_numpy(a) for a in (ids, n, sysm)]
    res = match_batch(auto, *args, k=32, m=64,
                      steps=int(auto.hops_for_level[
                          min(8, len(auto.hops_for_level) - 1)]),
                      slots=auto.wt_slots, take=auto.wt_take)
    assert not bool(res.overflow[0])
    return {fids_rev[j] for j in res.ids[0].tolist() if j >= 0}


def test_patched_matches_equal_fresh_flatten():
    rng = random.Random(7)
    base = sorted({_rand_filter(rng) for _ in range(40)})
    # padded capacity so ~25 patches fit without overflow
    tw = Twin(base, caps=(512, 512))
    live = dict(tw.fids)
    extra = sorted({_rand_filter(rng) for _ in range(60)}
                   - set(base))[:25]
    for f in extra:
        fid = len(live)
        live[f] = fid
        tw.insert(f, fid)
    for f in rng.sample(base, 8):
        assert tw.delete(f)
        del live[f]
    patched = tw.apply()
    # a fresh flatten of the same live set is the ground truth
    fresh = Twin(sorted(live))
    rev_p = {v: k for k, v in live.items()}
    rev_f = {v: k for k, v in fresh.fids.items()}
    for _ in range(200):
        topic = "/".join(rng.choice(WORDS)
                         for _ in range(rng.randint(1, 5)))
        got = _match_set(patched, tw.table, rev_p, topic)
        want = _match_set(fresh.dev, fresh.table, rev_f, topic)
        assert got == want, (topic, got, want)


def test_patch_is_incremental_and_double_buffered():
    tw = Twin(["a/b"], caps=(64, 64))
    before = tw.dev
    tw.insert("a/c", 1)
    assert tw.p.dirty
    out = tw.apply()
    assert not tw.p.dirty
    # the original tensors are untouched (double buffering)
    assert out.wt is not before.wt and out.node2 is not before.node2
    rev = {0: "a/b", 1: "a/c"}
    assert _match_set(out, tw.table, rev, "a/c") == {"a/c"}
    assert _match_set(before, tw.table, rev, "a/c") == set()
    # a drain with column updates only shares the untouched wt
    tw.delete("a/c")
    out2 = tw.apply()
    assert out2.wt is out.wt and out2.node2 is not out.node2


def test_overflow_marks_broken_and_blocks_apply():
    tw = Twin(["a"])  # min capacity (16)
    deep = "/".join(f"w{i}" for i in range(20))
    with pytest.raises(JaxPatchOverflow):
        tw.jp.insert(deep, 1)
    with pytest.raises(PatchOverflow) as e:
        tw.p.insert(deep, 1)
    assert e.value.kind == "state" and tw.p.broken and tw.jp.broken
    with pytest.raises(PatchOverflow):
        tw.p.insert("b", 2)
    with pytest.raises(PatchOverflow):
        tw.p.delete("a")
    with pytest.raises(AssertionError):
        tw.p.apply_updates(tw.dev)  # a partial queue never applies


def test_delete_missing_filter_returns_false():
    tw = Twin(["x/y", "x/+"], caps=(64, 64))
    assert not tw.delete("x/z")
    assert not tw.delete("x/y/z")
    assert not tw.delete("q/#")
    assert not tw.p.dirty
    assert tw.delete("x/+")
    assert tw.p.tombstones == 1
    tw.apply()


def test_delete_then_reinsert_same_filter_single_drain():
    """Both writes target the same node2 cell in one drain: the drain
    dedups by index (last wins), since repeated indices in one
    scatter apply in no fixed order on the card."""
    tw = Twin(["a/b", "c"], caps=(64, 64))
    assert tw.delete("a/b")
    tw.insert("a/b", tw.fids["a/b"])
    assert len(tw.p._col) == 2
    out = tw.apply()
    rev = {v: k for k, v in tw.fids.items()}
    assert _match_set(out, tw.table, rev, "a/b") == {"a/b"}
    assert _match_set(out, tw.table, rev, "c") == {"c"}


def _deep_filter(rng, vocab):
    d = rng.randint(1, 12)
    ws = [rng.choice(vocab) for _ in range(d)]
    if rng.random() < 0.25:
        ws = ws[: rng.randint(1, d)] + ["#"]
    return "/".join(ws)


def test_wide_mode_split_churn_parity():
    """Wide-layout patching: inserts that diverge mid-chain SPLIT
    compressed edges, deletes tombstone; the patched tables equal the
    JAX package's and hold exact oracle parity, and the hop bound
    grows so deepened walks still emit."""
    rng = random.Random(3)
    vocab = [f"v{i}" for i in range(9)]
    base = sorted({_deep_filter(rng, vocab) for _ in range(200)})
    tw = Twin(base, caps=(1 << 13, 1 << 13), mode="wide")
    assert tw.auto.wt_take > 1
    trie = TrieOracle()
    for f in base:
        trie.insert(f)
    fids = dict(tw.fids)
    for f in sorted({_deep_filter(rng, vocab) for _ in range(250)}
                    - set(base)):
        trie.insert(f)
        fids[f] = len(fids)
        tw.insert(f, fids[f])
    for f in rng.sample(base, 60):
        trie.delete(f)
        assert tw.delete(f), f
    assert tw.p.splits > 0  # the churn exercised splits
    dev = tw.apply()
    topics = ["/".join(rng.choice(vocab)
                       for _ in range(rng.randint(1, 12)))
              for _ in range(400)]
    ids, n, sysm = encode_batch(tw.table, topics, 16)
    wp = walk_params(tw.auto, ids.shape[1])
    # the patcher's grown bound, as the Router reads it
    wp["steps"] = int(tw.p.hops_for_level[
        min(ids.shape[1], len(tw.p.hops_for_level) - 1)])
    res = match_batch(dev, *(torch.from_numpy(a) for a in (ids, n, sysm)),
                      k=8, **wp)
    rev = {v: k for k, v in fids.items()}
    for i, t in enumerate(topics):
        assert not bool(res.overflow[i]), t
        got = sorted(rev[j] for j in res.ids[i].tolist() if j >= 0)
        assert got == sorted(trie.match(t)), t


def test_wide_mode_stale_steps_flags_overflow():
    """A walk run with the PRE-patch hop bound must flag the deepened
    topics as overflow (exact host re-match) rather than silently
    miss their matches."""
    tw = Twin(["root/" + "/".join(["c"] * 9)], caps=(1 << 10, 1 << 10),
              mode="wide")
    stale = walk_params(tw.auto, 16)  # bound BEFORE the deepening patch
    assert stale == jax_walk_params(tw.jauto, 16)
    fids = dict(tw.fids)
    for newf in ["root/c/c/x1/y/z", "root/c/c/c/c/x2/y/z",
                 "root/c/c/c/c/c/c/x3/y/z"]:
        fids[newf] = len(fids)
        tw.insert(newf, fids[newf])
    assert tw.p.hops_grown
    dev = tw.apply()
    topic = "root/c/c/c/c/x2/y/z"
    ids, n, sysm = encode_batch(tw.table, [topic] * 4, 16)
    args = [torch.from_numpy(a) for a in (ids, n, sysm)]
    res_stale = match_batch(dev, *args, k=4, **stale)
    fresh = dict(stale)
    fresh["steps"] = int(tw.p.hops_for_level[
        min(ids.shape[1], len(tw.p.hops_for_level) - 1)])
    res_fresh = match_batch(dev, *args, k=4, **fresh)
    rev = {v: k for k, v in fids.items()}
    assert sorted(rev[j] for j in res_fresh.ids[0].tolist() if j >= 0) \
        == [topic]
    assert bool(res_stale.overflow[0])


def test_hop_fallbacks_trigger_compaction_signal():
    """Host fallbacks observed while the hop bound is stale count
    toward needs_compaction alongside splits and tombstones."""
    tw = Twin(["a/b"], caps=(64, 64))
    for p in (tw.jp, tw.p):
        p.note_hop_fallbacks(5000)
        assert not p.needs_compaction(10)  # hops never grew
    tw.insert("a/b/c/d/e", 1)  # deepens the walk -> hops_grown
    for p in (tw.jp, tw.p):
        assert p.hops_grown
        p.note_hop_fallbacks(500)
        assert not p.needs_compaction(10)
        p.note_hop_fallbacks(600)  # 1100 > max(1024, live)
        assert p.needs_compaction(10)
    same_mirror(tw.jp, tw.p)


def test_router_note_match_fallbacks_schedules_rebuild():
    pr = Pair(delta=False, match_cache=False)
    pr.add("a/b")
    pr.parity(["a/b"])  # first flatten + live patcher
    r = pr.port
    rebuilds = r.stats()["rebuilds"]
    r._patcher.hops_grown = True  # force the stale-hop regime
    r.note_match_fallbacks(2000)
    deadline = time.monotonic() + 10
    while r.stats()["rebuilds"] == rebuilds:
        assert time.monotonic() < deadline, "no background rebuild"
        time.sleep(0.01)
    while r._compacting:
        time.sleep(0.005)
    assert r._patcher.hop_fallbacks == 0  # the fresh patcher is clean
    assert r.match_filters(["a/b"]) == [["a/b"]]


@pytest.mark.parametrize("drain_batch", [1, 4, 256])
def test_router_patch_in_place_drains_like_the_jax_router(drain_batch):
    """``delta=False`` with ``patch_drain_batch`` set: the mutator
    drains once the queue reaches the batch, the published tables
    equal the JAX package's after every step, and a new filter never
    re-flattens."""
    rng = random.Random(drain_batch)
    pr = Pair(delta=False, match_cache=False,
              patch_drain_batch=drain_batch)
    for i in range(60):
        pr.add(f"base/{i % 7}/{i}")
    pr.parity(["base/0/0"])
    rebuilds = pr.port.stats()["rebuilds"]
    live = []
    for step in range(40):
        f = "/".join(rng.choice(["base", "x", "+", "y"])
                     for _ in range(rng.randint(1, 4)))
        if f in live:
            pr.delete(f)
            live.remove(f)
        else:
            pr.add(f)
            live.append(f)
        assert pr.port._patcher.queued < drain_batch
        if step % 8 == 0:
            pr.parity(["base/0/0", "x/y", "y/base/x", "base/3/10"])
    assert pr.port.stats()["rebuilds"] == rebuilds
    auto = pr.port.automaton()[0]
    jauto = pr.ref.automaton()[0]
    np.testing.assert_array_equal(np.asarray(jauto.wt), auto.wt.numpy())
    np.testing.assert_array_equal(np.asarray(jauto.node2),
                                  auto.node2.numpy())
