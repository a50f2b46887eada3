"""The port's delta automaton and off-lock compaction against the JAX
package's ``Router``, on the CPU.

Each case runs one seeded filter and topic script through
``emqx_tpu.router.Router(MatcherConfig(use_native=False, ...))`` and
``emqx_tpu_torch.router.Router(use_native=False, device="cpu")`` (the
:class:`Pair` below, which the patch, match-cache and native-engine
suites share; ``Pair(native=True)`` puts both on the C++ engine) and
checks: the same filter ids; byte-equal ``match_dispatch`` ids and overflow flags;
equal cache counters, ``delta_info()``, epoch-bump totals and patcher
mirrors (main and side automaton); and results equal to the
``TrieOracle``. The cases are the single-chip ones of
``tests/test_delta.py``; the off-lock compaction's flatten is held on
a ``threading.Event`` on both routers, so their states stay equal
step for step.
"""

import random
import threading
import time

import numpy as np
import pytest
import torch

from emqx_tpu.router import MatcherConfig as JaxMatcherConfig
from emqx_tpu.router import Router as JaxRouter
from emqx_tpu_torch.oracle import TrieOracle
from emqx_tpu_torch.router import MatcherConfig, Router


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run torch single-threaded here and restore the setting after:
    these tests share worker processes and cores with timing-sensitive
    tests of the JAX package."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def same_mirror(a, b):
    """Two AutoPatcher mirrors (JAX package's, port's) hold the same
    tables, bounds and counters."""
    assert (a is None) == (b is None)
    if a is None:
        return
    np.testing.assert_array_equal(a.wt, b.wt)
    np.testing.assert_array_equal(a.node2, b.node2)
    np.testing.assert_array_equal(a.hops_for_level, b.hops_for_level)
    assert (a.n_states, a.n_edges, a.tombstones, a.splits,
            a.hop_fallbacks, a.hops_grown, a.broken) == \
        (b.n_states, b.n_edges, b.tombstones, b.splits,
         b.hop_fallbacks, b.hops_grown, b.broken)


class Pair:
    """The JAX package's Router and the port's, driven in lockstep,
    plus the TrieOracle of the same route set."""

    def __init__(self, native=False, **kw):
        kw.setdefault("device_min_filters", 0)
        kw["use_native"] = native  # both routers on the same engine
        self.ref = JaxRouter(JaxMatcherConfig(**kw), node="node1")
        self.port = Router(MatcherConfig(**kw), node="node1", device="cpu")
        self.oracle = TrieOracle()

    def add(self, f):
        fid = self.ref.add_route(f)
        assert self.port.add_route(f) == fid, f
        self.oracle.insert(f)
        return fid

    def delete(self, f):
        if self.port.has_route(f):
            self.oracle.delete(f)
        self.ref.delete_route(f)
        self.port.delete_route(f)

    def rebuild(self):
        self.ref.rebuild()
        self.port.rebuild()

    def dispatch(self, topics):
        """Both routers' ``match_dispatch``: byte-equal ids, overflow
        flags and snapshot. Returns the port's (ids, ovf)."""
        ji, jo, jm, je = self.ref.match_dispatch(topics)
        pi, po, pm, pe = self.port.match_dispatch(topics)
        np.testing.assert_array_equal(np.asarray(ji), pi.numpy())
        np.testing.assert_array_equal(np.asarray(jo), po.numpy())
        assert je == pe and list(jm) == list(pm)
        return pi, po

    def parity(self, topics, tag=""):
        """Byte-equal dispatch, both routers' ``match_filters`` equal
        to the TrieOracle, and equal router state."""
        self.dispatch(topics)
        want = [sorted(self.oracle.match(t)) for t in topics]
        for r in (self.ref, self.port):
            got = [sorted(row) for row in r.match_filters(topics)]
            assert got == want, (tag, type(r).__module__)
        self.same_state()

    def filters(self, topics):
        """Both routers' ``match_filters`` (equal); the port's."""
        got = self.port.match_filters(topics)
        assert [sorted(r) for r in self.ref.match_filters(topics)] == \
            [sorted(r) for r in got]
        return got

    def same_state(self):
        ref, port = self.ref, self.port
        assert ref._filter_ids == port._filter_ids
        assert ref._rebuilds == port._rebuilds
        ji, pi = ref.delta_info(), port.delta_info()
        ji.pop("rebuild_stall_ms")
        pi.pop("rebuild_stall_ms")
        assert ji == pi
        assert ref.cache_bump_totals() == port.cache_bump_totals()
        jc, pc = ref._match_cache_obj, port._match_cache_obj
        assert (jc is None) == (pc is None)
        if jc is not None:
            assert jc.stats() == pc.stats()
        same_mirror(ref._patcher, port._patcher)
        assert (ref._delta is None) == (port._delta is None)
        if ref._delta is not None:
            assert ref._delta.fids == port._delta.fids
            assert ref._delta.tombs == port._delta.tombs
            same_mirror(ref._delta._patcher, port._delta._patcher)

    def gate(self):
        """Hold both routers' background flatten until released:
        returns ``(started, release)`` — ``started`` waits until both
        flattens began (the trie is frozen), ``release()`` lets them
        finish and waits until both swapped."""
        events = []
        for r in (self.ref, self.port):
            orig = r._flatten_main
            started, go = threading.Event(), threading.Event()

            def gated(cap, nb, orig=orig, started=started, go=go):
                started.set()
                assert go.wait(30), "gate never released"
                return orig(cap, nb)

            r._flatten_main = gated
            events.append((started, go))

        def started(timeout=10):
            return all(s.wait(timeout) for s, _ in events)

        def release():
            for _, go in events:
                go.set()
            wait_idle(self.ref)
            wait_idle(self.port)

        return started, release


def wait_idle(router, timeout=30.0):
    """Wait until ``router``'s background compaction has finished."""
    deadline = time.monotonic() + timeout
    while router._compacting:
        assert time.monotonic() < deadline, "compaction never finished"
        time.sleep(0.005)


# -- two-probe parity -------------------------------------------------------


def test_delta_pending_adds_match_immediately():
    pr = Pair(match_cache=False)
    for i in range(40):
        pr.add(f"base/{i}/x")
    pr.parity(["base/0/x"])  # flatten → delta mode armed
    assert pr.port._patcher is None  # delta mode keeps no main mirror
    for f in ("fresh/topic", "fresh/+/deep", "wild/#"):
        pr.add(f)
    pr.parity(["fresh/topic", "fresh/a/deep", "wild/x/y", "base/3/x"])
    assert pr.filters(["fresh/a/deep"]) == [["fresh/+/deep"]]
    # the main automaton was never touched
    assert pr.port.stats()["rebuilds"] == 1
    assert pr.port.delta_info()["pending"] == 3


def test_delta_tombstone_masks_deleted_fid():
    pr = Pair(match_cache=False)
    for i in range(40):
        pr.add(f"t/{i}/x")
    pr.parity(["t/0/x"])
    pr.delete("t/3/x")       # main-table fid → tombstone
    pr.parity(["t/3/x", "t/4/x"])
    assert pr.filters(["t/3/x"]) == [[]]
    assert pr.port.delta_info()["tombstones"] == 1
    # re-add: the delta add wins over the tombstone
    pr.add("t/3/x")
    pr.parity(["t/3/x"])
    # delete of a PENDING add retracts it without a tombstone
    pr.add("gone/soon")
    pr.delete("gone/soon")
    pr.parity(["gone/soon", "t/3/x"])
    assert pr.port.delta_info()["tombstones"] == 1


@pytest.mark.parametrize("match_cache", [False, True])
def test_delta_randomized_churn_parity(match_cache):
    """Delta on and off against the JAX package under randomized
    interleaved add/delete/match churn: wildcards, '#'-terminals,
    $share-rooted verbatim filters, re-adds of tombstoned filters and
    topics past max_levels (overflow → host re-match)."""
    rng = random.Random(42)
    kw = dict(match_cache=match_cache, max_levels=6, active_k=4,
              delta_max_filters=10_000)  # no mid-test compaction
    on, off = Pair(delta=True, **kw), Pair(delta=False, **kw)
    live = {}
    words = ["a", "b", "w1", "w2", "x"]

    def roll_filter():
        if rng.random() < 0.1:
            return "$share/g1/%s/%s" % (rng.choice(words),
                                        rng.choice(words))
        depth = rng.randint(1, 5)
        ws = [rng.choice(words + ["+"]) for _ in range(depth)]
        if rng.random() < 0.2:
            ws[-1] = "#"
        return "/".join(ws)

    probe = (["a/b", "w1/w2/x", "a/a/a/a/a", "$share/g1/a/b",
              "b", "zz/unmatched", "a/b/x/w1/w2/a/b/x"]  # >6 levels
             + ["x/" + "/".join(rng.choice(words) for _ in range(3))
                for _ in range(4)])
    warm = set()
    while len(warm) < 60:
        warm.add(roll_filter())
    for f in sorted(warm):
        on.add(f)
        off.add(f)
        live[f] = True
    on.parity(probe[:2])
    off.parity(probe[:2])
    for step in range(150):
        if live and rng.random() < 0.45:
            f = rng.choice(list(live))
            on.delete(f)
            off.delete(f)
            del live[f]
        else:
            f = roll_filter()
            if f not in live:
                on.add(f)
                off.add(f)
                live[f] = True
        if step % 15 == 0:
            on.parity(probe, tag=f"on@{step}")
            off.parity(probe, tag=f"off@{step}")
    assert on.port.delta_info()["pending"] > 0
    assert off.port._patcher.tombstones > 0
    # fold the delta and re-check: the compacted tables must agree
    on.rebuild()
    on.parity(probe, tag="post-fold")


def test_delta_walk_stale_hop_bound_flags_overflow():
    """The side walk's step bound comes from the side patcher's
    hops_for_level; a walk run with a bound one short must flag the
    deep topic as overflow (exact host re-match), never truncate."""
    from emqx_tpu_torch.ops.delta import probe_packed
    from emqx_tpu_torch.ops.match import depth_bucket
    from emqx_tpu_torch.ops.tokenize import encode_batch

    pr = Pair(match_cache=False)
    for i in range(20):
        pr.add(f"s/{i}")
    pr.parity(["s/1"])
    pr.add("deep/a/b/c/d")
    pr.parity(["deep/a/b/c/d"])
    r = pr.port
    snap = r._snapshot_pair()[1]
    ids, n, sysm = encode_batch(r._table, ["deep/a/b/c/d"] * 8, 16)
    ids, n = depth_bucket(ids, n)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (ids, n, sysm)]
    lb = ids.shape[1]
    empty = torch.full((8, 4), -1, dtype=torch.int32)
    none = torch.zeros(8, dtype=torch.bool)
    good, ovf = probe_packed(snap, *args, empty, none, m=4)
    assert not bool(ovf[0]) and good[0, 0] == r.filter_id("deep/a/b/c/d")
    short = snap._replace(hops=np.minimum(snap.hops, snap.steps_for(lb) - 1))
    _, ovf = probe_packed(short, *args, empty, none, m=4)
    assert bool(ovf.all())


# -- off-lock compaction ----------------------------------------------------


def test_offlock_compaction_bounded_mutation_latency():
    """A route add/delete issued while a compaction flatten is in
    flight completes in milliseconds; matching during the flatten and
    after the swap is exact and byte-equal to the JAX package's."""
    pr = Pair(match_cache=False, delta_max_filters=32)
    for i in range(300):
        pr.add(f"seed/{i}/leaf")
    pr.parity(["seed/0/leaf"])
    started, release = pr.gate()
    # the 32nd pending add crosses delta_max_filters → compaction
    for i in range(32):
        pr.add(f"burst/{i}/x")
    assert started(), "compaction never started"
    lat = []
    for i in range(40):
        f = f"during/{i}/y"
        t0 = time.perf_counter()
        pr.port.add_route(f)
        lat.append(time.perf_counter() - t0)
        pr.ref.add_route(f)
        pr.oracle.insert(f)
        if i % 2 == 0:
            t0 = time.perf_counter()
            pr.port.delete_route(f)
            lat.append(time.perf_counter() - t0)
            pr.ref.delete_route(f)
            pr.oracle.delete(f)
    p99 = sorted(lat)[-1] * 1000.0
    assert p99 < 100.0, f"route op stalled {p99:.1f}ms on the flatten"
    assert pr.port._compacting and pr.port.delta_info()["rebuild_inflight"]
    probe = ["seed/5/leaf", "burst/3/x", "during/1/y", "during/2/y"]
    pr.parity(probe, tag="during")
    for t in ("during/3/y", "during/4/y", "burst/3/x"):
        assert sorted(pr.port.host_match(t)) == sorted(pr.oracle.match(t))
    release()
    info = pr.port.delta_info()
    assert info["merges"] == 1 and not info["rebuild_inflight"]
    pr.parity(probe + ["zz/none"], tag="post-swap")
    # the lock was held for ms, not for the flatten
    assert info["rebuild_stall_ms"] < 400


def test_offlock_compaction_delete_during_flatten():
    """Deletes landing mid-flatten tombstone against the NEW tables —
    the log split carries them across the swap. A deleted filter the
    frozen trie still holds keeps its freeze-time id for the flatten,
    so the port's compaction completes; the JAX package's
    Python-engine flatten raises ``KeyError`` on the same script (a
    reference caveat, ROADMAP.md queue C) and serves from its delta.
    Both stay exact."""
    pr = Pair(match_cache=False, delta_max_filters=8)
    for i in range(50):
        pr.add(f"s/{i}/x")
    pr.parity(["s/0/x"])
    started, release = pr.gate()
    for i in range(8):
        pr.add(f"b/{i}/y")   # the 8th triggers compaction (held)
    assert started()
    pr.delete("s/7/x")
    pr.delete("b/2/y")
    pr.add("mid/flight")
    pr.delete("s/9/x")       # deleted, then re-added mid-flatten
    pr.add("s/9/x")
    release()
    assert pr.port._compact_failures == 0
    assert pr.port.delta_info()["merges"] == 1
    assert pr.ref._compact_failures == 1  # the reference caveat
    topics = ["s/7/x", "b/2/y", "mid/flight", "b/3/y", "s/9/x", "s/8/x"]
    want = [sorted(pr.oracle.match(t)) for t in topics]
    assert [sorted(r) for r in pr.filters(topics)] == want
    assert want[:4] == [[], [], ["mid/flight"], ["b/3/y"]]
    # the log split: three tombstones against the new tables, two
    # pending adds
    d = pr.port._delta
    assert len(d.tombs) == 3 and set(d.fids) == {"mid/flight", "s/9/x"}
    # the next flatten folds the rest: the same tables and ids as the
    # JAX package's (its epoch is one behind: it never merged)
    pr.rebuild()
    (ji, jo, _, je), (pi, po, _, pe) = (pr.ref.match_dispatch(topics),
                                        pr.port.match_dispatch(topics))
    np.testing.assert_array_equal(np.asarray(ji), pi.numpy())
    np.testing.assert_array_equal(np.asarray(jo), po.numpy())
    assert pe == je + 1
    assert [sorted(r) for r in pr.filters(topics)] == want


# -- delta-off pin / runtime flip ------------------------------------------


def test_delta_off_restores_patch_in_place():
    """``delta=False``: mutations go through the AutoPatcher mirror
    and no delta structure ever materializes."""
    pr = Pair(delta=False, match_cache=False)
    for i in range(20):
        pr.add(f"a/{i}")
    pr.parity(["a/0"])
    assert pr.port._patcher is not None
    base = pr.port.stats()["patches"]
    pr.add("churn/x")
    pr.delete("a/3")
    assert pr.port.stats()["patches"] >= base + 2
    pr.parity(["churn/x", "a/3"])
    assert pr.port._delta is None
    assert pr.port.delta_info()["active"] is False


def test_set_delta_runtime_flip_is_equivalent():
    """Flipping delta at runtime folds pending state via one rebuild
    and gives identical match arrays on the same filter set."""
    pr = Pair(match_cache=False)
    for i in range(30):
        pr.add(f"f/{i}/x")
    pr.parity(["f/0/x"])
    pr.add("pending/delta")     # lives in the delta
    topics = ["f/3/x", "pending/delta", "nope"]
    pr.parity(topics)
    for r in (pr.ref, pr.port):
        r.set_delta(False)
    assert pr.port._patcher is not None    # mirror re-armed
    pr.parity(topics)
    pr.add("legacy/added")
    for r in (pr.ref, pr.port):
        r.set_delta(True)
    assert pr.port._patcher is None
    pr.parity(topics + ["legacy/added"])


# -- config / observability -------------------------------------------------


def test_delta_config_validation():
    for bad in (dict(delta_max_filters=0), dict(cache_partitions=12),
                dict(cache_partitions=0)):
        with pytest.raises(ValueError):
            Router(MatcherConfig(**bad), device="cpu")
        with pytest.raises(ValueError):
            JaxRouter(JaxMatcherConfig(use_native=False, **bad))


def test_delta_counters_drain_and_fold():
    from emqx_tpu.metrics import Metrics as JaxMetrics
    from emqx_tpu_torch.metrics import Metrics

    pr = Pair(match_cache=False, delta_max_filters=8)
    for i in range(40):
        pr.add(f"c/{i}/x")
    pr.parity(["c/0/x"])
    pr.add("d/new")
    pr.parity(["d/new"])
    started, release = pr.gate()
    for i in range(8):
        pr.add(f"e/{i}/y")  # crosses the bound → compaction
    assert started()
    release()
    assert pr.port.delta_info()["merges"] == 1
    drained = pr.port.drain_automaton_stats()
    ref = pr.ref.drain_automaton_stats()
    drained.pop("rebuild.stall_ms")
    ref.pop("rebuild.stall_ms")
    assert drained == ref
    assert drained["delta.filters"] >= 9 and drained["delta.merges"] == 1
    assert drained["delta.probes"] >= 1
    m, jm = Metrics(), JaxMetrics()
    m.fold_automaton_stats(drained)
    jm.fold_automaton_stats(drained)
    for k in drained:
        assert m.val(f"automaton.{k}") == jm.val(f"automaton.{k}") \
            == drained[k]
    # second drain is deltas-only
    assert pr.port.drain_automaton_stats()["delta.merges"] == 0
