"""The port's device mesh against the JAX package's, on the CPU.

The JAX side runs on its 8 virtual CPU devices (``tests/conftest.py``);
the port side on a :class:`~emqx_tpu_torch.parallel.mesh.Mesh` of
``["cpu"] * n`` — a grid that names one device more than once, so
every cell runs its own walk and every collective runs, as tensor ops.
One port counterpart for each test of ``tests/test_sharded.py``, plus
the host builders, the per-shard glue ops and the native sharded
engine. Match ids, subscriber ids, bitmap unions and counters are
compared exactly (tolerance 0: every output is an integer or a bit).
"""

import random

import jax
import numpy as np
import pytest
import torch

from emqx_tpu.oracle import TrieOracle as JaxTrieOracle
from emqx_tpu.ops.tokenize import WordTable as JaxWordTable
from emqx_tpu.ops.tokenize import encode_batch
from emqx_tpu.parallel import mesh as jmesh
from emqx_tpu.parallel import sharded as jsh
from emqx_tpu_torch.oracle import TrieOracle
from emqx_tpu_torch.ops.match import walk_params
from emqx_tpu_torch.ops.tokenize import WordTable
from emqx_tpu_torch.parallel import sharded as psh
from emqx_tpu_torch.parallel.mesh import default_mesh, make_mesh
from emqx_tpu_torch.router import MatcherConfig, Router

CPU8 = ["cpu"] * 8
GRIDS = [(4, 2), (2, 4), (8, 1), (1, 1)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run torch single-threaded here and restore the setting after:
    these tests share worker processes and cores with timing-sensitive
    tests of the JAX package."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_filters(rng, n):
    words = ["a", "b", "c", "d", "e", "s1", "s2"]
    out = set()
    while len(out) < n:
        depth = rng.randint(1, 5)
        ws = []
        for i in range(depth):
            r = rng.random()
            if r < 0.2:
                ws.append("+")
            elif r < 0.3 and i == depth - 1:
                ws.append("#")
            else:
                ws.append(rng.choice(words))
        out.add("/".join(ws))
    return sorted(out)


def _tables(filters):
    """The JAX and the port word tables over the same filters."""
    jt, pt = JaxWordTable(), WordTable()
    for f in filters:
        for w in f.split("/"):
            jt.intern(w)
            pt.intern(w)
    return jt, pt


def _same(jax_out, port_out, label):
    a = np.asarray(jax_out)
    b = port_out.cpu().numpy()
    if a.dtype == np.uint32:  # the port holds bitmap rows as int32 bits
        b = b.view(np.uint32)
    assert a.dtype == b.dtype and a.shape == b.shape, \
        (label, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=label)


def _same_step(jout, pout, label):
    for j, name in enumerate(("ids", "subs", "src")):
        _same(jout[j], pout[j], f"{label} {name}")
    _same(jout[4], pout[4], f"{label} overflow")
    _same(jout[5], pout[5], f"{label} match_overflow")
    if jout[3] is None:
        assert pout[3] is None
    else:
        for j, name in enumerate(("union", "has_big", "bovf")):
            _same(jout[3][j], pout[3][j], f"{label} {name}")
    assert set(jout[6]) == set(pout[6])
    for key in jout[6]:
        _same(jout[6][key], pout[6][key], f"{label} stats {key}")


def rows_lookup(rows, fid):
    for shard_rows in rows:
        if fid in shard_rows:
            return shard_rows[fid]
    return []


# -- host builders -----------------------------------------------------------


def test_shard_of_equals_jax_over_10000_seeded_filters():
    rng = random.Random(42)
    words = ["a", "b", "c", "dev", "s1", "+", "$SYS", "x" * 30, "ü"]
    filters = {"/".join(rng.choice(words) for _ in range(rng.randint(1, 8)))
               for _ in range(10_000)}
    filters = sorted(filters) + ["#", "a/#", "", "/"]
    for n in (1, 2, 3, 4, 8):
        assert [psh.shard_of(f, n) for f in filters] == \
            [jsh.shard_of(f, n) for f in filters], n
        assert psh.shard_filters(filters, n) == jsh.shard_filters(filters, n)


@pytest.mark.parametrize("n_trie", [1, 2, 4])
def test_host_builders_equal_jax(n_trie):
    """build_sharded (and its parts), build_sharded_fanout and
    build_sharded_bitmaps give the JAX package's arrays."""
    rng = random.Random(n_trie)
    filters = _rand_filters(rng, 150)
    fids = {f: i for i, f in enumerate(filters)}
    jt, pt = _tables(filters)
    shards = psh.shard_filters(filters, n_trie)
    ja, jparts = jsh.build_sharded(shards, fids, jt, return_parts=True)
    pa, pparts = psh.build_sharded(shards, fids, pt, return_parts=True)
    for name in ja._fields:
        np.testing.assert_array_equal(np.asarray(getattr(ja, name)),
                                      getattr(pa, name), err_msg=name)
    for jp, pp in zip(jparts, pparts):
        for name in ("wt", "wt_seed", "node2", "hops_for_level", "v2_hop",
                     "v2_depth", "wt_slots", "wt_take"):
            np.testing.assert_array_equal(np.asarray(getattr(jp, name)),
                                          np.asarray(getattr(pp, name)))
    rows = [{fids[f]: [fids[f] * 3, fids[f] * 3 + 1] for f in s}
            for s in shards]
    for a, b in zip(jsh.build_sharded_fanout(rows, len(filters),
                                             filter_capacity=512),
                    psh.build_sharded_fanout(rows, len(filters),
                                             filter_capacity=512)):
        np.testing.assert_array_equal(np.asarray(a), b)
    # row capacities are powers of two, as the fan-out manager keeps
    for a, b in zip(jsh.build_sharded_bitmaps(rows, len(filters), 700,
                                              row_capacity=256),
                    psh.build_sharded_bitmaps(rows, len(filters), 700,
                                              row_capacity=256)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_flatten_sharded_equals_build_sharded():
    """The native sharded engine's flatten gives build_sharded's arrays
    (the Python builder over the same shards and ids)."""
    from emqx_tpu_torch.ops.native import ShardedNativeEngine

    rng = random.Random(9)
    filters = _rand_filters(rng, 200) + [
        "/".join(f"w{i}" for i in range(12)),       # a deep literal chain
        "/".join(f"w{i}" for i in range(6)) + "/#"]
    for n_trie in (1, 2, 4):
        eng = ShardedNativeEngine(n_trie)
        fids = {}
        for f in filters:
            fids[f] = len(fids)
            eng.insert(f, fids[f])
        # the Python builder over the engine's own word ids
        table = WordTable()
        for w in eng.words():
            table.intern(w)
        na, nparts = eng.flatten_sharded()
        pa, pparts = psh.build_sharded(psh.shard_filters(filters, n_trie),
                                       fids, table, return_parts=True)
        for name in pa._fields:
            np.testing.assert_array_equal(getattr(na, name),
                                          getattr(pa, name), err_msg=name)
        assert len(nparts) == len(pparts) == n_trie
        oracle = TrieOracle()
        for g in filters:
            oracle.insert(g)
        for f in filters[:40]:
            topic = f.replace("+", "x").replace("#", "y")
            want = {fids[g] for g in oracle.match(topic)}
            assert set(eng.match(topic).tolist()) == want, topic


def test_finalize_parts_demotes_all_shards_on_wide_guard():
    """A shard whose trie trips compress_automaton's wide-mode guard
    (depth > 31) stays narrow even under force_mode="wide";
    finalize_parts then demotes EVERY shard to narrow instead of
    stacking mismatched row widths — as the JAX package does, array for
    array."""
    from emqx_tpu.ops.csr import build_automaton as jax_build
    from emqx_tpu_torch.ops.csr import build_automaton

    deep_ok = "/".join(f"w{i}" for i in range(10))
    too_deep = "/".join(f"v{i}" for i in range(33))
    jt, pt = _tables([deep_ok, too_deep])

    def raw(build, oracle_cls, table, filters):
        trie = oracle_cls()
        fids = {}
        for f in filters:
            trie.insert(f)
            fids[f] = [deep_ok, too_deep].index(f)
        return build(trie, fids, table, skip_hash=True)

    parts = psh.finalize_parts([raw(build_automaton, TrieOracle, pt, [f])
                                for f in (deep_ok, too_deep)])
    jparts = jsh.finalize_parts([raw(jax_build, JaxTrieOracle, jt, [f])
                                 for f in (deep_ok, too_deep)])
    assert len({p.wt_slots for p in parts}) == 1
    assert all(p.wt_take == 1 for p in parts)  # demoted to narrow
    for p, j in zip(parts, jparts):
        np.testing.assert_array_equal(p.wt, np.asarray(j.wt))
        np.testing.assert_array_equal(p.node2, np.asarray(j.node2))


# -- the glue ops ------------------------------------------------------------


def test_gather_pick_and_pack_fanout_equal_jax():
    from emqx_tpu.ops.fanout import build_fanout as jax_build_fanout
    from emqx_tpu.ops.fanout import gather_subscribers_src as jax_gather
    from emqx_tpu.ops.fanout import pick_shared as jax_pick
    from emqx_tpu.ops.pack import pack_fanout as jax_pack_fanout
    from emqx_tpu_torch.ops import convert
    from emqx_tpu_torch.ops.fanout import (build_fanout,
                                           gather_subscribers_src,
                                           pick_shared)
    from emqx_tpu_torch.ops.pack import pack_fanout

    rs = np.random.RandomState(4)
    rows = {int(f): [int(x) for x in rs.randint(0, 500,
                                                 size=rs.randint(0, 9))]
            for f in rs.choice(60, 40, replace=False)}
    jf = jax_build_fanout(rows, 60)
    pf = convert.fanout(build_fanout(rows, 60), "cpu")
    no_pairs = pf._replace(row_pairs=None)
    ids = rs.randint(-1, 70, size=(16, 12)).astype(np.int32)  # ≥ 60: drop
    seed = rs.randint(-50, 1000, size=16).astype(np.int32)
    T_ = torch.from_numpy
    for d in (4, 16, 64):
        want = jax_gather(jf, ids, d=d)
        for fan in (pf, no_pairs):
            got = gather_subscribers_src(fan, T_(ids), d=d)
            for a, b, name in zip(want, got, ("subs", "src", "n", "ovf")):
                _same(a, b, f"gather d={d} {name}")
        for pq in (8, 64, 1024):
            for a, b in zip(jax_pack_fanout(want[0], want[1], pq=pq),
                            pack_fanout(got[0], got[1], pq=pq)):
                _same(a, b, f"pack_fanout pq={pq}")
    _same(jax_pick(jf, ids, seed), pick_shared(pf, T_(ids), T_(seed)),
          "pick_shared")


def test_popcount_sum_counts_every_set_bit():
    """The union's set bits (the mesh's big-filter delivery counter):
    the SWAR count equals a bit-by-bit count, sign bit included."""
    rs = np.random.RandomState(0)
    x = rs.randint(-2**31, 2**31 - 1, size=(64, 333),
                   dtype=np.int64).astype(np.int32)
    x[0, :4] = [-1, -2**31, 2**31 - 1, 0]
    got = psh.popcount_sum(torch.from_numpy(x))
    assert got.dtype == torch.int32
    assert int(got) == int(np.unpackbits(x.view(np.uint8)).sum())
    assert int(psh.popcount_sum(torch.zeros(5, 7, dtype=torch.int32))) == 0


def test_match_cache_fovf_flags_equal_jax():
    """The mesh cache's three flags (_VALID, _OVF, _FOVF) and the
    (ovf, movf) they merge back into, against the JAX package's."""
    from emqx_tpu.ops.match_cache import _insert_jit, _merge_jit
    from emqx_tpu_torch.ops.match_cache import (_FOVF, MatchCache,
                                                insert_rows, merge_rows)

    rs = np.random.RandomState(7)
    table = rs.randint(-1, 9, size=(8, 5)).astype(np.int32)
    rows = rs.randint(-1, 9, size=(6, 4)).astype(np.int32)
    ovf = np.array([0, 1, 1, 0, 1, 0], bool)
    movf = np.array([0, 1, 0, 0, 0, 0], bool)   # rows 2 and 4: fan-only
    T_ = torch.from_numpy
    slots = [5, 0, 7, 2, 3, 1]
    want = _insert_jit(table, np.array(slots, np.int32), rows, ovf, movf)
    got = insert_rows(T_(table), slots, T_(rows), T_(ovf), T_(movf))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert got.numpy()[[7, 3], 0].tolist() == [_FOVF, _FOVF]  # rows 2, 4
    b_pad = 16
    hit_pos, hit_slots = [4, 1, 3], [7, 0, 3]
    miss_pos = [0, 9, 2]
    hp = np.full(8, b_pad, np.int32)
    hp[:3] = hit_pos
    hs = np.zeros(8, np.int32)
    hs[:3] = hit_slots
    mp = np.full(6, b_pad, np.int32)
    mp[:3] = miss_pos
    want = _merge_jit(np.asarray(want), hs, hp, rows, ovf, movf, mp,
                      b_pad=b_pad)
    got = merge_rows(got, hit_slots, hit_pos, T_(rows), T_(ovf), miss_pos,
                     b_pad, T_(movf))
    for a, b in zip(want, got):
        _same(a, b, "merge")
    # a cached fan-only overflow keeps movf False: boost_d, never k
    c = MatchCache(8, 4, "cpu")
    p = c.probe(["t", "u"], 1)
    c.insert(p, T_(rows[:2]), torch.tensor([True, True]),
             torch.tensor([False, True]))
    _ids, o, m = c.merge(4, c.probe(["t", "u"], 1))
    assert o[:2].tolist() == [True, True] and m[:2].tolist() == [False, True]


# -- the collective step -----------------------------------------------------


@pytest.mark.parametrize("n_data,n_trie", GRIDS)
def test_sharded_match_parity(n_data, n_trie):
    """publish_step's outputs equal the JAX function's global arrays
    byte for byte (dtypes included) and the oracle's matches; (1, 1)
    is the identity-collective fast path."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    rng = random.Random(0)
    filters = _rand_filters(rng, 120)
    fids = {f: i for i, f in enumerate(filters)}
    jt, pt = _tables(filters)
    oracle = TrieOracle()
    for f in filters:
        oracle.insert(f)
    shards = psh.shard_filters(filters, n_trie)
    ja, jparts = jsh.build_sharded(shards, fids, jt, return_parts=True)
    pa, parts = psh.build_sharded(shards, fids, pt, return_parts=True)
    rows = [{fids[f]: [fids[f] * 10, fids[f] * 10 + 1] for f in shard}
            for shard in shards]
    jfan = jsh.build_sharded_fanout(rows, len(filters))
    pfan = psh.build_sharded_fanout(rows, len(filters))
    words = ["a", "b", "c", "d", "e", "s1", "s2", "zz"]
    B = 8 * n_data
    topics = ["/".join(rng.choice(words) for _ in range(rng.randint(1, 5)))
              for _ in range(B)]
    ids_np, n_np, sys_np = encode_batch(jt, topics, 8)
    kw = dict(k=32, m=32, d=64, **walk_params(parts[0], 8))
    jm = jmesh.make_mesh(n_data, n_trie)
    jout = jsh.publish_step(jm, jsh.place_sharded(jm, ja),
                            jsh.place_sharded(jm, jfan),
                            *jsh.place_batch(jm, ids_np, n_np, sys_np), **kw)
    pm = make_mesh(n_data, n_trie, CPU8)
    out = psh.publish_step(pm, psh.place_sharded(pm, pa),
                           psh.place_sharded(pm, pfan),
                           *psh.place_batch(pm, ids_np, n_np, sys_np), **kw)
    _same_step(jout, out, f"grid {n_data}x{n_trie}")
    ids, subs, src, bm, ovf, movf, stats = out
    assert bm is None and not movf.any()
    inv = {v: k for k, v in fids.items()}
    total_m = total_d = 0
    for i, t in enumerate(topics):
        expect = sorted(oracle.match(t))
        assert sorted(inv[int(j)] for j in ids[i] if j >= 0) == expect, t
        exp_pairs = sorted((fids[f], x) for f in expect
                           for x in rows_lookup(rows, fids[f]))
        got_pairs = sorted((int(s), int(x)) for s, x in zip(src[i], subs[i])
                           if x >= 0)
        assert got_pairs == exp_pairs, t
        total_m += len(expect)
        total_d += len(exp_pairs)
    assert int(stats["matches"]) == total_m
    assert int(stats["deliveries"]) == total_d
    assert int(stats["overflows"]) == 0


@pytest.mark.parametrize("n_data,n_trie", GRIDS)
def test_sharded_bitmap_step_parity(n_data, n_trie):
    """With big-filter bitmaps (a small d and mb so both overflow
    somewhere), the unions, has_big, bovf, overflows and counters equal
    the JAX step's; on CPU tensors each cell ORs with B2's plain
    twin."""
    rng = random.Random(5)
    filters = _rand_filters(rng, 80)
    fids = {f: i for i, f in enumerate(filters)}
    jt, pt = _tables(filters)
    shards = psh.shard_filters(filters, n_trie)
    ja = jsh.build_sharded(shards, fids, jt)
    pa, parts = psh.build_sharded(shards, fids, pt, return_parts=True)
    rs = np.random.RandomState(3)
    small, big = [{} for _ in shards], [{} for _ in shards]
    for t, shard in enumerate(shards):
        for f in shard:
            n = int(rs.randint(1, 12))
            (big if n > 6 else small)[t][fids[f]] = sorted(
                int(x) for x in rs.choice(2000, n, replace=False))
    jfan = jsh.build_sharded_fanout(small, len(filters))
    pfan = psh.build_sharded_fanout(small, len(filters))
    jbm = jsh.build_sharded_bitmaps(big, len(filters), 2000)
    pbm = psh.build_sharded_bitmaps(big, len(filters), 2000)
    words = ["a", "b", "c", "d", "e", "s1", "s2", "zz"]
    topics = ["/".join(rng.choice(words) for _ in range(rng.randint(1, 5)))
              for _ in range(32 * n_data)]
    ids_np, n_np, sys_np = encode_batch(jt, topics, 8)
    kw = dict(k=32, m=32, d=4, mb=1, **walk_params(parts[0], 8))
    jm = jmesh.make_mesh(n_data, n_trie)
    jout = jsh.publish_step(jm, jsh.place_sharded(jm, ja),
                            jsh.place_sharded(jm, jfan),
                            *jsh.place_batch(jm, ids_np, n_np, sys_np),
                            jsh.place_sharded(jm, jbm), **kw)
    pm = make_mesh(n_data, n_trie, CPU8)
    out = psh.publish_step(pm, psh.place_sharded(pm, pa),
                           psh.place_sharded(pm, pfan),
                           *psh.place_batch(pm, ids_np, n_np, sys_np),
                           psh.place_sharded(pm, pbm), **kw)
    _same_step(jout, out, f"bitmap grid {n_data}x{n_trie}")
    assert out[3][0].any() and out[3][1].any()   # some big matches
    assert out[4].any() and out[3][2].any()      # d and mb overflow


def test_sharded_shared_pick_parity():
    """shared_pick_step picks seed % group size from each matched
    group's member row: the JAX step's arrays and the host's picks,
    over two shard layouts."""
    rng = random.Random(5)
    words = ["g1", "g2", "g3", "q"]
    filters = sorted({"/".join(rng.choice(words)
                               for _ in range(rng.randint(1, 3)))
                      for _ in range(30)})
    fids = {f: i for i, f in enumerate(filters)}
    jt, pt = _tables(filters)
    oracle = TrieOracle()
    for f in filters:
        oracle.insert(f)
    for n_data, n_trie in [(4, 2), (2, 4)]:
        shards = psh.shard_filters(filters, n_trie)
        ja = jsh.build_sharded(shards, fids, jt)
        pa, parts = psh.build_sharded(shards, fids, pt, return_parts=True)
        wp = walk_params(parts[0], 8)
        members = {f: [fids[f] * 100 + j for j in range(rng.randint(1, 5))]
                   for f in filters}
        rows = [{} for _ in range(n_trie)]
        for f in filters:
            rows[psh.shard_of(f, n_trie)][fids[f]] = members[f]
        B = 8 * n_data
        topics = ["/".join(rng.choice(words)
                           for _ in range(rng.randint(1, 3)))
                  for _ in range(B)]
        seeds = np.arange(B, dtype=np.int32) * 7 + 3
        ids_np, n_np, sys_np = encode_batch(jt, topics, 8)
        jm = jmesh.make_mesh(n_data, n_trie)
        spec = jax.sharding.NamedSharding(
            jm, jax.sharding.PartitionSpec("data"))
        jout = jsh.shared_pick_step(
            jm, jsh.place_sharded(jm, ja),
            jsh.place_sharded(jm, jsh.build_sharded_fanout(rows,
                                                           len(filters))),
            *jsh.place_batch(jm, ids_np, n_np, sys_np),
            jax.device_put(seeds, spec), k=16, m=16, **wp)
        pm = make_mesh(n_data, n_trie, CPU8)
        picks, mids, ovf = psh.shared_pick_step(
            pm, psh.place_sharded(pm, pa),
            psh.place_sharded(pm, psh.build_sharded_fanout(rows,
                                                           len(filters))),
            *psh.place_batch(pm, ids_np, n_np, sys_np), seeds, k=16, m=16,
            **wp)
        for a, b, name in zip(jout, (picks, mids, ovf),
                              ("picks", "ids", "ovf")):
            _same(a, b, f"shared pick {n_data}x{n_trie} {name}")
        assert not ovf.any()
        for i, t in enumerate(topics):
            got = sorted(int(p) for p in picks[i] if p >= 0)
            expect = sorted(members[f][seeds[i] % len(members[f])]
                            for f in oracle.match(t))
            assert got == expect, (t, got, expect)


# -- the router on a mesh ----------------------------------------------------


def _route_script(rng, n, words):
    filters = set()
    while len(filters) < n:
        depth = rng.randint(1, 4)
        ws = [rng.choice(words + ["+"]) for _ in range(depth)]
        if rng.random() < 0.2:
            ws[-1] = "#"
        filters.add("/".join(ws))
    return sorted(filters)


@pytest.mark.parametrize("use_native", [True, False])
def test_router_sharded_match_parity(use_native):
    """Router(mesh=...) matches through publish_step: equal to the JAX
    mesh router's and the oracle's match sets."""
    from emqx_tpu.router import MatcherConfig as JaxMatcherConfig
    from emqx_tpu.router import Router as JaxRouter

    rng = random.Random(3)
    words = ["a", "b", "c", "dd", "s"]
    filters = _route_script(rng, 60, words)
    jr = JaxRouter(JaxMatcherConfig(mesh=jmesh.default_mesh(8)), node="n1")
    r = Router(MatcherConfig(mesh=default_mesh(8, CPU8),
                             use_native=use_native), node="n1", device="cpu")
    oracle = TrieOracle()
    for f in filters:
        r.add_route(f)
        jr.add_route(f)
        oracle.insert(f)
    topics = ["/".join(rng.choice(words) for _ in range(rng.randint(1, 4)))
              for _ in range(40)]
    got, jgot = r.match_filters(topics), jr.match_filters(topics)
    for t, g, j in zip(topics, got, jgot):
        assert sorted(g) == sorted(j) == sorted(oracle.match(t)), t
    assert r.use_device_now()
    assert r.stats()["rebuilds"] == 1


def test_router_sharded_mutation_patches_not_rebuilds():
    """Mesh route churn is O(delta): a mutation patches its shard's
    tables (per-shard AutoPatcher) — no re-flatten."""
    r = Router(MatcherConfig(mesh=default_mesh(8, CPU8)), node="n1",
               device="cpu")
    r.add_route("a/+")
    assert r.match_filters(["a/x"]) == [["a/+"]]
    base = r.stats()["rebuilds"]
    patches = r.stats()["patches"]
    r.add_route("b/#")
    assert sorted(r.match_filters(["b/z/q"])[0]) == ["b/#"]
    assert r.stats()["rebuilds"] == base  # patched, not re-flattened
    assert r.stats()["patches"] > patches
    r.delete_route("a/+")
    assert r.match_filters(["a/x"])[0] == []
    assert r.stats()["rebuilds"] == base
    assert not r.delta_info()["active"]   # the delta is off on a mesh


def test_router_sharded_churn_parity_vs_oracle():
    """Sustained mesh churn (inserts + deletes across shards) keeps
    exact oracle parity through the per-shard patch path, and the
    patched tables equal the JAX mesh router's after the same script
    (the Python engine on both sides)."""
    from emqx_tpu.router import MatcherConfig as JaxMatcherConfig
    from emqx_tpu.router import Router as JaxRouter

    rng = random.Random(7)
    words = ["a", "b", "c", "d", "e"]
    r = Router(MatcherConfig(mesh=default_mesh(8, CPU8), use_native=False,
                             patch_drain_batch=4), node="n1", device="cpu")
    jr = JaxRouter(JaxMatcherConfig(mesh=jmesh.default_mesh(8),
                                    use_native=False, patch_drain_batch=4),
                   node="n1")
    oracle = TrieOracle()
    live = set()
    while len(live) < 40:
        f = "/".join(rng.choice(words + ["+"])
                     for _ in range(rng.randint(1, 4)))
        if f not in live:
            live.add(f)
            for x in (r, jr, oracle):
                (x.insert if x is oracle else x.add_route)(f)
    r.match_filters(["a/b"])  # initial flatten
    jr.match_filters(["a/b"])
    base = r.stats()["rebuilds"]
    for step in range(30):
        if rng.random() < 0.5 and live:
            f = rng.choice(sorted(live))
            live.discard(f)
            r.delete_route(f)
            jr.delete_route(f)
            oracle.delete(f)
        else:
            f = "/".join(rng.choice(words + ["+"])
                         for _ in range(rng.randint(1, 4)))
            if f not in live:
                live.add(f)
                r.add_route(f)
                jr.add_route(f)
                oracle.insert(f)
        if step % 5 == 4:
            topics = ["/".join(rng.choice(words)
                               for _ in range(rng.randint(1, 4)))
                      for _ in range(16)]
            for t, g in zip(topics, r.match_filters(topics)):
                assert sorted(g) == sorted(oracle.match(t)), (step, t)
    assert r.stats()["rebuilds"] == base  # zero re-flattens at churn
    auto, jauto = r.automaton()[0], jr.automaton()[0]
    for name in ("wt", "node2", "wt_seed"):
        a = np.asarray(getattr(jauto, name))
        b = getattr(auto, name).numpy()
        np.testing.assert_array_equal(a.view(np.int32), b, err_msg=name)


def test_mesh_use_device_false_is_honored():
    """MatcherConfig(mesh=..., use_device=False) stays on the host
    trie — the escape hatch wins over the mesh."""
    r = Router(MatcherConfig(mesh=default_mesh(8, CPU8), use_device=False),
               node="n1", device="cpu")
    r.add_route("esc/+")
    assert not r.use_device_now()
    assert r.match_filters(["esc/x"]) == [["esc/+"]]
    assert r.stats()["rebuilds"] == 0  # never flattened for a device


def test_mesh_needs_cuda_unless_given_devices():
    """A Mesh with no devices named takes every CUDA device and raises
    without CUDA; naming devices (the CPU here) builds it."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        default_mesh()
    with pytest.raises(ValueError, match="need 4 devices"):
        make_mesh(2, 2, ["cpu"] * 3)
    m = default_mesh(devices=["cpu"])
    assert m.shape == {"data": 1, "trie": 1} and m.home.type == "cpu"


def test_distributed_init_single_process_noop():
    from emqx_tpu_torch.parallel import distributed

    assert distributed.initialize() is False
    assert distributed.initialize(num_processes=1, process_id=0) is False
    with pytest.raises(ValueError):
        distributed.initialize(num_processes=2, process_id=0)


def test_distributed_global_mesh_factors():
    from emqx_tpu.parallel import distributed as jdist
    from emqx_tpu_torch.parallel import distributed

    m = distributed.global_mesh(local_devices=CPU8)
    assert m.shape["data"] * m.shape["trie"] == 8
    assert m.shape == dict(jdist.global_mesh().shape)
    m2 = distributed.global_mesh(n_trie=4, local_devices=CPU8)
    assert m2.shape == {"data": 2, "trie": 4}
    m3 = distributed.global_mesh(n_data=8, local_devices=CPU8)
    assert m3.shape == {"data": 8, "trie": 1}
    with pytest.raises(ValueError, match="does not cover"):
        distributed.global_mesh(n_data=3, n_trie=2, local_devices=CPU8)


# -- the broker on a mesh ----------------------------------------------------


class _Rec:
    def __init__(self, i=0):
        self.i = i
        self.got = []

    def deliver(self, topic, msg):
        self.got.append((topic, msg.topic, msg.payload))


def test_broker_on_mesh_end_to_end():
    """Broker.publish fans out through the collective step and the
    FanoutManager's per-shard tables; the second publish hits the mesh
    match cache; the counters the stats flush folds are the step's."""
    from emqx_tpu_torch.broker import Broker
    from emqx_tpu_torch.types import Message

    b = Broker(router=Router(MatcherConfig(mesh=default_mesh(8, CPU8)),
                             node="local", device="cpu"))
    subs = [_Rec() for _ in range(12)]
    for i, s in enumerate(subs):
        b.subscribe(s, f"room/{i}/+")
    everyone = _Rec()
    b.subscribe(everyone, "room/#")
    for _ in range(2):
        assert b.publish(Message(topic="room/3/temp", payload=b"hot")) == 2
    assert subs[3].got == [("room/3/+", "room/3/temp", b"hot")] * 2
    assert all(not s.got for j, s in enumerate(subs) if j != 3)
    assert everyone.got == [("room/#", "room/3/temp", b"hot")] * 2
    st = b.router.drain_device_stats()
    assert st == {"matches": 2, "deliveries": 2, "overflows": 0}  # one walk
    assert b.router.drain_cache_stats()["hit"] == 1


def _big_filter_script(broker_cls, msg_cls, router):
    rng = random.Random(11)
    b = broker_cls(router=router)
    subs = [_Rec(i) for i in range(40)]
    words = ["u", "v", "w"]
    filters = set()
    while len(filters) < 25:
        depth = rng.randint(1, 3)
        ws = [rng.choice(words + ["+"]) for _ in range(depth)]
        if rng.random() < 0.2:
            ws[-1] = "#"
        filters.add("/".join(ws))
    for f in sorted(filters):
        for s in rng.sample(subs, rng.randint(1, 4)):
            b.subscribe(s, f)
    # one BIG filter: 30 members > fanout_d=16 → the bitmap path
    for s in subs[:30]:
        b.subscribe(s, "big/#")
    topics = ["/".join(rng.choice(words) for _ in range(rng.randint(1, 3)))
              for _ in range(30)] + ["big/x", "big/y/z"]
    counts, got = [], []
    for t in topics:
        for s in subs:
            s.got.clear()
        counts.append(b.publish(msg_cls(topic=t, payload=b"p")))
        got.append([sorted(f for f, _t, _p in s.got) for s in subs])
    return b, subs, topics, filters | {"big/#"}, counts, got


def test_broker_on_mesh_fanout_parity_with_big_filter():
    """Every message's deliveries through the mesh broker — a filter
    past the d bound included (bitmap rows in its shard, one dense B2
    a cell) — equal the JAX mesh broker's and the oracle's."""
    from emqx_tpu.broker import Broker as JaxBroker
    from emqx_tpu.router import MatcherConfig as JaxMatcherConfig
    from emqx_tpu.router import Router as JaxRouter
    from emqx_tpu.types import Message as JaxMessage
    from emqx_tpu_torch.broker import Broker
    from emqx_tpu_torch.types import Message

    b, subs, topics, filters, counts, got = _big_filter_script(
        Broker, Message, Router(MatcherConfig(mesh=default_mesh(8, CPU8),
                                              fanout_d=16),
                                node="local", device="cpu"))
    _jb, _js, _jt, _jf, jcounts, jgot = _big_filter_script(
        JaxBroker, JaxMessage,
        JaxRouter(JaxMatcherConfig(mesh=jmesh.default_mesh(8), fanout_d=16),
                  node="local"))
    assert counts == jcounts and got == jgot
    oracle = TrieOracle()
    for f in filters:
        oracle.insert(f)
    for t, n, rows in zip(topics, counts, got):
        matched = oracle.match(t)
        exp = [sorted(f for f in matched if f in b.subscriptions(s))
               for s in subs]
        assert rows == exp and n == sum(map(len, exp)), t


def test_mesh_fan_overflow_boosts_d_not_k():
    """A fan-only overflow (per-topic deliveries past d, the match
    within k) grows the learned d — never k."""
    from emqx_tpu_torch.broker import Broker
    from emqx_tpu_torch.types import Message

    class S:
        def deliver(self, flt, msg):
            pass

    b = Broker(router=Router(MatcherConfig(mesh=make_mesh(8, 1, CPU8),
                                           fanout_d=2),
                             node="local", device="cpu"))
    for f in ("m/+", "m/#", "m/a"):
        b.subscribe(S(), f)
    k0 = b.router.effective_k()
    assert b.router.effective_d() == 2
    assert b.publish(Message(topic="m/a")) == 3   # host fallback
    assert b.router.effective_d() > 2
    assert b.router.effective_k() == k0            # k untouched
    assert b.publish(Message(topic="m/a")) == 3   # the grown d fits


def _pick_family(n_trie, mb, want_spread):
    """A topic family whose three matching filters (exact, +, #) spread
    over > 1 trie shard with ≤ mb a shard (want_spread=True), or
    collide in ONE shard with count > mb (False)."""
    for i in range(1000):
        fam = f"w{i}"
        filters = [f"{fam}/x", f"{fam}/+", f"{fam}/#"]
        shards = [psh.shard_of(f, n_trie) for f in filters]
        counts = [shards.count(t) for t in range(n_trie)]
        if want_spread:
            if max(counts) <= mb and len(set(shards)) > 1:
                return fam, filters
        elif max(counts) > mb:
            top = max(range(n_trie), key=counts.__getitem__)
            return fam, [f for f, s in zip(filters, shards) if s == top]
    raise AssertionError("no suitable family found")


def test_sharded_bitmap_multi_big_union_across_shards():
    """Big filters spread over both trie shards: the per-shard ORs
    combine into one union, and the multi-big tail delivers each
    (filter, member) pair exactly; the device counter counts unique
    union members once (not once per trie shard)."""
    from emqx_tpu_torch.broker import Broker
    from emqx_tpu_torch.types import Message

    fam, filters = _pick_family(2, mb=2, want_spread=True)
    b = Broker(router=Router(MatcherConfig(mesh=make_mesh(4, 2, CPU8),
                                           fanout_d=4, fanout_mb=2),
                             node="local", device="cpu"))
    subs = [_Rec(i) for i in range(30)]
    big_members = dict(zip(filters, [subs[:20], subs[5:25], subs[10:30]]))
    for f, ms in big_members.items():
        for s in ms:
            b.subscribe(s, f)
    assert b.publish(Message(topic=f"{fam}/x")) == 60
    for i, s in enumerate(subs):
        exp = sorted(f for f, ms in big_members.items() if s in ms)
        assert sorted(f for f, _t, _p in s.got) == exp, i
    assert b.metrics.val("messages.delivered") == 60
    st = b.router.drain_device_stats()
    assert st["overflows"] == 0 and st["deliveries"] == 30, st


def test_sharded_bitmap_mb_truncation_falls_back_exact():
    """More big matches than mb on ONE shard: bovf flags the row and
    the host loop delivers — exact despite the truncated union."""
    from emqx_tpu_torch.broker import Broker
    from emqx_tpu_torch.types import Message

    fam, colliding = _pick_family(2, mb=1, want_spread=False)
    assert len(colliding) >= 2
    b = Broker(router=Router(MatcherConfig(mesh=make_mesh(4, 2, CPU8),
                                           fanout_d=2, fanout_mb=1),
                             node="local", device="cpu"))
    subs = [_Rec() for _ in range(8)]
    for f in colliding:
        for s in subs:
            b.subscribe(s, f)  # 8 > d=2: all big, one shard, > mb=1
    assert b.publish(Message(topic=f"{fam}/x")) == 8 * len(colliding)
    for s in subs:
        assert sorted(f for f, _t, _p in s.got) == sorted(colliding)


def _fan_state(r, mesh, filters):
    from emqx_tpu_torch.broker_helper import ShardedFanoutState

    n_trie = mesh.shape["trie"]
    rows = [{} for _ in range(n_trie)]
    for f in filters:
        fid = r.filter_id(f)
        rows[psh.shard_of(f, n_trie)][fid] = [fid]
    fan = psh.place_sharded(mesh, psh.build_sharded_fanout(
        rows, len(r._id_to_filter)))
    return ShardedFanoutState(0, 0, fan, None, frozenset(), 8)


def test_placed_batch_parity_with_inline_encode():
    """encode_place_sharded + placed= gives the exact dispatch a plain
    publish_dispatch_sharded(topics, ...) call does."""
    rng = random.Random(7)
    mesh = default_mesh(4, CPU8)
    filters = [f"a/{i}/+" for i in range(100)] + ["a/#"]
    r = Router(MatcherConfig(mesh=mesh, fanout_d=8), device="cpu")
    for f in filters:
        r.add_route(f)
    topics = [f"a/{rng.randrange(100)}/x" for _ in range(32)]
    r.match_ids(topics)  # flatten
    st = _fan_state(r, mesh, filters)
    provider = lambda epoch, id_map: st  # noqa: E731
    plain = r.publish_dispatch_sharded(topics, provider)
    placed = r.publish_dispatch_sharded(
        topics, provider, placed=r.encode_place_sharded(topics))
    for i in (0, 1, 2, 4, 5):  # ids, subs, src, ovf, movf
        assert torch.equal(plain[i], placed[i]), i


def test_placed_batch_stale_after_route_add_reencodes():
    """A batch placed BEFORE a route add must not miss the new filter:
    the stale mutation revision re-encodes from the original topics."""
    mesh = default_mesh(4, CPU8)
    r = Router(MatcherConfig(mesh=mesh, fanout_d=8), device="cpu")
    r.add_route("a/+")
    topics = ["a/x", "brandnew/word"]
    r.match_ids(topics)  # flatten
    pl = r.encode_place_sharded(topics)
    r.add_route("brandnew/word")  # interns words the encoding never saw
    st = _fan_state(r, mesh, ("a/+", "brandnew/word"))
    out = r.publish_dispatch_sharded(topics, lambda e, m: st, placed=pl)
    id_map = out[6]
    matched = [sorted(id_map[i] for i in row.tolist()
                      if i >= 0 and id_map[i] is not None)
               for row in out[0][:2]]
    assert matched == [["a/+"], ["brandnew/word"]], matched
    with pytest.raises(ValueError, match="stale"):
        r.add_route("another/one")
        r.publish_dispatch_sharded(None, lambda e, m: st,
                                   placed=r.encode_place_sharded(topics)
                                   [:3] + (-1,))


def test_node_folds_the_mesh_device_counters():
    """The node's stats flush folds the mesh step's counters into
    ``device.*`` (the JAX node's ``_update_stats`` fold)."""
    from emqx_tpu_torch.node import Node
    from emqx_tpu_torch.types import Message

    node = Node(device="cpu",
                matcher=MatcherConfig(mesh=make_mesh(2, 2, CPU8),
                                      match_cache=False))
    node.broker.subscribe(_Rec(), "a/+")
    node.broker.subscribe(_Rec(), "a/#")
    node.broker.publish_batch([Message(topic="a/b"), Message(topic="a/c"),
                               Message(topic="z")])
    node.stats.tick()
    m = node.metrics
    assert (m.val("device.matches"), m.val("device.deliveries"),
            m.val("device.overflows")) == (4, 4, 0)
    assert node.router.drain_device_stats() == {
        "matches": 0, "deliveries": 0, "overflows": 0}
