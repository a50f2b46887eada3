"""The port's NFA walk (emqx_tpu_torch.ops.match) against the JAX
package's lax walk, byte for byte, and against the host trie oracle.

Inputs come from the seeded generators of tests/test_walk_pallas.py;
the automaton is built once by the JAX package's numpy builder and
handed to both packages (emqx_tpu_torch.ops.convert), so the walk is
the only thing compared. Tolerance is 0: every output is an integer.
The CUDA kernel's own comparison with the plain walk needs a card
(tests/test_torch_kernels.py; chip_smoke.py holds it at full size).
"""

import random

import numpy as np
import pytest
import torch

from emqx_tpu.ops.csr import build_automaton as jax_build_automaton
from emqx_tpu.ops.match import match_batch as jax_match_batch
from emqx_tpu.ops.match import walk_params
from emqx_tpu.ops.tokenize import WordTable as JaxWordTable
from emqx_tpu.ops.tokenize import encode_batch
from emqx_tpu.oracle import TrieOracle as JaxTrieOracle
from emqx_tpu_torch.ops import convert
from emqx_tpu_torch.ops.csr import build_automaton
from emqx_tpu_torch.ops.match import hash_mix, match_batch
from emqx_tpu_torch.ops.tokenize import WordTable
from emqx_tpu_torch.ops.walk_cuda import match_batch_auto, match_batch_cuda
from emqx_tpu_torch.oracle import TrieOracle
from test_walk_pallas import _build, _rand_filters, _rand_topics

DEEP = "/".join(["s1"] * 20)  # past max_levels = 16 → n_words = -1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run torch single-threaded here and restore the setting after:
    these tests share worker processes and cores with timing-sensitive
    tests of the JAX package."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, mode, n_filters=150, n_topics=32):
    rng = random.Random(seed)
    filters = _rand_filters(rng, n_filters)
    topics = _rand_topics(rng, n_topics) + [
        "$SYS/a", "$share/g/a/b", DEEP, "a", "s0/s1/s2"]
    trie, table, auto, inv = _build(filters, mode=mode)
    ids, n, sysm = encode_batch(table, topics, 16)
    return trie, auto, inv, topics, ids, n, sysm


def _both(auto, ids, n, sysm, **kw):
    ref = jax_match_batch(auto, ids, n, sysm, **kw)
    got = match_batch(convert.automaton(auto, "cpu"), torch.from_numpy(ids),
                      torch.from_numpy(n), torch.from_numpy(sysm), **kw)
    return ref, got


def _assert_same(ref, got):
    for name in ("ids", "count", "overflow"):
        a = np.asarray(getattr(ref, name))
        b = getattr(got, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("mode,pack_ids,k", [
    ("narrow", True, 16), ("narrow", False, 16),
    ("wide", True, 16), ("wide", False, 16),
    ("narrow", False, 64), ("wide", True, 64)])
def test_plain_walk_matches_lax_walk(mode, pack_ids, k):
    trie, auto, inv, topics, ids, n, sysm = _inputs(4100 + k, mode)
    assert (auto.wt_take > 1) == (mode == "wide")
    kw = dict(k=k, m=64, pack_ids=pack_ids,
              **walk_params(auto, ids.shape[1]))
    ref, got = _both(auto, ids, n, sysm, **kw)
    _assert_same(ref, got)
    # the deep topic is flagged for the host re-match, never truncated
    assert bool(got.overflow[topics.index(DEEP)])
    # set parity with the host trie on every row the walk finished
    for i, t in enumerate(topics):
        if got.overflow[i]:
            continue
        row = [inv[j] for j in got.ids[i].tolist() if j >= 0]
        assert sorted(row) == sorted(trie.match(t)), t


@pytest.mark.parametrize("mode", ["narrow", "wide"])
def test_plain_walk_tiny_k_overflow_and_sys(mode):
    filters = ["#", "+/#", "$SYS/#", "$SYS/+/x", "a/+/c", "a/b/c",
               "a/b/#", "+/+/+", "a/+/+", "+/b/+"]
    _trie, _table, auto, _inv = _build(filters, mode=mode)
    topics = ["a/b/c", "$SYS/broker", "$SYS/q/x", "a/x/c", "q", DEEP]
    ids, n, sysm = encode_batch(_table, topics, 16)
    for pack_ids in (True, False):
        kw = dict(k=2, m=8, pack_ids=pack_ids, **walk_params(auto, 16))
        ref, got = _both(auto, ids, n, sysm, **kw)
        _assert_same(ref, got)
        assert bool(got.overflow[0])  # a/b/c needs more than 2 lanes


def test_match_batch_auto_runs_plain_walk_on_cpu_tensors():
    _trie, auto, _inv, _topics, ids, n, sysm = _inputs(77, "narrow", 40, 8)
    kw = dict(k=16, m=64, pack_ids=False, **walk_params(auto, 16))
    ta = convert.automaton(auto, "cpu")
    args = (ta, torch.from_numpy(ids), torch.from_numpy(n),
            torch.from_numpy(sysm))
    a = match_batch_auto(*args, **kw)
    b = match_batch(*args, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # the kernel wrapper refuses CPU tensors instead of running anything
    with pytest.raises(ValueError):
        match_batch_cuda(*args, **kw)


def test_port_builder_is_byte_identical_to_the_jax_builder():
    rng = random.Random(31)
    filters = _rand_filters(rng, 200)
    jt, jw, pt, pw = JaxTrieOracle(), JaxWordTable(), TrieOracle(), WordTable()
    fids = {f: i for i, f in enumerate(filters)}
    for f in filters:
        jt.insert(f)
        pt.insert(f)
    want = jax_build_automaton(jt, fids, jw)
    got = build_automaton(pt, fids, pw)
    assert got.wt_take > 1  # deep spines ⇒ the wide layout
    for field in want._fields:
        a, b = getattr(want, field), getattr(got, field)
        if a is None or isinstance(a, (int, np.integer)):
            assert a == b, field
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                          err_msg=field)
            assert np.asarray(b).dtype == np.asarray(a).dtype, field


def test_hash_mix_matches_uint32_numpy():
    from emqx_tpu.ops.csr import hash_mix as np_hash_mix

    rs = np.random.RandomState(5)
    s = rs.randint(-1, 2**31 - 1, size=4096).astype(np.int32)
    w = rs.randint(-2, 2**31 - 1, size=4096).astype(np.int32)
    seed = np.uint32(0xA5A5A5A5 + 0x9E37 * 7)
    h1, h2 = np_hash_mix(s, w, seed)
    g1, g2 = hash_mix(torch.from_numpy(s).long(), torch.from_numpy(w).long(),
                      int(seed))
    np.testing.assert_array_equal(g1.numpy(), h1.astype(np.int64))
    np.testing.assert_array_equal(g2.numpy(), h2.astype(np.int64))
