"""The generators: deterministic per seed, in the configured shapes."""

from collections import Counter

import numpy as np
import pytest

from benchmark import workload
from benchmark.tests import _tiny

BIG_SEED = 2**33 + 17


def test_deployment_same_seed_same_subscriptions():
    a = workload.Deployment(_tiny.mixed_cfg(), BIG_SEED)
    b = workload.Deployment(_tiny.mixed_cfg(), BIG_SEED)
    c = workload.Deployment(_tiny.mixed_cfg(), BIG_SEED + 1)
    assert list(a.subscriptions()) == list(b.subscriptions())
    assert (a.draw_rows == b.draw_rows).all()
    assert list(a.subscriptions()) != list(c.subscriptions())


def test_topic_stream_same_seed_same_topics():
    dep = workload.Deployment(_tiny.hash_cfg(), 5)
    for law in ("zipf", "uniform"):
        tr = _tiny.traffic(law)
        s1 = workload.TopicStream(dep, tr, BIG_SEED)
        s2 = workload.TopicStream(dep, tr, BIG_SEED)
        # chunks are drawn apart from each other: the order they are
        # made in, alone or in bulk, changes nothing
        s2.chunk(3)
        s1.prefill(2 * workload.CHUNK)
        assert [s1.topic(i) for i in range(0, 5 * workload.CHUNK, 7)] == \
            [s2.topic(i) for i in range(0, 5 * workload.CHUNK, 7)]
        s3 = workload.TopicStream(dep, tr, BIG_SEED + 1)
        assert s3.chunk(0) != s1.chunk(0)


def test_late_chunks_are_counted():
    dep = workload.Deployment(_tiny.plus_cfg(), 5)
    st = workload.TopicStream(dep, _tiny.traffic("zipf"), 5)
    st.prefill(workload.CHUNK + 1)
    st.topic(2 * workload.CHUNK - 1)
    assert st.late_chunks == 0
    st.topic(2 * workload.CHUNK)
    assert st.late_chunks == 1


def test_plus_deployment_is_its_source_shape():
    dep = workload.Deployment(_tiny.plus_cfg(), 3)
    plus = dep.classes["plus"]
    assert len(plus) == len(set(plus)) == 3000
    assert all(f.count("+") == 1 and len(f.split("/")) == 5 for f in plus)
    assert list(dep.classes) == ["plus"]
    assert dep.subs == plus and dep.sids.tolist() == list(range(3000))
    assert dep.n_subscribers == 3000


def test_mixed_deployment_shape():
    dep = workload.Deployment(_tiny.mixed_cfg(), 3)
    hsh = dep.classes["hash"]
    assert {len(f.split("/")) - 1 for f in hsh} == {1, 2, 3, 4}
    assert all(f.endswith("/#") for f in hsh)
    # wide filters: members drawn from the '+' subscribers, distinct
    plus_sids = set(dep.members["plus"][:, 0].tolist())
    for sids in dep.members["wide"].tolist():
        assert len(set(sids)) == 1100 and set(sids) <= plus_sids
    shared = [s for s in dep.subs if s.startswith("$share/g/")]
    assert len(shared) == 50 * 4
    assert dep.tokens.strings(dep.draw_rows[100:102]) == dep.classes["wide"]
    assert dep.n_subscribers == 3000 + 200 + 200 + 200
    assert len(dep.sids) == len(dep.subs) == 3000 + 400 + 200 + 2 * 1100


def test_hash_deployment_shape():
    dep = workload.Deployment(_tiny.hash_cfg(), 9)
    depth = Counter(len(f.split("/")) - 1 for f in dep.classes["hash"])
    assert min(depth) >= 1 and max(depth) <= 16
    assert all(f.endswith("/#") for f in dep.classes["hash"])


def test_topics_fill_their_filters():
    dep = workload.Deployment(_tiny.hash_cfg(), 9)
    st = workload.TopicStream(dep, _tiny.traffic("uniform"), 4)
    for t in st.chunk(0):
        ws = t.split("/")
        assert 1 <= len(ws) <= 16
        assert all(w.startswith(f"w{lv}_") for lv, w in enumerate(ws))


def _fill_by_hand(flt, fill, extra, levels):
    """One topic from one filter, word by word."""
    out = []
    for lv, w in enumerate(flt.split("/")):
        if w == "+":
            out.append(workload.word(lv, fill[lv]))
        elif w == "#":
            e = int(extra * (levels - lv + 1))
            out += [workload.word(lv + j, fill[lv + j]) for j in range(e)]
        else:
            out.append(w)
    return "/".join(out)


@pytest.mark.parametrize("cfg", [_tiny.mixed_cfg, _tiny.hash_cfg])
def test_bulk_fill_equals_the_fill_by_hand(cfg):
    dep = workload.Deployment(cfg(), 21)
    tok = dep.tokens
    rng = np.random.default_rng(8)
    m = 2000
    rows = dep.draw_rows[rng.integers(0, len(dep.draw_rows), size=m)]
    fill = rng.integers(0, dep.vocab, size=(m, dep.levels))
    extra = rng.random(m)
    got = tok.strings(workload.fill_rows(rows, fill, extra, tok))
    flts = tok.strings(rows)
    want = [_fill_by_hand(f, fill[k].tolist(), extra[k], dep.levels)
            for k, f in enumerate(flts)]
    assert got == want


def test_strings_join_tokens_by_slash():
    tok = workload.Tokens(3, 4, ["big0"])
    P = workload.PAD
    rows = np.array([[0, 4 + 1, tok.PLUS, P], [2, tok.HASH, P, P],
                     [tok.EXTRA, P, P, P], [3, 7, 11, tok.HASH]])
    assert tok.strings(rows, block=3) == [
        "w0_0/w1_1/+", "w0_2/#", "big0", "w0_3/w1_3/w2_3/#"]


def test_first_rows_keeps_each_rows_first_occurrence():
    rng = np.random.default_rng(1)
    for width, hi in ((6, 5), (17, 30)):
        r = rng.integers(-1, hi, size=(5000, width)).astype(np.int16)
        r[::3] = r[5]
        _, first = np.unique(r, axis=0, return_index=True)
        assert workload.first_rows(r).tolist() == np.sort(first).tolist()


def test_zipf_ranks_favour_the_head():
    dep = workload.Deployment(_tiny.plus_cfg(), 3)
    st = workload.TopicStream(dep, _tiny.traffic("zipf"), 4)
    rng = np.random.default_rng(0)
    idx = st.draw_indices(rng, 100000)
    head = (idx < 10).mean()
    tail = (idx >= len(dep.draw_rows) - 10).mean()
    assert head > 0.1 and tail < 0.001
