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
from emqx_tpu_torch.ops.bitmap import or_bitmaps_cuda, or_bitmaps_ref
from emqx_tpu_torch.ops.csr import (attach_walk_tables, build_automaton,
                                    compress_automaton)
from emqx_tpu_torch.ops.match import match_batch, walk_params
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
    rs = np.random.RandomState(12)
    auto, table = _automaton(_filters(rs, 400), mode)
    ids, n, sysm = encode_batch(table, _topics(rs, 300), 16)
    ta = convert.automaton(auto, cuda_device)
    args = [torch.from_numpy(a).to(cuda_device) for a in (ids, n, sysm)]
    for k in (2, 16, 17, 64):
        for pack_ids in (True, False):
            kw = dict(k=k, m=64, pack_ids=pack_ids,
                      **walk_params(auto, ids.shape[1]))
            want = match_batch(ta, *args, **kw)
            got = match_batch_cuda(ta, *args, **kw)
            torch.cuda.synchronize()
            for x, y in zip(got, want):
                assert torch.equal(x, y), (k, pack_ids)


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
