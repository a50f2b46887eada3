"""The dense bitmap OR (kernel B4's function) on the CPU: the port's
plain version and B4's entry point against the JAX package's
``or_bitmaps_xla`` and its Pallas ``or_bitmaps`` in interpret mode, and
the launch grid and block algorithm of ``csrc/bitmap_or_dense.cu``
replayed in numpy. Inputs are made from a numpy seed; every output is
a bit, so equality is exact.
The kernel itself runs on the card (tests/test_torch_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emqx_tpu.ops import bitmap as jbm
from emqx_tpu_torch.ops import _build
from emqx_tpu_torch.ops import bitmap as tbm
from emqx_tpu_torch.parallel.sharded import _or_bitmaps_auto

#: (R, B, mb, W, dead every n-th topic or 0): each an edge of kernel B4
CASES = {
    "b_not_a_multiple_of_t": (8, 300, 16, 2048, 0),
    "more_distinct_rows_than_staged": (80, 130, 16, 1024, 0),
    "one_topic_one_slot": (3, 1, 1, 1024, 0),
    "ragged_last_strip": (8, 64, 4, 1028, 0),
    "every_fifth_topic_dead": (16, 200, 8, 3072, 5),
}


def _case(R, B, mb, W, dead, seed):
    rs = np.random.RandomState(seed)
    bm = rs.randint(0, 2**32, size=(R, W), dtype=np.uint64).astype(np.uint32)
    rows = rs.randint(-1, R, size=(B, mb)).astype(np.int32)
    if dead:
        rows[::dead] = -1
    return bm, rows


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_or_and_b4_entry_equal_jax_xla(name):
    R, B, mb, W, dead = CASES[name]
    bm, rows = _case(R, B, mb, W, dead, seed=len(name))
    want = np.asarray(jbm.or_bitmaps_xla(jnp.asarray(bm), jnp.asarray(rows)))
    got = tbm.or_bitmaps_ref(_t(bm), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    if dead:
        assert not want[::dead].any()
    assert torch.equal(_or_bitmaps_auto(_t(bm), torch.from_numpy(rows)), got)
    _build.reset_launches()
    if W % 1024:
        with pytest.raises(ValueError):
            tbm.or_bitmaps(_t(bm), torch.from_numpy(rows))
    else:
        assert torch.equal(tbm.or_bitmaps(_t(bm), torch.from_numpy(rows)),
                           got)
    assert _build.LAUNCHES["bitmap_or_dense"] == 0
    assert _build.LAUNCHES["or_bitmaps"] == 0


def test_b4_entry_equals_the_pallas_kernel_in_interpret_mode():
    bm, rows = _case(8, 12, 4, 1024, 5, seed=7)
    want = np.asarray(jbm.or_bitmaps(jnp.asarray(bm), jnp.asarray(rows),
                                     interpret=True))
    got = tbm.or_bitmaps(_t(bm), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert not want[0].any() and want[1:5].any()


#: csrc/bitmap_or_dense.cu's constants: 16-byte groups a strip, topics
#: a chunk, staged rows a chunk, rows on a topic's spill list, and the
#: launch limit on the grid's y extent
THREADS, TOPICS, STAGE, SPILL_CAP, MAX_GRID_Y = 256, 8, 8, 16, 65535


def _blocks(B, W4):
    """The launcher's grid, launch by launch: chunk ``c0 + y`` of every
    launch of at most 65,535 chunks, each over every strip. Yields
    ``(strip, first topic, topics)``."""
    chunks, strips = -(-B // TOPICS), -(-W4 // THREADS)
    for c0 in range(0, chunks, MAX_GRID_Y):
        for y in range(min(MAX_GRID_Y, chunks - c0)):
            b0 = (c0 + y) * TOPICS
            for x in range(strips):
                yield x, b0, min(TOPICS, B - b0)


def _kernel_model(bm, rows, order_seed):
    """``csrc/bitmap_or_dense.cu`` block by block, in numpy: each
    chunk's first ``STAGE`` distinct live rows claimed into the
    prefix-filled table in an order drawn from ``order_seed`` (the
    threads' interleaving is free); a topic ORs the staged columns of
    its rows, then its rows past the table from the bitmaps, or all its
    rows when more than ``SPILL_CAP`` are past it. Returns the union and
    how often each (topic, 16-byte group) was written."""
    R, W = bm.shape
    B, mb = rows.shape
    W4 = W // 4
    g4 = bm.reshape(R, W4, 4)
    out = np.zeros((B, W4, 4), np.uint32)
    writes = np.zeros((B, W4), np.int64)
    order = np.random.RandomState(order_seed)
    for x, b0, nt in _blocks(B, W4):
        ids = rows[b0:b0 + nt]
        tab, spilled = [], [[] for _ in range(nt)]
        for j in order.permutation(nt * mb):
            r = int(ids.flat[j])
            if not 0 <= r < R:
                continue
            if r not in tab and len(tab) < STAGE:
                tab.append(r)
            if r not in tab:
                spilled[j // mb].append(r)
        g = slice(x * THREADS, min((x + 1) * THREADS, W4))
        for t in range(nt):
            live = [int(r) for r in ids[t] if 0 <= r < R]
            acc = np.zeros_like(g4[0, g])
            for r in [r for r in tab if r in live] + (
                    spilled[t] if len(spilled[t]) <= SPILL_CAP else live):
                acc |= g4[r, g]
            out[b0 + t, g] = acc
            writes[b0 + t, g] += 1
    return out.reshape(B, W), writes


#: CASES, and row ids at or past R, and topics with more rows past the
#: table than their spill list holds
MODEL_CASES = dict(CASES, row_ids_past_r=(8, 70, 16, 1024, 0),
                   spill_list_full=(300, 40, 24, 1024, 0))


@pytest.mark.parametrize("name", sorted(MODEL_CASES))
def test_kernel_block_algorithm_equals_plain_or(name):
    """Every (topic, group) written once, equal to the plain OR, in two
    claim orders: rows staged, read from L2 past the table (R = 80 and
    300), also when a topic's spill list overflows (mb = 24); ids at or
    past R skipped like -1."""
    R, B, mb, W, dead = MODEL_CASES[name]
    bm, rows = _case(R, B, mb, W, dead, seed=3 + len(name))
    if name == "row_ids_past_r":
        rows[::3, ::2] = R + np.arange(0, mb, 2)
    live = np.where((rows >= 0) & (rows < R), rows, -1)
    want = tbm.or_bitmaps_ref(_t(bm), torch.from_numpy(live)).numpy()
    for seed in (0, 1):
        got, writes = _kernel_model(bm, rows, seed)
        assert (writes == 1).all()
        np.testing.assert_array_equal(got.view(np.int32), want)
    if R > 2 * STAGE:
        first = live[:TOPICS]
        assert len(np.unique(first[first >= 0])) > STAGE


@pytest.mark.parametrize("B, W", [
    (4096, 32768),          # B4's shape
    (2048, 16384),          # a 2x2 mesh cell
    (300, 2048),
    (130, 1028),            # a ragged last strip
    (1, 4),
    (0, 1024),
    (600_000, 4),           # more chunks than one launch's grid holds
])
def test_kernel_grid_covers_every_topic_strip_once(B, W):
    hits = np.zeros((B, -(-(W // 4) // THREADS)), np.int64)
    for x, b0, nt in _blocks(B, W // 4):
        hits[b0:b0 + nt, x] += 1
    assert (hits == 1).all()
    if B > MAX_GRID_Y * TOPICS:
        assert -(-B // TOPICS) > MAX_GRID_Y
