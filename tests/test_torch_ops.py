"""The port's pack, fan-out and bitmap ops against the JAX package's
jitted ones, on the same seeded inputs, exactly (every output is an
integer or a bit). The bitmap OR is held against
``emqx_tpu.ops.bitmap.or_bitmaps_auto``, which runs the Pallas kernel
in interpret mode on the CPU. Tests of the CUDA kernel itself need a
card (tests/test_torch_kernels.py).
"""

import itertools

import numpy as np
import pytest
import torch

from emqx_tpu.ops import bitmap as jbm
from emqx_tpu.ops import fanout as jfan
from emqx_tpu.ops import pack as jpack
from emqx_tpu_torch import device as tdevice
from emqx_tpu_torch.ops import bitmap as tbm
from emqx_tpu_torch.ops import convert
from emqx_tpu_torch.ops import fanout as tfan
from emqx_tpu_torch.ops import pack as tpack


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Run torch single-threaded here and restore the setting after:
    these tests share worker processes and cores with timing-sensitive
    tests of the JAX package."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _ids(rs, B, M, hi, fill=0.6):
    ids = rs.randint(0, hi, size=(B, M)).astype(np.int32)
    ids[rs.rand(B, M) < fill] = -1
    return ids


@pytest.mark.parametrize("pm", [8, 64, 512])
def test_pack_matches_and_mask_pad_rows(pm):
    rs = np.random.RandomState(pm)
    ids = _ids(rs, 16, 24, 100)
    masked_j = np.asarray(jpack.mask_pad_rows(ids, np.int32(11)))
    masked_t = tpack.mask_pad_rows(torch.from_numpy(ids), 11)
    _eq(masked_t, masked_j, "mask")
    flags = rs.rand(16) < 0.5
    _eq(tpack.mask_pad_flags(torch.from_numpy(flags), 11),
        jpack.mask_pad_flags(flags, np.int32(11)), "flags")
    for a, b in zip(tpack.pack_matches(masked_t, pm=pm),
                    jpack.pack_matches(masked_j, pm=pm)):
        _eq(a, b, "pack_matches")
    assert tpack.budget_for(100, 8) == jpack.budget_for(100, 8)


def test_bundle_i32_matches_jax():
    rs = np.random.RandomState(16)
    ptr = np.cumsum(rs.randint(0, 5, size=9)).astype(np.int32)
    bits = rs.randint(0, 2**32, size=(3, 4), dtype=np.uint64).astype(np.uint32)
    flags = rs.rand(5) < 0.5
    _eq(tpack.bundle_i32(torch.from_numpy(ptr), torch.from_numpy(flags),
                         torch.from_numpy(bits.view(np.int32))),
        jpack.bundle_i32(ptr, flags, bits), "bundle")


@pytest.mark.parametrize("seed,q", [(1, 512), (2, 32), (3, 4)])
def test_expand_packed_matches_jax(seed, q):
    """Includes over-budget totals (q smaller than the deliveries) —
    the totals drive the broker's re-pack loop."""
    rs = np.random.RandomState(seed)
    rows = {f: sorted(rs.choice(400, size=rs.randint(0, 9), replace=False)
                      .tolist()) for f in range(40) if rs.rand() < 0.8}
    host = jfan.build_fanout(rows, 40)
    ids = _ids(rs, 16, 12, 48)  # ids 40..47 lie past the table: drop
    m_ptr, packed = jpack.pack_matches(ids, pm=128)
    want = jfan.expand_packed(host, m_ptr, packed, q=q)
    got = tfan.expand_packed(convert.fanout(host, "cpu"),
                             torch.from_numpy(np.array(m_ptr)),
                             torch.from_numpy(np.array(packed)), q=q)
    for a, b, name in zip(got, want, ("f_ptr", "subs", "src", "total")):
        _eq(a, b, name)
    if q == 4:
        assert int(got[3]) > q


def test_builders_are_copies_of_the_jax_builders():
    rs = np.random.RandomState(9)
    rows = {f: sorted(rs.choice(5000, size=rs.randint(1, 60), replace=False)
                      .tolist()) for f in range(30)}
    a, b = tfan.build_fanout(rows, 30), jfan.build_fanout(rows, 30)
    for x, y in zip(a, b):
        _eq(x, y, "fanout")
    a, b = tbm.build_bitmaps(rows, 30, 5000), jbm.build_bitmaps(rows, 30, 5000)
    for x, y in zip(a, b):
        _eq(x, y, "bitmaps")
    assert tbm.words_for(70000) == jbm.words_for(70000)


def test_rows_for_matches_out_of_capacity_ids_drop():
    rs = np.random.RandomState(4)
    big = {3: [1, 2], 7: [5], 12: [9, 10, 11], 15: [0]}
    host = jbm.build_bitmaps(big, 16, 64)
    ids = _ids(rs, 12, 20, 40, fill=0.3)  # many ids ≥ 16 = capacity
    ids[0, :6] = [3, 7, 12, 15, 3, 7]      # > mb=4 big matches
    dev = convert.bitmaps(host, "cpu")
    for mb in (2, 4, 16):
        got = tbm.rows_for_matches(dev, torch.from_numpy(ids), mb=mb)
        want = jbm.rows_for_matches(host, ids, mb=mb)
        _eq(got[0], want[0], f"rows mb={mb}")
        _eq(got[1], want[1], f"ovf mb={mb}")
    assert bool(tbm.rows_for_matches(dev, torch.from_numpy(ids), mb=4)[1][0])


def test_or_bitmaps_ref_matches_pallas_kernel_in_interpret_mode():
    rs = np.random.RandomState(11)
    R, W, B, mb = 6, 2048, 8, 5
    bm = rs.randint(0, 2**32, size=(R, W), dtype=np.uint64).astype(np.uint32)
    rows = rs.randint(-1, R, size=(B, mb)).astype(np.int32)
    rows[2] = -1
    want = np.asarray(jbm.or_bitmaps_auto(bm, rows))
    got = tbm.or_bitmaps_ref(torch.from_numpy(bm.view(np.int32)),
                             torch.from_numpy(rows))
    _eq(got.numpy().view(np.uint32), want, "or")
    auto = tbm.or_bitmaps_auto(torch.from_numpy(bm.view(np.int32)),
                               torch.from_numpy(rows))
    assert torch.equal(auto, got)


def test_pack_union_rows_matches_jax():
    rs = np.random.RandomState(12)
    union = rs.randint(0, 2**32, size=(16, 64), dtype=np.uint64) \
        .astype(np.uint32)
    for has_big, pr in itertools.product(
            (rs.rand(16) < 0.4, np.zeros(16, bool)), (2, 8, 32)):
        got = tpack.pack_union_rows(torch.from_numpy(union.view(np.int32)),
                                    torch.from_numpy(has_big), pr=pr)
        want = jpack.pack_union_rows(union, has_big, pr=pr)
        _eq(got[0], want[0], "sel")
        _eq(got[1].numpy().view(np.uint32), want[1], "rows")
        assert int(got[2]) == int(want[2])


def test_device_resolution_never_falls_back_silently(monkeypatch):
    assert tdevice.resolve("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve()
    with pytest.raises(RuntimeError):
        tdevice.resolve("cuda")
    from emqx_tpu_torch.broker import Broker

    with pytest.raises(RuntimeError):
        Broker()


def test_bitmap_kernel_wrapper_refuses_cpu_tensors():
    bm = torch.zeros((4, 1024), dtype=torch.int32)
    rows = torch.full((2, 3), -1, dtype=torch.int32)
    with pytest.raises(ValueError):
        tbm.or_bitmaps_cuda(bm, rows)
