"""The port's routing-plane checkpoint and the durability layer's state
blobs and manifest, against the JAX package's.

The same route history goes through a JAX ``Router`` and a port
``Router(device="cpu")`` on the same engine (the native one and the
Python one), in delta mode and patching in place. Tolerance: exact
everywhere — the two packages' snapshot files hold the same members
with the same dtypes and values and the same ``meta``/``routes`` JSON;
a file written by either restores into the other with equal filter
ids, vocabulary and matches (tables placed straight on the device for
``delta=False``, routes-only for ``delta=True``); damaged files fail
or degrade alike; the state blobs and manifests are byte-equal.
"""

import json
import os

import numpy as np
import pytest
import torch

from emqx_tpu import checkpoint as jck
from emqx_tpu import faults as jf
from emqx_tpu import wire as jwire
from emqx_tpu.router import MatcherConfig as JMatcherConfig
from emqx_tpu.router import Router as JRouter
from emqx_tpu.types import Message as JMessage
from emqx_tpu_torch import checkpoint as pck
from emqx_tpu_torch import faults as pf
from emqx_tpu_torch import wire as pwire
from emqx_tpu_torch.router import MatcherConfig as PMatcherConfig
from emqx_tpu_torch.router import Router as PRouter
from emqx_tpu_torch.types import Message as PMessage

FILTERS = ["a/b", "a/+", "x/#", "deep/1/2/3", "$share-less/t", "+/+/q",
           "w/+/+/z", "#"]
PROBES = ["a/b", "a/q", "x/deep/er", "late/comer", "gone/soon",
          "deep/1/2/3", "$share-less/t", "no/match", "m/n/q", "w/1/2/z",
          "$SYS/x"]


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in (jf, pf):
        f.clear()
        f.set_master(True)
        f.drain_injected()  # an earlier file's firings in this process
    try:
        yield
    finally:
        for f in (jf, pf):
            f.clear()
            f.set_master(True)


def jmk(delta=True, native=True, node="n1"):
    return JRouter(JMatcherConfig(device_min_filters=0, delta=delta,
                                  use_native=native), node=node)


def pmk(delta=True, native=True, node="n1"):
    return PRouter(PMatcherConfig(device_min_filters=0, delta=delta,
                                  use_native=native), node=node,
                   device="cpu")


def fill(r):
    """The same history on either package: adds, a shared route, a
    flatten, a delete (an id hole), a later insert, a drain."""
    for f in FILTERS:
        r.add_route(f)
    r.add_route("a/+", dest=("g1", "n1"))
    r.add_route("a/+")  # refcount 2
    r.add_route("gone/soon")
    r.match_filters(["a/b"])
    r.delete_route("gone/soon")
    r.add_route("late/comer")
    r.match_filters(["a/b"])


def vocab(r):
    return (r._native.words() if r._native is not None
            else r._table.words())


def matches(r):
    return [sorted(m) for m in r.match_filters(PROBES)]


def members(path):
    with np.load(path) as data:
        out = {k: np.array(data[k]) for k in data.files}
    meta = json.loads(bytes(out.pop("meta")).decode())
    routes = json.loads(bytes(out.pop("routes")).decode())
    return meta, routes, out


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("native", [True, False])
def test_snapshot_files_hold_equal_members(tmp_path, delta, native):
    jr, pr = jmk(delta, native), pmk(delta, native)
    fill(jr)
    fill(pr)
    jinfo = jck.save(jr, str(tmp_path / "j.npz"))
    pinfo = pck.save(pr, str(tmp_path / "p.npz"))
    assert pinfo == jinfo and pinfo["tables"] == (not delta)
    jmeta, jroutes, jarr = members(str(tmp_path / "j.npz"))
    pmeta, proutes, parr = members(str(tmp_path / "p.npz"))
    assert pmeta == jmeta and proutes == jroutes
    assert sorted(parr) == sorted(jarr)
    for k in jarr:
        assert parr[k].dtype == jarr[k].dtype, k
        assert np.array_equal(parr[k], jarr[k]), k


@pytest.mark.parametrize("delta", [False, True])
@pytest.mark.parametrize("native", [True, False])
def test_roundtrip_on_both_engines(tmp_path, delta, native):
    src = pmk(delta, native)
    fill(src)
    path = str(tmp_path / "p.npz")
    pck.save(src, path)
    dst = pmk(delta=True, native=native)
    out = pck.load(dst, path)
    assert out["tables_restored"] == (not delta)
    if not delta:
        assert dst.stats()["rebuilds"] == 0  # placed, not flattened
    assert dst._filter_ids == src._filter_ids
    assert matches(dst) == matches(src)
    # the restored router keeps mutating exactly
    dst.add_route("post/restore/+")
    dst.delete_route("a/b")
    want = pmk(native=native)
    fill(want)
    want.add_route("post/restore/+")
    want.delete_route("a/b")
    assert matches(dst) == matches(want)


@pytest.mark.parametrize("save_delta", [False, True])
@pytest.mark.parametrize("load_delta", [False, True])
@pytest.mark.parametrize("native", [True, False])
def test_cross_restore_both_ways(tmp_path, save_delta, load_delta,
                                 native):
    jr, pr = jmk(save_delta, native), pmk(save_delta, native)
    fill(jr)
    fill(pr)
    jpath, ppath = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jck.save(jr, jpath)
    pck.save(pr, ppath)
    # a JAX-written file into the port's router
    p2 = pmk(load_delta, native)
    out = pck.load(p2, jpath)
    assert out["tables_restored"] == (not save_delta)
    # a port-written file into the JAX package's router
    j2 = jmk(load_delta, native)
    jout = jck.load(j2, ppath)
    assert jout["tables_restored"] == (not save_delta)
    for r in (p2, j2):
        assert r._filter_ids == jr._filter_ids
        assert r.route_table() == jr.route_table()
    assert vocab(p2) == vocab(j2) == vocab(jr)
    assert matches(p2) == matches(jr) == matches(j2)


def test_restore_remaps_the_saved_node_name(tmp_path):
    jr, pr = jmk(node="old"), pmk(node="old")
    for r in (jr, pr):
        fill_node(r, "old")
    jck.save(jr, str(tmp_path / "j.npz"))
    pck.save(pr, str(tmp_path / "p.npz"))
    for name in ("j.npz", "p.npz"):
        j2, p2 = jmk(node="new"), pmk(node="new")
        jck.load(j2, str(tmp_path / name))
        pck.load(p2, str(tmp_path / name))
        assert p2.route_table() == j2.route_table()
        assert ("g1", "new") in p2.route_table()["a/+"]
        assert "old" not in str(p2.route_table())
        assert matches(p2) == matches(j2)


def fill_node(r, node):
    for f in FILTERS:
        r.add_route(f, dest=node)
    r.add_route("a/+", dest=("g1", node))
    r.match_filters(["a/b"])


def _damaged(tmp_path, kind):
    """A snapshot file damaged one way; returns its path."""
    r = jmk(delta=False)
    fill(r)
    good = str(tmp_path / "good.npz")
    jck.save(r, good)
    meta, routes, arr = members(good)
    path = str(tmp_path / f"{kind}.npz")
    if kind == "garbage":
        with open(path, "wb") as f:
            f.write(b"not a zip at all \x00\x01\x02" * 16)
    elif kind.startswith("cut"):
        data = open(good, "rb").read()
        with open(path, "wb") as f:
            f.write(data[:int(len(data) * float(kind[3:]))])
    elif kind == "v1":
        meta["format"] = 1
        np.savez(path, meta=np.frombuffer(json.dumps(meta).encode(),
                                          dtype=np.uint8),
                 routes=np.frombuffer(json.dumps(routes).encode(),
                                      dtype=np.uint8),
                 ht_state=np.zeros((4, 4), np.int32))
    elif kind == "future":
        meta["format"] = 99
        np.savez(path, meta=np.frombuffer(json.dumps(meta).encode(),
                                          dtype=np.uint8),
                 routes=np.frombuffer(b"[]", dtype=np.uint8))
    elif kind == "no_arrays":
        np.savez(path, meta=np.frombuffer(json.dumps(meta).encode(),
                                          dtype=np.uint8),
                 routes=np.frombuffer(json.dumps(routes).encode(),
                                      dtype=np.uint8))
    elif kind == "no_meta":
        np.savez(path, routes=np.frombuffer(b"[]", dtype=np.uint8))
    return path


def _outcome(ck, mk, path):
    r = mk()
    try:
        out = ck.load(r, path)
    except ck.CheckpointError:
        return ("CheckpointError",)
    return (out, matches(r))


@pytest.mark.parametrize("kind", ["garbage", "cut0.25", "cut0.6",
                                  "cut0.95", "v1", "future", "no_arrays",
                                  "no_meta"])
def test_damaged_files_fail_or_degrade_alike(tmp_path, kind):
    path = _damaged(tmp_path, kind)
    jout = _outcome(jck, jmk, path)
    pout = _outcome(pck, pmk, path)
    assert pout == jout
    if kind in ("v1", "no_arrays"):
        assert not pout[0]["tables_restored"]
    else:
        assert pout == ("CheckpointError",)
    assert issubclass(pck.CheckpointError, ValueError)


def test_restore_into_a_used_router_refused(tmp_path):
    r = pmk()
    fill(r)
    path = str(tmp_path / "p.npz")
    pck.save(r, path)
    used = pmk()
    used.add_route("already/here")
    with pytest.raises(ValueError):
        pck.load(used, path)


@pytest.mark.parametrize("native", [True, False])
def test_device_lost_during_load_degrades_to_the_route_log(tmp_path,
                                                           native):
    src = pmk(delta=False, native=native)
    fill(src)
    path = str(tmp_path / "p.npz")
    assert pck.save(src, path)["tables"]
    jr = jmk()
    with jf.injected("device.lost", times=1):
        jout = jck.load(jr, path)
    r = pmk(native=native)
    with pf.injected("device.lost", times=1):
        out = pck.load(r, path)
    assert out == jout and not out["tables_restored"]
    assert pf.drain_injected() == 1
    # the route log is exact; the first match re-flattens
    assert matches(r) == matches(src) == matches(jr)
    assert r.stats()["rebuilds"] >= 1


@pytest.mark.parametrize("injected", [False, True],
                         ids=["real-failure", "device.lost"])
def test_placement_on_cuda_raises_unless_device_lost_injected(
        tmp_path, monkeypatch, injected):
    """On the card the breaker is strict: a real failure to place the
    restored tables raises (no router is left serving from the host);
    only the injected ``device.lost`` degrades to the route log. The
    router is pointed at a CUDA device and the placement made to
    fail, so the rule is held without a card."""
    from emqx_tpu_torch.ops import convert

    src = pmk(delta=False)
    fill(src)
    path = str(tmp_path / "p.npz")
    assert pck.save(src, path)["tables"]

    def placement_fails(host_auto, device):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(convert, "automaton", placement_fails)
    r = pmk(delta=False)
    r.device = torch.device("cuda")
    if not injected:
        with pytest.raises(RuntimeError, match="out of memory"):
            pck.load(r, path)
        return
    with pf.injected("device.lost", times=1):
        out = pck.load(r, path)
    jr = jmk(delta=False)
    with jf.injected("device.lost", times=1):
        jout = jck.load(jr, path)
    assert out == jout and not out["tables_restored"]
    assert pf.drain_injected() == 1
    # nothing placed: the route log re-flattens on the first match
    assert r.route_table() == src.route_table()
    assert r._published is None


def state_of(Message):
    return {"format": 1, "ts": 5.0,
            "sessions": [("c1", None, {"subscriptions": {}, "n": 1})],
            "retained": [("t/1", Message(topic="t/1", payload=b"v",
                                         id=7, timestamp=3.0))],
            "tombstones": [("t/2", 4.0)]}


def test_state_blobs_byte_equal_and_cross_load(tmp_path):
    jp, pp = str(tmp_path / "j.bin"), str(tmp_path / "p.bin")
    jck.save_state(jp, state_of(JMessage))
    pck.save_state(pp, state_of(PMessage))
    assert open(pp, "rb").read() == open(jp, "rb").read()
    assert pck.file_crc(pp) == jck.file_crc(jp)
    got = pck.load_state(jp)
    assert pwire.dumps(got) == jwire.dumps(state_of(JMessage))
    assert isinstance(got["retained"][0][1], PMessage)
    # a damaged blob raises the one error class on both sides
    data = open(jp, "rb").read()
    for bad in (data[:5], data[:-3], data[:12] + b"X" + data[13:]):
        with open(pp, "wb") as f:
            f.write(bad)
        with pytest.raises(jck.CheckpointError):
            jck.load_state(pp)
        with pytest.raises(pck.CheckpointError):
            pck.load_state(pp)


def test_manifest_commits_atomically_under_checkpoint_rename(tmp_path):
    m1 = {"format": 2, "generation": 1, "journal_seq": 1, "deltas": []}
    m2 = dict(m1, generation=2)
    jd, pd = tmp_path / "j", tmp_path / "p"
    for d, ck, faults in ((jd, jck, jf), (pd, pck, pf)):
        d.mkdir()
        assert ck.read_manifest(str(d)) is None
        ck.write_manifest(str(d), m1)
        with faults.injected("checkpoint.rename", times=1):
            with pytest.raises(faults.FaultInjected):
                ck.write_manifest(str(d), m2)
        # the crash window: the new manifest written, the previous
        # generation still authoritative
        assert ck.read_manifest(str(d)) == m1
        assert os.path.exists(os.path.join(str(d), "MANIFEST.tmp"))
        ck.write_manifest(str(d), m2)
    assert (pd / "MANIFEST").read_bytes() == (jd / "MANIFEST").read_bytes()
    assert pck.read_manifest(str(jd)) == jck.read_manifest(str(pd)) == m2
    for body in ("{", json.dumps({"format": 9})):
        (pd / "MANIFEST").write_text(body)
        with pytest.raises(jck.CheckpointError):
            jck.read_manifest(str(pd))
        with pytest.raises(pck.CheckpointError):
            pck.read_manifest(str(pd))
