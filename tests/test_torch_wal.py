"""The port's wire codec and write-ahead journal against the JAX
package's, byte for byte.

The same values go through ``emqx_tpu.wire`` and
``emqx_tpu_torch.wire``; the same op sequences through both packages'
``Wal`` and ``WalGroup``. Tolerance: exact everywhere — equal encoded
bytes, equal journal files, equal replayed records (compared by their
encoding), equal ``shard_of``, and equal degrade/recover behaviour
(alarm callbacks, counters, buffer bound) under the ``wal.append`` and
``wal.fsync`` fault points, armed in both registries.
"""

import math
import os

import numpy as np
import pytest

from emqx_tpu import faults as jf
from emqx_tpu import wal as jwal
from emqx_tpu import wire as jwire
from emqx_tpu.durability import journal_key as jjournal_key
from emqx_tpu.session import Session as JSession
from emqx_tpu.types import Message as JMessage
from emqx_tpu.types import SubOpts as JSubOpts
from emqx_tpu_torch import faults as pf
from emqx_tpu_torch import wal as pwal
from emqx_tpu_torch import wire as pwire
from emqx_tpu_torch.durability import journal_key as pjournal_key
from emqx_tpu_torch.session import Session as PSession
from emqx_tpu_torch.types import Message as PMessage
from emqx_tpu_torch.types import SubOpts as PSubOpts

#: the two packages' (Message, SubOpts, Session, wire, wal, faults)
JAX = (JMessage, JSubOpts, JSession, jwire, jwal, jf)
PORT = (PMessage, PSubOpts, PSession, pwire, pwal, pf)


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


def ops(pkg):
    """The journal's record vocabulary, built from one package's
    types (fixed ids and timestamps, so both sides are equal)."""
    Message, SubOpts = pkg[0], pkg[1]
    return [
        ("route", "a/+", "n1", 1),
        ("route", "a/+", ("g", "n1"), 2),
        ("retain", "t/1", Message(topic="t/1", payload=b"\x00\xffv",
                                  qos=1, id=(1 << 100) + 7,
                                  timestamp=1.5,
                                  flags={"retain": True},
                                  headers={"properties": {"k": 1}}),
         1.5),
        ("retain", "t/1", None, 2.5),
        ("sess.sub", "c1", "$share/g/a/b", SubOpts(qos=1, nl=1)),
        ("sess.unsub", "c1", "a/b"),
        ("sess.close", "c1"),
    ]


def session(pkg, seed=0):
    """A session with subscriptions, an inflight window, a PUBREL
    marker, an mqueue and awaiting-rel state, all deterministic."""
    Message, SubOpts, Session = pkg[0], pkg[1], pkg[2]
    rng = np.random.default_rng(seed)
    s = Session("dev-1", clean_start=False, max_inflight=4,
                max_mqueue_len=10, expiry_interval=300.0)
    s.created_at = 1000.0
    for i in range(5):
        s.subscriptions[f"f/{i}/+"] = SubOpts(qos=int(rng.integers(3)))
    s.subscriptions["$share/g/x/#"] = SubOpts(qos=1, share="g")
    s._rebuild_share_keys()
    for pid in (3, 1, 2):
        s.inflight.insert(pid, (Message(topic=f"f/{pid}/x",
                                        payload=bytes([pid]), qos=1,
                                        id=pid, timestamp=10.0 + pid),
                                20.0 + pid))
    s.inflight.insert(9, ("pubrel", 30.0))
    s.next_pkt_id = 10
    s.awaiting_rel = {5: 40.0, 6: 41.0}
    s.mqueue.restore([(0, [Message(topic="q", payload=b"m", qos=1,
                                   id=99, timestamp=50.0)])])
    return s


VALUES = [
    None, True, False, 0, -1, 1 << 53, (1 << 53) + 1, -(1 << 80), 0.5,
    float("inf"), float("-inf"), "", "ünï/códe", b"", b"\x00\x01\xff",
    bytearray(b"ba"), [1, [2, (3, b"x")]], (None, {1: "a", 2.5: b"b"}),
    {"k": {"n": [1, 2]}, 3: (4,)}, {1, 2}, frozenset({"a"}),
]


@pytest.mark.parametrize("value", VALUES, ids=repr)
def test_wire_scalars_and_containers_encode_equal(value):
    enc = jwire.dumps(value)
    assert pwire.dumps(value) == enc
    # and each side decodes the other's bytes to the same value
    assert pwire.dumps(pwire.loads(enc)) == enc
    assert jwire.dumps(jwire.loads(pwire.dumps(value))) == enc


def test_wire_nan_encodes_equal():
    enc = jwire.dumps(float("nan"))
    assert pwire.dumps(float("nan")) == enc
    assert math.isnan(pwire.loads(enc))


def test_wire_records_encode_equal_and_cross_decode():
    jops, pops = ops(JAX), ops(PORT)
    for j, p in zip(jops, pops):
        enc = jwire.dumps(j)
        assert pwire.dumps(p) == enc, j[0]
        # a JAX-written record decodes into the port's types, and the
        # port re-encodes it to the same bytes (and back)
        got = pwire.loads(enc)
        assert pwire.dumps(got) == enc
        assert jwire.dumps(jwire.loads(pwire.dumps(got))) == enc
    msg = pwire.loads(jwire.dumps(jops[2][2]))
    assert isinstance(msg, PMessage) and msg.id == (1 << 100) + 7
    opts = pwire.loads(jwire.dumps(jops[4][3]))
    assert isinstance(opts, PSubOpts) and opts.nl == 1


def test_session_to_wire_and_back_equal():
    js, ps = session(JAX), session(PORT)
    enc = jwire.dumps(js)
    assert pwire.dumps(ps) == enc
    back = pwire.loads(enc)
    assert isinstance(back, PSession) and not back.connected
    assert pwire.dumps(back) == enc
    assert jwire.dumps(jwire.loads(pwire.dumps(back))) == enc
    assert back.expiry_interval == 300.0
    assert back.inflight.keys() == [3, 1, 2, 9]
    assert back._share_keys == js._share_keys


@pytest.mark.parametrize("bad", [object(), lambda: 0, 1j])
def test_wire_refuses_the_same_values(bad):
    with pytest.raises(jwire.WireError):
        jwire.dumps(bad)
    with pytest.raises(pwire.WireError):
        pwire.dumps(bad)


@pytest.mark.parametrize("data", [b"{", b'["zz", 1]', b'["M", [1]]',
                                  b'["b", "a"]', b"[1, 2, 3]"])
def test_wire_malformed_frames_refused_alike(data):
    with pytest.raises(jwire.WireError):
        jwire.loads(data)
    with pytest.raises(pwire.WireError):
        pwire.loads(data)


def _write(pkg, path, records):
    w = pkg[4].Wal(path, fsync=False)
    for op in records:
        w.append(op)
    assert w.flush()
    w.close()


def test_journal_files_byte_equal(tmp_path):
    _write(JAX, str(tmp_path / "j.wal"), ops(JAX))
    _write(PORT, str(tmp_path / "p.wal"), ops(PORT))
    data = (tmp_path / "j.wal").read_bytes()
    assert (tmp_path / "p.wal").read_bytes() == data
    assert pwal.frame(b"abc") == jwal.frame(b"abc")
    # each package replays the other's file to the same records
    for reader, codec in ((jwal, jwire), (pwal, pwire)):
        for name in ("j.wal", "p.wal"):
            recs, torn = reader.replay(str(tmp_path / name))
            assert not torn
            assert [codec.dumps(r) for r in recs] == \
                [jwire.dumps(r) for r in ops(JAX)]


@pytest.mark.parametrize("shards", [1, 4])
def test_sharded_group_files_byte_equal(tmp_path, shards):
    for pkg, sub in ((JAX, "j"), (PORT, "p")):
        d = tmp_path / sub
        d.mkdir()
        g = pkg[4].WalGroup(str(d), 3, shards=shards, fsync=False)
        keyf = jjournal_key if pkg is JAX else pjournal_key
        for op in ops(pkg) * 3:
            g.append(op, keyf(op))
        g.flush()
        g.rotate_to(4)
        g.append(ops(pkg)[0], keyf(ops(pkg)[0]))
        g.close()
    jn, pn = sorted(os.listdir(tmp_path / "j")), \
        sorted(os.listdir(tmp_path / "p"))
    assert jn == pn and len(jn) == 2 * shards
    for name in jn:
        assert (tmp_path / "p" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


def _tail_cases(path, kind):
    """Damage a written journal: a torn tail, a flipped payload byte
    in the second record, a bad magic, an oversize length."""
    data = bytearray(open(path, "rb").read())
    first = len(jwal.encode_record(ops(JAX)[0]))
    if kind == "torn":
        data += jwal.encode_record(ops(JAX)[3])[:7]
    elif kind == "crc":
        data[first + jwal._HDR.size + 2] ^= 0xFF
    elif kind == "magic":
        data[first:first + 2] = b"XX"
    elif kind == "oversize":
        data[first:first + jwal._HDR.size] = jwal._HDR.pack(
            jwal.MAGIC, jwal.MAX_RECORD + 1, 0)
    with open(path, "wb") as f:
        f.write(data)


@pytest.mark.parametrize("kind", ["torn", "crc", "magic", "oversize"])
def test_replay_of_damaged_tails_equal(tmp_path, kind):
    path = str(tmp_path / "j.wal")
    _write(JAX, path, ops(JAX))
    _tail_cases(path, kind)
    jrecs, jtorn = jwal.replay(path)
    precs, ptorn = pwal.replay(path)
    assert ptorn == jtorn and jtorn
    assert [pwire.dumps(r) for r in precs] == \
        [jwire.dumps(r) for r in jrecs]
    # every byte-level truncation replays to the same prefix
    data = open(path, "rb").read()
    for cut in range(0, len(data), 7):
        p2 = str(tmp_path / "cut.wal")
        with open(p2, "wb") as f:
            f.write(data[:cut])
        j2, jt = jwal.replay(p2)
        p2r, pt = pwal.replay(p2)
        assert (pt, len(p2r)) == (jt, len(j2))


def test_shard_of_and_journal_key_equal():
    rng = np.random.default_rng(3)
    keys = ["", "a", "ü/ß", "\ud800x"] + [
        "/".join(str(w) for w in rng.integers(0, 1000, size=int(n)))
        for n in rng.integers(1, 6, size=300)]
    for n in (0, 1, 2, 3, 4, 8, 16):
        assert [pwal.shard_of(k, n) for k in keys] == \
            [jwal.shard_of(k, n) for k in keys]
    for j, p in zip(ops(JAX), ops(PORT)):
        assert pjournal_key(p) == jjournal_key(j)
    assert pwal.shard_path("d", None, 7) == jwal.shard_path("d", None, 7)
    assert pwal.shard_path("d", 2, 7) == jwal.shard_path("d", 2, 7)


def _info(w):
    out = dict(w.info())
    out.pop("path")
    out.pop("last_fsync_ms")
    return out


def _scenario(pkg, path, scenario):
    """One degrade/recover scenario on one package's Wal; returns the
    alarm events, the info snapshots and the replayed records."""
    events = []
    faults = pkg[5]
    w = pkg[4].Wal(path, fsync=True, max_buffer=3,
                   retry_backoff_s=0.0, on_error=events.append)
    recs = ops(pkg)
    snaps = []
    if scenario == "fsync":
        w.append(recs[0])
        with faults.injected("wal.fsync", times=1):
            snaps.append(w.flush())
        snaps.append(_info(w))
        snaps.append(w.flush())   # backoff 0: the retry lands it
    elif scenario == "append":
        w.append(recs[0])
        w.append(recs[1])
        snaps.append(w.flush())
        w.append(recs[2])
        with faults.injected("wal.append", times=1):
            snaps.append(w.flush())
    elif scenario == "bound":
        w._backoff0 = w._backoff = 3600.0
        with faults.injected("wal.fsync", times=1):
            w.append(recs[0])
            snaps.append(w.flush())
        for i in range(5):
            w.append(("sess.close", f"c{i}"))
        snaps.append(w.flush())   # inside the backoff: nothing
    snaps.append(_info(w))
    w._f.close()
    replayed, torn = pkg[4].replay(path)
    kinds = [None if e is None else type(e).__name__ for e in events]
    return (kinds, snaps, torn,
            [pkg[3].dumps(r) for r in replayed])


@pytest.mark.parametrize("scenario", ["fsync", "append", "bound"])
def test_fault_points_degrade_and_recover_equal(tmp_path, scenario):
    j = _scenario(JAX, str(tmp_path / "j.wal"), scenario)
    p = _scenario(PORT, str(tmp_path / "p.wal"), scenario)
    # the injected exception's class differs by package
    jk, pk = j[0], p[0]
    assert [k is None for k in pk] == [k is None for k in jk]
    assert p[1:] == j[1:]
    assert jk, "the degrade must call on_error"
    if scenario == "fsync":
        assert jk[-1] is None  # the recovering flush clears the alarm
    if scenario == "bound":
        assert p[1][-1]["dropped"] == 3 and p[1][-1]["pending"] == 3
