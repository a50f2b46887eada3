#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``emqx_tpu_torch``) on one GPU.

Drives the port's single-GPU publish → match → dispatch path and holds
its two hand-written kernels against their plain PyTorch versions:

  1. environment: torch / CUDA versions and the card's name and power
     limit (``nvidia-smi``);
  2. build: compiles ``emqx_tpu_torch/csrc/*.cu`` (one ``nvcc`` per
     source, in parallel) and prints the build seconds and the
     compiler's register report;
  3. B1 (the NFA walk) against the plain walk, byte for byte: the
     1M-filter narrow automaton of phase 5 at the main path's batch,
     a wide (chain-compressed) automaton, k ∈ {16, 64} with
     ``pack_ids`` on and off, tiny-k overflow, ``$SYS`` and too-deep
     topics; kernel and plain times;
  4. B2 (the bitmap OR) against ``or_bitmaps_ref``, bit for bit, at the
     main path's rows (the slice batch with the most live row slots)
     and at W = 32,768, B = 4,096, mb = 16 with -1 slots; times;
  5. the slice: ``Broker(device="cuda")`` at BASELINE config 2's shape
     (1M ``+`` subscriptions over a 5-level tree of 40 words per level,
     10K literal, 10K ``#``, 10K ``$share`` subscriptions, 8 filters of
     4,096 subscribers on the bitmap path), batches of Zipf(1.1) topics
     through ``publish_begin`` / ``publish_fetch`` / ``publish_finish``
     (what ``publish_batch`` runs); asserts every batch took the device
     path and launched both kernels, checks every batch's per-message
     (subscriber, filter) sets against the port's ``TrieOracle``, and
     prints msgs/s, p50/p99 batch latency, the overflow-row share and
     the subscribe / rebuild seconds.

The last two lines are one JSON object per kernel row
(``{"kernels": [...]}``) and ``{"ok": true, "device": {...}}``. Every
phase raises on failure; the script then exits non-zero. Without CUDA,
or without the ``emqx_tpu_torch`` package beside it, it exits non-zero
at once and prints no result.

    python3 chip_smoke.py                 # full size, one card
    python3 chip_smoke.py --subs 100000   # a smaller tree
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s — the
#: bound of both kernels is bytes moved over this rate
HBM_BYTES_PER_S = 3.35e12
LEVELS = 5
VOCAB = 40


def log(*a) -> None:
    print(*a, flush=True)


class Sink:
    """A subscriber; while ``Sink.log`` is a list, it records
    ``(message id, sink id, filter)`` per delivery."""

    __slots__ = ("sid",)
    log = None

    def __init__(self, sid: int) -> None:
        self.sid = sid

    def deliver(self, topic_filter, msg) -> None:
        if Sink.log is not None:
            Sink.log.append((msg.id, self.sid, topic_filter))


# -- workload: BASELINE config 2's shape -----------------------------------

def _word(level: int, i: int) -> str:
    return f"w{level}_{i}"


def _unique_rows(rng, n, make):
    """``n`` distinct rows from ``make(count)`` (generation order)."""
    rows = make(3 * n + 64)
    key = np.zeros(len(rows), np.int64)
    for col in range(rows.shape[1]):
        key = key * (VOCAB + 2) + rows[:, col]
    _, first = np.unique(key, return_index=True)
    if len(first) < n:
        raise RuntimeError("workload generator: too few distinct filters")
    return rows[np.sort(first)[:n]]


def _join(row) -> str:
    out = []
    for level, i in enumerate(row):
        if i < 0:
            break
        out.append("+" if i == VOCAB else "#" if i == VOCAB + 1
                   else _word(level, int(i)))
    return "/".join(out)


def make_workload(rng, n_plus: int, n_other: int, n_big: int,
                  big_members: int):
    """Filter strings of every class (subscription order)."""
    def plus_rows(c):
        r = rng.integers(0, VOCAB, size=(c, LEVELS))
        r[np.arange(c), rng.integers(0, LEVELS, size=c)] = VOCAB
        return r

    def hash_rows(c):
        r = rng.integers(0, VOCAB, size=(c, LEVELS))
        d = rng.integers(1, LEVELS, size=c)       # '#' after 1..4 words
        r[np.arange(c), d] = VOCAB + 1
        r[np.arange(LEVELS)[None, :] > d[:, None]] = -1
        return r

    plus = [_join(r) for r in _unique_rows(rng, n_plus, plus_rows)]
    lit = [_join(r) for r in _unique_rows(
        rng, n_other, lambda c: rng.integers(0, VOCAB, size=(c, LEVELS)))]
    hsh = [_join(r) for r in _unique_rows(rng, n_other, hash_rows)]
    shared = [_join(r) for r in _unique_rows(rng, n_other // 4, plus_rows)]
    big = ["/".join([_word(i, 0) for i in range(LEVELS - 1)] + [f"big{j}"])
           for j in range(n_big)]
    return {"plus": plus, "literal": lit, "hash": hsh, "shared": shared,
            "big": big, "big_members": big_members}


def subscribe_all(broker, wl, rng):
    """Subscribe every class; returns the sinks and the drawable
    filters (inner filter strings, big filters at Zipf ranks
    1000-1007 so a batch hits a few of them)."""
    sinks = []

    def new_sink():
        s = Sink(len(sinks))
        sinks.append(s)
        return s

    for f in wl["plus"]:
        broker.subscribe(new_sink(), f)
    for f in wl["literal"] + wl["hash"]:
        broker.subscribe(new_sink(), f)
    for f in wl["shared"]:
        for _ in range(4):
            broker.subscribe(new_sink(), f"$share/g/{f}")
    n_plus = len(wl["plus"])
    for f in wl["big"]:
        for i in rng.choice(n_plus, size=wl["big_members"], replace=False):
            broker.subscribe(sinks[int(i)], f)
    draw = wl["plus"] + wl["literal"] + wl["hash"] + wl["shared"]
    draw = [draw[i] for i in rng.permutation(len(draw))]
    at = min(1000, len(draw))
    draw[at:at] = wl["big"]
    return sinks, draw


def zipf_topics(rng, draw, n: int, a: float = 1.1):
    """``n`` topics: filters drawn Zipf(a) by rank, wildcards filled."""
    w = 1.0 / np.arange(1, len(draw) + 1, dtype=np.float64) ** a
    ranks = rng.choice(len(draw), size=n, p=w / w.sum())
    fill = rng.integers(0, VOCAB, size=(n, LEVELS))
    out = []
    for t, r in enumerate(ranks):
        ws = draw[int(r)].split("/")
        if ws[-1] == "#":
            # '#' matches the prefix plus 0 .. LEVELS-d more words
            d = len(ws) - 1
            extra = int(fill[t, 0]) % (LEVELS - d + 1)
            ws = ws[:-1] + [_word(d + j, int(fill[t, d + j]))
                            for j in range(extra)]
        out.append("/".join(_word(lv, int(fill[t, lv])) if w == "+" else w
                            for lv, w in enumerate(ws)))
    return out


# -- timing and bounds ------------------------------------------------------

def time_cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def kernel_ms(fn, name: str, iters: int = 20):
    """Device time of one launch of the kernel whose name contains
    ``name``, from torch.profiler's CUDA trace (the wrapper's host
    work and the torch ops around it excluded). Raises when the trace
    holds no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if name in e.key and _dev_us(e) > 0]
    if not hits:
        raise RuntimeError(f"torch.profiler traced no device time for {name}")
    return sum(_dev_us(e) for e in hits) / sum(e.count for e in hits) / 1e3


def walk_lanes(router, topics, k: int, steps: int):
    """``(live, probing)`` lane-hops of a narrow walk of ``topics``
    (the padded batch), replayed on the router's host trie: per hop,
    every live lane reads its state's node2 row and every lane that
    walks a known word probes two bucket rows. A frontier past k keeps
    k lanes, so an overflow row's count is approximate."""
    trie, table = router._trie, router._table
    max_levels = router.config.max_levels
    live = probing = 0
    for t in topics:
        ws = t.split("/")
        n = len(ws) if len(ws) <= max_levels else -1
        root_sys = ws[0].startswith("$")
        front = [trie.root]
        for s in range(steps):
            live += len(front)
            if s >= n:
                break  # ending (or too deep): no edge is walked
            known = table.lookup(ws[s]) >= 0
            nxt = []
            for node in front:
                if known:
                    probing += 1
                    child = node.children.get(ws[s])
                    if child is not None:
                        nxt.append(child)
                plus = node.children.get("+")
                if plus is not None and not (s == 0 and root_sys):
                    nxt.append(plus)
            front = nxt[:k]
            if not front:
                break
    return live, probing


def walk_bound_ms(B, L, steps, k, live, probing, row_bytes) -> float:
    """Least time for the walk's bytes: the batch words, lengths and
    flags read once, one node2 row per live lane per hop and two bucket
    rows per probing lane (what this batch needs, :func:`walk_lanes`),
    the emit slots and the overflow flags written once."""
    nbytes = (B * L * 4 + 2 * B * 4 + 4 + live * 16 + probing * 2 * row_bytes
              + B * steps * 2 * k * 4 + B * 4)
    return nbytes / HBM_BYTES_PER_S * 1e3


def or_bound_ms(R, W, B, mb, rows_live) -> float:
    """Least time for the OR's bytes: the rows read once, each live
    bitmap row tile read once (at most the whole table), the union
    written once."""
    read = min(rows_live, R) * W * 4
    return (read + B * mb * 4 + B * W * 4) / HBM_BYTES_PER_S * 1e3


# -- phases -----------------------------------------------------------------

def phase_env():
    import torch

    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    log(smi)
    return smi


def phase_build(card):
    from emqx_tpu_torch.ops import _build

    secs = _build.build(verbose=True)
    log(f"[build] both kernels built in {secs:.1f} s ({card})")


def check_walk(auto, args, kw, label):
    """Kernel vs plain on the same inputs; raises on any difference."""
    import torch

    from emqx_tpu_torch.ops.match import match_batch
    from emqx_tpu_torch.ops.walk_cuda import match_batch_cuda

    want = match_batch(auto, *args, **kw)
    got = match_batch_cuda(auto, *args, **kw)
    torch.cuda.synchronize()
    err = 0
    for name, x, y in zip(("ids", "count", "overflow"), got, want):
        if x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"walk kernel != plain walk ({label}: {name})")
        err = max(err, int((x.long() - y.long()).abs().max()) if x.numel() else 0)
    log(f"[B1] {label}: equal; {int(got.overflow.sum())} overflow rows")
    return err


def phase_walk(broker, batch_topics, rng, card):
    """B1 against the plain walk: the main automaton at the main
    path's inputs, k/pack variants, tiny k, $SYS, too-deep topics, and
    a wide automaton. Returns the kernel row's numbers."""
    import torch

    from emqx_tpu_torch.ops import convert
    from emqx_tpu_torch.ops.csr import (attach_walk_tables,
                                        build_automaton, compress_automaton)
    from emqx_tpu_torch.ops.match import match_batch, walk_params
    from emqx_tpu_torch.ops.tokenize import WordTable, encode_batch
    from emqx_tpu_torch.ops.walk_cuda import match_batch_cuda
    from emqx_tpu_torch.oracle import TrieOracle

    router = broker.router
    auto, _map, _epoch = router.automaton()
    uniq = list(dict.fromkeys(batch_topics))
    args, kw = router.walk_inputs(uniq)
    B, L = args[0].shape
    main = f"main automaton ({'wide' if kw['take'] > 1 else 'narrow'})"
    err = check_walk(auto, args, kw,
                     f"{main}, main path inputs B={B} L={L} "
                     f"k={kw['k']} steps={kw['steps']}")
    for k in (16, 64):
        for pack in (True, False):
            err = max(err, check_walk(
                auto, args, dict(kw, k=k, pack_ids=pack),
                f"{main} k={k} pack_ids={pack}"))
    odd = uniq[:2000] + ["$SYS/brokers/up", "$SYS/w1_0/w2_0",
                         "/".join(["w0_1"] * 20), "w0_1/w1_1/w2_1/w3_1/w4_1/x"]
    a2, kw2 = router.walk_inputs(odd)
    for pack in (True, False):
        err = max(err, check_walk(auto, a2, dict(kw2, k=2, m=8, pack_ids=pack),
                                  f"{main} tiny k=2 m=8 pack_ids={pack} "
                                  f"($SYS, too deep)"))
    # a wide automaton: deep literal chains the compressor fuses
    trie, table, fids = TrieOracle(), WordTable(), {}
    while len(fids) < 20000:
        depth = int(rng.integers(6, 17))
        ws = [f"d{int(x)}" for x in rng.integers(0, 3, size=depth)]
        r = rng.random()
        if r < 0.2:
            ws[-1] = "#"
        elif r < 0.35:
            ws[int(rng.integers(0, depth))] = "+"
        f = "/".join(ws)
        if f not in fids:
            fids[f] = len(fids)
            trie.insert(f)
            for w in ws:
                if w not in ("+", "#"):
                    table.intern(w)
    raw = build_automaton(trie, fids, table, skip_hash=True)
    wide, edges = compress_automaton(raw, force_mode="wide")
    wide = attach_walk_tables(wide, edges)
    wauto = convert.automaton(wide, router.device)
    topics = ["/".join(w if w not in ("+", "#") else "d1"
                       for w in f.split("/")) for f in list(fids)[:3000]]
    topics += ["$SYS/d0/d1", "/".join(["d0"] * 20), "d0", "d2/d2/d2"]
    ids, n, sysm = encode_batch(table, topics, 16)
    wargs = [torch.from_numpy(a).to(router.device) for a in (ids, n, sysm)]
    for k in (2, 16, 64):
        for pack in (True, False):
            err = max(err, check_walk(
                wauto, wargs, dict(k=k, m=64, pack_ids=pack,
                                   **walk_params(wide, ids.shape[1])),
                f"wide ({wide.v2_states} states, take {wide.wt_take}) "
                f"k={k} pack_ids={pack}"))
    # times and bound at the main path's inputs: the kernel alone
    # (profiler device time) and the wrapper with its torch tail
    run = lambda: match_batch_cuda(auto, *args, **kw)  # noqa: E731
    wrapper_ms = time_cuda_ms(run)
    ms = kernel_ms(run, "walk_kernel")
    plain_ms = time_cuda_ms(lambda: match_batch(auto, *args, **kw),
                            iters=3, warmup=1)
    if kw["take"] > 1:
        raise RuntimeError("walk_lanes replays the narrow layout only")
    padded = uniq + ["\x00/pad"] * (B - len(uniq))
    live, probing = walk_lanes(router, padded, kw["k"], kw["steps"])
    bound = walk_bound_ms(B, L, kw["steps"], kw["k"], live, probing,
                          auto.wt.shape[1] * 4)
    log(f"[B1] main path inputs B={B}: kernel {ms:.5f} ms (wrapper with "
        f"its torch tail {wrapper_ms:.5f} ms), plain {plain_ms:.4f} ms, "
        f"bound {bound:.5f} ms (bytes) — {card}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound}


def check_or(bitmaps, rows, label):
    import torch

    from emqx_tpu_torch.ops.bitmap import or_bitmaps_cuda, or_bitmaps_ref

    want = or_bitmaps_ref(bitmaps, rows)
    got = or_bitmaps_cuda(bitmaps, rows)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"bitmap OR kernel != plain OR ({label})")
    log(f"[B2] {label}: equal")
    return int((got.long() - want.long()).abs().max())


def phase_bitmap(broker, batches, rng, card):
    """B2 against the plain OR at the main path's rows (of the slice
    batch with the most live row slots) and at the dense W = 32,768 x
    B = 4,096 x mb = 16 shape."""
    import torch

    from emqx_tpu_torch.ops.bitmap import (or_bitmaps_cuda, or_bitmaps_ref,
                                           rows_for_matches)
    from emqx_tpu_torch.ops.pack import mask_pad_rows
    from emqx_tpu_torch.ops.walk_cuda import match_batch_auto

    router = broker.router
    auto, id_map, epoch = router.automaton()
    st = broker.helper.state(epoch, id_map)
    rows, live, pick = None, -1, -1
    for bi, batch in enumerate(batches):
        uniq = list(dict.fromkeys(batch))
        args, kw = router.walk_inputs(uniq)
        ids = mask_pad_rows(match_batch_auto(auto, *args, **kw).ids,
                            len(uniq))
        r, _ovf = rows_for_matches(st.bm, ids, mb=router.config.fanout_mb)
        n = int((r >= 0).sum())
        if n > live:
            rows, live, pick = r, n, bi
    if live <= 0:
        raise AssertionError("no slice batch matched a bitmap-path filter")
    bm = st.bm.bitmaps
    R, W = bm.shape
    B, mb = rows.shape
    err = check_or(bm, rows, f"main path rows (slice batch {pick}) B={B} "
                             f"mb={mb} R={R} W={W} ({live} live slots)")
    dense = torch.from_numpy(rng.integers(-1, st.bm.n_rows, size=(4096, 16))
                             .astype(np.int32)).to(bm.device)
    err = max(err, check_or(bm, dense, f"dense B=4096 mb=16 W={W} "
                                       f"({int((dense >= 0).sum())} live slots)"))
    ms = kernel_ms(lambda: or_bitmaps_cuda(bm, rows), "bitmap_or_kernel")
    plain_ms = time_cuda_ms(lambda: or_bitmaps_ref(bm, rows), iters=3, warmup=1)
    bound = or_bound_ms(R, W, B, mb, len(set(rows[rows >= 0].tolist())))
    d_ms = kernel_ms(lambda: or_bitmaps_cuda(bm, dense), "bitmap_or_kernel")
    d_plain = time_cuda_ms(lambda: or_bitmaps_ref(bm, dense), iters=3, warmup=1)
    d_bound = or_bound_ms(R, W, 4096, 16, st.bm.n_rows)
    log(f"[B2] main path rows B={B}: kernel {ms:.5f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound:.5f} ms (bytes) — {card}")
    log(f"[B2] dense B=4096 mb=16 W={W}: kernel {d_ms:.5f} ms, plain "
        f"{d_plain:.4f} ms, bound {d_bound:.5f} ms (bytes) — {card}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound}


def check_batches(broker, batches, deliveries):
    """Every batch's per-message (subscriber, filter) multisets against
    the port's TrieOracle: every local subscriber of every matched
    filter exactly once, one member per shared group, nothing else.
    ``batches`` holds ``(messages, results)`` pairs. Returns the count
    of checked deliveries that took the bitmap (big-filter) path."""
    from collections import Counter

    by_msg = {}
    for mid, sid, flt in deliveries:
        by_msg.setdefault(mid, Counter())[(sid, flt)] += 1
    big = {}
    n_big = 0
    for msgs, results in batches:
        for i, msg in enumerate(msgs):
            filters = broker.router.host_match(msg.topic)
            local = Counter()
            groups = []
            for f in filters:
                subs = broker.subscribers(f)
                for s in subs:
                    local[(s.sid, f)] += 1
                if big.setdefault(f, len(subs) > broker.helper.threshold):
                    n_big += len(subs)
                for route in broker.router.lookup_routes(f):
                    if isinstance(route.dest, tuple):
                        groups.append((route.dest[0], f))
            got = by_msg.get(msg.id, Counter())
            extra = got - local
            if local - got or len(extra) != len(groups) \
                    or sum(extra.values()) != len(groups):
                raise AssertionError(f"deliveries of {msg.topic!r} differ "
                                     f"from the oracle")
            for group, f in groups:
                members = {s.sid for s in broker.shared.subscribers(group, f)}
                if not any(sid in members for sid, ff in extra if ff == f):
                    raise AssertionError(f"shared group {group} of {f} missed")
            if results[i] != sum(local.values()) + len(groups):
                raise AssertionError(f"delivery count of {msg.topic!r}")
    return n_big


def phase_slice(broker, batches, card):
    """The timed main-path run; every count starts at 0 here."""
    from emqx_tpu_torch.ops import _build
    from emqx_tpu_torch.types import Message

    msgs = [[Message(topic=t, payload=b"x") for t in b] for b in batches]
    _build.reset_launches()
    lat, n_ovf, n_uniq = [], 0, 0
    split = np.zeros(3)  # begin (host + enqueue), fetch (+ wait), finish
    checks, big_rows = [], 0
    Sink.log = []
    for bi, batch in enumerate(msgs):
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        pb = broker.publish_begin(batch)
        if pb.done:
            raise AssertionError(f"batch {bi} did not take the device path")
        t1 = time.perf_counter()
        broker.publish_fetch(pb)
        t2 = time.perf_counter()
        res = broker.publish_finish(pb)
        t3 = time.perf_counter()
        lat.append(t3 - t0)
        split += (t1 - t0, t2 - t1, t3 - t2)
        for name in _build.KERNELS:
            if _build.LAUNCHES[name] <= before[name]:
                raise AssertionError(f"batch {bi} did not launch {name}")
        n_ovf += int(pb.ovf[:pb.n_uniq].sum())
        n_uniq += pb.n_uniq
        big_rows += int((pb.sel[:pb.n_uniq] >= 0).sum())
        checks.append((batch, res))
    launches = dict(_build.LAUNCHES)
    deliveries, Sink.log = Sink.log, None
    n_big = check_batches(broker, checks, deliveries)
    n_msgs = sum(len(b) for b in msgs)
    lat_ms = np.sort(np.array(lat) * 1e3)
    out = {
        "msgs_per_s": n_msgs / sum(lat),
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
        "overflow_row_share": n_ovf / max(1, n_uniq),
        "unique_per_batch": n_uniq / len(msgs),
        "launches": launches,
    }
    log(f"[slice] {len(msgs)} batches x {len(msgs[0])} msgs: "
        f"{out['msgs_per_s']:.1f} msgs/s, p50 {out['p50_ms']:.3f} ms, "
        f"p99 {out['p99_ms']:.3f} ms, overflow rows "
        f"{out['overflow_row_share']:.6f}, unique topics/batch "
        f"{out['unique_per_batch']:.1f}, launches {launches} — {card}")
    split_ms = split / len(msgs) * 1e3
    log(f"[slice] per batch: begin (encode, dedup, enqueue) "
        f"{split_ms[0]:.3f} ms, fetch (device wait, copy, plan) "
        f"{split_ms[1]:.3f} ms, finish (delivery tail) {split_ms[2]:.3f} ms"
        f" — {card}")
    out["split_ms"] = split_ms.tolist()
    log(f"[slice] all {n_msgs} messages: {len(deliveries)} deliveries "
        f"({n_big} through the bitmap path, {big_rows} union rows) match "
        f"the TrieOracle")
    return out


def phase_profile(broker, batches, card):
    """A few more batches under torch.profiler: device time by kernel
    and the device's idle share of the wall time (profiler overhead
    included). Runs after the counted run; it reports, never fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from emqx_tpu_torch.types import Message

    msgs = [[Message(topic=t, payload=b"x") for t in b] for b in batches]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in msgs:
            broker.publish_batch(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    events = [e for e in prof.key_averages() if _dev_us(e) > 0]
    busy_ms = sum(_dev_us(e) for e in events) / 1e3
    log(f"[profile] {len(msgs)} batches under the profiler: wall "
        f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
        f"{1 - busy_ms / wall_ms:.4f} — {card}")
    for e in sorted(events, key=_dev_us, reverse=True)[:10]:
        log(f"[profile]   {_dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")


def run(opts, device, card):
    """Phases 3-5 on ``device``; returns the kernel rows."""
    from emqx_tpu_torch.broker import Broker
    from emqx_tpu_torch.types import Message

    rng = np.random.default_rng(opts.seed)
    wl = make_workload(rng, opts.subs, opts.others, 8, 4096)
    broker = Broker(device=device)
    t0 = time.perf_counter()
    sinks, draw = subscribe_all(broker, wl, rng)
    sub_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    broker.router.automaton()
    rebuild_s = time.perf_counter() - t0
    topics = zipf_topics(rng, draw, opts.batch * (opts.batches + 1))
    t0 = time.perf_counter()
    broker.publish_batch([Message(topic=t) for t in topics[:opts.batch]])
    first_s = time.perf_counter() - t0
    log(f"[setup] {len(sinks)} subscribers, "
        f"{len(broker.router._filter_ids)} filters: subscribe "
        f"{sub_s:.1f} s, rebuild {rebuild_s:.1f} s, first batch "
        f"(fan-out tables) {first_s:.1f} s — {card}")
    batches = [topics[(i + 1) * opts.batch:(i + 2) * opts.batch]
               for i in range(opts.batches)]
    walk = phase_walk(broker, topics[:opts.batch], rng, card)
    bmp = phase_bitmap(broker, batches, rng, card)
    sl = phase_slice(broker, batches, card)
    phase_profile(broker, batches[:3], card)
    return [
        {"name": "walk", "route": "cuda",
         "source": "emqx_tpu_torch/csrc/walk.cu",
         "replaces": "emqx_tpu/ops/walk_pallas.py:87",
         "launches": sl["launches"]["walk"], "equal": True,
         "bound_by": "bytes", "library_ms": None, **walk},
        {"name": "bitmap_or", "route": "cuda",
         "source": "emqx_tpu_torch/csrc/bitmap_or.cu",
         "replaces": "emqx_tpu/ops/bitmap.py:199",
         "launches": sl["launches"]["bitmap_or"], "equal": True,
         "bound_by": "bytes", "library_ms": None, **bmp},
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--subs", type=int, default=1_000_000,
                    help="'+' subscriptions (BASELINE config 2: 1M)")
    ap.add_argument("--others", type=int, default=10_000,
                    help="literal, '#' and $share subscriptions each")
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    opts = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import emqx_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the emqx_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    card = phase_env()
    phase_build(card)
    rows = run(opts, "cuda", card)
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
