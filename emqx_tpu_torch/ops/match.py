"""The NFA-walk topic matcher — the plain PyTorch version of kernel B1.

A step-by-step twin of the JAX package's lax walk
(``emqx_tpu/ops/match.py:148-323``): same signature, same
:class:`MatchResult`, byte-identical output for both table layouts,
``pack_ids`` on and off and any ``k``/``m``/``steps``/``slots``/
``take``. It runs where the caller's tensors lie on the CPU (the
tests), and ``chip_smoke.py`` holds the CUDA kernel
(:mod:`.walk_cuda`) against it on the card.

  - a publish batch ``[B, L]`` of interned word ids walks the
    compressed tables (:mod:`emqx_tpu_torch.ops.csr`) one hop at a
    time, the batch axis written out instead of ``vmap``;
  - the active set (≤ k lanes) advances by literal edges (one 2-choice
    bucket probe pair per lane per hop) and ``+`` edges; ``#``
    terminals emit at every reached state, exact terminals at the end
    of the topic;
  - in the **wide** layout an edge consumes up to ``take`` words per
    hop and its inline chain words are compared exactly; the lane word
    packs ``state << 5 | level``;
  - ``$``-rooted topics suppress root wildcards;
  - overflowing topics (active set > k, matches > m, levels > L, or
    lanes left after the last hop) are flagged for the exact host
    re-match, never truncated silently.

``hash_mix`` needs uint32 wraparound; torch's ``uint32`` lacks ``+``
and ``>>`` on the CPU, so it is computed in int64 masked to 32 bits,
with each 32×32-bit product split so that no int64 product overflows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from emqx_tpu_torch.ops.csr import NARROW_SLOT, WIDE_SLOT

#: bits of the packed lane word reserved for the carried level
#: (wide mode): packed = state * 32 + level, level ≤ 31
_LVL_BITS = 5
_LVL_MASK = (1 << _LVL_BITS) - 1
_M32 = 0xFFFFFFFF


class MatchResult(NamedTuple):
    ids: torch.Tensor       # int32[B, M] matched filter ids, -1 padded
    count: torch.Tensor     # int32[B] number of valid ids (clamped to M)
    overflow: torch.Tensor  # bool[B] — host re-match required


def walk_params(host_auto, lb: int) -> dict:
    """Static kernel parameters for a batch sliced to ``lb`` levels
    (read from the host automaton: ``wt_slots``/``wt_take`` are
    ints, ``hops_for_level`` a host array)."""
    hl = host_auto.hops_for_level
    steps = int(hl[min(lb, len(hl) - 1)])
    return {"steps": steps, "slots": int(host_auto.wt_slots),
            "take": int(host_auto.wt_take)}


def depth_bucket(word_ids, n_words, min_levels: int = 2):
    """Slice the level axis to exactly the batch's deepest topic
    (host numpy arrays, before the device copy). Topics flagged
    too-deep (``n_words < 0``) stay on the overflow path."""
    L = word_ids.shape[1]
    max_n = int(np.max(n_words)) if n_words.size else 0
    lb = min(max(max_n, min_levels, 1), L)
    return word_ids[:, :lb], n_words


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2**32`` for int64 ``a`` in ``[0, 2**32)``: the
    product is split at 16 bits so no int64 intermediate overflows."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def hash_mix(state: torch.Tensor, word: torch.Tensor, seed):
    """The builder's ``(state, word) → (h1, h2)`` mix
    (``csr.hash_mix``), bit for bit, on int64 tensors holding the
    uint32 values (negative inputs are taken mod 2**32)."""
    s = state & _M32
    w = word & _M32
    h = (_mul32(s, 0x9E3779B9) + _mul32(w, 0x85EBCA6B) + seed) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h2 = _mul32(h, 0x846CA68B)
    h2 = h2 ^ (h2 >> 16)
    return h, h2


def _compact(cands: torch.Tensor, k: int):
    """Compact candidate lanes ``[B, n]`` (-1 invalid) into ``[B, k]``
    plus a per-row overflow flag — the lax walk's ``_compact``.

    n ≤ 32: a descending sort (the lax walk's Batcher network sorts
    the padded lanes; any sort gives the same sequence). Wider sets:
    the order-preserving pack of the valid lanes."""
    B, n = cands.shape
    valid = cands >= 0
    count = valid.sum(dim=1)
    if n <= 32:
        packed = torch.sort(cands, dim=1, descending=True).values[:, :k]
    else:
        pos = torch.cumsum(valid, dim=1) - 1
        idx = torch.where(valid & (pos < k), pos, k)
        packed = torch.full((B, k + 1), -1, dtype=cands.dtype,
                            device=cands.device).scatter_(
            1, idx, cands)[:, :k]
    return packed, count > k


def finish(emits: torch.Tensor, ovf: torch.Tensor, n_words: torch.Tensor,
           m: int, pack_ids: bool) -> MatchResult:
    """The walk's tail, shared by the plain walk and the CUDA kernel
    (``walk_pallas.py:301-322``): raw emit slots ``[B, steps, 2k]`` →
    :class:`MatchResult`, packed into ``m`` slots or left raw."""
    B = emits.shape[0]
    flat = emits.reshape(B, emits.shape[1] * emits.shape[2])
    valid = flat >= 0
    cnt = valid.sum(dim=1, dtype=torch.int32)
    too_long = n_words < 0
    if pack_ids:
        pos = torch.cumsum(valid, dim=1) - 1
        idx = torch.where(valid & (pos < m), pos, m)
        ids = torch.full((B, m + 1), -1, dtype=torch.int32,
                         device=flat.device).scatter_(1, idx, flat)[:, :m]
        return MatchResult(
            ids=torch.where(too_long[:, None], -1, ids),
            count=torch.where(too_long, 0,
                              torch.clamp(cnt, max=m)).to(torch.int32),
            overflow=ovf | (cnt > m) | too_long,
        )
    # raw slots: nothing can truncate, so m never overflows
    return MatchResult(
        ids=torch.where(too_long[:, None], -1, flat),
        count=torch.where(too_long, 0, cnt).to(torch.int32),
        overflow=ovf | too_long,
    )


def match_batch(
    auto,
    word_ids: torch.Tensor,   # int32[B, L]
    n_words: torch.Tensor,    # int32[B] (-1 = too many levels → overflow)
    sys_mask: torch.Tensor,   # bool[B]
    *,
    k: int = 16,
    m: int = 64,
    steps: Optional[int] = None,
    slots: int = 2,
    take: int = 1,
    pack_ids: bool = True,
) -> MatchResult:
    """Match a publish batch against the walk tables (module doc).

    ``pack_ids=False`` returns the RAW emit slots ``[B, steps*2k]``
    (-1 holes) — the main path feeds them to the global pack."""
    B, L = word_ids.shape
    if steps is None:
        steps = L + 1
    wide = take > 1
    if wide and L > _LVL_MASK:
        # the packed lane word carries the level in _LVL_BITS bits
        raise ValueError(
            f"wide walk supports at most {_LVL_MASK} levels, got {L}")
    sw = WIDE_SLOT if wide else NARROW_SLOT
    dev = word_ids.device
    nb = auto.wt.shape[0]
    seed = auto.wt_seed.to(torch.int64) & _M32
    words = word_ids.to(torch.int64)
    n = n_words.to(torch.int64)[:, None]           # [B, 1]
    n3 = n[:, :, None]
    is_sys = sys_mask.to(torch.bool)[:, None]
    rows_b = torch.arange(B, device=dev)[:, None]
    if wide:
        # word windows win_mat[b, l] = words[b, l : l+take], -2 past
        # the topic (the probe key word + the chain-compare window)
        wp = torch.cat([words, torch.full((B, take), -2, dtype=torch.int64,
                                          device=dev)], dim=1)
        win_mat = wp.unfold(1, take, 1)[:, :L]    # [B, L, take]
    else:
        # narrow: level == step for every lane; -2 past the topic
        pad = max(steps - L, 0)
        words_ext = torch.cat([words, torch.full(
            (B, pad), -2, dtype=torch.int64, device=dev)], dim=1)

    def rows_at(b):
        return auto.wt[b].view(B, k, slots, sw).to(torch.int64)

    def probe_narrow(state, word, b):
        row = rows_at(b)
        hit = (row[..., 0] == state[..., None]) & (
            row[..., 1] == word[..., None])
        return torch.where(hit, row[..., 2], -1).amax(dim=-1)

    def probe_wide(state, lvl, win, b):
        row = rows_at(b)
        stake = row[..., 2]
        hit = (row[..., 0] == state[..., None]) & (
            row[..., 1] == win[..., None, 0])
        # exact chain verify: every consumed word beyond the first
        # must equal the inline chain word
        for i in range(take - 1):
            hit &= (stake <= i + 1) | (
                row[..., 4 + i] == win[..., None, 1 + i])
        hit &= lvl[..., None] + stake <= n3
        child = torch.where(hit, row[..., 3], -1).amax(dim=-1)
        adv = torch.where(hit, stake, 0).amax(dim=-1)
        return child, adv

    active = torch.full((B, k), -1, dtype=torch.int64, device=dev)
    active[:, 0] = 0
    ovf = torch.zeros(B, dtype=torch.bool, device=dev)
    emits = []
    for s in range(steps):
        if wide:
            state = torch.where(active >= 0, active >> _LVL_BITS, -1)
            lvl = active & _LVL_MASK
        else:
            state = active
            w0 = words_ext[:, s:s + 1].expand(B, k)
        alive = state >= 0
        node = auto.node2[torch.clamp(state, min=0)].to(torch.int64)
        plus_col, hashf_col, endf_col = (
            node[..., 0], node[..., 1], node[..., 2])
        if wide:
            at_root_sys = (active == 0) & is_sys
            walking = alive & (lvl < n)
            ending = alive & (lvl == n)
        else:
            at_root_sys = (is_sys & alive) if s == 0 else \
                torch.zeros_like(alive)
            walking = alive & (s < n)
            ending = alive & (s == n)
        # '#'-child terminals at every reached state (match_#),
        # exact terminals at end-of-topic
        emit_h = torch.where(
            (walking | ending) & ~at_root_sys, hashf_col, -1)
        emit_e = torch.where(ending, endf_col, -1)

        if wide:
            win = win_mat[rows_b, torch.clamp(lvl, max=L - 1)]
            w0 = win[..., 0]
        h1, h2 = hash_mix(state, w0, seed)
        b1 = h1 & (nb - 1)
        b2 = h2 & (nb - 1)
        if wide:
            c1, a1 = probe_wide(state, lvl, win, b1)
            c2, a2 = probe_wide(state, lvl, win, b2)
            child = torch.maximum(c1, c2)
            adv = torch.maximum(a1, a2)
            lit_ok = walking & (w0 >= 0) & (child >= 0)
            lit = torch.where(
                lit_ok, (child << _LVL_BITS) | (lvl + adv), -1)
            plus_ok = walking & ~at_root_sys & (plus_col >= 0)
            plus = torch.where(
                plus_ok,
                (torch.clamp(plus_col, min=0) << _LVL_BITS) | (lvl + 1),
                -1)
        else:
            lit = torch.maximum(probe_narrow(state, w0, b1),
                                probe_narrow(state, w0, b2))
            lit = torch.where(walking & (w0 >= 0), lit, -1)
            plus = torch.where(walking & ~at_root_sys, plus_col, -1)
        active, over = _compact(torch.cat([lit, plus], dim=1), k)
        ovf |= over
        emits.append(torch.cat([emit_h, emit_e], dim=1))
    # lanes still alive after the last step were produced but never
    # processed — their emits are missing: flag for the host re-match
    if wide:
        r_lvl = active & _LVL_MASK
        ovf |= ((active >= 0) & (r_lvl <= n)).any(dim=1)
    else:
        ovf |= ((active >= 0) & (steps <= n)).any(dim=1)
    if emits:
        em = torch.stack(emits, dim=1).to(torch.int32)
    else:
        em = torch.empty((B, 0, 2 * k), dtype=torch.int32, device=dev)
    return finish(em, ovf, n_words.to(torch.int32), m, pack_ids)
