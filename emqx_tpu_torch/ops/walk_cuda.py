"""Kernel B1 behind :func:`match_batch_auto` — the walk's dispatch seam.

:func:`match_batch_cuda` launches the hand-written CUDA walk
(``csrc/walk.cu``, replacing the Pallas
``emqx_tpu/ops/walk_pallas.py::_walk_kernel``), which writes the raw
emit slots ``[B, steps, 2k]`` and the per-topic overflow; the
``pack_ids`` tail is the torch code the plain walk shares
(:func:`~emqx_tpu_torch.ops.match.finish`). Same signature and
byte-identical :class:`~emqx_tpu_torch.ops.match.MatchResult` as the
plain :func:`~emqx_tpu_torch.ops.match.match_batch`.

:func:`match_batch_auto` picks by the device of the tensors it is
given — CUDA tensors launch the kernel (or raise), CPU tensors run the
plain walk. There is no environment switch and no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from emqx_tpu_torch.ops import _build
from emqx_tpu_torch.ops.csr import MAX_TAKE, NARROW_SLOT, WIDE_SLOT
from emqx_tpu_torch.ops.match import (_LVL_MASK, MatchResult, finish,
                                      match_batch)

#: frontier capacity one warp holds (two slots per lane)
MAX_K = 64


def match_batch_cuda(
    auto,
    word_ids: torch.Tensor,
    n_words: torch.Tensor,
    sys_mask: torch.Tensor,
    *,
    k: int = 16,
    m: int = 64,
    steps: Optional[int] = None,
    slots: int = 2,
    take: int = 1,
    pack_ids: bool = True,
) -> MatchResult:
    """Launch kernel B1 on CUDA tensors (see module doc)."""
    B, L = word_ids.shape
    if steps is None:
        steps = L + 1
    wide = take > 1
    if wide and L > _LVL_MASK:
        raise ValueError(
            f"wide walk supports at most {_LVL_MASK} levels, got {L}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"walk kernel supports 1 <= k <= {MAX_K}, got {k}")
    if take > MAX_TAKE:
        raise ValueError(f"walk kernel supports take <= {MAX_TAKE}")
    dev = word_ids.device
    tensors = (word_ids, n_words, sys_mask, auto.wt, auto.wt_seed,
               auto.node2)
    if any(not t.is_cuda or t.device != dev for t in tensors):
        raise ValueError("match_batch_cuda: every tensor must lie on one "
                         "CUDA device")
    sw = WIDE_SLOT if wide else NARROW_SLOT
    nb = auto.wt.shape[0]
    if auto.wt.shape[1] != slots * sw or nb & (nb - 1):
        raise ValueError(f"match_batch_cuda: wt {tuple(auto.wt.shape)} "
                         f"does not hold {slots} slots of {sw} ints in a "
                         f"power-of-two bucket count")
    if any(t.dtype != torch.int32 for t in (auto.wt, auto.wt_seed,
                                             auto.node2)):
        raise TypeError("match_batch_cuda: walk tables must be int32")
    wt = auto.wt.contiguous()
    node2 = auto.node2.contiguous()
    if wt.data_ptr() % 16 or node2.data_ptr() % 16:
        raise ValueError("match_batch_cuda: tables must be 16-byte aligned")
    words = word_ids.to(torch.int32).contiguous()
    n = n_words.to(torch.int32).contiguous()
    sysm = sys_mask.to(torch.int32).contiguous()
    emits = torch.empty((B, steps, 2 * k), dtype=torch.int32, device=dev)
    ovf = torch.zeros((B,), dtype=torch.int32, device=dev)
    if B and steps:
        lib = _build.library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.emqx_walk(
            *(ctypes.c_void_p(t.data_ptr()) for t in (
                words, n, sysm, auto.wt_seed, wt, node2, emits, ovf)),
            B, L, k, steps, slots, take, nb, ctypes.c_void_p(stream))
        _build.check(lib, rc, "walk")
        _build.LAUNCHES["walk"] += 1
    return finish(emits, ovf > 0, n, m, pack_ids)


def match_batch_auto(auto, word_ids, n_words, sys_mask, *, k=16, m=64,
                     steps=None, slots=2, take=1,
                     pack_ids=True) -> MatchResult:
    """Kernel B1 on CUDA tensors, the plain walk on CPU tensors."""
    fn = match_batch_cuda if word_ids.is_cuda else match_batch
    return fn(auto, word_ids, n_words, sys_mask, k=k, m=m, steps=steps,
              slots=slots, take=take, pack_ids=pack_ids)
