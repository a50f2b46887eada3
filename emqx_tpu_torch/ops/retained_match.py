"""Batched retained-name matching (kernel B3): the subscribe-path
counterpart of the publish walk.

The retained index (:class:`emqx_tpu_torch.modules.retainer.RetainIndex`)
keeps stored topic names as a ``[cap, L]`` word-id matrix; a subscribe
burst encodes its filters as ``[F, L]`` and matches every filter
against every stored name in one elementwise pass (per level: equality
or ``+``; a ``#`` suffix relaxes the depth check; root wildcards never
match ``$`` names), giving an ``[F, cap]`` bool hit matrix.

:func:`match_names_many` is the plain PyTorch version, a step-by-step
twin of the JAX package's ``_match_many_body`` with one ``[F, cap]``
accumulator over the ``L`` levels. :func:`match_names_cuda` launches
the hand-written CUDA kernel (``csrc/retained_match.cu``), which
replaces the Pallas ``emqx_tpu/ops/retained_match.py::_retained_kernel``.
:func:`match_names_auto` picks by the device of the tensors it is
given: CUDA tensors launch the kernel (or raise), CPU tensors run the
plain version. A kernel with one name per thread is held by
instruction issue, not by its bytes; this one takes four names per
thread, so each shared-memory read of a pre-digested filter serves
four names and each filter's four results go out as one 32-bit store.
"""

from __future__ import annotations

import ctypes

import torch

from emqx_tpu_torch.ops import _build

#: '+' in an encoded FILTER row; never collides with stored word ids
#: (>= 0) or the topic-side UNKNOWN (-1) / PAD (-2)
PLUS_ID = -3

#: levels of a stored name the kernel takes (RetainIndex.L)
KERNEL_LEVELS = 16


def match_names_many(fw: torch.Tensor, fn: torch.Tensor,
                     has_hash: torch.Tensor, topic_ids: torch.Tensor,
                     n_words: torch.Tensor,
                     sys_mask: torch.Tensor) -> torch.Tensor:
    """``[F, L]`` filters against ``[cap, L]`` names → ``[F, cap]`` bool.

    ``fw`` filter word ids (``PLUS_ID`` for ``+``, PAD beyond ``fn``),
    ``fn`` per-filter word count without a trailing ``#``,
    ``has_hash`` the trailing-``#`` flag. A dead name row
    (``n_words == 0``) and a padding filter row (``fn == 0``, no
    ``#``) match nothing through the ``n > 0`` gate."""
    L = topic_ids.shape[1]
    fnc = fn[:, None]
    ok = torch.ones((fw.shape[0], topic_ids.shape[0]), dtype=torch.bool,
                    device=topic_ids.device)
    for lvl in range(L):
        w = fw[:, lvl][:, None]
        ok &= ((topic_ids[:, lvl][None, :] == w) | (w == PLUS_ID)
               | (lvl >= fnc))
    nw = n_words[None, :]
    exact = ok & (nw == fnc)
    deeper = has_hash[:, None] & ok & (nw >= fnc)
    hit = (exact | deeper) & (nw > 0)
    root_wild = (fw[:, 0] == PLUS_ID) | (has_hash & (fn == 0))
    return hit & ~(sys_mask[None, :] & root_wild[:, None])


def match_names_cuda(fw: torch.Tensor, fn: torch.Tensor,
                     has_hash: torch.Tensor, topic_ids: torch.Tensor,
                     n_words: torch.Tensor,
                     sys_mask: torch.Tensor) -> torch.Tensor:
    """Launch kernel B3: same arguments and result as
    :func:`match_names_many`. ``fw``/``topic_ids`` int32 with
    ``L = 16`` columns, ``fn``/``n_words`` int32, ``has_hash``/
    ``sys_mask`` bool. Raises on anything the kernel does not take, or
    when the launch fails."""
    tensors = (fw, fn, has_hash, topic_ids, n_words, sys_mask)
    dev = topic_ids.device
    if any(not t.is_cuda or t.device != dev for t in tensors):
        raise ValueError("match_names_cuda: every tensor must lie on one "
                         "CUDA device")
    if any(t.dtype != torch.int32 for t in (fw, fn, topic_ids, n_words)) \
            or has_hash.dtype != torch.bool or sys_mask.dtype != torch.bool:
        raise TypeError("match_names_cuda: int32 words and counts, bool "
                        "flags")
    F, L = fw.shape
    cap = topic_ids.shape[0]
    if L != KERNEL_LEVELS or topic_ids.shape[1] != L \
            or fn.shape != (F,) or has_hash.shape != (F,) \
            or n_words.shape != (cap,) or sys_mask.shape != (cap,):
        raise ValueError(
            f"match_names_cuda: shapes fw {tuple(fw.shape)}, ids "
            f"{tuple(topic_ids.shape)} (L must be {KERNEL_LEVELS})")
    tensors = [t.contiguous() for t in tensors]
    if tensors[3].data_ptr() % 16:
        raise ValueError("match_names_cuda: name rows must be 16-byte "
                         "aligned")
    out = torch.empty((F, cap), dtype=torch.bool, device=dev)
    if F and cap:
        lib = _build.library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.emqx_retained_match(
            *(ctypes.c_void_p(t.data_ptr()) for t in tensors + [out]),
            F, cap, L, ctypes.c_void_p(stream))
        _build.check(lib, rc, "retained_match")
        _build.count_launch("retained_match")
    return out


def match_names_auto(fw, fn, has_hash, topic_ids, n_words, sys_mask):
    """Kernel B3 on CUDA tensors, the plain version on CPU tensors."""
    fun = match_names_cuda if topic_ids.is_cuda else match_names_many
    return fun(fw, fn, has_hash, topic_ids, n_words, sys_mask)
