"""Device resolution for every entry point of the port.

The default device is ``"cuda"``. A caller that wants the CPU says so
(``device="cpu"``); a missing CUDA runtime is an error, never a silent
move to the CPU.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The ``torch.device`` an entry point runs on (``None`` = cuda).

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "emqx_tpu_torch: CUDA is not available on this host; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"emqx_tpu_torch: unsupported device {dev}")
    return dev
