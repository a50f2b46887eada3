"""Build the port's CUDA kernels at first use and bind them.

``csrc/walk.cu`` and ``csrc/bitmap_or.cu`` expose a plain C interface
and include no PyTorch header. :func:`build` compiles both with
``torch.utils.cpp_extension.load`` — ``nvcc`` for ``sm_90a``, one
compiler process per source run side by side by ninja — into one
shared library under ``emqx_tpu_torch/_build/`` (listed in
``.gitignore``); ``load`` rebuilds when a source changes. The library
is then bound with ``ctypes``. Nothing here runs at import time: the
first wrapper call on a CUDA tensor builds, and a CPU-only run never
needs ``nvcc``.

``LAUNCHES`` counts kernel launches per kernel; each wrapper adds one
where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("walk", "bitmap_or")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3", "-Xptxas=-v"]

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build(verbose: bool = False) -> float:
    """Compile (or find up to date) the kernel library; returns the
    seconds it took. ``verbose`` prints the compiler's output,
    including ptxas' register and spill report. Raises with the
    compiler's output when the build fails."""
    global _lib
    from torch.utils.cpp_extension import load

    with _lock:
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        saved_path = os.environ.get("PATH", "")
        if shutil.which("ninja") is None:
            # load() runs `ninja` from PATH; a pip-installed ninja sits
            # beside the interpreter even when its bin/ is not on PATH.
            # PATH is widened for the build only and restored after it.
            here = os.path.dirname(sys.executable)
            if os.path.exists(os.path.join(here, "ninja")):
                os.environ["PATH"] = here + os.pathsep + saved_path
        try:
            path = load(name="emqx_tpu_torch_kernels",
                        sources=[str(CSRC / f"{k}.cu") for k in KERNELS],
                        extra_cuda_cflags=NVCC_FLAGS,
                        build_directory=str(BUILD_DIR),
                        is_python_module=False, verbose=verbose)
        finally:
            os.environ["PATH"] = saved_path
        lib = ctypes.CDLL(path)
        ptr3, i4 = [ctypes.c_void_p] * 3, [ctypes.c_int] * 4
        for fn, args in (
                (lib.emqx_walk, [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7),
                (lib.emqx_bitmap_or, ptr3 + i4)):
            fn.argtypes = args + [ctypes.c_void_p]  # + the stream
            fn.restype = ctypes.c_int
        lib.emqx_cuda_error.argtypes = [ctypes.c_int]
        lib.emqx_cuda_error.restype = ctypes.c_char_p
        _lib = lib
        return time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    if _lib is None:
        build()
    return _lib


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.emqx_cuda_error(rc).decode(errors="replace")
        raise RuntimeError(f"emqx_tpu_torch: {name} kernel launch failed: "
                           f"{msg} (cudaError {rc})")
