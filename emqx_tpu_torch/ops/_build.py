"""Build the port's CUDA kernels at first use and bind them.

``csrc/walk.cu``, ``csrc/bitmap_or.cu``, ``csrc/bitmap_or_dense.cu``
and ``csrc/retained_match.cu`` expose a plain C interface and include
no PyTorch header. :func:`build` compiles all four with
``torch.utils.cpp_extension.load`` — ``nvcc`` for ``sm_90a``, one
compiler process per source run side by side by ninja — into one
shared library under ``emqx_tpu_torch/_build/`` (listed in
``.gitignore``); ``load`` rebuilds when a source changes. The library
is then bound with ``ctypes``. Nothing here runs at import time: the
first wrapper call on a CUDA tensor builds, and a CPU-only run never
needs ``nvcc``.

The host library (``csrc/host_native.cpp``: the word table, the trie,
its flatten, the batch encoder and the frame scanner) is plain C++ and
needs no CUDA: :func:`build_host` compiles it with ``g++`` into the same
directory, so a CPU-only run needs ``g++`` and nothing else. The CUDA
build lists its sources by name and never picks up the ``.cpp``.

``LAUNCHES`` counts kernel launches per kernel; each wrapper adds one
(:func:`count_launch`, under a lock: a multi-loop node launches B3
from its peer loops' threads) where it launches its kernel, and
nowhere else. ``or_bitmaps`` counts
the launches of the dense bitmap-OR kernel made through B4's entry point
(:func:`emqx_tpu_torch.ops.bitmap.or_bitmaps`), which
``bitmap_or_dense`` counts too.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("walk", "bitmap_or", "bitmap_or_dense", "retained_match")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3", "-Xptxas=-v"]
HOST_SRC = CSRC / "host_native.cpp"
HOST_LIB = BUILD_DIR / "libemqx_host.so"
HOST_CXX = ["g++", "-O2", "-fPIC", "-std=c++17", "-shared"]

#: launches per kernel since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS + ("or_bitmaps",), 0)

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name``: a read-modify-write of the
    module's current ``LAUNCHES`` under a lock, exact whatever thread
    launches."""
    with _count_lock:
        LAUNCHES[name] += 1


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
        for fn, args in (
                (lib.emqx_walk, [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7),
                (lib.emqx_bitmap_or, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5),
                (lib.emqx_bitmap_or_dense,
                 [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4),
                (lib.emqx_retained_match,
                 [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3)):
            fn.argtypes = args + [ctypes.c_void_p]  # + the stream
            fn.restype = ctypes.c_int
        lib.emqx_cuda_error.argtypes = [ctypes.c_int]
        lib.emqx_cuda_error.restype = ctypes.c_char_p
        _lib = lib
        return time.perf_counter() - t0


def build_host(src: Optional[Path] = None,
               lib: Optional[Path] = None) -> float:
    """Compile the host library ``src`` (default :data:`HOST_SRC`) into
    ``lib`` (default :data:`HOST_LIB`) when ``lib`` is missing or older
    than ``src``; returns the seconds it took. Processes building at
    once serialize on a file lock beside ``lib``; the compiler writes a
    private temporary file that is renamed over ``lib`` in one step, so
    a reader never maps a half-written library. Raises with the
    compiler's output when the build fails."""
    src = Path(src or HOST_SRC)
    lib = Path(lib or HOST_LIB)
    t0 = time.perf_counter()
    lib.parent.mkdir(parents=True, exist_ok=True)
    with open(lib.parent / (lib.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.exists() and \
                    lib.stat().st_mtime >= src.stat().st_mtime:
                return time.perf_counter() - t0
            tmp = lib.with_name(f".{lib.name}.{os.getpid()}."
                                f"{threading.get_ident()}.tmp")
            try:
                r = subprocess.run([*HOST_CXX, "-o", str(tmp), str(src)],
                                   capture_output=True, text=True)
            except OSError as e:  # no compiler on PATH
                raise RuntimeError(f"emqx_tpu_torch: cannot run "
                                   f"{HOST_CXX[0]}: {e}") from e
            if r.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"emqx_tpu_torch: host library build failed "
                    f"({HOST_CXX[0]} exit {r.returncode}):\n"
                    f"{r.stdout}{r.stderr}")
            os.replace(tmp, lib)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
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
