"""Device mesh construction for the broker.

The port of the JAX package's ``parallel/mesh.py``. Two mesh axes,
mirroring the reference's two scale dimensions:

  - ``data``: publish-batch sharding — the analogue of EMQX's hashed
    broker/router worker pools (each worker handles a slice of
    traffic, src/emqx_broker.erl:428-429);
  - ``trie``: subscription-table sharding — the analogue of topic
    shards + replicated Mnesia tables (src/emqx_broker_helper.erl:
    82-92, src/emqx_router.erl:77-86): each device holds a slice of
    the filter set and match results are gathered over the axis.

A :class:`Mesh` is a ``[n_data, n_trie]`` grid of ``torch.device``.
A grid may name one device more than once: every cell then runs its
own walk and every collective runs, as tensor ops on that device —
the counterpart of the JAX package's virtual CPU devices. With several
processes (:mod:`.distributed`) each cell also carries the rank of the
process that owns it; a process runs only its own cells.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def cuda_devices() -> list:
    """Every visible CUDA device; raises without CUDA (a mesh of CPU
    devices is something the caller asks for by passing them)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "emqx_tpu_torch: CUDA is not available on this host; pass "
            "devices=['cpu', ...] to build a mesh of CPU devices")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def _device(d) -> torch.device:
    """``d`` as a ``torch.device``; a bare ``"cuda"`` names device 0,
    so equal devices compare (and hash) equal."""
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None \
        else d


class Mesh:
    """A ``[n_data, n_trie]`` grid of torch devices with the axis names
    ``("data", "trie")``; ``shape`` reads as the JAX mesh's does
    (``mesh.shape["trie"]``).

    ``ranks`` (same grid shape) names the process owning each cell and
    ``rank`` this process (both 0 in one process). A data row's cells
    must share one process: the trie axis gathers match ids every step
    and stays inside a process, and only the ``data`` sums cross
    processes."""

    axis_names = ("data", "trie")

    def __init__(self, devices: Sequence[Sequence], ranks=None,
                 rank: int = 0) -> None:
        grid = tuple(tuple(_device(d) for d in row) for row in devices)
        if not grid or not grid[0] or len({len(r) for r in grid}) != 1:
            raise ValueError("a mesh is a non-empty rectangular grid")
        if ranks is None:
            ranks = [[0] * len(grid[0]) for _ in grid]
        ranks = tuple(tuple(int(x) for x in row) for row in ranks)
        if [len(r) for r in ranks] != [len(r) for r in grid]:
            raise ValueError("ranks must have the grid's shape")
        for i, row in enumerate(ranks):
            if len(set(row)) != 1:
                raise ValueError(
                    f"data row {i} spans processes {sorted(set(row))}: "
                    f"the trie axis must stay inside one process")
        self.devices = grid
        self.ranks = ranks
        self.rank = int(rank)
        self.shape = {"data": len(grid), "trie": len(grid[0])}
        self.size = len(grid) * len(grid[0])

    @property
    def n_processes(self) -> int:
        return len({r for row in self.ranks for r in row})

    def local_data(self) -> list:
        """The data rows this process runs (all of them in one
        process)."""
        return [i for i, row in enumerate(self.ranks) if row[0] == self.rank]

    def cells(self):
        """``(i, t, device)`` of every cell this process runs, in
        row-major order."""
        for i in self.local_data():
            for t, dev in enumerate(self.devices[i]):
                yield i, t, dev

    @property
    def home(self) -> torch.device:
        """The device of this process's first cell: where the step's
        outputs are assembled."""
        i = self.local_data()[0]
        return self.devices[i][0]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, trie="
                f"{self.shape['trie']}, devices="
                f"{[[str(d) for d in r] for r in self.devices]})")


def make_mesh(n_data: int, n_trie: int,
              devices: Optional[Sequence] = None) -> Mesh:
    """An ``n_data × n_trie`` mesh over the first ``n_data·n_trie`` of
    ``devices`` (every visible CUDA device by default)."""
    devs = list(devices) if devices is not None else cuda_devices()
    need = n_data * n_trie
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    return Mesh([devs[i * n_trie:(i + 1) * n_trie] for i in range(n_data)])


def default_mesh(n_devices: Optional[int] = None,
                 devices: Optional[Sequence] = None) -> Mesh:
    """Prefer sharding the batch; put leftover factor on the trie axis.

    For n a power of two: (n, 1) for n ≤ 2 else (n // 2, 2) — both
    axes exercised whenever possible."""
    devs = list(devices) if devices is not None else cuda_devices()
    n = n_devices if n_devices is not None else len(devs)
    if n <= 2:
        return make_mesh(n, 1, devs)
    return make_mesh(n // 2, 2, devs)
