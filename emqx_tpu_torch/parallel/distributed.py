"""Multi-process bring-up: the ``torch.distributed`` control plane.

The port of the JAX package's ``parallel/distributed.py``. The
reference's cluster substrate is ekka membership + the gen_rpc data
plane; here the split is:

  - **host control plane** — the cluster modules (membership,
    replication, takeover) over their socket transport, as on one host;
  - **device data plane** — a global mesh spanning every process's
    devices. ``torch.distributed`` has no single controller: each
    process runs the cells of the mesh on its own devices
    (:class:`~emqx_tpu_torch.parallel.mesh.Mesh` ``ranks``), and a
    collective whose axis crosses processes goes through it (``gloo``
    for CPU devices, ``nccl`` for CUDA ones). The ``data`` axis is the
    one that crosses processes: publish batches shard cleanly there,
    and only the step's counters are summed over it; the ``trie``
    axis, which gathers match ids every step, stays inside a process.

A single-process call is a no-op (the common single-host case); a
multi-process call joins the process group and :func:`global_mesh`
returns the mesh over every process's devices.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import torch

from emqx_tpu_torch.parallel.mesh import Mesh, cuda_devices, default_mesh

log = logging.getLogger("emqx_tpu_torch.distributed")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: int = 1,
               process_id: int = 0,
               device: Optional[str] = None) -> bool:
    """Join the process group.

    Single-process (``num_processes == 1``) is a no-op returning False.
    Multi-process: every process calls this with the same
    ``coordinator_address`` (``host:port``, served by process 0) before
    the first step; the backend is ``gloo`` when ``device`` is the CPU,
    ``nccl`` for CUDA (the default, which needs CUDA)."""
    if num_processes <= 1:
        return False
    if coordinator_address is None:
        raise ValueError("multi-process init needs coordinator_address")
    import torch.distributed as dist

    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("emqx_tpu_torch: nccl needs CUDA; pass "
                           "device='cpu' for a gloo process group")
    dist.init_process_group(
        backend="gloo" if dev.type == "cpu" else "nccl",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    log.info("joined the process group: process %d/%d via %s",
             process_id, num_processes, coordinator_address)
    return True


def _world():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_mesh(n_data: Optional[int] = None,
                n_trie: Optional[int] = None,
                local_devices: Optional[Sequence] = None) -> Mesh:
    """The broker mesh over every process's devices (after
    :func:`initialize`): process p's ``len(local_devices)`` devices
    (every visible CUDA device by default) follow process p-1's, as
    the JAX package's global device list does, so a data row lies
    inside one process whenever ``n_trie`` divides the per-process
    count. With explicit factors their product must cover the device
    count; the default puts the whole process-crossing factor on
    ``data``."""
    local = list(local_devices) if local_devices is not None \
        else cuda_devices()
    world, rank = _world()
    n = len(local) * world
    if n_data is None and n_trie is None:
        if world == 1:
            return default_mesh(n, local)
        n_trie = 2 if len(local) % 2 == 0 and n > 2 else 1
    if n_data is None:
        n_data = n // int(n_trie)
    if n_trie is None:
        n_trie = n // int(n_data)
    n_data, n_trie = int(n_data), int(n_trie)
    if n_data * n_trie != n:
        # dropping devices would desynchronize the collectives across
        # processes (some processes' devices outside the mesh)
        raise ValueError(
            f"mesh {n_data}x{n_trie} does not cover {n} devices")
    # every process's cells, in global order: this process's devices
    # where it runs them, the same local index elsewhere
    devs = [(p, local[j]) for p in range(world) for j in range(len(local))]
    grid = [devs[i * n_trie:(i + 1) * n_trie] for i in range(n_data)]
    return Mesh([[d for _p, d in row] for row in grid],
                ranks=[[p for p, _d in row] for row in grid], rank=rank)
