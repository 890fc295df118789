"""Multi-process runtime: ``torch.distributed`` wiring and a global mesh.

PyTorch counterpart of :mod:`bask_tpu.parallel.distributed`:

* :func:`init_distributed` starts the process group (opt-in). The
  coordinator, process count and process id come from the arguments, or
  from JAX's variables (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
  ``JAX_PROCESS_ID``), or from torchrun's (``MASTER_ADDR`` /
  ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). The backend follows the
  device the caller names: NCCL for CUDA cards, gloo for the CPU. It is
  never probed.
* :func:`global_walker_mesh` is a 1-axis
  :class:`~bask_tpu_torch.parallel.mesh.Mesh` over every process's local
  devices, in rank order; its collectives run through the process group.
  Walker ensembles, candidate grids and row strips shard over it as over
  a mesh of one process.
* :func:`shard_global` gives this process's shards of an array every
  process holds in full (a seeded initial ensemble, the training data).

Every process runs the same program on the same host data; a sharded
result is gathered to every process, so the chain, the consensus and the
next point agree across processes. NCCL takes one rank per card: two
ranks on one card are refused by NCCL itself, and the port does not work
around it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .mesh import Mesh

__all__ = ["init_distributed", "global_walker_mesh", "shard_global"]

# the devices of this process, set by init_distributed
_LOCAL = {"devices": None}


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    *,
    device: str = "cuda",
) -> tuple:
    """Start the process group; returns ``(rank, world_size)``.

    ``coordinator_address`` is ``host:port`` of rank 0 (JAX's form). The
    arguments left as ``None`` come from JAX's variables, then torchrun's.
    ``local_device_ids`` are this process's cards (``device="cuda"``,
    default: card ``rank``) or, with ``device="cpu"``, one CPU entry per
    id. A process group that cannot start raises.
    """
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        v = env.get("JAX_NUM_PROCESSES", env.get("WORLD_SIZE"))
        num_processes = None if v is None else int(v)
    if process_id is None:
        v = env.get("JAX_PROCESS_ID", env.get("RANK"))
        process_id = None if v is None else int(v)
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "init_distributed needs the coordinator address, the process "
            "count and the process id (arguments, JAX_COORDINATOR_ADDRESS/"
            "JAX_NUM_PROCESSES/JAX_PROCESS_ID, or MASTER_ADDR/MASTER_PORT/"
            "WORLD_SIZE/RANK)"
        )
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if local_device_ids is None:
        local_device_ids = [process_id] if kind == "cuda" else [0]
    if kind == "cuda":
        devices = [torch.device("cuda", int(i)) for i in local_device_ids]
        Mesh(devices)  # raises for a card this machine does not have
        torch.cuda.set_device(devices[0])
    else:
        devices = [torch.device("cpu")] * len(local_device_ids)
    torch.distributed.init_process_group(
        "nccl" if kind == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
    )
    _LOCAL["devices"] = devices
    return torch.distributed.get_rank(), torch.distributed.get_world_size()


def global_walker_mesh(axis: str = "walkers") -> Mesh:
    """1-axis mesh over every process's local devices, in rank order (each
    process must hold as many as the others)."""
    if not torch.distributed.is_initialized() or _LOCAL["devices"] is None:
        raise RuntimeError("global_walker_mesh needs init_distributed first")
    mine = [str(d) for d in _LOCAL["devices"]]
    everyone = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(everyone, mine)
    if len({len(v) for v in everyone}) != 1:
        raise ValueError(f"processes hold unequal device counts: {[len(v) for v in everyone]}")
    names = [d for v in everyone for d in v]
    owners = [r for r, v in enumerate(everyone) for _ in v]
    return Mesh(names, (axis,), owners=owners, group=torch.distributed.group.WORLD)


def shard_global(arr, mesh: Mesh, axis: str, sharded_dim: int = 0):
    """This process's shards of ``arr`` (every process holds all of it),
    split along ``sharded_dim`` over ``mesh``'s ``axis``: one tensor per
    local entry, on its device, in entry order."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    t = torch.as_tensor(np.asarray(arr) if not isinstance(arr, torch.Tensor) else arr)
    return mesh.split(t, dim=sharded_dim)
