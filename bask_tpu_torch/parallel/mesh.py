"""Device meshes for sharding walker ensembles, candidate grids and rows.

PyTorch counterpart of :mod:`bask_tpu.parallel.mesh`. A :class:`Mesh` is
a 1- or 2-axis grid of ``torch.device`` entries with named axes, the
counterpart of ``jax.sharding.Mesh``. An entry may repeat a device
(``Mesh(["cuda:0"] * 4, ("walkers",))``, or ``"cpu"`` eight times in the
tests): the caller chooses that layout, as the JAX package's tests chose
eight virtual CPU devices, and the same code takes distinct cards where
the machine has them.

JAX places a sharded array and lets ``shard_map`` run the body per
device. Here :func:`shard_walkers` and :func:`shard_candidates` return the
per-entry chunks in order, the callers run each chunk on its entry's
device, and the mesh's few collectives join the results:

* :meth:`Mesh.all_gather` concatenates the entries' parts along a
  dimension (JAX's ``all_gather(tiled=True)``);
* :meth:`Mesh.broadcast` hands one entry's block to every entry (the
  counterpart of the ``psum`` of a block that only its owner fills,
  ``dist_chol.py:207-224``);
* :meth:`Mesh.all_reduce` sums one tensor per entry (the row sweep's
  scalars and gradient parts).

A candidate grid's argmax is taken once over the gathered values, as
JAX's ``argmax`` over a sharded array gathers them.

In one process they are device-to-device copies, and an entry that
repeats a device shares that device's copy. A mesh built by
:func:`bask_tpu_torch.parallel.distributed.global_walker_mesh` spans
processes: each process holds its own entries, and the collectives go
through the ``torch.distributed`` process group. A collective that fails
raises; nothing falls back to an unsharded path.
"""

from __future__ import annotations

import warnings
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "walker_mesh", "shard_walkers", "shard_candidates"]


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda":
        index = 0 if dev.index is None else dev.index
        if not torch.cuda.is_available() or index >= torch.cuda.device_count():
            raise RuntimeError(
                f"mesh names {dev} but this machine has "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                "CUDA card(s)"
            )
        dev = torch.device("cuda", index)
    return dev


class Mesh:
    """A 1- or 2-axis grid of devices with named axes.

    ``devices`` is a (nested) sequence or array of ``torch.device`` or
    device strings; ``axis_names`` names its axes. ``shape`` maps each
    axis name to its size, as ``jax.sharding.Mesh.shape`` does. A device
    may appear more than once. Naming a CUDA card the machine does not
    have raises.

    ``owners`` and ``group`` are set by
    :func:`~bask_tpu_torch.parallel.distributed.global_walker_mesh` only:
    the rank that holds each entry and the process group the collectives
    run through. On such a mesh ``devices`` holds this process's device
    for its own entries and the owner's device name for the others.
    """

    def __init__(self, devices, axis_names: Sequence[str] = ("walkers",), *,
                 owners=None, group=None):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(
                f"a mesh of {arr.ndim} axes needs {arr.ndim} axis names, got {axis_names}"
            )
        if arr.ndim not in (1, 2) or arr.size == 0:
            raise ValueError(f"a mesh has one or two non-empty axes, got shape {arr.shape}")
        self.group = group
        self.rank = 0 if group is None else torch.distributed.get_rank(group)
        self.owners = (np.zeros(arr.shape, dtype=int) if owners is None
                       else np.asarray(owners, dtype=int).reshape(arr.shape))
        if group is not None and arr.ndim != 1:
            raise ValueError("a mesh across processes has one axis")
        out = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            mine = self.owners[idx] == self.rank
            out[idx] = _device(arr[idx]) if mine else torch.device(arr[idx])
        self.devices = out
        self.axis_names = axis_names

    @property
    def shape(self):
        return OrderedDict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        names = [str(d) for d in self.devices.flat]
        return f"Mesh({names}, axis_names={self.axis_names}, shape={tuple(self.devices.shape)})"

    # -- layout --------------------------------------------------------------

    def row(self, i: int) -> "Mesh":
        """The 1-axis mesh of the entries at index ``i`` of the first axis
        (a row group of a (walkers, rows) mesh)."""
        if self.devices.ndim != 2:
            raise ValueError("row() takes a 2-axis mesh")
        sub = Mesh.__new__(Mesh)
        sub.group, sub.rank = self.group, self.rank
        sub.owners = self.owners[i].copy()
        sub.devices = self.devices[i].copy()
        sub.axis_names = self.axis_names[1:]
        return sub

    @property
    def local(self):
        """Indices (1-axis mesh) of the entries this process holds."""
        return [p for p in range(self.devices.shape[0]) if self.owners[p] == self.rank]

    def replicas(self):
        """The distinct devices of this process's entries, in entry order."""
        seen = []
        for p in self.local:
            if self.devices[p] not in seen:
                seen.append(self.devices[p])
        return seen

    def _check_1d(self, what):
        if self.devices.ndim != 1:
            raise ValueError(f"{what} runs on a 1-axis mesh (take mesh.row(i))")

    def split(self, x, dim: int = 0):
        """This process's chunks of ``x`` (held in full by every process)
        along ``dim``, one per local entry, each on its entry's device; the
        chunks are ``torch.tensor_split``'s, so they may differ by one."""
        self._check_1d("split")
        chunks = torch.tensor_split(x, self.devices.shape[0], dim=dim)
        return [chunks[p].to(self.devices[p]) for p in self.local]

    # -- collectives ---------------------------------------------------------

    def all_gather(self, parts, dim: int = 0, device=None):
        """Concatenate every entry's part along ``dim``, in entry order.

        ``parts`` holds this process's parts, one per local entry. Returns
        ``{device: full}`` for every replica device, or the full tensor on
        ``device`` when one is named. Across processes every rank must give
        parts of one shape (``all_gather_into_tensor``).
        """
        self._check_1d("all_gather")
        if len(parts) != len(self.local):
            raise ValueError(f"all_gather takes {len(self.local)} parts, got {len(parts)}")
        if self.group is None:
            if device is not None:
                return torch.cat([t.to(device) for t in parts], dim=dim)
            return {dev: torch.cat([t.to(dev) for t in parts], dim=dim)
                    for dev in self.replicas()}
        home = self.replicas()[0]
        mine = torch.cat([t.to(home) for t in parts], dim=dim).movedim(dim, 0)
        full = self._gather_ranks(mine)
        full = full.movedim(0, dim)
        if device is not None:
            return full.to(device)
        return {dev: full.to(dev) for dev in self.replicas()}

    def _gather_ranks(self, t):
        """Every rank's ``t`` (one shape on every rank) stacked along dim 0
        in rank order, through the process group."""
        t = t.contiguous()
        world = torch.distributed.get_world_size(self.group)
        full = torch.empty((world * t.shape[0],) + t.shape[1:], dtype=t.dtype, device=t.device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            torch.distributed.all_gather_into_tensor(full, t, group=self.group)
        return full

    def broadcast(self, block, src: int, shape=None, dtype=None):
        """Entry ``src``'s ``block`` on every replica device, as
        ``{device: block}``. ``block`` is given where this process holds
        ``src`` (else ``None``); across processes the receivers allocate
        ``shape`` and ``dtype``."""
        self._check_1d("broadcast")
        reps = self.replicas()
        if self.group is not None:
            owner = int(self.owners[src])
            if owner == self.rank:
                buf = block.to(reps[0]).contiguous()
            else:
                buf = torch.empty(shape, dtype=dtype, device=reps[0])
            torch.distributed.broadcast(buf, src=owner, group=self.group)
            block = buf
        return {dev: block.to(dev) for dev in reps}

    def all_reduce(self, values, device=None):
        """Sum one tensor per local entry elementwise over every entry; the
        result on ``device`` (default: the first replica's)."""
        self._check_1d("all_reduce")
        device = self.replicas()[0] if device is None else device
        red = torch.stack([torch.as_tensor(v).to(device) for v in values]).sum(0)
        if self.group is not None:
            red = red.contiguous()
            torch.distributed.all_reduce(red, op=torch.distributed.ReduceOp.SUM,
                                         group=self.group)
        return red


def walker_mesh(n_devices: Optional[int] = None, axis: str = "walkers") -> Mesh:
    """1-axis mesh over the first ``n_devices`` CUDA cards (default: all),
    as the JAX package's covers ``jax.devices()[:n]``. Asking for more
    cards than the machine has raises; a mesh that repeats a device is
    built with :class:`Mesh` itself."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = count if n_devices is None else int(n_devices)
    if n < 1 or n > count:
        raise RuntimeError(f"walker_mesh({n_devices}) needs {n} CUDA card(s); this machine has {count}")
    return Mesh([torch.device("cuda", i) for i in range(n)], (axis,))


def _shard(x, mesh: Mesh, axis: str):
    if mesh.axis_names != (axis,):
        raise ValueError(f"sharding along {axis!r} takes a 1-axis mesh named so, got {mesh.axis_names}")
    return mesh.split(torch.as_tensor(x))


def shard_walkers(pos, mesh: Mesh, axis: str = "walkers"):
    """A (W, D) walker tensor split along W over the 1-axis ``mesh``: the
    chunks of this process's entries, in order, each on its device."""
    return _shard(pos, mesh, axis)


def shard_candidates(X, mesh: Mesh, axis: str = "walkers"):
    """A (C, d) candidate grid split along C over the 1-axis ``mesh``: the
    chunks of this process's entries, in order, each on its device."""
    return _shard(X, mesh, axis)
