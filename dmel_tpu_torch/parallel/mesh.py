"""Data parallelism over processes (counterpart of
``dmel_tpu/parallel/mesh.py``).

The JAX package lays a one-axis ``("data",)`` mesh over its devices and
lets GSPMD split the batch and insert the collectives, so that
``fit(mesh=...)`` computes what the single-device ``fit`` computes on
the same global batch.  Here a rank is a process with one device, joined
to the others by a ``torch.distributed`` process group; every rank holds
the whole model and computes on its contiguous rows of the global batch.
The program stays the single device's:

- every rank holds the same global host batch (the loaders are seeded
  alike) and takes its rows (:func:`place_global_batch`);
- the loss and the metrics are normalised by the global count of kept
  rows, so the sum of the ranks' gradients (:func:`all_reduce_gradients`)
  is the single device's gradient, padded tail batches included;
- batch-norm statistics are taken over the global batch, and dropout
  and SpecAugment masks drawn at the global shape, each rank keeping its
  rows: the models learn of the split from
  :func:`~dmel_tpu_torch.distributed.mesh_scope`.

The :class:`Mesh` record, the collectives (:func:`replicate`, the
differentiable :func:`all_reduce_sum`, :func:`all_reduce_gradients`,
:func:`assert_replicated`, the object gathers) and the scope live in
:mod:`dmel_tpu_torch.distributed`, a low-level module that the models
and ``fit`` import, and are re-exported here; this module builds the
mesh and places the batches.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dmel_tpu_torch.distributed import (  # noqa: F401
    Mesh, all_gather_object, all_reduce_, all_reduce_gradients,
    all_reduce_sum, assert_replicated, barrier, data_mesh, gather_object,
    mesh_scope, rank_rand, replicate, shard_rows)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Join this process to a process group of ``num_processes`` ranks as
    rank ``process_id``, through ``torch.distributed.init_process_group``
    over ``tcp://<coordinator_address>`` (``host:port``; rank 0 listens
    there).  With no arguments it does nothing, so the same entry point
    runs one process and many.

    ``backend`` defaults to ``nccl`` where CUDA is available and ``gloo``
    elsewhere.  ``gloo`` on CUDA lets several ranks share one card (NCCL
    refuses two ranks on one device): for checking, not for speed."""
    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize_distributed needs the coordinator's "
                         "address, the number of processes and this "
                         "process's id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    address = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=address,
                            world_size=int(num_processes),
                            rank=int(process_id))


def make_mesh(axis_names: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """The mesh over the ranks of the process group, as this rank sees
    it; without a process group, a mesh of one rank.

    ``shape``, where given, must be ``(ranks,)``.  ``devices`` is this
    rank's device (``"cpu"``, or a CUDA device); None takes
    ``cuda:<local rank % device count>`` (the local rank from
    ``LOCAL_RANK``, else the rank) and makes it the current CUDA device,
    as NCCL's object collectives need."""
    axis_names = tuple(axis_names)
    if len(axis_names) != 1:
        raise ValueError(f"the mesh has one axis, not {axis_names}")
    if dist.is_available() and dist.is_initialized():
        group, rank, size = (dist.group.WORLD, dist.get_rank(),
                             dist.get_world_size())
    else:
        group, rank, size = None, 0, 1
    if shape is not None and tuple(shape) != (size,):
        raise ValueError(f"mesh shape {tuple(shape)}: the process group "
                         f"has {size} ranks")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "devices='cpu' to run on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    else:
        device = torch.device(devices)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return Mesh(axis_names, rank, size, device, group)


class Placement(NamedTuple):
    """How a tensor lies on a mesh: split along its leading axis over the
    mesh axis ``axis`` in rank order, or replicated (``axis`` None)."""

    mesh: Mesh
    axis: Optional[str]


def batch_sharding(mesh: Mesh, axis: str = "data") -> Placement:
    """The leading (batch) axis split over ``axis``, each rank holding its
    contiguous rows."""
    if axis not in mesh.axis_names:
        raise ValueError(f"no axis {axis!r} in {mesh.axis_names}")
    return Placement(mesh, axis)


def replicated(mesh: Mesh) -> Placement:
    """The whole tensor on every rank."""
    return Placement(mesh, None)


def place_global_batch(batch, mesh: Mesh, axis: str = "data") -> tuple:
    """The global host batch ``batch`` (a tuple of arrays, the same on every
    rank) placed by :func:`batch_sharding`: this rank's contiguous rows of
    each array, as tensors on its device."""
    batch_sharding(mesh, axis)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)
                 for a in shard_rows(batch, mesh))


def shard_batch(batch, mesh: Mesh, axis: str = "data") -> tuple:
    """:func:`place_global_batch`: a rank holds only its rows, so placing a
    batch and placing the global batch are one operation here."""
    return place_global_batch(batch, mesh, axis)
