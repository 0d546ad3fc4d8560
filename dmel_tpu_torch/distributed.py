"""The mesh record, its collectives and the split of the models' leading
axis over ranks: the low level of data parallelism, which the models and
``fit`` import as they import :mod:`~dmel_tpu_torch.precision`.

A data-parallel rank holds its contiguous rows of the global batch
(:func:`shard_rows`); :mod:`~dmel_tpu_torch.parallel.mesh` builds the
mesh, places the batches and re-exports this module's names.  Every
collective here is the identity on a mesh without a process group.  The
models learn of the split from :func:`mesh_scope`, which
``train_step``, ``eval_step``, ``fit`` and ``fit_trials`` enter: a scope
held in a ``contextvars.ContextVar``, as
:func:`~dmel_tpu_torch.precision.precision_scope` holds the numeric
flags, so that no module changes its signature or its state, and a scope
of one rank leaves every model as it is without a mesh.  Inside it

- the batch norms take their statistics over the global batch, through
  the differentiable all-reduce :func:`all_reduce_sum`
  (:func:`data_mesh` says whether the batch is split);
- dropout and SpecAugment draw their masks at the global shape from a
  generator in the same state on every rank, each rank keeping its rows
  (:func:`rank_rand`), so the generators never drift apart.

``axis="trial"`` is the scope of a pack of trials split over the ranks
(:func:`~dmel_tpu_torch.parallel.trials.fit_trials`): its trials never
communicate, so nothing reduces, but the masks are drawn over the whole
pack.

:class:`Mesh` is a record of the port's own, not
``torch.distributed.device_mesh.DeviceMesh``: a mesh here has one axis
and needs its rank, its size, the process group and the rank's explicit
device.  ``DeviceMesh`` picks the device and the backend from the device
type (one card a rank, NCCL on CUDA), where two ranks may share one card
over gloo, and it needs a process group even for one rank.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A one-axis mesh of ranks, as seen from one of them: this process's
    ``rank`` of ``size``, its ``device`` and the process ``group`` (None:
    a mesh of one rank without a process group, where every collective
    is the identity).  :func:`~dmel_tpu_torch.parallel.mesh.make_mesh`
    builds it."""

    axis_names: tuple
    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None


def shard_rows(batch, mesh: Mesh) -> tuple:
    """This rank's contiguous rows of each host array of the global batch
    ``batch`` (a tuple of arrays); raises ``ValueError`` where the rows do
    not split evenly over the ranks."""
    out = []
    for a in batch:
        n = a.shape[0]
        if n % mesh.size:
            raise ValueError(f"global batch dim {n} not divisible by the "
                             f"mesh size {mesh.size}")
        per = n // mesh.size
        out.append(a[mesh.rank * per:(mesh.rank + 1) * per])
    return tuple(out)


def _broadcast_(t: torch.Tensor, mesh: Mesh) -> None:
    """Overwrite ``t`` with rank 0's, through a copy on the mesh's device
    where ``t`` lies elsewhere (NCCL moves CUDA tensors only)."""
    own = t.detach()
    buf = own.to(mesh.device)
    dist.broadcast(buf, 0, group=mesh.group)
    if buf is not own:
        own.copy_(buf)


@torch.no_grad()
def replicate(obj, mesh: Mesh):
    """Make ``obj`` (a module, or an optimizer) equal to rank 0's on every
    rank: a module's parameters and buffers, an optimizer's state tensors,
    each broadcast from rank 0 in place.  Returns ``obj``; nothing happens
    on a mesh without a process group."""
    if mesh.group is None:
        return obj
    if isinstance(obj, torch.optim.Optimizer):
        tensors = [v for g in obj.param_groups for p in g["params"]
                   for _, v in sorted(obj.state.get(p, {}).items())
                   if torch.is_tensor(v)]
    else:
        tensors = list(obj.parameters()) + list(obj.buffers())
    for t in tensors:
        _broadcast_(t, mesh)
    return obj


def all_reduce_sum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks, differentiable: its backward sums
    the gradient over the ranks, as a statistic inside the graph needs.
    ``t`` itself on a mesh without a process group."""
    if mesh.group is None:
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)


def all_reduce_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``t`` over the ranks in place, outside autograd; returns it."""
    if mesh.group is not None:
        dist.all_reduce(t, group=mesh.group)
    return t


@torch.no_grad()
def all_reduce_gradients(params, mesh: Mesh) -> None:
    """Sum every parameter's gradient over the ranks, in one collective
    over their concatenation.  A parameter without a gradient is left
    alone: the ranks run one graph, so they agree on which."""
    if mesh.group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), mesh)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def assert_replicated(t: torch.Tensor, mesh: Mesh, what: str) -> None:
    """Raise ``RuntimeError`` unless ``t`` holds the same bits on every
    rank (an all-gather; NaNs compare by their bits).  Ranks that decide
    differently on a value would stop at different collectives and
    hang."""
    if mesh.group is None:
        return
    t = t.detach().to(mesh.device).reshape(-1).contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    bits = [p.view(torch.uint8) for p in parts]
    if not all(torch.equal(bits[0], b) for b in bits[1:]):
        raise RuntimeError(f"{what} differs between the ranks: "
                           f"{[p.tolist() for p in parts]}")


def all_gather_object(obj, mesh: Mesh) -> list:
    """Every rank's ``obj`` (picklable), in rank order."""
    if mesh.group is None:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def gather_object(obj, mesh: Mesh) -> Optional[list]:
    """Every rank's ``obj`` in rank order on rank 0; None on the others."""
    if mesh.group is None:
        return [obj]
    out = [None] * mesh.size if mesh.rank == 0 else None
    dist.gather_object(obj, out, dst=0, group=mesh.group)
    return out


def barrier(mesh: Mesh) -> None:
    """Wait until every rank has come here."""
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


class _Scope(NamedTuple):
    mesh: Mesh
    axis: str


_SCOPE: contextvars.ContextVar = contextvars.ContextVar(
    "dmel_tpu_torch_mesh_scope", default=None)


@contextlib.contextmanager
def mesh_scope(mesh: Optional[Mesh], axis: str = "data"):
    """Run the body with the leading axis of the models' tensors split over
    ``mesh``'s ranks (module docstring).  ``axis="data"``: the batch, so
    batch norms and the masked losses reduce over the global batch.
    ``axis="trial"``: the trials of a pack, which never communicate.
    Masks are drawn at the global shape in both.  A mesh of one rank, or
    None, sets no scope: every model runs as it does without a mesh."""
    if axis not in ("data", "trial"):
        raise ValueError(f"unknown split axis {axis!r}")
    value = None if mesh is None or mesh.size == 1 else _Scope(mesh, axis)
    token = _SCOPE.set(value)
    try:
        yield
    finally:
        _SCOPE.reset(token)


def data_mesh() -> Optional[Mesh]:
    """The scope's mesh where it splits the batch (``axis="data"``), else
    None: the batch statistics and the losses' counts are global there."""
    scope = _SCOPE.get()
    return scope.mesh if scope is not None and scope.axis == "data" else None


def rank_rand(shape, generator: Optional[torch.Generator], device,
              dim: int = 0) -> torch.Tensor:
    """``torch.rand(shape)`` in float32 from ``generator``, as this rank's
    share of one draw over all ranks: inside a :func:`mesh_scope` of more
    than one rank, ``shape[dim]`` is this rank's part of an axis split
    over the ranks in order, so the whole axis is drawn and this rank's
    contiguous slice kept.  Every rank's generator then advances alike,
    and the ranks' slices together are the single device's draw."""
    scope = _SCOPE.get()
    if scope is None:
        return torch.rand(shape, generator=generator, device=device,
                          dtype=torch.float32)
    full = list(shape)
    n = full[dim]
    full[dim] = n * scope.mesh.size
    u = torch.rand(full, generator=generator, device=device,
                   dtype=torch.float32)
    return u.narrow(dim, scope.mesh.rank * n, n)
