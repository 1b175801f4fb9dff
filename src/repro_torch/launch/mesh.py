"""Meshes over a ``torch.distributed`` process group (twin of ``repro.launch.mesh``).

A JAX ``Mesh`` with a ``data`` axis names devices that one program spans.
The port's twin is the default process group: every rank runs the same
program on the same inputs, holds a shard of the work, and meets the other
ranks in collectives. :class:`ReplayMesh` holds that group, its world size
(the shard count), this rank, the device the rank computes on and the
device its collectives run on (CUDA for NCCL, the CPU for gloo).
:class:`HostMesh` adds the JAX ``("data", "model")`` layout over the same
group: rank r sits at ``(r // model, r % model)``, as ``jax.make_mesh``
lays devices out, and each row (the model axis) and each column (the data
axis) has a subgroup of its own for collectives along one axis.

The caller opens a group (``torch.distributed.init_process_group``,
``torchrun``, or the launchers' :func:`open_group`) and a mesh is built
over it; without one, :func:`make_replay_mesh` and :func:`make_host_mesh`
raise.

:func:`make_production_mesh` describes the JAX package's production mesh,
(16, 16) ``("data", "model")`` or (2, 16, 16) ``("pod", "data", "model")``,
with no process group: a :class:`MetaMesh`, this side of the dry run
(``python -m repro_torch.launch.dryrun``). It plays rank 0; its collectives
take ``meta`` tensors only, return results of the right shape and count
the bytes each collective kind receives (the twin of the JAX dry run's
collective bytes, which it parses from the compiled HLO).

:func:`sum_replicated` and :func:`grad_sum` are the two collectives of a
model-parallel region (Megatron's g and f) as ``torch.autograd.Function``s
on a mesh's subgroups, and :func:`gather_last` the all-gather of column
shards whose backward reduce-scatters. The port follows the JAX convention that every rank
holds the global loss: a sum whose result is then replicated passes its
cotangent through unchanged (g), and an input that feeds each rank's own
part of a sum gets its gradient summed over those ranks (f).
``torch.distributed.nn.functional.all_reduce`` is neither: its backward
all-reduces the cotangent, which counts a replicated loss once per rank.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device

__all__ = ["HostMesh", "MetaMesh", "ReplayMesh", "gather_last", "grad_sum", "make_host_mesh",
           "make_production_mesh", "make_replay_mesh", "open_group", "sum_replicated"]

AXES = ("data", "model")
#: the collective kinds of the JAX dry run's HLO count, in its order
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


@dataclasses.dataclass(eq=False)
class ReplayMesh:
    """This rank's view of a 1-D ``data`` mesh over the default group.

    Collectives take tensors on any device: they are moved to
    ``comm_device`` for the call and back after it. A failed collective
    raises (gloo and NCCL both raise on a timeout or a lost peer).
    """

    size: int                   # world size = data shards
    rank: int
    device: torch.device        # where this rank computes
    comm_device: torch.device   # where its collectives run

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.size}

    def check_live(self) -> None:
        """Raise unless the group this mesh was built over is still open."""
        if not dist.is_initialized() or dist.get_world_size() != self.size:
            raise RuntimeError(
                "the mesh's process group is not initialized (call "
                "torch.distributed.init_process_group before a sharded run)"
            )

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM, axis=None) -> torch.Tensor:
        """Elementwise reduction of ``t`` over every rank (a new tensor).
        ``axis`` may name ``data``, the one axis."""
        _data_only(axis)
        self.check_live()
        buf = t.to(self.comm_device, copy=True)
        dist.all_reduce(buf, op=op)
        return buf.to(t.device)

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes``: its rank (``data`` is the one
        axis)."""
        _data_only(axes)
        return self.rank

    def all_gather(self, t: torch.Tensor, axis=None) -> List[torch.Tensor]:
        """Every rank's ``t`` (same shape on every rank), in rank order.
        ``axis`` may name ``data``, the one axis."""
        _data_only(axis)
        self.check_live()
        buf = t.to(self.comm_device).contiguous()
        out = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(out, buf)
        return [o.to(t.device) for o in out]

    def reduce_scatter(self, t: torch.Tensor, axis=None) -> torch.Tensor:
        """This rank's block of ``t`` (``size`` equal blocks along dim 0)
        summed over every rank: the transpose of :meth:`all_gather`."""
        _data_only(axis)
        self.check_live()
        buf = t.to(self.comm_device).contiguous()
        chunks = list(buf.chunk(self.size, dim=0))
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks)
        return out.to(t.device)


@dataclasses.dataclass(eq=False)
class HostMesh(ReplayMesh):
    """This rank's view of a ``("data", "model")`` mesh over the default
    group: ``size // model`` rows of ``model`` ranks.

    The collectives take ``axis``: ``"data"`` (this rank's column),
    ``"model"`` (its row), a tuple of both or ``None`` (every rank). A
    tensor is moved to ``comm_device`` for the call and back after it.
    """

    model: int = 1
    groups: Dict[str, object] = dataclasses.field(default_factory=dict)  # axis → this rank's subgroup

    @property
    def data(self) -> int:
        return self.size // self.model

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def axis_names(self) -> Tuple[str, str]:
        return AXES

    def coords(self, rank: int) -> Dict[str, int]:
        """``rank``'s place on each axis."""
        return {"data": rank // self.model, "model": rank % self.model}

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` (one name or a tuple, the first
        major), as ``jax.lax.axis_index`` numbers shards."""
        return _index_of(self, self.rank, axes)

    def _group(self, axes):
        """The subgroup spanning ``axes`` and its members' global ranks,
        in rank order."""
        names = set(_axes(AXES if axes is None else axes))
        if names == set(AXES):
            return None, list(range(self.size))
        (a,) = names
        me = self.coords(self.rank)
        other = "model" if a == "data" else "data"
        return self.groups[a], [r for r in range(self.size) if self.coords(r)[other] == me[other]]

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM, axis=None) -> torch.Tensor:
        """Elementwise reduction of ``t`` over the ranks along ``axis``."""
        self.check_live()
        group, _ = self._group(axis)
        buf = t.to(self.comm_device, copy=True)
        dist.all_reduce(buf, op=op, group=group)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor, axis=None) -> List[torch.Tensor]:
        """Every rank's ``t`` along ``axis``, ordered by their index along
        it (``axis_index``)."""
        self.check_live()
        group, members = self._group(axis)
        buf = t.to(self.comm_device).contiguous()
        out = [torch.empty_like(buf) for _ in members]
        dist.all_gather(out, buf, group=group)
        order = sorted(range(len(members)), key=lambda i: _index_of(self, members[i], axis))
        return [out[i].to(t.device) for i in order]

    def reduce_scatter(self, t: torch.Tensor, axis=None) -> torch.Tensor:
        """This rank's block of ``t`` summed over the ranks along ``axis``:
        ``t`` is cut into one equal block per rank along dim 0, in the
        order of :meth:`all_gather`, and the rank keeps the block at its
        index (the transpose of :meth:`all_gather`)."""
        self.check_live()
        group, members = self._group(axis)
        blocks = t.to(self.comm_device).contiguous().chunk(len(members), dim=0)
        chunks = [blocks[_index_of(self, r, axis)].contiguous() for r in members]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=group)
        return out.to(t.device)


def _axes(axes) -> Tuple[str, ...]:
    out = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in out:
        if a not in AXES:
            raise ValueError(f"unknown mesh axis {a!r}; the axes are {AXES}")
    return out


def _data_only(axes) -> None:
    if axes is not None and set(_axes(axes)) != {"data"}:
        raise ValueError(f"a ReplayMesh has one axis, 'data'; not {axes!r}")


def _index_of(mesh: HostMesh, rank: int, axes) -> int:
    """``rank``'s index along ``axes`` (``None``: every axis, so its rank)."""
    idx = 0
    for a in _axes(AXES if axes is None else axes):
        idx = idx * mesh.shape[a] + mesh.coords(rank)[a]
    return idx


def open_group(dev: torch.device) -> bool:
    """For a launcher: join the group ``torchrun`` describes (``env://``),
    or open one rank of its own over a ``HashStore`` (NCCL on the card,
    gloo on the CPU); nothing when a group is open. Returns whether this
    call opened it, so the caller destroys only what it opened."""
    if dist.is_initialized():
        return False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    timeout = timedelta(seconds=120)
    if "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
    return True


def _backend_device(device: torch.device) -> torch.device:
    backend = dist.get_backend()
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("an NCCL group computes on CUDA; pass device=None or 'cuda'")
        return device
    return torch.device("cpu")


def make_replay_mesh(shards: int | None = None, device=None) -> ReplayMesh:
    """1-D data mesh over the default process group, for the sharded
    replay and the mesh DiDiC.

    ``shards`` defaults to the world size and must equal it: every rank of
    the group takes part. (The JAX twin may take a prefix of the visible
    devices; a process group has no ranks to leave out.) ``device`` is
    where this rank computes, ``None`` meaning CUDA; an NCCL group needs
    it to be CUDA, a gloo group runs its collectives on the CPU whatever
    it is.
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "make_replay_mesh needs an initialized process group "
            "(torch.distributed.init_process_group, or run under torchrun)"
        )
    n = dist.get_world_size()
    shards = n if shards is None else int(shards)
    if shards != n:
        raise ValueError(f"shards={shards} outside {n}..{n}: the mesh spans the whole "
                         f"group of {n} ranks")
    dev = _rank_device(device)
    return ReplayMesh(size=n, rank=dist.get_rank(), device=dev,
                      comm_device=_backend_device(dev))


def _rank_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_host_mesh(model: int = 1, device=None) -> HostMesh:
    """``("data", "model")`` mesh over every rank of the default group:
    ``data = world // model`` (twin of the JAX ``make_host_mesh``, whose
    mesh spans every device). Every rank must call it, in the same order
    as every other collective: it creates one subgroup per row and one per
    column."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_host_mesh needs an initialized process group "
            "(torch.distributed.init_process_group, or run under torchrun)"
        )
    n, model = dist.get_world_size(), int(model)
    if model < 1 or n % model:
        raise ValueError(f"the model axis ({model}) must divide the world size {n}")
    data = n // model
    groups: Dict[str, object] = {}
    rank = dist.get_rank()
    for d in range(data):  # rows: the model axis
        g = dist.new_group([d * model + j for j in range(model)])
        if rank // model == d:
            groups["model"] = g
    for j in range(model):  # columns: the data axis
        g = dist.new_group([d * model + j for d in range(data)])
        if rank % model == j:
            groups["data"] = g
    dev = _rank_device(device)
    return HostMesh(size=n, rank=rank, device=dev, comm_device=_backend_device(dev),
                    model=model, groups=groups)


# ------------------------------------------------------------ production mesh
@dataclasses.dataclass(eq=False)
class MetaMesh:
    """A mesh with no process group: its axis sizes and rank 0's view of it.

    The dry run's stand-in for a mesh of ``size`` devices. Every axis index
    is 0. Its collectives (``all_reduce``, ``all_gather``,
    ``reduce_scatter``: the ones the cells' steps call) take ``meta``
    tensors only (the dry run allocates nothing), return ``meta`` results of
    the right shapes and add the bytes this rank receives to
    :attr:`collectives` under the JAX dry run's names (the output size, as
    the JAX dry run sums HLO outputs). A collective along axes of one device
    moves nothing and is not counted."""

    shape: Dict[str, int]
    collectives: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=lambda: {k: {"count": 0, "bytes": 0} for k in COLLECTIVES})

    @property
    def size(self) -> int:
        return self._span(None)

    def axis_index(self, axes) -> int:
        self._span(axes)
        return 0

    def collective_stats(self) -> Dict[str, object]:
        """The counts by kind with ``total_bytes`` and ``total_count``, as
        the JAX dry run's ``collective_stats`` lays them out."""
        out: Dict[str, object] = {k: dict(v) for k, v in self.collectives.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.collectives.values())
        out["total_count"] = sum(v["count"] for v in self.collectives.values())
        return out

    def _span(self, axes) -> int:
        names = tuple(self.shape) if axes is None else (axes,) if isinstance(axes, str) else tuple(axes)
        n = 1
        for a in names:
            if a not in self.shape:
                raise ValueError(f"unknown mesh axis {a!r}; the axes are {tuple(self.shape)}")
            n *= self.shape[a]
        return n

    def _count(self, kind: str, t: torch.Tensor, axis, out_elements: int) -> int:
        """Check ``t`` is ``meta``; count ``out_elements`` of its type
        received under ``kind`` where ``axis`` spans more than one device.
        Returns the span."""
        if t.device.type != "meta":
            raise ValueError(f"a MetaMesh collective takes meta tensors, got one on {t.device}")
        n = self._span(axis)
        if n > 1:
            self.collectives[kind]["count"] += 1
            self.collectives[kind]["bytes"] += out_elements * t.element_size()
        return n

    def all_reduce(self, t: torch.Tensor, op=None, axis=None) -> torch.Tensor:
        self._count("all-reduce", t, axis, t.numel())
        return torch.empty_like(t)

    def all_gather(self, t: torch.Tensor, axis=None) -> List[torch.Tensor]:
        n = self._count("all-gather", t, axis, t.numel() * self._span(axis))
        return [torch.empty_like(t) for _ in range(n)]

    def reduce_scatter(self, t: torch.Tensor, axis=None) -> torch.Tensor:
        n = self._span(axis)
        self._count("reduce-scatter", t, axis, t.numel() // n)
        return torch.empty_like(t.chunk(n, dim=0)[0])


def make_production_mesh(*, multi_pod: bool = False) -> MetaMesh:
    """The JAX package's production mesh as a :class:`MetaMesh`: (16, 16)
    ``("data", "model")``, or (2, 16, 16) ``("pod", "data", "model")``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MetaMesh(dict(zip(axes, shape)))


# ----------------------------------------------- model-parallel collectives
class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        return mesh.all_reduce(t, axis=axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GradSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.contiguous(), axis=ctx.axis), None, None


def sum_replicated(t: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``t`` summed over the ranks along ``axis``, the result replicated on
    each (Megatron's g): its backward passes the cotangent through, since
    every rank holds the same loss of it."""
    return _SumReplicated.apply(t, mesh, axis)


def grad_sum(t: torch.Tensor, mesh, axis) -> torch.Tensor:
    """``t`` as it is (Megatron's f), for an input each rank along ``axis``
    feeds into its own part of a :func:`sum_replicated`: the backward sums
    the ranks' cotangents, so the gradient is the whole one on each."""
    return _GradSum.apply(t, mesh, axis)


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return torch.cat(mesh.all_gather(t, axis=axis), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        n = ctx.mesh.shape[ctx.axis]
        blocks = torch.stack(grad.chunk(n, dim=-1))                 # [n, ..., C]: rank i's columns at i
        return ctx.mesh.reduce_scatter(blocks, axis=ctx.axis)[0], None, None


def gather_last(t: torch.Tensor, mesh, axis) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, concatenated on the last dimension
    in their index order: the whole of a column-sharded product. Its
    backward reduce-scatters: each rank's cotangent of the whole is its
    share of a replicated loss, so the block of ``t``'s columns is summed
    over the ranks and each keeps its own."""
    return _GatherLast.apply(t, mesh, axis)
