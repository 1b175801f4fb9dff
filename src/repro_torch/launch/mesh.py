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
raise. The JAX package's ``make_production_mesh`` waits for the config
registry (ROADMAP A12.6).
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device

__all__ = ["HostMesh", "ReplayMesh", "make_host_mesh", "make_replay_mesh", "open_group"]

AXES = ("data", "model")


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
