"""Meshes over a ``torch.distributed`` process group (twin of ``repro.launch.mesh``).

A JAX ``Mesh`` with a ``data`` axis names devices that one program spans.
The port's twin is the default process group: every rank runs the same
program on the same inputs, holds a shard of the work, and meets the other
ranks in collectives. :class:`ReplayMesh` holds that group, its world size
(the shard count), this rank, the device the rank computes on and the
device its collectives run on (CUDA for NCCL, the CPU for gloo).

Nothing here starts a group. The caller opens one
(``torch.distributed.init_process_group``, or ``torchrun``) and a mesh is
built over it; without one, :func:`make_replay_mesh` raises. The JAX
package's ``make_production_mesh`` waits for the config registry
(ROADMAP A12.6).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch
import torch.distributed as dist

from repro_torch import resolve_device

__all__ = ["ReplayMesh", "make_host_mesh", "make_replay_mesh"]


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

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Elementwise reduction of ``t`` over every rank (a new tensor)."""
        self.check_live()
        buf = t.to(self.comm_device, copy=True)
        dist.all_reduce(buf, op=op)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (same shape on every rank), in rank order."""
        self.check_live()
        buf = t.to(self.comm_device).contiguous()
        out = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(out, buf)
        return [o.to(t.device) for o in out]


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
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return ReplayMesh(size=n, rank=dist.get_rank(), device=dev,
                      comm_device=_backend_device(dev))


def make_host_mesh(model: int = 1, device=None) -> ReplayMesh:
    """Small mesh over every rank (tests, examples). The JAX twin adds a
    ``model`` axis; its collectives belong to the model-sharding slice, so
    only ``model=1`` is built here."""
    if int(model) != 1:
        raise ValueError("a model axis comes with the model-sharding slice; use model=1")
    return make_replay_mesh(device=device)
