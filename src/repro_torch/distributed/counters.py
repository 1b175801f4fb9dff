"""Distributed per-vertex counter reduction (twin of ``repro.distributed.counters``).

The sharded traffic replay (:mod:`repro_torch.core.traffic_sharded`) counts
per-vertex mass on every rank and needs the global per-vertex totals back:
each rank scatter-adds its (vertex id, mass) pairs into a dense row with
``index_add_``, and one ``all_reduce(SUM)`` publishes the total to every
rank.

The JAX package counts in int32 on the device (no x64 there) and bounds
each wave so that it cannot wrap, widening to int64 on the host. Torch
counts in int64 on the device, so nothing can wrap; the wave bound and the
host fold (:class:`CounterAccumulator`) are kept as the JAX package has
them, so a log is cut into the same waves and folded the same way.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

__all__ = ["CounterAccumulator", "data_shard_count", "make_scatter_psum"]


def data_shard_count(mesh, data_axes: Tuple[str, ...] = ("data",)) -> int:
    """Number of shards along the mesh data axes."""
    n = 1
    for a in data_axes:
        n *= mesh.shape[a]
    return n


def make_scatter_psum(
    mesh, n_rows: int, data_axes: Tuple[str, ...] = ("data",),
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Return ``(ids, mass) -> [n_rows] int64``: this rank's scatter-add of
    ``mass`` by ``ids`` (``ids`` broadcast to ``mass``'s shape), summed over
    the mesh's ranks. Ids outside ``[0, n_rows)`` are dropped, so padding
    ids (``n_rows`` or any id past it) are inert.

    The JAX twin takes every shard's row stacked ``[S, W]`` (or one shared
    ``[W]`` row); here each rank passes its own rows, whatever their shape.
    """
    if data_shard_count(mesh, data_axes) != mesh.size:
        raise ValueError("the data axes must span the mesh")

    def scatter_psum(ids: torch.Tensor, mass: torch.Tensor) -> torch.Tensor:
        ids = torch.broadcast_to(ids, mass.shape).reshape(-1).long()
        mass = mass.reshape(-1).long()
        keep = (ids >= 0) & (ids < n_rows)
        local = torch.zeros(n_rows, dtype=torch.int64, device=mass.device)
        local.index_add_(0, ids[keep], mass[keep])
        return mesh.all_reduce(local)

    return scatter_psum


class CounterAccumulator:
    """int64 host accumulation of per-wave counters.

    ``add`` widens before summing, so a wave already at the int32 range (the
    JAX package's device counters) cannot wrap.
    """

    def __init__(self, n_rows: int):
        self.total = np.zeros(n_rows, dtype=np.int64)

    def add(self, wave) -> None:
        if isinstance(wave, torch.Tensor):
            wave = wave.cpu().numpy()
        wave = np.asarray(wave)
        self.total += wave.astype(np.int64, copy=False)
