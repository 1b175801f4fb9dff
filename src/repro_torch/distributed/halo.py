"""Halo (ghost-vertex) exchange for partition-aware message passing (twin
of ``repro.distributed.halo``).

The thesis's *Shadow Construct* (§5.3.1): a remote neighbour is held
locally as a ghost row, refreshed once per message-passing step by a
collective. Each shard exports its boundary rows (its vertices another
shard references), one ``all_gather`` over the ranks publishes every
boundary, and each shard then gathers the ghosts it needs through an
index table built on the host.

Collective volume a step = S × B_max × F × bytes, where B_max tracks the
edge cut: a better DiDiC partitioning shrinks the collective. The tables
are built in numpy, array for array the JAX package's; the product runs
on each rank in torch (``all_gather``, then ``index_add_``). The exchange
is a ``torch.autograd.Function``, so a loss reaches the boundary rows of
every rank: its backward reduce-scatters the gathered rows' gradient back
to the ranks that exported them (:class:`_HaloExchange`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.distributed.counters import data_shard_count
from repro_torch.distributed.placement import PartitionedLayout
from repro_torch.graphs.structure import Graph

__all__ = ["HaloProgram", "build_halo_program", "make_partitioned_spmm"]


@dataclasses.dataclass
class HaloProgram:
    """Static, per-shard-stacked index tables for the halo exchange."""

    edge_src: np.ndarray       # [S, E_max] index into [local(block) ++ ghosts(G_max)]
    edge_dst: np.ndarray       # [S, E_max] local destination index (0..block)
    edge_w: np.ndarray         # [S, E_max] float32
    edge_mask: np.ndarray      # [S, E_max] float32
    boundary_idx: np.ndarray   # [S, B_max] local indices exported by each shard
    ghost_src: np.ndarray      # [S, G_max] index into flattened all-gather [S·B_max]
    block: int
    n_shards: int

    @property
    def e_max(self) -> int:
        return self.edge_src.shape[1]

    @property
    def b_max(self) -> int:
        return self.boundary_idx.shape[1]

    @property
    def g_max(self) -> int:
        return self.ghost_src.shape[1]

    def halo_bytes(self, d_feat: int, bytes_per_el: int = 4) -> int:
        """all_gather volume per step per device."""
        return self.n_shards * self.b_max * d_feat * bytes_per_el


def _pad_stack(rows, pad_value, dtype) -> np.ndarray:
    width = max((len(r) for r in rows), default=0)
    width = max(width, 1)
    out = np.full((len(rows), width), pad_value, dtype=dtype)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def build_halo_program(
    graph: Graph,
    layout: PartitionedLayout,
    edge_weights: np.ndarray | None = None,
) -> HaloProgram:
    """Precompute the per-shard edge/boundary/ghost tables (host-side)."""
    s_arr, r_arr, w_arr = graph.undirected
    if edge_weights is not None:
        w_arr = edge_weights
    S, block = layout.n_shards, layout.block
    new_s = layout.old_to_new[s_arr]
    new_r = layout.old_to_new[r_arr]
    shard_s = new_s // block
    shard_r = new_r // block
    local_s = new_s % block
    local_r = new_r % block

    # Boundary sets: nodes referenced by any foreign shard.
    cross = shard_s != shard_r
    boundary_rows = []
    boundary_pos = {}  # (shard, local_idx) -> position in that shard's export list
    for s in range(S):
        exported = np.unique(local_s[cross & (shard_s == s)])
        boundary_rows.append(exported)
        for pos, li in enumerate(exported):
            boundary_pos[(s, int(li))] = pos
    boundary_idx = _pad_stack(boundary_rows, 0, np.int32)
    b_max = boundary_idx.shape[1]

    # Per destination shard: edges grouped by receiver's shard; ghost table.
    edge_src_rows, edge_dst_rows, edge_w_rows = [], [], []
    ghost_rows = []
    for s in range(S):
        mask = shard_r == s
        es, ed, ew = local_s[mask], local_r[mask], w_arr[mask]
        eshard = shard_s[mask]
        is_local = eshard == s
        # ghosts: unique (src shard, src local) pairs for foreign senders
        foreign = ~is_local
        gkey = eshard[foreign] * block + es[foreign]
        guniq, ginv = np.unique(gkey, return_inverse=True)
        g_shard = guniq // block
        g_local = guniq % block
        ghost_src = np.array(
            [g_shard[i] * b_max + boundary_pos[(int(g_shard[i]), int(g_local[i]))]
             for i in range(guniq.shape[0])],
            dtype=np.int64,
        )
        src_index_f = np.empty(es.shape[0], dtype=np.int64)
        src_index_f[is_local] = es[is_local]
        src_index_f[foreign] = block + ginv  # ghosts appended after locals
        edge_src_rows.append(src_index_f)
        edge_dst_rows.append(ed)
        edge_w_rows.append(ew)
        ghost_rows.append(ghost_src)

    edge_src = _pad_stack(edge_src_rows, 0, np.int32)
    edge_dst = _pad_stack(edge_dst_rows, 0, np.int32)
    edge_w = _pad_stack(edge_w_rows, 0.0, np.float32)
    edge_mask = _pad_stack([np.ones(len(r), np.float32) for r in edge_w_rows], 0.0, np.float32)
    ghost_src = _pad_stack(ghost_rows, 0, np.int32)
    # Clamp padded ghost capacity so edge_src stays in range.
    g_max = ghost_src.shape[1]
    edge_src = np.minimum(edge_src, block + g_max - 1)
    return HaloProgram(
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_w=edge_w,
        edge_mask=edge_mask,
        boundary_idx=boundary_idx,
        ghost_src=ghost_src,
        block=block,
        n_shards=S,
    )


class _HaloExchange(torch.autograd.Function):
    """Every data shard's boundary rows ``x_local[bidx]``, gathered along
    ``axes`` in shard order to ``[S·B_max, F]``. Backward: the gathered
    rows' gradient summed over the shards, each keeping its own block (a
    reduce-scatter), added into its rows. Every rank of the data group must
    take part in both directions."""

    @staticmethod
    def forward(ctx, x_local, bidx, mesh, axes):
        ctx.save_for_backward(bidx)
        ctx.mesh, ctx.axes, ctx.n_rows = mesh, axes, x_local.shape[0]
        return torch.cat(mesh.all_gather(x_local[bidx], axis=axes), dim=0)

    @staticmethod
    def backward(ctx, grad_all):
        (bidx,) = ctx.saved_tensors
        mine = ctx.mesh.reduce_scatter(grad_all, axis=ctx.axes)    # [B_max, F]
        grad = torch.zeros((ctx.n_rows, mine.shape[1]), dtype=mine.dtype, device=mine.device)
        return grad.index_add_(0, bidx, mine), None, None, None


def make_partitioned_spmm(
    program: HaloProgram, mesh, data_axes: Tuple[str, ...] = ("data",)
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return ``x_local [block, F] → Σ_e w·x[src]`` for this rank's block,
    with the halo exchange: this rank's boundary rows go into one
    ``all_gather``, its ghosts are read from the result, and its edges are
    summed into its rows with ``index_add_``. The JAX twin takes the whole
    ``[S·block, F]`` array sharded over the mesh; here each rank passes and
    gets back its own block: the block of its index along ``data_axes``,
    exchanged with the ranks of its data group only (on a mesh with a model
    axis, the ranks of one data column share a shard)."""
    if data_shard_count(mesh, data_axes) != program.n_shards:
        raise ValueError(f"the program has {program.n_shards} shards, the mesh "
                         f"{data_shard_count(mesh, data_axes)}")
    r, dev, block = mesh.axis_index(data_axes), mesh.device, program.block
    esrc = torch.as_tensor(program.edge_src[r], dtype=torch.int64, device=dev)
    edst = torch.as_tensor(program.edge_dst[r], dtype=torch.int64, device=dev)
    coef = torch.as_tensor(program.edge_w[r] * program.edge_mask[r], device=dev)
    bidx = torch.as_tensor(program.boundary_idx[r], dtype=torch.int64, device=dev)
    gsrc = torch.as_tensor(program.ghost_src[r], dtype=torch.int64, device=dev)

    def spmm(x_local: torch.Tensor) -> torch.Tensor:
        all_b = _HaloExchange.apply(x_local, bidx, mesh, data_axes)  # [S·B_max, F]
        xx = torch.cat([x_local, all_b[gsrc]], dim=0)
        out = torch.zeros((block, x_local.shape[1]), dtype=x_local.dtype, device=x_local.device)
        return out.index_add_(0, edst, coef[:, None] * xx[esrc])

    return spmm
