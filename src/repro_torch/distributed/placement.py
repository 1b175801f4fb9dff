"""DiDiC-partition-aware data placement (twin of ``repro.distributed.placement``).

``build_layout`` takes a partition map (from DiDiC or any baseline) and
re-indexes the vertices so that each data shard owns one contiguous,
equally padded block. Cross-shard edges are then exactly the rows the halo
exchange (:mod:`.halo`) moves per message-passing step: placement quality
is edge cut in hardware units.

k (partitions) is decoupled from the shard count: with k > S, partitions
fold onto shards round-robin; k < S is rejected (pick k = S·m). Host
numpy, array for array the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core import metrics
from repro_torch.graphs.structure import Graph

__all__ = ["PartitionedLayout", "build_layout", "collective_bytes_estimate"]


@dataclasses.dataclass
class PartitionedLayout:
    """Node placement: shard s owns new ids [s·block, (s+1)·block)."""

    old_to_new: np.ndarray     # [N] original id → padded new id
    new_to_old: np.ndarray     # [S·block] padded new id → original id (-1 = pad)
    shard_of_node: np.ndarray  # [N] shard owning each original node
    n_shards: int
    block: int                 # padded nodes per shard

    @property
    def padded_n(self) -> int:
        return self.n_shards * self.block

    def scatter_features(self, x: np.ndarray, fill: float = 0.0) -> np.ndarray:
        """[N, F] features → [S·block, F] padded/permuted layout."""
        out = np.full((self.padded_n,) + x.shape[1:], fill, dtype=x.dtype)
        out[self.old_to_new] = x
        return out

    def gather_features(self, xp: np.ndarray) -> np.ndarray:
        return xp[self.old_to_new]


def build_layout(
    graph: Graph,
    parts: np.ndarray,
    n_shards: int,
    block_multiple: int = 8,
) -> PartitionedLayout:
    parts = np.asarray(parts, dtype=np.int64)
    k = int(parts.max()) + 1
    if k < n_shards:
        raise ValueError(f"k={k} partitions cannot cover {n_shards} shards; use k = S·m")
    shard_of_part = np.arange(k) % n_shards
    shard_of_node = shard_of_part[parts]

    order = np.argsort(shard_of_node, kind="stable")
    counts = np.bincount(shard_of_node, minlength=n_shards)
    block = int(-(-counts.max() // block_multiple) * block_multiple)

    old_to_new = np.empty(graph.n_nodes, dtype=np.int64)
    new_to_old = np.full(n_shards * block, -1, dtype=np.int64)
    start = 0
    for s in range(n_shards):
        nodes = order[start:start + counts[s]]
        new_ids = s * block + np.arange(counts[s])
        old_to_new[nodes] = new_ids
        new_to_old[new_ids] = nodes
        start += counts[s]
    return PartitionedLayout(
        old_to_new=old_to_new,
        new_to_old=new_to_old,
        shard_of_node=shard_of_node.astype(np.int32),
        n_shards=n_shards,
        block=block,
    )


def collective_bytes_estimate(
    graph: Graph, parts: np.ndarray, d_feat: int, bytes_per_el: int = 4
) -> Tuple[float, float]:
    """(halo bytes per message-passing step, edge-cut fraction): the
    boundary vertex set × ``d_feat`` × bytes, the paper's inter-partition
    traffic in wire bytes."""
    s, r, _ = graph.undirected
    cross = parts[s] != parts[r]
    boundary = np.unique(s[cross])
    return float(boundary.shape[0] * d_feat * bytes_per_el), metrics.edge_cut_fraction(graph, parts)
