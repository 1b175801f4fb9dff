"""Neighbour sampling for sampled GraphSAGE training (twin of
``repro.graphs.sampler``).

Host numpy over the undirected CSR: for a batch of target nodes, a uniform
fanout sample with replacement per hop, returned as fixed-shape padded
blocks (``[n_targets, fanout]`` indices into the previous hop's node
list). The draws are the JAX package's, draw for draw, so one seed gives
the same blocks in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.graphs.structure import Graph

__all__ = ["SampledBlock", "NeighborSampler"]


@dataclasses.dataclass
class SampledBlock:
    """One hop of a sampled computation graph (fixed, padded shapes).

    ``neighbors[i, j]`` is the j-th sampled in-neighbour of target node i,
    as an index into ``src_nodes``; ``mask`` marks real samples (0 for a
    node with no neighbour, whose samples fall back to itself). The first
    ``n_targets`` entries of ``src_nodes`` are the targets.
    """

    src_nodes: np.ndarray   # [n_src] global node ids of this hop's inputs
    neighbors: np.ndarray   # [n_targets, fanout] int32 indices into src_nodes
    mask: np.ndarray        # [n_targets, fanout] float32
    n_targets: int


class NeighborSampler:
    """Uniform fanout sampler over the (undirected) CSR adjacency."""

    def __init__(self, graph: Graph, fanouts: Sequence[int], seed: int = 0):
        self.indptr, self.indices, _ = graph.undirected_csr
        self.fanouts = tuple(int(f) for f in fanouts)
        self.n_nodes = graph.n_nodes
        self._rng = np.random.default_rng(seed)

    def sample_batch(self, batch_nodes: np.ndarray) -> List[SampledBlock]:
        """The layered computation graph of ``batch_nodes``, outermost hop
        first: ``blocks[-1]`` aggregates into the batch nodes."""
        batch_nodes = np.asarray(batch_nodes, dtype=np.int64)
        blocks: List[SampledBlock] = []
        targets = batch_nodes
        for fanout in reversed(self.fanouts):
            nbrs, mask = self._sample_neighbors(targets, fanout)
            flat = nbrs.ravel()
            uniq = np.unique(np.concatenate([targets, flat]))
            # The targets first, then the other sampled nodes in id order.
            order = np.concatenate([targets, np.setdiff1d(uniq, targets, assume_unique=False)])
            sorter = np.argsort(order)
            local_nbrs = sorter[
                np.searchsorted(order, flat, sorter=sorter)
            ].astype(np.int32).reshape(nbrs.shape)
            blocks.append(SampledBlock(
                src_nodes=order, neighbors=local_nbrs, mask=mask, n_targets=int(targets.shape[0]),
            ))
            targets = order
        blocks.reverse()
        return blocks

    def _sample_neighbors(self, nodes: np.ndarray, fanout: int) -> Tuple[np.ndarray, np.ndarray]:
        starts = self.indptr[nodes]
        degs = self.indptr[nodes + 1] - starts
        offs = self._rng.integers(0, 1 << 62, size=(nodes.shape[0], fanout))
        safe_deg = np.maximum(degs, 1)[:, None]
        idx = starts[:, None] + (offs % safe_deg)
        nbrs = self.indices[np.minimum(idx, self.indices.shape[0] - 1)]
        mask = (degs[:, None] > 0).astype(np.float32) * np.ones((1, fanout), np.float32)
        nbrs = np.where(degs[:, None] > 0, nbrs, nodes[:, None])  # self-fallback
        return nbrs.astype(np.int64), mask

    def batches(self, batch_size: int, n_batches: int, seed: int = 0):
        """``n_batches`` batches of ``batch_size`` distinct node ids."""
        rng = np.random.default_rng(seed)
        for _ in range(n_batches):
            yield rng.choice(self.n_nodes, size=batch_size, replace=False)
