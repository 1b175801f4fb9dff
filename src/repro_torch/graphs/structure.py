"""Graph containers and format conversions (host-side numpy).

Twin of ``repro.graphs.structure`` without the growth store
(``GraphStore``): the host COO arrays are the whole graph, and a graph grown
by :meth:`Graph.with_edges` or :meth:`Graph.with_vertices` is a new object
whose engines and layouts are built afresh. The graph stays on the host in
COO form, and derives:

* CSR views for host-side traversal (the scalar oracle, the op-log
  generators),
* the symmetrized (undirected) edge list for diffusion (DiDiC, paper §3.2),
* the padded in-neighbour gather layout (:class:`PaddedNeighbors`) that the
  ``frontier_gather`` kernel walks,
* the padded block-ELL layout (:class:`BlockEll`) that the ``bell_matmul``
  kernel walks.

Every array here is produced by the same numpy operations as the JAX
package's twin, so the layouts are identical element for element (the
parity tests hold them to that). Device tensors are made by the engines
that consume these layouts.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "Graph",
    "BlockEll",
    "PaddedNeighbors",
    "coalesce_edges",
    "symmetrize",
    "padded_neighbors",
]


def coalesce_edges(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: Optional[np.ndarray],
    n_nodes: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort edges by (sender, receiver), merge duplicates (summing weights)."""
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    if weights is None:
        weights = np.ones(senders.shape[0], dtype=np.float32)
    weights = np.asarray(weights, dtype=np.float32)
    key = senders * n_nodes + receivers
    order = np.argsort(key, kind="stable")
    key, senders, receivers, weights = key[order], senders[order], receivers[order], weights[order]
    uniq, inv = np.unique(key, return_inverse=True)
    merged_w = np.zeros(uniq.shape[0], dtype=np.float32)
    np.add.at(merged_w, inv, weights)
    first = np.searchsorted(key, uniq)
    return senders[first].astype(np.int32), receivers[first].astype(np.int32), merged_w


def symmetrize(
    senders: np.ndarray, receivers: np.ndarray, weights: np.ndarray, n_nodes: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return the undirected (symmetrized, coalesced, loop-free) edge set."""
    s = np.concatenate([senders, receivers])
    r = np.concatenate([receivers, senders])
    w = np.concatenate([weights, weights])
    keep = s != r
    return coalesce_edges(s[keep], r[keep], w[keep], n_nodes)


@dataclasses.dataclass(frozen=True)
class BlockEll:
    """Padded block-ELL (BELL) block-sparse matrix layout.

    ``blocks[i, j]`` is the dense ``(bs, bs)`` block at block-row ``i``,
    slot ``j``; ``block_cols[i, j]`` its block-column. Padded slots carry
    zero blocks, column 0 and mask 0.
    """

    blocks: np.ndarray       # [n_block_rows, max_nnzb, bs, bs] float32
    block_cols: np.ndarray   # [n_block_rows, max_nnzb] int32 (0 where padded)
    block_mask: np.ndarray   # [n_block_rows, max_nnzb] float32 {0,1}
    n_rows: int              # logical (unpadded) row count
    n_cols: int
    block_size: int

    @property
    def n_block_rows(self) -> int:
        return self.blocks.shape[0]

    @property
    def max_nnzb(self) -> int:
        return self.blocks.shape[1]

    @property
    def padded_rows(self) -> int:
        return self.n_block_rows * self.block_size


@dataclasses.dataclass(frozen=True)
class PaddedNeighbors:
    """Rectangular (ELL-style) gather layout of an edge set.

    Row ``v`` lists the in-neighbours of ``v`` (every edge ``u → v`` puts
    ``u`` in ``nbr[v]``), padded to the max in-degree or to ``cap``. Padded
    slots carry index 0 and mask 0. Edges past the cap live in the COO
    ``spill_*`` tail (empty when uncapped).
    """

    nbr: np.ndarray      # [N, D] int32 in-neighbour ids (0 where padded)
    w: np.ndarray        # [N, D] float32 edge weights (0 where padded)
    mask: np.ndarray     # [N, D] float32 {0, 1}
    spill_s: np.ndarray  # [S] int32 senders of over-cap edges
    spill_r: np.ndarray  # [S] int32 receivers of over-cap edges
    spill_w: np.ndarray  # [S] float32 weights of over-cap edges

    @property
    def n_nodes(self) -> int:
        return self.nbr.shape[0]

    @property
    def n_spill(self) -> int:
        return self.spill_s.shape[0]


def padded_neighbors(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: Optional[np.ndarray],
    n_nodes: int,
    cap: Optional[int] = None,
) -> PaddedNeighbors:
    """Pack an edge list into the :class:`PaddedNeighbors` gather layout.

    ``cap`` bounds the slot axis; edges past it spill into the COO tail.
    """
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    if weights is None:
        weights = np.ones(senders.shape[0], dtype=np.float32)
    weights = np.asarray(weights, dtype=np.float32)
    counts = np.bincount(receivers, minlength=n_nodes)
    d = max(int(counts.max(initial=0)), 1)
    if cap is not None:
        d = min(d, max(int(cap), 1))
    order = np.argsort(receivers, kind="stable")
    r_sorted = receivers[order]
    s_sorted = senders[order]
    w_sorted = weights[order]
    starts = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(r_sorted.shape[0], dtype=np.int64) - starts[r_sorted]
    main = slot < d
    nbr = np.zeros((n_nodes, d), dtype=np.int32)
    w = np.zeros((n_nodes, d), dtype=np.float32)
    mask = np.zeros((n_nodes, d), dtype=np.float32)
    nbr[r_sorted[main], slot[main]] = s_sorted[main].astype(np.int32)
    w[r_sorted[main], slot[main]] = w_sorted[main]
    mask[r_sorted[main], slot[main]] = 1.0
    sp = ~main
    return PaddedNeighbors(
        nbr=nbr, w=w, mask=mask,
        spill_s=s_sorted[sp].astype(np.int32),
        spill_r=r_sorted[sp].astype(np.int32),
        spill_w=w_sorted[sp],
    )


@dataclasses.dataclass
class Graph:
    """A directed, weighted multigraph with optional node metadata.

    ``senders[e] -> receivers[e]`` with weight ``edge_weight[e]``. Node
    metadata (``node_type``, coordinates, ...) lives in ``node_attrs``.
    """

    n_nodes: int
    senders: np.ndarray            # [E] int32
    receivers: np.ndarray          # [E] int32
    edge_weight: np.ndarray        # [E] float32
    node_attrs: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    name: str = "graph"

    def __post_init__(self) -> None:
        self.senders = np.asarray(self.senders, dtype=np.int32)
        self.receivers = np.asarray(self.receivers, dtype=np.int32)
        if self.edge_weight is None:
            self.edge_weight = np.ones(self.senders.shape[0], dtype=np.float32)
        self.edge_weight = np.asarray(self.edge_weight, dtype=np.float32)
        if not (self.senders.shape == self.receivers.shape == self.edge_weight.shape):
            raise ValueError("senders, receivers and edge_weight must have one shape")

    @property
    def n_edges(self) -> int:
        return int(self.senders.shape[0])

    @cached_property
    def out_degree(self) -> np.ndarray:
        return np.bincount(self.senders, minlength=self.n_nodes).astype(np.int32)

    @cached_property
    def in_degree(self) -> np.ndarray:
        return np.bincount(self.receivers, minlength=self.n_nodes).astype(np.int32)

    @cached_property
    def degree(self) -> np.ndarray:
        return self.out_degree + self.in_degree

    @cached_property
    def undirected(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(senders, receivers, weights) of the symmetrized loop-free graph."""
        return symmetrize(self.senders, self.receivers, self.edge_weight, self.n_nodes)

    @cached_property
    def weighted_degree(self) -> np.ndarray:
        """d(v) = sum of undirected incident edge weights (paper Eq. 3.4)."""
        s, _, w = self.undirected
        d = np.zeros(self.n_nodes, dtype=np.float64)
        np.add.at(d, s, w)
        return d.astype(np.float32)

    @cached_property
    def csr(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(indptr, indices, weights) over *directed* out-edges."""
        order = np.argsort(self.senders, kind="stable")
        indices = self.receivers[order]
        weights = self.edge_weight[order]
        counts = np.bincount(self.senders, minlength=self.n_nodes)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return indptr, indices, weights

    @cached_property
    def undirected_csr(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        s, r, w = self.undirected
        order = np.argsort(s, kind="stable")
        indices = r[order]
        weights = w[order]
        counts = np.bincount(s, minlength=self.n_nodes)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return indptr, indices, weights

    # -------------------------------------------------------------- updates
    def with_edges(
        self,
        senders: np.ndarray,
        receivers: np.ndarray,
        weights: Optional[np.ndarray] = None,
    ) -> "Graph":
        """New :class:`Graph` with the given edges appended.

        The node set (and ``node_attrs``, shared by reference) is unchanged,
        so partition maps, evaluation logs and per-vertex state stay valid;
        every structure-derived cache (CSR views, layouts, engines, DiDiC's
        products) is built afresh on the new object. This is how the
        service applies a dynamism log that inserts edges.
        """
        senders = np.asarray(senders, dtype=self.senders.dtype)
        receivers = np.asarray(receivers, dtype=self.receivers.dtype)
        if weights is None:
            weights = np.ones(senders.shape[0], dtype=np.float32)
        weights = np.asarray(weights, dtype=np.float32)
        if not (senders.shape == receivers.shape == weights.shape):
            raise ValueError("with_edges arrays must have matching shapes")
        for ends in (senders, receivers):
            if ends.size and (ends.min() < 0 or ends.max() >= self.n_nodes):
                raise ValueError("with_edges endpoints must be existing vertices")
        return Graph(
            n_nodes=self.n_nodes,
            senders=np.concatenate([self.senders, senders]),
            receivers=np.concatenate([self.receivers, receivers]),
            edge_weight=np.concatenate([self.edge_weight, weights]),
            node_attrs=self.node_attrs,
            name=self.name,
        )

    def with_vertices(
        self,
        n_new: int,
        attrs: Optional[Dict[str, np.ndarray]] = None,
        senders: Optional[np.ndarray] = None,
        receivers: Optional[np.ndarray] = None,
        weights: Optional[np.ndarray] = None,
    ) -> "Graph":
        """New :class:`Graph` with ``n_new`` vertices appended, plus their
        incident edges.

        The new vertices take ids ``n_nodes .. n_nodes + n_new - 1``; edge
        endpoints may name old or new vertices. ``attrs[key]`` gives the
        appended rows (shape ``[n_new, ...]``) of per-node metadata; keys
        not given get zero rows of the matching dtype (sentinels such as
        ``parent = -1`` must be passed explicitly). Attr arrays are
        reallocated, so the old graph stays valid, and every structure
        cache is built afresh on the new object. This is how the service
        applies a dynamism log that allocates vertices (the Insert
        experiment).
        """
        n_new = int(n_new)
        if n_new < 0:
            raise ValueError("with_vertices needs n_new >= 0")
        n_total = self.n_nodes + n_new
        attrs = attrs or {}
        unknown = set(attrs) - set(self.node_attrs)
        if unknown:
            raise ValueError(f"with_vertices attrs not in node_attrs: {sorted(unknown)}")
        new_attrs: Dict[str, np.ndarray] = {}
        for key, old in self.node_attrs.items():
            if old.shape[0] != self.n_nodes:
                new_attrs[key] = old  # not per-node metadata; carried as-is
                continue
            rows = attrs.get(key)
            if rows is None:
                rows = np.zeros((n_new,) + old.shape[1:], dtype=old.dtype)
            else:
                rows = np.asarray(rows, dtype=old.dtype)
                if rows.shape != (n_new,) + old.shape[1:]:
                    raise ValueError(
                        f"with_vertices attrs[{key!r}] has shape {rows.shape}, "
                        f"want {(n_new,) + old.shape[1:]}"
                    )
            new_attrs[key] = np.concatenate([old, rows])
        if senders is None:
            senders = np.zeros(0, dtype=self.senders.dtype)
        if receivers is None:
            receivers = np.zeros(0, dtype=self.receivers.dtype)
        senders = np.asarray(senders, dtype=self.senders.dtype)
        receivers = np.asarray(receivers, dtype=self.receivers.dtype)
        if weights is None:
            weights = np.ones(senders.shape[0], dtype=np.float32)
        weights = np.asarray(weights, dtype=np.float32)
        if not (senders.shape == receivers.shape == weights.shape):
            raise ValueError("with_vertices edge arrays must have matching shapes")
        for ends in (senders, receivers):
            if ends.size and (ends.min() < 0 or ends.max() >= n_total):
                raise ValueError(
                    "with_vertices endpoints must be existing or appended vertices"
                )
        return Graph(
            n_nodes=n_total,
            senders=np.concatenate([self.senders, senders]),
            receivers=np.concatenate([self.receivers, receivers]),
            edge_weight=np.concatenate([self.edge_weight, weights]),
            node_attrs=new_attrs,
            name=self.name,
        )

    def to_block_ell(self, block_size: int = 128, undirected: bool = True) -> BlockEll:
        """Pack the (weighted) adjacency into the BELL layout for ``bell_matmul``.

        Rows/cols are zero-padded to a multiple of ``block_size``; the block
        at (bi, bj) is dense ``A[bi*bs:(bi+1)*bs, bj*bs:(bj+1)*bs]``. Vertices
        keep their ids (no reordering), so a block row touches as many block
        columns as its vertices' neighbours span. Cached per
        ``(block_size, undirected)``.
        """
        cache = self.__dict__.setdefault("_bell_cache", {})
        key = (block_size, undirected)
        if key in cache:
            return cache[key]
        if undirected:
            s, r, w = self.undirected
        else:
            s, r, w = self.senders, self.receivers, self.edge_weight
        bs = block_size
        nbr = -(-self.n_nodes // bs)  # ceil
        bi = s // bs
        bj = r // bs
        pair = bi.astype(np.int64) * nbr + bj
        uniq_pairs, inv = np.unique(pair, return_inverse=True)
        u_bi = (uniq_pairs // nbr).astype(np.int64)
        u_bj = (uniq_pairs % nbr).astype(np.int64)
        slot_of_pair = np.zeros(uniq_pairs.shape[0], dtype=np.int64)
        row_counts = np.bincount(u_bi, minlength=nbr)
        max_nnzb = max(int(row_counts.max(initial=0)), 1)
        order = np.argsort(u_bi, kind="stable")
        slot_running = np.arange(uniq_pairs.shape[0])
        row_starts = np.concatenate([[0], np.cumsum(row_counts)])
        slot_of_pair[order] = slot_running - row_starts[u_bi[order]]
        blocks = np.zeros((nbr, max_nnzb, bs, bs), dtype=np.float32)
        block_cols = np.zeros((nbr, max_nnzb), dtype=np.int32)
        block_mask = np.zeros((nbr, max_nnzb), dtype=np.float32)
        block_cols[u_bi, slot_of_pair] = u_bj.astype(np.int32)
        block_mask[u_bi, slot_of_pair] = 1.0
        e_slot = slot_of_pair[inv]
        np.add.at(blocks, (bi, e_slot, s % bs, r % bs), w)
        bell = BlockEll(
            blocks=blocks,
            block_cols=block_cols,
            block_mask=block_mask,
            n_rows=self.n_nodes,
            n_cols=self.n_nodes,
            block_size=bs,
        )
        cache[key] = bell
        return bell

    def summary(self) -> str:
        return (
            f"Graph({self.name}): |V|={self.n_nodes:,} |E|={self.n_edges:,} "
            f"avg_out_deg={self.n_edges / max(self.n_nodes, 1):.2f}"
        )
