"""Graph containers, format conversions and the delta-overlay store
(host-side numpy).

Twin of ``repro.graphs.structure``. The graph stays on the host in COO
form, and derives:

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

A growing graph carries a **base + delta overlay** (:class:`GraphStore`):
when growth begins the store fixes a vertex capacity ``n_cap >= n_nodes``
and an edge capacity ``e_cap >= n_edges``, and every device buffer built
for a store-backed graph (the replay engines' tables, DiDiC's coefficient
tables and state, the mesh DiDiC's halo tables) is sized to capacity with
an inert tail: dead rows get zero mass, dead edges point at a sentinel row.
A grown graph (a new :class:`Graph` from :meth:`Graph.with_vertices` or
:meth:`Graph.with_edges`) shares its parent's store while it fits, and the
engines, replayers and programs cached in ``store.caches`` *adopt* it: they
write the grown graph into the buffers they already hold instead of being
built again. When an insert would overflow the capacity the lineage
**compacts**: a new store with fresh headroom over the grown extents,
``compactions`` one higher, and everything cached is built once more on
it. The host COO arrays stay the logical truth at every step; capacities
only shape device buffers, so host results do not change.
"""

from __future__ import annotations

import dataclasses
import os
from functools import cached_property
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "Graph",
    "GraphStore",
    "GROWTH_HEADROOM",
    "BlockEll",
    "PaddedNeighbors",
    "coalesce_edges",
    "symmetrize",
    "padded_neighbors",
]

# Capacity multiplier applied when a store is allocated (at growth onset and
# at every compaction): a delta sized to ``headroom - 1`` times the current
# extents absorbs that much relative growth before the next compaction.
# Default only: ``GraphStore(headroom=...)``, ``Graph.ensure_store(headroom=...)``
# or the ``REPRO_GROWTH_HEADROOM`` environment variable override it (padded
# capacity costs device memory linearly).
GROWTH_HEADROOM = 2.0


def _resolve_headroom(headroom: Optional[float] = None) -> float:
    if headroom is None:
        headroom = float(os.environ.get("REPRO_GROWTH_HEADROOM", GROWTH_HEADROOM))
    headroom = float(headroom)
    if headroom < 1.0:
        raise ValueError(f"growth headroom must be >= 1.0, got {headroom}")
    return headroom


class GraphStore:
    """Delta-overlay control block shared along one growing graph lineage.

    The store pins the padded device capacity (``n_cap`` rows, ``e_cap``
    edge slots) that every overlay buffer is sized to, records the base
    extents the current delta sits on (``base_nodes``/``base_edges``; the
    delta cursors are ``graph.n_nodes - base_nodes`` and ``graph.n_edges -
    base_edges``) and counts ``compactions``. ``caches`` holds the engines,
    replayers, DiDiC tables and mesh programs of the lineage, keyed by
    their parameters, so that a grown graph (a new :class:`Graph`) reuses
    them by adoption. The store holds no graph data: the host COO arrays of
    each :class:`Graph` are the truth.
    """

    def __init__(
        self,
        n_cap: int,
        e_cap: int,
        base_nodes: int,
        base_edges: int,
        compactions: int = 0,
        headroom: Optional[float] = None,
    ) -> None:
        self.n_cap = int(n_cap)
        self.e_cap = int(e_cap)
        self.base_nodes = int(base_nodes)
        self.base_edges = int(base_edges)
        self.compactions = int(compactions)
        # A compaction re-derives capacity with the lineage's headroom, not
        # whatever the process default is at that moment.
        self.headroom = _resolve_headroom(headroom)
        self.caches: Dict = {}

    def would_overflow(self, graph: "Graph", n_new_vertices: int, n_new_edges: int) -> bool:
        """True if appending the given counts to ``graph`` exceeds capacity."""
        return (
            graph.n_nodes + int(n_new_vertices) > self.n_cap
            or graph.n_edges + int(n_new_edges) > self.e_cap
        )

    def delta_nodes(self, graph: "Graph") -> int:
        """Vertex append cursor: rows of ``graph`` living in the delta."""
        return graph.n_nodes - self.base_nodes

    def delta_edges(self, graph: "Graph") -> int:
        """Edge append cursor: edge slots of ``graph`` living in the delta."""
        return graph.n_edges - self.base_edges

    def _carry_to(self, old_graph: "Graph", new_graph: "Graph") -> None:
        """Attach this store to a grown graph, compacting on overflow: the
        old base and delta (``old_graph``'s extents) become the new base,
        the overflowing insert lands in the new delta, and the capacities
        are derived with headroom from the grown extents."""
        if new_graph.n_nodes <= self.n_cap and new_graph.n_edges <= self.e_cap:
            new_graph.store = self
        else:
            new_graph.store = GraphStore(
                n_cap=_with_headroom(new_graph.n_nodes, self.headroom),
                e_cap=_with_headroom(new_graph.n_edges, self.headroom),
                base_nodes=old_graph.n_nodes,
                base_edges=old_graph.n_edges,
                compactions=self.compactions + 1,
                headroom=self.headroom,
            )

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"GraphStore(n_cap={self.n_cap}, e_cap={self.e_cap}, "
            f"base={self.base_nodes}/{self.base_edges}, "
            f"compactions={self.compactions})"
        )


def _with_headroom(extent: int, headroom: Optional[float] = None) -> int:
    return int(np.ceil(_resolve_headroom(headroom) * max(int(extent), 1)))


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

    def density(self) -> float:
        """Stored blocks over the blocks of the padded square."""
        nnzb = float(self.block_mask.sum())
        total = (self.padded_rows / self.block_size) ** 2
        return nnzb / max(total, 1.0)

    def to_dense(self) -> np.ndarray:
        """The logical ``[n_rows, n_cols]`` matrix (host numpy)."""
        bs = self.block_size
        out = np.zeros((self.padded_rows, self.padded_rows), dtype=self.blocks.dtype)
        for i in range(self.n_block_rows):
            for j in range(self.max_nnzb):
                if self.block_mask[i, j] > 0:
                    c = int(self.block_cols[i, j])
                    out[i * bs:(i + 1) * bs, c * bs:(c + 1) * bs] += self.blocks[i, j]
        return out[: self.n_rows, : self.n_cols]


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
    def max_deg(self) -> int:
        return self.nbr.shape[1]

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
    store: Optional[GraphStore] = dataclasses.field(default=None, repr=False)

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

    # ----------------------------------------------------- delta overlay
    def ensure_store(
        self,
        n_cap: Optional[int] = None,
        e_cap: Optional[int] = None,
        headroom: Optional[float] = None,
    ) -> GraphStore:
        """Attach (or return) the delta-overlay store of this lineage.

        Called when growth begins; the default capacities reserve
        ``headroom`` times the current extents (``headroom`` defaults to the
        ``REPRO_GROWTH_HEADROOM`` environment variable, then
        :data:`GROWTH_HEADROOM`). Explicit caps must cover the graph.
        """
        if self.store is not None:
            return self.store
        n_cap = _with_headroom(self.n_nodes, headroom) if n_cap is None else int(n_cap)
        e_cap = _with_headroom(self.n_edges, headroom) if e_cap is None else int(e_cap)
        if n_cap < self.n_nodes or e_cap < self.n_edges:
            raise ValueError(
                f"store capacity ({n_cap}, {e_cap}) below current extents "
                f"({self.n_nodes}, {self.n_edges})"
            )
        self.store = GraphStore(
            n_cap=n_cap, e_cap=e_cap,
            base_nodes=self.n_nodes, base_edges=self.n_edges,
            headroom=headroom,
        )
        return self.store

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
        the structure-derived caches held by the graph (CSR views, layouts)
        are built afresh on the new object. A :class:`GraphStore` is carried
        over while the result fits its capacity (the store's engines then
        adopt the new graph) and replaced by a compacted store otherwise.
        This is how the service applies a dynamism log that inserts edges.
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
        out = Graph(
            n_nodes=self.n_nodes,
            senders=np.concatenate([self.senders, senders]),
            receivers=np.concatenate([self.receivers, receivers]),
            edge_weight=np.concatenate([self.edge_weight, weights]),
            node_attrs=self.node_attrs,
            name=self.name,
        )
        if self.store is not None:
            self.store._carry_to(self, out)
        return out

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
        reallocated, so the old graph stays valid, and the graph's own
        structure caches are built afresh on the new object; a
        :class:`GraphStore` is carried or compacted as in
        :meth:`with_edges`. This is how the service applies a dynamism log
        that allocates vertices (the Insert experiment).
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
        out = Graph(
            n_nodes=n_total,
            senders=np.concatenate([self.senders, senders]),
            receivers=np.concatenate([self.receivers, receivers]),
            edge_weight=np.concatenate([self.edge_weight, weights]),
            node_attrs=new_attrs,
            name=self.name,
        )
        if self.store is not None:
            self.store._carry_to(self, out)
        return out

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

    # ------------------------------------------------------------- utilities
    def subgraph(self, node_mask: np.ndarray) -> "Graph":
        """Induced subgraph, its nodes renumbered densely. Node attributes
        whose first extent is not ``n_nodes`` are left out."""
        node_mask = np.asarray(node_mask, dtype=bool)
        new_id = np.full(self.n_nodes, -1, dtype=np.int64)
        kept = np.nonzero(node_mask)[0]
        new_id[kept] = np.arange(kept.shape[0])
        e_keep = node_mask[self.senders] & node_mask[self.receivers]
        attrs = {k: v[kept] for k, v in self.node_attrs.items() if v.shape[0] == self.n_nodes}
        return Graph(
            n_nodes=int(kept.shape[0]),
            senders=new_id[self.senders[e_keep]],
            receivers=new_id[self.receivers[e_keep]],
            edge_weight=self.edge_weight[e_keep],
            node_attrs=attrs,
            name=self.name + "_sub",
        )

    def clustering_stats(self, sample: int = 2000, seed: int = 0) -> float:
        """Approximate global clustering coefficient over ``sample`` vertices
        drawn without replacement."""
        indptr, indices, _ = self.undirected_csr
        rng = np.random.default_rng(seed)
        nodes = rng.choice(self.n_nodes, size=min(sample, self.n_nodes), replace=False)
        coeffs = []
        for v in nodes:
            nbrs = indices[indptr[v]:indptr[v + 1]]
            d = nbrs.shape[0]
            if d < 2:
                coeffs.append(0.0)
                continue
            nbr_set = set(nbrs.tolist())
            links = 0
            for u in nbrs:
                row = indices[indptr[u]:indptr[u + 1]]
                links += sum(1 for x in row if int(x) in nbr_set)
            coeffs.append(links / (d * (d - 1)))
        return float(np.mean(coeffs)) if coeffs else 0.0

    def summary(self) -> str:
        return (
            f"Graph({self.name}): |V|={self.n_nodes:,} |E|={self.n_edges:,} "
            f"avg_out_deg={self.n_edges / max(self.n_nodes, 1):.2f}"
        )
