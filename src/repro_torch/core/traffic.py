"""Access-pattern traffic simulator (paper §6.2, Ch. 7 measurements).

Twin of ``repro.core.traffic``. Per-dataset synthetic, *non-uniform* access
patterns are generated once into a deterministic, replayable operation log
(the "evaluation log"), then executed against a partitioned graph while
counting:

* **total traffic**  — one unit per graph action (index lookup, property
  read, edge retrieval, endpoint retrieval — paper §6.2.1),
* **global traffic** — actions that require two partitions to communicate
  (an edge traversal whose endpoints live on different partitions),
* **per-partition traffic** — units attributed to the partition serving
  each action (drives the load-balance CV of Tables 7.2–7.4),
* **per-vertex traffic** — feeds the ``least_traffic`` insert method.

Per-step action counts follow the paper's tables:
  File system (Table 6.1): T_L = 2, T_PG = 1
  GIS        (Table 6.3): T_L = 8, T_PG = 1
  Twitter    (Table 6.4): T_L = 2, T_PG = 1

``execute_ops`` dispatches between two engines that produce identical
counters: ``engine="batched"`` (default), the PyTorch engine of
:mod:`repro_torch.core.traffic_batched` on ``device``, and
``engine="scalar"``, the NumPy/heapq oracle below — one op at a time, the
semantic reference.

Shared semantics (both engines):

* BFS patterns count one traversal step per (op, frontier-vertex → child)
  edge, with path multiplicity; a filesystem op retires after the level at
  which its target first appears among the children.
* The GIS pattern accounts the *A\\* expansion set* under the Euclidean
  heuristic ``h`` (consistent, since road weights ≥ straight-line length):

      S(op) = { u reachable from src : (f(u), u) <_lex (f(dst), dst) },
      f(u) = g*(u) + h(u, dst),

  truncated to the ``max_expansions`` lex-smallest entries. Each u ∈ S
  contributes deg(u) traversal steps (its edge expansions).

The placement's exception table has capacity 0 in this slice, so no
replica routing appears here (a step's ``t_pg`` always books to the
receiver's partition).
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
from typing import Optional, Tuple

import numpy as np

from repro_torch.graphs.generators import FS_FILE, FS_FOLDER, _CITIES
from repro_torch.graphs.structure import Graph

__all__ = [
    "OpLog",
    "TrafficResult",
    "generate_ops",
    "execute_ops",
    "pattern_for",
]


@dataclasses.dataclass
class OpLog:
    """A replayable evaluation log (paper §6.1: deterministic, reusable)."""

    pattern: str              # filesystem | gis_short | gis_long | twitter
    starts: np.ndarray        # [n_ops]
    ends: np.ndarray          # [n_ops] (unused by twitter: -1)
    t_l: int                  # local actions per traversal step
    t_pg: int                 # potentially-global actions per step

    @property
    def n_ops(self) -> int:
        return int(self.starts.shape[0])

    def fingerprint(self) -> str:
        """Content hash, stable across regenerated-but-equal logs.

        Equal for regenerated-but-equal logs, and equal to the JAX
        package's fingerprint of the same log. Cached: logs are immutable
        by contract (§6.1 — deterministic, reusable).
        """
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            h = hashlib.sha1()
            h.update(self.pattern.encode())
            h.update(np.asarray([self.t_l, self.t_pg], dtype=np.int64).tobytes())
            h.update(np.ascontiguousarray(self.starts, dtype=np.int64).tobytes())
            h.update(np.ascontiguousarray(self.ends, dtype=np.int64).tobytes())
            fp = self.__dict__["_fingerprint"] = h.hexdigest()
        return fp


@dataclasses.dataclass
class TrafficResult:
    per_op_total: np.ndarray      # [n_ops] traffic units
    per_op_global: np.ndarray     # [n_ops] global (inter-partition) units
    per_partition: np.ndarray     # [k] units served per partition
    per_vertex: np.ndarray        # [N] units served per vertex

    @property
    def total(self) -> float:
        return float(self.per_op_total.sum())

    @property
    def global_(self) -> float:
        return float(self.per_op_global.sum())

    @property
    def percent_global(self) -> float:
        """T_G% of Eq. 7.2."""
        return self.global_ / max(self.total, 1e-12)


# ===========================================================================
# Operation-log generation
# ===========================================================================
def _gen_filesystem(graph: Graph, n_ops: int, seed: int) -> OpLog:
    """End ∝ degree among files/folders; start = random ancestor (§6.2.1)."""
    rng = np.random.default_rng(seed)
    nt = graph.node_attrs["node_type"]
    parent = graph.node_attrs["parent"]
    depth = graph.node_attrs["depth"].astype(np.int64)
    candidates = np.nonzero((nt == FS_FILE) | (nt == FS_FOLDER))[0]
    p = graph.degree[candidates].astype(np.float64)
    p /= p.sum()
    ends = rng.choice(candidates, size=n_ops, p=p)

    # Walk up 1..(depth(end) − 2) levels (root folder of the user sits at
    # depth 2: org→user→root-folder). Start must be a folder.
    max_up = np.maximum(depth[ends] - 2, 1)
    ups = (rng.integers(0, 1 << 30, size=n_ops) % max_up) + 1
    starts = ends.copy()
    remaining = ups.copy()
    for _ in range(int(depth.max()) + 1):
        step = remaining > 0
        starts = np.where(step & (parent[starts] >= 0), parent[starts], starts)
        remaining = np.maximum(remaining - 1, 0)
    # Clamp to folders (ends that were files walked ≥1 level so starts are
    # folders except degenerate roots).
    bad = nt[starts] != FS_FOLDER
    starts[bad] = np.where(parent[starts[bad]] >= 0, parent[starts[bad]], starts[bad])
    return OpLog("filesystem", starts.astype(np.int64), ends.astype(np.int64), t_l=2, t_pg=1)


def _city_distance(graph: Graph) -> np.ndarray:
    lon = graph.node_attrs["lon"].astype(np.float64)
    lat = graph.node_attrs["lat"].astype(np.float64)
    cxy = np.array([[c[1], c[2]] for c in _CITIES])
    d = np.min(
        np.sqrt((lon[:, None] - cxy[None, :, 0]) ** 2 + (lat[:, None] - cxy[None, :, 1]) ** 2),
        axis=1,
    )
    return d


def _gen_gis(graph: Graph, n_ops: int, seed: int, variant: str) -> OpLog:
    """Start near cities; short ends via random walk (mean 11), long ends
    near (usually different) cities (§6.2.2)."""
    rng = np.random.default_rng(seed)
    d = _city_distance(graph)
    p = np.exp(-d / 0.15)
    p /= p.sum()
    starts = rng.choice(graph.n_nodes, size=n_ops, p=p)
    if variant == "long":
        ends = rng.choice(graph.n_nodes, size=n_ops, p=p)
        return OpLog("gis_long", starts.astype(np.int64), ends.astype(np.int64), t_l=8, t_pg=1)
    # short: random walk from start, exponential length (mean 11).
    indptr, indices, _ = graph.undirected_csr
    lengths = np.maximum(rng.exponential(11.0, size=n_ops).astype(np.int64), 1)
    ends = starts.copy()
    max_len = int(lengths.max())
    for step in range(max_len):
        act = lengths > step
        deg = indptr[ends + 1] - indptr[ends]
        ok = act & (deg > 0)
        pick = indptr[ends[ok]] + (rng.integers(0, 1 << 30, size=int(ok.sum())) % deg[ok])
        ends[ok] = indices[pick]
    return OpLog("gis_short", starts.astype(np.int64), ends.astype(np.int64), t_l=8, t_pg=1)


def _gen_twitter(graph: Graph, n_ops: int, seed: int) -> OpLog:
    """Start ∝ out-degree; friend-of-a-friend = 2-hop out-BFS (§6.2.3)."""
    rng = np.random.default_rng(seed)
    p = (graph.out_degree + 1e-9).astype(np.float64)
    p /= p.sum()
    starts = rng.choice(graph.n_nodes, size=n_ops, p=p)
    return OpLog("twitter", starts.astype(np.int64), np.full(n_ops, -1, dtype=np.int64), t_l=2, t_pg=1)


_PATTERNS = {
    "filesystem": _gen_filesystem,
    "twitter": _gen_twitter,
}


def pattern_for(graph: Graph) -> str:
    if "node_type" in graph.node_attrs:
        return "filesystem"
    if "lon" in graph.node_attrs:
        return "gis_short"
    return "twitter"


def generate_ops(graph: Graph, n_ops: int = 10_000, seed: int = 0, pattern: Optional[str] = None) -> OpLog:
    pattern = pattern or pattern_for(graph)
    if pattern in ("gis_short", "gis_long"):
        return _gen_gis(graph, n_ops, seed, pattern.split("_")[1])
    return _PATTERNS[pattern](graph, n_ops, seed)


# ===========================================================================
# Pattern edge universes (shared by both engines)
# ===========================================================================
def _filtered_children_csr_edges(graph: Graph) -> Tuple[np.ndarray, np.ndarray]:
    """Edge list restricted to folder→{file,folder} (the fs BFS universe)."""
    nt = graph.node_attrs["node_type"]
    keep = (nt[graph.senders] == FS_FOLDER) & (
        (nt[graph.receivers] == FS_FOLDER) | (nt[graph.receivers] == FS_FILE)
    )
    return graph.senders[keep].astype(np.int64), graph.receivers[keep].astype(np.int64)


def _csr_from_edges(s: np.ndarray, r: np.ndarray, n_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    order = np.argsort(s, kind="stable")
    indices = r[order].astype(np.int64)
    counts = np.bincount(s, minlength=n_nodes)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return indptr, indices


# ===========================================================================
# Scalar oracle execution (one op at a time — the semantic reference)
# ===========================================================================
class _ScalarCounters:
    def __init__(self, n_ops: int, k: int, n_nodes: int, t_l: int, t_pg: int):
        self.per_op_total = np.zeros(n_ops, dtype=np.int64)
        self.per_op_global = np.zeros(n_ops, dtype=np.int64)
        self.per_partition = np.zeros(k, dtype=np.int64)
        self.per_vertex = np.zeros(n_nodes, dtype=np.int64)
        self.t_l, self.t_pg = t_l, t_pg

    def step(self, i: int, u: int, v: int, parts: np.ndarray) -> None:
        """One traversal step: op i expands edge u → v."""
        self.per_op_total[i] += self.t_l + self.t_pg
        pu, pv = parts[u], parts[v]
        if pu != pv:
            self.per_op_global[i] += 1
        self.per_partition[pu] += self.t_l
        self.per_partition[pv] += self.t_pg
        self.per_vertex[u] += self.t_l
        self.per_vertex[v] += self.t_pg

    def result(self) -> TrafficResult:
        return TrafficResult(
            self.per_op_total, self.per_op_global, self.per_partition, self.per_vertex
        )


def _execute_bfs_scalar(
    graph: Graph,
    ops: OpLog,
    parts: np.ndarray,
    k: int,
) -> TrafficResult:
    """Per-op level-by-level BFS down the filtered filesystem tree."""
    s, r = _filtered_children_csr_edges(graph)
    indptr, indices = _csr_from_edges(s, r, graph.n_nodes)
    max_levels = int(graph.node_attrs["depth"].max()) + 2
    ctr = _ScalarCounters(ops.n_ops, k, graph.n_nodes, ops.t_l, ops.t_pg)
    for i in range(ops.n_ops):
        end = int(ops.ends[i])
        frontier = [int(ops.starts[i])]
        for _lvl in range(max_levels):
            children = []
            found = False
            for u in frontier:
                for e in range(indptr[u], indptr[u + 1]):
                    v = int(indices[e])
                    ctr.step(i, u, v, parts)
                    children.append(v)
                    if v == end:
                        found = True
            if found or not children:
                break
            frontier = children
    return ctr.result()


def _execute_twitter_scalar(
    graph: Graph,
    ops: OpLog,
    parts: np.ndarray,
    k: int,
) -> TrafficResult:
    """Per-op 2-hop friend-of-a-friend expansion with path multiplicity."""
    indptr, indices, _ = graph.csr
    ctr = _ScalarCounters(ops.n_ops, k, graph.n_nodes, ops.t_l, ops.t_pg)
    for i in range(ops.n_ops):
        frontier = [int(ops.starts[i])]
        for _hop in range(2):
            children = []
            for u in frontier:
                for e in range(indptr[u], indptr[u + 1]):
                    v = int(indices[e])
                    ctr.step(i, u, v, parts)
                    children.append(v)
            frontier = children
    return ctr.result()


def _execute_gis_scalar(
    graph: Graph,
    ops: OpLog,
    parts: np.ndarray,
    k: int,
    max_expansions: int = 50_000,
) -> TrafficResult:
    """Per-op heapq shortest paths + A*-expansion-set accounting.

    Distances settle by plain Dijkstra order (g, id) — with positive
    weights every first pop is final, no heuristic consistency needed —
    and the search stops once the smallest unsettled distance exceeds
    g(dst), which covers every vertex with f ≤ f(dst). Membership in the
    expansion set S is then decided by (f, id) <_lex (f(dst), dst); see
    the module docstring. All distance arithmetic is float32 with the same
    operation order as the batched kernel, so counters agree bit-for-bit.
    """
    indptr, indices, weights = graph.undirected_csr
    weights = weights.astype(np.float32)
    lon = graph.node_attrs["lon"].astype(np.float32)
    lat = graph.node_attrs["lat"].astype(np.float32)
    ctr = _ScalarCounters(ops.n_ops, k, graph.n_nodes, ops.t_l, ops.t_pg)

    for i in range(ops.n_ops):
        src, dst = int(ops.starts[i]), int(ops.ends[i])
        dist = {}
        heap = [(np.float32(0.0), src)]
        tentative = {src: np.float32(0.0)}
        g_dst = None
        while heap:
            gu, u = heapq.heappop(heap)
            if u in dist:
                continue
            if g_dst is not None and gu > g_dst:
                break
            dist[u] = gu
            if u == dst:
                g_dst = gu
            for e in range(indptr[u], indptr[u + 1]):
                v = int(indices[e])
                if v in dist:
                    continue
                cand = gu + weights[e]
                known = tentative.get(v)
                if known is None or cand < known:
                    tentative[v] = cand
                    heapq.heappush(heap, (cand, v))
        # A* expansion set under the Euclidean heuristic (h(dst) = 0).
        tx, ty = lon[dst], lat[dst]
        f_dst = (np.float32(np.inf), dst) if g_dst is None else (g_dst, dst)
        expansion = []
        for u, gu in dist.items():
            dx = lon[u] - tx
            dy = lat[u] - ty
            fu = gu + np.sqrt(dx * dx + dy * dy)
            if (fu, u) < f_dst:
                expansion.append((fu, u))
        if len(expansion) > max_expansions:
            expansion.sort()
            expansion = expansion[:max_expansions]
        for _fu, u in expansion:
            for e in range(indptr[u], indptr[u + 1]):
                ctr.step(i, u, int(indices[e]), parts)
    return ctr.result()


def _execute_scalar(
    graph: Graph,
    ops: OpLog,
    parts: np.ndarray,
    k: int,
) -> TrafficResult:
    if ops.pattern == "filesystem":
        return _execute_bfs_scalar(graph, ops, parts, k)
    if ops.pattern in ("gis_short", "gis_long"):
        return _execute_gis_scalar(graph, ops, parts, k)
    if ops.pattern == "twitter":
        return _execute_twitter_scalar(graph, ops, parts, k)
    raise ValueError(f"unknown pattern {ops.pattern!r}")


# ===========================================================================
# Dispatch
# ===========================================================================
def execute_ops(
    graph: Graph,
    ops: OpLog,
    parts: np.ndarray,
    k: Optional[int] = None,
    engine: str = "batched",
    device=None,
) -> TrafficResult:
    """Run an evaluation log against a partitioning and measure traffic.

    ``engine``: ``"batched"`` (the PyTorch engine on ``device``; ``None``
    means CUDA) or ``"scalar"`` (the NumPy oracle, host only). Both
    produce identical counters.
    """
    k = int(parts.max()) + 1 if k is None else k
    parts = np.asarray(parts, dtype=np.int64)
    if engine == "scalar":
        return _execute_scalar(graph, ops, parts, k)
    if engine == "batched":
        from repro_torch.core.traffic_batched import execute_ops_batched

        return execute_ops_batched(graph, ops, parts, k, device=device)
    raise ValueError(f"unknown engine {engine!r}")
