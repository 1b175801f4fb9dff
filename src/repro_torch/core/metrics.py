"""Partitioning-quality metrics (paper §3.2 Tables 3.2/3.3, §7.1).

Twin of ``repro.core.metrics``: the same numpy code, so reports agree exactly.

All metrics operate on a partition assignment ``parts: int32[N]`` over a
:class:`repro_torch.graphs.Graph` and follow the paper's definitions:

* edge cut ``ec(G)``       — Eq. 3.9 (sum of weights of crossing edges; also
                             reported as a fraction of total weight, which is
                             how Table 7.1 presents it),
* conductance ``φ``        — Eq. 3.10,
* modularity ``Mod(Π)``    — Eq. 3.11,
* partition-size balance   — Eq. 3.13 / coefficient of variation (Eq. 7.1),
* expected global traffic  — Eq. 7.3 correlation formula.

Host-side (numpy): these run over graphs with millions of edges in O(E).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.graphs.structure import Graph

__all__ = [
    "edge_cut",
    "edge_cut_fraction",
    "conductance",
    "modularity",
    "coefficient_of_variation",
    "partition_counts",
    "expected_global_traffic",
    "partition_report",
]


def _crossing_mask(graph: Graph, parts: np.ndarray) -> np.ndarray:
    return parts[graph.senders] != parts[graph.receivers]


def edge_cut(graph: Graph, parts: np.ndarray) -> float:
    """Sum of weights of edges whose endpoints lie on different partitions.

    Counted over the *directed* edge list (each stored edge once), matching
    the database model where an edge lives on its start vertex's partition
    (paper §3.2: "edges reside on the partition of their start vertex").
    """
    cross = _crossing_mask(graph, parts)
    return float(graph.edge_weight[cross].sum())


def edge_cut_fraction(graph: Graph, parts: np.ndarray) -> float:
    """Edge cut as a fraction of total edge weight (Table 7.1 presentation)."""
    total = float(graph.edge_weight.sum())
    return edge_cut(graph, parts) / max(total, 1e-12)


def conductance(graph: Graph, parts: np.ndarray, k: Optional[int] = None) -> Dict[str, float]:
    """φ(π) = ∂(π)/μ(π) per partition; returns min/max/mean (paper Eq. 3.10)."""
    k = int(parts.max()) + 1 if k is None else k
    s, r, w = graph.undirected
    cross = parts[s] != parts[r]
    # ∂(π): weight of undirected edges leaving π — each undirected edge
    # appears twice in the symmetrized list, once per direction, so summing
    # crossing directed-edge weight by sender partition counts each leaving
    # edge exactly once per side.
    boundary = np.zeros(k, dtype=np.float64)
    np.add.at(boundary, parts[s[cross]], w[cross])
    # μ(π): volume = sum of weighted degrees.
    volume = np.zeros(k, dtype=np.float64)
    np.add.at(volume, parts, graph.weighted_degree.astype(np.float64))
    phi = boundary / np.maximum(volume, 1e-12)
    return {
        "min": float(phi.min()),
        "max": float(phi.max()),
        "mean": float(phi.mean()),
    }


def modularity(graph: Graph, parts: np.ndarray, k: Optional[int] = None) -> float:
    """Mod(Π) = Σ_i [ iw(π_i)/iw(G) − (Σ_{v∈π_i} d(v) / 2·iw(G))² ] (Eq. 3.11)."""
    k = int(parts.max()) + 1 if k is None else k
    s, r, w = graph.undirected
    # iw over undirected edges: symmetrized list double-counts, halve.
    same = parts[s] == parts[r]
    iw_total = float(w.sum()) / 2.0
    iw_part = np.zeros(k, dtype=np.float64)
    np.add.at(iw_part, parts[s[same]], w[same])
    iw_part /= 2.0
    deg = graph.weighted_degree.astype(np.float64)
    deg_part = np.zeros(k, dtype=np.float64)
    np.add.at(deg_part, parts, deg)
    if iw_total <= 0:
        return 0.0
    return float((iw_part / iw_total - (deg_part / (2.0 * iw_total)) ** 2).sum())


def partition_counts(graph: Graph, parts: np.ndarray, k: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Vertices and (start-vertex-resident) edges per partition."""
    k = int(parts.max()) + 1 if k is None else k
    v = np.bincount(parts, minlength=k).astype(np.int64)
    e = np.bincount(parts[graph.senders], minlength=k).astype(np.int64)
    return {"vertices": v, "edges": e}


def coefficient_of_variation(values: np.ndarray) -> float:
    """c_v = σ/μ as a fraction (paper Eq. 7.1; tables show it as %)."""
    values = np.asarray(values, dtype=np.float64)
    mu = values.mean()
    if mu == 0:
        return 0.0
    return float(values.std() / mu)


def expected_global_traffic(t_pg: int, t_l: int, ec_fraction: float) -> float:
    """Eq. 7.3: T_G% = (T_PG × ec(Π)) / (T_L + T_PG).

    ``t_pg``/``t_l`` are the per-step counts of potentially-global vs local
    graph actions of an access pattern (paper Tables 6.1/6.3/6.4).
    """
    return (t_pg * ec_fraction) / (t_l + t_pg)


def partition_report(graph: Graph, parts: np.ndarray, k: Optional[int] = None) -> Dict[str, float]:
    """One-stop summary used by benchmarks and the runtime logger."""
    k = int(parts.max()) + 1 if k is None else k
    counts = partition_counts(graph, parts, k)
    return {
        "k": k,
        "edge_cut": edge_cut(graph, parts),
        "edge_cut_fraction": edge_cut_fraction(graph, parts),
        "modularity": modularity(graph, parts, k),
        "conductance_max": conductance(graph, parts, k)["max"],
        "cv_vertices": coefficient_of_variation(counts["vertices"]),
        "cv_edges": coefficient_of_variation(counts["edges"]),
    }
