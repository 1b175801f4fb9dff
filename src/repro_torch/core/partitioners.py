"""Baseline partitioning methods (paper §6.3).

Twin of ``repro.core.partitioners`` (host numpy, identical results):

* ``random_partition``     — the paper's baseline: every vertex lands on a
  uniformly random partition (expected edge cut 1 − 1/k).
* ``linear_partition``     — contiguous id ranges.
* ``hardcoded_filesystem`` — subtree packing: leaf folders in DFS order are
  split into k equal segments; ancestors adopt their children's partition,
  non-folder vertices their parent's (paper §6.3 "File System Hardcoded").
* ``hardcoded_gis``        — longitude sweep: scan vertices east→west and cut
  into k equal-|V| chunks (paper §6.3 "GIS Hardcoded", Fig. 6.11).

No hardcoded method exists for Twitter (paper: "no hardcoded partitioning
was performed" — insufficient domain knowledge).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.graphs.generators import FS_FOLDER, FS_ORG, FS_USER
from repro_torch.graphs.structure import Graph

__all__ = [
    "random_partition",
    "linear_partition",
    "hardcoded_filesystem",
    "hardcoded_gis",
    "hardcoded_for",
]


def random_partition(n_nodes: int, k: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, k, size=n_nodes).astype(np.int32)


def linear_partition(n_nodes: int, k: int) -> np.ndarray:
    return np.minimum((np.arange(n_nodes) * k) // n_nodes, k - 1).astype(np.int32)


def hardcoded_filesystem(graph: Graph, k: int) -> np.ndarray:
    """Subtree packing using the generator's parent pointers and types."""
    nt = graph.node_attrs["node_type"]
    parent = graph.node_attrs["parent"]
    depth = graph.node_attrs["depth"]
    n = graph.n_nodes

    # Children lists over tree edges (parent array), folders only for DFS.
    is_folder = nt == FS_FOLDER
    order = np.argsort(parent[1:], kind="stable")  # group children by parent
    child_nodes = np.arange(1, n)[order]
    child_parents = parent[1:][order]

    # DFS over folders from roots (folders whose parent is not a folder).
    folder_children: dict[int, list[int]] = {}
    for c, p in zip(child_nodes[is_folder[child_nodes]], child_parents[is_folder[child_nodes]]):
        folder_children.setdefault(int(p), []).append(int(c))
    roots = [int(v) for v in np.nonzero(is_folder & ~np.isin(parent, np.nonzero(is_folder)[0]))[0]]

    leaf_order: list[int] = []
    stack = list(reversed(roots))
    while stack:
        v = stack.pop()
        kids = folder_children.get(v, [])
        if kids:
            stack.extend(reversed(kids))
        else:
            leaf_order.append(v)

    parts = np.full(n, -1, dtype=np.int32)
    if leaf_order:
        leaf_arr = np.array(leaf_order)
        seg = np.minimum(np.arange(leaf_arr.shape[0]) * k // leaf_arr.shape[0], k - 1)
        parts[leaf_arr] = seg

    # Ancestors: process folders by decreasing depth, adopt a child's part.
    folders = np.nonzero(is_folder)[0]
    for v in folders[np.argsort(-depth[folders])]:
        if parts[v] < 0:
            kids = folder_children.get(int(v), [])
            assigned = [parts[c] for c in kids if parts[c] >= 0]
            parts[v] = assigned[0] if assigned else 0
    # Users co-locate with their root folder (paper: subtree packing keeps
    # a user's whole tree together); orgs with their first user.
    root_folders = np.nonzero(is_folder & np.isin(parent, np.nonzero(nt == FS_USER)[0]))[0]
    for rf in root_folders:
        parts[parent[rf]] = parts[rf]
    for org in np.nonzero(nt == FS_ORG)[0]:
        users = np.nonzero((nt == FS_USER) & (parent == org))[0]
        parts[org] = parts[users[0]] if users.size else 0
    # Everything else: inherit from parent, increasing depth so parents win.
    others = np.nonzero(~is_folder & (nt != FS_USER) & (nt != FS_ORG))[0]
    for v in others[np.argsort(depth[others])]:
        p = parent[v]
        parts[v] = parts[p] if p >= 0 and parts[p] >= 0 else 0
    return parts


def hardcoded_gis(graph: Graph, k: int) -> np.ndarray:
    """Equal-|V| longitude chunks, east→west (paper Fig. 6.11)."""
    lon = graph.node_attrs["lon"]
    order = np.argsort(lon, kind="stable")
    parts = np.empty(graph.n_nodes, dtype=np.int32)
    parts[order] = np.minimum(np.arange(graph.n_nodes) * k // graph.n_nodes, k - 1)
    return parts


def hardcoded_for(graph: Graph, k: int) -> Optional[np.ndarray]:
    """Dataset-dispatching hardcoded partitioner; None if unavailable."""
    if "node_type" in graph.node_attrs and "parent" in graph.node_attrs:
        return hardcoded_filesystem(graph, k)
    if "lon" in graph.node_attrs:
        return hardcoded_gis(graph, k)
    return None  # e.g. Twitter — paper §6.3
