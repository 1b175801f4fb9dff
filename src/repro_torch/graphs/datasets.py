"""Dataset registry: the paper's three graphs, the test graph and the GNN
stand-ins.

Twin of ``repro.graphs.datasets``: ``load(name, scale, seed)`` is the
single entry point of the quickstart, ``chip_smoke.py``, the training
launcher and the tests. ``scale=1.0`` is the paper's size for the paper's
graphs, and the published node count for the stand-ins of the public GNN
datasets (cora, reddit, ogbn-products), whose statistics ``SHAPE_STATS``
records; the draws are the JAX package's, so both build identical arrays.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from repro_torch.graphs import generators as G
from repro_torch.graphs.structure import Graph

__all__ = ["load", "DATASETS", "SHAPE_STATS"]

# Published statistics of the GNN shapes.
SHAPE_STATS = {
    "full_graph_sm": dict(n_nodes=2_708, n_edges=10_556, d_feat=1_433),
    "minibatch_lg": dict(n_nodes=232_965, n_edges=114_615_892, batch_nodes=1_024, fanout=(15, 10)),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128),
}


def _cora_like(scale: float = 1.0, seed: int = 0) -> Graph:
    n = max(int(2708 * scale), 64)
    g = G.random_graph(n, avg_degree=10556 / 2708, seed=seed)
    g.name = "cora_like"
    return g


def _reddit_like(scale: float = 0.02, seed: int = 0) -> Graph:
    # Twitter-like: far fewer edges than reddit's 115 M at scale=1.0.
    n = max(int(232_965 * scale), 256)
    g = G.twitter_social(scale=n / 611_643, seed=seed)
    g.name = "reddit_like"
    return g


def _products_like(scale: float = 0.01, seed: int = 0) -> Graph:
    """ogbn-products stand-in: communities of ~500 (85 % of the edges
    inside one) at the published average degree."""
    n = max(int(2_449_029 * scale), 512)
    avg_degree = 61_859_140 / 2_449_029
    rng = np.random.default_rng(seed)
    comm_size = 500
    comm = rng.permutation(n) // comm_size
    e = int(n * avg_degree / 2)
    n_in = int(e * 0.85)
    s_in = rng.integers(0, n, size=n_in)
    offs = rng.integers(1, comm_size, size=n_in)
    order = np.argsort(comm, kind="stable")
    pos_in_comm = np.empty(n, dtype=np.int64)
    pos_in_comm[order] = np.arange(n)
    base = pos_in_comm[s_in] - pos_in_comm[s_in] % comm_size
    r_in = order[np.minimum(base + (pos_in_comm[s_in] % comm_size + offs) % comm_size, n - 1)]
    s_out = rng.integers(0, n, size=e - n_in)
    r_out = rng.integers(0, n, size=e - n_in)
    s = np.concatenate([s_in, s_out])
    r = np.concatenate([r_in, r_out])
    keep = s != r
    return Graph(
        n_nodes=n, senders=s[keep].astype(np.int32), receivers=r[keep].astype(np.int32),
        edge_weight=np.ones(int(keep.sum()), np.float32),
        node_attrs={"community": comm.astype(np.int32)}, name="products_like",
    )


DATASETS: Dict[str, Callable[..., Graph]] = {
    "filesystem": G.filesystem_tree,
    "gis": G.gis_romania,
    "twitter": G.twitter_social,
    "two_cluster": lambda scale=1.0, seed=0: G.two_cluster(n_per=max(int(64 * scale), 8), seed=seed),
    "cora_like": _cora_like,
    "reddit_like": _reddit_like,
    "products_like": _products_like,
    "molecules": lambda scale=1.0, seed=0: G.molecule_batch(n_mols=max(int(128 * scale), 2), seed=seed),
    "mesh": lambda scale=1.0, seed=0: G.mesh_graph(
        rows=max(int(64 * scale), 8), cols=max(int(64 * scale), 8), seed=seed
    ),
}


def load(name: str, scale: float = 0.1, seed: int = 0) -> Graph:
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(DATASETS)}")
    return DATASETS[name](scale=scale, seed=seed)
