"""Dataset registry for the paper's three graphs plus the test graph.

Twin of ``repro.graphs.datasets`` restricted to the static slice's graphs:
``load(name, scale, seed)`` is the single entry point of the quickstart,
``chip_smoke.py`` and the tests. ``scale=1.0`` is the paper's size.
"""

from __future__ import annotations

from typing import Callable, Dict

from repro_torch.graphs import generators as G
from repro_torch.graphs.structure import Graph

__all__ = ["load", "DATASETS"]

DATASETS: Dict[str, Callable[..., Graph]] = {
    "filesystem": G.filesystem_tree,
    "gis": G.gis_romania,
    "twitter": G.twitter_social,
    "two_cluster": lambda scale=1.0, seed=0: G.two_cluster(n_per=max(int(64 * scale), 8), seed=seed),
}


def load(name: str, scale: float = 0.1, seed: int = 0) -> Graph:
    if name not in DATASETS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(DATASETS)}")
    return DATASETS[name](scale=scale, seed=seed)
