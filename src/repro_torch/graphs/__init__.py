from repro_torch.graphs.structure import (
    BlockEll, Graph, PaddedNeighbors, coalesce_edges, padded_neighbors, symmetrize,
)
from repro_torch.graphs import generators, datasets

__all__ = [
    "BlockEll", "Graph", "PaddedNeighbors", "coalesce_edges", "padded_neighbors",
    "symmetrize", "generators", "datasets",
]
