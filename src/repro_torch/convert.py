"""Carry state from the JAX package into the port.

The JAX package's objects are handed over as numpy arrays (the caller
applies ``np.asarray`` on its side); these functions build the port's
objects from them. Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.didic import DidicState
from repro_torch.core.traffic import OpLog
from repro_torch.graphs.structure import BlockEll, Graph, PaddedNeighbors

__all__ = [
    "block_ell_from_arrays",
    "didic_state_from_arrays",
    "graph_from_arrays",
    "oplog_from_arrays",
    "padded_neighbors_from_arrays",
]


def graph_from_arrays(
    n_nodes: int,
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_weight: np.ndarray,
    node_attrs: Optional[Dict[str, np.ndarray]] = None,
    name: str = "graph",
) -> Graph:
    return Graph(
        n_nodes=int(n_nodes),
        senders=np.array(senders, dtype=np.int32),
        receivers=np.array(receivers, dtype=np.int32),
        edge_weight=np.array(edge_weight, dtype=np.float32),
        node_attrs={k: np.array(v) for k, v in (node_attrs or {}).items()},
        name=name,
    )


def oplog_from_arrays(
    pattern: str, starts: np.ndarray, ends: np.ndarray, t_l: int, t_pg: int,
) -> OpLog:
    return OpLog(
        pattern, np.array(starts, dtype=np.int64), np.array(ends, dtype=np.int64),
        t_l=int(t_l), t_pg=int(t_pg),
    )


def didic_state_from_arrays(
    w: np.ndarray, l: np.ndarray, parts: np.ndarray, beta: np.ndarray, device=None,
) -> DidicState:
    dev = resolve_device(device)
    return DidicState(
        w=torch.as_tensor(np.array(w, dtype=np.float32), device=dev),
        l=torch.as_tensor(np.array(l, dtype=np.float32), device=dev),
        parts=torch.as_tensor(np.array(parts, dtype=np.int32), device=dev),
        beta=torch.as_tensor(np.array(beta, dtype=np.float32), device=dev),
    )


def padded_neighbors_from_arrays(
    nbr, w, mask, spill_s, spill_r, spill_w,
) -> PaddedNeighbors:
    return PaddedNeighbors(
        nbr=np.array(nbr, dtype=np.int32), w=np.array(w, dtype=np.float32),
        mask=np.array(mask, dtype=np.float32),
        spill_s=np.array(spill_s, dtype=np.int32), spill_r=np.array(spill_r, dtype=np.int32),
        spill_w=np.array(spill_w, dtype=np.float32),
    )


def block_ell_from_arrays(
    blocks, block_cols, block_mask, n_rows: int, n_cols: int, block_size: int,
) -> BlockEll:
    return BlockEll(
        blocks=np.array(blocks, dtype=np.float32),
        block_cols=np.array(block_cols, dtype=np.int32),
        block_mask=np.array(block_mask, dtype=np.float32),
        n_rows=int(n_rows), n_cols=int(n_cols), block_size=int(block_size),
    )
