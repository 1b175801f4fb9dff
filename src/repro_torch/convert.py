"""Carry state from the JAX package into the port.

The JAX package's objects are handed over as numpy arrays (the caller
applies ``np.asarray`` on its side); these functions build the port's
objects from them. Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.didic import DidicState
from repro_torch.core.traffic import OpLog
from repro_torch.graphs.structure import BlockEll, Graph, PaddedNeighbors

__all__ = [
    "adamw_state_from_arrays",
    "block_ell_from_arrays",
    "didic_state_from_arrays",
    "din_params_from_arrays",
    "gnn_params_from_arrays",
    "graph_from_arrays",
    "mace_params_from_arrays",
    "oplog_from_arrays",
    "padded_neighbors_from_arrays",
    "transformer_params_from_arrays",
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


def _tensor(a, device: torch.device) -> torch.Tensor:
    """numpy (float32, int or ``ml_dtypes`` bfloat16) → tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.as_tensor(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.as_tensor(np.array(a)).to(device)


def _tree(tree: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    return {k: _tree(v, device) if isinstance(v, dict) else _tensor(v, device) for k, v in tree.items()}


_SWIGLU_KEYS = {"w_gate", "w_up", "w_down"}
_MOE_KEYS = {"router"} | _SWIGLU_KEYS


def _missing(tree: Dict[str, Any], want: set, what: str) -> None:
    missing = want - set(tree)
    if missing:
        raise ValueError(f"not a parameter pytree: {what} lacks {sorted(missing)}")


def transformer_params_from_arrays(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The JAX package's LM pytree (layers stacked ``[L, ...]``, a dense
    ``ffn`` or a ``moe`` subtree) → the port's parameters, same names,
    orientation (``y = x @ W``) and types (a bfloat16 leaf stays bfloat16;
    the MoE router is float32 in both packages)."""
    _missing(tree, {"embed", "layers", "ln_f", "lm_head"}, "the tree")
    layers = tree["layers"]
    _missing(layers, {"ln1", "ln2", "attn"}, "layers")
    if "moe" in layers:
        _missing(layers["moe"], _MOE_KEYS, "layers.moe")
        if "shared" in layers["moe"]:
            _missing(layers["moe"]["shared"], _SWIGLU_KEYS, "layers.moe.shared")
    else:
        _missing(layers, {"ffn"}, "layers")
        _missing(layers["ffn"], _SWIGLU_KEYS, "layers.ffn")
    return _tree(tree, resolve_device(device))


def din_params_from_arrays(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The JAX package's DIN pytree → the port's parameters."""
    missing = {"item_embed", "cat_embed", "attn", "mlp"} - set(tree)
    if missing:
        raise ValueError(f"not a DIN pytree: missing {sorted(missing)}")
    return _tree(tree, resolve_device(device))


def adamw_state_from_arrays(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The JAX package's AdamW state (``m`` and ``v`` float32 trees like the
    parameters, ``step`` an int32 scalar) → the port's, so that a JAX train
    state resumes in :class:`repro_torch.train.Trainer`."""
    missing = {"m", "v", "step"} - set(tree)
    if missing:
        raise ValueError(f"not an AdamW state: missing {sorted(missing)}")
    dev = resolve_device(device)
    return {
        "m": _tree(tree["m"], dev),
        "v": _tree(tree["v"], dev),
        "step": torch.as_tensor(np.array(tree["step"], dtype=np.int32), device=dev),
    }


_MLP2 = {"w0", "b0", "w1", "b1"}
_GNN_KEYS = {
    "gcn": lambda n: {f"w{i}" for i in range(n)},
    "sage": lambda n: {f"{w}{i}" for i in range(n) for w in ("w_self", "w_nbr")},
    "meshgraphnet": lambda n: {"enc_node", "enc_edge", "dec", "proc"},
}


def gnn_params_from_arrays(tree: Dict[str, Any], kind: str, n_layers: int, device=None) -> Dict[str, Any]:
    """The JAX package's GCN, GraphSAGE or MeshGraphNet pytree (``kind`` as
    in ``GnnConfig``) → the port's parameters, same names and orientation;
    MeshGraphNet's processor stays stacked ``[n_layers, ...]``."""
    want = _GNN_KEYS[kind](n_layers)
    if set(tree) != want:
        raise ValueError(f"not a {kind} pytree of {n_layers} layers: keys {sorted(tree)}, want {sorted(want)}")
    if kind == "meshgraphnet":
        proc = tree["proc"]
        if set(proc) != {"edge_mlp", "node_mlp", "ln_e", "ln_n"} or any(
                np.shape(leaf)[0] != n_layers for sub in proc.values() for leaf in sub.values()):
            raise ValueError(f"not a stacked [{n_layers}, ...] MeshGraphNet processor")
        for name in ("enc_node", "enc_edge", "dec"):
            _missing(tree[name], _MLP2, name)
    return _tree(tree, resolve_device(device))


def mace_params_from_arrays(tree: Dict[str, Any], n_layers: int, device=None) -> Dict[str, Any]:
    """The JAX package's MACE pytree → the port's parameters."""
    want = {"species_embed", "readout"} | {f"layer{i}" for i in range(n_layers)}
    if set(tree) != want:
        raise ValueError(f"not a MACE pytree of {n_layers} layers: keys {sorted(tree)}")
    for i in range(n_layers):
        _missing(tree[f"layer{i}"], {"radial_s", "radial_v", "radial_t", "mix_s", "mix_v", "mix_t"},
                 f"layer{i}")
    return _tree(tree, resolve_device(device))
