"""Sharding rules per architecture family (twin of ``repro.distributed.sharding``).

A spec is a tuple with one entry a dimension: ``None`` (the dimension is
whole on every rank), one mesh axis name, or a tuple of names (the first
major). A one-name tuple is written as the name, as ``PartitionSpec``
prints it, so ``tuple(jax_spec) == port_spec``. The rules are the JAX
package's, by leaf name:

  embed [V, D]            → (model, None)       vocab-sharded embedding
  attn wq/wk/wv [D, H·dh] → (None, model)       head-sharded
  attn wo [H·dh, D]       → (model, None)
  ffn w_gate/up [D, F]    → (None, model)
  ffn w_down [F, D]       → (model, None)
  moe experts [E, …]      → (model, None, None) expert-parallel
  tokens [B, T]           → (batch_axes, None)
  kv cache [L,B,T,Hkv,dh] → (None, batch_axes, model, None, None)

Stacked-layer leaves carry a leading L axis, which stays whole. GNN node
tables shard over the data axes; DIN's embedding tables over model rows.
The optimizer state mirrors the parameter specs. The port runs an LM
under these specs (``transformer.forward``/``loss_fn``/``serve_step`` with
a mesh): vocabulary-parallel embedding and head, tensor-parallel attention
and SwiGLU, expert-parallel routed experts, split-K decode.

A process group has no global array, so :func:`shard_tree` stands for the
JAX package's ``to_shardings`` + ``device_put``: it gives this rank its
slice of each leaf, and :func:`gather_tree` puts the leaves back together
with ``all_gather`` along each sharded dimension's axes. Both take a
:class:`~repro_torch.launch.mesh.HostMesh` (or, on ``meta`` tensors, the
dry run's :class:`~repro_torch.launch.mesh.MetaMesh`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]
Tree = Dict[str, Any]

__all__ = [
    "Spec", "batch_axes", "data_shards", "lm_param_specs", "replicated_specs", "opt_state_specs", "lm_batch_spec",
    "kv_cache_spec", "gnn_node_spec", "din_param_specs", "leaf_shards", "shard_leaf", "shard_tree", "gather_tree",
    "splits_over",
]


def spec(*entries: Entry) -> Spec:
    """A spec from its entries: a one-name tuple becomes the name and an
    empty one ``None``, as ``PartitionSpec`` normalises them."""
    out = []
    for e in entries:
        if isinstance(e, tuple) and len(e) <= 1:
            e = e[0] if e else None
        out.append(e)
    return tuple(out)


def batch_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel axes: ('pod', 'data') on a multi-pod mesh, ('data',) otherwise."""
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def data_shards(mesh) -> int:
    """Ranks along the batch axes: the data shards of a batch."""
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n


def _lm_leaf_spec(path: str, ndim: int) -> Spec:
    """Spec for one LM parameter leaf, by name pattern (see module doc)."""
    stacked = ".layers." in path or path.startswith("layers.")
    base: Tuple[Optional[str], ...]
    if "embed" in path and "species" not in path:
        base = ("model", None)
    elif "lm_head" in path:
        base = (None, "model")
    elif any(k in path for k in ("wq", "wk", "wv", "w_gate", "w_up")):
        base = (None, "model")
    elif any(k in path for k in ("wo", "w_down")):
        base = ("model", None)
    elif "router" in path:
        base = (None, None)
    else:
        base = ()
    # MoE routed-expert stacks have a leading E axis under "moe"; the
    # always-on shared expert is a plain SwiGLU and keeps the TP rules.
    if ".moe." in path and ".shared." not in path and any(k in path for k in ("w_gate", "w_up", "w_down")):
        base = ("model",) + (None,) * 2
    pad = ndim - len(base) - (1 if stacked else 0)
    s = ((None,) if stacked else ()) + (None,) * max(pad, 0) + base
    s = s[-ndim:] if len(s) > ndim else s + (None,) * (ndim - len(s))
    return spec(*s)


def _map_with_path(fn, tree: Tree, prefix: str = "") -> Tree:
    """``fn(path, leaf)`` over nested dicts, the path's keys joined by '.'."""
    return {k: _map_with_path(fn, v, f"{prefix}{k}.") if isinstance(v, dict) else fn(f"{prefix}{k}", v)
            for k, v in tree.items()}


def lm_param_specs(params: Tree) -> Tree:
    """Spec tree of LM parameters (tensors, ``meta`` tensors included)."""
    return _map_with_path(lambda path, leaf: _lm_leaf_spec(path, len(leaf.shape)), params)


def replicated_specs(tree: Tree) -> Tree:
    return _map_with_path(lambda path, leaf: (), tree)


def opt_state_specs(param_specs: Tree) -> Tree:
    """AdamW state mirrors params; step replicates."""
    return {"m": param_specs, "v": param_specs, "step": ()}


def lm_batch_spec(mesh) -> Spec:
    return spec(batch_axes(mesh), None)


def kv_cache_spec(mesh) -> Spec:
    return spec(None, batch_axes(mesh), "model", None, None)


def gnn_node_spec(mesh) -> Spec:
    return spec(batch_axes(mesh), None)


def din_param_specs(params: Tree) -> Tree:
    def leaf_spec(path, leaf):
        if "item_embed" in path or "cat_embed" in path:
            return ("model", None)
        return (None,) * len(leaf.shape)

    return _map_with_path(leaf_spec, params)


# ------------------------------------------------------------ placement
def _entry_axes(entry: Entry) -> Tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def _shards(mesh, entry: Entry) -> int:
    n = 1
    for a in _entry_axes(entry):
        n *= mesh.shape[a]
    return n


def splits_over(s: Spec, axis: str) -> bool:
    """Whether a leaf of spec ``s`` is split along ``axis``."""
    return any(axis in _entry_axes(e) for e in s)


def leaf_shards(s: Spec, mesh) -> int:
    """The ranks a leaf of spec ``s`` is split across (1: whole on each)."""
    n = 1
    for entry in s:
        n *= _shards(mesh, entry)
    return n


def _walk(fn, tree: Tree, specs: Tree) -> Tree:
    return {k: _walk(fn, v, specs[k]) if isinstance(v, dict) else fn(v, specs[k]) for k, v in tree.items()}


def shard_leaf(leaf: torch.Tensor, s: Spec, mesh) -> torch.Tensor:
    """This rank's slice of one leaf: each dimension whose entry names
    axes is cut into as many equal blocks as those axes have ranks, and
    the rank keeps the block at its index along them. A leaf split
    nowhere is returned as it is (no copy); a split leaf is a copy, so the
    whole one can be freed. A dimension that does not divide raises."""
    if len(s) > leaf.dim():
        raise ValueError(f"spec {s} has more entries than the leaf's {leaf.dim()} dimensions")
    out = leaf
    for dim, entry in enumerate(s):
        n = _shards(mesh, entry)
        if n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(f"dimension {dim} of size {out.shape[dim]} does not split into {n} shards")
        size = out.shape[dim] // n
        out = out.narrow(dim, mesh.axis_index(_entry_axes(entry)) * size, size)
    return out if out is leaf else out.clone()


def shard_tree(tree: Tree, specs: Tree, mesh) -> Tree:
    """This rank's slice of every leaf (:func:`shard_leaf`)."""
    return _walk(lambda leaf, s: shard_leaf(leaf, s, mesh), tree, specs)


def gather_tree(tree: Tree, specs: Tree, mesh) -> Tree:
    """The whole leaves back from every rank's slices (the inverse of
    :func:`shard_tree`): one ``all_gather`` for each split dimension."""
    def join(leaf: torch.Tensor, s: Spec) -> torch.Tensor:
        for dim in reversed(range(len(s))):
            if _shards(mesh, s[dim]) > 1:
                leaf = torch.cat(mesh.all_gather(leaf, axis=_entry_axes(s[dim])), dim=dim)
        return leaf

    return _walk(join, tree, specs)
