"""Atomic, step-indexed checkpoints of nested dicts of tensors (twin of
``repro.train.checkpoint``).

A checkpoint is the JAX package's pair of files: ``ckpt_{step:08d}.npz``
holds every leaf as host numpy under its ``"/"``-joined dict path (keys
sorted, as JAX flattens a dict), and ``ckpt_{step:08d}.manifest.json``
names the step, the file and ``extra``. Both are written to a temporary
file and renamed, so a crash mid-write never corrupts the newest complete
checkpoint, and :func:`restore_latest` falls back past an unreadable one.
The two packages read each other's float32 and integer checkpoints.

A bfloat16 leaf is written as the JAX package writes it, numpy ``V2``: its
16 bits. :func:`restore_latest` reads ``V2`` back as bfloat16 where the
template leaf is bfloat16. (The JAX package's own restore cannot cast ``V2``
and falls through to ``None``; ROADMAP C.)
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Tree = Dict[str, Any]

_MANIFEST = "manifest.json"


def _host(leaf) -> np.ndarray:
    """A leaf as host numpy; bfloat16 as its bits, numpy ``V2``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _paths(tree: Tree, prefix: str = ""):
    """``(path, leaf)`` pairs, keys sorted, paths ``"/"``-joined."""
    for k in sorted(tree):
        v, path = tree[k], f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _paths(v, path + "/")
        else:
            yield path, v


def _flatten_with_paths(tree: Tree) -> Dict[str, np.ndarray]:
    return {path: _host(leaf) for path, leaf in _paths(tree)}


def _host_tree(tree: Tree) -> Tree:
    return {k: _host_tree(v) if isinstance(v, dict) else _host(v) for k, v in tree.items()}


def save(
    directory: str,
    step: int,
    tree: Tree,
    extra: Optional[Dict[str, Any]] = None,
    keep: int = 3,
) -> str:
    """Atomically persist ``tree`` for ``step``; prune old checkpoints."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten_with_paths(tree)
    name = f"ckpt_{step:08d}"
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    os.close(fd)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    final = os.path.join(directory, name + ".npz")
    os.replace(tmp, final)

    manifest = {"step": step, "file": name + ".npz", "extra": extra or {}}
    fd, tmpm = tempfile.mkstemp(dir=directory, suffix=".json.tmp")
    os.close(fd)
    with open(tmpm, "w") as f:
        json.dump(manifest, f)
    os.replace(tmpm, os.path.join(directory, f"{name}.{_MANIFEST}"))

    _prune(directory, keep)
    return final


def save_async(directory: str, step: int, tree: Tree, extra=None, keep: int = 3) -> threading.Thread:
    """Host-async save: the device→host copy happens here, the IO on a thread."""
    host_tree = _host_tree(tree)
    t = threading.Thread(target=save, args=(directory, step, host_tree, extra, keep), daemon=True)
    t.start()
    return t


def _prune(directory: str, keep: int) -> None:
    manifests = sorted(f for f in os.listdir(directory) if f.endswith(_MANIFEST))
    for m in manifests[:-keep]:
        base = m.replace("." + _MANIFEST, "")
        for suffix in (".npz", "." + _MANIFEST):
            try:
                os.remove(os.path.join(directory, base + suffix))
            except FileNotFoundError:
                pass


def _restore_leaf(arr: np.ndarray, leaf: torch.Tensor) -> torch.Tensor:
    """``arr`` in the type and on the device of the template ``leaf``."""
    if arr.dtype.kind == "V":
        if leaf.dtype != torch.bfloat16 or arr.dtype.itemsize != 2:
            raise ValueError(f"a {arr.dtype} leaf restores only into bfloat16, not {leaf.dtype}")
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=leaf.device, dtype=leaf.dtype)


def _unflatten(template: Tree, data, prefix: str = "") -> Tree:
    out = {}
    for k, v in template.items():
        path = f"{prefix}{k}"
        out[k] = _unflatten(v, data, path + "/") if isinstance(v, dict) else _restore_leaf(data[path], v)
    return out


def restore_latest(directory: str, template: Tree) -> Optional[Tuple[int, Tree, Dict]]:
    """Restore the newest readable checkpoint into the structure, types and
    devices of ``template``."""
    if not os.path.isdir(directory):
        return None
    manifests = sorted(f for f in os.listdir(directory) if f.endswith(_MANIFEST))
    for m in reversed(manifests):
        try:
            with open(os.path.join(directory, m)) as f:
                manifest = json.load(f)
            with np.load(os.path.join(directory, manifest["file"])) as data:
                tree = _unflatten(template, data)
            return manifest["step"], tree, manifest.get("extra", {})
        except (KeyError, OSError, ValueError):
            continue  # corrupt/partial checkpoint: fall back to previous
    return None
