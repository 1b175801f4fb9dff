"""mace [gnn] — 2L d_hidden=128 l_max=2 correlation_order=3 n_rbf=8
E(3)-equivariant ACE message passing [arXiv:2206.07697; paper]."""

import functools
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import base
from repro_torch.models.mace import MaceConfig


def _cfg(dims) -> MaceConfig:
    return MaceConfig(
        name="mace", n_layers=2, d_hidden=128, l_max=2,
        correlation_order=3, n_rbf=8, n_species=8,
    )


FULL = _cfg(base.GNN_SHAPES["molecule"])


def smoke(device=None) -> Dict[str, float]:
    """A small MACE on 4 molecules: energies finite, invariant under a
    rotation within 1e-4, gradients finite."""
    from repro_torch.graphs import generators
    from repro_torch.models import mace
    from repro_torch.optim.adamw import leaves

    dev = resolve_device(device)
    mol = generators.molecule_batch(n_mols=4, atoms_per_mol=10, seed=0)
    cfg = MaceConfig(d_hidden=16, n_layers=2)
    p = mace.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    species, pos, mol_id = (torch.as_tensor(mol.node_attrs[k], device=dev) for k in ("species", "pos", "mol_id"))
    s, r = torch.as_tensor(mol.senders, device=dev), torch.as_tensor(mol.receivers, device=dev)
    e, _ = mace.forward(cfg, p, species, pos, s, r, mol_id, 4)
    q, _ = np.linalg.qr(np.random.default_rng(0).normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    e2, _ = mace.forward(cfg, p, species, pos @ torch.as_tensor(q.astype(np.float32), device=dev), s, r, mol_id, 4)
    ws = [w.requires_grad_(True) for w in leaves(p)]
    grads = torch.autograd.grad((mace.forward(cfg, p, species, pos, s, r, mol_id, 4)[0] ** 2).sum(), ws,
                                allow_unused=True, materialize_grads=True)
    if e.shape != (4,) or not all(bool(torch.isfinite(t).all()) for t in (e, *grads)):
        raise RuntimeError("mace smoke: wrong shape or non-finite values")
    if float((e - e2).abs().max()) >= 1e-4:
        raise RuntimeError("mace smoke: rotation invariance violated")
    return {"energy_mean": float(e.mean())}


base.register(base.ArchConfig(
    arch_id="mace",
    family="gnn",
    shapes=tuple(base.GNN_SHAPES),
    skipped={},
    dryrun=functools.partial(base.gnn_dryrun, "mace", _cfg),
    smoke=smoke,
))
