"""MACE-lite: higher-order E(3)-equivariant message passing
(arXiv:2206.07697; twin of ``repro.models.mace``).

The JAX package's explicit Cartesian irrep algebra, exactly
E(3)-equivariant for l ≤ 2 (no e3nn): per node ``C`` channels of scalars
``s [N, C]``, vectors ``v [N, C, 3]`` and traceless symmetric tensors
``T [N, C, 3, 3]``; messages are equivariant products with the edge
direction r̂, weighted per channel by a radial mixer of an ``n_rbf``
Bessel basis with a smooth cutoff; correlation order 3 comes from the
products at the node (|v|², T·v, tr(T·T')). The energy is a readout of the
scalars summed per molecule, so it is invariant under rotation and
translation. Aggregation is ``index_add`` (see ``models/gnn.py``). The
last layer's ``mix_v`` and ``mix_t`` feed only ``v`` and ``T``, which the
readout never reads: their gradients are zero.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.gnn import segment_sum

Params = Dict[str, Any]

__all__ = ["MaceConfig", "bessel_rbf", "init", "forward"]


@dataclasses.dataclass(frozen=True)
class MaceConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128        # channels per irrep
    l_max: int = 2
    correlation_order: int = 3
    n_rbf: int = 8
    n_species: int = 8
    r_cut: float = 2.0
    dtype: Any = torch.float32


def bessel_rbf(r: torch.Tensor, n_rbf: int, r_cut: float) -> torch.Tensor:
    """sin(nπr/rc)/r basis times a smooth polynomial cutoff."""
    r = torch.clamp(r, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=r.dtype, device=r.device)
    basis = torch.sin(n[None, :] * math.pi * r[:, None] / r_cut) / r[:, None]
    u = r / r_cut
    envelope = torch.where(u < 1.0, (1 - u) ** 2 * (1 + 2 * u), torch.zeros_like(u))
    return basis * envelope[:, None]


def init(cfg: MaceConfig, gen: torch.Generator, device=None) -> Params:
    """Random parameters on ``device`` (default CUDA), drawn from ``gen``."""
    dev = resolve_device(device)
    c = cfg.d_hidden
    p: Params = {
        "species_embed": L.normal((cfg.n_species, c), 0.1, gen, cfg.dtype, dev),
        "readout": L.mlp_init(gen, (c, c, 1), cfg.dtype, dev),
    }
    for layer in range(cfg.n_layers):
        p[f"layer{layer}"] = {
            # radial mixers, one per message group
            "radial_s": L.mlp_init(gen, (cfg.n_rbf, c), cfg.dtype, dev),
            "radial_v": L.mlp_init(gen, (cfg.n_rbf, c), cfg.dtype, dev),
            "radial_t": L.mlp_init(gen, (cfg.n_rbf, c), cfg.dtype, dev),
            # channel mixers after aggregation
            "mix_s": L.normal((3 * c, c), (3 * c) ** -0.5, gen, cfg.dtype, dev),
            "mix_v": L.normal((3 * c, c), (3 * c) ** -0.5, gen, cfg.dtype, dev),
            "mix_t": L.normal((2 * c, c), (2 * c) ** -0.5, gen, cfg.dtype, dev),
        }
    return p


def _outer_traceless(v: torch.Tensor) -> torch.Tensor:
    """v ``[..., 3]`` → the traceless symmetric ``[..., 3, 3]`` (the l=2
    part of v⊗v)."""
    t = v[..., :, None] * v[..., None, :]
    tr = torch.diagonal(t, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return t - tr * eye / 3.0


def forward(
    cfg: MaceConfig,
    params: Params,
    species: torch.Tensor,    # [N] int
    pos: torch.Tensor,        # [N, 3]
    senders: torch.Tensor,    # [E]
    receivers: torch.Tensor,  # [E]
    mol_id: torch.Tensor,     # [N] molecule of each atom
    n_mols: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(energy per molecule ``[n_mols]``, scalars per atom ``[N, C]``)."""
    senders, receivers = senders.long(), receivers.long()
    n = species.shape[0]
    c = cfg.d_hidden
    s = params["species_embed"][species.long()]
    v = torch.zeros((n, c, 3), dtype=cfg.dtype, device=pos.device)
    t = torch.zeros((n, c, 3, 3), dtype=cfg.dtype, device=pos.device)

    rij = pos[receivers] - pos[senders]
    dist = torch.linalg.norm(rij + 1e-9, dim=-1)
    rhat = rij / torch.clamp(dist, min=1e-6)[:, None]
    rbf = bessel_rbf(dist, cfg.n_rbf, cfg.r_cut)

    for layer in range(cfg.n_layers):
        lp = params[f"layer{layer}"]
        rs = L.mlp(lp["radial_s"], rbf)
        rv = L.mlp(lp["radial_v"], rbf)
        rt = L.mlp(lp["radial_t"], rbf)

        # messages (A-features): equivariant products with r̂
        src_s, src_v, src_t = s[senders], v[senders], t[senders]
        m_s = rs * src_s
        m_v = rv[:, :, None] * (src_s[:, :, None] * rhat[:, None, :] + src_v)
        m_t = rt[:, :, None, None] * (
            _outer_traceless(rhat[:, None, :].expand(src_v.shape)) * src_s[:, :, None, None] + src_t
        )
        m_s2 = rs * torch.einsum("eci,ei->ec", src_v, rhat)            # v·r̂
        m_v2 = rv[:, :, None] * torch.einsum("ecij,ej->eci", src_t, rhat)  # T·r̂

        agg_s = segment_sum(torch.cat([m_s, m_s2], dim=-1), receivers, n)
        agg_v = segment_sum(torch.cat([m_v, m_v2], dim=1), receivers, n)
        agg_t = segment_sum(m_t, receivers, n)

        # B-features: correlation-order-3 products at the node
        a_s, a_s2 = agg_s[:, :c], agg_s[:, c:]
        a_v, a_v2 = agg_v[:, :c], agg_v[:, c:]
        vv = torch.einsum("nci,nci->nc", a_v, a_v)
        tv = torch.einsum("ncij,ncj->nci", agg_t, a_v)
        tt = torch.einsum("ncij,ncij->nc", agg_t, agg_t)

        s = s + torch.tanh(torch.cat([a_s + a_s2, vv, tt], dim=-1) @ lp["mix_s"])
        cat_v = torch.cat([a_v, a_v2, tv], dim=1)
        v = v + torch.einsum("nmi,mk->nki", cat_v, lp["mix_v"])
        cat_t = torch.cat([agg_t, _outer_traceless(a_v)], dim=1)
        t = t + torch.einsum("nmij,mk->nkij", cat_t, lp["mix_t"])

    site_energy = L.mlp(params["readout"], s)[:, 0]
    energy = segment_sum(site_energy, mol_id.long(), n_mols)
    return energy, s
