"""Message-passing GNNs: GCN, GraphSAGE (full and sampled), MeshGraphNet.

Twin of ``repro.models.gnn``. Messages are gathered along an edge index
and reduced per receiving node; ``jax.ops.segment_sum`` becomes
``index_add`` into an explicit zero output (on the card a float32 sum by
atomics, so the card's sums are not bit-reproducible). Parameters keep the
JAX package's names and orientation (``y = x @ W``); MeshGraphNet's
processor stays stacked ``[L, ...]`` and a Python loop takes the place of
``lax.scan``. No kernel: the JAX models call no Pallas kernel either.

Configs: gcn-cora (2 layers, d 16, symmetric-normalised mean;
arXiv:1609.02907), graphsage-reddit (2 layers, d 128, mean, fanout 15-10;
arXiv:1706.02216), meshgraphnet (15 layers, d 128, sum, 2-layer MLPs;
arXiv:2010.03409).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L

Params = Dict[str, Any]

__all__ = [
    "GnnConfig", "segment_sum", "segment_mean", "gcn_norm_coeffs", "gcn_init", "gcn_forward",
    "sage_init", "sage_forward_full", "sage_forward_sampled", "mgn_init", "mgn_forward", "init",
    "node_classification_loss",
]


@dataclasses.dataclass(frozen=True)
class GnnConfig:
    name: str = "gcn"
    kind: str = "gcn"            # gcn | sage | meshgraphnet
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 16
    d_out: int = 7               # classes (or regression dims)
    aggregator: str = "mean"     # mean | sum
    mlp_layers: int = 2          # meshgraphnet MLP depth
    d_edge_in: int = 4           # meshgraphnet edge features
    dtype: Any = torch.float32


# -------------------------------------------------------------- primitives
def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[i] = Σ data[j] over segment_ids[j] == i`` (``jax.ops.segment_sum``)."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add(0, segment_ids, data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    s = segment_sum(data, segment_ids, num_segments)
    c = segment_sum(torch.ones((data.shape[0], 1), dtype=data.dtype, device=data.device), segment_ids,
                    num_segments)
    return s / torch.clamp(c, min=1.0)


def _degree_plus_one(senders: torch.Tensor, n: int) -> torch.Tensor:
    return segment_sum(torch.ones(senders.shape, dtype=torch.float32, device=senders.device), senders, n) + 1.0


def gcn_norm_coeffs(senders: torch.Tensor, receivers: torch.Tensor, n: int) -> torch.Tensor:
    """Symmetric normalisation D^-1/2 (A+I) D^-1/2, one coefficient an edge."""
    deg = _degree_plus_one(senders, n)
    return torch.rsqrt(deg[senders]) * torch.rsqrt(deg[receivers])


# --------------------------------------------------------------------- GCN
def gcn_init(cfg: GnnConfig, gen: torch.Generator, device=None) -> Params:
    dev = resolve_device(device)
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.d_out]
    return {
        f"w{i}": L.normal((dims[i], dims[i + 1]), dims[i] ** -0.5, gen, cfg.dtype, dev)
        for i in range(len(dims) - 1)
    }


def gcn_forward(cfg: GnnConfig, params: Params, x: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor) -> torch.Tensor:
    """Node outputs ``[N, d_out]`` from features ``[N, d_in]`` over the
    symmetrized edges."""
    senders, receivers = senders.long(), receivers.long()
    n = x.shape[0]
    coeff = gcn_norm_coeffs(senders, receivers, n)
    self_coeff = 1.0 / _degree_plus_one(senders, n)
    for i in range(cfg.n_layers):
        x = x @ params[f"w{i}"]
        agg = segment_sum(coeff[:, None] * x[receivers], senders, n)
        x = agg + self_coeff[:, None] * x
        if i < cfg.n_layers - 1:
            x = torch.relu(x)
    return x


# --------------------------------------------------------------- GraphSAGE
def sage_init(cfg: GnnConfig, gen: torch.Generator, device=None) -> Params:
    dev = resolve_device(device)
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.d_out]
    p: Params = {}
    for i in range(len(dims) - 1):
        p[f"w_self{i}"] = L.normal((dims[i], dims[i + 1]), dims[i] ** -0.5, gen, cfg.dtype, dev)
        p[f"w_nbr{i}"] = L.normal((dims[i], dims[i + 1]), dims[i] ** -0.5, gen, cfg.dtype, dev)
    return p


def sage_forward_full(cfg: GnnConfig, params: Params, x: torch.Tensor, senders: torch.Tensor,
                      receivers: torch.Tensor) -> torch.Tensor:
    senders, receivers = senders.long(), receivers.long()
    n = x.shape[0]
    for i in range(cfg.n_layers):
        nbr = segment_mean(x[receivers], senders, n)
        x = x @ params[f"w_self{i}"] + nbr @ params[f"w_nbr{i}"]
        if i < cfg.n_layers - 1:
            x = torch.relu(x)
    return x


def sage_forward_sampled(
    cfg: GnnConfig,
    params: Params,
    feats: List[torch.Tensor],       # [feats of the outermost block's source nodes, d_in]
    neighbors: List[torch.Tensor],   # per block [n_targets_i, fanout] into its sources
    masks: List[torch.Tensor],       # per block [n_targets_i, fanout]
    n_targets: List[int],
) -> torch.Tensor:
    """The layered sampled forward (fixed shapes): block i mean-pools its
    sampled neighbours' rows under the mask; a block's targets are the
    first rows of its sources."""
    h = feats[0]
    for i in range(cfg.n_layers):
        nbrs = neighbors[i].long()
        mask = masks[i]
        gathered = h[nbrs]                                   # [T, F, d]
        denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
        nbr = (gathered * mask[..., None]).sum(dim=1) / denom
        self_h = h[: nbrs.shape[0]]
        h = self_h @ params[f"w_self{i}"] + nbr @ params[f"w_nbr{i}"]
        if i < cfg.n_layers - 1:
            h = torch.relu(h)
    return h


# ------------------------------------------------------------ MeshGraphNet
def mgn_init(cfg: GnnConfig, gen: torch.Generator, device=None) -> Params:
    """Encoders, decoder and the processor's ``n_layers`` blocks stacked
    ``[L, ...]``, as the JAX package's ``vmap``-ed init lays them out."""
    dev = resolve_device(device)
    d = cfg.d_hidden
    p: Params = {
        "enc_node": L.mlp_init(gen, (cfg.d_in, d, d), cfg.dtype, dev),
        "enc_edge": L.mlp_init(gen, (cfg.d_edge_in, d, d), cfg.dtype, dev),
        "dec": L.mlp_init(gen, (d, d, cfg.d_out), cfg.dtype, dev),
    }
    blocks = [{
        "edge_mlp": L.mlp_init(gen, (3 * d, d, d), cfg.dtype, dev),
        "node_mlp": L.mlp_init(gen, (2 * d, d, d), cfg.dtype, dev),
        "ln_e": L.layernorm_init(d, cfg.dtype, dev),
        "ln_n": L.layernorm_init(d, cfg.dtype, dev),
    } for _ in range(cfg.n_layers)]

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    p["proc"] = stack(blocks)
    return p


def _layer(tree, i: int):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def mgn_forward(cfg: GnnConfig, params: Params, node_feat: torch.Tensor, edge_feat: torch.Tensor,
                senders: torch.Tensor, receivers: torch.Tensor) -> torch.Tensor:
    senders, receivers = senders.long(), receivers.long()
    n = node_feat.shape[0]
    h = L.mlp(params["enc_node"], node_feat)
    e = L.mlp(params["enc_edge"], edge_feat)
    for i in range(cfg.n_layers):
        lp = _layer(params["proc"], i)
        msg_in = torch.cat([e, h[senders], h[receivers]], dim=-1)
        e = e + L.layernorm(lp["ln_e"], L.mlp(lp["edge_mlp"], msg_in))
        agg = segment_sum(e, receivers, n)
        h = h + L.layernorm(lp["ln_n"], L.mlp(lp["node_mlp"], torch.cat([h, agg], dim=-1)))
    return L.mlp(params["dec"], h)


# ------------------------------------------------------------------ facade
def init(cfg: GnnConfig, gen: torch.Generator, device=None) -> Params:
    """Random parameters of ``cfg.kind`` on ``device`` (default CUDA),
    drawn from ``gen`` (a generator on that device)."""
    return {"gcn": gcn_init, "sage": sage_init, "meshgraphnet": mgn_init}[cfg.kind](cfg, gen, device)


def node_classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
