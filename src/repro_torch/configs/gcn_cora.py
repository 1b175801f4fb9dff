"""gcn-cora [gnn] — 2L d_hidden=16 mean aggregation sym-norm
[arXiv:1609.02907; paper]."""

import functools
from typing import Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs import base
from repro_torch.models.gnn import GnnConfig


def _cfg(dims) -> GnnConfig:
    return GnnConfig(
        name="gcn-cora", kind="gcn", n_layers=2,
        d_in=dims["d_feat"], d_hidden=16, d_out=7, aggregator="mean",
    )


FULL = _cfg(base.GNN_SHAPES["full_graph_sm"])


def smoke(device=None) -> Dict[str, float]:
    """A small GCN on the planted two-community graph: forward, loss and
    gradients, all finite."""
    from repro_torch.data.pipeline import gnn_features
    from repro_torch.graphs import generators
    from repro_torch.models import gnn

    dev = resolve_device(device)
    g = generators.two_cluster(n_per=40, seed=0)
    s, r, _ = (torch.as_tensor(a, device=dev) for a in g.undirected)
    cfg = GnnConfig(kind="gcn", d_in=8, d_hidden=16, d_out=4)
    p = gnn.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    x, labels = (torch.as_tensor(a, device=dev)
                 for a in gnn_features(g.n_nodes, 8, 4, parts_hint=g.node_attrs["block"]))
    p = {k: w.requires_grad_(True) for k, w in p.items()}
    out = gnn.gcn_forward(cfg, p, x, s, r)
    loss = gnn.node_classification_loss(out, labels)
    grads = torch.autograd.grad(loss, list(p.values()))
    if out.shape != (g.n_nodes, 4) or not all(bool(torch.isfinite(t).all()) for t in (out, *grads)):
        raise RuntimeError("gcn-cora smoke: wrong shape or non-finite values")
    return {"loss": float(loss.detach())}


base.register(base.ArchConfig(
    arch_id="gcn-cora",
    family="gnn",
    shapes=tuple(base.GNN_SHAPES),
    skipped={},
    dryrun=functools.partial(base.gnn_dryrun, "gcn", _cfg),
    smoke=smoke,
))
