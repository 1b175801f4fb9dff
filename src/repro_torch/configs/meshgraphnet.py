"""meshgraphnet [gnn] — 15L d_hidden=128 sum aggregation mlp_layers=2
[arXiv:2010.03409]. ``FULL`` takes its input width from the registry's
first shape (``full_graph_sm``), as the JAX registry's cells do."""

import functools
from typing import Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs import base
from repro_torch.models.gnn import GnnConfig


def _cfg(dims) -> GnnConfig:
    return GnnConfig(
        name="meshgraphnet", kind="meshgraphnet", n_layers=15,
        d_in=dims["d_feat"], d_hidden=128, d_out=3, aggregator="sum",
        mlp_layers=2, d_edge_in=4,
    )


FULL = _cfg(base.GNN_SHAPES["full_graph_sm"])


def smoke(device=None) -> Dict[str, float]:
    """A 3-block MeshGraphNet on a 10×10 mesh: forward, loss and
    gradients, all finite."""
    from repro_torch.graphs import generators
    from repro_torch.models import gnn
    from repro_torch.optim.adamw import leaves

    dev = resolve_device(device)
    g = generators.mesh_graph(10, 10, seed=0)
    s, r, _ = (torch.as_tensor(a, device=dev) for a in g.undirected)
    cfg = GnnConfig(kind="meshgraphnet", n_layers=3, d_in=4, d_hidden=32, d_out=2, d_edge_in=3)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = gnn.init(cfg, gen, device=dev)
    nf = torch.randn((g.n_nodes, 4), generator=gen, device=dev)
    ef = torch.randn((s.shape[0], 3), generator=gen, device=dev)
    ws = [w.requires_grad_(True) for w in leaves(p)]
    out = gnn.mgn_forward(cfg, p, nf, ef, s, r)
    loss = (out ** 2).mean()
    grads = torch.autograd.grad(loss, ws)
    if out.shape != (g.n_nodes, 2) or not all(bool(torch.isfinite(t).all()) for t in (out, *grads)):
        raise RuntimeError("meshgraphnet smoke: wrong shape or non-finite values")
    return {"loss": float(loss.detach())}


base.register(base.ArchConfig(
    arch_id="meshgraphnet",
    family="gnn",
    shapes=tuple(base.GNN_SHAPES),
    skipped={},
    dryrun=functools.partial(base.gnn_dryrun, "meshgraphnet", _cfg),
    smoke=smoke,
))
