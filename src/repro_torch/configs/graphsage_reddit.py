"""graphsage-reddit [gnn] — 2L d_hidden=128 mean aggregation,
sample_sizes=25-10 (arch) / fanout 15-10 (assigned minibatch shape)
[arXiv:1706.02216; paper]."""

import functools
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import base
from repro_torch.models.gnn import GnnConfig


def _cfg(dims) -> GnnConfig:
    return GnnConfig(
        name="graphsage-reddit", kind="sage", n_layers=2,
        d_in=dims["d_feat"], d_hidden=128, d_out=41, aggregator="mean",
    )


FULL = _cfg(base.GNN_SHAPES["minibatch_lg"])


def smoke(device=None) -> Dict[str, float]:
    """A small GraphSAGE on a Twitter-like graph: the full-graph forward,
    then the sampled forward over a real neighbour sampler and its loss."""
    from repro_torch.data.pipeline import gnn_features
    from repro_torch.graphs import generators
    from repro_torch.graphs.sampler import NeighborSampler
    from repro_torch.models import gnn

    dev = resolve_device(device)
    g = generators.twitter_social(scale=0.002, seed=0)
    cfg = GnnConfig(kind="sage", d_in=16, d_hidden=32, d_out=5)
    p = gnn.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    x, labels = gnn_features(g.n_nodes, 16, 5)
    s, r, _ = (torch.as_tensor(a, device=dev) for a in g.undirected)
    out = gnn.sage_forward_full(cfg, p, torch.as_tensor(x, device=dev), s, r)
    blocks = NeighborSampler(g, (5, 3), seed=0).sample_batch(np.arange(16))
    out2 = gnn.sage_forward_sampled(
        cfg, p, [torch.as_tensor(x[blocks[0].src_nodes], device=dev)],
        [torch.as_tensor(b.neighbors, device=dev) for b in blocks],
        [torch.as_tensor(b.mask, device=dev) for b in blocks],
        [b.n_targets for b in blocks],
    )
    if (out.shape != (g.n_nodes, 5) or out2.shape != (16, 5)
            or not (bool(torch.isfinite(out).all()) and bool(torch.isfinite(out2).all()))):
        raise RuntimeError("graphsage-reddit smoke: wrong shape or non-finite values")
    loss = gnn.node_classification_loss(out2, torch.as_tensor(labels[:16], device=dev))
    return {"loss": float(loss.detach())}


base.register(base.ArchConfig(
    arch_id="graphsage-reddit",
    family="gnn",
    shapes=tuple(base.GNN_SHAPES),
    skipped={},
    dryrun=functools.partial(base.gnn_dryrun, "sage", _cfg),
    smoke=smoke,
))
