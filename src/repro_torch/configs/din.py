"""din [recsys] — embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80
target-attention interaction [arXiv:1706.06978; paper]."""

import functools
from typing import Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs import base
from repro_torch.models.recsys import DinConfig

FULL = DinConfig(
    name="din", n_items=1_000_000, n_cats=10_000, embed_dim=18, seq_len=100,
    attn_mlp=(80, 40), mlp=(200, 80),
)


def smoke(device=None) -> Dict[str, float]:
    """A small DIN on 8 requests: logits, loss and gradients finite, and the
    retrieval tower scoring 100 candidates."""
    from repro_torch.data.pipeline import din_batch
    from repro_torch.models import recsys
    from repro_torch.optim.adamw import leaves

    dev = resolve_device(device)
    cfg = DinConfig(n_items=500, n_cats=20, seq_len=10)
    p = recsys.init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    b = {k: torch.as_tensor(v, device=dev) for k, v in din_batch(8, 10, 500, 20).items()}
    ws = [w.requires_grad_(True) for w in leaves(p)]
    logits = recsys.forward(cfg, p, b)
    loss = recsys.bce_loss(cfg, p, b)
    grads = torch.autograd.grad(loss, ws)
    with torch.no_grad():
        uv = recsys.user_vector(cfg, p, b)
        cand = torch.arange(100, device=dev)
        scores = recsys.retrieval_scores(cfg, p, uv, cand, cand % 20)
    if logits.shape != (8,) or scores.shape != (8, 100) or not all(
            bool(torch.isfinite(t).all()) for t in (logits, scores, *grads)):
        raise RuntimeError("din smoke: wrong shape or non-finite values")
    return {"loss": float(loss.detach())}


base.register(base.ArchConfig(
    arch_id="din",
    family="recsys",
    shapes=tuple(base.DIN_SHAPES),
    skipped={},
    dryrun=functools.partial(base.din_dryrun, FULL),
    smoke=smoke,
))
