"""DIN — Deep Interest Network [arXiv:1706.06978] (twin of ``repro.models.recsys``).

Embedding width 18, history of 100, attention MLP 80-40, main MLP 200-80,
target attention over the history. Scoring (:func:`forward`) pools the
history with softmax weights from the attention MLP; the retrieval tower
(:func:`user_vector`) mask-mean pools it through the ``embedding_bag``
kernel (two launches a call on the card: items, then categories), and
:func:`retrieval_scores` scores users against candidates with one matmul.

Parameters are a dictionary laid out like the JAX package's pytree:
``item_embed [n_items, d]``, ``cat_embed [n_cats, d]``, ``attn`` and ``mlp``
(``w{i}``/``b{i}``, ``y = x @ w + b``). Batches are dictionaries of tensors:
``hist_items``/``hist_cats`` int32 [B, S], ``hist_mask`` float32 [B, S],
``target_item``/``target_cat`` int32 [B], ``label`` int32 [B].
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels.embedding_bag import embedding_bag_auto
from repro_torch.models import layers as L

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DinConfig:
    name: str = "din"
    n_items: int = 1_000_000
    n_cats: int = 10_000
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: Tuple[int, ...] = (80, 40)
    mlp: Tuple[int, ...] = (200, 80)
    dtype: Any = torch.float32


def init(cfg: DinConfig, gen: torch.Generator, device=None) -> Params:
    """Random parameters on ``device`` (default CUDA), drawn from ``gen``
    (a generator on that device)."""
    dev = resolve_device(device)
    d = cfg.embed_dim
    attn_in = 4 * 2 * d  # [hist, target, hist−target, hist*target], item‖category each
    mlp_in = 2 * d * 2   # pooled history + target
    return {
        "item_embed": L.normal((cfg.n_items, d), 0.05, gen, cfg.dtype, dev),
        "cat_embed": L.normal((cfg.n_cats, d), 0.05, gen, cfg.dtype, dev),
        "attn": L.mlp_init(gen, (attn_in,) + tuple(cfg.attn_mlp) + (1,), cfg.dtype, dev),
        "mlp": L.mlp_init(gen, (mlp_in,) + tuple(cfg.mlp) + (1,), cfg.dtype, dev),
    }


def _embed_pair(params: Params, items: torch.Tensor, cats: torch.Tensor) -> torch.Tensor:
    """[...] ids → [..., 2d] item‖category embedding."""
    ei = params["item_embed"][items.long()]
    ec = params["cat_embed"][cats.long()]
    return torch.cat([ei, ec], dim=-1)


def forward(cfg: DinConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Click logits [B]: target attention over the history, then the MLP."""
    hist = _embed_pair(params, batch["hist_items"], batch["hist_cats"])    # [B,S,2d]
    target = _embed_pair(params, batch["target_item"], batch["target_cat"])  # [B,2d]
    tgt = target[:, None, :].expand_as(hist)
    attn_in = torch.cat([hist, tgt, hist - tgt, hist * tgt], dim=-1)
    scores = L.mlp(params["attn"], attn_in)[..., 0]                        # [B,S]
    del attn_in  # 15 GB at the serve_bulk batch; free it before the softmax
    mask = batch["hist_mask"]
    scores = scores.masked_fill(~(mask > 0), -1e30)
    # Softmax over the history (the common variant; the paper's DIN leaves
    # the sigmoid weights unnormalised), zero for an empty history.
    w = torch.softmax(scores, dim=-1) * (mask.sum(-1, keepdim=True) > 0)
    pooled = torch.einsum("bs,bsd->bd", w.to(hist.dtype), hist)            # [B,2d]
    feats = torch.cat([pooled, target], dim=-1)
    return L.mlp(params["mlp"], feats)[..., 0]


def pooled_history_embedding_bag(cfg: DinConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mask-mean history pooling through ``embedding_bag`` → [B, 2d]."""
    w = batch["hist_mask"].to(params["item_embed"].dtype)
    pooled_i = embedding_bag_auto(params["item_embed"], batch["hist_items"], w, mode="mean")
    pooled_c = embedding_bag_auto(params["cat_embed"], batch["hist_cats"], w, mode="mean")
    return torch.cat([pooled_i, pooled_c], dim=-1)


def bce_loss(cfg: DinConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean binary cross-entropy of the click logits: the training loss
    (scoring pools with softmax weights, so it reaches no kernel)."""
    z = forward(cfg, params, batch).float()
    y = batch["label"].float()
    return torch.mean(torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs())))


def user_vector(cfg: DinConfig, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Retrieval tower: mask-mean pooled history → [B, 2d] user vector."""
    return pooled_history_embedding_bag(cfg, params, batch)


def retrieval_scores(cfg: DinConfig, params: Params, user_vec: torch.Tensor,
                     cand_items: torch.Tensor, cand_cats: torch.Tensor) -> torch.Tensor:
    """Score [B] users against [n_cand] candidates: one batched matmul."""
    cand = _embed_pair(params, cand_items, cand_cats)      # [n_cand, 2d]
    return user_vec @ cand.T                               # [B, n_cand]
