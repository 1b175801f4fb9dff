"""Plain PyTorch version of the EmbeddingBag kernel: gather, then weighted sum.

``table [V, D]``, ``indices [B, L]`` (padded), ``weights [B, L]`` (0 at
padding) → ``out [B, D]`` with ``out[b] = Σ_l weights[b, l] · table[indices[b, l]]``.
:func:`embedding_bag_bwd_ref` is its backward, the one the kernel's
``torch.autograd.Function`` runs on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

# (V, D, B, L) of the JAX package's kernel tests (tests/test_kernels.py,
# TestEmbeddingBag): the port's tests and chip_smoke.py hold the kernel to
# this plain version at these shapes.
TEST_SHAPES = ((100, 18, 8, 5), (257, 64, 16, 7), (64, 130, 4, 3))


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    rows = table[indices.long()]                      # [B, L, D]
    return torch.einsum("bl,bld->bd", weights.to(table.dtype), rows)


def embedding_bag_bwd_ref(
    table_shape, indices: torch.Tensor, weights: torch.Tensor, table: torch.Tensor, dout: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients ``(dtable, dweights)`` of :func:`embedding_bag_ref` for
    the output gradient ``dout [B, D]``: ``dtable`` adds ``weights[b, l] ·
    dout[b]`` into row ``indices[b, l]`` (``index_add_``), and
    ``dweights[b, l] = ⟨table[indices[b, l]], dout[b]⟩``."""
    b, l = indices.shape
    idx = indices.long().reshape(-1)
    contrib = (weights.to(dout.dtype)[:, :, None] * dout[:, None, :]).reshape(b * l, -1)
    dtable = torch.zeros(tuple(table_shape), dtype=dout.dtype, device=dout.device).index_add_(0, idx, contrib)
    dweights = torch.einsum("bld,bd->bl", table[indices.long()].to(dout.dtype), dout)
    return dtable.to(table.dtype), dweights.to(weights.dtype)
