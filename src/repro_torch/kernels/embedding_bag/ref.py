"""Plain PyTorch version of the EmbeddingBag kernel: gather, then weighted sum.

``table [V, D]``, ``indices [B, L]`` (padded), ``weights [B, L]`` (0 at
padding) → ``out [B, D]`` with ``out[b] = Σ_l weights[b, l] · table[indices[b, l]]``.
"""

from __future__ import annotations

import torch

# (V, D, B, L) of the JAX package's kernel tests (tests/test_kernels.py,
# TestEmbeddingBag): the port's tests and chip_smoke.py hold the kernel to
# this plain version at these shapes.
TEST_SHAPES = ((100, 18, 8, 5), (257, 64, 16, 7), (64, 130, 4, 3))


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    rows = table[indices.long()]                      # [B, L, D]
    return torch.einsum("bl,bld->bd", weights.to(table.dtype), rows)
