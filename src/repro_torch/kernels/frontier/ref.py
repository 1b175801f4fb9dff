"""Plain PyTorch version of the frontier gather kernel.

Same function as ``csrc/frontier_gather.cu`` on the same arguments
``(x, nbr, w)``, with ``w`` already masked: ``w·mask`` for ``mode="sum"``,
``+inf`` in padded slots for ``mode="min"``.

``mode="sum"``:  out[v, c] = Σ_j  w[v, j] · x[nbr[v, j], c]
``mode="min"``:  out[v, c] = min_j ( x[nbr[v, j], c] + w[v, j] )

One gather per slot (the unrolled-slot form the JAX package uses on its
CPU path), so memory stays at ``[V, C]`` instead of ``[V, D, C]``.
"""

from __future__ import annotations

import torch


def frontier_gather_ref(
    x: torch.Tensor,      # [N, C] float32
    nbr: torch.Tensor,    # [V, D] integer in-neighbour ids
    w: torch.Tensor,      # [V, D] float32 (masked as above)
    mode: str = "sum",
) -> torch.Tensor:
    v, d = nbr.shape
    idx = nbr.long()
    if mode == "sum":
        acc = torch.zeros((v, x.shape[1]), dtype=x.dtype, device=x.device)
        for j in range(d):
            acc = acc + w[:, j, None] * x[idx[:, j]]
        return acc
    if mode == "min":
        acc = torch.full((v, x.shape[1]), float("inf"), dtype=x.dtype, device=x.device)
        for j in range(d):
            acc = torch.minimum(acc, x[idx[:, j]] + w[:, j, None])
        return acc
    raise ValueError(f"unknown mode {mode!r}")
