"""Plain PyTorch version of the frontier gather kernel.

Same function as ``csrc/frontier_gather.cu`` on the same arguments
``(x, nbr, w, tail)``, with ``w`` already masked: ``w·mask`` for
``mode="sum"``, ``+inf`` in padded slots for ``mode="min"``; ``tail``
holds each row's over-cap slots (:class:`SpillTail`).

``mask`` (``[V, D]`` {0, 1}, the JAX reference's fourth argument) masks an
unmasked ``w`` here instead: 0 for ``sum``, ``+inf`` for ``min``.

``mode="sum"``:  out[v, c] = Σ_j  w[v, j] · x[nbr[v, j], c]  (+ Σ over v's tail)
``mode="min"``:  out[v, c] = min_j ( x[nbr[v, j], c] + w[v, j] )  (and over v's tail)

``min`` is ``torch.minimum``'s: NaN wherever any ``x + w`` is NaN. One
gather per slot (the unrolled-slot form the JAX package uses on its CPU
path), so memory stays at ``[V, C]`` instead of ``[V, D, C]``; the tail is
folded in as the JAX package folds its spill tail, with
``scatter_reduce_("amin")`` or ``index_add_``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class SpillTail(NamedTuple):
    """Over-cap slots of a capped layout, grouped by receiving row (CSR)."""

    ptr: torch.Tensor   # [V + 1] int32: row v's slots are src/w[ptr[v]:ptr[v + 1]]
    src: torch.Tensor   # [S] int32 sender (row of x) of each slot
    w: torch.Tensor     # [S] float32 weight of each slot, as in w above
    rows: torch.Tensor  # [R] int32 the rows that have tail slots, ascending


def frontier_gather_ref(
    x: torch.Tensor,      # [N, C] float32
    nbr: torch.Tensor,    # [V, D] integer in-neighbour ids
    w: torch.Tensor,      # [V, D] float32 (masked as above)
    mask: Optional[torch.Tensor] = None,  # [V, D] {0, 1}, when w is not masked
    mode: str = "sum",
    tail: Optional[SpillTail] = None,
) -> torch.Tensor:
    v, d = nbr.shape
    if mask is not None:
        if mode == "sum":
            w = w * mask.to(w.dtype)
        else:
            w = torch.where(mask > 0, w, torch.full_like(w, float("inf")))
    idx = nbr.long()
    if mode == "sum":
        acc = torch.zeros((v, x.shape[1]), dtype=x.dtype, device=x.device)
        for j in range(d):
            acc = acc + w[:, j, None] * x[idx[:, j]]
    elif mode == "min":
        acc = torch.full((v, x.shape[1]), float("inf"), dtype=x.dtype, device=x.device)
        for j in range(d):
            acc = torch.minimum(acc, x[idx[:, j]] + w[:, j, None])
    else:
        raise ValueError(f"unknown mode {mode!r}")
    if tail is None or tail.src.shape[0] == 0:
        return acc
    counts = (tail.ptr[1:] - tail.ptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(v, device=x.device), counts)
    vals = x[tail.src.long()]
    if mode == "sum":
        return acc.index_add_(0, rows, tail.w[:, None] * vals)
    return acc.scatter_reduce_(0, rows[:, None].expand(-1, x.shape[1]), vals + tail.w[:, None], "amin",
                               include_self=True)
