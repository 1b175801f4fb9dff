"""Plain PyTorch version of the fixed-order segment sum.

``out[s] = Σ data[e]`` over ``ids[e] == s`` into a zero output of ``n``
rows: ``index_add_``, which on the CPU adds the rows one after another in
ascending ``e``, the order the kernel ``csrc/segment_sum.cu`` keeps (and
the order of XLA's scatter-add on the CPU, so the CPU parity tests keep
their numbers). :func:`segment_order_ref` is the kernel's grouping of the
edges: a stable sort by segment and CSR offsets.
"""

from __future__ import annotations

from typing import Tuple

import torch


def segment_sum_ref(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids, data)


def segment_order_ref(ids: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(perm, offsets)``: the edge ids in ascending segment order,
    ascending within a segment (``perm [E]``, int64), and each segment's
    first position in ``perm`` (``offsets [n + 1]``, int64; segment ``s``
    is ``perm[offsets[s]:offsets[s + 1]]``). Built where ``ids`` lies,
    with no host synchronisation; ids outside ``[0, n)`` fall outside
    every segment."""
    ids = ids.reshape(-1).long()
    keys, perm = torch.sort(ids, stable=True)
    bounds = torch.arange(n + 1, dtype=torch.int64, device=ids.device)
    return perm, torch.searchsorted(keys, bounds)
