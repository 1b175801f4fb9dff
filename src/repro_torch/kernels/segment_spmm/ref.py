"""Plain PyTorch version of the fixed-order CSR product and of DiDiC's
updates around it.

``out[s] = Σ scale[e] · x[col[e]]`` over the edges ``e`` of row ``s``:
the float32 products ``scale[:, None] * x[col]``, then ``index_add_`` into
a zero output of ``n`` rows, which on the CPU adds them one after another
in ascending ``e``, the order the kernel ``csrc/segment_spmm.cu`` keeps
(and the order of XLA's scatter-add on the CPU, so the JAX package's
``jax.ops.segment_sum`` of the same products gives the same bits).

The three epilogues are DiDiC's updates (``core/didic.py``'s step, the
JAX package's ``src/repro/core/didic.py:205-206``, ``:211``, ``:219``),
written as the step writes them, so on the CPU a fused call is the step's
own arithmetic; the kernel rounds each of their operations once, in this
order. ``x`` is the product's input (``n`` rows) and ``d`` a ``[n]``
vector.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.segment_sum.ref import segment_sum_ref


def segment_spmm_ref(x: torch.Tensor, col: torch.Tensor, scale: torch.Tensor, ids: torch.Tensor,
                     n: int) -> torch.Tensor:
    """``x [N, F]``, ``col``, ``scale`` and ``ids`` (each edge's row) ``[E]``
    → ``[n, F]``."""
    return segment_sum_ref(scale[:, None] * x[col.long()], ids, n)


def benefit_ref(parts: torch.Tensor, k: int, member: float, live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[n, k]``: ``member`` where the row is live and the column is its
    part, else 1 (DiDiC's secondary benefit, Eq. 4.7)."""
    classes = torch.arange(k, dtype=torch.int32, device=parts.device)
    onehot = (parts[:, None] == classes[None, :]).to(torch.float32)
    if live is not None:
        onehot = onehot * live.to(torch.float32)[:, None]
    return 1.0 + (member - 1.0) * onehot


def secondary_ref(x: torch.Tensor, col: torch.Tensor, scale: torch.Tensor, ids: torch.Tensor, l: torch.Tensor,
                  degc: torch.Tensor, parts: torch.Tensor, member: float,
                  live: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The secondary step with ``x = l / b``: ``l' = l − degc·x + A @ x`` and
    the next step's ``l' / b``."""
    l = l - degc[:, None] * x + segment_spmm_ref(x, col, scale, ids, x.shape[0])
    return l, l / benefit_ref(parts, x.shape[1], member, live)


def primary_ref(x: torch.Tensor, col: torch.Tensor, scale: torch.Tensor, ids: torch.Tensor, l: torch.Tensor,
                degc: torch.Tensor) -> torch.Tensor:
    """The primary step with ``x = w``: ``w + l − degc·w + A @ w``."""
    return x + l - degc[:, None] * x + segment_spmm_ref(x, col, scale, ids, x.shape[0])


def smooth_ref(x: torch.Tensor, col: torch.Tensor, scale: torch.Tensor, ids: torch.Tensor,
               safe_deg: torch.Tensor) -> torch.Tensor:
    """One lazy-random-walk smoothing step: ``0.5·x + 0.5·(A @ x) / safe_deg``."""
    return 0.5 * x + 0.5 * segment_spmm_ref(x, col, scale, ids, x.shape[0]) / safe_deg[:, None]
