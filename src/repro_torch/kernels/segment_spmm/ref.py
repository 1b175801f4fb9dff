"""Plain PyTorch version of the fixed-order CSR product.

``out[s] = Σ scale[e] · x[col[e]]`` over the edges ``e`` of row ``s``:
the float32 products ``scale[:, None] * x[col]``, then ``index_add_`` into
a zero output of ``n`` rows, which on the CPU adds them one after another
in ascending ``e``, the order the kernel ``csrc/segment_spmm.cu`` keeps
(and the order of XLA's scatter-add on the CPU, so the JAX package's
``jax.ops.segment_sum`` of the same products gives the same bits).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.segment_sum.ref import segment_sum_ref


def segment_spmm_ref(x: torch.Tensor, col: torch.Tensor, scale: torch.Tensor, ids: torch.Tensor,
                     n: int) -> torch.Tensor:
    """``x [N, F]``, ``col``, ``scale`` and ``ids`` (each edge's row) ``[E]``
    → ``[n, F]``."""
    return segment_sum_ref(scale[:, None] * x[col.long()], ids, n)

