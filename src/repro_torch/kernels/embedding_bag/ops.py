"""Wrappers of the EmbeddingBag kernel (twin of ``repro.kernels.embedding_bag``).

:func:`embedding_bag` dispatches by the device of ``table``: a CPU or
``meta`` tensor goes to the plain version (:mod:`.ref`), a CUDA tensor to the hand-written
kernel ``csrc/embedding_bag.cu``, which raises if it fails to build or
launch. :func:`embedding_bag_auto` adds ``sum``/``mean`` pooling on top,
normalising ``mean`` weights exactly as the JAX package does. The JAX
package's ``use_kernel`` switch has no twin: the device decides.

On the card the kernel's output is differentiable: :func:`embedding_bag`
runs it inside a ``torch.autograd.Function`` (:class:`_EmbeddingBag`) whose
forward is one counted launch and whose backward is the plain
:func:`.ref.embedding_bag_bwd_ref`, as the JAX package differentiates its
oracle. :data:`KERNEL` counts forward launches only. On the CPU and on
``meta`` autograd differentiates the plain version itself.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import CudaKernel, check_cuda_tensor
from repro_torch.kernels.embedding_bag.ref import embedding_bag_bwd_ref, embedding_bag_ref

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
KERNEL = CudaKernel("embedding_bag", "embedding_bag.cu", [_P, _P, _P, _P, _I64, _I64, _I64, _P])


def embedding_bag(
    table: torch.Tensor,    # [V, D] float32
    indices: torch.Tensor,  # [B, L] int32 (0 where padded), each in [0, V)
    weights: torch.Tensor,  # [B, L] float32 (0 where padded)
) -> torch.Tensor:
    """``out[b] = Σ_l weights[b, l] · table[indices[b, l]]`` → ``[B, D]``.

    The kernel does not check that indices lie in ``[0, V)``."""
    if table.device.type in ("cpu", "meta"):
        return embedding_bag_ref(table, indices, weights)
    if table.device.type != "cuda":
        raise ValueError(f"embedding_bag runs on cpu, meta or cuda tensors, got {table.device}")
    return _EmbeddingBag.apply(table, indices, weights)


class _EmbeddingBag(torch.autograd.Function):
    """The CUDA branch under autograd: forward is the kernel (one counted
    launch), backward the plain :func:`embedding_bag_bwd_ref` (no launch)."""

    @staticmethod
    def forward(ctx, table, indices, weights):
        ctx.save_for_backward(table, indices, weights)
        return _kernel_call(table, indices, weights)

    @staticmethod
    def backward(ctx, dout):
        table, indices, weights = ctx.saved_tensors
        dtable, dweights = embedding_bag_bwd_ref(table.shape, indices, weights, table, dout.contiguous())
        return dtable, None, dweights


def _kernel_call(table, indices, weights) -> torch.Tensor:
    """One launch of ``csrc/embedding_bag.cu`` on checked CUDA tensors."""
    check_cuda_tensor(table, "table", (torch.float32,), 2, table.device)
    check_cuda_tensor(indices, "indices", (torch.int32,), 2, table.device)
    check_cuda_tensor(weights, "weights", (torch.float32,), 2, table.device)
    if weights.shape != indices.shape:
        raise ValueError(f"weights {tuple(weights.shape)} and indices {tuple(indices.shape)} differ")
    out = torch.empty((indices.shape[0], table.shape[1]), dtype=torch.float32, device=table.device)
    _launch(table, indices, weights, out)
    return out


def _launch(table, indices, weights, out) -> None:
    b, l = indices.shape
    KERNEL.launch(
        table.data_ptr(), indices.data_ptr(), weights.data_ptr(), out.data_ptr(),
        b, l, table.shape[1], torch.cuda.current_stream(table.device).cuda_stream,
    )


def embedding_bag_auto(
    table: torch.Tensor,
    indices: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
    *,
    mode: str = "sum",
) -> torch.Tensor:
    """EmbeddingBag with ``sum`` or ``mean`` pooling; ``mean`` divides each
    bag's weights by ``max(Σ_l w, 1e-9)`` before the weighted sum."""
    if weights is None:
        weights = torch.ones(indices.shape, dtype=table.dtype, device=table.device)
    if mode == "mean":
        denom = torch.clamp(weights.sum(dim=1, keepdim=True), min=1e-9)
        weights = weights / denom
    elif mode != "sum":
        raise ValueError(f"unknown mode {mode!r}")
    return embedding_bag(table, indices, weights)
