"""Wrappers of the fixed-order segment sum (no Pallas twin: the JAX package
sums with ``jax.ops.segment_sum``, an XLA scatter-add).

:func:`segment_sum` computes ``out[s] = Σ data[e]`` over ``ids[e] == s``
(``n`` rows, empty segments 0) and dispatches by the device of ``data``: a
CPU or ``meta`` tensor goes to the plain version (:mod:`.ref`,
``index_add_`` into zeros), a CUDA tensor to the hand-written kernel
``csrc/segment_sum.cu``, which raises if it fails to build or launch. The
kernel adds each segment's rows in ascending edge order, the order of
``index_add_`` on the CPU, so the card's sums equal the CPU's bit for bit
and repeat from run to run (``index_add_`` on the card sums by atomics).
It takes float32 data only.

:func:`gather` is ``x[ids]`` whose backward is :func:`segment_sum` of the
gradient over ``ids``; :func:`segment_sum`'s backward is a gather. So the
forward and the backward of a message-passing layer both sum through the
kernel on the card, and autograd adds no accumulating ``index_put`` of its
own. On the CPU both backwards run the plain version (``index_add_``, one
row after another): bit-equal to autograd's own ``x[ids]`` backward on one
thread, where that accumulating ``index_put`` runs in index order too;
with more threads autograd's does not repeat from run to run, the plain
version does.

The kernel needs the edges grouped by segment (:func:`segment_order`: a
stable sort, CSR offsets and the list of long segments, built on the
card). The grouping is kept on the index tensor itself, so a static graph
whose index tensors live as long as the graph (the halo program's tables,
a training batch's edges) builds it once, and a sampled block's fresh
tensors build their own.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import CudaKernel, check_cuda_tensor
from repro_torch.kernels.segment_sum.ref import segment_order_ref, segment_sum_ref

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
KERNEL = CudaKernel("segment_sum", "segment_sum.cu", [_P, _P, _P, _P, _I64, _I64, _P, _I64, _I64, _P])
#: segments of more edges than this go to the kernel's block-per-segment path
LONG_SEGMENT = 256


def segment_order(ids: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(perm, offsets, long_ids)`` of ``ids`` (any shape, flattened) over
    ``n`` segments: :func:`.ref.segment_order_ref`'s grouping and the
    segments of more than :data:`LONG_SEGMENT` edges (int64; finding them
    waits for the device once). Kept on ``ids`` and built again only when
    ``ids`` changed in place or ``n`` differs."""
    key = (int(n), ids._version)
    memo = ids.__dict__.get("_segment_order")
    if memo is not None and memo[0] == key:
        return memo[1]
    perm, offsets = segment_order_ref(ids, n)
    order = (perm, offsets, torch.nonzero(offsets[1:] - offsets[:-1] > LONG_SEGMENT).reshape(-1))
    ids._segment_order = (key, order)
    return order


def _sum(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """The segment sum of ``data`` (``[E, ...]``) over ``ids`` (``E``
    entries, any shape), without autograd."""
    if data.device.type in ("cpu", "meta"):
        return segment_sum_ref(data, ids.reshape(-1).long(), n)
    if data.device.type != "cuda":
        raise ValueError(f"segment_sum runs on cpu, meta or cuda tensors, got {data.device}")
    return _kernel_call(data, ids, n)


def _kernel_call(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """One launch of ``csrc/segment_sum.cu`` on checked CUDA tensors."""
    e, rest = data.shape[0], tuple(data.shape[1:])
    if ids.numel() != e:
        raise ValueError(f"ids has {ids.numel()} entries, data {e} rows")
    if ids.device != data.device:
        raise ValueError(f"ids is on {ids.device}, data on {data.device}")
    flat = data.reshape(e, math.prod(rest)).contiguous()
    check_cuda_tensor(flat, "data", (torch.float32,), 2, data.device)
    perm, offsets, long_ids = segment_order(ids, n)
    out = torch.empty((n, flat.shape[1]), dtype=torch.float32, device=data.device)
    KERNEL.launch(flat.data_ptr(), perm.data_ptr(), offsets.data_ptr(), long_ids.data_ptr(), long_ids.numel(),
                  LONG_SEGMENT, out.data_ptr(), n, flat.shape[1], torch.cuda.current_stream(data.device).cuda_stream)
    return out.reshape((n,) + rest)


class _SegmentSum(torch.autograd.Function):
    """Forward the segment sum, backward the gather of the gradient."""

    @staticmethod
    def forward(ctx, data, ids, n):
        ctx.ids = ids
        return _sum(data, ids, n)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return grad.index_select(0, ctx.ids.reshape(-1).long()), None, None


class _Gather(torch.autograd.Function):
    """Forward ``x[ids]``, backward the segment sum of the gradient."""

    @staticmethod
    def forward(ctx, x, ids):
        # the index tensor itself, not a saved copy: its grouping is kept on it
        ctx.ids, ctx.n = ids, x.shape[0]
        rows = x.index_select(0, ids.reshape(-1).long())
        return rows.reshape(tuple(ids.shape) + tuple(x.shape[1:]))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        ids = ctx.ids
        flat = grad.reshape((ids.numel(),) + tuple(grad.shape[ids.dim():]))
        return _sum(flat, ids, ctx.n), None


def segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """``out[s] = Σ data[e]`` over ``ids[e] == s`` → ``[n, ...]``
    (``jax.ops.segment_sum``); differentiable in ``data``. The kernel does
    not check that ids lie in ``[0, n)``."""
    return _SegmentSum.apply(data, ids, int(n))


def gather(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``x[ids]`` → ``ids.shape + x.shape[1:]``, whose gradient in ``x`` is
    summed by :func:`segment_sum`."""
    return _Gather.apply(x, ids)
