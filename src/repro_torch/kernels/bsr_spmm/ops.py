"""Wrappers of the block-ELL SpMM kernel (twin of ``repro.kernels.bsr_spmm``).

:func:`bell_matmul` dispatches by the device of ``x``: a CPU or ``meta``
tensor goes to the plain version (:mod:`.ref`), a CUDA tensor to the hand-written kernel
``csrc/bell_matmul.cu``, which raises if it fails to build or launch. The
kernel streams block rows with 16-byte copies, so on the card a block row
(``bs`` values) must be a multiple of 16 bytes: ``bs % 4 == 0`` in float32,
``bs % 8 == 0`` in bfloat16.
:func:`make_bell_matmul` closes over a host-side
:class:`~repro_torch.graphs.structure.BlockEll` and returns ``X -> A @ X``.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.graphs.structure import BlockEll
from repro_torch.kernels import CudaKernel, check_cuda_tensor
from repro_torch.kernels.bsr_spmm.ref import bell_matmul_ref

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
KERNEL = CudaKernel(
    "bell_matmul", "bell_matmul.cu", [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, ctypes.c_int, _P],
)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bell_matmul(
    blocks: torch.Tensor,       # [nbr, maxnnz, bs, bs] float32 or bfloat16
    block_cols: torch.Tensor,   # [nbr, maxnnz] int32
    block_mask: torch.Tensor,   # [nbr, maxnnz] int32 (0/1)
    x: torch.Tensor,            # [nbr*bs, F], blocks' dtype
) -> torch.Tensor:
    """``A @ x`` over the block-ELL ``A``; returns ``x``'s dtype."""
    if x.device.type in ("cpu", "meta"):
        return bell_matmul_ref(blocks, block_cols, block_mask, x)
    if x.device.type != "cuda":
        raise ValueError(f"bell_matmul runs on cpu, meta or cuda tensors, got {x.device}")
    if x.dtype not in _DTYPES or blocks.dtype != x.dtype:
        raise TypeError(f"blocks {blocks.dtype} and x {x.dtype} must both be float32 or bfloat16")
    check_cuda_tensor(blocks, "blocks", (x.dtype,), 4, x.device)
    check_cuda_tensor(block_cols, "block_cols", (torch.int32,), 2, x.device)
    check_cuda_tensor(block_mask, "block_mask", (torch.int32,), 2, x.device)
    check_cuda_tensor(x, "x", (x.dtype,), 2, x.device)
    nbr, maxnnz, bs, bs2 = blocks.shape
    if bs != bs2:
        raise ValueError(f"blocks must be square, got {bs}x{bs2}")
    if tuple(block_cols.shape) != (nbr, maxnnz) or tuple(block_mask.shape) != (nbr, maxnnz):
        raise ValueError("block_cols and block_mask must be [n_block_rows, max_nnz]")
    if x.shape[0] != nbr * bs:
        raise ValueError(f"x has {x.shape[0]} rows, the layout {nbr * bs}")
    if (bs * blocks.element_size()) % 16 or blocks.data_ptr() % 16:
        raise ValueError(f"the kernel copies block rows in 16-byte units: block size {bs} "
                         f"({blocks.dtype}) and the blocks' address must allow it")
    f = x.shape[1]
    out = torch.empty((nbr * bs, f), dtype=x.dtype, device=x.device)
    KERNEL.launch(
        blocks.data_ptr(), block_cols.data_ptr(), block_mask.data_ptr(),
        x.data_ptr(), out.data_ptr(), nbr, maxnnz, bs, f, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return out


def make_bell_matmul(
    bell: BlockEll, device=None, dtype: torch.dtype = torch.float32,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return ``x [padded_rows, F] -> A @ x`` on ``device``."""
    dev = resolve_device(device)
    blocks = torch.as_tensor(bell.blocks, device=dev).to(dtype).contiguous()
    cols = torch.as_tensor(bell.block_cols, dtype=torch.int32, device=dev)
    mask = torch.as_tensor(bell.block_mask, device=dev).to(torch.int32)

    def mm(x: torch.Tensor) -> torch.Tensor:
        return bell_matmul(blocks, cols, mask, x)

    return mm
