"""Wrapper of the fixed-order CSR product (no Pallas twin: the JAX package
computes DiDiC's product at the paper's scale as ``ce[:, None] *
take(x, r)`` followed by ``jax.ops.segment_sum``, and ``bell_matmul``'s
block-ELL packing fits reduced scales only).

:func:`segment_spmm` computes ``out[s] = Σ scale[e] · x[col[e]]`` over
the edges of row ``s`` of a :class:`CsrMatrix` (built once by
:func:`csr_matrix`, which checks its tensors), and dispatches by the
device of ``x``: a CPU or ``meta`` tensor goes to the plain version
(:mod:`.ref`: the float32 products, then ``index_add_`` into zeros), a
CUDA tensor to the hand-written kernel ``csrc/segment_spmm.cu``, which
raises if it fails to build or launch. The kernel rounds each product
once and adds each row's products in ascending edge order from +0.0, the
order of ``index_add_`` on the CPU, so the card's product equals the
CPU's bit for bit and repeats from run to run. It takes float32 ``x``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import CudaKernel, check_cuda_tensor
from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
KERNEL = CudaKernel("segment_spmm", "segment_spmm.cu", [_P, _P, _P, _P, _P, _I64, _I64, _P, _I64, _I64, _P])
#: rows of more edges than this go to the kernel's long role (a block for
#: every 16 columns), the others to its short role (a lane group each). 256
#: by measurement on an H100 (``kernel_ab.py --phase segment_spmm
#: --long-segment``, DiDiC's matrices at ``scale=1.0``, k = 4): filesystem's
#: 10,922 rows of 65-104 edges take 1.5x longer as long blocks (at 32 or
#: 64) than in the short role (at 96 to 1,024, all alike); GIS and Twitter
#: do not move
LONG_SEGMENT = 256


class CsrMatrix(NamedTuple):
    """A sparse matrix in CSR form, its edges sorted by row, built once by
    :func:`csr_matrix`."""

    ids: torch.Tensor       # [E] int64: each edge's row, ascending (the plain version's)
    offsets: torch.Tensor   # [n + 1] int64: row s holds edges offsets[s]:offsets[s + 1]
    col: torch.Tensor       # [E] int32: each edge's row of x
    scale: torch.Tensor     # [E] float32: each edge's coefficient
    long_ids: torch.Tensor  # int64: the rows of more than long_at edges, longest first
    long_at: int

    @property
    def n(self) -> int:
        return self.offsets.numel() - 1


def csr_matrix(ids: torch.Tensor, col: torch.Tensor, scale: torch.Tensor, n: int) -> CsrMatrix:
    """The ``n``-row CSR matrix of the edges ``(ids[e], col[e], scale[e])``
    whose rows ``ids`` ascend (rows past the last id stay empty), where the
    tensors lie: offsets by ``bincount`` and ``cumsum``, and the rows of
    more than :data:`LONG_SEGMENT` edges, longest first, ties by ascending
    row (the kernel gives them its first blocks; finding them waits for the
    device once)."""
    ids = ids.reshape(-1).long()
    if ids.numel() and (bool((ids[1:] < ids[:-1]).any()) or int(ids[0]) < 0 or int(ids[-1]) >= n):
        raise ValueError(f"csr_matrix needs row ids ascending within [0, {n})")
    col = col.reshape(-1).to(torch.int32).contiguous()
    scale = scale.reshape(-1).to(torch.float32).contiguous()
    if not ids.numel() == col.numel() == scale.numel():
        raise ValueError(f"{ids.numel()} row ids, {col.numel()} columns, {scale.numel()} values")
    if not ids.device == col.device == scale.device:
        raise ValueError(f"row ids on {ids.device}, columns on {col.device}, values on {scale.device}")
    lengths = torch.bincount(ids, minlength=n)
    offsets = torch.cat([lengths.new_zeros(1), torch.cumsum(lengths, 0)])
    long_ids = torch.nonzero(lengths > LONG_SEGMENT).reshape(-1)
    long_ids = long_ids[torch.sort(lengths[long_ids], descending=True, stable=True).indices]
    return CsrMatrix(ids, offsets, col, scale, long_ids, LONG_SEGMENT)


def segment_spmm(x: torch.Tensor, a: CsrMatrix) -> torch.Tensor:
    """``out[s] = Σ a.scale[e] · x[a.col[e]]`` over row ``s``'s edges →
    ``[a.n, F]`` for ``x [N, F]``. The kernel does not check that ``a.col``
    lies in ``[0, N)``."""
    if x.device.type in ("cpu", "meta"):
        return segment_spmm_ref(x, a.col, a.scale, a.ids, a.n)
    if x.device.type != "cuda":
        raise ValueError(f"segment_spmm runs on cpu, meta or cuda tensors, got {x.device}")
    return _kernel_call(x.contiguous(), a)


def _kernel_call(x: torch.Tensor, a: CsrMatrix) -> torch.Tensor:
    """One launch of ``csrc/segment_spmm.cu``; the matrix's tensors were
    checked when it was built, so only ``x`` is checked here (the stream is
    read raw, as ``segment_sum`` reads it)."""
    dev = x.device
    check_cuda_tensor(x, "x", (torch.float32,), 2, a.offsets.device)
    n, f = a.n, x.shape[1]
    out = torch.empty((n, f), dtype=torch.float32, device=dev)
    KERNEL.launch(x.data_ptr(), a.col.data_ptr(), a.scale.data_ptr(), a.offsets.data_ptr(), a.long_ids.data_ptr(),
                  a.long_ids.numel(), a.long_at, out.data_ptr(), n, f, torch._C._cuda_getCurrentRawStream(dev.index))
    return out
