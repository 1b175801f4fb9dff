"""Wrapper of the fixed-order CSR product and DiDiC's updates fused into it
(no Pallas twin: the JAX package computes DiDiC's product at the paper's
scale as ``ce[:, None] * take(x, r)`` followed by ``jax.ops.segment_sum``,
and ``bell_matmul``'s block-ELL packing fits reduced scales only).

:func:`segment_spmm` computes ``out[s] = Σ scale[e] · x[col[e]]`` over
the edges of row ``s`` of a :class:`CsrMatrix` (built once by
:func:`csr_matrix`, which checks its tensors and plans the kernel's
tiles); :func:`segment_spmm_secondary`, :func:`segment_spmm_primary` and
:func:`segment_spmm_smooth` compute DiDiC's three updates around the same
product, each in one launch. Each dispatches by the device of ``x``: a CPU
or ``meta`` tensor goes to the plain version (:mod:`.ref`: the float32
products, then ``index_add_`` into zeros, then the update as DiDiC's step
writes it), a CUDA tensor to the hand-written kernel
``csrc/segment_spmm.cu``, which raises if it fails to build or launch. The
kernel rounds each product once and adds each row's products in ascending
edge order from +0.0, the order of ``index_add_`` on the CPU, and rounds
each operation of an update once in the plain version's order, so the
card's result equals the CPU's bit for bit and repeats from run to run. It
takes float32 ``x``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import CudaKernel, check_cuda_tensor
from repro_torch.kernels.segment_spmm.ref import (
    benefit_ref, primary_ref, secondary_ref, segment_spmm_ref, smooth_ref,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_longlong
KERNEL = CudaKernel("segment_spmm", "segment_spmm.cu",
                    [_P, _P, _P, _P, _I, _P, _I64, _I64, _P, _I64, _I64, _P, _I64, _I64, _I, ctypes.c_float,
                     _P, _P, _P, _P, _P, _P])
#: rows of more edges than this go to the kernel's long role (a block for
#: every 16 columns), the others to tiles (F = 4) or lane groups. 256 by
#: measurement on an H100 (``kernel_ab.py --phase segment_spmm
#: --long-segment``, DiDiC's matrices at ``scale=1.0``, k = 4, on the lane
#: groups): filesystem's 10,922 rows of 65-104 edges take 1.5x longer as
#: long blocks (at 32 or 64) than as short rows (at 96 to 1,024, all
#: alike); GIS and Twitter do not move
LONG_SEGMENT = 256
#: a tile's edges at most (at most ``kTileEdges`` = 2,048 in the kernel: 32
#: KB of x rows at F = 4) and its rows at most (a thread each: the kernel's
#: block of 256 threads)
TILE_EDGES = 2048
TILE_ROWS = 256
#: the kernel's epilogue codes
EPILOGUES = {"none": 0, "secondary": 1, "primary": 2, "smooth": 3}


class CsrMatrix(NamedTuple):
    """A sparse matrix in CSR form, its edges sorted by row, built once by
    :func:`csr_matrix`."""

    ids: torch.Tensor       # [E] int64: each edge's row, ascending (the plain version's)
    offsets: torch.Tensor   # [n + 1] int32 where E < 2^31, else int64: row s holds edges offsets[s]:offsets[s + 1]
    col: torch.Tensor       # [E] int32: each edge's row of x
    scale: torch.Tensor     # [E] float32: each edge's coefficient
    long_ids: torch.Tensor  # int64: the rows of more than long_at edges, longest first
    long_at: int
    tiles: torch.Tensor     # [T, 4] int64: (first row, end row, first edge, end edge) of each tile of short rows
    tile_edges: int         # the most edges of any tile

    @property
    def n(self) -> int:
        return self.offsets.numel() - 1


def tile_plan(offsets: np.ndarray, long_at: int, max_edges: int = TILE_EDGES,
              max_rows: int = TILE_ROWS) -> np.ndarray:
    """``[T, 4]`` int64 tiles of the rows of at most ``long_at`` edges, in
    row order: each a run of consecutive such rows, as many as fit in
    ``max_edges`` edges and ``max_rows`` rows, cut at every longer row
    (which no tile holds), as (first row, end row, first edge, end edge)."""
    if long_at > max_edges:
        raise ValueError(f"a short row of {long_at} edges would not fit a tile of {max_edges}")
    offsets = np.asarray(offsets, dtype=np.int64)
    n = offsets.size - 1
    long_rows = np.flatnonzero(np.diff(offsets) > long_at)
    tiles = []
    r, li = 0, 0
    while r < n:
        if li < long_rows.size and long_rows[li] == r:
            r, li = r + 1, li + 1
            continue
        stop = min(long_rows[li] if li < long_rows.size else n, r + max_rows)
        fits = int(np.searchsorted(offsets, offsets[r] + max_edges, side="right")) - 1
        end = min(fits, stop)
        tiles.append((r, end, offsets[r], offsets[end]))
        r = end
    return np.array(tiles, dtype=np.int64).reshape(-1, 4)


def csr_matrix(ids: torch.Tensor, col: torch.Tensor, scale: torch.Tensor, n: int) -> CsrMatrix:
    """The ``n``-row CSR matrix of the edges ``(ids[e], col[e], scale[e])``
    whose rows ``ids`` ascend (rows past the last id stay empty), where the
    tensors lie: offsets by ``bincount`` and ``cumsum``, the rows of more
    than :data:`LONG_SEGMENT` edges, longest first, ties by ascending row
    (the kernel gives them its first blocks), and the other rows' tiles
    (:func:`tile_plan`, planned on the host: building the matrix waits for
    the device once)."""
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
    plan = tile_plan(offsets.cpu().numpy(), LONG_SEGMENT, TILE_EDGES, TILE_ROWS)
    tile_edges = int((plan[:, 3] - plan[:, 2]).max()) if plan.size else 0
    if ids.numel() < 2 ** 31:
        offsets = offsets.to(torch.int32)
    return CsrMatrix(ids, offsets, col, scale, long_ids, LONG_SEGMENT, torch.as_tensor(plan, device=ids.device),
                     max(tile_edges, 1))


def segment_spmm(x: torch.Tensor, a: CsrMatrix) -> torch.Tensor:
    """``out[s] = Σ a.scale[e] · x[a.col[e]]`` over row ``s``'s edges →
    ``[a.n, F]`` for ``x [N, F]``. The kernel does not check that ``a.col``
    lies in ``[0, N)``."""
    if _plain(x):
        return segment_spmm_ref(x, a.col, a.scale, a.ids, a.n)
    return _kernel_call(x.contiguous(), a, "none")


def segment_spmm_secondary(x: torch.Tensor, a: CsrMatrix, l: torch.Tensor, degc: torch.Tensor,
                           parts: torch.Tensor, member: float,
                           live: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """DiDiC's secondary step on ``x = l / b`` (``x``, ``l`` ``[n, k]``,
    ``degc`` ``[n]``, ``parts`` int32 ``[n]``, ``live`` bool ``[n]`` or None):
    ``l' = l − degc·x + A @ x`` and the next step's ``l' / b``, where ``b``
    is ``member`` at a live row's own part and 1 elsewhere."""
    if _plain(x):
        return secondary_ref(x, a.col, a.scale, a.ids, l, degc, parts, member, live)
    return _kernel_call(x.contiguous(), a, "secondary", l=l, d=degc, parts=parts, live=live, member=member)


def segment_spmm_primary(x: torch.Tensor, a: CsrMatrix, l: torch.Tensor, degc: torch.Tensor) -> torch.Tensor:
    """DiDiC's primary step on ``x = w``: ``w + l − degc·w + A @ w``."""
    if _plain(x):
        return primary_ref(x, a.col, a.scale, a.ids, l, degc)
    return _kernel_call(x.contiguous(), a, "primary", l=l, d=degc)


def segment_spmm_smooth(x: torch.Tensor, a: CsrMatrix, safe_deg: torch.Tensor) -> torch.Tensor:
    """One smoothing step: ``0.5·x + 0.5·(A @ x) / safe_deg`` (``safe_deg``
    ``[n]``)."""
    if _plain(x):
        return smooth_ref(x, a.col, a.scale, a.ids, safe_deg)
    return _kernel_call(x.contiguous(), a, "smooth", d=safe_deg)


def _plain(x: torch.Tensor) -> bool:
    if x.device.type in ("cpu", "meta"):
        return True
    if x.device.type != "cuda":
        raise ValueError(f"segment_spmm runs on cpu, meta or cuda tensors, got {x.device}")
    return False


@functools.lru_cache(maxsize=None)
def _member32(member: float) -> float:
    """``member`` as the plain version's benefit holds it in float32."""
    return float(benefit_ref(torch.zeros(1, dtype=torch.int32), 1, member)[0, 0])


def _kernel_call(x: torch.Tensor, a: CsrMatrix, epilogue: str, l: Optional[torch.Tensor] = None,
                 d: Optional[torch.Tensor] = None, parts: Optional[torch.Tensor] = None,
                 live: Optional[torch.Tensor] = None, member: float = 1.0):
    """One launch of ``csrc/segment_spmm.cu``, counted under the route
    ``epilogue``; the matrix's tensors were checked when it was built, so
    only ``x`` and the epilogue's operands are checked here (the stream is
    read raw, as ``segment_sum`` reads it)."""
    dev = x.device
    check_cuda_tensor(x, "x", (torch.float32,), 2, a.offsets.device)
    n, f = a.n, x.shape[1]
    if epilogue != "none" and x.shape[0] != n:
        raise ValueError(f"an epilogue needs x with the matrix's {n} rows, got {x.shape[0]}")
    if l is not None:
        l = l.contiguous()
        check_cuda_tensor(l, "l", (torch.float32,), 2, dev)
        if l.shape != x.shape:
            raise ValueError(f"l has shape {tuple(l.shape)}, x {tuple(x.shape)}")
    for t, name, dtype in ((d, "d", torch.float32), (parts, "parts", torch.int32), (live, "live", torch.bool)):
        if t is not None:
            check_cuda_tensor(t, name, (dtype,), 1, dev)
            if t.shape[0] != n:
                raise ValueError(f"{name} has {t.shape[0]} rows, the matrix {n}")
    out = torch.empty((n, f), dtype=torch.float32, device=dev)
    out2 = torch.empty_like(out) if epilogue == "secondary" else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    KERNEL.launch(x.data_ptr(), a.col.data_ptr(), a.scale.data_ptr(), a.offsets.data_ptr(),
                  int(a.offsets.dtype == torch.int32), a.long_ids.data_ptr(), a.long_ids.numel(), a.long_at,
                  a.tiles.data_ptr(), a.tiles.shape[0], a.tile_edges, out.data_ptr(), n, f, EPILOGUES[epilogue],
                  _member32(member), ptr(l), ptr(d), ptr(parts), ptr(live), ptr(out2),
                  torch._C._cuda_getCurrentRawStream(dev.index), route=epilogue)
    return out if out2 is None else (out, out2)
