"""Wrappers of the frontier gather kernel (twin of ``repro.kernels.frontier``).

:func:`frontier_gather` dispatches by the device of ``x``: a CPU tensor goes
to the plain version (:mod:`.ref`), a CUDA tensor to the hand-written
kernel ``csrc/frontier_gather.cu``, which raises if it fails to build or
launch.

Capped layouts put their over-cap edges in a spill tail. The JAX package
folds its COO tail in with an XLA scatter after its Pallas kernel; here
:func:`spill_tail` packs it once per layout by receiver (a
:class:`SpillTail`, CSR) and the kernel reads each row's tail after its
padded slots. The plain version folds the same tail in with
``scatter_reduce_("amin")`` for ``mode="min"`` (exact in any order) and
``index_add_`` for ``mode="sum"``. :func:`frontier_relax` is the GIS
replay's relaxation step; :func:`make_frontier_gather` closes over a
host-side :class:`~repro_torch.graphs.structure.PaddedNeighbors`.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.graphs.structure import PaddedNeighbors
from repro_torch.kernels import CudaKernel, check_cuda_tensor
from repro_torch.kernels.frontier.ref import SpillTail, frontier_gather_ref

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
KERNEL = CudaKernel(
    "frontier_gather", "frontier_gather.cu",
    [_P, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_int, _P],
)
_MODES = {"sum": 0, "min": 1}


def spill_tail(spill_s, spill_r, spill_w, n_rows: int, device) -> Optional[SpillTail]:
    """Pack a COO spill tail (host arrays) by receiver into a
    :class:`SpillTail` on ``device``; ``None`` when it is empty. Entries of
    one receiver keep their order."""
    spill_r = np.asarray(spill_r, dtype=np.int64)
    if spill_r.shape[0] == 0:
        return None
    spill_s = np.asarray(spill_s, dtype=np.int32)
    spill_w = np.asarray(spill_w, dtype=np.float32)
    if np.any(spill_r[1:] < spill_r[:-1]):
        by_row = np.argsort(spill_r, kind="stable")
        spill_s, spill_r, spill_w = spill_s[by_row], spill_r[by_row], spill_w[by_row]
    counts = np.bincount(spill_r, minlength=n_rows)
    ptr = np.zeros(n_rows + 1, dtype=np.int32)
    np.cumsum(counts, out=ptr[1:])
    rows = np.flatnonzero(counts).astype(np.int32)
    return SpillTail(*(torch.as_tensor(a, device=device) for a in (ptr, spill_s, spill_w, rows)))


def frontier_gather(
    x: torch.Tensor,      # [N, C] float32 vertex-major frontier values
    nbr: torch.Tensor,    # [V, D] int32 in-neighbour ids (0 where padded)
    w: torch.Tensor,      # [V, D] float32: sum → w·mask; min → +inf where padded
    *,
    mode: str = "sum",
    order: Optional[torch.Tensor] = None,  # [V] int32, a permutation of the rows
    tail: Optional[SpillTail] = None,      # each row's over-cap slots
) -> torch.Tensor:
    """Gather-reduce neighbour rows of ``x`` and of the spill ``tail`` (see
    :mod:`.ref`).

    ``order`` is the kernel's row schedule: blocks take the rows in that
    order, and each row is still written to its own place, so it changes
    which rows run together and never the result. The caller promises a
    permutation; nothing checks its contents, and the plain version ignores
    it."""
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if x.device.type == "cpu":
        return frontier_gather_ref(x, nbr, w, mode=mode, tail=tail)
    if x.device.type != "cuda":
        raise ValueError(f"frontier_gather runs on cpu or cuda tensors, got {x.device}")
    check_cuda_tensor(x, "x", (torch.float32,), 2, x.device)
    check_cuda_tensor(nbr, "nbr", (torch.int32,), 2, x.device)
    check_cuda_tensor(w, "w", (torch.float32,), 2, x.device)
    if w.shape != nbr.shape:
        raise ValueError(f"w {tuple(w.shape)} and nbr {tuple(nbr.shape)} differ")
    v, d = nbr.shape
    if order is not None:
        check_cuda_tensor(order, "order", (torch.int32,), 1, x.device)
        if order.shape[0] != v:
            raise ValueError(f"order has {order.shape[0]} rows, nbr {v}")
    tail_args = (None, 0, None, None, None)
    if tail is not None:
        for name in ("ptr", "src", "rows"):
            check_cuda_tensor(getattr(tail, name), f"tail.{name}", (torch.int32,), 1, x.device)
        check_cuda_tensor(tail.w, "tail.w", (torch.float32,), 1, x.device)
        if tail.ptr.shape[0] != v + 1 or tail.w.shape != tail.src.shape:
            raise ValueError("tail.ptr must have V + 1 entries and tail.w one per tail.src")
        tail_args = (tail.rows.data_ptr(), tail.rows.shape[0], tail.ptr.data_ptr(),
                     tail.src.data_ptr(), tail.w.data_ptr())
    c = x.shape[1]
    out = torch.empty((v, c), dtype=torch.float32, device=x.device)
    KERNEL.launch(
        x.data_ptr(), nbr.data_ptr(), w.data_ptr(), None if order is None else order.data_ptr(),
        *tail_args, out.data_ptr(), v, d, c, _MODES[mode],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return out


def frontier_relax(
    x: torch.Tensor,                       # [N, C] vertex-major frontier values
    nbr: torch.Tensor,                     # [V, D] int32 in-neighbour ids (0 where padded)
    w_inf: torch.Tensor,                   # [V, D] float32 weights, +inf where padded
    tail: Optional[SpillTail],             # over-cap edges by receiver (weights +inf where padded)
    order: Optional[torch.Tensor] = None,  # [V] int32 row schedule (see frontier_gather)
) -> torch.Tensor:
    """One min-plus relaxation over a capped gather layout + spill tail.

    ``out[v, c] = min( min_j x[nbr[v,j], c] + w_inf[v,j],
                       min over spill edges u→v of x[u, c] + w )``

    On a CUDA tensor every slot, the tail's too, goes through the kernel.
    """
    return frontier_gather(x, nbr, w_inf, mode="min", order=order, tail=tail)


def make_frontier_gather(
    pn: PaddedNeighbors, mode: str = "sum", device=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return ``x [N, C] -> out [N, C]`` over ``pn`` on ``device``.

    Capped layouts (``pn.n_spill > 0``) read their spill tail in the same
    call (:func:`spill_tail`).
    """
    dev = resolve_device(device)
    if mode == "sum":
        w_host = pn.w * pn.mask
    elif mode == "min":
        w_host = np.where(pn.mask > 0, pn.w, np.float32(np.inf)).astype(np.float32)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    nbr = torch.as_tensor(pn.nbr, dtype=torch.int32, device=dev)
    w = torch.as_tensor(w_host, dtype=torch.float32, device=dev)
    tail = spill_tail(pn.spill_s, pn.spill_r, pn.spill_w, pn.nbr.shape[0], dev)

    def gather(x: torch.Tensor) -> torch.Tensor:
        return frontier_gather(x, nbr, w, mode=mode, tail=tail)

    return gather
