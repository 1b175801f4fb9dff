"""Wrappers of the frontier gather kernel (twin of ``repro.kernels.frontier``).

:func:`frontier_gather` dispatches by the device of ``x``: a CPU tensor goes
to the plain version (:mod:`.ref`), a CUDA tensor to the hand-written
kernel ``csrc/frontier_gather.cu``, which raises if it fails to build or
launch.

Capped layouts put their over-cap edges in a COO spill tail, folded in by a
plain PyTorch epilogue after the gather, as the JAX package folds them in
with an XLA scatter outside its Pallas kernel: ``scatter_reduce_("amin")``
for ``mode="min"`` (exact in any order) and ``index_add_`` for
``mode="sum"``. :func:`frontier_relax` is the GIS replay's relaxation step;
:func:`make_frontier_gather` closes over a host-side
:class:`~repro_torch.graphs.structure.PaddedNeighbors`.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.graphs.structure import PaddedNeighbors
from repro_torch.kernels import CudaKernel, check_cuda_tensor
from repro_torch.kernels.frontier.ref import frontier_gather_ref

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
KERNEL = CudaKernel(
    "frontier_gather", "frontier_gather.cu", [_P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_int, _P],
)
_MODES = {"sum": 0, "min": 1}


def frontier_gather(
    x: torch.Tensor,      # [N, C] float32 vertex-major frontier values
    nbr: torch.Tensor,    # [V, D] int32 in-neighbour ids (0 where padded)
    w: torch.Tensor,      # [V, D] float32: sum → w·mask; min → +inf where padded
    *,
    mode: str = "sum",
) -> torch.Tensor:
    """Gather-reduce neighbour rows of ``x`` (see :mod:`.ref`)."""
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if x.device.type == "cpu":
        return frontier_gather_ref(x, nbr, w, mode=mode)
    if x.device.type != "cuda":
        raise ValueError(f"frontier_gather runs on cpu or cuda tensors, got {x.device}")
    check_cuda_tensor(x, "x", (torch.float32,), 2, x.device)
    check_cuda_tensor(nbr, "nbr", (torch.int32,), 2, x.device)
    check_cuda_tensor(w, "w", (torch.float32,), 2, x.device)
    if w.shape != nbr.shape:
        raise ValueError(f"w {tuple(w.shape)} and nbr {tuple(nbr.shape)} differ")
    v, d = nbr.shape
    c = x.shape[1]
    out = torch.empty((v, c), dtype=torch.float32, device=x.device)
    KERNEL.launch(
        x.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr(),
        v, d, c, _MODES[mode], torch.cuda.current_stream(x.device).cuda_stream,
    )
    return out


def spill_epilogue(out, x, spill_s, spill_r, spill_w, mode: str) -> torch.Tensor:
    """Fold the COO spill tail into a gathered result, in place.

    ``spill_s``/``spill_r`` are int64. Padded spill entries carry ``w = +inf``
    (the min identity) for ``min`` and must carry ``w = 0`` for ``sum``.
    """
    if spill_s.shape[0] == 0:
        return out
    rows = x[spill_s]  # [S, C]
    if mode == "sum":
        return out.index_add_(0, spill_r, spill_w[:, None] * rows)
    if mode == "min":
        idx = spill_r[:, None].expand(-1, x.shape[1])
        return out.scatter_reduce_(0, idx, rows + spill_w[:, None], "amin", include_self=True)
    raise ValueError(f"unknown mode {mode!r}")


def frontier_relax(
    x: torch.Tensor,        # [N, C] vertex-major frontier values
    nbr: torch.Tensor,      # [V, D] int32 in-neighbour ids (0 where padded)
    w_inf: torch.Tensor,    # [V, D] float32 weights, +inf where padded
    spill_s: torch.Tensor,  # [S] int64 senders of over-cap edges
    spill_r: torch.Tensor,  # [S] int64 receivers of over-cap edges
    spill_w: torch.Tensor,  # [S] float32 weights, +inf where padded
) -> torch.Tensor:
    """One min-plus relaxation over a capped gather layout + spill tail.

    ``out[v, c] = min( min_j x[nbr[v,j], c] + w_inf[v,j],
                       min over spill edges u→v of x[u, c] + w )``

    On a CUDA tensor the rectangular slots always go through the kernel.
    """
    acc = frontier_gather(x, nbr, w_inf, mode="min")
    return spill_epilogue(acc, x, spill_s, spill_r, spill_w, mode="min")


def make_frontier_gather(
    pn: PaddedNeighbors, mode: str = "sum", device=None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return ``x [N, C] -> out [N, C]`` over ``pn`` on ``device``.

    Capped layouts (``pn.n_spill > 0``) fold their spill tail in with
    :func:`spill_epilogue`.
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
    spill_s = torch.as_tensor(pn.spill_s, dtype=torch.int64, device=dev)
    spill_r = torch.as_tensor(pn.spill_r, dtype=torch.int64, device=dev)
    spill_w = torch.as_tensor(pn.spill_w, dtype=torch.float32, device=dev)

    def gather(x: torch.Tensor) -> torch.Tensor:
        out = frontier_gather(x, nbr, w, mode=mode)
        return spill_epilogue(out, x, spill_s, spill_r, spill_w, mode)

    return gather
