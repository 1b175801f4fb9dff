"""PyTorch/CUDA port of the partitioned-graph-database system.

Twin of the JAX package ``repro``, module for module: ``graphs`` (the
paper's three datasets and their layouts), ``core`` (partitioners, DiDiC,
the traffic replay, metrics, the service facade), ``kernels`` (the
hand-written CUDA kernels that replace the JAX package's Pallas kernels),
the serving paths of DIN and the LM (dense and MoE), and the training of
those and of the GNNs and MACE: ``data``, ``models``, ``configs``,
``serving``, ``train``, ``optim``, ``launch`` (with the meshes over a
``torch.distributed`` process group) and ``distributed`` (the sharded
replay's counters, placement, the halo exchange, MoE expert placement, the
sharding rules). It
imports PyTorch and numpy, never JAX and never ``repro``.

Every entry point takes ``device=None``, which means CUDA;
:func:`resolve_device` raises when CUDA is asked for and absent, so a run
never falls back to the CPU unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; raise if CUDA is asked for and not available.
    ``meta`` (shapes only, no storage) passes too, for
    :func:`repro_torch.models.transformer.init_abstract`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
