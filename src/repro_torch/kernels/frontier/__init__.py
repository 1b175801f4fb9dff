from repro_torch.kernels.frontier.ops import (
    KERNEL, frontier_gather, frontier_relax, make_frontier_gather, spill_epilogue,
)
from repro_torch.kernels.frontier.ref import frontier_gather_ref

__all__ = [
    "KERNEL", "frontier_gather", "frontier_gather_ref", "frontier_relax",
    "make_frontier_gather", "spill_epilogue",
]
