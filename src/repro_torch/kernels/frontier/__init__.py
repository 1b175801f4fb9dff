from repro_torch.kernels.frontier.ops import (
    KERNEL, frontier_gather, frontier_relax, make_frontier_gather, spill_tail,
)
from repro_torch.kernels.frontier.ref import SpillTail, frontier_gather_ref

__all__ = [
    "KERNEL", "SpillTail", "frontier_gather", "frontier_gather_ref", "frontier_relax",
    "make_frontier_gather", "spill_tail",
]
