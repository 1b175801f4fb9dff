"""Ownership placement: the owner array plus an exception table.

Twin of ``repro.core.placement`` for the static slice. ``owner[v]`` is the
single home partition of ``v`` (the paper's ``parts`` array). The JAX
package adds a fixed-capacity table of hot vertices replicated read-only on
every partition; this slice holds that table at capacity 0, which the JAX
package defines to be bit-identical to the bare owner array on all four
traffic counters, so no engine here routes through replicas. Promotion,
eviction and invalidation come with a later slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Placement"]


@dataclasses.dataclass
class Placement:
    """Owner array + an exception table of capacity 0."""

    owner: np.ndarray
    capacity: int = 0

    def __post_init__(self) -> None:
        self.owner = np.asarray(self.owner, dtype=np.int32)
        if int(self.capacity) != 0:
            raise ValueError("this slice supports an exception table of capacity 0 only")
        self.hot = np.zeros(0, dtype=np.int64)  # live entries: none

    def replace_owner(self, owner: np.ndarray) -> None:
        """Swap in a new owner array (repartition)."""
        self.owner = np.asarray(owner, dtype=np.int32)
