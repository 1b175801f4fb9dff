"""Ownership placement: the owner array plus an exception table.

Twin of ``repro.core.placement`` at capacity 0. ``owner[v]`` is the single
home partition of ``v`` (the paper's ``parts`` array). The JAX package adds
a fixed-capacity table of hot vertices replicated read-only on every
partition; the port holds that table at capacity 0, which the JAX package
defines to be bit-identical to the bare owner array on all four traffic
counters, so no engine here routes through replicas. The queries and the
invalidation the service's dynamic methods call have their capacity-0
forms: no hot vertex, no replica mask, nothing to invalidate. Promotion and
eviction come with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
            raise ValueError("the port supports an exception table of capacity 0 only")
        self.hot = np.zeros(0, dtype=np.int64)  # live entries: none

    def hot_vertices(self) -> np.ndarray:
        """Live entries of the exception table, sorted: none at capacity 0."""
        return self.hot.copy()

    @property
    def n_hot(self) -> int:
        return 0

    def replicated_mask(self) -> Optional[np.ndarray]:
        """``None``: no vertex is replicated, every engine takes its plain path."""
        return None

    def replace_owner(self, owner: np.ndarray) -> None:
        """Swap in a new owner array (repartition, migration or growth)."""
        self.owner = np.asarray(owner, dtype=np.int32)

    def invalidate(self, vertices: np.ndarray) -> int:
        """Drop the replicas of written ``vertices``; returns how many were
        dropped: none at capacity 0."""
        return 0
