"""Ownership + read-replica placement with a hot-vertex exception table.

Twin of ``repro.core.placement``. The paper's placement is a single
assignment ``parts[v] -> partition``; Twitter-style skew breaks it (§6.5),
because every friend-of-a-friend traversal pushes load to a celebrity
vertex's owner wherever DiDiC puts it. So placement is split into:

* an **owner array**, the single writable home of every vertex (the old
  ``parts`` array): moves, inserts and migrations always resolve the owner;
* a fixed-capacity **exception table** of hot vertices replicated
  read-only on every partition. A traversal step ``u -> v`` with ``v`` in
  the table is served from the replica at ``owner(u)``: it counts no
  cross-partition traffic, and its ``t_pg`` books to the reading
  partition. The table is sorted and padded to ``capacity`` with ``-1``.

**Invalidation.** A write to a replicated vertex evicts it from the table
(:meth:`Placement.invalidate`) and bumps ``replica_epoch``, the token that
names the replica generation.

An empty table is ``replicated_mask() is None``, and every consumer (the
scalar oracle, the batched engine, DiDiC pinning) then takes its plain
path, so capacity 0 is the bare ``parts`` array on all four counters.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

__all__ = ["Placement"]


@dataclasses.dataclass
class Placement:
    """Owner array + fixed-capacity hot-vertex exception table.

    ``owner[v]`` is the writable home partition of ``v`` (the old
    ``parts`` array, same dtype/shape contract). ``hot`` is an
    ``int64[capacity]`` table of replicated vertex ids, ``-1``-padded to
    its static capacity; ``replica_epoch`` increments on every change to
    the table (promotion, eviction, invalidation) so downstream caches
    and serving epochs can key on the replica generation.
    """

    owner: np.ndarray
    capacity: int = 0
    hot: Optional[np.ndarray] = None
    replica_epoch: int = 0

    def __post_init__(self) -> None:
        self.owner = np.asarray(self.owner, dtype=np.int32)
        self.capacity = int(self.capacity)
        if self.capacity < 0:
            raise ValueError(f"exception-table capacity must be >= 0, got {self.capacity}")
        if self.hot is None:
            self.hot = np.full(self.capacity, -1, dtype=np.int64)
        else:
            self.hot = np.asarray(self.hot, dtype=np.int64)
            if self.hot.shape != (self.capacity,):
                raise ValueError(
                    f"hot table has shape {self.hot.shape}, want ({self.capacity},)"
                )

    # ------------------------------------------------------------ queries
    @property
    def n_nodes(self) -> int:
        return int(self.owner.shape[0])

    def hot_vertices(self) -> np.ndarray:
        """Live (non-sentinel) entries of the exception table, sorted."""
        live = self.hot[self.hot >= 0]
        return np.sort(live)

    @property
    def n_hot(self) -> int:
        return int((self.hot >= 0).sum())

    def replicated_mask(self) -> Optional[np.ndarray]:
        """bool[N] mask of replicated vertices, or ``None`` when empty.

        ``None`` is the contract for "no exceptions": every engine takes
        its pre-refactor fast path, keeping capacity-0 placements
        bit-identical to a bare ``parts`` array.
        """
        live = self.hot[self.hot >= 0]
        if live.size == 0:
            return None
        mask = np.zeros(self.n_nodes, dtype=bool)
        mask[live[live < self.n_nodes]] = True
        return mask

    def is_replicated(self, v: int) -> bool:
        return bool((self.hot == int(v)).any())

    # ---------------------------------------------------------- mutation
    def replace_owner(self, owner: np.ndarray) -> None:
        """Swap in a new owner array (repartition, growth, or restore).

        The exception table survives — hot ids are vertex ids, which
        stay valid across repartitions and growth (growth only appends).
        Entries beyond the new vertex count (a restore to a smaller
        graph) are evicted.
        """
        owner = np.asarray(owner, dtype=np.int32)
        n = int(owner.shape[0])
        stale = (self.hot >= 0) & (self.hot >= n)
        if stale.any():
            self.hot = np.where(stale, np.int64(-1), self.hot)
            self.replica_epoch += 1
        self.owner = owner

    def set_hot(self, vertices: np.ndarray) -> None:
        """Replace the exception table with ``vertices`` (<= capacity).

        The table is stored sorted-ascending then ``-1``-padded, so two
        placements with the same hot *set* serialize identically.
        Bumps ``replica_epoch`` only on an actual change.
        """
        vertices = np.unique(np.asarray(vertices, dtype=np.int64))
        vertices = vertices[vertices >= 0]
        if vertices.shape[0] > self.capacity:
            raise ValueError(
                f"{vertices.shape[0]} hot vertices exceed table capacity "
                f"{self.capacity}"
            )
        table = np.full(self.capacity, -1, dtype=np.int64)
        table[: vertices.shape[0]] = vertices
        if not np.array_equal(table, self.hot):
            self.hot = table
            self.replica_epoch += 1

    def invalidate(self, vertices: np.ndarray) -> int:
        """Evict replicas of ``vertices`` (a write is routing through
        ownership and the read-only copies are now stale).

        Returns the number of replicas dropped; bumps ``replica_epoch``
        when any were. No-op (and no epoch bump) for vertices not in the
        table — the common all-writes-are-cold case stays free.
        """
        vertices = np.asarray(vertices, dtype=np.int64)
        if self.n_hot == 0 or vertices.size == 0:
            return 0
        drop = (self.hot >= 0) & np.isin(self.hot, vertices)
        n = int(drop.sum())
        if n:
            kept = self.hot[~drop & (self.hot >= 0)]
            table = np.full(self.capacity, -1, dtype=np.int64)
            table[: kept.shape[0]] = np.sort(kept)
            self.hot = table
            self.replica_epoch += 1
        return n

    # ------------------------------------------------------ serialization
    def to_meta(self) -> Dict:
        return {"capacity": self.capacity, "replica_epoch": int(self.replica_epoch)}

    @classmethod
    def from_parts(cls, parts: np.ndarray, capacity: int = 0) -> "Placement":
        return cls(owner=np.asarray(parts, dtype=np.int32), capacity=int(capacity))

    def copy(self) -> "Placement":
        return Placement(
            owner=self.owner.copy(), capacity=self.capacity,
            hot=self.hot.copy(), replica_epoch=self.replica_epoch,
        )
