"""The paper's partitioning-framework abstractions (§3.1, Fig. 3.1).

Twin of ``repro.core.framework`` on one device. Four components compose
the runtime:

* :class:`InsertPartitioner`  — allocates entities to partitions at write
  time (random / fewest-vertices / least-traffic, §6.4),
* :class:`RuntimeLogger`      — per-partition ``InstanceInfo`` metrics
  (vertices, edges, local vs global traffic — §5.2),
* :class:`RuntimePartitioner` — DiDiC, initial and maintenance passes,
* :class:`MigrationScheduler` — decides when a maintained map is adopted
  and turns it into migration commands.

:class:`PartitionedGraphService` is one logical graph plus a placement,
serving the thesis emulator's measurements and the dynamic experiments'
cycle: apply dynamism (moves, and for the Insert workload new vertices and
edges), maintain with DiDiC through the Migration-Scheduler, replay.

The service holds a :class:`~repro_torch.core.placement.Placement`: the
owner array (``parts``) plus a fixed-capacity exception table of hot
vertices replicated read-only on every partition
(``exception_capacity=``, 0 by default). Reads of a replicated vertex are
local to the reader; writes (moves, inserts, migrations) resolve the owner
and invalidate the vertex's replicas; maintenance pins the hot vertices;
:meth:`PartitionedGraphService.refresh_placement` re-selects the table from
the logger's per-vertex traffic, with hysteresis.

The mesh engines, the fault plan, the write-ahead journal, retries and
degraded mode come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import metrics
from repro_torch.core.didic import DidicConfig, DidicState, didic_partition, didic_refine
from repro_torch.core.dynamism import DynamismLog, apply_dynamism, generate_dynamism
from repro_torch.core.partitioners import select_hot_vertices
from repro_torch.core.placement import Placement
from repro_torch.core.traffic import OpLog, TrafficResult, execute_ops, generate_ops
from repro_torch.graphs.structure import Graph

__all__ = [
    "InstanceInfo",
    "InsertPartitioner",
    "RuntimeLogger",
    "RuntimePartitioner",
    "MigrationCommand",
    "MigrationScheduler",
    "PartitionedGraphService",
]


@dataclasses.dataclass
class InstanceInfo:
    """Per-partition runtime metrics (paper §5.2)."""

    n_vertices: int = 0
    n_edges: int = 0
    local_traffic: int = 0
    global_traffic: int = 0


class InsertPartitioner:
    """Insert-Partitioning component: allocate new entities to partitions.

    Each ``allocate`` draws from a fresh child spawned off one
    :class:`np.random.SeedSequence`, as in the JAX package: the i-th call of
    two partitioners built with the same seed is identical, and streams of
    different seeds never collide. ``engine="device"`` asks for the JAX
    package's mesh scan, which :func:`generate_dynamism` refuses for the
    sequential methods until the multi-device slice.
    """

    def __init__(self, method: str = "random", k: int = 4, seed: int = 0,
                 engine: str = "host"):
        self.method = method
        self.k = k
        self.engine = engine
        self._seeds = np.random.SeedSequence(seed)

    def allocate(
        self,
        parts: np.ndarray,
        amount: float,
        vertex_traffic: Optional[np.ndarray] = None,
        insert_rate: float = 0.0,
        graph: Optional[Graph] = None,
    ) -> DynamismLog:
        """Allocate one dynamism slice; ``insert_rate`` of the units
        allocate new vertices (with edges drawn on ``graph``, required then)
        instead of moving existing ones — the paper's Insert workload."""
        (stream,) = self._seeds.spawn(1)
        return generate_dynamism(
            parts, amount, self.method, self.k,
            vertex_traffic=vertex_traffic, seed=stream, engine=self.engine,
            insert_rate=insert_rate, graph=graph,
        )

    def rng_state(self) -> Tuple:
        """The SeedSequence's position ``(entropy, spawn_key,
        n_children_spawned)``; restoring it reproduces the remaining
        ``allocate`` stream exactly."""
        ss = self._seeds
        return (ss.entropy, tuple(int(x) for x in ss.spawn_key),
                int(ss.n_children_spawned))

    def set_rng_state(self, state: Tuple) -> None:
        entropy, spawn_key, n_spawned = state
        self._seeds = np.random.SeedSequence(
            entropy, spawn_key=tuple(int(x) for x in spawn_key),
            n_children_spawned=int(n_spawned),
        )

    def advance(self, n: int = 1) -> None:
        """Discard ``n`` allocation draws (a log given from elsewhere stands
        in for this partitioner's draw, and later draws stay aligned)."""
        self._seeds.spawn(int(n))


class RuntimeLogger:
    """Runtime-Logging component: accumulates InstanceInfo per partition."""

    def __init__(self, k: int):
        self.k = k
        self.reset()

    def reset(self) -> None:
        self.infos: List[InstanceInfo] = [InstanceInfo() for _ in range(self.k)]
        self._last_percent_global = 0.0
        # Accumulated per-vertex served traffic, the hot-vertex selection
        # signal. Growable: observations from a grown graph extend it.
        self.vertex_traffic = np.zeros(0, dtype=np.int64)

    def observe_structure(self, graph: Graph, parts: np.ndarray) -> None:
        counts = metrics.partition_counts(graph, parts, self.k)
        for i in range(self.k):
            self.infos[i].n_vertices = int(counts["vertices"][i])
            self.infos[i].n_edges = int(counts["edges"][i])

    def observe_traffic(self, result: TrafficResult) -> None:
        """Attribute served traffic per partition, split local vs global
        (§5.2): global actions are apportioned by each partition's served
        share with largest remainders, so ``local + global == served`` per
        partition and the global attribution sums to the measured total."""
        total = int(result.per_op_total.sum())
        global_total = int(result.per_op_global.sum())
        served = np.asarray(result.per_partition, dtype=np.int64)[: self.k]
        if total > 0 and global_total > 0:
            quota_num = global_total * served
            g = quota_num // total
            rem = quota_num - g * total
            short = global_total - int(g.sum())
            if short > 0:
                # Largest fractional remainder first; ties break on the
                # lowest partition index (stable sort of -rem).
                order = np.argsort(-rem, kind="stable")
                g[order[:short]] += 1
        else:
            g = np.zeros(self.k, dtype=np.int64)
        for i in range(self.k):
            self.infos[i].global_traffic += int(g[i])
            self.infos[i].local_traffic += int(served[i]) - int(g[i])
        pv = np.asarray(result.per_vertex, dtype=np.int64)
        if pv.shape[0] > self.vertex_traffic.shape[0]:
            self.vertex_traffic = np.concatenate([
                self.vertex_traffic,
                np.zeros(pv.shape[0] - self.vertex_traffic.shape[0], np.int64),
            ])
        self.vertex_traffic[: pv.shape[0]] += pv
        self._last_percent_global = result.percent_global

    def percent_global(self) -> float:
        return self._last_percent_global

    def load_balance_cv(self) -> Dict[str, float]:
        return {
            "vertices": metrics.coefficient_of_variation(
                np.array([i.n_vertices for i in self.infos])
            ),
            "edges": metrics.coefficient_of_variation(np.array([i.n_edges for i in self.infos])),
            # Balance is judged on *served* traffic — local and global
            # attribution together.
            "traffic": metrics.coefficient_of_variation(
                np.array([i.local_traffic + i.global_traffic for i in self.infos])
            ),
        }


class RuntimePartitioner:
    """Runtime-Partitioning component: DiDiC's initial partitioning and its
    maintenance passes on ``device``, with the diffusion state carried from
    one pass to the next."""

    def __init__(self, config: DidicConfig, device=None):
        self.config = config
        self.device = device
        self.state: Optional[DidicState] = None

    def initial(self, graph: Graph, seed: int = 0) -> np.ndarray:
        parts, self.state = didic_partition(graph, self.config, seed=seed, device=self.device)
        return parts

    def maintain(self, graph: Graph, parts: np.ndarray, iterations: int = 1,
                 pinned: Optional[np.ndarray] = None) -> np.ndarray:
        """One maintenance refinement; ``pinned`` vertices (the placement's
        exception table) keep their assignment."""
        parts, self.state = didic_refine(
            graph, parts, self.config, state=self.state, iterations=iterations,
            pinned=pinned, device=self.device,
        )
        return parts


@dataclasses.dataclass
class MigrationCommand:
    vertices: np.ndarray
    target: int


class MigrationScheduler:
    """Migration-Scheduler component.

    Decides when the map produced by runtime partitioning is applied:
    migrate when the share of vertices wanting to move exceeds
    ``min_move_fraction`` and the global-traffic share has degraded
    ``degradation_factor``× over the post-maintenance baseline (the paper's
    Dynamic experiment migrates on a fixed interval instead). The baseline
    moves only where it is set: the first measurement establishes it and
    :meth:`record_maintenance` resets it.
    """

    def __init__(self, min_move_fraction: float = 0.002, degradation_factor: float = 1.25):
        self.min_move_fraction = min_move_fraction
        self.degradation_factor = degradation_factor
        self.baseline_percent_global = np.inf
        self.history: List[Dict] = []

    def should_migrate(self, percent_global: float) -> bool:
        if not np.isfinite(self.baseline_percent_global):
            # First measurement: nothing to compare against yet.
            self.baseline_percent_global = float(percent_global)
            return False
        return percent_global > self.baseline_percent_global * self.degradation_factor

    def record_maintenance(self, percent_global: float) -> None:
        """Reset the degradation baseline to a post-maintenance measurement."""
        self.baseline_percent_global = float(percent_global)

    def plan(
        self, old_parts: np.ndarray, new_parts: np.ndarray, step: int = 0
    ) -> List[MigrationCommand]:
        """Group the map's delta into per-target migration commands, with
        history keyed by the caller's logical ``step``."""
        moved = np.nonzero(old_parts != new_parts)[0]
        if moved.shape[0] < self.min_move_fraction * old_parts.shape[0]:
            return []
        tgt = np.asarray(new_parts)[moved]
        order = np.argsort(tgt, kind="stable")
        uniq, starts = np.unique(tgt[order], return_index=True)
        cmds = [
            MigrationCommand(vertices=vs, target=int(t))
            for t, vs in zip(uniq, np.split(moved[order], starts[1:]))
        ]
        self.history.append({"step": int(step), "n_moved": int(moved.shape[0])})
        return cmds

    @staticmethod
    def apply(parts: np.ndarray, cmds: List[MigrationCommand]) -> np.ndarray:
        out = parts.copy()
        for c in cmds:
            out[c.vertices] = c.target
        return out


class PartitionedGraphService:
    """Emulator-style partitioned graph database (paper §5.3.2): drives the
    Static, Insert, Stress and Dynamic experiments on one device. Replays
    and DiDiC run on ``device`` (``None`` means CUDA)."""

    def __init__(
        self,
        graph: Graph,
        k: int,
        didic: Optional[DidicConfig] = None,
        *,
        device=None,
        exception_capacity: int = 0,
    ):
        self.device = resolve_device(device)
        self.graph = graph
        self.k = k
        self.placement = Placement(
            owner=np.zeros(graph.n_nodes, dtype=np.int32),
            capacity=int(exception_capacity),
        )
        self.logger = RuntimeLogger(k)
        self.runtime = RuntimePartitioner(didic or DidicConfig(k=k), device=self.device)
        self.scheduler = MigrationScheduler()

    @property
    def engine(self) -> str:
        """Which engine family serves this service: ``host`` (no mesh)."""
        return "host"

    @property
    def parts(self) -> np.ndarray:
        """The owner array of the service placement."""
        return self.placement.owner

    @parts.setter
    def parts(self, value: np.ndarray) -> None:
        self.placement.replace_owner(np.asarray(value))

    def refresh_placement(self, hysteresis: float = 1.25) -> np.ndarray:
        """Re-select the exception table from the accumulated per-vertex
        traffic (promotion with hysteresis, see
        :func:`~repro_torch.core.partitioners.select_hot_vertices`) and
        return the new hot vertices. No-op at capacity 0."""
        if self.placement.capacity == 0:
            return self.placement.hot_vertices()
        hot = select_hot_vertices(
            self.logger.vertex_traffic, self.placement.capacity,
            current_hot=self.placement.hot_vertices(), hysteresis=hysteresis,
        )
        self.placement.set_hot(hot)
        return self.placement.hot_vertices()

    def partition_with(self, parts: np.ndarray) -> "PartitionedGraphService":
        if parts.shape[0] != self.graph.n_nodes:
            raise ValueError(f"parts has {parts.shape[0]} entries, the graph {self.graph.n_nodes} vertices")
        self.parts = parts.astype(np.int32)
        self.logger.observe_structure(self.graph, self.parts)
        return self

    def partition_didic(self, seed: int = 0) -> "PartitionedGraphService":
        return self.partition_with(self.runtime.initial(self.graph, seed=seed))

    def maintain(self, iterations: int = 1) -> None:
        self.parts = self.runtime.maintain(self.graph, self.parts, iterations=iterations,
                                           pinned=self.placement.hot_vertices())
        self.logger.observe_structure(self.graph, self.parts)

    def propose_maintenance(self, iterations: int = 1) -> np.ndarray:
        """Run a maintenance refinement from the served map and return the
        proposed map without adopting it. Advances ``runtime.state``; a
        caller that may discard the proposal keeps the state from before
        and hands it to :meth:`commit_migration`."""
        return self.runtime.maintain(self.graph, self.parts, iterations=iterations,
                                     pinned=self.placement.hot_vertices())

    def commit_migration(self, scheduler: MigrationScheduler,
                         new_parts: np.ndarray, step: int,
                         prev_state=None) -> int:
        """Adopt a proposed map through the Migration-Scheduler; returns the
        number of migrated vertices. If the scheduler rejects a non-trivial
        plan, the diffusion state rolls back to ``prev_state``, so later
        maintenance never diffuses from a map the service did not serve."""
        cmds = scheduler.plan(self.parts, new_parts.astype(np.int32), step=step)
        if not cmds and (self.parts != new_parts).any():
            self.runtime.state = prev_state
            return 0
        self.parts = scheduler.apply(self.parts, cmds)
        if cmds and self.placement.n_hot:
            # A migration is an ownership write: replicas of moved vertices drop.
            self.placement.invalidate(np.concatenate([c.vertices for c in cmds]))
        self.logger.observe_structure(self.graph, self.parts)
        return int(sum(c.vertices.shape[0] for c in cmds))

    def maintain_migrate(self, scheduler: MigrationScheduler, step: int,
                         iterations: int = 1) -> int:
        """Propose then commit in one call: the dynamic experiment's
        stop-the-world maintenance pass."""
        prev_state = self.runtime.state
        new_parts = self.propose_maintenance(iterations=iterations)
        return self.commit_migration(scheduler, new_parts, step, prev_state=prev_state)

    def run_ops(self, ops: OpLog, engine: str = "batched") -> TrafficResult:
        """Replay an evaluation log: ``batched`` (the device engine) or
        ``scalar`` (the host oracle); both give identical counters. Steps
        into the placement's replicated vertices are local reads."""
        result = execute_ops(self.graph, ops, self.parts, self.k, engine=engine,
                             device=self.device,
                             replicated=self.placement.replicated_mask())
        self.logger.observe_traffic(result)
        return result

    def make_ops(self, n_ops: int = 10_000, seed: int = 0, pattern: Optional[str] = None) -> OpLog:
        return generate_ops(self.graph, n_ops=n_ops, seed=seed, pattern=pattern)

    def apply_dynamism(self, log: DynamismLog) -> None:
        """Apply a dynamism slice: partition moves, edge inserts and, for a
        vertex-growth log, new vertices on the partitions the log allocated.

        Atomic: every check (shapes and bounds in the graph rebuild, insert
        admissibility) runs before any state changes, so a rejected log
        leaves ``parts``, ``graph`` and the logger as they were. A
        structural log replaces the graph by a new object (its engines and
        DiDiC products are built afresh on it); growth drops the carried
        diffusion state, which is per-vertex, so the next maintenance pass
        seeds from the grown map. (The JAX package wraps this in its
        write-ahead journal and fault plan, which come with a later slice.)
        """
        if not log.structural:
            self.parts = apply_dynamism(self.parts, log)
            # A move is an ownership write: replicas of moved vertices drop.
            self.placement.invalidate(log.vertices)
            self.logger.observe_structure(self.graph, self.parts)
            return
        # -- validate (no mutation yet) --------------------------------------
        if log.n_new_vertices:
            if log.base_nodes is not None and log.base_nodes != self.graph.n_nodes:
                raise ValueError(
                    f"vertex-growth log grows a base of {log.base_nodes} "
                    f"vertices but the service graph has {self.graph.n_nodes}"
                )
            new_graph = self.graph.with_vertices(
                log.n_new_vertices, log.insert_attrs,
                log.insert_senders, log.insert_receivers, log.insert_weights,
            )
        else:
            new_graph = self.graph.with_edges(
                log.insert_senders, log.insert_receivers, log.insert_weights
            )
        self._check_insert_admissible(log)
        new_parts = apply_dynamism(self.parts, log)
        # -- commit (nothing below may raise) --------------------------------
        self.parts = new_parts
        self.graph = new_graph
        self.placement.invalidate(
            np.concatenate([np.asarray(log.vertices, dtype=np.int64), log.dirty_vertices()])
        )
        if log.n_new_vertices:
            self.runtime.state = None
        self.logger.observe_structure(self.graph, self.parts)

    def _check_insert_admissible(self, log: DynamismLog) -> None:
        """Refuse edge inserts lighter than their straight-line length on a
        coordinate graph: the GIS replay's A* heuristic and its window
        acceptance rely on weights ≥ Euclidean length. New vertices'
        coordinates come from the log's rows, as they will be stored."""
        attrs = self.graph.node_attrs
        if "lon" not in attrs or "lat" not in attrs:
            return
        s = np.asarray(log.insert_senders, dtype=np.int64)
        r = np.asarray(log.insert_receivers, dtype=np.int64)
        w = (np.ones(s.shape[0], dtype=np.float32)
             if log.insert_weights is None
             else np.asarray(log.insert_weights, dtype=np.float32))
        lon = np.asarray(attrs["lon"], dtype=np.float64)
        lat = np.asarray(attrs["lat"], dtype=np.float64)
        if log.n_new_vertices:
            if "lon" not in log.insert_attrs or "lat" not in log.insert_attrs:
                raise ValueError(
                    "vertex growth on a coordinate graph requires lon/lat "
                    "rows in the log's insert_attrs"
                )
            lon = np.concatenate([lon, np.asarray(
                log.insert_attrs["lon"], dtype=attrs["lon"].dtype
            ).astype(np.float64)])
            lat = np.concatenate([lat, np.asarray(
                log.insert_attrs["lat"], dtype=attrs["lat"].dtype
            ).astype(np.float64)])
        dist = np.hypot(lon[s] - lon[r], lat[s] - lat[r])
        # float32 storage may round the weight just under the float64
        # distance; allow that rounding, nothing more.
        short = w.astype(np.float64) < dist * (1.0 - 1e-6)
        if short.any():
            i = int(np.nonzero(short)[0][0])
            raise ValueError(
                "structural insert weight below straight-line length "
                f"(edge {int(s[i])}→{int(r[i])}: w={float(w[i]):g} < "
                f"{float(dist[i]):g}) — inadmissible for the GIS heuristic"
            )

    def report(self) -> Dict[str, float]:
        return metrics.partition_report(self.graph, self.parts, self.k)
