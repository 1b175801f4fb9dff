"""The paper's partitioning-framework abstractions (§3.1, Fig. 3.1).

Twin of ``repro.core.framework`` on one device. Four components compose
the runtime:

* :class:`InsertPartitioner`  — allocates entities to partitions at write
  time (random / fewest-vertices / least-traffic, §6.4),
* :class:`RuntimeLogger`      — per-partition ``InstanceInfo`` metrics
  (vertices, edges, local vs global traffic — §5.2), per-vertex traffic,
  the service-health counters and the online front-end's latency samples,
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

The fault layer is optional and off by default: an attached
:class:`~repro_torch.core.fault.FaultPlan` fires crashes and maintenance
timeouts at named sites, ``retry_policy`` bounds the maintenance retries,
and a :class:`~repro_torch.core.recovery.DynamismJournal` makes
:meth:`PartitionedGraphService.apply_dynamism` a write-ahead, exactly-once
operation per log fingerprint. With none attached the service computes
exactly what it did without them.

**Growth.** A structural log attaches a delta-overlay
:class:`~repro_torch.graphs.structure.GraphStore` to the service's graph
(``ensure_store``, at the default headroom) before it grows it, so every
grown graph of the lineage shares the store's engines, replayers and DiDiC
tables by adoption; a log that would overflow the store fires
``apply:compact`` before the compaction. :meth:`PartitionedGraphService.prepare_growth`
attaches the store and builds those once, ahead of the first growth slice.

**Engine dispatch.** Built with a ``mesh`` (a
:class:`~repro_torch.launch.mesh.ReplayMesh` over a ``torch.distributed``
group, every rank running the same program), ``run_ops`` replays through
:func:`~repro_torch.core.traffic_sharded.replay_sharded` with the log's
resident state, ``maintain`` runs the halo-exchange DiDiC of
:mod:`repro_torch.core.didic_distributed` (unless ``maintenance="shared"``
keeps the single-device DiDiC, bit for bit the meshless service's), and
the insert partitioner draws the sequential policies with the device scan.
A shard marked failed (:meth:`PartitionedGraphService.mark_shard_failed`,
or the fault plan's schedule) degrades the sharded replay to the batched
engine over the whole log, bit-equal and counted in the logger's
``degraded_replays`` and ``degraded_ops``.
"""

from __future__ import annotations

import dataclasses
import time as _time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import metrics
from repro_torch.core.didic import (
    DidicConfig,
    DidicState,
    _overlay_tables_for,
    didic_partition,
    didic_refine,
)
from repro_torch.core.didic_distributed import (
    _capacity_mesh_program,
    didic_partition_distributed,
    didic_refine_distributed,
)
from repro_torch.core.dynamism import DynamismLog, apply_dynamism, generate_dynamism
from repro_torch.core.fault import MaintenanceTimeout, RetryPolicy, SimulatedCrash
from repro_torch.core.partitioners import select_hot_vertices
from repro_torch.core.placement import Placement
from repro_torch.core.traffic import OpLog, TrafficResult, execute_ops, generate_ops, pattern_for
from repro_torch.core.traffic_batched import get_engine
from repro_torch.core.traffic_sharded import migrate_resident_states, replay_sharded
from repro_torch.distributed.counters import data_shard_count
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
    different seeds never collide. ``engine="device"`` draws the sequential
    methods with the device scan on ``device`` (bit-identical targets).
    """

    def __init__(self, method: str = "random", k: int = 4, seed: int = 0,
                 engine: str = "host", device=None):
        self.method = method
        self.k = k
        self.engine = engine
        self.device = device
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
            insert_rate=insert_rate, graph=graph, device=self.device,
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
    """Runtime-Logging component: accumulates InstanceInfo per partition,
    the service-health counters of the fault layer (maintenance retries,
    recoveries) and the online front-end's latency samples (per op class,
    queue wait and service time in ticks of the server's simulated clock,
    never wall-clock reads)."""

    def __init__(self, k: int):
        self.k = k
        self.reset()

    def reset(self) -> None:
        """Clear every measurement; the SLO budgets are configuration and
        survive."""
        self.infos: List[InstanceInfo] = [InstanceInfo() for _ in range(self.k)]
        self._last_percent_global = 0.0
        # Health counters, under the JAX package's names (a snapshot
        # restores them by name). ``resident_state_bytes`` is this rank's
        # resident replay state, refreshed after each sharded replay.
        self.degraded_replays = 0
        self.degraded_ops = 0
        self.maintenance_retries = 0
        self.maintenance_retry_time_s = 0.0
        self.recoveries = 0
        self.recovery_time_s = 0.0
        self.resident_state_bytes = 0
        # Accumulated per-vertex served traffic, the hot-vertex selection
        # signal. Growable: observations from a grown graph extend it.
        self.vertex_traffic = np.zeros(0, dtype=np.int64)
        # Latency samples are Python ints (ticks), so long-horizon sums
        # cannot wrap.
        self.slo_violations = 0
        self._latency: Dict[str, Dict[str, List[int]]] = {}
        if not hasattr(self, "_slo_budgets"):
            self._slo_budgets: Dict[str, int] = {}

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

    # -- health counters -------------------------------------------------------
    def record_degraded(self, n_ops: int) -> None:
        """One replay served through the degraded (shared-engine) path."""
        self.degraded_replays += 1
        self.degraded_ops += int(n_ops)

    def record_maintenance_retries(self, retries: int, elapsed_s: float) -> None:
        self.maintenance_retries += int(retries)
        self.maintenance_retry_time_s += float(elapsed_s)

    def record_recovery(self, elapsed_s: float) -> None:
        self.recoveries += 1
        self.recovery_time_s += float(elapsed_s)

    # -- latency (online front-end) ------------------------------------------
    def set_slo(self, op_class: str, budget_ticks: int) -> None:
        """An op of ``op_class`` violates its SLO when its queue wait plus
        service time exceeds ``budget_ticks``."""
        self._slo_budgets[op_class] = int(budget_ticks)

    def record_latency(self, op_class: str, queue_wait: int, service_time: int) -> None:
        """Record one served op's latency sample (simulated-clock ticks)."""
        wait, service = int(queue_wait), int(service_time)
        bucket = self._latency.setdefault(op_class, {"wait": [], "service": []})
        bucket["wait"].append(wait)
        bucket["service"].append(service)
        budget = self._slo_budgets.get(op_class)
        if budget is not None and wait + service > budget:
            self.slo_violations += 1

    @staticmethod
    def _percentile(samples: List[int], q: float) -> int:
        """Nearest rank, ``sorted[ceil(q/100 * n) - 1]``: no interpolation,
        so the percentile of one sample is that sample."""
        n = len(samples)
        if n == 0:
            raise ValueError("percentile of empty sample set")
        rank = max(1, -(-int(q * n) // 100))  # ceil(q*n/100), floor 1
        return sorted(samples)[rank - 1]

    def latency_report(self) -> Dict[str, Dict[str, float]]:
        """Per-op-class latency summary on the simulated clock (ticks)."""
        report: Dict[str, Dict[str, float]] = {}
        for cls, bucket in sorted(self._latency.items()):
            waits, services = bucket["wait"], bucket["service"]
            totals = [w + s for w, s in zip(waits, services)]
            n = len(waits)
            report[cls] = {
                "count": n,
                "queue_wait_p50": self._percentile(waits, 50),
                "queue_wait_p95": self._percentile(waits, 95),
                "queue_wait_p99": self._percentile(waits, 99),
                "queue_wait_max": max(waits),
                "queue_wait_mean": sum(waits) / n,
                "total_p50": self._percentile(totals, 50),
                "total_p95": self._percentile(totals, 95),
                "total_p99": self._percentile(totals, 99),
                "total_max": max(totals),
                "total_mean": sum(totals) / n,
                "service_mean": sum(services) / n,
            }
            budget = self._slo_budgets.get(cls)
            if budget is not None:
                report[cls]["slo_budget"] = budget
        return report

    def health_report(self) -> Dict[str, float]:
        return {
            "degraded_replays": self.degraded_replays,
            "degraded_ops": self.degraded_ops,
            "maintenance_retries": self.maintenance_retries,
            "maintenance_retry_time_s": self.maintenance_retry_time_s,
            "recoveries": self.recoveries,
            "recovery_time_s": self.recovery_time_s,
            "slo_violations": self.slo_violations,
            "resident_state_bytes": self.resident_state_bytes,
        }

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
    one pass to the next.

    With a ``mesh`` both passes run the halo-exchange DiDiC of
    :mod:`repro_torch.core.didic_distributed` (each rank one block of
    vertices, the carried state sharded). It is the same algorithm summed
    in another float32 order, so it matches the single-device DiDiC in
    quality, not bit for bit.
    """

    def __init__(self, config: DidicConfig, mesh=None,
                 data_axes: Tuple[str, ...] = ("data",), device=None):
        self.config = config
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self.device = device
        self.state: Optional[DidicState] = None

    def initial(self, graph: Graph, seed: int = 0) -> np.ndarray:
        if self.mesh is not None:
            parts, _ = didic_partition_distributed(graph, self.config, self.mesh,
                                                   self.data_axes, seed=seed)
            self.state = None  # sharded maintenance seeds from the map
            return parts
        parts, self.state = didic_partition(graph, self.config, seed=seed, device=self.device)
        return parts

    def maintain(self, graph: Graph, parts: np.ndarray, iterations: int = 1,
                 pinned: Optional[np.ndarray] = None) -> np.ndarray:
        """One maintenance refinement; ``pinned`` vertices (the placement's
        exception table) keep their assignment."""
        if self.mesh is not None:
            parts, self.state = didic_refine_distributed(
                graph, parts, self.config, self.mesh, self.data_axes,
                state=self.state, iterations=iterations, pinned=pinned,
            )
            return parts
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
    Static, Insert, Stress and Dynamic experiments. Replays and DiDiC run
    on ``device`` (``None`` means CUDA), or with a ``mesh`` on its ranks
    (the mesh's device), every rank running the same program.

    ``maintenance`` refines the mesh's choice for DiDiC: ``"auto"`` the
    mesh DiDiC when there is a mesh, ``"sharded"`` the mesh DiDiC (a mesh
    is required), ``"shared"`` the single-device DiDiC even on a mesh, so
    a mesh run stays bit-identical to the meshless service.

    ``fault_plan``, ``journal`` and ``retry_policy`` (all ``None`` by
    default) attach the fault layer; see the module docstring."""

    def __init__(
        self,
        graph: Graph,
        k: int,
        didic: Optional[DidicConfig] = None,
        *,
        device=None,
        mesh=None,
        data_axes: Tuple[str, ...] = ("data",),
        maintenance: str = "auto",
        exception_capacity: int = 0,
    ):
        if maintenance not in ("auto", "sharded", "shared"):
            raise ValueError(f"unknown maintenance mode {maintenance!r}")
        if maintenance == "sharded" and mesh is None:
            raise ValueError("maintenance='sharded' requires a mesh")
        self.mesh = mesh
        self.data_axes = tuple(data_axes)
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.graph = graph
        self.k = k
        self.placement = Placement(
            owner=np.zeros(graph.n_nodes, dtype=np.int32),
            capacity=int(exception_capacity),
        )
        # Evaluation logs served on the mesh, by content fingerprint, LRU:
        # structural dynamism migrates their resident replay states onto the
        # new graph, an equal regenerated log lands on the first one's
        # state, and logs past ``max_resident_logs`` drop theirs.
        self._replayed_logs: "OrderedDict[str, OpLog]" = OrderedDict()
        self.max_resident_logs = 8
        self.fault_plan = None
        self.journal = None
        self.retry_policy = None
        # Shards marked failed; with the fault plan's they degrade the
        # sharded replay to the batched engine.
        self.failed_shards: set = set()
        # Fingerprints of journal-managed logs already applied, LRU-bounded:
        # the idempotency window of journal replay after recovery.
        self._applied_dynamism: "OrderedDict[str, None]" = OrderedDict()
        self.max_applied_fingerprints = 256
        self.logger = RuntimeLogger(k)
        self.runtime = RuntimePartitioner(
            didic or DidicConfig(k=k),
            mesh=mesh if maintenance in ("auto", "sharded") else None,
            data_axes=self.data_axes, device=self.device,
        )
        self.scheduler = MigrationScheduler()

    @property
    def engine(self) -> str:
        """Which engine family serves this service: ``host`` or, with a
        mesh, ``device``."""
        return "device" if self.mesh is not None else "host"

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

    def _maintain_attempt(self, fn):
        """Run one maintenance computation under the fault plan.

        An injected :class:`~repro_torch.core.fault.MaintenanceTimeout`
        fires before the deterministic DiDiC computation, so a retried
        attempt gives the uninterrupted result bit for bit. Retries back off
        under ``retry_policy``; a spent budget raises
        :class:`~repro_torch.core.fault.RecoveryDeadlineExceeded`. Retry
        counts and time land in the logger's health counters.
        """
        if self.fault_plan is None:
            return fn()
        policy = self.retry_policy or RetryPolicy()
        t0 = _time.perf_counter()
        attempt = 0
        while True:
            try:
                self.fault_plan.fire("maintain")
                out = fn()
            except MaintenanceTimeout:
                attempt += 1
                policy.wait(attempt, _time.perf_counter() - t0)
                continue
            if attempt:
                self.logger.record_maintenance_retries(attempt, _time.perf_counter() - t0)
            return out

    def maintain(self, iterations: int = 1) -> None:
        self.parts = self._maintain_attempt(
            lambda: self.runtime.maintain(self.graph, self.parts, iterations=iterations,
                                          pinned=self.placement.hot_vertices())
        )
        self.logger.observe_structure(self.graph, self.parts)

    def propose_maintenance(self, iterations: int = 1,
                            parts: Optional[np.ndarray] = None) -> np.ndarray:
        """Run a maintenance refinement and return the proposed map without
        adopting it. ``parts`` defaults to the served map; the online
        front-end passes its background round's working copy, so a round
        spread over ticks diffuses from its own intermediate map while the
        service serves the committed one. Advances ``runtime.state``; a
        caller that may discard the proposal keeps the state from before
        and hands it to :meth:`commit_migration`."""
        src = self.parts if parts is None else parts
        return self._maintain_attempt(
            lambda: self.runtime.maintain(self.graph, src, iterations=iterations,
                                          pinned=self.placement.hot_vertices())
        )

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

    def run_ops(self, ops: OpLog, engine: str = "auto", resident: bool = True) -> TrafficResult:
        """Replay an evaluation log. ``engine``: ``auto`` (sharded with a
        mesh, else batched), ``sharded``, ``batched`` (the device engine) or
        ``scalar`` (the host oracle); all give identical counters. Steps
        into the placement's replicated vertices are local reads. An
        attached fault plan fires ``replay`` first.

        ``resident`` (sharded only) keeps the log's parts-independent solve
        artifacts across replays
        (:class:`~repro_torch.core.traffic_sharded.ResidentReplayState`);
        ``False`` forces a cold solve. Equal logs share one state
        (:meth:`_register_log`).

        **Degraded mode.** While a shard is failed (:meth:`mark_shard_failed`
        or the fault plan's schedule) a sharded replay runs the batched
        engine over the whole log instead, bit-equal on all four counters;
        the logger counts the replay in ``degraded_replays`` and the ops
        whose home shard is down in ``degraded_ops``.
        """
        if self.fault_plan is not None:
            self.fault_plan.fire("replay")
        if engine == "sharded" and self.mesh is None:
            raise ValueError("engine='sharded' requires a service mesh")
        replicated = self.placement.replicated_mask()
        if engine == "sharded" or (engine == "auto" and self.mesh is not None):
            failed = self._currently_failed_shards()
            if failed:
                result = execute_ops(self.graph, ops, self.parts, self.k, engine="batched",
                                     device=self.device, replicated=replicated)
                self.logger.record_degraded(self._degraded_op_count(ops, failed))
            else:
                ops = self._register_log(ops)
                result = replay_sharded(self.graph, ops, self.mesh, self.parts, self.k,
                                        data_axes=self.data_axes, resident=resident,
                                        replicated=replicated)
                self.logger.resident_state_bytes = self._resident_state_bytes()
        else:
            result = execute_ops(self.graph, ops, self.parts, self.k,
                                 engine="batched" if engine == "auto" else engine,
                                 device=self.device, replicated=replicated)
        self.logger.observe_traffic(result)
        return result

    def _resident_state_bytes(self) -> int:
        """This rank's resident replay state over the registered logs."""
        return sum(state.state_bytes()
                   for ops in self._replayed_logs.values()
                   for state in ops.__dict__.get("_resident_replay", {}).values())

    # -- shard health --------------------------------------------------------
    def mark_shard_failed(self, shard: int) -> None:
        """Mark a mesh shard down: sharded replays degrade to the batched
        engine until :meth:`mark_shard_recovered`. A meshless service
        records it and replays as before."""
        self.failed_shards.add(int(shard))

    def mark_shard_recovered(self, shard: int) -> None:
        self.failed_shards.discard(int(shard))

    def _currently_failed_shards(self) -> set:
        failed = set(self.failed_shards)
        if self.fault_plan is not None:
            failed |= set(self.fault_plan.failed_shards())
        return failed

    def _degraded_op_count(self, ops: OpLog, failed: set) -> int:
        """Ops whose home shard (the contiguous split of the log) is down."""
        shards = data_shard_count(self.mesh, self.data_axes)
        b = -(-max(ops.n_ops, 1) // shards)
        return sum(max(0, min(ops.n_ops, (s + 1) * b) - min(ops.n_ops, s * b))
                   for s in failed if 0 <= s < shards)

    def _register_log(self, ops: OpLog) -> OpLog:
        """The working set of logs with resident state: an equal log
        resolves to the first one seen (and its state); past
        ``max_resident_logs`` the least recent log drops its state."""
        fp = ops.fingerprint()
        cached = self._replayed_logs.get(fp)
        if cached is not None:
            self._replayed_logs.move_to_end(fp)
            return cached
        self._replayed_logs[fp] = ops
        while len(self._replayed_logs) > self.max_resident_logs:
            _, evicted = self._replayed_logs.popitem(last=False)
            evicted.__dict__.pop("_resident_replay", None)
        return ops

    def make_ops(self, n_ops: int = 10_000, seed: int = 0, pattern: Optional[str] = None) -> OpLog:
        return generate_ops(self.graph, n_ops=n_ops, seed=seed, pattern=pattern)

    def apply_dynamism(self, log: DynamismLog) -> None:
        """Apply a dynamism slice: partition moves, edge inserts and, for a
        vertex-growth log, new vertices on the partitions the log allocated.

        Atomic: every check (shapes and bounds in the graph rebuild, insert
        admissibility) runs before any state changes, so a rejected log
        leaves ``parts``, ``graph`` and the logger as they were. A
        structural log replaces the graph by a new object on the same
        delta-overlay store (attached here if the graph had none), whose
        engines and DiDiC tables adopt it; one that would overflow the store
        fires ``apply:compact`` first and compacts. Growth drops the carried
        diffusion state, which is per-vertex, so the next maintenance pass
        seeds from the grown map.

        **Write-ahead journal.** With a
        :class:`~repro_torch.core.recovery.DynamismJournal` attached the
        application is exactly-once per log fingerprint: the intent (the
        whole log) is journaled before any check, the commit mark after
        every mutation, and a fingerprint this service already applied is a
        no-op. A validation error marks the entry aborted; an injected
        :class:`~repro_torch.core.fault.SimulatedCrash` leaves it pending
        for the recovery driver to roll back.
        """
        journal, plan = self.journal, self.fault_plan
        fp = None
        if journal is not None:
            fp = log.fingerprint()
            if fp in self._applied_dynamism:
                self._applied_dynamism.move_to_end(fp)
                return
            journal.begin(log, fp)
        try:
            if plan is not None:
                plan.fire("apply:pre_validate")
            self._apply_dynamism_checked(log)
        except SimulatedCrash:
            # The process "dies" mid-apply: the entry stays pending.
            raise
        except BaseException:
            # Any other error is a clean rejection.
            if journal is not None:
                journal.abort(fp)
            raise
        if journal is not None:
            journal.commit(fp)
            self._applied_dynamism[fp] = None
            while len(self._applied_dynamism) > self.max_applied_fingerprints:
                self._applied_dynamism.popitem(last=False)
        if plan is not None:
            plan.fire("apply:post_commit")

    def _apply_dynamism_checked(self, log: DynamismLog) -> None:
        """Validate, fire ``apply:pre_commit``, then commit (journal-agnostic)."""
        plan = self.fault_plan
        if not log.structural:
            new_parts = apply_dynamism(self.parts, log)
            if plan is not None:
                plan.fire("apply:pre_commit")
            self.parts = new_parts
            # A move is an ownership write: replicas of moved vertices drop.
            self.placement.invalidate(log.vertices)
            self.logger.observe_structure(self.graph, self.parts)
            return
        old_graph = self.graph
        # -- validate (no mutation yet) --------------------------------------
        # Growth runs on the delta-overlay store: attach one on the first
        # structural log (attaching changes no graph content), and fire the
        # compaction site when this log overflows it.
        store = old_graph.ensure_store()
        n_new_edges = 0 if log.insert_senders is None else int(np.asarray(log.insert_senders).shape[0])
        if plan is not None and store.would_overflow(old_graph, log.n_new_vertices, n_new_edges):
            plan.fire("apply:compact")
        if log.n_new_vertices:
            if log.base_nodes is not None and log.base_nodes != old_graph.n_nodes:
                raise ValueError(
                    f"vertex-growth log grows a base of {log.base_nodes} "
                    f"vertices but the service graph has {old_graph.n_nodes}"
                )
            new_graph = old_graph.with_vertices(
                log.n_new_vertices, log.insert_attrs,
                log.insert_senders, log.insert_receivers, log.insert_weights,
            )
        else:
            new_graph = old_graph.with_edges(
                log.insert_senders, log.insert_receivers, log.insert_weights
            )
        self._check_insert_admissible(log)
        new_parts = apply_dynamism(self.parts, log)
        if plan is not None:
            plan.fire("apply:pre_commit")
        # -- commit (nothing below may raise) --------------------------------
        self.parts = new_parts
        self.graph = new_graph
        self.placement.invalidate(
            np.concatenate([np.asarray(log.vertices, dtype=np.int64), log.dirty_vertices()])
        )
        if log.n_new_vertices:
            self.runtime.state = None
        if self.mesh is not None:
            dirty = log.dirty_vertices()
            for ops in self._replayed_logs.values():
                migrate_resident_states(ops, old_graph, self.graph, dirty)
        self.logger.observe_structure(self.graph, self.parts)

    def prepare_growth(self) -> None:
        """Arm the service for vertex growth: attach a
        :class:`~repro_torch.graphs.structure.GraphStore` at the default
        headroom and build, once, what every growth slice then adopts: the
        replay engine of the graph's pattern on the service's device, and
        the overlay DiDiC tables (or, with sharded maintenance, the capacity
        mesh program). The JAX package runs a throwaway refine here to trace
        its closures; the port builds the same objects without running one.
        Idempotent, and cheap after the first call."""
        graph = self.graph
        graph.ensure_store()
        get_engine(graph, pattern_for(graph), device=self.device)
        if self.runtime.mesh is not None:
            _capacity_mesh_program(graph, self.runtime.mesh, self.runtime.data_axes)
        elif not self.runtime.config.use_kernel:
            _overlay_tables_for(graph, self.device)

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
