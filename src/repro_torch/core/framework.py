"""The paper's partitioning-framework abstractions (§3.1), static part.

Twin of the static part of ``repro.core.framework``:

* :class:`RuntimeLogger`      — per-partition ``InstanceInfo`` metrics
  (vertices, edges, local vs global traffic — §5.2),
* :class:`RuntimePartitioner` — the initial DiDiC partitioning,
* :class:`PartitionedGraphService` — one logical graph plus a placement,
  serving the thesis emulator's measurements: partition, generate the
  evaluation log, replay it, report edge cut and modularity.

The mesh, the fault plan, the journal, dynamism, maintenance and the
per-vertex traffic that selects hot vertices come with later slices. The
placement's exception table has capacity 0 here, so ``parts`` is the whole
placement.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import metrics
from repro_torch.core.didic import DidicConfig, DidicState, didic_partition
from repro_torch.core.placement import Placement
from repro_torch.core.traffic import OpLog, TrafficResult, execute_ops, generate_ops
from repro_torch.graphs.structure import Graph

__all__ = [
    "InstanceInfo",
    "RuntimeLogger",
    "RuntimePartitioner",
    "PartitionedGraphService",
]


@dataclasses.dataclass
class InstanceInfo:
    """Per-partition runtime metrics (paper §5.2)."""

    n_vertices: int = 0
    n_edges: int = 0
    local_traffic: int = 0
    global_traffic: int = 0


class RuntimeLogger:
    """Runtime-Logging component: accumulates InstanceInfo per partition."""

    def __init__(self, k: int):
        self.k = k
        self.reset()

    def reset(self) -> None:
        self.infos: List[InstanceInfo] = [InstanceInfo() for _ in range(self.k)]
        self._last_percent_global = 0.0

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
    """Runtime-Partitioning component: the initial DiDiC partitioning on
    ``device`` (its state is kept for later maintenance)."""

    def __init__(self, config: DidicConfig, device=None):
        self.config = config
        self.device = device
        self.state: Optional[DidicState] = None

    def initial(self, graph: Graph, seed: int = 0) -> np.ndarray:
        parts, self.state = didic_partition(graph, self.config, seed=seed, device=self.device)
        return parts


class PartitionedGraphService:
    """Emulator-style partitioned graph database (paper §5.3.2), static
    experiment. Replays run on ``device`` (``None`` means CUDA)."""

    def __init__(
        self,
        graph: Graph,
        k: int,
        didic: Optional[DidicConfig] = None,
        *,
        device=None,
    ):
        self.device = resolve_device(device)
        self.graph = graph
        self.k = k
        self.placement = Placement(owner=np.zeros(graph.n_nodes, dtype=np.int32))
        self.logger = RuntimeLogger(k)
        self.runtime = RuntimePartitioner(didic or DidicConfig(k=k), device=self.device)

    @property
    def parts(self) -> np.ndarray:
        """The owner array of the service placement."""
        return self.placement.owner

    @parts.setter
    def parts(self, value: np.ndarray) -> None:
        self.placement.replace_owner(np.asarray(value))

    def partition_with(self, parts: np.ndarray) -> "PartitionedGraphService":
        if parts.shape[0] != self.graph.n_nodes:
            raise ValueError(f"parts has {parts.shape[0]} entries, the graph {self.graph.n_nodes} vertices")
        self.parts = parts.astype(np.int32)
        self.logger.observe_structure(self.graph, self.parts)
        return self

    def partition_didic(self, seed: int = 0) -> "PartitionedGraphService":
        return self.partition_with(self.runtime.initial(self.graph, seed=seed))

    def run_ops(self, ops: OpLog, engine: str = "batched") -> TrafficResult:
        """Replay an evaluation log: ``batched`` (the device engine) or
        ``scalar`` (the host oracle); both give identical counters."""
        result = execute_ops(self.graph, ops, self.parts, self.k, engine=engine,
                             device=self.device)
        self.logger.observe_traffic(result)
        return result

    def make_ops(self, n_ops: int = 10_000, seed: int = 0, pattern: Optional[str] = None) -> OpLog:
        return generate_ops(self.graph, n_ops=n_ops, seed=seed, pattern=pattern)

    def report(self) -> Dict[str, float]:
        return metrics.partition_report(self.graph, self.parts, self.k)
