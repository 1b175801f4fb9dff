"""The dynamic-experiment runtime (paper §6.4, §7.4–7.6), on one device.

Twin of the driver part of ``repro.core.dynamic_runtime``. The paper's
maintenance experiments run one cycle per dynamism slice:

    dynamism slice  →  (intermittent) DiDiC maintenance  →  traffic replay

and the replay's per-vertex traffic feeds the next slice's
``least_traffic`` insert policy. :class:`DynamicExperimentRuntime` drives
that cycle on a :class:`~repro_torch.core.framework.PartitionedGraphService`:
the insert partitioner's draw (host numpy), the Migration-Scheduler's
maintenance (DiDiC on the card: the segment route, or ``bell_matmul`` with
``DidicConfig.use_kernel``) and the batched replay (GIS through
``frontier_gather``). With ``insert_rate`` > 0 the graph grows every slice;
each grown graph gets its own engines.

The JAX package's mesh path (the insert policies as one ``lax.scan``,
sharded replay, mesh DiDiC) and its fault-plan hooks come with later
slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.core.framework import (
    InsertPartitioner,
    MigrationScheduler,
    PartitionedGraphService,
)
from repro_torch.core.traffic import OpLog, TrafficResult

__all__ = ["SliceRecord", "DynamicRunResult", "DynamicExperimentRuntime"]


@dataclasses.dataclass
class SliceRecord:
    """Per-slice measurements of the dynamic experiment."""

    index: int
    units: int
    percent_global: float                      # after (any) maintenance
    maintained: bool
    migrated: int                              # vertices moved by migration
    damaged_percent_global: Optional[float] = None
    inserted: int = 0                          # new vertices allocated


@dataclasses.dataclass
class DynamicRunResult:
    baseline: TrafficResult     # traffic on the starting partitioning
    records: List[SliceRecord]
    final: TrafficResult        # traffic after the last slice
    parts: np.ndarray           # final partition map


class DynamicExperimentRuntime:
    """Drive the Insert/Stress/Dynamic experiment cycle on a graph service."""

    def __init__(
        self,
        service: PartitionedGraphService,
        insert_method: str = "random",
        seed: int = 0,
    ):
        self.service = service
        self.insert = InsertPartitioner(
            insert_method, service.k, seed=seed, engine=service.engine
        )
        # The paper's Dynamic experiment migrates on a fixed interval, so
        # the default scheduler applies every planned move.
        self.scheduler = MigrationScheduler(min_move_fraction=0.0)
        self._baseline: Optional[TrafficResult] = None
        self._result: Optional[TrafficResult] = None
        self._records: List[SliceRecord] = []

    def begin(self, ops: OpLog) -> TrafficResult:
        """Measure the baseline and arm the per-slice loop."""
        self._baseline = self._result = self.service.run_ops(ops)
        self._records = []
        return self._baseline

    def run_slice(
        self,
        i: int,
        ops: OpLog,
        amount: float,
        maintain_every: int = 1,
        iterations: int = 1,
        measure_damaged: bool = False,
        insert_rate: float = 0.0,
    ) -> Tuple[SliceRecord, TrafficResult]:
        """Run one slice of the cycle: dynamism → maintenance → replay, the
        dynamism drawn from the insert partitioner's next stream and fed
        the latest replay's per-vertex traffic."""
        svc = self.service
        log = self.insert.allocate(
            svc.parts, amount, vertex_traffic=self._result.per_vertex,
            insert_rate=insert_rate, graph=svc.graph,
        )
        svc.apply_dynamism(log)
        damaged_pg = svc.run_ops(ops).percent_global if measure_damaged else None
        maintained = (i + 1) % maintain_every == 0
        migrated = 0
        if maintained:
            migrated = svc.maintain_migrate(self.scheduler, step=i, iterations=iterations)
        result = svc.run_ops(ops)
        if maintained:
            # Judge later degradation against what the current graph can
            # achieve, not against the first-ever quality.
            self.scheduler.record_maintenance(result.percent_global)
        self._result = result
        record = SliceRecord(
            index=i,
            units=log.units,
            percent_global=result.percent_global,
            maintained=maintained,
            migrated=migrated,
            damaged_percent_global=damaged_pg,
            inserted=log.n_new_vertices,
        )
        self._records.append(record)
        return record, result

    def result(self) -> DynamicRunResult:
        """Package the loop state accumulated so far."""
        return DynamicRunResult(
            baseline=self._baseline,
            records=list(self._records),
            final=self._result,
            parts=self.service.parts.copy(),
        )

    def run(
        self,
        ops: OpLog,
        n_slices: int,
        amount: float,
        maintain_every: int = 1,
        iterations: int = 1,
        measure_damaged: bool = False,
        insert_rate: float = 0.0,
        on_slice: Optional[Callable[[int, TrafficResult], None]] = None,
    ) -> DynamicRunResult:
        """Run ``n_slices`` slices of ``amount`` dynamism each: per slice,
        generate and apply a dynamism log (from the insert partitioner's
        spawned stream, fed by the latest per-vertex traffic), maintain
        every ``maintain_every``-th slice (DiDiC ``iterations`` + migration
        through the scheduler), then replay ``ops``. ``measure_damaged``
        adds a replay before maintenance (the Stress experiment's damaged
        T_G %); ``insert_rate`` makes that share of each slice's units
        allocate new vertices (the Insert workload), so the graph, the map
        and the traffic feed grow across slices. ``on_slice`` sees every
        post-maintenance :class:`TrafficResult`."""
        self.begin(ops)
        for i in range(n_slices):
            _, result = self.run_slice(
                i, ops, amount,
                maintain_every=maintain_every, iterations=iterations,
                measure_damaged=measure_damaged, insert_rate=insert_rate,
            )
            if on_slice is not None:
                on_slice(i, result)
        return self.result()
