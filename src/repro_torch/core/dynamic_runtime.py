"""The dynamic-experiment runtime (paper §6.4, §7.4–7.6).

Twin of ``repro.core.dynamic_runtime``. The paper's
maintenance experiments run one cycle per dynamism slice:

    dynamism slice  →  (intermittent) DiDiC maintenance  →  traffic replay

and the replay's per-vertex traffic feeds the next slice's
``least_traffic`` insert policy. :class:`DynamicExperimentRuntime` drives
that cycle on a :class:`~repro_torch.core.framework.PartitionedGraphService`:
the insert partitioner's draw (host numpy), the Migration-Scheduler's
maintenance (DiDiC on the card: the segment route, or ``bell_matmul`` with
``DidicConfig.use_kernel``) and the batched replay (GIS through
``frontier_gather``). With ``insert_rate`` > 0 the graph grows every slice:
the first growth slice of a storeless graph calls the service's
``prepare_growth``, which attaches a delta-overlay store and builds its
engine and DiDiC tables, and every grown graph adopts them
(:mod:`repro_torch.graphs.structure`).

The runtime carries the fault layer's hooks: :meth:`begin` and
:meth:`run_slice` tell an attached fault plan which slice runs, and
``run_slice(log=)`` takes a journaled log in place of the partitioner's
draw, so the recovery driver (:mod:`repro_torch.core.recovery`) can resume
a fresh runtime at any slice boundary.

**On a mesh.** The service decides the engine for every leg: built with a
``mesh`` its replays are sharded over the ranks and resident
(:mod:`repro_torch.core.traffic_sharded`: one log's solve artifacts stay on
each rank across slices, and a structural slice re-solves only the ops its
inserts touch), the insert partitioner draws the sequential policies with
the device scan (:func:`scan_dynamism_targets`, bit-identical to the host
loops of :mod:`repro_torch.core.dynamism`), and maintenance is chosen by
the service's ``maintenance``: ``"shared"`` keeps the single-device DiDiC,
so a mesh run equals the meshless run on every counter of every slice;
``"sharded"`` runs the halo-exchange DiDiC, the same algorithm summed in
another float32 order, held to quality instead. On a store the JAX
package's dynamism scan also pins its padded unit count to the capacity's
slice (``pad_units``); that only keeps a compiled scan shape and changes no
target, so the port's draws pass no ``pad_units``.

The device scan carries the JAX package's unrolled blocks
(:func:`_unroll_blocks`, whose previous-occurrence rows let a unit read its
mover's current partition without an ``[N]`` map). Torch counts in int64
on the device, so the JAX package's base-2²⁰ digit pairs are not needed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

from repro_torch.core.dynamism import DynamismLog
from repro_torch.core.framework import (
    InsertPartitioner,
    MigrationScheduler,
    PartitionedGraphService,
)
from repro_torch.core.traffic import OpLog, TrafficResult

__all__ = [
    "scan_dynamism_targets",
    "SliceRecord",
    "DynamicRunResult",
    "DynamicExperimentRuntime",
]

# Move units a scan block holds (the JAX package's unroll). Blocks only
# shape the previous-occurrence rows; every unit is one sequential step.
_SCAN_UNROLL = 8
# least_traffic totals are exact integers the host oracle carries in
# float64: exact below 2**53.
_VALUE_CEIL = 1 << 53


def _unroll_blocks(movers: np.ndarray, parts: np.ndarray,
                   extra: Tuple[np.ndarray, ...] = (),
                   insert: Optional[np.ndarray] = None,
                   pad_units: int = 0) -> np.ndarray:
    """Host block prep of the scan, row for row the JAX package's.

    Returns ``[T/U, 5 + len(extra), U]`` int64: ``src0`` (each mover's
    initial partition), ``prev_in`` (in-block offset of the mover's previous
    move, -1 if none), ``prev_out`` (its absolute index when in an earlier
    block, -1 otherwise), ``live`` (the tail mask), ``is_insert``
    (vertex-allocation units: no source, and their mover slot is the
    anchor, not a moved vertex), then the ``extra`` per-unit rows.
    ``pad_units`` pins the padded unit count (rounded up to a block);
    padded units are dead (``live`` 0) and change nothing.
    """
    u = _SCAN_UNROLL
    movers = np.asarray(movers, dtype=np.int64)
    units = movers.shape[0]
    # prev[j] = latest j' < j with movers[j'] == movers[j], else -1. Insert
    # units take unique pseudo-ids: they link to nothing.
    movers_eff = movers
    if insert is not None and insert.any():
        movers_eff = movers.copy()
        movers_eff[insert] = -1 - np.arange(int(insert.sum()), dtype=np.int64)
    order = np.lexsort((np.arange(units), movers_eff))
    sm = movers_eff[order]
    prev = np.full(units, -1, dtype=np.int64)
    if units > 1:
        same = sm[1:] == sm[:-1]
        prev[order[1:][same]] = order[:-1][same]
    j0s = (np.arange(units) // u) * u
    in_block = prev >= j0s
    prev_in = np.where(in_block, prev - j0s, -1)
    prev_out = np.where(~in_block & (prev >= 0), prev, -1)

    rows = (
        np.asarray(parts, dtype=np.int64)[movers], prev_in, prev_out,
        np.ones(units, dtype=np.int64),
        np.zeros(units, dtype=np.int64) if insert is None else insert.astype(np.int64),
    ) + tuple(extra)
    total = -(-max(units, int(pad_units)) // u) * u
    packed = np.zeros((len(rows), total), dtype=np.int64)
    packed[2, units:] = -1  # padded prev_out stays "none"
    for i, row in enumerate(rows):
        packed[i, :units] = row
    return packed.reshape(len(rows), -1, u).transpose(1, 0, 2)


def _sequential_scan(totals: torch.Tensor, packed: np.ndarray,
                     dec: np.ndarray, inc: np.ndarray) -> np.ndarray:
    """The sequential oracle on the device: unit by unit, the target is
    the first argmin of ``totals`` (``torch.argmin`` returns the first
    minimum, as ``np.argmin`` does), the mover's current partition loses
    ``dec`` and the target gains ``inc``. The mover's current partition is
    its previous move's target (the host knows which unit that was, from
    the packed rows), else its initial partition. ``dec``/``inc`` are
    per-unit host arrays, zero on dead units."""
    dev = totals.device
    n_blocks, _, u = packed.shape
    units = n_blocks * u
    flat = packed.transpose(1, 0, 2).reshape(packed.shape[1], units)
    base = (np.arange(units) // u) * u
    prev = np.where(flat[1] >= 0, base + flat[1], flat[2])
    src0 = torch.as_tensor(flat[0], device=dev)
    dec_t = torch.as_tensor(-dec, dtype=totals.dtype, device=dev)
    inc_t = torch.as_tensor(inc, dtype=totals.dtype, device=dev)
    targets: List[torch.Tensor] = []
    for j in range(units):
        src = targets[prev[j]] if prev[j] >= 0 else src0[j]
        t = torch.argmin(totals)
        totals.index_add_(0, src.view(1), dec_t[j].view(1))
        totals.index_add_(0, t.view(1), inc_t[j].view(1))
        targets.append(t)
    if not targets:
        return np.zeros(0, dtype=np.int32)
    return torch.stack(targets).to(torch.int32).cpu().numpy()


def scan_dynamism_targets(
    parts: np.ndarray,
    movers: np.ndarray,
    method: str,
    k: int,
    vertex_traffic: Optional[np.ndarray] = None,
    insert_mask: Optional[np.ndarray] = None,
    pad_units: int = 0,
    device=None,
) -> np.ndarray:
    """Device-scan targets for a mover sequence, bit-identical to the
    sequential host loops of
    :func:`repro_torch.core.dynamism.generate_dynamism`.

    ``insert_mask`` flags vertex-allocation units: their slot in ``movers``
    is the anchor, and the policy treats them as a pure addition to the
    chosen target (no source decrement, no traffic carried).
    ``least_traffic`` needs integer-valued, non-negative
    ``vertex_traffic`` whose total stays below 2⁵³ (where the host
    oracle's float64 totals are exact); anything else raises.
    """
    dev = resolve_device(device)
    movers = np.asarray(movers)
    units = int(movers.shape[0])
    if insert_mask is not None:
        insert_mask = np.asarray(insert_mask, dtype=bool)
        if insert_mask.shape[0] != units:
            raise ValueError("insert_mask must be one flag per unit")
    ins = np.zeros(units, dtype=bool) if insert_mask is None else insert_mask
    if method == "fewest_vertices":
        packed = _unroll_blocks(movers, parts, insert=insert_mask, pad_units=pad_units)
        live = packed[:, 3, :].reshape(-1)
        is_ins = packed[:, 4, :].reshape(-1)
        counts = torch.as_tensor(np.bincount(parts, minlength=k).astype(np.int64), device=dev)
        return _sequential_scan(counts, packed, live * (1 - is_ins), live)[:units]
    if method != "least_traffic":
        raise ValueError(f"no device scan for insert method {method!r}")
    if vertex_traffic is None:
        raise ValueError("least_traffic requires vertex_traffic")
    vt = np.asarray(vertex_traffic)
    vt64 = np.asarray(np.rint(vt), dtype=np.int64)
    if not np.array_equal(vt64.astype(vt.dtype, copy=False), vt):
        raise ValueError(
            "device least_traffic needs integer-valued vertex_traffic "
            "(use engine='host' for fractional estimates)"
        )
    if vt64.min(initial=0) < 0 or float(vt64.sum(dtype=np.float64)) >= _VALUE_CEIL:
        raise ValueError("vertex_traffic outside the exact integer range [0, 2**53)")
    tr0 = np.zeros(k, dtype=np.int64)
    np.add.at(tr0, np.asarray(parts, dtype=np.int64), vt64)
    vt_unit = np.where(ins, np.int64(0), vt64[movers.astype(np.int64)])
    packed = _unroll_blocks(movers, parts, extra=(vt_unit,), insert=insert_mask,
                            pad_units=pad_units)
    moved = packed[:, 5, :].reshape(-1) * packed[:, 3, :].reshape(-1)
    return _sequential_scan(torch.as_tensor(tr0, device=dev), packed, moved, moved)[:units]


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
    """Drive the Insert/Stress/Dynamic experiment cycle on a graph service.

    ``scheduler`` decides which maintained maps migrate (default: every
    planned move, ``MigrationScheduler(min_move_fraction=0.0)``)."""

    def __init__(
        self,
        service: PartitionedGraphService,
        insert_method: str = "random",
        seed: int = 0,
        scheduler: Optional[MigrationScheduler] = None,
    ):
        self.service = service
        self.insert = InsertPartitioner(
            insert_method, service.k, seed=seed, engine=service.engine,
            device=service.device,
        )
        # The paper's Dynamic experiment migrates on a fixed interval, so
        # the default scheduler applies every planned move.
        self.scheduler = (scheduler if scheduler is not None
                          else MigrationScheduler(min_move_fraction=0.0))
        # Loop state, which a snapshot captures and a restore puts back.
        self._baseline: Optional[TrafficResult] = None
        self._result: Optional[TrafficResult] = None
        self._records: List[SliceRecord] = []

    @property
    def last_result(self) -> Optional[TrafficResult]:
        """The latest traffic measurement, which feeds the next slice's
        ``least_traffic`` policy: set by :meth:`begin` and :meth:`run_slice`,
        put back by a snapshot restore."""
        return self._result

    def begin(self, ops: OpLog) -> TrafficResult:
        """Measure the baseline and arm the per-slice loop."""
        svc = self.service
        if svc.fault_plan is not None:
            svc.fault_plan.begin_slice(svc.fault_plan.BASELINE)
        self._baseline = self._result = svc.run_ops(ops)
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
        log: Optional[DynamismLog] = None,
    ) -> Tuple[SliceRecord, TrafficResult]:
        """Run one slice of the cycle: dynamism → maintenance → replay, the
        dynamism drawn from the insert partitioner's next stream and fed
        the latest replay's per-vertex traffic.

        ``log`` stands in for the draw (the recovery driver passes a
        journal-committed log when it resumes past a post-commit crash);
        the partitioner still advances one draw, so later slices draw what
        an uninterrupted run draws. A crash mid-slice leaves the loop state
        as it was, so re-running slice ``i`` after a restore reproduces it.
        """
        svc = self.service
        if svc.fault_plan is not None:
            svc.fault_plan.begin_slice(i)
        if insert_rate > 0.0 and svc.graph.store is None:
            # First growth slice on a storeless graph: attach the store and
            # build what the growth slices adopt.
            svc.prepare_growth()
        if log is None:
            log = self.insert.allocate(
                svc.parts, amount, vertex_traffic=self._result.per_vertex,
                insert_rate=insert_rate, graph=svc.graph,
            )
        else:
            self.insert.advance(1)
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
