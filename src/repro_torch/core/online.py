"""Online request front-end over :class:`PartitionedGraphService`.

Twin of ``repro.core.online``. The paper evaluates partition quality by
replaying pre-materialized access patterns (§5–6); a graph store in
production serves operations as they arrive, which is where the traffic a
partitioning causes becomes latency users see. This module serves them:

* **Simulated clients** — :func:`make_arrival_stream` draws a
  deterministic, seeded arrival process (``uniform`` | ``bursty`` |
  ``skewed_hot``) over the paper's op generators, draw for draw as the JAX
  package does, interleaving op classes round-robin.
* **Bounded admission queue** — per-op-class FIFO queues under one global
  bound; arrivals beyond it wait in the stream (admission never reorders
  and never drops).
* **Fixed-slot batching** — each tick packs queued ops of one class into an
  :class:`~repro_torch.core.traffic.OpLog` of exactly ``batch_slots`` ops,
  padding with *inert* ops (:func:`inert_pad_op`) that expand no edge and
  so add zero to every counter in every engine.
* **Background maintenance** — :class:`BackgroundMaintenance` spreads a
  DiDiC round over budgeted iterations between admission batches
  (:meth:`PartitionedGraphService.propose_maintenance` carries the
  diffusion state; ``commit_migration`` adopts the round's map).
* **Deterministic latency** — the server runs on a simulated integer clock
  (one tick, one admission round); queue wait and service time land in the
  logger's latency samples. No wall-clock read, except ``run()``'s timing
  of a recovery.

The batches replay through the service's engine on its device (GIS
through the ``frontier_gather`` kernel on the card), or through the
sharded replay on a mesh service, cold: no batch keeps resident state.

**Bit-exactness.** Per-op counters are independent per op and the
aggregates are integer sums with pads adding zero, so the online totals
equal an offline replay of the live ops alone, per placement epoch: the
server opens an epoch (owner map, hot table, the ops each class served
under it) whenever migration changes the map or the hot table churns, and
:func:`offline_replay` must reproduce all four counters bit for bit.

**Crash safety.** Each tick runs in a fixed order: fire ``serve:admit`` (no
state mutated yet) → pull arrivals (cursor-guarded) → peek the batch →
pure replay → fire ``serve:commit`` → fold counters and pop served ops (the
only mutations) → background maintenance → clock advance. A
:class:`~repro_torch.core.fault.SimulatedCrash` at either site leaves the
tick re-runnable, and the supervised :meth:`OnlineServer.run` retries it
bit-identically. A ``serve:commit`` crash re-runs the pure replay, so only
the logger's traffic observation repeats; the served counters fold once.
"""

from __future__ import annotations

import dataclasses
import time as _time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.fault import SimulatedCrash
from repro_torch.core.framework import MigrationScheduler, PartitionedGraphService
from repro_torch.core.traffic import OpLog, execute_ops, generate_ops
from repro_torch.graphs.generators import FS_FILE, FS_FOLDER
from repro_torch.graphs.structure import Graph

__all__ = [
    "ARRIVAL_PROCESSES",
    "ArrivalOp",
    "make_arrival_stream",
    "inert_pad_op",
    "BackgroundMaintenance",
    "OnlineServer",
    "OnlineRunResult",
    "offline_replay",
]

ARRIVAL_PROCESSES = ("uniform", "bursty", "skewed_hot")


@dataclasses.dataclass(frozen=True)
class ArrivalOp:
    """One client request: an op of ``op_class`` arriving at a simulated
    clock tick. ``seq`` is the global submission index, the tiebreak that
    makes service order total."""

    op_class: str
    start: int
    end: int
    arrival: int
    seq: int


def _hot_candidates(graph: Graph, op_class: str) -> np.ndarray:
    """Vertices eligible as a hot-spot start for ``op_class``."""
    if op_class == "filesystem":
        return np.nonzero(graph.node_attrs["node_type"] == FS_FOLDER)[0]
    return np.arange(graph.n_nodes)


def make_arrival_stream(
    graph: Graph,
    op_classes: Tuple[str, ...],
    n_ops: int,
    seed: int = 0,
    process: str = "uniform",
    ops_per_tick: int = 4,
    hot_fraction: float = 0.75,
    n_hot: int = 4,
) -> Tuple[List[ArrivalOp], Dict[str, Tuple[int, int]]]:
    """Materialize a deterministic arrival stream.

    Per class, ops come from :func:`generate_ops` (the served workload is
    the evaluated one); classes interleave round-robin and the process
    assigns nondecreasing arrival ticks:

    * ``uniform``    — exactly ``ops_per_tick`` arrivals per tick;
    * ``bursty``     — geometric burst sizes (mean ``2·ops_per_tick``)
      separated by geometric idle gaps;
    * ``skewed_hot`` — uniform timing, but ``hot_fraction`` of the ops
      restart from the ``n_hot`` highest-degree eligible vertices.

    Returns the stream (sorted by ``(arrival, seq)``) and each class's
    ``(t_l, t_pg)`` step costs, which the server needs to build batches.
    """
    if process not in ARRIVAL_PROCESSES:
        raise ValueError(f"unknown arrival process {process!r}; one of {ARRIVAL_PROCESSES}")
    per_class: Dict[str, OpLog] = {}
    t_counts: Dict[str, Tuple[int, int]] = {}
    per_cls_n = -(-n_ops // len(op_classes))
    for ci, cls in enumerate(op_classes):
        log = generate_ops(graph, n_ops=per_cls_n, seed=seed * 1000 + ci, pattern=cls)
        per_class[cls] = log
        t_counts[cls] = (log.t_l, log.t_pg)

    # Round-robin interleave, truncated to n_ops.
    interleaved: List[Tuple[str, int, int]] = []
    for i in range(per_cls_n):
        for cls in op_classes:
            log = per_class[cls]
            interleaved.append((cls, int(log.starts[i]), int(log.ends[i])))
    interleaved = interleaved[:n_ops]

    rng = np.random.default_rng(seed)
    if process == "bursty":
        arrivals: List[int] = []
        tick = 0
        while len(arrivals) < n_ops:
            burst = int(rng.geometric(1.0 / (2 * ops_per_tick)))
            arrivals.extend([tick] * min(burst, n_ops - len(arrivals)))
            tick += 1 + int(rng.geometric(0.5))
        arrival_ticks = np.asarray(arrivals[:n_ops], dtype=np.int64)
    else:
        arrival_ticks = np.arange(n_ops, dtype=np.int64) // ops_per_tick

    if process == "skewed_hot":
        hot_mask = rng.random(n_ops) < hot_fraction
        hot_sets = {cls: _hot_candidates(graph, cls) for cls in op_classes}
        for cls, cand in hot_sets.items():
            order = np.argsort(-graph.degree[cand], kind="stable")
            hot_sets[cls] = cand[order[: max(1, n_hot)]]
        picks = rng.integers(0, 1 << 30, size=n_ops)
        rewritten = []
        for i, (cls, s, e) in enumerate(interleaved):
            if hot_mask[i]:
                hot = hot_sets[cls]
                s = int(hot[picks[i] % hot.shape[0]])
                if cls in ("gis_short", "gis_long") and s == e:
                    # keep the op non-degenerate: (v, v) is the inert pad
                    s = int(hot[(picks[i] + 1) % hot.shape[0]])
            rewritten.append((cls, s, e))
        interleaved = rewritten

    stream = [ArrivalOp(cls, s, e, int(arrival_ticks[i]), i)
              for i, (cls, s, e) in enumerate(interleaved)]
    return stream, t_counts


def inert_pad_op(graph: Graph, op_class: str) -> Tuple[int, int]:
    """A ``(start, end)`` pair whose traversal expands zero edges: a
    filesystem BFS from a file (no filtered out-edges), a GIS route with
    ``start == end`` (empty expansion set), a Twitter 2-hop from an
    out-degree-0 vertex."""
    if op_class == "filesystem":
        files = np.nonzero(graph.node_attrs["node_type"] == FS_FILE)[0]
        if files.shape[0] == 0:
            raise ValueError("filesystem pad op needs at least one file vertex")
        v = int(files[0])
        return (v, v)
    if op_class in ("gis_short", "gis_long"):
        return (0, 0)
    if op_class == "twitter":
        sinks = np.nonzero(graph.out_degree == 0)[0]
        if sinks.shape[0] == 0:
            raise ValueError(
                "twitter pad op needs an out-degree-0 vertex; this graph "
                "has none — append an isolated parking vertex "
                "(graph.with_vertices(1)) before partitioning"
            )
        return (int(sinks[0]), -1)
    raise ValueError(f"unknown op class {op_class!r}")


class BackgroundMaintenance:
    """Budgeted DiDiC maintenance interleaved between admission batches.

    Every ``every`` ticks a round starts (the diffusion state kept for
    rollback, the served map copied into a working map); each tick then
    advances the round by ``budget_iterations`` refinement iterations on
    the working map, and after ``round_iterations`` the round commits
    through the Migration-Scheduler: ``scheduler`` where one is given,
    else the service's own, which then plans, commits and records. The
    service serves the committed map throughout. Structural growth
    mid-round invalidates the working map, and the round restarts from the
    grown map on its next tick.
    """

    def __init__(self, service: PartitionedGraphService,
                 scheduler: Optional[MigrationScheduler] = None, *,
                 every: int = 4, budget_iterations: int = 1,
                 round_iterations: int = 4):
        self.service = service
        self.scheduler = scheduler if scheduler is not None else service.scheduler
        self.every = int(every)
        self.budget_iterations = int(budget_iterations)
        self.round_iterations = int(round_iterations)
        self._working: Optional[np.ndarray] = None
        self._prev_state = None
        self._done = 0
        self.rounds_completed = 0
        self.iterations_run = 0
        self.first_iteration_tick: Optional[int] = None

    def tick(self, now: int) -> Optional[int]:
        """Advance background work at tick ``now``. Returns the migrated
        vertex count when a round commits this tick, else ``None``."""
        svc = self.service
        if self._working is not None and self._working.shape[0] != svc.graph.n_nodes:
            self._working = None  # growth mid-round: restart next tick
            self._done = 0
        if self._working is None:
            if (now + 1) % self.every != 0:
                return None
            self._prev_state = svc.runtime.state
            self._working = svc.parts.copy()
            self._done = 0
        budget = min(self.budget_iterations, self.round_iterations - self._done)
        self._working = svc.propose_maintenance(iterations=budget, parts=self._working)
        self._done += budget
        self.iterations_run += budget
        if self.first_iteration_tick is None:
            self.first_iteration_tick = int(now)
        if self._done < self.round_iterations:
            return None
        moved = svc.commit_migration(self.scheduler, self._working, step=now,
                                     prev_state=self._prev_state)
        self._working = None
        self._prev_state = None
        self.rounds_completed += 1
        return moved


@dataclasses.dataclass
class OnlineRunResult:
    """An online run: the four traffic counters in the shape
    :func:`offline_replay` gives, the epoch record, and the latency and
    health reports."""

    per_op: Dict[str, np.ndarray]    # cls → [n_served, 2] int64 (total, global)
    per_partition: np.ndarray        # [k] int64
    per_vertex: np.ndarray           # [N] int64
    epochs: List[Dict]
    ticks: int
    ops_served: int
    batches_served: int
    latency: Dict[str, Dict[str, float]]
    health: Dict[str, float]


class OnlineServer:
    """Fixed-slot admission loop over a partitioned service: construct it,
    :meth:`submit_stream` a materialized arrival stream, then :meth:`run`
    (or drive :meth:`tick` by hand)."""

    def __init__(self, service: PartitionedGraphService, *,
                 batch_slots: int = 8, queue_limit: int = 64,
                 maintenance: Optional[BackgroundMaintenance] = None,
                 slo: Optional[Dict[str, int]] = None):
        if batch_slots < 1:
            raise ValueError("batch_slots must be >= 1")
        if queue_limit < batch_slots:
            raise ValueError("queue_limit must be >= batch_slots")
        self.service = service
        self.batch_slots = int(batch_slots)
        self.queue_limit = int(queue_limit)
        self.maintenance = maintenance
        self.clock = 0
        self.ops_served = 0
        self.batches_served = 0
        self._queues: Dict[str, Deque[ArrivalOp]] = {}
        self._queued = 0
        self._arrivals: List[ArrivalOp] = []
        self._cursor = 0
        self._t_counts: Dict[str, Tuple[int, int]] = {}
        self._pads: Dict[str, Tuple[int, int]] = {}
        self._per_op: Dict[str, List[Tuple[int, int]]] = {}
        self._per_partition = np.zeros(service.k, dtype=np.int64)
        self._per_vertex = np.zeros(service.graph.n_nodes, dtype=np.int64)
        self._baseline_pending = False
        self.epochs: List[Dict] = [
            {"parts": service.parts.copy(), "hot": service.placement.hot_vertices(), "ops": {}}
        ]
        if slo:
            for cls, budget in slo.items():
                service.logger.set_slo(cls, budget)

    # -- admission ----------------------------------------------------------
    def submit_stream(self, arrivals: List[ArrivalOp],
                      t_counts: Dict[str, Tuple[int, int]]) -> None:
        """Attach the materialized client stream (one per run)."""
        if self._arrivals:
            raise RuntimeError("a stream is already submitted")
        for a, b in zip(arrivals, arrivals[1:]):
            if (a.arrival, a.seq) > (b.arrival, b.seq):
                raise ValueError("arrival stream must be sorted by (arrival, seq)")
        self._arrivals = list(arrivals)
        self._t_counts = dict(t_counts)
        for cls in t_counts:
            self._queues.setdefault(cls, deque())
            self._per_op.setdefault(cls, [])

    def _pull_arrivals(self) -> None:
        """Admit due arrivals under the queue bound; idempotent within a
        tick and order-preserving (admission stops at the first op that
        does not fit)."""
        while self._cursor < len(self._arrivals):
            op = self._arrivals[self._cursor]
            if op.arrival > self.clock or self._queued >= self.queue_limit:
                break
            self._queues[op.op_class].append(op)
            self._queued += 1
            self._cursor += 1

    def _pick_class(self) -> Optional[str]:
        """The op class whose queue head arrived first (seq tiebreak)."""
        best = None
        best_key = None
        for cls, q in self._queues.items():
            if q:
                key = (q[0].arrival, q[0].seq)
                if best_key is None or key < best_key:
                    best, best_key = cls, key
        return best

    def _pad_for(self, cls: str) -> Tuple[int, int]:
        pad = self._pads.get(cls)
        if pad is None:
            pad = self._pads[cls] = inert_pad_op(self.service.graph, cls)
        return pad

    def _batch_log(self, cls: str, live: List[ArrivalOp]) -> OpLog:
        pad_s, pad_e = self._pad_for(cls)
        n_pad = self.batch_slots - len(live)
        starts = np.asarray([op.start for op in live] + [pad_s] * n_pad, dtype=np.int64)
        ends = np.asarray([op.end for op in live] + [pad_e] * n_pad, dtype=np.int64)
        t_l, t_pg = self._t_counts[cls]
        return OpLog(cls, starts, ends, t_l=t_l, t_pg=t_pg)

    # -- the admission loop -------------------------------------------------
    def tick(self) -> Optional[Tuple[str, int]]:
        """One admission round. Returns ``(op_class, n_live)`` when a batch
        was served, ``None`` on an idle tick. The step order is the
        crash-safety contract (module docstring)."""
        svc = self.service
        plan = svc.fault_plan
        if plan is not None:
            plan.begin_slice(self.clock)
            plan.fire("serve:admit")
        self._pull_arrivals()
        cls = self._pick_class()
        served = None
        if cls is not None:
            q = self._queues[cls]
            live = [q[i] for i in range(min(self.batch_slots, len(q)))]
            # Cold: each batch is a new log, and resident state kept per log
            # would grow with the requests served.
            result = svc.run_ops(self._batch_log(cls, live), resident=False)
            if plan is not None:
                plan.fire("serve:commit")
            self._fold(cls, live, result)
            served = (cls, len(live))
        elif plan is not None:
            plan.fire("serve:commit")
        if self.maintenance is not None:
            if self.maintenance.tick(self.clock) is not None:
                self._baseline_pending = True
        # A new epoch opens whenever the placement changes: a migrated owner
        # map or a churned exception table.
        cur = self.epochs[-1]
        hot = svc.placement.hot_vertices()
        if (cur["parts"].shape[0] != svc.parts.shape[0]
                or (cur["parts"] != svc.parts).any()
                or not np.array_equal(cur["hot"], hot)):
            self.epochs.append({"parts": svc.parts.copy(), "hot": hot, "ops": {}})
        self.clock += 1
        return served

    def _fold(self, cls: str, live: List[ArrivalOp], result) -> None:
        """Commit a served batch into the server aggregates (the only
        tick-state mutation; runs after ``serve:commit``)."""
        svc = self.service
        per_op = self._per_op[cls]
        epoch_ops = self.epochs[-1]["ops"].setdefault(cls, [])
        for i, op in enumerate(live):
            per_op.append((int(result.per_op_total[i]), int(result.per_op_global[i])))
            epoch_ops.append((op.start, op.end))
            svc.logger.record_latency(cls, self.clock - op.arrival, 1)
        pp = np.asarray(result.per_partition, dtype=np.int64)
        self._per_partition[: pp.shape[0]] += pp
        pv = np.asarray(result.per_vertex, dtype=np.int64)
        if pv.shape[0] > self._per_vertex.shape[0]:
            grown = np.zeros(pv.shape[0], dtype=np.int64)
            grown[: self._per_vertex.shape[0]] = self._per_vertex
            self._per_vertex = grown
        self._per_vertex[: pv.shape[0]] += pv
        q = self._queues[cls]
        for _ in live:
            q.popleft()
        self._queued -= len(live)
        self.ops_served += len(live)
        self.batches_served += 1
        if self._baseline_pending and self.maintenance is not None:
            self.maintenance.scheduler.record_maintenance(result.percent_global)
            self._baseline_pending = False

    @property
    def drained(self) -> bool:
        return self._cursor >= len(self._arrivals) and self._queued == 0

    def run(self, max_ticks: int = 100_000, supervise: bool = True) -> OnlineRunResult:
        """Serve the submitted stream to completion. With ``supervise`` and
        a fault plan attached, an injected
        :class:`~repro_torch.core.fault.SimulatedCrash` is counted as a
        recovery in the health counters and the tick retried,
        bit-identically (crash events fire once). Without ``supervise`` the
        crash propagates out of ``run``; the tick left nothing half done,
        so a later ``run()`` serves the rest as a supervised run would."""
        while not self.drained:
            if self.clock >= max_ticks:
                raise RuntimeError(
                    f"stream not drained after {max_ticks} ticks "
                    f"({self._queued} queued, cursor {self._cursor}/{len(self._arrivals)})"
                )
            if supervise and self.service.fault_plan is not None:
                t0 = _time.perf_counter()
                try:
                    self.tick()
                except SimulatedCrash:
                    self.service.logger.record_recovery(_time.perf_counter() - t0)
            else:
                self.tick()
        return self.result()

    def result(self) -> OnlineRunResult:
        svc = self.service
        return OnlineRunResult(
            per_op={cls: np.asarray(v, dtype=np.int64).reshape(-1, 2)
                    for cls, v in self._per_op.items()},
            per_partition=self._per_partition.copy(),
            per_vertex=self._per_vertex.copy(),
            epochs=self.epochs,
            ticks=self.clock,
            ops_served=self.ops_served,
            batches_served=self.batches_served,
            latency=svc.logger.latency_report(),
            health=svc.logger.health_report(),
        )


def offline_replay(
    graph: Graph,
    epochs: List[Dict],
    k: int,
    t_counts: Dict[str, Tuple[int, int]],
    engine: str = "batched",
    device=None,
) -> Tuple[Dict[str, np.ndarray], np.ndarray, np.ndarray]:
    """Replay a server's epoch record offline and aggregate the counters.

    Each epoch's live ops replay as one log per class against the epoch's
    owner map and hot table, on ``device`` (``None`` means CUDA) with the
    batched engine or on the host with ``engine="scalar"``. Per-op rows
    concatenate in epoch order (the served order: per-class service is
    FIFO and epochs are chronological) and the additive counters sum.
    Valid for runs on a static graph. Returns ``(per_op, per_partition,
    per_vertex)`` in the shape of :class:`OnlineRunResult`.
    """
    per_op: Dict[str, List[np.ndarray]] = {}
    per_partition = np.zeros(k, dtype=np.int64)
    per_vertex = np.zeros(graph.n_nodes, dtype=np.int64)
    for epoch in epochs:
        parts = np.asarray(epoch["parts"], dtype=np.int32)
        hot = np.asarray(epoch.get("hot", ()), dtype=np.int64)
        replicated = None
        if hot.size:
            replicated = np.zeros(graph.n_nodes, dtype=bool)
            replicated[hot] = True
        for cls, pairs in epoch["ops"].items():
            if not pairs:
                continue
            starts = np.asarray([s for s, _ in pairs], dtype=np.int64)
            ends = np.asarray([e for _, e in pairs], dtype=np.int64)
            t_l, t_pg = t_counts[cls]
            ops = OpLog(cls, starts, ends, t_l=t_l, t_pg=t_pg)
            result = execute_ops(graph, ops, parts, k, engine=engine, device=device,
                                 replicated=replicated)
            per_op.setdefault(cls, []).append(
                np.stack([result.per_op_total.astype(np.int64),
                          result.per_op_global.astype(np.int64)], axis=1)
            )
            per_partition += np.asarray(result.per_partition, dtype=np.int64)
            per_vertex += np.asarray(result.per_vertex, dtype=np.int64)
    return (
        {cls: np.concatenate(chunks, axis=0) for cls, chunks in per_op.items()},
        per_partition,
        per_vertex,
    )
