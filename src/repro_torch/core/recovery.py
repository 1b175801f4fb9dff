"""Durability and crash recovery for the partitioned graph service.

Twin of ``repro.core.recovery`` on one device. A serving deployment of the
paper's service must survive losing the process mid-cycle without losing
the measurement contract: every number replayable bit for bit. This module
makes the dynamic-experiment cycle
(:class:`~repro_torch.core.dynamic_runtime.DynamicExperimentRuntime` over
:class:`~repro_torch.core.framework.PartitionedGraphService`)
crash-consistent:

**Snapshot** (:class:`ServiceSnapshot`): a versioned, checksummed capture
of the service state, under the JAX package's keys:

* the partition map and the graph's **delta** over a pinned base graph
  (appended attr rows and edge triples; growth is pure concatenation, so
  one ``with_vertices``/``with_edges`` call rebuilds the grown graph bit
  for bit), and the geometry of its delta-overlay store under
  ``meta["store"]`` (capacities, base extents, ``compactions``,
  ``headroom``; ``None`` without a store), which :meth:`ServiceSnapshot.restore_into`
  forces on the rebuilt graph, since the capacity shapes the overlay DiDiC's
  sums;
* DiDiC's carried state (``w``/``l``/``parts``/``beta``, copied off the
  device), the logger's infos, health counters and per-vertex traffic, the
  placement (hot table, ``replica_epoch``), the Migration-Scheduler's
  baseline and history, the insert partitioner's ``SeedSequence``
  position;
* the runtime's loop state: baseline and latest traffic, the per-slice
  records, the next slice to run.

Engines, layouts and DiDiC products are not captured: they are functions
of the graph, built afresh (or, cached on a store that survived with the
base graph, adopted) on the restored graph's first replay and maintenance
pass. Serialization is ``npz`` with
``sort_keys`` JSON meta (:meth:`ServiceSnapshot.to_bytes`); a sha1 over
the canonical payload is checked on load and before every restore, so a
corrupt snapshot fails loudly (:class:`SnapshotIntegrityError`).

**Journal** (:class:`DynamismJournal`): a write-ahead log of
``apply_dynamism``, keyed by the log's fingerprint. The whole log is
journaled before validation (``pending``) and marked ``committed`` after
every mutation; the service skips fingerprints it already applied, so
re-applying after a crash is exactly-once. A crash before commit leaves the
entry pending and recovery rolls it back (the slice is regenerated from
the restored RNG stream); a crash after commit leaves it committed and
recovery re-applies it. Entries older than the latest snapshot are
compacted away. Its byte form is the JAX package's: either package reads
the other's journal.

**Recovery driver** (:func:`run_with_recovery`): runs a dynamic experiment
under a :class:`~repro_torch.core.fault.FaultPlan`, snapshotting every
``snapshot_every`` slices. On a :class:`~repro_torch.core.fault.SimulatedCrash`
it drops the dead runtime, device memory and all, builds a fresh one
(nothing survives the "process" but the snapshot and the journal),
restores, and resumes at the snapshot's slice, feeding journal-committed
logs back into the slices that had applied them. Every leg is
deterministic given the restored state (DiDiC's segment route and the
replay have no atomics), so the recovered run is bit-exact against an
uninterrupted one on every traffic counter.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import io
import json
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.convert import didic_state_from_arrays
from repro_torch.core.dynamic_runtime import SliceRecord
from repro_torch.core.dynamism import DynamismLog
from repro_torch.core.fault import FaultPlan, RetryPolicy, SimulatedCrash
from repro_torch.core.framework import InstanceInfo
from repro_torch.core.placement import Placement
from repro_torch.core.traffic import TrafficResult
from repro_torch.graphs.structure import Graph, GraphStore

__all__ = [
    "SNAPSHOT_VERSION",
    "SnapshotIntegrityError",
    "graph_fingerprint",
    "ServiceSnapshot",
    "JournalEntry",
    "DynamismJournal",
    "replay_journal",
    "RecoveryStats",
    "run_with_recovery",
]

SNAPSHOT_VERSION = 1

_RESULT_FIELDS = ("per_op_total", "per_op_global", "per_partition", "per_vertex")
_LOG_ARRAYS = ("vertices", "targets", "insert_senders", "insert_receivers",
               "insert_weights", "unit_is_insert", "insert_unit")


class SnapshotIntegrityError(ValueError):
    """Snapshot checksum/version mismatch — refuse to restore from it."""


def graph_fingerprint(graph: Graph) -> str:
    """Content hash of a graph (structure and node metadata); equal to the
    JAX package's for an equal graph."""
    h = hashlib.sha1()
    h.update(str(graph.n_nodes).encode())
    for arr in (graph.senders, graph.receivers, graph.edge_weight):
        a = np.ascontiguousarray(arr)
        h.update(str(a.dtype).encode() + a.tobytes())
    for key in sorted(graph.node_attrs):
        a = np.ascontiguousarray(graph.node_attrs[key])
        h.update(key.encode() + str(a.dtype).encode() + a.tobytes())
    return h.hexdigest()


def _payload_checksum(meta: Dict, arrays: Dict[str, np.ndarray]) -> str:
    """sha1 over the canonical (meta, arrays) payload, checksum excluded."""
    clean = {k: v for k, v in sorted(meta.items()) if k != "checksum"}
    h = hashlib.sha1()
    h.update(json.dumps(clean, sort_keys=True).encode())
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode() + str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _to_npz(meta: Dict, arrays: Dict[str, np.ndarray]) -> bytes:
    # sort_keys: equal contents serialize to equal bytes, whatever order
    # the meta dict was built in.
    payload = dict(arrays)
    payload["__meta__"] = np.frombuffer(json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez_compressed(buf, **payload)
    return buf.getvalue()


def _from_npz(blob: bytes) -> Tuple[Dict, Dict[str, np.ndarray]]:
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(bytes(z["__meta__"]).decode())
    return meta, arrays


def _own(a) -> np.ndarray:
    """A C-contiguous copy: a snapshot kept in memory must share no
    storage with the live runtime, which updates its arrays in place."""
    return np.array(a, copy=True, order="C")


def _result_to_arrays(result: TrafficResult, prefix: str,
                      arrays: Dict[str, np.ndarray]) -> None:
    for f in _RESULT_FIELDS:
        arrays[f"{prefix}__{f}"] = _own(getattr(result, f))


def _result_from_arrays(prefix: str, arrays: Dict[str, np.ndarray]) -> TrafficResult:
    return TrafficResult(**{f: arrays[f"{prefix}__{f}"].copy() for f in _RESULT_FIELDS})


def _pack_log(log: DynamismLog, prefix: str, meta: Dict,
              arrays: Dict[str, np.ndarray]) -> None:
    meta[prefix] = {
        "method": log.method,
        "k": log.k,
        "base_nodes": log.base_nodes,
        "attr_keys": sorted(log.insert_attrs),
        "present": [n for n in _LOG_ARRAYS if getattr(log, n) is not None],
    }
    for name in _LOG_ARRAYS:
        arr = getattr(log, name)
        if arr is not None:
            arrays[f"{prefix}__{name}"] = np.ascontiguousarray(arr)
    for key in sorted(log.insert_attrs):
        arrays[f"{prefix}__attr__{key}"] = np.ascontiguousarray(log.insert_attrs[key])


def _unpack_log(prefix: str, meta: Dict, arrays: Dict[str, np.ndarray]) -> DynamismLog:
    m = meta[prefix]
    kw = {name: arrays[f"{prefix}__{name}"].copy() for name in m["present"]}
    for name in _LOG_ARRAYS:
        kw.setdefault(name, None)
    return DynamismLog(
        method=m["method"], k=int(m["k"]),
        base_nodes=None if m["base_nodes"] is None else int(m["base_nodes"]),
        insert_attrs={key: arrays[f"{prefix}__attr__{key}"].copy() for key in m["attr_keys"]},
        **kw,
    )


@dataclasses.dataclass
class ServiceSnapshot:
    """One versioned, checksummed capture of a dynamic run's state.

    Built by :meth:`capture`, applied by :meth:`restore_into`;
    :meth:`to_bytes`/:meth:`from_bytes` round-trip it through compressed
    ``npz`` (the durable form). :meth:`verify` recomputes the checksum and
    raises :class:`SnapshotIntegrityError` on a mismatch; a restore always
    verifies first. A capture copies every array it takes and a restore
    gives back copies (growth concatenates), so a snapshot kept in memory
    (no round trip) stays what it captured however often it is restored.
    """

    meta: Dict
    arrays: Dict[str, np.ndarray]

    @classmethod
    def capture(cls, runtime, base_graph: Graph, next_slice: int) -> "ServiceSnapshot":
        """Snapshot ``runtime`` at a slice boundary: slices ``< next_slice``
        are inside the snapshot, ``next_slice`` is where a restored run
        resumes."""
        svc = runtime.service
        graph = svc.graph
        if graph.n_nodes < base_graph.n_nodes or graph.n_edges < base_graph.n_edges:
            raise ValueError("service graph is not a growth of the base graph")
        rng = runtime.insert.rng_state()
        meta: Dict = {
            "version": SNAPSHOT_VERSION,
            "next_slice": int(next_slice),
            "k": int(svc.k),
            "n_nodes": int(graph.n_nodes),
            "n_edges": int(graph.n_edges),
            "base_nodes": int(base_graph.n_nodes),
            "base_edges": int(base_graph.n_edges),
            "base_fingerprint": graph_fingerprint(base_graph),
            # The delta-overlay geometry: the capacity shapes every overlay
            # buffer and with it the overlay DiDiC's sums, so a restored run
            # must see the pre-crash geometry, not what a one-shot rebuild
            # would derive; the headroom, so that a later compaction derives
            # capacity as the pre-crash lineage would.
            "store": None if graph.store is None else {
                "n_cap": int(graph.store.n_cap),
                "e_cap": int(graph.store.e_cap),
                "base_nodes": int(graph.store.base_nodes),
                "base_edges": int(graph.store.base_edges),
                "compactions": int(graph.store.compactions),
                "headroom": float(graph.store.headroom),
            },
            "has_didic": svc.runtime.state is not None,
            "has_baseline": runtime._baseline is not None,
            "has_result": runtime._result is not None,
            "insert_entropy": str(rng[0]),
            "insert_spawn_key": list(rng[1]),
            "insert_n_spawned": rng[2],
            "applied_fingerprints": list(svc._applied_dynamism),
            "last_percent_global": float(svc.logger._last_percent_global),
            "placement": svc.placement.to_meta(),
            "health": svc.logger.health_report(),
            "scheduler_history": [
                [int(hh["step"]), int(hh["n_moved"])] for hh in runtime.scheduler.history
            ],
            "records": [dataclasses.asdict(r) for r in runtime._records],
        }
        arrays: Dict[str, np.ndarray] = {
            "parts": _own(svc.parts),
            "delta_senders": _own(graph.senders[base_graph.n_edges:]),
            "delta_receivers": _own(graph.receivers[base_graph.n_edges:]),
            "delta_weights": _own(graph.edge_weight[base_graph.n_edges:]),
            # np.inf round-trips through arrays, not through json
            "scheduler_baseline": np.float64(runtime.scheduler.baseline_percent_global),
            "logger_infos": np.array(
                [[i.n_vertices, i.n_edges, i.local_traffic, i.global_traffic]
                 for i in svc.logger.infos], dtype=np.int64),
            "placement_hot": _own(svc.placement.hot),
            # The hot-selection signal: without it a restored run's next
            # refresh_placement would select from a cold accumulator.
            "logger_vertex_traffic": _own(svc.logger.vertex_traffic),
        }
        attr_delta_keys = []
        # sorted: the npz member order is part of the serialized bytes
        for key, old in sorted(base_graph.node_attrs.items()):
            if old.shape[0] != base_graph.n_nodes:
                continue  # not per-node metadata; carried as-is by growth
            attr_delta_keys.append(key)
            arrays[f"attr_delta__{key}"] = _own(graph.node_attrs[key][base_graph.n_nodes:])
        meta["attr_delta_keys"] = sorted(attr_delta_keys)
        if svc.runtime.state is not None:
            st = svc.runtime.state
            for f in ("w", "l", "parts", "beta"):
                arrays[f"didic__{f}"] = np.array(getattr(st, f).detach().cpu().numpy())
        if runtime._baseline is not None:
            _result_to_arrays(runtime._baseline, "baseline", arrays)
        if runtime._result is not None:
            _result_to_arrays(runtime._result, "result", arrays)
        meta["checksum"] = _payload_checksum(meta, arrays)
        return cls(meta=meta, arrays=arrays)

    def verify(self) -> None:
        if self.meta.get("version") != SNAPSHOT_VERSION:
            raise SnapshotIntegrityError(
                f"snapshot version {self.meta.get('version')!r}, "
                f"reader supports {SNAPSHOT_VERSION}"
            )
        want = self.meta.get("checksum")
        got = _payload_checksum(self.meta, self.arrays)
        if want != got:
            raise SnapshotIntegrityError(
                f"snapshot checksum mismatch: stored {want!r}, computed {got!r}"
            )

    def to_bytes(self) -> bytes:
        return _to_npz(self.meta, self.arrays)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "ServiceSnapshot":
        meta, arrays = _from_npz(blob)
        snap = cls(meta=meta, arrays=arrays)
        snap.verify()
        return snap

    @property
    def next_slice(self) -> int:
        return int(self.meta["next_slice"])

    def rebuild_graph(self, base_graph: Graph) -> Graph:
        """Re-grow the snapshot's graph from the pinned base, bit for bit
        (growth is pure concatenation of the recorded deltas)."""
        if graph_fingerprint(base_graph) != self.meta["base_fingerprint"]:
            raise SnapshotIntegrityError("snapshot was taken against a different base graph")
        n_new = int(self.meta["n_nodes"]) - base_graph.n_nodes
        s = self.arrays["delta_senders"]
        if n_new == 0 and s.shape[0] == 0:
            return base_graph
        if n_new == 0:
            return base_graph.with_edges(s, self.arrays["delta_receivers"],
                                         self.arrays["delta_weights"])
        attrs = {key: self.arrays[f"attr_delta__{key}"] for key in self.meta["attr_delta_keys"]}
        return base_graph.with_vertices(n_new, attrs, s, self.arrays["delta_receivers"],
                                        self.arrays["delta_weights"])

    def restore_into(self, runtime, base_graph: Graph) -> None:
        """Load this snapshot into a (typically fresh) runtime and service.
        The DiDiC state goes back as tensors on ``service.device``; the
        engines and DiDiC products are built (or adopted) on first use. The
        rebuilt graph gets the snapshot's store geometry: a one-shot rebuild
        from the base can carry or compact at other extents than the
        incremental run did."""
        self.verify()
        svc = runtime.service
        if svc.k != int(self.meta["k"]):
            raise SnapshotIntegrityError(f"snapshot k={self.meta['k']} vs service k={svc.k}")
        svc.graph = self.rebuild_graph(base_graph)
        sm = self.meta.get("store")
        if sm is not None:
            st = svc.graph.store
            if st is None or st.n_cap != int(sm["n_cap"]) or st.e_cap != int(sm["e_cap"]):
                svc.graph.store = GraphStore(
                    n_cap=int(sm["n_cap"]), e_cap=int(sm["e_cap"]),
                    base_nodes=int(sm["base_nodes"]), base_edges=int(sm["base_edges"]),
                    compactions=int(sm["compactions"]), headroom=sm.get("headroom"),
                )
            else:
                st.base_nodes = int(sm["base_nodes"])
                st.base_edges = int(sm["base_edges"])
                st.compactions = int(sm["compactions"])
                if sm.get("headroom") is not None:
                    st.headroom = float(sm["headroom"])
        pm = self.meta["placement"]
        svc.placement = Placement(
            owner=self.arrays["parts"].copy(), capacity=int(pm["capacity"]),
            hot=self.arrays["placement_hot"].copy(), replica_epoch=int(pm["replica_epoch"]),
        )
        svc.logger.vertex_traffic = self.arrays["logger_vertex_traffic"].astype(np.int64)
        if self.meta["has_didic"]:
            svc.runtime.state = didic_state_from_arrays(
                *(self.arrays[f"didic__{f}"] for f in ("w", "l", "parts", "beta")),
                device=svc.device,
            )
        else:
            svc.runtime.state = None
        svc.logger.infos = [
            InstanceInfo(n_vertices=int(r[0]), n_edges=int(r[1]),
                         local_traffic=int(r[2]), global_traffic=int(r[3]))
            for r in self.arrays["logger_infos"]
        ]
        svc.logger._last_percent_global = float(self.meta["last_percent_global"])
        for key, val in self.meta["health"].items():
            setattr(svc.logger, key, type(getattr(svc.logger, key))(val))
        svc._applied_dynamism = OrderedDict((fp, None) for fp in self.meta["applied_fingerprints"])
        runtime.scheduler.baseline_percent_global = float(self.arrays["scheduler_baseline"])
        runtime.scheduler.history = [
            {"step": int(s), "n_moved": int(n)} for s, n in self.meta["scheduler_history"]
        ]
        runtime.insert.set_rng_state((
            int(self.meta["insert_entropy"]),
            tuple(self.meta["insert_spawn_key"]),
            int(self.meta["insert_n_spawned"]),
        ))
        runtime._baseline = (_result_from_arrays("baseline", self.arrays)
                             if self.meta["has_baseline"] else None)
        runtime._result = (_result_from_arrays("result", self.arrays)
                           if self.meta["has_result"] else None)
        runtime._records = [SliceRecord(**r) for r in self.meta["records"]]


# ===========================================================================
# Write-ahead dynamism journal
# ===========================================================================
@dataclasses.dataclass
class JournalEntry:
    seq: int
    fingerprint: str
    status: str                    # "pending" | "committed" | "aborted"
    log: DynamismLog
    slice_index: int = -1


class DynamismJournal:
    """Write-ahead log of dynamism applications, keyed by log fingerprint.

    The service writes the intent (:meth:`begin`, the whole log) before
    validating and the commit mark (:meth:`commit`) after every mutation;
    :meth:`abort` records a clean validation rejection. A re-begun
    fingerprint reuses its entry (an aborted one is revived to pending), so
    a rolled-back slice that is retried keeps one entry. :meth:`compact`
    drops the entries a snapshot subsumes; :meth:`to_bytes`/:meth:`from_bytes`
    give the journal the snapshot's durable ``npz`` form.
    """

    def __init__(self):
        self.entries: "OrderedDict[str, JournalEntry]" = OrderedDict()
        self._next_seq = 0
        self._current_slice = -1

    def mark_slice(self, index: int) -> None:
        """Stamp subsequent :meth:`begin` calls with this slice index."""
        self._current_slice = int(index)

    def entry_for_slice(self, index: int) -> Optional[JournalEntry]:
        for e in self.entries.values():
            if e.slice_index == int(index):
                return e
        return None

    def begin(self, log: DynamismLog, fingerprint: Optional[str] = None) -> JournalEntry:
        fp = fingerprint or log.fingerprint()
        entry = self.entries.get(fp)
        if entry is not None:
            if entry.status == "aborted":
                entry.status = "pending"
            entry.slice_index = self._current_slice
            return entry
        entry = JournalEntry(seq=self._next_seq, fingerprint=fp, status="pending", log=log,
                             slice_index=self._current_slice)
        self._next_seq += 1
        self.entries[fp] = entry
        return entry

    def commit(self, fingerprint: str) -> None:
        self.entries[fingerprint].status = "committed"

    def abort(self, fingerprint: str) -> None:
        self.entries[fingerprint].status = "aborted"

    def pending(self) -> List[JournalEntry]:
        return [e for e in self.entries.values() if e.status == "pending"]

    def committed(self) -> List[JournalEntry]:
        return sorted((e for e in self.entries.values() if e.status == "committed"),
                      key=lambda e: e.seq)

    def rollback_pending(self) -> int:
        """Abort every pending entry (a crash before commit means the
        mutation never happened: apply is atomic). Returns how many."""
        n = 0
        for e in self.pending():
            e.status = "aborted"
            n += 1
        return n

    def compact(self, before_slice: int) -> int:
        """Drop non-pending entries of slices ``< before_slice`` (inside the
        latest snapshot). Returns how many were dropped."""
        drop = [fp for fp, e in self.entries.items()
                if e.status != "pending" and 0 <= e.slice_index < int(before_slice)]
        for fp in drop:
            del self.entries[fp]
        return len(drop)

    def to_bytes(self) -> bytes:
        # In seq order (the journal's semantic order), so equal contents give
        # equal bytes however they were assembled.
        ordered = sorted(self.entries.items(), key=lambda kv: kv[1].seq)
        meta: Dict = {
            "next_seq": self._next_seq,
            "current_slice": self._current_slice,
            "order": [fp for fp, _ in ordered],
        }
        arrays: Dict[str, np.ndarray] = {}
        for i, (fp, e) in enumerate(ordered):
            meta[f"entry{i}"] = {"seq": e.seq, "fingerprint": fp, "status": e.status,
                                 "slice_index": e.slice_index}
            _pack_log(e.log, f"log{i}", meta, arrays)
        meta["checksum"] = _payload_checksum(meta, arrays)
        return _to_npz(meta, arrays)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "DynamismJournal":
        meta, arrays = _from_npz(blob)
        if meta.get("checksum") != _payload_checksum(meta, arrays):
            raise SnapshotIntegrityError("journal checksum mismatch")
        j = cls()
        j._next_seq = int(meta["next_seq"])
        j._current_slice = int(meta["current_slice"])
        for i, fp in enumerate(meta["order"]):
            em = meta[f"entry{i}"]
            j.entries[fp] = JournalEntry(
                seq=int(em["seq"]), fingerprint=fp, status=em["status"],
                log=_unpack_log(f"log{i}", meta, arrays), slice_index=int(em["slice_index"]),
            )
        return j


def replay_journal(service, journal: DynamismJournal, after_seq: int = -1) -> int:
    """Re-apply committed journal entries (seq order) to a service.

    Idempotent: the service skips fingerprints it already applied, so a
    replay over a partly recovered service is safe. Returns how many
    entries were applied.
    """
    applied = 0
    for e in journal.committed():
        if e.seq <= after_seq:
            continue
        if e.fingerprint in service._applied_dynamism:
            service._applied_dynamism.move_to_end(e.fingerprint)
            continue
        service.apply_dynamism(e.log)
        applied += 1
    return applied


# ===========================================================================
# Recovery driver
# ===========================================================================
@dataclasses.dataclass
class RecoveryStats:
    """What the supervisor did across one faulted run."""

    recoveries: int = 0
    recovery_time_s: float = 0.0
    snapshots_taken: int = 0
    journal_rolled_back: int = 0
    journal_replayed: int = 0
    journal_compacted: int = 0
    resumed_from: List[int] = dataclasses.field(default_factory=list)
    # Per snapshot: its npz size (round-tripped snapshots only) and the
    # seconds to capture it, round trip included; per recovery: the seconds
    # to decode (when round-tripped) and restore the snapshot.
    snapshot_bytes: List[int] = dataclasses.field(default_factory=list)
    capture_s: List[float] = dataclasses.field(default_factory=list)
    restore_s: List[float] = dataclasses.field(default_factory=list)


def run_with_recovery(
    make_runtime: Callable[[], "DynamicExperimentRuntime"],
    base_graph: Graph,
    ops,
    n_slices: int,
    amount: float,
    *,
    maintain_every: int = 1,
    iterations: int = 1,
    measure_damaged: bool = False,
    insert_rate=0.0,
    fault_plan: Optional[FaultPlan] = None,
    journal: Optional[DynamismJournal] = None,
    retry_policy: Optional[RetryPolicy] = None,
    snapshot_every: int = 4,
    snapshot_roundtrip: bool = True,
    max_recoveries: int = 8,
    on_slice: Optional[Callable[[int, TrafficResult], None]] = None,
) -> Tuple["DynamicRunResult", RecoveryStats]:
    """Supervise a dynamic run under fault injection.

    ``make_runtime`` builds a fresh runtime over a fresh service on
    ``base_graph``; it is called once at the start and once per recovery,
    so nothing survives a crash but the snapshot and the journal. With
    ``snapshot_roundtrip`` (the default) every snapshot passes through its
    ``npz`` bytes on capture and on restore, so recovery consumes exactly
    what durable storage would hold; without it the captured snapshot is
    kept in memory and restored as it is (it shares no storage with the
    runtime), and ``RecoveryStats.snapshot_bytes`` gets no entry. On a
    crash the dead runtime is dropped and
    collected before the new one is built, so its grown graphs, engines and
    DiDiC products are freed and device memory does not grow with the
    number of recoveries. The run resumes at the latest snapshot; slices
    whose dynamism had committed re-apply the journaled log, and a pending
    entry is rolled back and its slice regenerated from the restored RNG
    stream. The recovered run is bit-exact against an uninterrupted one.

    ``insert_rate`` is a float or a per-slice callable ``i -> rate``
    (deterministic in ``i``, so re-run slices regenerate identically).
    """
    journal = journal if journal is not None else DynamismJournal()
    stats = RecoveryStats()

    def fresh_runtime():
        rt = make_runtime()
        svc = rt.service
        svc.fault_plan = fault_plan
        svc.journal = journal
        svc.retry_policy = retry_policy
        return rt

    def take_snapshot(rt, next_slice: int) -> ServiceSnapshot:
        t0 = time.perf_counter()
        snap = ServiceSnapshot.capture(rt, base_graph, next_slice=next_slice)
        if snapshot_roundtrip:
            blob = snap.to_bytes()
            snap = ServiceSnapshot.from_bytes(blob)
            stats.snapshot_bytes.append(len(blob))
        stats.capture_s.append(time.perf_counter() - t0)
        stats.snapshots_taken += 1
        stats.journal_compacted += journal.compact(before_slice=next_slice)
        return snap

    runtime = fresh_runtime()
    runtime.begin(ops)
    snapshot = take_snapshot(runtime, next_slice=0)

    i = 0
    while i < n_slices:
        journal.mark_slice(i)
        entry = journal.entry_for_slice(i)
        log = entry.log if entry is not None and entry.status == "committed" else None
        crashed = False
        try:
            _, result = runtime.run_slice(
                i, ops, amount,
                maintain_every=maintain_every, iterations=iterations,
                measure_damaged=measure_damaged,
                insert_rate=insert_rate(i) if callable(insert_rate) else insert_rate,
                log=log,
            )
        except SimulatedCrash:
            if stats.recoveries >= max_recoveries:
                raise
            crashed = True
        if crashed:
            # Outside the handler, so no traceback holds the dead runtime's
            # frames: dropping it frees the crashed "process's" memory. The
            # logs it served drop their resident replay states too (their
            # replayers may live on, in a store the base graph keeps).
            t0 = time.perf_counter()
            stats.journal_rolled_back += journal.rollback_pending()
            for served in runtime.service._replayed_logs.values():
                served.__dict__.pop("_resident_replay", None)
            runtime = None
            gc.collect()
            runtime = fresh_runtime()
            t1 = time.perf_counter()
            if snapshot_roundtrip:
                snapshot = ServiceSnapshot.from_bytes(snapshot.to_bytes())
            snapshot.restore_into(runtime, base_graph)
            stats.restore_s.append(time.perf_counter() - t1)
            i = snapshot.next_slice
            elapsed = time.perf_counter() - t0
            stats.recoveries += 1
            stats.recovery_time_s += elapsed
            stats.resumed_from.append(i)
            runtime.service.logger.record_recovery(elapsed)
            continue
        if log is not None:
            stats.journal_replayed += 1
        if on_slice is not None:
            on_slice(i, result)
        i += 1
        if snapshot_every and i % snapshot_every == 0 and i < n_slices:
            snapshot = take_snapshot(runtime, next_slice=i)
    return runtime.result(), stats
