"""Port parity for the fault layer and crash recovery: ``core/fault.py``,
the service's and runtime's fault hooks, and ``core/recovery.py``, against
the JAX package with no mesh (as ``tests/test_recovery.py`` runs it).

Every comparison is bit-exact: the counters are integers, and DiDiC is only
ever compared within one package (an uninterrupted port run against a
recovered port run), or not at all (the JAX comparison injects the JAX
DiDiC map and runs no maintenance). Held against the JAX package: the
fault-site registry, plan schedules and their ``describe()``, the retry
policy, journal bytes in both directions, ``graph_fingerprint``, snapshot
keys, and a recovered run's four counters on every slice.
"""

import io
import json

import numpy as np
import pytest
import torch

from repro.core import fault as jax_fault
from repro.core import framework as jax_framework
from repro.core import recovery as jax_recovery
from repro.core.didic import DidicConfig as JaxDidicConfig
from repro.core.dynamic_runtime import DynamicExperimentRuntime as JaxRuntime
from repro.core.traffic import generate_ops as jax_generate_ops
from repro.graphs import datasets as jax_datasets
from repro_torch.core import fault, partitioners
from repro_torch.core.didic import DidicConfig
from repro_torch.core.dynamic_runtime import DynamicExperimentRuntime
from repro_torch.core.dynamism import DynamismLog
from repro_torch.core.fault import (
    FAULT_SITES,
    FaultPlan,
    MaintenanceTimeout,
    RecoveryDeadlineExceeded,
    RetryPolicy,
    SimulatedCrash,
)
from repro_torch.core.framework import InsertPartitioner, PartitionedGraphService, RuntimeLogger
from repro_torch.core.recovery import (
    DynamismJournal,
    ServiceSnapshot,
    SnapshotIntegrityError,
    graph_fingerprint,
    replay_journal,
    run_with_recovery,
)
from repro_torch.core.traffic import generate_ops
from repro_torch.graphs import datasets

# The suite runs in several worker processes at once; one intra-op thread
# each keeps PyTorch from oversubscribing the cores.
torch.set_num_threads(1)

COUNTERS = ("per_op_total", "per_op_global", "per_partition", "per_vertex")
FAST_DIDIC = DidicConfig(k=4, iterations=6)
NO_SLEEP = dict(sleep=lambda s: None)


def _assert_results_equal(a, b, ctx=""):
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f"{ctx}: {f} diverged")


def _fs():
    return datasets.load("filesystem", scale=0.001, seed=1)


def _runtime_factory(graph, *, seed=7, method="least_traffic", capacity=0):
    def make():
        svc = PartitionedGraphService(graph, 4, didic=FAST_DIDIC, device="cpu",
                                      exception_capacity=capacity)
        svc.partition_didic(seed=0)
        return DynamicExperimentRuntime(svc, insert_method=method, seed=seed)

    return make


def _uninterrupted(make, ops, n_slices, amount, rate, **kw):
    """Per-slice results and the final result of a run with no fault."""
    base = {}
    rt = make()
    rt.begin(ops)
    for i in range(n_slices):
        _, base[i] = rt.run_slice(i, ops, amount, insert_rate=rate(i) if callable(rate) else rate,
                                  **kw)
    return base, rt.result()


def _recovered(make, graph, ops, n_slices, amount, plan, **kw):
    got = {}
    out, stats = run_with_recovery(
        make, graph, ops, n_slices, amount, fault_plan=plan,
        retry_policy=RetryPolicy(**NO_SLEEP), on_slice=lambda i, r: got.__setitem__(i, r), **kw)
    return got, out, stats


# ---------------------------------------------------------------------------
# Fault primitives against the JAX package
# ---------------------------------------------------------------------------
def test_fault_sites_are_the_jax_registry():
    assert list(FAULT_SITES) == list(jax_fault.FAULT_SITES)
    for site, text in FAULT_SITES.items():
        assert text == jax_fault.FAULT_SITES[site], site
    assert "apply:compact" in FAULT_SITES


def _schedule(cls):
    return (cls().crash(2, site="apply:pre_commit").fail_shard(3, shard=1, slices=2)
            .timeout_maintenance(1, times=2).crash(4, site="serve:commit"))


def _fire_trace(plan, mod):
    """(slice, site, what fired) for every site on slices -1..5, twice."""
    out = []
    for s in range(-1, 6):
        plan.begin_slice(s)
        for site in sorted(FAULT_SITES) * 2:
            try:
                plan.fire(site)
                out.append((s, site, None))
            except mod.SimulatedFault as e:
                out.append((s, site, type(e).__name__, str(e)))
        out.append((s, "shards", sorted(plan.failed_shards())))
    return out


def test_fault_plan_matches_jax():
    plan, jplan = _schedule(FaultPlan), _schedule(jax_fault.FaultPlan)
    assert plan.describe() == jplan.describe()
    assert _fire_trace(plan, fault) == _fire_trace(jplan, jax_fault)
    assert plan.failed_shards(3) == plan.failed_shards(4) == frozenset({1})
    assert plan.failed_shards(5) == frozenset() and plan.current_slice == 5


def test_unknown_fault_sites_rejected():
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan().crash(0, site="apply:prevalidate")
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan().fire("bogus-site")
    # The store's compaction site is registered, as in the JAX package.
    for cls in (FaultPlan, jax_fault.FaultPlan):
        plan = cls().crash(0, site="apply:compact")
        plan.begin_slice(0)
        with pytest.raises(Exception, match="apply:compact"):
            plan.fire("apply:compact")


def test_retry_policy_backoff_then_deadline():
    trace = []
    for cls in (RetryPolicy, jax_fault.RetryPolicy):
        sleeps = []
        p = cls(max_retries=3, backoff_base_s=1.0, backoff_factor=2.0, deadline_s=100.0,
                sleep=sleeps.append)
        for attempt in (1, 2, 3):
            p.wait(attempt, elapsed_s=0.0)
        p.wait(1, elapsed_s=99.5)  # the last sleep is cut to the deadline
        assert sleeps == [1.0, 2.0, 4.0, 0.5]
        for attempt, elapsed in ((4, 0.0), (1, 100.0)):  # retries, then clock spent
            with pytest.raises(Exception) as e:
                p.wait(attempt, elapsed_s=elapsed)
            trace.append((type(e.value).__name__, str(e.value)))
    assert trace[:2] == trace[2:]
    assert trace[0][0] == RecoveryDeadlineExceeded.__name__


def test_fault_injector_matches_jax():
    raised = []
    for mod in (fault, jax_fault):
        inj = mod.FaultInjector(fail_at_steps=(2, 5))
        trace = []
        for step in (0, 1, 2, 2, 3, 5, 5, 6):
            try:
                inj.check(step)
                trace.append((step, None))
            except mod.SimulatedFault as e:
                trace.append((step, str(e)))
        raised.append(trace)
    assert raised[0] == raised[1]
    assert [s for s, msg in raised[0] if msg] == [2, 5]  # each step fires once


def test_straggler_mitigator_matches_jax(monkeypatch):
    durations = [1.0, 1.2, 0.8, 1.0, 1.1, 1.0, 4.0, 1.0, 3.2, 3.4, 0.9, 10.0]
    traces = []
    for mod in (fault, jax_fault):
        m = mod.StragglerMitigator(deadline_factor=3.0, ewma_alpha=0.2, min_samples=5)
        flags = [m.observe(d) for d in durations]
        traces.append((flags, m._ewma, m._n, m.stragglers_detected))
    assert traces[0] == traces[1]
    assert sum(traces[0][0]) == traces[0][3] > 0

    # run_with_mitigation re-dispatches a step that blows the deadline, once.
    # Each call of the step takes its duration from ``durations`` on a
    # virtual clock.
    counts = []
    for mod in (fault, jax_fault):
        clock = [0.0]
        monkeypatch.setattr(mod.time, "perf_counter", lambda: clock[0])
        steps = iter([1.0] * 5 + [1.0, 5.0, 1.0, 1.0])

        def step(x):
            clock[0] += next(steps)
            return x * 2

        m = mod.StragglerMitigator(min_samples=5)
        outs = [m.run_with_mitigation(step, i) for i in range(8)]
        counts.append((outs, m.redispatches, m.stragglers_detected))
    assert counts[0] == counts[1]
    assert counts[0][0] == [2 * i for i in range(8)] and counts[0][1] == 1


def test_maintenance_timeout_retries_bit_identical():
    g = _fs()
    ref = PartitionedGraphService(g, 4, didic=FAST_DIDIC, device="cpu").partition_didic(seed=0)
    ref.maintain()
    svc = PartitionedGraphService(g, 4, didic=FAST_DIDIC, device="cpu").partition_didic(seed=0)
    svc.fault_plan = FaultPlan().timeout_maintenance(0, times=2)
    svc.fault_plan.begin_slice(0)
    sleeps = []
    svc.retry_policy = RetryPolicy(max_retries=5, sleep=sleeps.append)
    svc.maintain()
    np.testing.assert_array_equal(svc.parts, ref.parts)
    assert torch.equal(svc.runtime.state.w, ref.runtime.state.w)
    assert svc.logger.maintenance_retries == 2 and len(sleeps) == 2
    assert svc.logger.health_report()["maintenance_retries"] == 2


def test_maintenance_retry_budget_exhaustion_raises():
    g = _fs()
    svc = PartitionedGraphService(g, 4, didic=FAST_DIDIC, device="cpu").partition_didic(seed=0)
    svc.fault_plan = FaultPlan().timeout_maintenance(0, times=10)
    svc.fault_plan.begin_slice(0)
    svc.retry_policy = RetryPolicy(max_retries=2, **NO_SLEEP)
    before = svc.parts.copy()
    with pytest.raises(RecoveryDeadlineExceeded):
        svc.maintain()
    with pytest.raises(MaintenanceTimeout):  # the 4th scheduled timeout, unretried
        svc.fault_plan.fire("maintain")
    np.testing.assert_array_equal(svc.parts, before)  # nothing applied


def test_logger_health_and_reset_match_jax():
    ours, ref = RuntimeLogger(2), jax_framework.RuntimeLogger(2)
    for lg in (ours, ref):
        lg.record_degraded(10)
        lg.record_maintenance_retries(2, 0.5)
        lg.record_recovery(1.0)
        lg.record_recovery(0.25)
    assert ours.health_report() == ref.health_report()
    assert list(ours.health_report()) == list(ref.health_report())
    ours.reset()
    assert all(v == 0 for v in ours.health_report().values())


# ---------------------------------------------------------------------------
# Write-ahead dynamism journal
# ---------------------------------------------------------------------------
def _service(g):
    svc = PartitionedGraphService(g, 4, device="cpu")
    return svc.partition_with(partitioners.random_partition(g.n_nodes, 4, seed=0))


def test_wal_crash_rolls_back_then_applies_exactly_once():
    g = _fs()
    svc = _service(g)
    svc.journal = journal = DynamismJournal()
    log = InsertPartitioner("random", 4, seed=0).allocate(svc.parts, 0.05, insert_rate=0.5,
                                                          graph=svc.graph)
    svc.fault_plan = plan = FaultPlan().crash(0, site="apply:pre_commit")
    plan.begin_slice(0)
    parts_before = svc.parts.copy()
    with pytest.raises(SimulatedCrash):
        svc.apply_dynamism(log)
    entry = journal.entries[log.fingerprint()]
    assert entry.status == "pending"              # intent written ahead of validation
    assert svc.graph is g                         # atomic: nothing mutated
    np.testing.assert_array_equal(svc.parts, parts_before)
    assert journal.rollback_pending() == 1 and entry.status == "aborted"
    svc.apply_dynamism(log)                       # the retry revives the entry
    assert entry.status == "committed" and entry.seq == 0
    grown = svc.graph.n_nodes
    assert grown == g.n_nodes + log.n_new_vertices
    svc.apply_dynamism(log)                       # a committed fingerprint is a no-op
    assert svc.graph.n_nodes == grown and len(journal.entries) == 1


def test_validation_failure_marks_aborted():
    g = datasets.load("gis", scale=0.001, seed=0)
    svc = _service(g)
    svc.journal = journal = DynamismJournal()
    bad = DynamismLog(
        vertices=np.array([1]), targets=np.array([1], np.int32), method="random", k=4,
        insert_senders=np.array([0]), insert_receivers=np.array([g.n_nodes - 1]),
        insert_weights=np.array([1e-8], np.float32),  # below the straight line
    )
    with pytest.raises(ValueError, match="straight-line"):
        svc.apply_dynamism(bad)
    assert journal.entries[bad.fingerprint()].status == "aborted"
    assert svc.graph is g and bad.fingerprint() not in svc._applied_dynamism


def _journaled_service(g, n=4):
    svc = _service(g)
    svc.journal = journal = DynamismJournal()
    ip = InsertPartitioner("random", 4, seed=0)
    for i in range(n):
        journal.mark_slice(i)
        svc.apply_dynamism(ip.allocate(svc.parts, 0.03, insert_rate=0.5 if i % 2 else 0.0,
                                       graph=svc.graph))
    return svc, journal


def test_replay_journal_is_idempotent():
    g = _fs()
    svc, journal = _journaled_service(g, n=3)
    fresh = _service(g)
    fresh.journal = journal
    assert replay_journal(fresh, journal) == 3
    assert graph_fingerprint(fresh.graph) == graph_fingerprint(svc.graph)
    np.testing.assert_array_equal(fresh.parts, svc.parts)
    assert replay_journal(fresh, journal) == 0


def test_journal_serialization_and_compaction():
    g = _fs()
    _, journal = _journaled_service(g)
    restored = DynamismJournal.from_bytes(journal.to_bytes())
    assert [e.seq for e in restored.entries.values()] == [0, 1, 2, 3]
    for fp, e in journal.entries.items():
        r = restored.entries[fp]
        assert (r.status, r.slice_index) == (e.status, e.slice_index)
        assert r.log.fingerprint() == fp
    assert restored.compact(before_slice=2) == 2
    assert [e.slice_index for e in restored.entries.values()] == [2, 3]
    with np.load(io.BytesIO(journal.to_bytes())) as z:
        payload = {k: z[k] for k in z.files}
    meta = json.loads(bytes(payload["__meta__"]).decode())
    meta["entry0"]["status"] = "pending"  # tamper, keeping the stored checksum
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **payload)
    with pytest.raises(SnapshotIntegrityError, match="journal checksum"):
        DynamismJournal.from_bytes(buf.getvalue())


def _entries(journal):
    return [(fp, e.seq, e.status, e.slice_index, e.log.fingerprint())
            for fp, e in journal.entries.items()]


def test_journal_bytes_cross_decode_with_jax():
    """A journal the JAX package wrote decodes in the port and the reverse,
    every entry with its status, slice and log fingerprint."""
    g, jg = _fs(), jax_datasets.load("filesystem", scale=0.001, seed=1)
    svc, journal = _journaled_service(g)
    jsvc = jax_framework.PartitionedGraphService(jg, 4)
    jsvc.partition_with(partitioners.random_partition(g.n_nodes, 4, seed=0))
    jsvc.journal = jjournal = jax_recovery.DynamismJournal()
    ip = jax_framework.InsertPartitioner("random", 4, seed=0)
    for i in range(4):
        jjournal.mark_slice(i)
        jsvc.apply_dynamism(ip.allocate(jsvc.parts, 0.03, insert_rate=0.5 if i % 2 else 0.0,
                                        graph=jsvc.graph))
    jjournal.rollback_pending()
    assert _entries(journal) == _entries(jjournal)
    from_jax = DynamismJournal.from_bytes(jjournal.to_bytes())
    to_jax = jax_recovery.DynamismJournal.from_bytes(journal.to_bytes())
    assert _entries(from_jax) == _entries(journal) == _entries(to_jax)
    assert (from_jax._next_seq, from_jax._current_slice) == (4, 3)
    # The decoded JAX journal rebuilds the port's service.
    fresh = _service(g)
    assert replay_journal(fresh, from_jax) == 4
    assert graph_fingerprint(fresh.graph) == graph_fingerprint(svc.graph)
    np.testing.assert_array_equal(fresh.parts, svc.parts)


# ---------------------------------------------------------------------------
# graph_fingerprint and snapshots
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["filesystem", "gis", "twitter"])
def test_graph_fingerprint_matches_jax(name):
    g, jg = datasets.load(name, scale=0.001), jax_datasets.load(name, scale=0.001)
    assert graph_fingerprint(g) == jax_recovery.graph_fingerprint(jg)
    log = InsertPartitioner("random", 4, seed=3).allocate(
        np.zeros(g.n_nodes, np.int32), 0.1, insert_rate=0.5, graph=g)
    grow = (log.n_new_vertices, log.insert_attrs, log.insert_senders, log.insert_receivers,
            log.insert_weights)
    assert (graph_fingerprint(g.with_vertices(*grow))
            == jax_recovery.graph_fingerprint(jg.with_vertices(*grow)))
    assert graph_fingerprint(g.with_vertices(*grow)) != graph_fingerprint(g)


def test_capture_restore_resume_bit_exact():
    """Snapshot at a slice boundary, restore into a fresh runtime, finish
    the run: every slice equals the uninterrupted run."""
    g = _fs()
    make = _runtime_factory(g)
    ops = generate_ops(g, n_ops=120, seed=3)
    kw = dict(maintain_every=2)
    base, ref = _uninterrupted(make, ops, 6, 0.05, 0.4, **kw)
    rt = make()
    rt.begin(ops)
    for i in range(2):
        rt.run_slice(i, ops, 0.05, insert_rate=0.4, **kw)
    snap = ServiceSnapshot.from_bytes(ServiceSnapshot.capture(rt, g, next_slice=2).to_bytes())
    store = rt.service.graph.store
    assert snap.meta["store"] == {
        "n_cap": store.n_cap, "e_cap": store.e_cap, "base_nodes": store.base_nodes,
        "base_edges": store.base_edges, "compactions": store.compactions,
        "headroom": store.headroom,
    }
    assert snap.next_slice == 2 and snap.meta["has_didic"]
    rt2 = make()
    snap.restore_into(rt2, g)
    state, want = rt2.service.runtime.state, rt.service.runtime.state
    for f in ("w", "l", "parts", "beta"):
        assert getattr(state, f).device == rt2.service.device
        assert torch.equal(getattr(state, f), getattr(want, f)), f
    for i in range(2, 6):
        _, res = rt2.run_slice(i, ops, 0.05, insert_rate=0.4, **kw)
        _assert_results_equal(base[i], res, f"slice {i}")
    out = rt2.result()
    np.testing.assert_array_equal(ref.parts, out.parts)
    assert ref.records == out.records


def test_snapshot_keys_match_jax():
    """The same run in both packages snapshots under the same meta keys and
    array names, with equal graph deltas and loop state."""
    g, jg = _fs(), jax_datasets.load("filesystem", scale=0.001, seed=1)
    parts0 = np.asarray(jax_framework.PartitionedGraphService(
        jg, 4, didic=JaxDidicConfig(k=4, iterations=6)).partition_didic(seed=0).parts)
    svc = PartitionedGraphService(g, 4, didic=FAST_DIDIC, device="cpu").partition_with(parts0.copy())
    jsvc = jax_framework.PartitionedGraphService(jg, 4, didic=JaxDidicConfig(k=4, iterations=6))
    jsvc.partition_with(parts0.copy())
    ops, jops = generate_ops(g, n_ops=60, seed=3), jax_generate_ops(jg, n_ops=60, seed=3)
    snaps = []
    for rt, o, base in ((DynamicExperimentRuntime(svc, "least_traffic", seed=7), ops, g),
                        (JaxRuntime(jsvc, "least_traffic", seed=7), jops, jg)):
        rt.begin(o)
        for i in range(2):
            rt.run_slice(i, o, 0.05, insert_rate=0.5, maintain_every=5)
        cls = ServiceSnapshot if rt.service is svc else jax_recovery.ServiceSnapshot
        snaps.append(cls.capture(rt, base, next_slice=2))
    ours, ref = snaps
    assert sorted(ours.meta) == sorted(ref.meta) and sorted(ours.arrays) == sorted(ref.arrays)
    for key in ref.meta:
        if key not in ("checksum", "health"):
            assert ours.meta[key] == ref.meta[key], key
    assert ours.meta["store"] is not None and ours.meta["store"] == ref.meta["store"]
    assert ours.meta["health"].keys() == ref.meta["health"].keys()
    for name in ref.arrays:
        np.testing.assert_array_equal(ours.arrays[name], ref.arrays[name], err_msg=name)
        assert ours.arrays[name].dtype == ref.arrays[name].dtype, name


def test_checksum_version_and_base_guards():
    g = _fs()
    rt = _runtime_factory(g)()
    ops = generate_ops(g, n_ops=60, seed=3)
    rt.begin(ops)
    rt.run_slice(0, ops, 0.05, insert_rate=0.5)
    snap = ServiceSnapshot.capture(rt, g, next_slice=1)
    snap.verify()
    blob = snap.to_bytes()
    loaded = ServiceSnapshot.from_bytes(blob)
    assert loaded.meta["checksum"] == snap.meta["checksum"]
    loaded.arrays["parts"] = loaded.arrays["parts"].copy()
    loaded.arrays["parts"][0] += 1  # bit rot
    with pytest.raises(SnapshotIntegrityError, match="checksum"):
        loaded.verify()
    with pytest.raises(SnapshotIntegrityError, match="checksum"):
        loaded.restore_into(_runtime_factory(g)(), g)
    stale = ServiceSnapshot.from_bytes(blob)
    stale.meta["version"] = 99
    with pytest.raises(SnapshotIntegrityError, match="version"):
        stale.verify()
    with pytest.raises(SnapshotIntegrityError, match="base graph"):
        ServiceSnapshot.from_bytes(blob).rebuild_graph(datasets.load("filesystem", scale=0.001, seed=2))
    with pytest.raises(SnapshotIntegrityError, match="k="):
        other = DynamicExperimentRuntime(PartitionedGraphService(g, 2, device="cpu"))
        ServiceSnapshot.from_bytes(blob).restore_into(other, g)


def test_placement_snapshot_roundtrip_bit_exact():
    """At capacity > 0 the snapshot carries the hot table, its epoch and
    the per-vertex traffic: a restored service routes replica reads alike."""
    g = _fs()
    make = _runtime_factory(g, capacity=8)
    ops = generate_ops(g, n_ops=60, seed=3)
    rt = make()
    rt.begin(ops)
    rt.run_slice(0, ops, 0.05, insert_rate=0.3)
    assert rt.service.refresh_placement().size > 0
    snap = ServiceSnapshot.from_bytes(ServiceSnapshot.capture(rt, g, next_slice=1).to_bytes())
    rt2 = make()
    snap.restore_into(rt2, g)
    p1, p2 = rt.service.placement, rt2.service.placement
    assert p2.capacity == p1.capacity == 8 and p2.replica_epoch == p1.replica_epoch > 0
    np.testing.assert_array_equal(p2.hot, p1.hot)
    np.testing.assert_array_equal(p2.owner, p1.owner)
    np.testing.assert_array_equal(p2.replicated_mask(), p1.replicated_mask())
    np.testing.assert_array_equal(rt2.service.logger.vertex_traffic, rt.service.logger.vertex_traffic)
    _, a = rt.run_slice(1, ops, 0.05, insert_rate=0.3)
    _, b = rt2.run_slice(1, ops, 0.05, insert_rate=0.3)
    _assert_results_equal(a, b, "slice after restore")


def test_rebuild_graph_is_bit_exact_growth():
    g = _fs()
    rt = _runtime_factory(g)()
    ops = generate_ops(g, n_ops=60, seed=3)
    rt.begin(ops)
    for i in range(2):
        rt.run_slice(i, ops, 0.05, insert_rate=0.5)
    grown = rt.service.graph
    assert grown.n_nodes > g.n_nodes
    rebuilt = ServiceSnapshot.from_bytes(
        ServiceSnapshot.capture(rt, g, next_slice=2).to_bytes()).rebuild_graph(g)
    assert rebuilt.n_nodes == grown.n_nodes
    for field in ("senders", "receivers", "edge_weight"):
        np.testing.assert_array_equal(getattr(rebuilt, field), getattr(grown, field), err_msg=field)
        assert getattr(rebuilt, field).dtype == getattr(grown, field).dtype
    assert sorted(rebuilt.node_attrs) == sorted(grown.node_attrs)
    for key in grown.node_attrs:
        np.testing.assert_array_equal(rebuilt.node_attrs[key], grown.node_attrs[key], err_msg=key)
    assert graph_fingerprint(rebuilt) == graph_fingerprint(grown)


# ---------------------------------------------------------------------------
# Recovered runs
# ---------------------------------------------------------------------------
def test_recovered_run_bit_exact_vs_uninterrupted():
    """Pre-commit and post-commit crashes and a maintenance timeout: after
    snapshot, restore and journal replay, all four counters equal the
    uninterrupted run on every slice."""
    g = _fs()
    make = _runtime_factory(g)
    ops = generate_ops(g, n_ops=120, seed=3)
    kw = dict(maintain_every=2)
    base, ref = _uninterrupted(make, ops, 6, 0.05, 0.3, **kw)
    plan = (FaultPlan().crash(1, site="apply:pre_commit").crash(4, site="apply:post_commit")
            .timeout_maintenance(3, times=1))
    got, out, stats = _recovered(make, g, ops, 6, 0.05, plan, journal=DynamismJournal(),
                                 snapshot_every=2, insert_rate=0.3, **kw)
    assert stats.recoveries == 2 and stats.resumed_from == [0, 4]
    assert stats.journal_rolled_back >= 1 and stats.journal_replayed >= 1
    assert len(stats.restore_s) == 2 and len(stats.snapshot_bytes) == stats.snapshots_taken == 3
    for i in range(6):
        _assert_results_equal(base[i], got[i], f"slice {i}")
    np.testing.assert_array_equal(ref.parts, out.parts)
    assert ref.records == out.records
    _assert_results_equal(ref.final, out.final, "final")


def test_pre_validate_crash_rolls_back_and_recovers():
    g = _fs()
    make = _runtime_factory(g)
    ops = generate_ops(g, n_ops=60, seed=3)
    kw = dict(maintain_every=2)
    base, ref = _uninterrupted(make, ops, 4, 0.05, 0.4, **kw)
    got, out, stats = _recovered(make, g, ops, 4, 0.05,
                                 FaultPlan().crash(1, site="apply:pre_validate"),
                                 snapshot_every=2, insert_rate=0.4, **kw)
    assert stats.recoveries == 1 and stats.journal_rolled_back >= 1
    for i in range(4):
        _assert_results_equal(base[i], got[i], f"slice {i}")
    np.testing.assert_array_equal(ref.parts, out.parts)
    assert ref.records == out.records


def test_recovery_budget_exhaustion_reraises():
    g = _fs()
    ops = generate_ops(g, n_ops=60, seed=3)
    with pytest.raises(SimulatedCrash):
        run_with_recovery(_runtime_factory(g), g, ops, 3, 0.05,
                          fault_plan=FaultPlan().crash(0).crash(1), max_recoveries=1)


def test_chaos_soak_bit_exact_with_bounded_journal():
    """14 slices of mixed move and vertex-growth churn under crashes at
    every apply site and at replay, and maintenance timeouts."""
    g = _fs()
    make = _runtime_factory(g)
    ops = generate_ops(g, n_ops=80, seed=5)
    n = 14
    rate = lambda i: 0.5 if i % 4 == 1 else 0.0  # noqa: E731 — deterministic in i
    kw = dict(maintain_every=3)
    base, ref = _uninterrupted(make, ops, n, 0.02, rate, **kw)
    plan = (FaultPlan().crash(1, site="apply:pre_commit").crash(5, site="apply:post_commit")
            .crash(7, site="replay").crash(9, site="apply:pre_validate")
            .timeout_maintenance(8, times=2).timeout_maintenance(11, times=1))
    journal = DynamismJournal()
    got, out, stats = _recovered(make, g, ops, n, 0.02, plan, journal=journal,
                                 snapshot_every=4, insert_rate=rate, **kw)
    assert stats.recoveries == 4
    assert stats.journal_rolled_back >= 2 and stats.journal_replayed >= 1
    for i in range(n):
        _assert_results_equal(base[i], got[i], f"slice {i}")
    np.testing.assert_array_equal(ref.parts, out.parts)
    assert ref.records == out.records
    assert stats.journal_compacted > 0 and len(journal.entries) <= 4 + 2


def test_recovered_run_matches_jax_recovered_run():
    """With the JAX DiDiC map injected and no maintenance (``maintain_every``
    past the last slice), the port's recovered run equals the JAX package's
    recovered run on every slice, growth included."""
    g, jg = _fs(), jax_datasets.load("filesystem", scale=0.001, seed=1)
    jcfg = JaxDidicConfig(k=4, iterations=6)
    parts0 = np.asarray(jax_framework.PartitionedGraphService(jg, 4, didic=jcfg)
                        .partition_didic(seed=0).parts)

    def make():
        svc = PartitionedGraphService(g, 4, didic=FAST_DIDIC, device="cpu")
        return DynamicExperimentRuntime(svc.partition_with(parts0.copy()), "least_traffic", seed=7)

    def jmake():
        svc = jax_framework.PartitionedGraphService(jg, 4, didic=jcfg)
        return JaxRuntime(svc.partition_with(parts0.copy()), "least_traffic", seed=7)

    def plan(mod):
        return (mod.FaultPlan().crash(1, site="apply:pre_commit")
                .crash(3, site="apply:post_commit").crash(4, site="replay"))

    kw = dict(maintain_every=6, snapshot_every=2, insert_rate=0.3)
    got, out, stats = _recovered(make, g, generate_ops(g, n_ops=80, seed=3), 5, 0.05,
                                 plan(fault), **kw)
    want = {}
    jout, jstats = jax_recovery.run_with_recovery(
        jmake, jg, jax_generate_ops(jg, n_ops=80, seed=3), 5, 0.05, fault_plan=plan(jax_fault),
        retry_policy=jax_fault.RetryPolicy(**NO_SLEEP),
        on_slice=lambda i, r: want.__setitem__(i, r), **kw)
    assert stats.recoveries == jstats.recoveries == 3
    assert stats.resumed_from == jstats.resumed_from
    for i in range(5):
        _assert_results_equal(got[i], want[i], f"slice {i}")
    assert [vars(r) for r in out.records] == [vars(r) for r in jout.records]
    np.testing.assert_array_equal(out.parts, jout.parts)
    assert sum(r.inserted for r in out.records) > 0


# ---------------------------------------------------------------------------
# Meshless shard failures
# ---------------------------------------------------------------------------
def test_shard_failures_change_nothing_without_a_mesh():
    g = _fs()
    make = _runtime_factory(g)
    ops = generate_ops(g, n_ops=60, seed=3)
    base, ref = _uninterrupted(make, ops, 3, 0.05, 0.3, maintain_every=2)
    got, out, stats = _recovered(make, g, ops, 3, 0.05,
                                 FaultPlan().fail_shard(0, shard=0, slices=3),
                                 maintain_every=2, insert_rate=0.3)
    assert stats.recoveries == 0
    for i in range(3):
        _assert_results_equal(base[i], got[i], f"slice {i}")
    assert ref.records == out.records
    health = make().service.logger.health_report()
    assert health["degraded_replays"] == health["degraded_ops"] == 0
    # As in the JAX package: a meshless service records a failed shard and
    # replays as before, counting nothing degraded.
    svc = make().service
    before = svc.run_ops(ops)
    svc.mark_shard_failed(0)
    assert svc.failed_shards == {0}
    _assert_results_equal(before, svc.run_ops(ops), "meshless replay, shard 0 marked failed")
    assert svc.logger.health_report()["degraded_replays"] == 0


def test_no_plan_no_journal_is_the_plain_service():
    """With nothing attached the fault hooks change no counter: a plain run
    equals one with an empty plan and a journal."""
    g = _fs()
    make = _runtime_factory(g)
    ops = generate_ops(g, n_ops=60, seed=3)
    base, ref = _uninterrupted(make, ops, 3, 0.05, 0.3, maintain_every=2)
    got, out, stats = _recovered(make, g, ops, 3, 0.05, FaultPlan(), journal=DynamismJournal(),
                                 maintain_every=2, insert_rate=0.3)
    for i in range(3):
        _assert_results_equal(base[i], got[i], f"slice {i}")
    assert ref.records == out.records and stats.recoveries == 0
