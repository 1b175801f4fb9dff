"""Port parity for the graph side's remaining options and utilities,
against the JAX package on the CPU.

Held against the JAX package, bit for bit: ``DynamicExperimentRuntime``
with a caller's ``scheduler`` (one that rejects plans) and its
``last_result`` after ``begin`` and after every slice, the JAX run's
maintained maps injected; ``BackgroundMaintenance`` with its own
``scheduler``; ``OnlineServer.run(supervise=False)`` raising at the JAX
server's tick and then serving the rest; ``Graph.subgraph``,
``Graph.clustering_stats``, ``BlockEll.density``/``to_dense``,
``PaddedNeighbors.max_deg``, ``TrafficResult.sorted_percent_global`` and
``frontier_gather_ref``'s ``mask``. Held within the port:
``run_with_recovery(snapshot_roundtrip=False)`` against the uninterrupted
run and the round-tripped one, an in-memory snapshot's independence from
the live runtime, ``last_result`` across a snapshot restore, and the
replay CLI's ``--force-host-devices`` against its one-rank run.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import fault as jax_fault
from repro.core import framework as jax_framework
from repro.core import online as jax_online
from repro.core.didic import DidicConfig as JaxDidicConfig
from repro.core.dynamic_runtime import DynamicExperimentRuntime as JaxRuntime
from repro.core.traffic import execute_ops as jax_execute_ops
from repro.core.traffic import generate_ops as jax_generate_ops
from repro.graphs import datasets as jax_datasets
from repro.graphs.structure import padded_neighbors as jax_padded_neighbors
from repro.kernels.frontier.ref import frontier_gather_ref as jax_frontier_gather_ref
from repro_torch.core import partitioners
from repro_torch.core.didic import DidicConfig
from repro_torch.core.dynamic_runtime import DynamicExperimentRuntime
from repro_torch.core.fault import FaultPlan, RetryPolicy, SimulatedCrash
from repro_torch.core.framework import MigrationScheduler, PartitionedGraphService
from repro_torch.core.online import BackgroundMaintenance, OnlineServer, make_arrival_stream
from repro_torch.core.recovery import DynamismJournal, ServiceSnapshot, run_with_recovery
from repro_torch.core.traffic import execute_ops, generate_ops
from repro_torch.graphs import datasets
from repro_torch.graphs.structure import padded_neighbors
from repro_torch.kernels.frontier.ref import frontier_gather_ref

# The suite runs in several worker processes at once; one intra-op thread
# each keeps PyTorch from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
COUNTERS = ("per_op_total", "per_op_global", "per_partition", "per_vertex")
FAST_DIDIC = DidicConfig(k=4, iterations=6)
JAX_FAST_DIDIC = JaxDidicConfig(k=4, iterations=6)
GENERATORS = ("filesystem", "gis", "twitter")
CLASSES = ("filesystem", "twitter")


def _assert_results_equal(a, b, ctx=""):
    for f in COUNTERS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                      err_msg=f"{ctx}: {f}")


def _fs():
    return datasets.load("filesystem", scale=0.001, seed=1)


def _jax_fs():
    return jax_datasets.load("filesystem", scale=0.001, seed=1)


def _jax_parts(jg):
    svc = jax_framework.PartitionedGraphService(jg, 4, didic=JAX_FAST_DIDIC)
    return np.asarray(svc.partition_didic(seed=0).parts)


def _recording(jsvc):
    """Keep a copy of every map the JAX service's DiDiC maintenance returns."""
    maps = []
    inner = jsvc.runtime.maintain

    def maintain(*a, **kw):
        out = inner(*a, **kw)
        maps.append(np.array(out, copy=True))
        return out

    jsvc.runtime.maintain = maintain
    return maps


def _inject(svc, maps):
    """Serve the JAX run's maintained maps, in order, as the port's DiDiC."""
    supply = iter(maps)
    svc.runtime.maintain = lambda *a, **kw: next(supply).copy()
    return supply


# ---------------------------------------------------------------------------
# DynamicExperimentRuntime(scheduler=) and last_result
# ---------------------------------------------------------------------------
SCHED_RUN = dict(amount=0.05, maintain_every=1)
SCHED_SLICES = 5


def test_runtime_scheduler_and_last_result_match_jax():
    """A scheduler that migrates only plans moving at least 5 % of the
    vertices: the records, the scheduler's history and ``last_result``'s
    four counters after ``begin`` and after every slice equal the JAX
    runtime's with the same scheduler, the JAX maintained maps injected."""
    g, jg = _fs(), _jax_fs()
    parts0 = _jax_parts(jg)
    ops, jops = generate_ops(g, n_ops=80, seed=3), jax_generate_ops(jg, n_ops=80, seed=3)

    jsvc = jax_framework.PartitionedGraphService(jg, 4, didic=JAX_FAST_DIDIC)
    jsvc.partition_with(parts0.copy())
    maps = _recording(jsvc)
    jrt = JaxRuntime(jsvc, "least_traffic", seed=7,
                     scheduler=jax_framework.MigrationScheduler(min_move_fraction=0.05))
    svc = PartitionedGraphService(g, 4, didic=FAST_DIDIC, device="cpu").partition_with(parts0.copy())
    scheduler = MigrationScheduler(min_move_fraction=0.05)
    rt = DynamicExperimentRuntime(svc, "least_traffic", seed=7, scheduler=scheduler)
    assert rt.scheduler is scheduler and rt.last_result is None
    assert DynamicExperimentRuntime(svc).scheduler.min_move_fraction == 0.0

    want_last = [jrt.begin(jops)]
    for i in range(SCHED_SLICES):
        jrt.run_slice(i, jops, **SCHED_RUN)
        want_last.append(jrt.last_result)
    assert len(maps) == SCHED_SLICES
    supply = _inject(svc, maps)
    rt.begin(ops)
    _assert_results_equal(rt.last_result, want_last[0], "after begin")
    for i in range(SCHED_SLICES):
        rt.run_slice(i, ops, **SCHED_RUN)
        _assert_results_equal(rt.last_result, want_last[i + 1], f"slice {i}")
    assert next(supply, None) is None
    got, want = rt.result(), jrt.result()
    assert [vars(r) for r in got.records] == [vars(r) for r in want.records]
    assert scheduler.history == jrt.scheduler.history
    migrated = [r.migrated for r in got.records]
    assert 0 in migrated and any(m > 0 for m in migrated), migrated
    # A rejected plan is one the scheduler never recorded.
    assert len(scheduler.history) < SCHED_SLICES
    np.testing.assert_array_equal(got.parts, np.asarray(want.parts))


@pytest.mark.parametrize("roundtrip", [False, True], ids=["in_memory", "bytes"])
def test_last_result_survives_snapshot_restore(roundtrip):
    g = _fs()
    ops = generate_ops(g, n_ops=60, seed=3)

    def make():
        svc = PartitionedGraphService(g, 4, didic=FAST_DIDIC, device="cpu")
        return DynamicExperimentRuntime(svc.partition_didic(seed=0), "least_traffic", seed=7)

    rt = make()
    rt.begin(ops)
    for i in range(2):
        rt.run_slice(i, ops, 0.05)
    snap = ServiceSnapshot.capture(rt, g, next_slice=2)
    if roundtrip:
        snap = ServiceSnapshot.from_bytes(snap.to_bytes())
    fresh = make()
    assert fresh.last_result is None
    snap.restore_into(fresh, g)
    _assert_results_equal(fresh.last_result, rt.last_result, "restored")
    assert fresh.last_result is not rt.last_result
    # Both resume to the same next slice.
    _, a = rt.run_slice(2, ops, 0.05)
    _, b = fresh.run_slice(2, ops, 0.05)
    _assert_results_equal(a, b, "slice 2 after restore")


# ---------------------------------------------------------------------------
# run_with_recovery(snapshot_roundtrip=False)
# ---------------------------------------------------------------------------
def _runtime_factory(graph):
    def make():
        svc = PartitionedGraphService(graph, 4, didic=FAST_DIDIC, device="cpu")
        return DynamicExperimentRuntime(svc.partition_didic(seed=0), "least_traffic", seed=7)

    return make


def _uninterrupted(make, ops, n_slices, amount, rate, **kw):
    base = {}
    rt = make()
    rt.begin(ops)
    for i in range(n_slices):
        _, base[i] = rt.run_slice(i, ops, amount, insert_rate=rate, **kw)
    return base, rt.result()


def _recovered(make, graph, ops, n_slices, amount, plan, **kw):
    got = {}
    out, stats = run_with_recovery(
        make, graph, ops, n_slices, amount, fault_plan=plan,
        retry_policy=RetryPolicy(sleep=lambda s: None),
        on_slice=lambda i, r: got.__setitem__(i, r), **kw)
    return got, out, stats


# (plan, snapshot_every, maintain_every): the crash plan of
# tests/test_torch_recovery.py, and two crashes that restore one snapshot
# twice after slices that maintain (the DiDiC state and the maps change in
# place between them).
PLANS = {
    "pre_post_timeout": (lambda: FaultPlan().crash(1, site="apply:pre_commit")
                         .crash(4, site="apply:post_commit").timeout_maintenance(3, times=1), 2, 2),
    "one_snapshot_twice": (lambda: FaultPlan().crash(2, site="apply:post_commit")
                           .crash(3, site="replay"), 6, 1),
}


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_in_memory_snapshots_recover_bit_exact(plan):
    make_plan, every, maintain_every = PLANS[plan]
    g = _fs()
    make = _runtime_factory(g)
    ops = generate_ops(g, n_ops=120, seed=3)
    kw = dict(maintain_every=maintain_every)
    base, ref = _uninterrupted(make, ops, 6, 0.05, 0.3, **kw)
    legs = {}
    for roundtrip in (True, False):
        legs[roundtrip] = _recovered(make, g, ops, 6, 0.05, make_plan(), journal=DynamismJournal(),
                                     snapshot_every=every, insert_rate=0.3,
                                     snapshot_roundtrip=roundtrip, **kw)
    (got_b, out_b, stats_b), (got_m, out_m, stats_m) = legs[True], legs[False]
    assert stats_m.recoveries == stats_b.recoveries == 2
    assert stats_m.resumed_from == stats_b.resumed_from
    assert (stats_m.journal_rolled_back, stats_m.journal_replayed, stats_m.snapshots_taken) == \
           (stats_b.journal_rolled_back, stats_b.journal_replayed, stats_b.snapshots_taken)
    assert stats_m.snapshot_bytes == [] and len(stats_b.snapshot_bytes) == stats_b.snapshots_taken
    assert len(stats_m.capture_s) == stats_m.snapshots_taken and len(stats_m.restore_s) == 2
    for i in range(6):
        _assert_results_equal(got_m[i], base[i], f"in memory, slice {i}")
        _assert_results_equal(got_m[i], got_b[i], f"in memory against bytes, slice {i}")
    for out in (out_m, out_b):
        np.testing.assert_array_equal(out.parts, ref.parts)
        assert out.records == ref.records
        _assert_results_equal(out.final, ref.final, "final")


def test_in_memory_snapshot_shares_nothing_with_the_runtime():
    """A snapshot captured in memory still verifies, and restores the
    captured state, after the runtime ran on and changed its maps, DiDiC
    state, counters and graph in place."""
    g = _fs()
    make = _runtime_factory(g)
    ops = generate_ops(g, n_ops=60, seed=3)
    rt = make()
    rt.begin(ops)
    rt.run_slice(0, ops, 0.05, insert_rate=0.3)
    snap = ServiceSnapshot.capture(rt, g, next_slice=1)
    blob = snap.to_bytes()
    for i in range(1, 4):  # no growth: the counters accumulate in place
        rt.run_slice(i, ops, 0.05)
    snap.verify()
    assert snap.to_bytes() == blob
    a, b = make(), make()
    snap.restore_into(a, g)
    a.run_slice(1, ops, 0.05)  # mutates what the restore gave it
    snap.restore_into(b, g)
    snap.verify()
    ref = ServiceSnapshot.from_bytes(blob)
    c = make()
    ref.restore_into(c, g)
    np.testing.assert_array_equal(b.service.parts, c.service.parts)
    np.testing.assert_array_equal(b.service.runtime.state.w.numpy(), c.service.runtime.state.w.numpy())
    _assert_results_equal(b.last_result, c.last_result, "restored twice")


# ---------------------------------------------------------------------------
# BackgroundMaintenance(scheduler=) and OnlineServer.run(supervise=False)
# ---------------------------------------------------------------------------
def _graph():
    return datasets.load("filesystem", scale=0.001, seed=1).with_vertices(1)


def _jax_graph():
    return jax_datasets.load("filesystem", scale=0.001, seed=1).with_vertices(1)


def _served(res):
    return ({cls: np.asarray(v) for cls, v in res.per_op.items()}, res.per_partition,
            res.per_vertex, res.ticks, res.ops_served, res.batches_served, res.latency,
            res.health, [{cls: list(map(tuple, ops)) for cls, ops in e["ops"].items()}
                         for e in res.epochs],
            [np.asarray(e["parts"]) for e in res.epochs])


def _assert_served_equal(a, b, ctx=""):
    (op_a, pp_a, pv_a, *rest_a, parts_a), (op_b, pp_b, pv_b, *rest_b, parts_b) = _served(a), _served(b)
    assert sorted(op_a) == sorted(op_b), ctx
    for cls in op_a:
        np.testing.assert_array_equal(op_a[cls], op_b[cls], err_msg=f"{ctx} {cls}")
    np.testing.assert_array_equal(pp_a, pp_b, err_msg=ctx)
    np.testing.assert_array_equal(pv_a, pv_b, err_msg=ctx)
    assert rest_a == rest_b, ctx
    assert len(parts_a) == len(parts_b), ctx
    for x, y in zip(parts_a, parts_b):
        np.testing.assert_array_equal(x, y, err_msg=ctx)


BG = dict(every=3, budget_iterations=1, round_iterations=2)


def test_background_maintenance_scheduler_matches_jax():
    """A caller's scheduler plans, commits and records the background
    rounds; the service's own scheduler keeps an empty history. With the
    JAX run's maintained maps injected, the served counters, epochs and
    both schedulers' histories equal the JAX server's."""
    g, jg = _graph(), _jax_graph()
    parts0 = _jax_parts(jg)
    kw = dict(seed=0, process="uniform", ops_per_tick=3)
    arrivals, t_counts = make_arrival_stream(g, CLASSES, 36, **kw)
    jarrivals, jt_counts = jax_online.make_arrival_stream(jg, CLASSES, 36, **kw)

    jsvc = jax_framework.PartitionedGraphService(jg, 4, didic=JAX_FAST_DIDIC)
    jsvc.partition_with(parts0.copy())
    maps = _recording(jsvc)
    jsched = jax_framework.MigrationScheduler(min_move_fraction=0.0)
    jserver = jax_online.OnlineServer(jsvc, batch_slots=4, queue_limit=16,
                                      maintenance=jax_online.BackgroundMaintenance(jsvc, jsched, **BG))
    jserver.submit_stream(jarrivals, jt_counts)
    want = jserver.run()

    svc = PartitionedGraphService(g, 4, didic=FAST_DIDIC, device="cpu").partition_with(parts0.copy())
    supply = _inject(svc, maps)
    sched = MigrationScheduler(min_move_fraction=0.0)
    bg = BackgroundMaintenance(svc, sched, **BG)
    assert bg.scheduler is sched
    server = OnlineServer(svc, batch_slots=4, queue_limit=16, maintenance=bg)
    server.submit_stream(arrivals, t_counts)
    got = server.run()

    assert next(supply, None) is None and bg.rounds_completed > 0
    _assert_served_equal(got, want, "background maintenance with a scheduler")
    assert len(got.epochs) > 1  # the rounds committed moves
    assert sched.history == jsched.history and len(sched.history) == bg.rounds_completed
    assert svc.scheduler.history == [] and jsvc.scheduler.history == []
    assert sched.baseline_percent_global == jsched.baseline_percent_global
    # Without one, the service's scheduler records the rounds.
    assert BackgroundMaintenance(svc, **BG).scheduler is svc.scheduler


@pytest.mark.parametrize("site,tick", [("serve:admit", 2), ("serve:commit", 4)])
def test_unsupervised_run_raises_then_resumes_like_jax(site, tick):
    """``run(supervise=False)`` lets the injected crash out at the JAX
    server's tick; a second ``run()`` serves the rest, equal to the clean
    leg and to the JAX server's second run."""
    g, jg = _graph(), _jax_graph()
    parts0 = _jax_parts(jg)
    kw = dict(seed=0, process="bursty", ops_per_tick=3)
    arrivals, t_counts = make_arrival_stream(g, CLASSES, 30, **kw)
    jarrivals, jt_counts = jax_online.make_arrival_stream(jg, CLASSES, 30, **kw)

    def server(plan):
        svc = PartitionedGraphService(g, 4, didic=FAST_DIDIC, device="cpu")
        svc.partition_with(parts0.copy())
        svc.fault_plan = plan
        s = OnlineServer(svc, batch_slots=4, queue_limit=8)
        s.submit_stream(arrivals, t_counts)
        return s

    clean = server(None).run(supervise=False)
    port = server(FaultPlan().crash(tick, site=site))
    with pytest.raises(SimulatedCrash):
        port.run(supervise=False)
    jsvc = jax_framework.PartitionedGraphService(jg, 4, didic=JAX_FAST_DIDIC)
    jsvc.partition_with(parts0.copy())
    jsvc.fault_plan = jax_fault.FaultPlan().crash(tick, site=site)
    jax_server = jax_online.OnlineServer(jsvc, batch_slots=4, queue_limit=8)
    jax_server.submit_stream(jarrivals, jt_counts)
    with pytest.raises(jax_fault.SimulatedCrash):
        jax_server.run(supervise=False)
    assert port.clock == jax_server.clock == tick
    assert (port.ops_served, port._queued, port._cursor) == \
           (jax_server.ops_served, jax_server._queued, jax_server._cursor)
    got, want = port.run(), jax_server.run()
    assert got.health["recoveries"] == want.health["recoveries"] == 0
    _assert_served_equal(got, want, "resumed against JAX")
    _assert_served_equal(got, clean, "resumed against the clean leg")


# ---------------------------------------------------------------------------
# The replay CLI's --force-host-devices
# ---------------------------------------------------------------------------
def _replay_cli(*args, timeout=180):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.replay", "--dataset", "gis",
                           "--scale", "0.002", "--n-ops", "50", *args],
                          capture_output=True, text=True, timeout=timeout, env=env, cwd=ROOT)


def test_force_host_devices_equals_the_one_rank_run():
    runs = {}
    for key, extra in (("one", ()), ("forced", ("--force-host-devices", "2"))):
        out = _replay_cli("--device", "cpu", "--degraded-check", *extra)
        assert out.returncode == 0, out.stderr[-3000:]
        lines = [line for line in out.stdout.splitlines() if line.startswith("{")]
        assert len(lines) == 1, out.stdout  # rank 0 alone prints
        runs[key] = json.loads(lines[0])
    one, forced = runs["one"], runs["forced"]
    assert (one["shards"], forced["shards"]) == (1, 2)
    for key in ("dataset", "pattern", "n_ops", "total_traffic", "percent_global", "verified"):
        assert forced[key] == one[key], key
    assert forced["verified"] and forced["degraded"]["degraded_replays"] == 1
    assert forced["degraded"]["degraded_ops"] == 25 and one["degraded"]["degraded_ops"] == 50


def test_force_host_devices_needs_the_cpu():
    out = _replay_cli("--device", "cuda", "--force-host-devices", "2", timeout=60)
    assert out.returncode != 0 and out.stdout == ""
    assert "--force-host-devices" in out.stderr and "--device cpu" in out.stderr


def test_force_host_devices_refuses_under_torchrun():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), WORLD_SIZE="2", RANK="0")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.replay", "--device", "cpu",
                          "--force-host-devices", "2"],
                         capture_output=True, text=True, timeout=60, env=env, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "torchrun" in out.stderr


# ---------------------------------------------------------------------------
# The graph and traffic utilities
# ---------------------------------------------------------------------------
def _graphs(name):
    return datasets.load(name, scale=0.002, seed=1), jax_datasets.load(name, scale=0.002, seed=1)


@pytest.mark.parametrize("name", GENERATORS)
def test_subgraph_matches_jax(name):
    g, jg = _graphs(name)
    mask = np.random.default_rng(5).random(g.n_nodes) < 0.6
    got, want = g.subgraph(mask), jg.subgraph(mask)
    assert (got.n_nodes, got.name) == (want.n_nodes, want.name) and got.name == f"{name}_sub"
    for f in ("senders", "receivers", "edge_weight"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)), err_msg=f)
    assert sorted(got.node_attrs) == sorted(want.node_attrs)
    for key, v in got.node_attrs.items():
        np.testing.assert_array_equal(v, want.node_attrs[key], err_msg=key)
    assert got.n_edges > 0 and got.n_nodes == int(mask.sum())


def test_subgraph_keeps_only_per_node_attributes():
    g = datasets.load("gis", scale=0.002, seed=1)
    g.node_attrs["bbox"] = np.zeros(4, np.float32)  # not per node
    sub = g.subgraph(np.arange(g.n_nodes) % 2 == 0)
    assert "bbox" not in sub.node_attrs and "lon" in sub.node_attrs
    assert sub.node_attrs["lon"].shape == (sub.n_nodes,)


@pytest.mark.parametrize("name", GENERATORS)
@pytest.mark.parametrize("sample,seed", [(200, 0), (10_000, 3)])
def test_clustering_stats_matches_jax(name, sample, seed):
    g, jg = _graphs(name)
    got = g.clustering_stats(sample=sample, seed=seed)
    assert got == jg.clustering_stats(sample=sample, seed=seed)
    assert 0.0 <= got <= 1.0


@pytest.mark.parametrize("name", GENERATORS)
@pytest.mark.parametrize("block_size", [32, 128])
def test_block_ell_density_and_dense_match_jax(name, block_size):
    g, jg = _graphs(name)
    got, want = g.to_block_ell(block_size), jg.to_block_ell(block_size)
    assert got.density() == want.density() and 0.0 < got.density() <= 1.0
    dense = got.to_dense()
    np.testing.assert_array_equal(dense, want.to_dense())
    assert dense.shape == (g.n_nodes, g.n_nodes)
    s, r, w = g.undirected
    np.testing.assert_allclose(dense[s, r], w, rtol=1e-6)


@pytest.mark.parametrize("name", GENERATORS)
@pytest.mark.parametrize("cap", [None, 3])
def test_padded_neighbors_max_deg_matches_jax(name, cap):
    g, jg = _graphs(name)
    got = padded_neighbors(*g.undirected, g.n_nodes, cap=cap)
    want = jax_padded_neighbors(*jg.undirected, jg.n_nodes, cap=cap)
    assert got.max_deg == want.max_deg == got.nbr.shape[1]
    if cap is not None:
        assert got.max_deg == cap and got.n_spill > 0


@pytest.mark.parametrize("name", GENERATORS)
def test_sorted_percent_global_matches_jax_on_a_replay(name):
    g, jg = _graphs(name)
    n_ops = 40 if name == "gis" else 200
    parts = partitioners.random_partition(g.n_nodes, 4, seed=0)
    got = execute_ops(g, generate_ops(g, n_ops=n_ops, seed=0), parts, 4, device="cpu")
    want = jax_execute_ops(jg, jax_generate_ops(jg, n_ops=n_ops, seed=0), parts, 4)
    curve = got.sorted_percent_global()
    np.testing.assert_array_equal(curve, np.asarray(want.sorted_percent_global()))
    assert curve.shape == (n_ops,) and np.all(np.diff(curve) <= 0)
    assert curve[0] <= 1.0 and curve[-1] >= 0.0


@pytest.mark.parametrize("mode", ["sum", "min"])
def test_frontier_gather_ref_mask_matches_jax(mode):
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    v, d, n, c = 37, 5, 50, 8
    x = rng.standard_normal((n, c)).astype(np.float32)
    nbr = rng.integers(0, n, (v, d)).astype(np.int32)
    w = rng.random((v, d)).astype(np.float32)
    mask = (rng.random((v, d)) < 0.7).astype(np.float32)
    got = frontier_gather_ref(torch.from_numpy(x), torch.from_numpy(nbr), torch.from_numpy(w),
                              torch.from_numpy(mask), mode=mode)
    want = jax_frontier_gather_ref(jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(w),
                                   jnp.asarray(mask), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
