"""Port parity for the online front-end (``core/online.py``) and the
``--arch graph`` launcher, against the JAX package with no mesh (as
``tests/test_online.py`` runs it).

Every comparison is bit-exact. Held against the JAX package: the arrival
streams of all three processes, the inert pads, the latency percentiles,
and, with the JAX DiDiC map injected and no maintenance, a whole
``OnlineRunResult`` (per-op, per-partition and per-vertex counters, ticks,
the latency report, the epochs' ops). Held within the port: online against
``offline_replay`` of its epochs, crash legs against clean legs.
"""

import numpy as np
import pytest
import torch

from repro.core import framework as jax_framework
from repro.core import online as jax_online
from repro.core.didic import DidicConfig as JaxDidicConfig
from repro.core.traffic import OpLog as JaxOpLog
from repro.core.traffic import execute_ops as jax_execute_ops
from repro.graphs import datasets as jax_datasets
from repro_torch.core.didic import DidicConfig
from repro_torch.core.fault import FaultPlan, SimulatedCrash
from repro_torch.core.framework import InsertPartitioner, PartitionedGraphService, RuntimeLogger
from repro_torch.core.online import (
    ARRIVAL_PROCESSES,
    BackgroundMaintenance,
    OnlineServer,
    inert_pad_op,
    make_arrival_stream,
    offline_replay,
)
from repro_torch.core.recovery import DynamismJournal
from repro_torch.core.traffic import OpLog, execute_ops, generate_ops
from repro_torch.graphs import datasets
from repro_torch.launch import serve

# The suite runs in several worker processes at once; one intra-op thread
# each keeps PyTorch from oversubscribing the cores.
torch.set_num_threads(1)

FAST_DIDIC = DidicConfig(k=4, iterations=6)
CLASSES = ("filesystem", "twitter")
GIS_CLASSES = ("gis_short", "gis_long")


def _graph():
    # with_vertices(1): the filesystem graph links files back to their
    # parents, so the Twitter pad needs an appended parking vertex.
    return datasets.load("filesystem", scale=0.001, seed=1).with_vertices(1)


def _jax_graph():
    return jax_datasets.load("filesystem", scale=0.001, seed=1).with_vertices(1)


def _service(g, parts=None, capacity=0):
    svc = PartitionedGraphService(g, 4, didic=FAST_DIDIC, device="cpu",
                                  exception_capacity=capacity)
    if parts is None:
        return svc.partition_didic(seed=0)
    return svc.partition_with(parts.copy())


def _parts(g):
    return _service(g).parts


def _maintenance(svc, every=3):
    return BackgroundMaintenance(svc, every=every, budget_iterations=1, round_iterations=2)


def _serve(svc, arrivals, t_counts, *, slots=4, queue=16, maintenance=None, plan=None):
    svc.fault_plan = plan
    server = OnlineServer(svc, batch_slots=slots, queue_limit=queue, maintenance=maintenance)
    server.submit_stream(arrivals, t_counts)
    return server.run()


def _assert_served_equal(a, b, classes, ctx=""):
    for cls in classes:
        np.testing.assert_array_equal(a.per_op[cls], b.per_op[cls], err_msg=f"{ctx} {cls}")
    np.testing.assert_array_equal(a.per_partition, b.per_partition, err_msg=ctx)
    np.testing.assert_array_equal(a.per_vertex, b.per_vertex, err_msg=ctx)


def _assert_offline_equal(res, g, t_counts, classes):
    off_op, off_pp, off_pv = offline_replay(g, res.epochs, 4, t_counts, device="cpu")
    for cls in classes:
        np.testing.assert_array_equal(res.per_op[cls], off_op[cls], err_msg=cls)
    np.testing.assert_array_equal(res.per_partition, off_pp)
    np.testing.assert_array_equal(res.per_vertex, off_pv)


def _epoch_ops(epochs):
    return [{cls: list(map(tuple, ops)) for cls, ops in e["ops"].items()} for e in epochs]


# ---------------------------------------------------------------------------
# Arrival streams and inert pads against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("classes", [CLASSES, GIS_CLASSES], ids=["fs_twitter", "gis"])
@pytest.mark.parametrize("process", ARRIVAL_PROCESSES)
def test_arrival_streams_match_jax(process, classes):
    if classes == GIS_CLASSES:
        g, jg = datasets.load("gis", scale=0.001), jax_datasets.load("gis", scale=0.001)
    else:
        g, jg = _graph(), _jax_graph()
    for seed, n in ((3, 48), (0, 37)):
        got, t = make_arrival_stream(g, classes, n, seed=seed, process=process, ops_per_tick=3)
        want, jt = jax_online.make_arrival_stream(jg, classes, n, seed=seed, process=process,
                                                  ops_per_tick=3)
        assert [(a.op_class, a.start, a.end, a.arrival, a.seq) for a in got] == \
               [(a.op_class, a.start, a.end, a.arrival, a.seq) for a in want]
        assert t == jt and len(got) == n
        for x, y in zip(got, got[1:]):
            assert (x.arrival, x.seq) <= (y.arrival, y.seq)


def test_unknown_process_rejected():
    with pytest.raises(ValueError, match="unknown arrival process"):
        make_arrival_stream(_graph(), CLASSES, 8, process="poisson")


@pytest.mark.parametrize("engine", ["scalar", "batched"])
@pytest.mark.parametrize("cls", CLASSES)
def test_pads_match_jax_and_count_zero(engine, cls):
    g = _graph()
    pad = inert_pad_op(g, cls)
    assert pad == jax_online.inert_pad_op(_jax_graph(), cls)
    log = OpLog(cls, np.full(8, pad[0], np.int64), np.full(8, pad[1], np.int64), t_l=2, t_pg=1)
    r = execute_ops(g, log, _parts(g), 4, engine=engine, device="cpu")
    for f in ("per_op_total", "per_op_global", "per_partition", "per_vertex"):
        assert int(np.abs(getattr(r, f)).sum()) == 0, f


def test_gis_pad_counts_zero_on_both_engines():
    g = datasets.load("gis", scale=0.001, seed=0)
    pad = inert_pad_op(g, "gis_short")
    assert pad == jax_online.inert_pad_op(jax_datasets.load("gis", scale=0.001, seed=0), "gis_long")
    log = OpLog("gis_short", np.full(4, pad[0], np.int64), np.full(4, pad[1], np.int64),
                t_l=8, t_pg=1)
    parts = np.arange(g.n_nodes, dtype=np.int32) % 4
    for engine in ("scalar", "batched"):
        r = execute_ops(g, log, parts, 4, engine=engine, device="cpu")
        assert int(np.abs(r.per_op_total).sum()) == 0, engine
        assert int(np.abs(r.per_partition).sum()) == 0, engine


def test_pads_reject_like_jax():
    g = datasets.load("filesystem", scale=0.001, seed=1)  # no parking vertex
    assert (g.out_degree > 0).all()
    with pytest.raises(ValueError, match="parking vertex"):
        inert_pad_op(g, "twitter")
    with pytest.raises(ValueError, match="unknown op class"):
        inert_pad_op(g, "bogus")


# ---------------------------------------------------------------------------
# Serving: online == offline, and == the JAX server
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("process", ARRIVAL_PROCESSES)
def test_online_equals_offline_replay(process):
    g = _graph()
    svc = _service(g, _parts(g))
    arrivals, t_counts = make_arrival_stream(g, CLASSES, 36, seed=0, process=process,
                                             ops_per_tick=3)
    res = _serve(svc, arrivals, t_counts, maintenance=_maintenance(svc))
    assert res.ops_served == 36
    assert sum(len(ops) for e in res.epochs for ops in e["ops"].values()) == 36
    _assert_offline_equal(res, g, t_counts, CLASSES)


def test_batch_slot_count_does_not_change_counters():
    g = _graph()
    parts0 = _parts(g)
    arrivals, t_counts = make_arrival_stream(g, CLASSES, 24, seed=0)
    a, b = (_serve(_service(g, parts0), arrivals, t_counts, slots=s) for s in (2, 8))
    _assert_served_equal(a, b, CLASSES, "2 vs 8 slots")


@pytest.mark.parametrize("process", ARRIVAL_PROCESSES)
def test_server_matches_jax_server(process):
    """The JAX package's DiDiC map in both services, no maintenance: the
    whole result equals the JAX server's."""
    g, jg = _graph(), _jax_graph()
    jsvc = jax_framework.PartitionedGraphService(jg, 4, didic=JaxDidicConfig(k=4, iterations=6))
    parts0 = np.asarray(jsvc.partition_didic(seed=0).parts)
    kw = dict(seed=0, process=process, ops_per_tick=3)
    arrivals, t_counts = make_arrival_stream(g, CLASSES, 30, **kw)
    jarrivals, jt_counts = jax_online.make_arrival_stream(jg, CLASSES, 30, **kw)
    slo = {"filesystem": 2, "twitter": 3}
    server = OnlineServer(_service(g, parts0), batch_slots=4, queue_limit=8, slo=slo)
    server.submit_stream(arrivals, t_counts)
    got = server.run()
    jserver = jax_online.OnlineServer(jsvc, batch_slots=4, queue_limit=8, slo=slo)
    jserver.submit_stream(jarrivals, jt_counts)
    want = jserver.run()
    _assert_served_equal(got, want, CLASSES, process)
    assert (got.ticks, got.ops_served, got.batches_served) == \
           (want.ticks, want.ops_served, want.batches_served)
    assert got.latency == want.latency and got.health == want.health
    assert _epoch_ops(got.epochs) == _epoch_ops(want.epochs)


def test_nonempty_exception_table_bit_exact_with_and_without_crash():
    """Serving skewed_hot arrivals with a promoted hot table (as
    ``tests/test_online.py::TestSkewedHotPlacementServing`` does) equals
    offline replay of its epochs, and a crash leg equals the clean leg."""
    g = _graph()
    parts0 = _parts(g)
    prime = generate_ops(g, n_ops=32, seed=5)
    arrivals, t_counts = make_arrival_stream(g, CLASSES, 36, seed=0, process="skewed_hot",
                                             ops_per_tick=3)

    def leg(plan):
        svc = _service(g, parts0, capacity=16)
        svc.run_ops(prime)               # accumulate per-vertex traffic...
        assert svc.refresh_placement().size > 0  # ...and promote the hot set
        return svc, _serve(svc, arrivals, t_counts, maintenance=_maintenance(svc), plan=plan)

    clean_svc, clean = leg(None)
    assert clean.ops_served == 36 and any(len(e["hot"]) > 0 for e in clean.epochs)
    _assert_offline_equal(clean, g, t_counts, CLASSES)
    crash_svc, crashed = leg(FaultPlan().crash(3, site="serve:admit").crash(5, site="serve:commit"))
    np.testing.assert_array_equal(crash_svc.placement.hot, clean_svc.placement.hot)
    assert crashed.health["recoveries"] == 2
    _assert_served_equal(crashed, clean, CLASSES, "crash leg")
    assert crashed.latency == clean.latency
    _assert_offline_equal(crashed, g, t_counts, CLASSES)


# ---------------------------------------------------------------------------
# Admission
# ---------------------------------------------------------------------------
def test_queue_bound_holds_and_nothing_drops():
    g = _graph()
    server = OnlineServer(_service(g), batch_slots=2, queue_limit=4)
    arrivals, t_counts = make_arrival_stream(g, CLASSES, 20, seed=0, ops_per_tick=1000)
    assert all(op.arrival == 0 for op in arrivals)
    server.submit_stream(arrivals, t_counts)
    peak = 0
    while not server.drained:
        server.tick()
        peak = max(peak, server._queued)
        assert server._queued <= 4
    assert peak > 0 and server.ops_served == 20


def test_service_is_fifo_per_class():
    g = _graph()
    server = OnlineServer(_service(g), batch_slots=4, queue_limit=16)
    arrivals, t_counts = make_arrival_stream(g, CLASSES, 24, seed=0)
    server.submit_stream(arrivals, t_counts)
    server.run()
    for cls in CLASSES:
        submitted = [(op.start, op.end) for op in arrivals if op.op_class == cls]
        assert [p for e in server.epochs for p in e["ops"].get(cls, [])] == submitted


def test_invalid_configuration_rejected():
    g = _graph()
    svc = _service(g)
    with pytest.raises(ValueError, match="batch_slots"):
        OnlineServer(svc, batch_slots=0)
    with pytest.raises(ValueError, match="queue_limit"):
        OnlineServer(svc, batch_slots=8, queue_limit=4)
    server = OnlineServer(svc, batch_slots=2, queue_limit=4)
    arrivals, t_counts = make_arrival_stream(g, CLASSES, 4, seed=0)
    server.submit_stream(arrivals, t_counts)
    with pytest.raises(RuntimeError, match="already submitted"):
        server.submit_stream(arrivals, t_counts)
    with pytest.raises(ValueError, match="sorted"):
        OnlineServer(svc, batch_slots=2, queue_limit=4).submit_stream(
            list(reversed(arrivals)), t_counts)
    stuck = OnlineServer(svc, batch_slots=2, queue_limit=4)
    stuck.submit_stream(arrivals, t_counts)
    with pytest.raises(RuntimeError, match="not drained"):
        stuck.run(max_ticks=1)


# ---------------------------------------------------------------------------
# Latency
# ---------------------------------------------------------------------------
def test_percentiles_match_jax():
    rng = np.random.default_rng(0)
    fixtures = [[7], [3] * 10, [10, 1, 7, 3, 9, 5, 2, 8, 4, 6], [1, 2, 3, 4], [2 ** 62, 1]]
    fixtures += [rng.integers(0, 50, size=n).tolist() for n in (2, 5, 17, 100, 101)]
    for samples in fixtures:
        for q in (0, 1, 25, 26, 50, 95, 99, 100):
            assert RuntimeLogger._percentile(samples, q) == \
                jax_framework.RuntimeLogger._percentile(samples, q), (samples, q)
    assert RuntimeLogger._percentile([10, 1, 7, 3, 9, 5, 2, 8, 4, 6], 50) == 5
    with pytest.raises(ValueError, match="empty"):
        RuntimeLogger._percentile([], 50)
    ours, ref = RuntimeLogger(2), jax_framework.RuntimeLogger(2)
    for lg in (ours, ref):
        lg.set_slo("fs", 4)
        for w in fixtures[2] + [2 ** 62]:
            lg.record_latency("fs", queue_wait=w, service_time=1)
            lg.record_latency("tw", queue_wait=w // 2, service_time=2)
    assert ours.latency_report() == ref.latency_report()
    assert ours.slo_violations == ref.slo_violations


def test_reset_keeps_slo_budgets():
    lg = RuntimeLogger(2)
    lg.set_slo("fs", 4)
    lg.record_latency("fs", queue_wait=10, service_time=1)
    assert lg.slo_violations == 1
    lg.reset()
    assert lg.latency_report() == {} and lg.health_report()["slo_violations"] == 0
    lg.record_latency("fs", queue_wait=10, service_time=1)  # the budget survived
    assert lg.slo_violations == 1


def test_slo_violations_count_at_the_boundary():
    lg = RuntimeLogger(2)
    lg.set_slo("fs", 5)
    lg.record_latency("fs", queue_wait=4, service_time=1)   # == budget: within
    assert lg.slo_violations == 0
    lg.record_latency("fs", queue_wait=5, service_time=1)   # > budget
    lg.record_latency("tw", queue_wait=100, service_time=1)  # no budget set
    assert lg.slo_violations == 1
    assert lg.latency_report()["fs"]["slo_budget"] == 5
    assert "slo_budget" not in lg.latency_report()["tw"]


def test_server_latency_is_queue_wait_on_the_simulated_clock():
    g = _graph()
    server = OnlineServer(_service(g), batch_slots=1, queue_limit=8, slo={"filesystem": 2})
    arrivals, t_counts = make_arrival_stream(g, ("filesystem",), 6, seed=0, ops_per_tick=1000)
    server.submit_stream(arrivals, t_counts)
    res = server.run()
    rep = res.latency["filesystem"]
    assert rep["count"] == 6 and rep["queue_wait_max"] == 5 and rep["service_mean"] == 1.0
    assert res.health["slo_violations"] == 4  # totals 3..6 exceed 2


# ---------------------------------------------------------------------------
# Background maintenance
# ---------------------------------------------------------------------------
def test_round_spreads_over_budgeted_ticks_then_commits():
    svc = _service(_graph())
    bg = BackgroundMaintenance(svc, every=4, budget_iterations=1, round_iterations=3)
    moved = {now: bg.tick(now) for now in range(11)}
    assert bg.rounds_completed == 2 and bg.iterations_run == 6
    assert bg.first_iteration_tick == 3
    assert [t for t, m in moved.items() if m is not None] == [5, 9]


def test_growth_mid_round_restarts_from_grown_map():
    g = _graph()
    svc = _service(g)
    bg = BackgroundMaintenance(svc, every=2, budget_iterations=1, round_iterations=4)
    assert bg.tick(1) is None and bg._working is not None
    n0 = g.n_nodes
    svc.graph = g.with_vertices(4, None, np.array([0, 1, 2, 3], np.int64),
                                np.arange(n0, n0 + 4, dtype=np.int64))
    svc.parts = np.concatenate([svc.parts, np.arange(4, dtype=np.int32) % 4])
    svc.runtime.state = None  # what apply_dynamism does on growth
    bg.tick(2)                # the stale working map is dropped
    assert bg._working is None or bg._working.shape[0] == svc.graph.n_nodes
    for now in range(3, 12):
        bg.tick(now)
    assert bg.rounds_completed >= 1


def test_serving_continues_across_structural_growth():
    g = _graph()
    svc = _service(g)
    svc.journal = DynamismJournal()
    server = OnlineServer(svc, batch_slots=4, queue_limit=16,
                          maintenance=BackgroundMaintenance(svc, every=3, round_iterations=2))
    arrivals, t_counts = make_arrival_stream(g, CLASSES, 24, seed=0, ops_per_tick=2)
    server.submit_stream(arrivals, t_counts)
    ip = InsertPartitioner("random", 4, seed=0)
    grew = False
    while not server.drained:
        server.tick()
        if server.clock == 4:  # structural growth mid-serving
            log = ip.allocate(svc.parts, 0.05, insert_rate=0.5, graph=svc.graph)
            svc.apply_dynamism(log)
            grew = log.n_new_vertices > 0
    assert grew and server.ops_served == 24
    res = server.result()
    assert res.per_vertex.shape[0] == svc.graph.n_nodes
    assert svc.journal.entries
    for e in res.epochs:
        assert e["parts"].min() >= 0 and e["parts"].max() < 4


# ---------------------------------------------------------------------------
# Crash retries
# ---------------------------------------------------------------------------
def test_admit_and_commit_crashes_retry_bit_exact():
    g = _graph()
    parts0 = _parts(g)
    arrivals, t_counts = make_arrival_stream(g, CLASSES, 32, seed=0, process="uniform",
                                             ops_per_tick=3)

    def leg(plan):
        svc = _service(g, parts0)
        return _serve(svc, arrivals, t_counts, maintenance=_maintenance(svc, every=4), plan=plan)

    clean = leg(None)
    crashed = leg(FaultPlan().crash(2, site="serve:admit").crash(4, site="serve:commit"))
    assert crashed.health["recoveries"] == 2
    _assert_served_equal(clean, crashed, CLASSES, "crash retry")
    assert clean.latency == crashed.latency and clean.ticks == crashed.ticks
    assert _epoch_ops(clean.epochs) == _epoch_ops(crashed.epochs)


def test_admit_crash_leaves_tick_unstarted():
    g = _graph()
    svc = _service(g)
    svc.fault_plan = FaultPlan().crash(0, site="serve:admit")
    server = OnlineServer(svc, batch_slots=4, queue_limit=16)
    arrivals, t_counts = make_arrival_stream(g, ("filesystem",), 8, seed=0)
    server.submit_stream(arrivals, t_counts)
    with pytest.raises(SimulatedCrash):
        server.tick()
    assert (server.clock, server.ops_served, server._cursor, server._queued) == (0, 0, 0, 0)
    served = server.tick()  # the crash fired once; the retry serves
    assert served is not None and server.ops_served == served[1]


def test_offline_replay_scalar_equals_jax_oracle():
    """The epoch record replays to the same counters through the port's
    scalar oracle and the JAX package's."""
    g, jg = _graph(), _jax_graph()
    svc = _service(g)
    arrivals, t_counts = make_arrival_stream(g, CLASSES, 24, seed=1, process="bursty")
    res = _serve(svc, arrivals, t_counts, maintenance=_maintenance(svc))
    got = offline_replay(g, res.epochs, 4, t_counts, engine="scalar")
    for cls in CLASSES:
        parts = res.epochs[0]["parts"]
        pairs = res.epochs[0]["ops"][cls]
        log = JaxOpLog(cls, np.asarray([s for s, _ in pairs]), np.asarray([e for _, e in pairs]),
                       *t_counts[cls])
        want = jax_execute_ops(jg, log, parts, 4, engine="scalar")
        n = len(pairs)
        np.testing.assert_array_equal(got[0][cls][:n, 0], want.per_op_total)
        np.testing.assert_array_equal(got[0][cls][:n, 1], want.per_op_global)
    _assert_offline_equal(res, g, t_counts, CLASSES)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------
def test_launcher_serves_graph_on_cpu(capsys):
    serve.main(["--arch", "graph", "--requests", "32", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[serve] graph/uniform: 32 ops in ") and out[0].endswith("(cpu)")
    assert sum(line.startswith("[serve]   gis_") for line in out) == 2
    assert out[-1].startswith("[serve]   slo_violations=")


def test_launcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "graph", "--requests", "8"])
