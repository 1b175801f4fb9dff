"""Port parity for the dynamic experiments: dynamism generation, graph
growth, the insert partitioner, the Migration-Scheduler, pinned DiDiC
maintenance and the dynamic-experiment runtime, against the JAX package
with no mesh.

What is held bit for bit: every dynamism log (vertices, targets, the insert
payload and attrs, ``fingerprint()``), grown graphs, insert streams, the
scheduler's plans, the damaged T_G % of the Stress experiment, and, with
each slice's maintained map taken from the JAX run, all four counters and
every ``SliceRecord`` field of every slice. The port's own DiDiC sums floats
in another order (``test_torch_didic.py``), so uninjected runs are held to
the band ``|port − ref| ≤ 0.25·ref + 0.01`` on each slice's T_G %.
"""

import os
import pathlib
import subprocess
import sys
import weakref

import numpy as np
import pytest
import torch

from repro.core import framework as jax_framework
from repro.core.didic import DidicConfig as JaxDidicConfig
from repro.core.didic import didic_partition as jax_didic_partition
from repro.core.didic import didic_refine as jax_didic_refine
from repro.core.dynamic_runtime import DynamicExperimentRuntime as JaxRuntime
from repro.core.dynamism import DynamismLog as JaxLog
from repro.core.dynamism import apply_dynamism as jax_apply
from repro.core.dynamism import generate_dynamism as jax_generate
from repro.graphs import datasets as jax_datasets
from repro_torch import convert
from repro_torch.core import framework
from repro_torch.core.didic import DidicConfig, didic_refine
from repro_torch.core.dynamic_runtime import DynamicExperimentRuntime
from repro_torch.core.dynamism import DynamismLog, apply_dynamism, generate_dynamism
from repro_torch.core.traffic import execute_ops, generate_ops
from repro_torch.core.traffic_batched import get_engine
from repro_torch.graphs import datasets
from repro_torch.graphs.structure import Graph

# The suite runs in several worker processes at once; one intra-op thread
# each keeps PyTorch from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCALE = 0.003
NAMES = ("filesystem", "gis", "twitter")
METHODS = ("random", "fewest_vertices", "least_traffic")
COUNTERS = ("per_op_total", "per_op_global", "per_partition", "per_vertex")
LOG_FIELDS = ("vertices", "targets", "insert_senders", "insert_receivers", "insert_weights",
              "unit_is_insert", "insert_unit")


def _n_ops(name):
    return 40 if name == "gis" else 300


@pytest.fixture(scope="module")
def graphs():
    return {name: (datasets.load(name, scale=SCALE), jax_datasets.load(name, scale=SCALE))
            for name in NAMES}


@pytest.fixture(scope="module")
def traffic(graphs):
    """A random map per dataset and its replay's per-vertex traffic."""
    out = {}
    for name, (g, _) in graphs.items():
        parts = np.random.default_rng(1).integers(0, 4, g.n_nodes).astype(np.int32)
        ops = generate_ops(g, n_ops=_n_ops(name), seed=0)
        out[name] = (parts, execute_ops(g, ops, parts, 4, engine="scalar").per_vertex)
    return out


def _assert_logs_equal(got, want):
    for field in LOG_FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=field)
            assert np.asarray(a).dtype == np.asarray(b).dtype, field
    assert (got.method, got.k, got.base_nodes) == (want.method, want.k, want.base_nodes)
    assert sorted(got.insert_attrs) == sorted(want.insert_attrs)
    for key in want.insert_attrs:
        np.testing.assert_array_equal(got.insert_attrs[key], want.insert_attrs[key], err_msg=key)
        assert got.insert_attrs[key].dtype == want.insert_attrs[key].dtype
    assert got.fingerprint() == want.fingerprint()


def _assert_graphs_equal(got, want):
    assert got.n_nodes == want.n_nodes
    for field in ("senders", "receivers", "edge_weight"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert sorted(got.node_attrs) == sorted(want.node_attrs)
    for key in want.node_attrs:
        np.testing.assert_array_equal(got.node_attrs[key], want.node_attrs[key], err_msg=key)
        assert got.node_attrs[key].dtype == want.node_attrs[key].dtype


def _assert_counters_equal(got, want):
    for field in COUNTERS:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


# ---------------------------------------------------------------------------
# generate_dynamism, DynamismLog, apply_dynamism
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("insert_rate", [0.0, 0.3])
@pytest.mark.parametrize("seed_kind", ["int", "seedsequence"])
@pytest.mark.parametrize("amount", [0.01, 0.25])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", NAMES)
def test_generate_dynamism_matches_jax(graphs, traffic, name, method, amount, seed_kind, insert_rate):
    g, jg = graphs[name]
    parts, vt = traffic[name]
    seed = 7 if seed_kind == "int" else np.random.SeedSequence(7).spawn(3)[2]
    kw = dict(k=4, vertex_traffic=vt, insert_rate=insert_rate)
    want = jax_generate(parts, amount, method, seed=seed, graph=jg, **kw)
    got = generate_dynamism(parts, amount, method, seed=seed, graph=g, **kw)
    _assert_logs_equal(got, want)
    assert got.units == want.units and got.structural == want.structural
    assert got.n_new_vertices == want.n_new_vertices
    np.testing.assert_array_equal(got.new_vertices(), want.new_vertices())
    np.testing.assert_array_equal(got.dirty_vertices(), want.dirty_vertices())
    np.testing.assert_array_equal(apply_dynamism(parts, got), jax_apply(parts, want))


@pytest.mark.parametrize("insert_rate", [0.0, 0.3])
@pytest.mark.parametrize("name", NAMES)
def test_least_traffic_with_traffic_shorter_than_parts(graphs, traffic, name, insert_rate):
    """A replay on the graph before growth: the missing vertices carry zero."""
    g, jg = graphs[name]
    parts, vt = traffic[name]
    short = vt[: g.n_nodes - 37]
    kw = dict(k=4, vertex_traffic=short, seed=5, insert_rate=insert_rate)
    _assert_logs_equal(generate_dynamism(parts, 0.25, "least_traffic", graph=g, **kw),
                       jax_generate(parts, 0.25, "least_traffic", graph=jg, **kw))


@pytest.mark.parametrize("name", NAMES)
def test_random_with_device_engine_draws_on_the_host(graphs, name):
    """``random`` needs no scan: both packages draw it on the host under
    ``engine="device"`` too."""
    g, jg = graphs[name]
    parts = np.zeros(g.n_nodes, dtype=np.int32)
    _assert_logs_equal(generate_dynamism(parts, 0.1, "random", k=4, seed=1, engine="device"),
                       jax_generate(parts, 0.1, "random", k=4, seed=1, engine="device"))


def test_device_scan_names_the_multi_device_slice():
    """The device scan came with the multi-device slice: on the CPU it
    draws the host loop's log, and the JAX package's device scan's."""
    parts = (np.arange(100) % 4).astype(np.int32)
    for method in ("fewest_vertices", "least_traffic"):
        kw = dict(k=4, seed=3, vertex_traffic=np.arange(100) if method == "least_traffic" else None)
        dev = generate_dynamism(parts, 0.4, method, engine="device", device="cpu", **kw)
        _assert_logs_equal(dev, generate_dynamism(parts, 0.4, method, **kw))
        _assert_logs_equal(dev, jax_generate(parts, 0.4, method, engine="device", **kw))


@pytest.mark.parametrize("name", NAMES)
def test_slices_of_a_growth_log_apply_to_the_whole_log(graphs, traffic, name):
    """Five 5 % slices (boundaries computed as running float sums) equal the
    JAX package's slices, and applied in sequence give the whole log's map
    and graph, on both sides."""
    g, jg = graphs[name]
    parts, vt = traffic[name]
    kw = dict(k=4, vertex_traffic=vt, seed=3, insert_rate=0.3)
    whole = generate_dynamism(parts, 0.25, "least_traffic", graph=g, **kw)
    jwhole = jax_generate(parts, 0.25, "least_traffic", graph=jg, **kw)
    p, graph, frac = parts.copy(), g, 0.0
    for _ in range(5):
        sl = whole.slice(frac / 0.25, (frac + 0.05) / 0.25)
        _assert_logs_equal(sl, jwhole.slice(frac / 0.25, (frac + 0.05) / 0.25))
        graph = graph.with_vertices(sl.n_new_vertices, sl.insert_attrs, sl.insert_senders,
                                    sl.insert_receivers, sl.insert_weights)
        p = apply_dynamism(p, sl)
        frac += 0.05
    np.testing.assert_array_equal(p, apply_dynamism(parts, whole))
    _assert_graphs_equal(graph, g.with_vertices(
        whole.n_new_vertices, whole.insert_attrs, whole.insert_senders,
        whole.insert_receivers, whole.insert_weights))


def test_pure_move_slice_matches_jax(traffic):
    parts, vt = traffic["twitter"]
    log = generate_dynamism(parts, 0.2, "fewest_vertices", k=4, seed=2)
    jlog = jax_generate(parts, 0.2, "fewest_vertices", k=4, seed=2)
    for a, b in ((0.0, 0.3), (0.3, 0.7), (0.7, 1.0)):
        _assert_logs_equal(log.slice(a, b), jlog.slice(a, b))
        np.testing.assert_array_equal(apply_dynamism(parts, log.slice(a, b)),
                                      jax_apply(parts, jlog.slice(a, b)))


def _error_cases(g, jg, parts, vt):
    """(port call, JAX call) pairs that must raise the same exception type."""
    grow = dict(k=4, vertex_traffic=vt, seed=0, insert_rate=0.3)
    log = generate_dynamism(parts, 0.1, "random", graph=g, **grow)
    jlog = jax_generate(parts, 0.1, "random", graph=jg, **grow)
    bare = dict(vertices=np.arange(3), targets=np.zeros(3, np.int32), method="random", k=4,
                insert_senders=np.array([0]), insert_receivers=np.array([1]))
    n = g.n_nodes
    return {
        "unknown method": (lambda: generate_dynamism(parts, 0.1, "biggest", k=4),
                           lambda: jax_generate(parts, 0.1, "biggest", k=4)),
        "unknown engine": (lambda: generate_dynamism(parts, 0.1, "random", k=4, engine="tpu"),
                           lambda: jax_generate(parts, 0.1, "random", k=4, engine="tpu")),
        "insert_rate above 1": (lambda: generate_dynamism(parts, 0.1, "random", k=4, insert_rate=1.5),
                                lambda: jax_generate(parts, 0.1, "random", k=4, insert_rate=1.5)),
        "growth without a graph": (lambda: generate_dynamism(parts, 0.1, "random", k=4, insert_rate=0.2),
                                   lambda: jax_generate(parts, 0.1, "random", k=4, insert_rate=0.2)),
        "graph of another size": (
            lambda: generate_dynamism(parts[:-1], 0.1, "random", k=4, insert_rate=0.2, graph=g),
            lambda: jax_generate(parts[:-1], 0.1, "random", k=4, insert_rate=0.2, graph=jg)),
        "least_traffic without traffic": (lambda: generate_dynamism(parts, 0.1, "least_traffic", k=4),
                                          lambda: jax_generate(parts, 0.1, "least_traffic", k=4)),
        "apply to another base": (lambda: apply_dynamism(parts[:-1], log),
                                  lambda: jax_apply(parts[:-1], jlog)),
        "slice without attribution": (lambda: DynamismLog(**bare).slice(0.0, 0.5),
                                      lambda: JaxLog(**bare).slice(0.0, 0.5)),
        "edge to a missing vertex": (lambda: g.with_edges(np.array([0]), np.array([n])),
                                     lambda: jg.with_edges(np.array([0]), np.array([n]))),
        "edge arrays of two shapes": (lambda: g.with_edges(np.array([0, 1]), np.array([1])),
                                      lambda: jg.with_edges(np.array([0, 1]), np.array([1]))),
        "negative growth": (lambda: g.with_vertices(-1), lambda: jg.with_vertices(-1)),
        "unknown attr": (lambda: g.with_vertices(1, {"colour": np.zeros(1)}),
                         lambda: jg.with_vertices(1, {"colour": np.zeros(1)})),
        "edge past the grown vertices": (
            lambda: g.with_vertices(2, senders=np.array([0]), receivers=np.array([n + 2])),
            lambda: jg.with_vertices(2, senders=np.array([0]), receivers=np.array([n + 2]))),
    }


@pytest.mark.parametrize("case", [
    "unknown method", "unknown engine", "insert_rate above 1", "growth without a graph",
    "graph of another size", "least_traffic without traffic", "apply to another base",
    "slice without attribution", "edge to a missing vertex", "edge arrays of two shapes",
    "negative growth", "unknown attr", "edge past the grown vertices",
])
def test_errors_raise_the_same_types(graphs, traffic, case):
    g, jg = graphs["gis"]
    parts, vt = traffic["gis"]
    port_call, jax_call = _error_cases(g, jg, parts, vt)[case]
    with pytest.raises(Exception) as want:
        jax_call()
    with pytest.raises(want.type):
        port_call()


@pytest.mark.parametrize("name", NAMES)
def test_with_vertices_and_with_edges_match_jax(graphs, traffic, name):
    g, jg = graphs[name]
    parts, vt = traffic[name]
    log = generate_dynamism(parts, 0.1, "random", k=4, seed=4, insert_rate=0.5, graph=g)
    grown = g.with_vertices(log.n_new_vertices, log.insert_attrs, log.insert_senders,
                            log.insert_receivers, log.insert_weights)
    jgrown = jg.with_vertices(log.n_new_vertices, log.insert_attrs, log.insert_senders,
                              log.insert_receivers, log.insert_weights)
    _assert_graphs_equal(grown, jgrown)
    # Attrs not given get zero rows; explicit sentinels pass through.
    _assert_graphs_equal(g.with_vertices(3), jg.with_vertices(3))
    s, r = log.insert_receivers[:50] % g.n_nodes, log.insert_senders[:50] % g.n_nodes
    _assert_graphs_equal(g.with_edges(s, r), jg.with_edges(s, r))
    w = np.linspace(1.0, 2.0, s.shape[0]).astype(np.float32)
    _assert_graphs_equal(g.with_edges(s, r, w), jg.with_edges(s, r, w))
    # Growth reallocates the attrs, leaving the old graph whole; new edges
    # share them.
    assert all(a.shape[0] == g.n_nodes for a in g.node_attrs.values())
    assert g.with_edges(s, r).node_attrs is g.node_attrs


# ---------------------------------------------------------------------------
# InsertPartitioner, MigrationScheduler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", METHODS)
def test_insert_partitioner_streams_match_jax(graphs, traffic, method):
    g, jg = graphs["filesystem"]
    parts, vt = traffic["filesystem"]
    ours = framework.InsertPartitioner(method, k=4, seed=11)
    ref = jax_framework.InsertPartitioner(method, k=4, seed=11)
    for rate in (0.0, 0.3, 0.0):
        _assert_logs_equal(ours.allocate(parts, 0.03, vertex_traffic=vt, insert_rate=rate, graph=g),
                           ref.allocate(parts, 0.03, vertex_traffic=vt, insert_rate=rate, graph=jg))
    assert ours.rng_state() == ref.rng_state()
    ours.advance(2)
    ref.advance(2)
    assert ours.rng_state() == ref.rng_state()

    state = ours.rng_state()
    first = ours.allocate(parts, 0.03, vertex_traffic=vt)
    ours.allocate(parts, 0.03, vertex_traffic=vt)
    ours.set_rng_state(state)
    _assert_logs_equal(ours.allocate(parts, 0.03, vertex_traffic=vt), first)
    _assert_logs_equal(first, ref.allocate(parts, 0.03, vertex_traffic=vt))


SCHEDULERS = pytest.mark.parametrize(
    "cls", [framework.MigrationScheduler, jax_framework.MigrationScheduler], ids=["port", "jax"])


class TestMigrationScheduler:
    """The JAX package's own cases (tests/test_dynamic_runtime.py), run
    against both classes, plus a plan compared across them."""

    @SCHEDULERS
    def test_plan_step_keyed_history(self, cls):
        old = np.array([0, 0, 1, 1, 2, 2], dtype=np.int32)
        new = np.array([1, 0, 1, 2, 0, 2], dtype=np.int32)
        sched = cls(min_move_fraction=0.0)
        cmds = sched.plan(old, new, step=7)
        assert sched.history == [{"step": 7, "n_moved": 3}]
        assert np.array_equal(cls.apply(old, cmds), new)

    @SCHEDULERS
    def test_vectorized_grouping_matches_naive(self, cls):
        rng = np.random.default_rng(0)
        old = rng.integers(0, 5, size=1000).astype(np.int32)
        new = rng.integers(0, 5, size=1000).astype(np.int32)
        cmds = cls(min_move_fraction=0.0).plan(old, new, step=0)
        moved = np.nonzero(old != new)[0]
        got = {c.target: set(c.vertices.tolist()) for c in cmds}
        want = {int(t): set(moved[new[moved] == t].tolist()) for t in np.unique(new[moved])}
        assert got == want

    @SCHEDULERS
    def test_threshold_returns_empty(self, cls):
        old = np.zeros(1000, dtype=np.int32)
        new = old.copy()
        new[0] = 1
        sched = cls(min_move_fraction=0.01)
        assert sched.plan(old, new, step=0) == []
        assert sched.history == []

    @SCHEDULERS
    def test_degradation_baseline_resets_after_maintenance(self, cls):
        sched = cls(degradation_factor=1.25)
        assert not sched.should_migrate(0.10)
        assert sched.should_migrate(0.20)
        sched.record_maintenance(0.18)
        for pg in (0.19, 0.20, 0.22):
            assert not sched.should_migrate(pg), pg
        assert sched.should_migrate(0.18 * 1.25 + 0.01)

    @SCHEDULERS
    def test_lucky_slice_does_not_poison_baseline(self, cls):
        sched = cls(degradation_factor=1.25)
        sched.record_maintenance(0.18)
        assert not sched.should_migrate(0.10)
        for pg in (0.17, 0.18, 0.19, 0.20, 0.22):
            assert not sched.should_migrate(pg), pg
        assert sched.should_migrate(0.18 * 1.25 + 0.01)

    @SCHEDULERS
    def test_baseline_moves_only_via_record_maintenance(self, cls):
        sched = cls(degradation_factor=1.25)
        assert not sched.should_migrate(0.10)
        assert sched.baseline_percent_global == 0.10
        assert sched.should_migrate(0.20)
        assert sched.baseline_percent_global == 0.10
        sched.record_maintenance(0.08)
        assert sched.should_migrate(0.101)

    def test_plans_equal_across_packages(self):
        rng = np.random.default_rng(5)
        old = rng.integers(0, 4, size=500).astype(np.int32)
        new = np.where(rng.random(500) < 0.2, rng.integers(0, 4, size=500), old).astype(np.int32)
        ours = framework.MigrationScheduler(min_move_fraction=0.0).plan(old, new, step=3)
        ref = jax_framework.MigrationScheduler(min_move_fraction=0.0).plan(old, new, step=3)
        assert [c.target for c in ours] == [c.target for c in ref]
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.vertices, b.vertices)


# ---------------------------------------------------------------------------
# DiDiC maintenance with pins
# ---------------------------------------------------------------------------
def test_refine_with_pins_matches_jax_step(graphs):
    g, jg = graphs["gis"]
    _, jstate = jax_didic_partition(jg, JaxDidicConfig(k=4, iterations=3), seed=2)
    parts = np.asarray(jstate.parts)
    # Pins on vertices whose assignment moves in an unpinned refine.
    free, _ = jax_didic_refine(jg, parts, JaxDidicConfig(k=4), state=jstate, iterations=1)
    moved = np.nonzero(np.asarray(free) != parts)[0]
    assert moved.size > 0
    pinned = moved[:: max(1, moved.size // 20)]
    jparts, jout = jax_didic_refine(jg, parts, JaxDidicConfig(k=4), state=jstate, iterations=1,
                                    pinned=pinned)
    state = convert.didic_state_from_arrays(
        np.asarray(jstate.w), np.asarray(jstate.l), parts, np.asarray(jstate.beta), device="cpu")
    got, out = didic_refine(g, parts, DidicConfig(k=4), state=state, iterations=1, device="cpu",
                            pinned=pinned)
    np.testing.assert_array_equal(got[pinned], parts[pinned])
    np.testing.assert_array_equal(np.asarray(jparts)[pinned], parts[pinned])
    for field in ("w", "l", "beta"):
        np.testing.assert_allclose(getattr(out, field).numpy(), np.asarray(getattr(jout, field)),
                                   rtol=1e-4, atol=1e-5, err_msg=field)
    assert (got == np.asarray(jparts)).mean() >= 0.99
    # An empty pin set is the unpinned refine.
    unpinned, _ = didic_refine(g, parts, DidicConfig(k=4), state=state, iterations=1, device="cpu")
    empty, _ = didic_refine(g, parts, DidicConfig(k=4), state=state, iterations=1, device="cpu",
                            pinned=np.zeros(0, np.int64))
    np.testing.assert_array_equal(unpinned, empty)


# ---------------------------------------------------------------------------
# The dynamic-experiment runtime
# ---------------------------------------------------------------------------
def _start(name, graphs, iterations=5):
    """Both services on the JAX package's DiDiC map, the port's with the
    carried state converted over."""
    g, jg = graphs[name]
    cap = 256 if name == "filesystem" else 64
    jcfg = JaxDidicConfig(k=4, iterations=iterations, smooth_cap=cap)
    cfg = DidicConfig(k=4, iterations=iterations, smooth_cap=cap)
    parts0, jstate = jax_didic_partition(jg, jcfg, seed=0)
    parts0 = np.asarray(parts0)
    jsvc = jax_framework.PartitionedGraphService(jg, 4, didic=jcfg)
    jsvc.runtime.state = jstate
    jsvc.partition_with(parts0.copy())
    svc = framework.PartitionedGraphService(g, 4, didic=cfg, device="cpu")
    svc.runtime.state = convert.didic_state_from_arrays(
        np.asarray(jstate.w), np.asarray(jstate.l), parts0, np.asarray(jstate.beta), device="cpu")
    svc.partition_with(parts0.copy())
    return svc, jsvc


# (insert method, insert_rate, maintain_every)
RUNS = {
    "random": ("random", 0.0, 1),
    "least_traffic": ("least_traffic", 0.0, 2),
    "growth": ("least_traffic", 0.3, 2),
}


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("name", NAMES)
def test_runtime_with_jax_maintenance_is_bit_equal(graphs, name, run):
    """Each slice's maintained map comes from the JAX run (the port's
    ``runtime.maintain`` is replaced here); every counter and record must
    then be equal on every slice, grown graphs included."""
    method, rate, every = RUNS[run]
    svc, jsvc = _start(name, graphs)
    maps = []
    jax_maintain = jsvc.runtime.maintain

    def recorded(*args, **kwargs):
        out = jax_maintain(*args, **kwargs)
        maps.append(np.array(out, copy=True))
        return out

    jsvc.runtime.maintain = recorded
    supply = iter(maps)
    svc.runtime.maintain = lambda *args, **kwargs: next(supply)
    kw = dict(n_slices=4, amount=0.05, maintain_every=every, insert_rate=rate)
    jres, res = [], []
    jops = jsvc.make_ops(n_ops=_n_ops(name), seed=0)
    ops = svc.make_ops(n_ops=_n_ops(name), seed=0)
    want = JaxRuntime(jsvc, insert_method=method, seed=0).run(
        jops, on_slice=lambda i, r: jres.append(r), **kw)
    got = DynamicExperimentRuntime(svc, insert_method=method, seed=0).run(
        ops, on_slice=lambda i, r: res.append(r), **kw)
    assert len(res) == len(jres) == 4 and len(maps) == (4 // every)
    _assert_counters_equal(got.baseline, want.baseline)
    for a, b in zip(res, jres):
        _assert_counters_equal(a, b)
    assert [vars(r) for r in got.records] == [vars(r) for r in want.records]
    np.testing.assert_array_equal(got.parts, want.parts)
    _assert_graphs_equal(svc.graph, jsvc.graph)
    assert svc.logger.load_balance_cv() == jsvc.logger.load_balance_cv()
    if rate:
        assert sum(r.inserted for r in got.records) > 0
        assert svc.graph.n_nodes > graphs[name][0].n_nodes
        # The grown graph's batched engine against the port's scalar oracle.
        _assert_counters_equal(svc.run_ops(ops), execute_ops(svc.graph, ops, svc.parts, 4,
                                                             engine="scalar"))


@pytest.mark.parametrize("run", ["random", "growth"])
@pytest.mark.parametrize("name", NAMES)
def test_runtime_lands_in_the_reference_band(graphs, name, run):
    """The port's own maintenance: each slice's T_G % within
    ``0.25·ref + 0.01`` of the JAX run's. A growth run attaches a store in
    both packages, so its maintenance is the overlay step on both sides."""
    method, rate, every = RUNS[run]
    svc, jsvc = _start(name, graphs)
    kw = dict(n_slices=4, amount=0.05, maintain_every=every, insert_rate=rate)
    want = JaxRuntime(jsvc, insert_method=method, seed=0).run(
        jsvc.make_ops(n_ops=_n_ops(name), seed=0), **kw)
    got = DynamicExperimentRuntime(svc, insert_method=method, seed=0).run(
        svc.make_ops(n_ops=_n_ops(name), seed=0), **kw)
    for a, b in zip(got.records, want.records):
        assert abs(a.percent_global - b.percent_global) <= 0.25 * b.percent_global + 0.01, (a, b)
        assert (a.units, a.maintained, a.inserted) == (b.units, b.maintained, b.inserted)


@pytest.mark.parametrize("name", NAMES)
def test_stress_damage_is_bit_equal(graphs, name):
    """The Stress experiment (25 % random dynamism, one cold maintenance
    iteration): the damaged T_G % is measured before any maintenance, so it
    is equal; the repaired one lands in the band and below the damage."""
    svc, jsvc = _start(name, graphs)
    svc.runtime.state = None
    jsvc.runtime.state = None
    kw = dict(n_slices=1, amount=0.25, maintain_every=1, measure_damaged=True)
    want = JaxRuntime(jsvc, insert_method="random", seed=0).run(
        jsvc.make_ops(n_ops=_n_ops(name), seed=0), **kw)
    got = DynamicExperimentRuntime(svc, insert_method="random", seed=0).run(
        svc.make_ops(n_ops=_n_ops(name), seed=0), **kw)
    rec, jrec = got.records[0], want.records[0]
    assert rec.damaged_percent_global == jrec.damaged_percent_global
    assert got.baseline.percent_global == want.baseline.percent_global
    assert abs(rec.percent_global - jrec.percent_global) <= 0.25 * jrec.percent_global + 0.01
    assert rec.damaged_percent_global > got.baseline.percent_global


def test_growth_frees_the_old_graphs_engine(graphs):
    """Growth attaches a store to the service's graph: the old graph, and
    with it its own (storeless) engine, goes as soon as the service drops
    it, and every grown graph is replayed by the store's one engine, which
    adopts it in place."""
    g, _ = graphs["gis"]
    base = Graph(n_nodes=g.n_nodes, senders=g.senders, receivers=g.receivers,
                 edge_weight=g.edge_weight, node_attrs=g.node_attrs, name=g.name)
    svc = framework.PartitionedGraphService(base, 4, device="cpu")
    del base
    svc.partition_with(np.random.default_rng(0).integers(0, 4, g.n_nodes).astype(np.int32))
    ops = svc.make_ops(n_ops=20, seed=0)
    res = svc.run_ops(ops)
    old = weakref.ref(get_engine(svc.graph, ops.pattern, device="cpu"))
    old_graph = weakref.ref(svc.graph)
    ip = framework.InsertPartitioner("least_traffic", k=4, seed=0)
    log = ip.allocate(svc.parts, 0.05, vertex_traffic=res.per_vertex, insert_rate=0.5,
                      graph=svc.graph)
    svc.apply_dynamism(log)
    store = svc.graph.store
    assert store is not None and store.compactions == 0
    assert svc.graph.n_nodes == g.n_nodes + log.n_new_vertices > g.n_nodes
    res = svc.run_ops(ops)
    _assert_counters_equal(res, execute_ops(svc.graph, ops, svc.parts, 4, engine="scalar"))
    assert old_graph() is None and old() is None
    eng = get_engine(svc.graph, ops.pattern, device="cpu")
    assert eng.store is store and eng.n_nodes == svc.graph.n_nodes
    grown = weakref.ref(svc.graph)
    log = ip.allocate(svc.parts, 0.05, vertex_traffic=res.per_vertex, insert_rate=0.5,
                      graph=svc.graph)
    svc.apply_dynamism(log)
    _assert_counters_equal(svc.run_ops(ops), execute_ops(svc.graph, ops, svc.parts, 4,
                                                         engine="scalar"))
    assert grown() is None and svc.graph.store is store
    assert get_engine(svc.graph, ops.pattern, device="cpu") is eng
    assert eng.n_nodes == svc.graph.n_nodes


def test_inadmissible_insert_leaves_the_service_unchanged(graphs):
    g, jg = graphs["gis"]
    parts = np.zeros(g.n_nodes, dtype=np.int32)
    svc = framework.PartitionedGraphService(g, 4, device="cpu").partition_with(parts)
    jsvc = jax_framework.PartitionedGraphService(jg, 4).partition_with(parts)
    far = int(np.argmax(g.node_attrs["lon"]))
    bad = dict(vertices=np.array([0]), targets=np.array([1], np.int32), method="random", k=4,
               insert_senders=np.array([0]), insert_receivers=np.array([far]),
               insert_weights=np.array([1e-6], np.float32))
    with pytest.raises(ValueError, match="straight-line"):
        jsvc.apply_dynamism(JaxLog(**bad))
    with pytest.raises(ValueError, match="straight-line"):
        svc.apply_dynamism(DynamismLog(**bad))
    assert svc.graph is g and np.array_equal(svc.parts, parts)


def test_partition_and_serve_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.partition_and_serve", "--device", "cpu",
         "--scale", "0.002"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600,
    )
    assert out.returncode == 0, out.stderr
    text = out.stdout
    for name in NAMES:
        assert f"=== {name}:" in text
    assert text.count("stress: damaged") == 3
    assert text.count("dynamic:") == 3


def test_partition_and_serve_defaults_to_cuda():
    """Without ``--device`` the entry point asks for CUDA and, where there is
    none, stops with the port's error instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.partition_and_serve", "--scale", "0.001"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
