"""Port parity for the hot-vertex placement at capacity > 0: ``Placement``,
``select_hot_vertices``, the replica mask in the scalar oracle and the
batched engine, the service's ``refresh_placement`` and pinned maintenance,
and ``repro_torch.skew_smoke``, against the JAX package with no mesh.

What is held bit for bit: the table, its epoch, its mask and its errors
after every step of each case of the JAX package's own placement tests; all
four counters of the port's scalar oracle and batched engine (GIS through
``frontier_relax``'s plain version) against the JAX scalar oracle with a
non-empty mask; the hot set and epoch of the port's service against the JAX
service's after every slice of a growing dynamic run, with the JAX run's
maintained maps injected; and the skew sweep's figures against the JAX
engines run live on the same DiDiC partitions.
"""

import numpy as np
import pytest
import torch

from repro.core import framework as jax_framework
from repro.core import partitioners as jax_partitioners
from repro.core.didic import DidicConfig as JaxDidicConfig
from repro.core.didic import didic_partition as jax_didic_partition
from repro.core.dynamic_runtime import DynamicExperimentRuntime as JaxRuntime
from repro.core.placement import Placement as JaxPlacement
from repro.core.traffic import execute_ops as jax_execute_ops
from repro.core.traffic import generate_ops as jax_generate_ops
from repro.graphs import datasets as jax_datasets
from repro_torch import skew_smoke
from repro_torch.core import framework, partitioners
from repro_torch.core.didic import DidicConfig
from repro_torch.core.dynamic_runtime import DynamicExperimentRuntime
from repro_torch.core.placement import Placement
from repro_torch.core.traffic import execute_ops, generate_ops
from repro_torch.graphs import datasets

# The suite runs in several worker processes at once; one intra-op thread
# each keeps PyTorch from oversubscribing the cores.
torch.set_num_threads(1)

SCALE = 0.003
NAMES = ("filesystem", "gis", "twitter")
COUNTERS = ("per_op_total", "per_op_global", "per_partition", "per_vertex")


def _n_ops(name):
    return 40 if name == "gis" else 300


def _assert_counters_equal(got, want):
    for field in COUNTERS:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


# ---------------------------------------------------------------------------
# Placement and select_hot_vertices: each case runs on both packages
# ---------------------------------------------------------------------------
def _state(p):
    mask = p.replicated_mask()
    return (p.hot.tolist(), p.hot.dtype.str, p.replica_epoch, p.n_hot, p.owner.tolist(),
            None if mask is None else mask.tolist(), p.hot_vertices().tolist())


def _trace(cls, steps, n=10, capacity=4):
    """Run ``steps`` (callables on a placement) and record, after each, its
    return value or error type and message, and the placement's state."""
    p = cls(owner=np.arange(n, dtype=np.int32) % 3, capacity=capacity)
    out = [_state(p)]
    for step in steps:
        try:
            ret = step(p)
            ret = ret.tolist() if isinstance(ret, np.ndarray) else ret
        except Exception as e:  # the error's type and text are compared
            ret = (type(e).__name__, str(e))
        out.append((ret, _state(p)))
    return out


PLACEMENT_CASES = {
    "static_sorted_padded": (4, [lambda p: p.set_hot([7, 2, 2]), lambda p: p.is_replicated(7),
                                 lambda p: p.is_replicated(3), lambda p: p.set_hot([0, 1, 2, 3, 4]),
                                 lambda p: p.set_hot([-1, 5])]),
    "epoch_bumps_only_on_change": (4, [lambda p: p.set_hot([3, 5]), lambda p: p.set_hot([5, 3]),
                                       lambda p: p.set_hot([]), lambda p: p.set_hot([])]),
    "invalidate_repacks_and_counts": (4, [lambda p: p.set_hot([1, 4, 8]),
                                          lambda p: p.invalidate([4, 9]),
                                          lambda p: p.invalidate([9]),
                                          lambda p: p.invalidate([]),
                                          lambda p: p.invalidate([1, 8])]),
    "replace_owner_evicts_out_of_range": (4, [lambda p: p.set_hot([2, 9]),
                                              lambda p: p.replace_owner(np.zeros(5, np.int32)),
                                              lambda p: p.replace_owner(np.ones(12, np.int32))]),
    "capacity_zero_is_inert": (0, [lambda p: p.invalidate([1, 2]), lambda p: p.set_hot([]),
                                   lambda p: p.set_hot([1]), lambda p: p.replace_owner(
                                       np.zeros(4, np.int32))]),
    "meta_copy_roundtrip": (4, [lambda p: p.set_hot([3]), lambda p: p.to_meta(),
                                lambda p: _state(p.copy()),
                                lambda p: _state(type(p).from_parts(p.owner, capacity=2))]),
}


@pytest.mark.parametrize("case", list(PLACEMENT_CASES))
def test_placement_matches_jax(case):
    capacity, steps = PLACEMENT_CASES[case]
    assert _trace(Placement, steps, capacity=capacity) == _trace(JaxPlacement, steps,
                                                                  capacity=capacity)


def test_placement_rejects_bad_shapes_like_jax():
    for kwargs in (dict(capacity=-1), dict(capacity=2, hot=np.array([1, 2, 3]))):
        errors = []
        for cls in (Placement, JaxPlacement):
            with pytest.raises(ValueError) as info:
                cls(owner=np.zeros(4, np.int32), **kwargs)
            errors.append(str(info.value))
        assert errors[0] == errors[1]


SELECT_CASES = {
    "top_k_ties_by_id": (np.array([5, 0, 9, 9, 1, 3]), 3, None),
    "capacity_zero": (np.array([5, 0, 9, 9, 1, 3]), 0, None),
    "no_zero_traffic": (np.array([5, 0, 9, 9, 1, 3]), 6, None),
    "hysteresis_holds": (np.array([10, 11, 12, 0]), 2, [0, 1]),
    "hysteresis_displaces": (np.array([10, 11, 13, 0]), 2, [0, 1]),
    "free_capacity_admits": (np.array([10, 0, 4, 0]), 3, [0]),
    "stale_incumbents_dropped": (np.array([1, 2, 3]), 2, [7, -1, 1]),
    "empty_traffic": (np.zeros(0, np.int64), 4, None),
}


@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_select_hot_vertices_matches_jax(case):
    traffic, capacity, current = SELECT_CASES[case]
    got = partitioners.select_hot_vertices(traffic, capacity, current_hot=current)
    want = jax_partitioners.select_hot_vertices(traffic, capacity, current_hot=current)
    assert got.dtype == want.dtype and got.tolist() == want.tolist()


def test_select_hot_vertices_matches_jax_on_random_traffic():
    rng = np.random.default_rng(3)
    for trial in range(20):
        traffic = rng.integers(0, 50, size=200) * (rng.random(200) < 0.5)
        current = rng.choice(220, size=rng.integers(0, 12), replace=False) - 10
        cap = int(rng.integers(0, 16))
        for hyst in (1.0, 1.25, 2.0):
            got = partitioners.select_hot_vertices(traffic, cap, current, hysteresis=hyst)
            want = jax_partitioners.select_hot_vertices(traffic, cap, current, hysteresis=hyst)
            assert got.tolist() == want.tolist(), (trial, hyst)


# ---------------------------------------------------------------------------
# The engines with a replica mask
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def replays():
    """Per dataset: both graphs, a random map, the log, and the JAX scalar
    oracle's mask-free replay (its per-vertex traffic picks the hot set)."""
    out = {}
    for name in NAMES:
        g, jg = datasets.load(name, scale=SCALE), jax_datasets.load(name, scale=SCALE)
        parts = np.random.default_rng(1).integers(0, 4, g.n_nodes).astype(np.int32)
        jops = jax_generate_ops(jg, n_ops=_n_ops(name), seed=0)
        ops = generate_ops(g, n_ops=_n_ops(name), seed=0)
        base = jax_execute_ops(jg, jops, parts, 4, engine="scalar")
        out[name] = (g, jg, parts, ops, jops, base)
    return out


@pytest.mark.parametrize("capacity", [8, 64])
@pytest.mark.parametrize("name", NAMES)
def test_masked_replay_matches_jax_oracle(replays, name, capacity):
    g, jg, parts, ops, jops, base = replays[name]
    hot = jax_partitioners.select_hot_vertices(base.per_vertex, capacity)
    assert hot.size == capacity
    mask = np.zeros(g.n_nodes, dtype=bool)
    mask[hot] = True
    want = jax_execute_ops(jg, jops, parts, 4, engine="scalar", replicated=mask)
    scalar = execute_ops(g, ops, parts, 4, engine="scalar", replicated=mask)
    batched = execute_ops(g, ops, parts, 4, engine="batched", device="cpu", replicated=mask)
    _assert_counters_equal(scalar, want)
    _assert_counters_equal(batched, want)
    # Replication only moves traffic: totals are conserved, global never
    # rises, and 64 replicas cut it on every pattern.
    assert batched.per_op_total.sum() == base.per_op_total.sum()
    assert batched.per_partition.sum() == base.per_partition.sum()
    assert batched.per_op_global.sum() <= base.per_op_global.sum()
    if capacity == 64:
        assert batched.per_op_global.sum() < base.per_op_global.sum()


@pytest.mark.parametrize("name", NAMES)
def test_capacity_zero_equals_the_mask_free_replay(replays, name):
    g, _, parts, ops, _, base = replays[name]
    plain = execute_ops(g, ops, parts, 4, device="cpu")
    _assert_counters_equal(plain, base)
    empty = Placement.from_parts(parts, capacity=0).replicated_mask()
    assert empty is None
    _assert_counters_equal(execute_ops(g, ops, parts, 4, device="cpu", replicated=empty), plain)
    # An all-false mask takes the masked path and must land on the same counters.
    none_hot = np.zeros(g.n_nodes, dtype=bool)
    _assert_counters_equal(execute_ops(g, ops, parts, 4, device="cpu", replicated=none_hot),
                           plain)
    _assert_counters_equal(execute_ops(g, ops, parts, 4, engine="scalar", replicated=none_hot),
                           plain)


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------
def _services(name, graphs, capacity, iterations=5):
    """Both services on the JAX package's DiDiC map, with an exception
    table of ``capacity``."""
    g, jg = graphs
    cap = 256 if name == "filesystem" else 64
    jcfg = JaxDidicConfig(k=4, iterations=iterations, smooth_cap=cap)
    cfg = DidicConfig(k=4, iterations=iterations, smooth_cap=cap)
    parts0, _ = jax_didic_partition(jg, jcfg, seed=0)
    parts0 = np.asarray(parts0)
    jsvc = jax_framework.PartitionedGraphService(jg, 4, didic=jcfg, exception_capacity=capacity)
    jsvc.partition_with(parts0.copy())
    svc = framework.PartitionedGraphService(g, 4, didic=cfg, device="cpu",
                                            exception_capacity=capacity)
    svc.partition_with(parts0.copy())
    return svc, jsvc


@pytest.mark.parametrize("name", NAMES)
def test_refresh_placement_matches_jax(replays, name):
    g, jg, _, _, _, _ = replays[name]
    svc, jsvc = _services(name, (g, jg), capacity=16)
    ops, jops = svc.make_ops(n_ops=_n_ops(name), seed=0), jsvc.make_ops(n_ops=_n_ops(name), seed=0)
    for _ in range(2):
        _assert_counters_equal(svc.run_ops(ops), jsvc.run_ops(jops))
    np.testing.assert_array_equal(svc.logger.vertex_traffic, jsvc.logger.vertex_traffic)
    hot = svc.refresh_placement()
    assert hot.tolist() == jsvc.refresh_placement().tolist() and hot.size == 16
    assert svc.placement.replica_epoch == jsvc.placement.replica_epoch == 1
    # Masked replays from here on; traffic from another log shifts the
    # ranking, and hysteresis decides the same way in both packages.
    _assert_counters_equal(svc.run_ops(ops), jsvc.run_ops(jops))
    ops2 = svc.make_ops(n_ops=_n_ops(name), seed=5)
    jops2 = jsvc.make_ops(n_ops=_n_ops(name), seed=5)
    _assert_counters_equal(svc.run_ops(ops2), jsvc.run_ops(jops2))
    for hyst in (1.25, 1.0):
        assert svc.refresh_placement(hyst).tolist() == jsvc.refresh_placement(hyst).tolist()
        assert svc.placement.replica_epoch == jsvc.placement.replica_epoch
        np.testing.assert_array_equal(svc.placement.hot, jsvc.placement.hot)


def test_capacity_zero_service_is_unchanged(replays):
    g, jg, parts, ops, _, base = replays["twitter"]
    svc = framework.PartitionedGraphService(g, 4, device="cpu").partition_with(parts)
    res = svc.run_ops(ops)
    assert svc.refresh_placement().size == 0 and svc.placement.replica_epoch == 0
    _assert_counters_equal(res, base)
    _assert_counters_equal(svc.run_ops(ops), base)
    np.testing.assert_array_equal(svc.logger.vertex_traffic, 2 * base.per_vertex)
    svc.logger.reset()
    assert svc.logger.vertex_traffic.shape == (0,)


@pytest.mark.parametrize("name", NAMES)
def test_pinned_maintenance_keeps_hot_owners(replays, name):
    """The port's own maintenance: the hot vertices keep their owners and
    replicas, and the rest of the map may move."""
    g, jg, _, _, _, _ = replays[name]
    svc, _ = _services(name, (g, jg), capacity=32)
    svc.run_ops(svc.make_ops(n_ops=_n_ops(name), seed=0))
    hot = svc.refresh_placement()
    before = svc.parts.copy()
    epoch = svc.placement.replica_epoch
    svc.parts = np.roll(before, 1)  # a damaged map for maintenance to repair
    damaged = svc.parts.copy()
    moved = svc.maintain_migrate(framework.MigrationScheduler(min_move_fraction=0.0), step=0)
    assert moved > 0
    np.testing.assert_array_equal(svc.parts[hot], damaged[hot])
    assert svc.placement.hot_vertices().tolist() == hot.tolist()
    assert svc.placement.replica_epoch == epoch


@pytest.mark.parametrize("name", NAMES)
def test_hot_table_matches_jax_across_a_growing_run(replays, name):
    """A dynamic run with growth (30 % of the units insert new vertices),
    the hot set refreshed after every slice and the JAX run's maintained
    maps injected: counters, the table and its epoch equal after every slice."""
    g, jg, _, _, _, _ = replays[name]
    svc, jsvc = _services(name, (g, jg), capacity=32)
    maps = []
    jax_maintain = jsvc.runtime.maintain

    def recorded(*args, **kwargs):
        out = jax_maintain(*args, **kwargs)
        maps.append(np.array(out, copy=True))
        return out

    jsvc.runtime.maintain = recorded
    supply = iter(maps)
    svc.runtime.maintain = lambda *args, **kwargs: next(supply)
    jops = jsvc.make_ops(n_ops=_n_ops(name), seed=0)
    ops = svc.make_ops(n_ops=_n_ops(name), seed=0)
    jsvc.run_ops(jops)
    svc.run_ops(ops)
    jsvc.refresh_placement()
    svc.refresh_placement()
    seen, jseen = [], []

    def slice_hook(service, log):
        def hook(i, result):
            log.append((result, service.placement.hot.tolist(), service.placement.replica_epoch,
                        service.graph.n_nodes))
            service.refresh_placement()
            log.append((service.placement.hot.tolist(), service.placement.replica_epoch))
        return hook

    kw = dict(n_slices=4, amount=0.05, maintain_every=2, insert_rate=0.3)
    JaxRuntime(jsvc, insert_method="least_traffic", seed=0).run(
        jops, on_slice=slice_hook(jsvc, jseen), **kw)
    DynamicExperimentRuntime(svc, insert_method="least_traffic", seed=0).run(
        ops, on_slice=slice_hook(svc, seen), **kw)
    assert len(seen) == len(jseen) == 8 and len(maps) == 2
    for (res, *rest), (jres, *jrest) in zip(seen[0::2], jseen[0::2]):
        _assert_counters_equal(res, jres)
        assert rest == jrest
    assert seen[1::2] == jseen[1::2]
    assert svc.graph.n_nodes > g.n_nodes
    assert jsvc.placement.replica_epoch > 1  # the table changed along the run
    np.testing.assert_array_equal(svc.logger.vertex_traffic, jsvc.logger.vertex_traffic)


# ---------------------------------------------------------------------------
# skew_smoke
# ---------------------------------------------------------------------------
def test_skew_smoke_matches_the_jax_engines():
    """The sweep at a reduced scale on the JAX DiDiC partitions: each
    capacity's global traffic and load CV equal the JAX scalar and batched
    engines' on the same hot sets."""
    scale, n_ops = 0.01, 48
    jparts = {}
    for name, _ in skew_smoke.WORKLOADS:
        jg = jax_datasets.load(name, scale=scale, seed=0)
        p, _ = jax_didic_partition(jg, JaxDidicConfig(k=skew_smoke.K,
                                                      iterations=skew_smoke.DIDIC_ITERATIONS),
                                   seed=0)
        jparts[name] = np.asarray(p, dtype=np.int32)
    rows, update = skew_smoke.skew_smoke(scale=scale, n_ops=n_ops, device="cpu", parts=jparts)
    assert [r.split(",")[0] for r in rows] == ["skew/twitter/reduction_at_128",
                                               "skew/filesystem/reduction_at_128"]
    for name, pattern in skew_smoke.WORKLOADS:
        jg = jax_datasets.load(name, scale=scale, seed=0)
        jops = jax_generate_ops(jg, n_ops=n_ops, seed=2, pattern=pattern)
        base = jax_execute_ops(jg, jops, jparts[name], skew_smoke.K, engine="batched")
        for capacity in skew_smoke.CAPACITIES:
            hot = jax_partitioners.select_hot_vertices(base.per_vertex, capacity)
            mask = None
            if hot.size:
                mask = np.zeros(jg.n_nodes, dtype=bool)
                mask[hot] = True
            got = update[name]["sweep"][str(capacity)]
            assert got["replicated"] == hot.size
            for engine in ("scalar", "batched"):
                res = jax_execute_ops(jg, jops, jparts[name], skew_smoke.K, engine=engine,
                                      replicated=mask)
                pp = np.asarray(res.per_partition, dtype=np.float64)
                assert got["global_traffic"] == float(res.per_op_global.sum()), (name, capacity)
                assert got["load_cv"] == round(float(pp.std() / pp.mean()), 4), (name, capacity)
    assert update["twitter"]["reduction_at_128"] >= 0.20


def test_skew_smoke_gates_are_fatal(monkeypatch):
    """A sweep whose replicas do not cut Twitter's traffic fails its gate."""
    monkeypatch.setattr(skew_smoke, "hot_mask", lambda per_vertex, capacity: None)
    with pytest.raises(AssertionError, match="twitter"):
        skew_smoke.skew_smoke(scale=0.005, n_ops=24, device="cpu")


def test_skew_smoke_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        skew_smoke.skew_smoke(scale=0.005, n_ops=8)
