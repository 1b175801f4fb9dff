"""Port parity for the traffic replay: the port's scalar oracle and its
batched engine (on the CPU) are bit-equal on all four counters to the JAX
package's scalar oracle, on every case of the JAX package's own
``TestEquivalence`` (tests/test_traffic_engine.py)."""

import numpy as np
import pytest
import torch

from repro.core import partitioners as jax_partitioners
from repro.core import traffic as jax_traffic
from repro.core.didic import DidicConfig as JaxDidicConfig
from repro.core.didic import didic_partition as jax_didic_partition
from repro.graphs import datasets as jax_datasets
from repro_torch import convert
from repro_torch.core import traffic
from repro_torch.core.traffic_batched import BatchedTrafficEngine, get_engine
from repro_torch.graphs import datasets

# The suite runs in several worker processes at once; one intra-op thread
# each keeps PyTorch from oversubscribing the cores.
torch.set_num_threads(1)

SCALE = 0.004


@pytest.fixture(scope="module")
def graphs():
    return {
        name: (datasets.load(name, scale=SCALE), jax_datasets.load(name, scale=SCALE))
        for name in ("filesystem", "gis", "twitter")
    }


def _assert_exact(got, ref):
    np.testing.assert_array_equal(got.per_op_total, ref.per_op_total)
    np.testing.assert_array_equal(got.per_op_global, ref.per_op_global)
    np.testing.assert_array_equal(got.per_partition, ref.per_partition)
    np.testing.assert_array_equal(got.per_vertex, ref.per_vertex)
    assert got.per_partition.sum() == got.total


def _parts(kind, jg, k, seed):
    if kind == "random":
        return jax_partitioners.random_partition(jg.n_nodes, k, seed=seed)
    if kind == "hardcoded":
        return jax_partitioners.hardcoded_for(jg, k)
    if kind == "didic":
        parts, _ = jax_didic_partition(jg, JaxDidicConfig(k=k, iterations=5), seed=seed)
        return np.asarray(parts)
    raise ValueError(kind)


# (dataset, pattern, n_ops, log seed, parts kind, k, parts seed, engine kwargs)
CASES = {
    "filesystem_random": ("filesystem", None, 400, 1, "random", 4, 0, {}),
    "filesystem_hardcoded": ("filesystem", None, 300, 2, "hardcoded", 2, 0, {}),
    "twitter": ("twitter", None, 400, 1, "random", 4, 3, {}),
    "gis_short": ("gis", "gis_short", 200, 1, "hardcoded", 4, 0, {}),
    "gis_long": ("gis", "gis_long", 60, 1, "random", 4, 0, {}),
    "gis_didic_parts": ("gis", "gis_short", 80, 4, "didic", 2, 0, {}),
    "gis_bucketed_delta_4": ("gis", "gis_short", 100, 6, "random", 4, 2, {"delta_scale": 4.0}),
    "gis_small_chunk": ("gis", "gis_short", 13, 7, "random", 3, 0, {"chunk": 8}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_equivalence_with_jax_scalar_oracle(graphs, case):
    name, pattern, n_ops, log_seed, kind, k, parts_seed, engine_kw = CASES[case]
    g, jg = graphs[name]
    ops = traffic.generate_ops(g, n_ops=n_ops, seed=log_seed, pattern=pattern)
    jops = jax_traffic.generate_ops(jg, n_ops=n_ops, seed=log_seed, pattern=pattern)
    assert ops.fingerprint() == jops.fingerprint()
    parts = _parts(kind, jg, k, parts_seed)
    ref = jax_traffic.execute_ops(jg, jops, parts, k, engine="scalar")

    _assert_exact(traffic.execute_ops(g, ops, parts, k, engine="scalar"), ref)
    eng = BatchedTrafficEngine(g, ops.pattern, device="cpu", **engine_kw)
    _assert_exact(eng.run(ops, parts, k, t_l=ops.t_l, t_pg=ops.t_pg), ref)


def test_gis_degenerate_src_eq_dst(graphs):
    g, jg = graphs["gis"]
    v = np.array([7, 7, 123], dtype=np.int64)
    ops = convert.oplog_from_arrays("gis_short", v, v, t_l=8, t_pg=1)
    jops = jax_traffic.OpLog("gis_short", v, v.copy(), t_l=8, t_pg=1)
    parts = jax_partitioners.random_partition(jg.n_nodes, 2, seed=0)
    ref = jax_traffic.execute_ops(jg, jops, parts, 2, engine="scalar")
    got = traffic.execute_ops(g, ops, parts, 2, engine="batched", device="cpu")
    _assert_exact(got, ref)
    assert got.total == 0


def test_gis_max_expansions_truncation(graphs):
    """The lex-(f, id) truncation (a stable sort) agrees with the JAX
    oracle even where it clips the expansion set."""
    g, jg = graphs["gis"]
    ops = traffic.generate_ops(g, n_ops=40, seed=5, pattern="gis_long")
    jops = jax_traffic.generate_ops(jg, n_ops=40, seed=5, pattern="gis_long")
    parts = jax_partitioners.random_partition(jg.n_nodes, 2, seed=1)
    full = jax_traffic.execute_ops(jg, jops, parts, 2, engine="scalar")
    clipped = jax_traffic._execute_gis_scalar(jg, jops, parts, 2, max_expansions=64)
    assert clipped.total < full.total  # the cap binds
    _assert_exact(traffic._execute_gis_scalar(g, ops, parts, 2, max_expansions=64), clipped)
    eng = BatchedTrafficEngine(g, "gis_long", max_expansions=64, device="cpu")
    _assert_exact(eng.run(ops, parts, 2, t_l=ops.t_l, t_pg=ops.t_pg), clipped)


def test_oplog_fingerprint_stable():
    g = datasets.load("twitter", scale=0.002)
    a = traffic.generate_ops(g, n_ops=50, seed=3)
    b = traffic.generate_ops(g, n_ops=50, seed=3)
    c = traffic.generate_ops(g, n_ops=50, seed=4)
    assert a.fingerprint() == b.fingerprint() != c.fingerprint()
    jops = jax_traffic.generate_ops(jax_datasets.load("twitter", scale=0.002), n_ops=50, seed=3)
    carried = convert.oplog_from_arrays(jops.pattern, jops.starts, jops.ends, jops.t_l, jops.t_pg)
    assert carried.fingerprint() == a.fingerprint()


def test_engine_cache_keyed_by_params_and_device(graphs):
    g, _ = graphs["gis"]
    assert get_engine(g, "gis_short", device="cpu") is get_engine(
        g, "gis_short", max_expansions=50_000, device="cpu")
    assert get_engine(g, "gis_short", max_expansions=64, device="cpu").max_expansions == 64
    assert get_engine(g, "gis_short", max_expansions=64, device="cpu") is not get_engine(
        g, "gis_short", device="cpu")
