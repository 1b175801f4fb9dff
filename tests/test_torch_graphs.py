"""Port parity: the port's graph generators and layouts equal the JAX
package's, array for array (both are the same numpy code, draw for draw)."""

import numpy as np
import pytest

from repro.graphs import datasets as jax_datasets
from repro.graphs.structure import padded_neighbors as jax_padded_neighbors
from repro_torch.graphs import datasets
from repro_torch.graphs.structure import padded_neighbors


def _assert_same_graph(a, b):
    assert a.n_nodes == b.n_nodes
    assert a.name == b.name
    np.testing.assert_array_equal(a.senders, b.senders)
    np.testing.assert_array_equal(a.receivers, b.receivers)
    np.testing.assert_array_equal(a.edge_weight, b.edge_weight)
    assert sorted(a.node_attrs) == sorted(b.node_attrs)
    for key in a.node_attrs:
        assert a.node_attrs[key].dtype == b.node_attrs[key].dtype, key
        np.testing.assert_array_equal(a.node_attrs[key], b.node_attrs[key])


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name,scale", [
    ("filesystem", 0.004), ("gis", 0.004), ("twitter", 0.004), ("two_cluster", 1.0),
])
def test_generators_identical(name, scale, seed):
    _assert_same_graph(
        datasets.load(name, scale=scale, seed=seed),
        jax_datasets.load(name, scale=scale, seed=seed),
    )


@pytest.mark.parametrize("cap", [None, 2, 4])
def test_padded_neighbors_identical(cap):
    g = datasets.load("gis", scale=0.002, seed=1)
    s, r, w = g.undirected
    js, jr, jw = jax_datasets.load("gis", scale=0.002, seed=1).undirected
    got = padded_neighbors(s, r, w, g.n_nodes, cap=cap)
    want = jax_padded_neighbors(js, jr, jw, g.n_nodes, cap=cap)
    if cap is not None:
        assert got.n_spill > 0  # the cap binds
    for field in ("nbr", "w", "mask", "spill_s", "spill_r", "spill_w"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


@pytest.mark.parametrize("block_size", [16, 32, 128])
@pytest.mark.parametrize("undirected", [True, False])
def test_block_ell_identical(block_size, undirected):
    got = datasets.load("two_cluster", seed=2).to_block_ell(block_size, undirected)
    want = jax_datasets.load("two_cluster", seed=2).to_block_ell(block_size, undirected)
    for field in ("blocks", "block_cols", "block_mask"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert (got.n_rows, got.n_cols, got.block_size) == (want.n_rows, want.n_cols, want.block_size)


def test_derived_views_identical():
    g = datasets.load("filesystem", scale=0.002)
    jg = jax_datasets.load("filesystem", scale=0.002)
    for a, b in zip(g.undirected + g.undirected_csr + g.csr, jg.undirected + jg.undirected_csr + jg.csr):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(g.weighted_degree, jg.weighted_degree)
    np.testing.assert_array_equal(g.degree, jg.degree)
